"""Port vs reference: filter design, blocked HWR accumulation, the
multirate bank (float numerics, and the routing of numerics="fixed")."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import esc10_mp as cfg_ref
from repro.core import filterbank as fb_ref
from repro_torch.configs import esc10_mp as cfg_port
from repro_torch.core import filterbank as fb

ATOL = 1e-5


@pytest.mark.parametrize("quant_bits", [None, 8])
@pytest.mark.parametrize("spacing", ["octave", "greenwood"])
def test_taps_equal_reference_exactly(quant_bits, spacing):
    c = cfg_ref.FILTERBANK._replace(quant_bits=quant_bits, spacing=spacing)
    ref = fb_ref.FilterBank(c)
    port = fb.FilterBank(fb.FilterBankConfig(**c._asdict()), device="cpu")
    assert len(port.bp_taps) == 30 and len(port.lp_tap_list) == 5
    for a, b in zip(port.bp_taps, ref.bp_taps):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(port.lp_tap_list, ref.lp_tap_list):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(port.bp_by_octave, ref.bp_by_octave):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_config_fields_and_presets_match_reference():
    assert fb.FilterBankConfig._fields == fb_ref.FilterBankConfig._fields
    assert fb.FilterBankConfig() == fb.FilterBankConfig(
        **fb_ref.FilterBankConfig()._asdict())
    assert cfg_port.FILTERBANK._asdict() == cfg_ref.FILTERBANK._asdict()
    assert cfg_port.FILTERBANK_SMOKE._asdict() == \
        cfg_ref.FILTERBANK_SMOKE._asdict()


@pytest.mark.parametrize("n", [1, 2, 3, 200, 512, 513, 1500])
def test_accumulate_block_len(n):
    assert fb.accumulate_block_len(n) == fb_ref.accumulate_block_len(n)


@pytest.mark.parametrize("l", [0, 7, 600, 1100])
def test_hwr_accumulate_bitwise(l):
    rng = np.random.default_rng(l)
    y = rng.standard_normal((3, 2, l)).astype(np.float32)
    valid = rng.integers(0, l + 1, (3, 1)).astype(np.int32)
    for v in (None, valid):
        got = fb.hwr_accumulate(torch.from_numpy(y),
                                None if v is None else torch.from_numpy(v))
        want = fb_ref.hwr_accumulate(y, v)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quant_bits,solver", [(None, "newton"),
                                               (8, "bisect")])
def test_multirate_accumulate_matches_reference(quant_bits, solver):
    c = cfg_ref.FILTERBANK_SMOKE._replace(quant_bits=quant_bits,
                                          solver=solver)
    ref = fb_ref.FilterBank(c)
    port = fb.FilterBank(fb.FilterBankConfig(**c._asdict()), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 300)).astype(np.float32)
    np.testing.assert_allclose(port.accumulate(x).numpy(),
                               np.asarray(jax.jit(ref.accumulate)(x)),
                               atol=ATOL, rtol=0)


def test_valid_mode_matches_padded():
    c = fb.FilterBankConfig(fs=4000.0, num_octaves=2, filters_per_octave=2)
    bank = fb.FilterBank(c, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 40)).astype(np.float32))
    H, h = bank.bp_by_octave[0], bank.lp_filters[0]
    assert torch.equal(fb.bank_fir_valid(x, H, c),
                       fb.bank_fir(x, H, c)[..., H.shape[1] - 1:])
    assert torch.equal(fb.single_fir_valid(x, h, c),
                       fb.single_fir(x, h, c)[..., h.shape[0] - 1:])


def test_mac_mode_matches_reference():
    c = cfg_ref.FILTERBANK_SMOKE._replace(mode="mac")
    ref = fb_ref.FilterBank(c)
    port = fb.FilterBank(fb.FilterBankConfig(**c._asdict()), device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 200)).astype(np.float32)
    np.testing.assert_allclose(port.accumulate(x).numpy(),
                               np.asarray(jax.jit(ref.accumulate)(x)),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("mode", ["mp", "mac"])
def test_fixed_numerics_accumulate_matches_reference(mode):
    c = cfg_ref.FILTERBANK_SMOKE._replace(mode=mode, numerics="fixed",
                                          fixed_amax=3.0)
    ref = fb_ref.FilterBank(c)
    port = fb.FilterBank(fb.FilterBankConfig(**c._asdict()), device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 250)).astype(np.float32)
    got = port.accumulate(x)
    # the 32-bit accumulators, dequantized by a power of two: exact
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.accumulate(x)))
    assert port.fixed_bank() is port.fixed_bank()
    # the float engine refuses a fixed config, naming the right entry point
    with pytest.raises(ValueError, match="FilterBank.accumulate"):
        fb.multirate_accumulate(torch.from_numpy(x), port.bp_by_octave,
                                port.lp_filters, port.config)


def test_unknown_numerics_raises():
    with pytest.raises(ValueError, match="unknown numerics 'int8'"):
        fb.FilterBank(fb.FilterBankConfig(numerics="int8"), device="cpu")
