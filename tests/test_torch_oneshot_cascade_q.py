"""The integer one-shot bank's multirate cascade, port vs reference, on the
CPU.

On the card ``core.fixed.bank_accumulate_q`` (MP, ``use_pallas``) runs the
whole cascade of a fixed-point ``apply`` in one launch of the int one-shot
kernel (``kernels.fir_mp.fir_mp_oneshot_cascade_q``); on CPU tensors the
same entry point runs the plain composition
(``kernels.ref.fir_mp_oneshot_cascade_q``), which is what the kernel is
held to, bit for bit, on the card. Here the plain cascade is held bit for
bit against the reference's ``bank_accumulate_q`` through its Pallas
kernel (``fir_mp_bank_q_pallas``, interpret mode), and the host side of
the kernel route (integer work plan, octave table, one-stage stage
record, routing, refusals) is checked.

Inputs are seeded numpy arrays given to both packages; the smoke bank
(``FILTERBANK_SMOKE``: 3 octaves of 3 filters, 16 / 6 taps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs.esc10_mp import make_pipeline as make_ref_pipeline
from repro.core import fixed as fx_ref
from repro_torch import bridge
from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.core import fixed as fx
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.fir_mp import (ONESHOT_KINDS,
                                        ONESHOT_Q_OCTAVE_FIELDS, STAGE_FIELDS,
                                        STAGE_HEAD, _one_stage_table,
                                        _oneshot_q_inputs, _program_table,
                                        fir_mp_oneshot_cascade_q,
                                        oneshot_plan, oneshot_q_octave_rows,
                                        pack_stages)

KEEP, BAND, OUT = (ONESHOT_KINDS.index(k) for k in ("keep", "band", "out"))


@pytest.fixture(autouse=True)
def _pallas_names(monkeypatch):
    # the reference names TPUCompilerParams, which newer JAX calls
    # CompilerParams; interpret mode ignores it either way
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


@pytest.fixture(scope="module")
def progs():
    """The reference's smoke program, calibrated on seeded audio, and the
    port's copy of it through the bridge."""
    with jax.threefry_partitionable(False):
        pipe = make_ref_pipeline(smoke=True, numerics="fixed")
    x = np.random.default_rng(0).standard_normal((4, 2000)).astype(
        np.float32) * 0.3
    prog_r = fx_ref.compile_pipeline(pipe, calibration_audio=x)
    return prog_r, bridge.program_from_numpy(bridge.program_to_numpy(prog_r))


def _codes(prog, B, N, seed):
    """ADC codes over the signal format's whole range."""
    s = prog.bank.signal
    return np.random.default_rng(seed).integers(
        s.qmin, s.qmax + 1, (B, N)).astype(np.int32)


@pytest.mark.parametrize("B,N", [(1, 37), (2, 300), (3, 517)])
def test_plain_cascade_q_matches_reference_pallas(progs, B, N):
    """Bit for bit the reference's bank_accumulate_q through its Pallas
    int bank kernel (interpret mode): odd lengths, one row, and a
    length past two tiles."""
    prog_r, prog = progs
    xq = _codes(prog, B, N, N)
    want = fx_ref.bank_accumulate_q(prog_r.bank, jnp.asarray(xq),
                                    use_pallas=True)
    got = ref.fir_mp_oneshot_cascade_q(prog.bank, torch.from_numpy(xq))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bank_accumulate_q_routes_cpu_tensors_to_the_plain_cascade(
        progs, monkeypatch):
    """use_pallas on CPU tensors runs the plain cascade once (leading
    dims kept), equal to the torch-op loop; MAC mode and use_pallas=False
    keep their loop; nothing is counted."""
    calls = []
    plain = ref.fir_mp_oneshot_cascade_q

    def spy(bank, xq):
        calls.append(tuple(xq.shape))
        return plain(bank, xq)

    monkeypatch.setattr(ref, "fir_mp_oneshot_cascade_q", spy)
    _, prog = progs
    xq = torch.from_numpy(_codes(prog, 2, 130, 1))
    reset_launches()
    got = fx.bank_accumulate_q(prog.bank, xq, use_pallas=True)
    assert calls == [(2, 130)]
    assert torch.equal(got, fx.bank_accumulate_q(prog.bank, xq))
    assert torch.equal(fx.bank_accumulate_q(prog.bank, xq[0],
                                            use_pallas=True), got[0])
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    pipe = make_pipeline(smoke=True, numerics="fixed", device="cpu")
    cfg = pipe.config._replace(mode="mac")
    mac = fx.compile_bank(cfg, pipe.bp_taps, pipe.lp_taps, amax=1.0)
    assert fx.bank_accumulate_q(mac, xq, use_pallas=True).shape == (2, 9)
    assert len(calls) == 2


def test_integer_plan_puts_every_item_after_its_input():
    """The integer plan queues every item once, after the keep items that
    write its input, and has no partials and no done counters: its
    scratch holds x_1 .. x_{O-1} (int32), its counters the head and one
    ready counter per row of each."""
    for B, N, F, O, ctas in ((8, 16000, 5, 6, 528), (1, 5, 5, 6, 528),
                             (3, 301, 4, 8, 100), (2, 37, 3, 3, 0)):
        plan = oneshot_plan(B, N, F, octaves=O, ctas=ctas, integer=True)
        seen, keep_done_at = {}, {}
        for kind, o, start, count, offset in plan["segments"].tolist():
            assert offset == seen.get((kind, o), 0)
            seen[(kind, o)] = offset + count
            if kind == KEEP:
                keep_done_at[o] = start + count
            if o >= 1:
                assert keep_done_at.get(o - 1, 1 << 40) <= start
        want = {(KEEP, o): B * k for o, k in enumerate(plan["keep_tiles"])}
        want.update({(BAND, o): B * F * t
                     for o, t in enumerate(plan["tiles"])})
        assert seen == want and plan["items"] == sum(want.values())
        assert plan["integer"]
        assert plan["part_off"] == plan["done_off"] == (0,) * O
        assert plan["scratch"] == B * sum(plan["lens"][1:])
        assert plan["counters"] == 1 + B * (O - 1)
        # the queue is the float plan's
        flt = oneshot_plan(B, N, F, octaves=O, ctas=ctas)
        assert np.array_equal(flt["segments"], plan["segments"])
        assert flt["sig_off"] == plan["sig_off"]
    one = oneshot_plan(3, 300, 5, integer=True)
    assert one["segments"].tolist() == [[BAND, 0, 0, 30, 0]]
    assert (one["scratch"], one["counters"]) == (0, 1)


def test_q_octave_rows_point_into_scratch_and_counters():
    B, N, F = 2, 600, 3
    plan = oneshot_plan(B, N, F, octaves=3, integer=True)
    x = torch.zeros(B, N, dtype=torch.int32)
    scratch = torch.empty(plan["scratch"], dtype=torch.int32)
    counters = torch.zeros(plan["counters"], dtype=torch.int32)
    rows = oneshot_q_octave_rows(plan, x, scratch, counters)
    f = {k: rows[:, i].tolist()
         for i, k in enumerate(ONESHOT_Q_OCTAVE_FIELDS)}
    sp, cp = scratch.data_ptr(), counters.data_ptr()
    # x_1 (2 rows of 300) at the scratch's start, then x_2
    assert f["src"] == [x.data_ptr(), sp, sp + 4 * 600]
    assert f["dst"] == f["src"][1:] + [0]
    assert f["ready_in"] == [0, cp + 4, cp + 4 * 3]
    assert f["ready_out"] == f["ready_in"][1:] + [0]
    assert f["n"] == [600, 300, 150] and f["tiles"] == [3, 2, 1]
    assert f["out_len"] == [300, 150, 0] and f["fir_tiles"] == [2, 1, 0]
    assert f["ready_target"] == [0, 2, 1] and f["col"] == [0, 3, 6]
    assert f["stride"] == [2] * 3 and f["fir_F"] == [1] * 3
    out = oneshot_plan(B, N, F, output=True, integer=True)
    y = torch.empty(B, F, N, dtype=torch.int32)
    row = oneshot_q_octave_rows(out, x, None, counters, y)[0].tolist()
    assert row == [x.data_ptr(), y.data_ptr(), 0, 0, N, 3, F, 3, N, 1, 0, 0]


def test_stage_tables_are_the_stream_kernels(progs):
    """The cascade reads the bank's stage table, the one the int stream
    kernel packs (cached on the bank per delay length); the one-stage
    entry packs one record of the same format."""
    _, prog = progs
    st = prog.bank.octaves
    nxt = [st[o + 1].in_spec for o in range(len(st) - 1)] + [None]
    table = _program_table(prog.bank, 15, "cpu")[0]
    np.testing.assert_array_equal(table.numpy(), pack_stages(st, nxt, 15))
    H = np.arange(-24, 24, dtype=np.int32).reshape(3, 16)
    rec = _one_stage_table(H, 37, 9, -512, 511, "cpu").numpy()[0]
    head = dict(zip(STAGE_FIELDS, rec[:len(STAGE_FIELDS)].tolist()))
    assert (head["F"], head["M"], head["gamma_bp"], head["iters_bp"],
            head["band_qmin"], head["band_qmax"], head["emit"]) == \
        (3, 16, 37, 9, -512, 511, 0)
    assert head["sig_shift"] == head["acc_shift"] == 0
    np.testing.assert_array_equal(rec[STAGE_HEAD:STAGE_HEAD + 48],
                                  H[:, ::-1].reshape(-1))


def test_cascade_q_wrapper_refuses_what_the_kernel_does_not_take(progs):
    _, prog = progs
    bank = prog.bank
    xq = torch.zeros(2, 64, dtype=torch.int32)
    # float-carried codes are taken (the fake-quant twin's instance); other
    # dtypes raise (checked on the card's route; here directly)
    assert _oneshot_q_inputs(xq.float(), 16, 6, "k").dtype == torch.float32
    for dt in (torch.float64, torch.int64):
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            _oneshot_q_inputs(xq.to(dt), 16, 6, "fir_mp_oneshot_cascade_q")
    with pytest.raises(ValueError, match="M_lp = 9 must be at most"):
        _oneshot_q_inputs(xq, 16, 9, "fir_mp_oneshot_cascade_q")
    assert _oneshot_q_inputs(xq, 16, 6, "k").dtype == torch.int32
    # mixed devices
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_oneshot_cascade_q(bank, xq.to("meta"))
    # a MAC-mode bank
    with pytest.raises(ValueError, match="no 'mac'-mode variant"):
        fir_mp_oneshot_cascade_q(dataclasses.replace(bank, mode="mac"), xq)
    # unequal tap lengths across octaves
    st = list(bank.octaves)
    st[1] = dataclasses.replace(st[1], bp_q=np.asarray(st[1].bp_q)[:, :12])
    with pytest.raises(ValueError, match="one band-pass and one low-pass"):
        fir_mp_oneshot_cascade_q(dataclasses.replace(bank, octaves=tuple(st)),
                                 xq)
    with pytest.raises(ValueError, match="xq must be \\(B, N\\)"):
        fir_mp_oneshot_cascade_q(bank, xq[0])
