"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (decided inside the ``cuda`` fixture,
so every worker collects the same tests). This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.esc10_mp import FILTERBANK, make_pipeline
from repro_torch.core.filterbank import FilterBank
from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.fir_mp import (fir_mp_bank_kernel, fir_mp_kernel,
                                        fir_mp_stream_octave)

pytestmark = pytest.mark.cuda

TOL = 1e-5   # each output within TOL * (1 + max |plain|)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    bound = TOL * (1 + float(want.abs().max()))
    assert float((got - want).abs().max()) <= bound


@pytest.fixture
def bank(dev):
    return FilterBank(FILTERBANK, device=dev)


@pytest.mark.parametrize("L", [1, 7, 160, 256, 600])
@pytest.mark.parametrize("solver", ["newton", "bisect"])
def test_stream_octave_kernel_matches_plain(dev, bank, L, solver):
    g = torch.Generator().manual_seed(L)
    S, F, T1 = 37, 5, 15
    n = torch.randint(0, L + 1, (S,), generator=g, dtype=torch.int32)
    n[0], n[1] = 0, L
    x = torch.randn(S, L, generator=g)
    x = torch.where(torch.arange(L)[None] < n[:, None], x, 0.0)
    args = [t.to(dev) for t in (
        x, n, torch.randint(0, 2, (S,), generator=g, dtype=torch.int32),
        torch.randn(S, T1, generator=g), torch.rand(S, F, generator=g),
        torch.rand(S, generator=g))] + [bank.bp_by_octave[1],
                                        bank.lp_filters[1]]
    kw = dict(scale=2.0, solver=solver, emit_next=True, update_amax=True)
    reset_launches()
    got = fir_mp_stream_octave(*args, 4.0, **kw)
    assert LAUNCHES["fir_mp_stream_octave"] == 1
    want = ref.fir_mp_stream_octave(*args, 4.0, **kw)
    for a, b in zip(got, want):
        _close(a, b)
    assert torch.equal(got[0][0], args[4][0])      # the n == 0 slot
    assert torch.equal(got[1][0], args[3][0])


@pytest.mark.parametrize("B,N", [(1, 5), (3, 300), (8, 4000)])
def test_bank_kernels_match_plain(dev, bank, B, N):
    x = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (B, N)).astype(np.float32)).to(dev)
    H, h = bank.bp_by_octave[0], bank.lp_filters[0]
    reset_launches()
    _close(fir_mp_bank_kernel(x, H, 4.0), ref.fir_mp_bank(x, H, 4.0))
    _close(fir_mp_bank_kernel(x, H, 4.0, accumulate=True),
           ref.fir_mp_bank_accumulate(x, H, 4.0))
    _close(fir_mp_kernel(x, h, 4.0), ref.fir_mp(x, h, 4.0))
    _close(fir_mp_kernel(x, h, 4.0, accumulate=True),
           ref.fir_mp_accumulate(x, h, 4.0))
    assert (LAUNCHES["fir_mp_bank"], LAUNCHES["fir_mp"]) == (2, 2)


@pytest.mark.parametrize("quant_bits,solver", [(None, "newton"),
                                               (8, "newton"),
                                               (None, "bisect")])
def test_session_step_through_the_kernel_matches_torch_ops(dev, quant_bits,
                                                           solver):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (16, 700)).astype(np.float32)).to(dev)
    out = {}
    for impl in ("pallas", "xla"):
        base = make_pipeline(stream_impl=impl, use_pallas=False,
                             quant_bits=quant_bits)
        pipe = InFilterPipeline(base.config._replace(solver=solver),
                                base.bp_taps, base.lp_taps, base.mu,
                                base.sigma, base.clf.params)
        state = pipe.init_session(16)
        reset_launches()
        for i in range(0, 700, 160):
            p, state = pipe.apply(x[:, i:i + 160], state)
        out[impl] = (p, state.acc, LAUNCHES["fir_mp_stream_octave"])
    assert out["pallas"][2] == 6 * 5 and out["xla"][2] == 0
    _close(out["pallas"][1], out["xla"][1])
    _close(out["pallas"][0], out["xla"][0])
