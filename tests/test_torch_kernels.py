"""The plain PyTorch versions of the CUDA kernels against the reference's
Pallas kernels, run as the reference's own tests run them on the CPU
(interpret mode), and the kernel wrappers' device routing.

Tolerance: 2e-5, the repo's f32 kernel gate (tests/test_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.kernels.fir_mp import fir_mp_stream_octave as pallas_octave
from repro.kernels import ops as pallas_ops
from repro_torch.core.filterbank import FilterBank, FilterBankConfig
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.fir_mp import (fir_mp_bank_kernel, fir_mp_kernel,
                                        fir_mp_stream_octave)

ATOL = 2e-5


def _taps(M=16, M_lp=6, F=3):
    bank = FilterBank(FilterBankConfig(fs=8000.0, num_octaves=2,
                                       filters_per_octave=F, bp_taps=M,
                                       lp_taps=M_lp), device="cpu")
    return bank.bp_by_octave[0].numpy(), bank.lp_filters[0].numpy()


@pytest.mark.parametrize("B,N", [(1, 37), (3, 130)])
def test_plain_bank_matches_pallas(B, N):
    H, lp = _taps()
    x = np.random.default_rng(N).standard_normal((B, N)).astype(np.float32)
    xt, Ht, lpt = map(torch.from_numpy, (x, H, lp))
    for got, want in (
            (ref.fir_mp_bank(xt, Ht, 4.0), pallas_ops.fir_mp_bank(x, H, 4.0)),
            (ref.fir_mp_bank_accumulate(xt, Ht, 4.0),
             pallas_ops.fir_mp_bank_accumulate(x, H, 4.0)),
            (ref.fir_mp(xt, lpt, 4.0), pallas_ops.fir_mp(x, lp, 4.0)),
            (ref.fir_mp_accumulate(xt, lpt, 4.0),
             pallas_ops.fir_mp_accumulate(x, lp, 4.0))):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_tile_sum_order():
    h = torch.rand(2, 3, 700)
    s = ref.tile_sum(h)
    want = sum(h[..., 256 * t:256 * (t + 1)].sum(-1) for t in range(3))
    torch.testing.assert_close(s, want, atol=1e-4, rtol=1e-6)


def _stream_case(S, L, seed, emit, solver):
    rng = np.random.default_rng(seed)
    H, lp = _taps()
    F, T1 = H.shape[0], 15
    n = rng.integers(0, L + 1, S).astype(np.int32)
    n[0], n[1], n[-1] = 0, L, 1      # an inert slot, a full one, an odd one
    x = rng.standard_normal((S, L)).astype(np.float32)
    x[np.arange(L)[None] >= n[:, None]] = 0.0
    args = (x, n, rng.integers(0, 2, S).astype(np.int32),
            rng.standard_normal((S, T1)).astype(np.float32),
            rng.random((S, F)).astype(np.float32),
            rng.random(S).astype(np.float32), H,
            lp if emit else np.zeros(1, np.float32))
    kw = dict(scale=2.0, solver=solver, emit_next=emit, update_amax=True)
    return args, kw


@pytest.mark.parametrize("S,L,emit,solver", [(5, 7, True, "newton"),
                                             (4, 520, True, "newton"),
                                             (3, 40, False, "bisect")])
def test_plain_stream_octave_matches_pallas_bitwise(monkeypatch, S, L, emit,
                                                    solver):
    # the reference names TPUCompilerParams, which newer JAX calls
    # CompilerParams; interpret mode ignores it either way
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    args, kw = _stream_case(S, L, L, emit, solver)
    want = pallas_octave(*map(jnp.asarray, args), 4.0, interpret=True,
                         **kw)
    got = ref.fir_mp_stream_octave(*map(torch.from_numpy, args), 4.0, **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        # the same add DAG on both sides: bit for bit, not merely close
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    inert = args[1] == 0
    np.testing.assert_array_equal(got[0].numpy()[inert], args[4][inert])
    np.testing.assert_array_equal(got[1].numpy()[inert], args[3][inert])
    np.testing.assert_array_equal(got[2].numpy()[inert], args[5][inert])


def test_wrappers_route_cpu_tensors_to_plain_versions():
    args, kw = _stream_case(3, 20, 1, True, "newton")
    targs = [torch.from_numpy(a) for a in args]
    reset_launches()
    got = fir_mp_stream_octave(*targs, 4.0, **kw)
    want = ref.fir_mp_stream_octave(*targs, 4.0, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    x, H = targs[0], targs[6]
    assert torch.equal(fir_mp_bank_kernel(x, H, 4.0),
                       ref.fir_mp_bank(x, H, 4.0))
    assert torch.equal(fir_mp_kernel(x, H[0], 4.0, accumulate=True),
                       ref.fir_mp_accumulate(x, H[0], 4.0))
    # the CPU path runs no kernel, so nothing is counted
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 16, device="meta")
    H = torch.empty(3, 16, device="meta")
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_bank_kernel(x, H, 4.0)
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_kernel(torch.zeros(2, 16), H[0], 4.0)
    with pytest.raises(ValueError, match="unknown MP solver"):
        fir_mp_stream_octave(*[torch.zeros(1)] * 8, 4.0, solver="sgd")


def test_int_wrappers_refuse_other_devices_and_keep_leading_dims():
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import fir_mp_bank_q, fir_mp_bank_q_accumulate
    from repro_torch.kernels.fir_mp import fir_mp_bank_q_kernel
    H = np.random.default_rng(0).integers(-100, 100, (3, 16)).astype(np.int32)
    kw = dict(gamma_q=256, iters=11, qmin=-512, qmax=511)
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_bank_q_kernel(torch.empty(2, 16, dtype=torch.int32,
                                         device="meta"), H, **kw)
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -300, 300, (2, 3, 50)).astype(np.int32))
    spec = ref._Bounds(-512, 511)
    want = fx.fxp_fir_bank(x, H, 256, 11, spec)
    assert torch.equal(fir_mp_bank_q(x, H, **kw), want)
    assert torch.equal(fir_mp_bank_q_accumulate(x, H, **kw),
                       fx.fxp_hwr_accumulate(want))
