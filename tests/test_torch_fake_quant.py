"""Port vs reference: the fake-quant twin and the paper's 8-bit deployment
flow, on the CPU.

The fake-quant twin is the integer datapath on integer codes carried in
float32. Its plain versions in the port (``kernels.ref``, which the
wrappers run for CPU tensors and ``chip_smoke.py`` holds the CUDA
kernels' float instances against) are held here against the reference's
Pallas integer kernels run on f32 carriers in interpret mode, exactly:
below 2**24 every value is an exact integer. The deployment flow (QAT at
8 bits through ``fit``, the MAC baseline's features, ``fixed.predict``
on the float carrier through the bank kernel's route) is held against
the reference's with the tolerances stated at each test. Inputs are
seeded numpy arrays given to both packages; golden pipelines are built
under ``jax.threefry_partitionable(False)`` as tests/test_torch_fixed.py
does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from golden_cases import CASES, build_pipeline, make_audio
from repro.configs import esc10_mp as ref_esc
from repro.core import fixed as fx_ref
from repro.core import pipeline as pipe_ref
from repro.core import trainer as trainer_ref
from repro.core.filterbank import FilterBank as RefFilterBank
from repro.kernels.fir_mp import fir_mp_bank_q_pallas
from repro.kernels.fir_mp import fir_mp_stream_octave_q as pallas_stream_q
from repro_torch import bridge
from repro_torch.configs import esc10_mp
from repro_torch.core import fixed as fx
from repro_torch.core import trainer
from repro_torch.core.filterbank import FilterBank
from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.data.acoustic import make_esc10_like
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.fir_mp import (fir_mp_bank_q_kernel,
                                        fir_mp_oneshot_cascade_q,
                                        fir_mp_stream_cascade_q,
                                        fir_mp_stream_octave_q)

from test_torch_train import (FIT_LOSS_TOL, FIT_PARAM_TOL, GRAD_TOL,
                              TRAIN_TOL, _check_params, _close, _np,
                              _params_np, _same_start)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run loops of small torch ops (SGD steps, per-octave
    solves). Under a parallel test run every worker holds a full intra-op
    thread pool, and such loops then slow by two orders of magnitude;
    with one thread they keep their one-process time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32, (what, got.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@functools.lru_cache(maxsize=1)
def _programs(seed=0):
    """The reference's and the port's compiled program of one golden
    pipeline, calibrated on its audio (made once per process: read
    only)."""
    case = dict(CASES["esc_mp_f32"], seed=seed)
    with jax.threefry_partitionable(False):
        ref_pipe = build_pipeline(case)
    x = make_audio(case)
    port = bridge.pipeline_from_numpy(
        ref_pipe.config, [np.asarray(t) for t in ref_pipe.bp_taps],
        [np.asarray(t) for t in ref_pipe.lp_taps], np.asarray(ref_pipe.mu),
        np.asarray(ref_pipe.sigma), [np.asarray(a) for a in ref_pipe.clf],
        device="cpu")
    return (fx_ref.compile_pipeline(ref_pipe, calibration_audio=x),
            fx.compile_pipeline(port, calibration_audio=x), x)


# -- the plain float-carried versions vs the reference's Pallas kernels ------


@pytest.mark.parametrize("o,lp,accumulate", [(0, False, True),
                                              (1, True, False)])
def test_plain_bank_q_on_float_codes_matches_pallas(o, lp, accumulate):
    """``fir_mp_bank_q_pallas`` on f32-carried codes (interpret mode), band
    and accumulate modes, against the port's plain version and the
    wrapper's CPU route: the same float32 values."""
    prog_r, prog, _ = _programs()
    rng = np.random.default_rng(25 + o)
    st = prog.bank.octaves[o]
    H, spec = (st.lp_q, st.lp_spec) if lp else (st.bp_q, st.band_spec)
    g, it = (st.gamma_lp, st.iters_lp) if lp else (st.gamma_bp,
                                                   st.iters_bp)
    x = rng.integers(-300, 300, (3, 130)).astype(np.float32)
    want = fir_mp_bank_q_pallas(
        jnp.asarray(x), jnp.asarray(H), gamma_q=g, iters=it,
        qmin=spec.qmin, qmax=spec.qmax, accumulate=accumulate,
        interpret=True)
    if not accumulate:
        want = jnp.moveaxis(want, 0, 1)       # (F, B, N) -> (B, F, N)
    kw = dict(gamma_q=g, iters=it, qmin=spec.qmin, qmax=spec.qmax)
    got = (ref.fir_mp_bank_q_accumulate if accumulate
           else ref.fir_mp_bank_q)(torch.from_numpy(x), H, **kw)
    _eq(got, want, f"octave {o} lp={lp}")
    reset_launches()
    _eq(fir_mp_bank_q_kernel(torch.from_numpy(x), H,
                             accumulate=accumulate, **kw), want)
    assert LAUNCHES["fir_mp_bank_q"] == 0


@pytest.mark.parametrize("S,L,o,emit,update_amax", [
    (5, 600, 0, True, True), (4, 9, 2, False, False)])
def test_plain_stream_octave_q_on_float_codes_matches_pallas(
        monkeypatch, S, L, o, emit, update_amax):
    """``fir_mp_stream_octave_q`` on f32-carried registers (interpret
    mode) against the port's plain version and the wrapper's CPU route,
    every output exactly."""
    # the reference names TPUCompilerParams, which newer JAX calls
    # CompilerParams; interpret mode ignores it either way
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    prog_r, prog, _ = _programs()
    st, st_r = prog.bank.octaves[o], prog_r.bank.octaves[o]
    nxt = prog.bank.octaves[o + 1].in_spec if emit else None
    nxt_r = prog_r.bank.octaves[o + 1].in_spec if emit else None
    rng = np.random.default_rng(L + 25)
    T1, Fn = 15, st.bp_q.shape[0]
    n = rng.integers(0, L + 1, S).astype(np.int32)
    n[0], n[1], n[-1] = 0, L, 1
    x = rng.integers(-128, 128, (S, L)).astype(np.float32)
    x[np.arange(L)[None] >= n[:, None]] = 0
    start = rng.integers(0, 2, S).astype(np.int32)
    regs = (rng.integers(-128, 128, (S, T1)).astype(np.float32),
            rng.integers(0, 5000, (S, Fn)).astype(np.float32),
            rng.integers(0, 100, S).astype(np.float32))
    want = pallas_stream_q(
        jnp.asarray(x), jnp.asarray(n), jnp.asarray(start),
        *map(jnp.asarray, regs), stage=st_r, next_spec=nxt_r,
        emit_next=emit, update_amax=update_amax, interpret=True)
    args = (torch.from_numpy(x), torch.from_numpy(n),
            torch.from_numpy(start), *map(torch.from_numpy, regs))
    kw = dict(stage=st, next_spec=nxt, emit_next=emit,
              update_amax=update_amax)
    reset_launches()
    for got in (ref.fir_mp_stream_octave_q(*args, **kw),
                fir_mp_stream_octave_q(*args, **kw)):
        for g, w, what in zip(got[:3], want[:3], ("acc", "delay", "amax")):
            _eq(g, w, what)
        if emit:
            _eq(got[3], np.asarray(want[3])[:, :(L + 1) // 2], "y_next")
        else:
            assert got[3] is None and want[3] is None
    assert LAUNCHES["fir_mp_stream_octave_q"] == 0


def test_predict_on_the_float_carrier_matches_reference():
    """``fixed.predict(prog, x, carrier="float", use_pallas=True)``: the
    reference runs its Pallas int kernel on f32 codes (interpret mode),
    the port the bank kernel's route (its plain version here); p and phi
    exactly, and exactly the int carrier's."""
    prog_r, prog, x = _programs()
    x = x[:, :400]
    want = jax.jit(lambda v: fx_ref.predict(prog_r, v, carrier="float",
                                            use_pallas=True))(jnp.asarray(x))
    reset_launches()
    got = fx.predict(prog, torch.from_numpy(x), carrier="float",
                     use_pallas=True)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    on_int = fx.predict(prog, torch.from_numpy(x))
    for g, w, i, what in zip(got, want, on_int, ("p", "phi")):
        _eq(g, w, what)
        _eq(g, i, what)
    _, _, s_f = fx.infer_q(prog, fx.quantize_signal(prog, torch.from_numpy(x),
                                                    carrier="float"),
                           use_pallas=True)
    assert s_f.dtype == torch.float32


# -- the wrappers' contract on the carriers -----------------------------------


def test_wrappers_take_float_codes_and_refuse_mixes():
    """Each int kernel wrapper takes f32-carried codes (here its CPU route,
    on the card the kernel's float instance); a call that mixes carriers,
    or codes in another dtype, raises on either device."""
    _, prog, _ = _programs()
    bank = prog.bank
    st = bank.octaves[0]
    rng = np.random.default_rng(7)
    xq = torch.from_numpy(rng.integers(-100, 100, (2, 64)).astype(np.int32))
    got = fir_mp_oneshot_cascade_q(bank, xq.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, fir_mp_oneshot_cascade_q(bank, xq).float())
    kw = dict(gamma_q=st.gamma_bp, iters=st.iters_bp,
              qmin=st.band_spec.qmin, qmax=st.band_spec.qmax)
    assert fir_mp_bank_q_kernel(xq.float(), st.bp_q, **kw).dtype == \
        torch.float32
    for bad in (xq.double(), xq.long()):
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            fir_mp_oneshot_cascade_q(bank, bad)
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            fir_mp_bank_q_kernel(bad, st.bp_q, **kw)
    S, L, O, T1 = 3, 16, len(bank.octaves), 15
    P = sum(s.bp_q.shape[0] for s in bank.octaves)
    chunk = torch.from_numpy(rng.integers(-100, 100, (S, L)).astype(
        np.int32))
    n = torch.full((S,), L, dtype=torch.int32)
    delays = tuple(torch.zeros(S, T1, dtype=torch.int32) for _ in range(O))
    cons = tuple(torch.zeros(S, dtype=torch.int32) for _ in range(O))
    acc = torch.zeros(S, P, dtype=torch.int32)
    amax = torch.zeros(S, dtype=torch.int32)
    want = fir_mp_stream_cascade_q(prog, chunk, n, delays, cons, acc, amax)
    got = fir_mp_stream_cascade_q(prog, chunk.float(), n,
                                  tuple(d.float() for d in delays), cons,
                                  acc.float(), amax.float())
    for g, w in zip(got[0] + (got[2], got[3]), want[0] + (want[2], want[3])):
        assert g.dtype == torch.float32 and torch.equal(g, w.float())
    with pytest.raises(ValueError, match="mixed carriers"):
        fir_mp_stream_cascade_q(prog, chunk.float(), n, delays, cons, acc,
                                amax)
    with pytest.raises(ValueError, match="carried in int32 or in float32"):
        fir_mp_stream_cascade_q(prog, chunk, n, delays, cons, acc.long(),
                                amax)
    with pytest.raises(ValueError, match="mixed carriers"):
        fir_mp_stream_octave_q(chunk, n, n, delays[0].float(),
                               acc[:, :st.bp_q.shape[0]], amax, stage=st,
                               next_spec=bank.octaves[1].in_spec)


# -- the deployment flow: QAT fit, the MAC baseline --------------------------


def test_qat_fit_matches_reference(monkeypatch):
    """``fit`` at 8 bits (``quant_bits=8`` in the bank's config and in the
    trainer's: taps and signal quantized, the STE on every weight) at the
    smoke bank, from the same initial params: the features' statistics,
    the loss trace and the trained params within test_fit_matches_
    reference's tolerances (tests/test_torch_train.py), and the port's
    model and the reference's carried across decide the held-out clips
    alike. The port's bank runs its kernel route (the plain cascade
    here), the reference's its XLA path."""
    ds = make_esc10_like(per_class_train=2, per_class_test=1, fs=4000.0,
                         seconds=0.5, seed=2)
    p0 = _params_np(esc10_mp.FILTERBANK_SMOKE.num_filters, 10, 13)
    _same_start(monkeypatch, p0)
    tc = dict(num_steps=10, lr=0.5, gamma_anneal_start=4.0,
              gamma_anneal_steps=5, quant_bits=esc10_mp.QUANT_BITS)
    want, losses_r = pipe_ref.InFilterPipeline.fit(
        ref_esc.FILTERBANK_SMOKE._replace(quant_bits=ref_esc.QUANT_BITS),
        ds.x_train, ds.y_train, 10, trainer_ref.TrainConfig(**tc))
    got, losses = InFilterPipeline.fit(
        esc10_mp.FILTERBANK_SMOKE._replace(quant_bits=esc10_mp.QUANT_BITS,
                                           use_pallas=True),
        ds.x_train, ds.y_train, 10, trainer.TrainConfig(**tc), device="cpu")
    for a, b in zip(got.bp_taps, want.bp_taps):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    _close(_np(got.mu), want.mu, TRAIN_TOL)
    _close(_np(got.sigma), want.sigma, TRAIN_TOL)
    _close(losses[:5], losses_r[:5], GRAD_TOL)
    _close(losses, losses_r, FIT_LOSS_TOL)
    _check_params(got.clf.params, want.clf, FIT_PARAM_TOL)
    # the reference's trained model carried across decides the held-out
    # clips as the port's own trained model does
    carried = InFilterPipeline(
        got.config, got.bp_taps, got.lp_taps, np.array(want.mu),
        np.array(want.sigma), [np.array(a) for a in want.clf],
        device="cpu")
    assert torch.equal(got.apply(ds.x_test).argmax(-1),
                       carried.apply(ds.x_test).argmax(-1))


def test_mac_baseline_matches_reference():
    """``FILTERBANK_MAC_BASELINE`` (the paper's "Normal SVM" column) is the
    reference's, and its features (a torch einsum over ``unfold`` in
    float32, TF32 off) at the smoke width within 1e-5 x (1 + max) of the
    reference's; its fixed twin's accumulators (the shift-add FIR)
    exactly the reference's."""
    assert esc10_mp.FILTERBANK_MAC_BASELINE._asdict() == \
        ref_esc.FILTERBANK_MAC_BASELINE._asdict()
    cfg = esc10_mp.FILTERBANK_SMOKE._replace(mode="mac")
    x = make_esc10_like(per_class_train=1, per_class_test=1, fs=4000.0,
                        seconds=0.5, seed=4).x_train[:4]
    fb = FilterBank(cfg, device="cpu")
    fb_r = RefFilterBank(ref_esc.FILTERBANK_SMOKE._replace(mode="mac"))
    got = fb.accumulate(torch.from_numpy(x))
    want = np.asarray(jax.jit(fb_r.accumulate)(jnp.asarray(x)))
    np.testing.assert_allclose(
        _np(got), want, rtol=0,
        atol=1e-5 * (1 + float(np.abs(want).max())))
    fixed = cfg._replace(numerics="fixed")
    bank = fx.compile_bank(fixed, fb.bp_by_octave, fb.lp_filters, amax=1.0)
    bank_r = fx_ref.compile_bank(
        ref_esc.FILTERBANK_SMOKE._replace(mode="mac", numerics="fixed"),
        fb_r.bp_by_octave, fb_r.lp_filters, amax=1.0)
    xq = fx.quantize_signal(bank, torch.from_numpy(x))
    np.testing.assert_array_equal(
        _np(fx.bank_accumulate_q(bank, xq, use_pallas=True)),
        np.asarray(jax.jit(lambda v: fx_ref.bank_accumulate_q(bank_r, v))(
            jnp.asarray(_np(xq)))))
