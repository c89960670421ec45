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
from repro_torch.core import fixed as fx
from repro_torch.data.acoustic import make_esc10_like
from repro_torch.core.filterbank import FilterBankConfig
from repro_torch.kernels.fir_mp import (fir_mp_bank_kernel,
                                        fir_mp_bank_q_kernel, fir_mp_kernel,
                                        fir_mp_oneshot_cascade,
                                        fir_mp_oneshot_cascade_q,
                                        fir_mp_stream_cascade,
                                        fir_mp_stream_cascade_q,
                                        fir_mp_stream_octave,
                                        fir_mp_stream_octave_q, stream_plan)
from repro_torch.kernels.mp_kernels import (mp_linear_bwd_kernel,
                                            mp_linear_grads_kernel,
                                            mp_linear_kernel,
                                            mp_linear_plan,
                                            mp_waterfill_kernel)
from repro_torch.kernels.ops import mp_linear as mp_linear_op
from repro_torch.core import pipeline as pl
from repro_torch.serving import StreamServer, bucket_length

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


def _registers(g, S, L, n, octaves, F, T1, *, fixed=None):
    """Session registers and a chunk for the cascade tests: n (S,) valid
    counts; consumed counters with odd phases; a chunk zeroed past n."""
    cons = tuple(torch.randint(0, 1000, (S,), generator=g, dtype=torch.int32)
                 for _ in range(octaves))
    if fixed is None:
        x = torch.randn(S, L, generator=g)
        delays = tuple(torch.randn(S, T1, generator=g)
                       for _ in range(octaves))
        acc = torch.rand(S, octaves * F, generator=g)
        amax = torch.rand(S, generator=g)
        zero = 0.0
    else:
        lo, hi = fixed
        i32 = dict(generator=g, dtype=torch.int32)
        x = torch.randint(lo, hi, (S, L), **i32)
        delays = tuple(torch.randint(lo, hi, (S, T1), **i32)
                       for _ in range(octaves))
        acc = torch.randint(0, 1 << 20, (S, octaves * F), **i32)
        amax = torch.randint(0, 128, (S,), **i32)
        zero = 0
    x = torch.where(torch.arange(L)[None] < n[:, None], x, zero)
    return x, delays, cons, acc, amax


def _valid_counts(g, S, L, served):
    if served:                       # a served wave: 160 of a 256 bucket
        return torch.full((S,), min(L, 160), dtype=torch.int32)
    n = torch.randint(0, L + 1, (S,), generator=g, dtype=torch.int32)
    n[0], n[1], n[2] = 0, L, max(1, L - 1 - (L % 2 == 0))   # 0, full, odd
    return n


@pytest.mark.parametrize("S,L,served,solver,update_amax",
                         [(256, 256, True, "newton", True),
                          (37, 700, False, "newton", True),
                          (37, 700, False, "newton", False),
                          (19, 160, False, "bisect", True),
                          (5, 1, False, "newton", True),
                          (9, 33, False, "newton", True)])
def test_stream_cascade_kernel_matches_plain(dev, bank, S, L, served, solver,
                                             update_amax):
    """The whole cascade in one launch against the per-octave plain loop:
    a served wave, two blocks at octave 0 (L = 700), mixed valid counts
    (0, full, odd), odd phases, both solvers, amax updated or not."""
    g = torch.Generator().manual_seed(S * L)
    c = bank.config
    O, F, T1 = c.num_octaves, c.filters_per_octave, 15
    n = _valid_counts(g, S, L, served)
    x, delays, cons, acc, amax = _registers(g, S, L, n, O, F, T1)
    args = [x.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
            tuple(t.to(dev) for t in cons), acc.to(dev), amax.to(dev),
            bank.bp_by_octave, bank.lp_filters, c.gamma_f]
    kw = dict(solver=solver, update_amax=update_amax)
    reset_launches()
    got = fir_mp_stream_cascade(*args, **kw)
    assert LAUNCHES["fir_mp_stream_cascade"] == 1
    assert LAUNCHES["fir_mp_stream_octave"] == 0
    want = ref.fir_mp_stream(*args, **kw)
    for a, b in zip(got[0], want[0]):
        _close(a, b)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    _close(got[2], want[2])
    _close(got[3], want[3])
    inert = n.to(dev) == 0
    assert torch.equal(got[2][inert], args[4][inert])
    for o in range(O):
        assert torch.equal(got[0][o][inert], args[2][o][inert])


@pytest.mark.parametrize("L,threads", [(1, 32), (4, 64), (8, 96),
                                       (16, 192), (600, 256)])
def test_stream_cascade_each_thread_count(dev, bank, L, threads):
    """Every CTA size the plan takes (it follows L) gives the plain
    cascade's result."""
    g = torch.Generator().manual_seed(L)
    c = bank.config
    S, O, F = 21, c.num_octaves, c.filters_per_octave
    assert stream_plan(L, F, c.bp_taps, c.lp_taps, 15,
                       octaves=O)["threads"] == threads
    n = _valid_counts(g, S, L, False)
    x, delays, cons, acc, amax = _registers(g, S, L, n, O, F, 15)
    args = [x.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
            tuple(t.to(dev) for t in cons), acc.to(dev), amax.to(dev),
            bank.bp_by_octave, bank.lp_filters, c.gamma_f]
    got = fir_mp_stream_cascade(*args)
    want = ref.fir_mp_stream(*args)
    _close(got[2], want[2])
    _close(got[3], want[3])
    for a, b in zip(got[0], want[0]):
        _close(a, b)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("B,N", [(1, 5), (3, 300), (8, 4000), (8, 16000)])
def test_oneshot_cascade_kernel_matches_plain(dev, bank, B, N):
    """The whole one-shot cascade in one launch equals the plain
    per-octave composition bit for bit, with the full esc10-mp taps."""
    x = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (B, N)).astype(np.float32)).to(dev)
    reset_launches()
    got = fir_mp_oneshot_cascade(x, bank.bp_by_octave, bank.lp_filters, 4.0)
    assert LAUNCHES["fir_mp_oneshot_cascade"] == 1
    assert LAUNCHES["fir_mp_bank"] == LAUNCHES["fir_mp"] == 0
    want = ref.fir_mp_oneshot_cascade(x, bank.bp_by_octave, bank.lp_filters,
                                      4.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,M_lp,octaves", [(12, 5, 4), (16, 16, 2),
                                            (3, 6, 1)])
def test_oneshot_cascade_generic_taps_match_plain(dev, M, M_lp, octaves):
    """Tap counts other than the configuration's 16 / 6 run the generic
    body: the same bits."""
    cfg = FilterBankConfig(num_octaves=octaves, filters_per_octave=4,
                           bp_taps=M, lp_taps=M_lp)
    fb = FilterBank(cfg, device=dev)
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(
        (5, 777)).astype(np.float32)).to(dev)
    got = fir_mp_oneshot_cascade(x, fb.bp_by_octave, fb.lp_filters, 4.0)
    want = ref.fir_mp_oneshot_cascade(x, fb.bp_by_octave, fb.lp_filters, 4.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_oneshot_apply_runs_one_cascade_launch(dev):
    """One float ``apply`` launches the cascade once and no one-stage
    kernel, and equals the same ``apply`` through the one-stage entries
    (the route before the cascade) bit for bit."""
    pipe = make_pipeline()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 4000)).astype(np.float32)).to(dev)
    reset_launches()
    p, phi = pipe.apply(x, return_features=True)
    assert (LAUNCHES["fir_mp_oneshot_cascade"], LAUNCHES["fir_mp_bank"],
            LAUNCHES["fir_mp"]) == (1, 0, 0)
    parts, x_o = [], x
    for o, H in enumerate(pipe.bp_taps):
        parts.append(fir_mp_bank_kernel(x_o, H, 4.0, accumulate=True)
                     * (2.0 ** o))
        if o < len(pipe.lp_taps):
            x_o = fir_mp_kernel(x_o, pipe.lp_taps[o], 4.0)[..., ::2]
    phi_stages = (torch.cat(parts, -1) - pipe.mu) / pipe.sigma
    assert torch.equal(phi, phi_stages)
    assert torch.equal(p, pipe.clf(phi_stages, exact=False))


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
        out[impl] = (p, state.acc, (LAUNCHES["fir_mp_stream_cascade"],
                                    LAUNCHES["fir_mp_stream_octave"]))
    # one cascade launch per wave, no per-octave launch
    assert out["pallas"][2] == (5, 0) and out["xla"][2] == (0, 0)
    _close(out["pallas"][1], out["xla"][1])
    _close(out["pallas"][0], out["xla"][0])


# ---------------------------------------------------------------------------
# the integer kernels: exactly equal to their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def clips():
    return make_esc10_like(per_class_train=1, per_class_test=1, fs=16000.0,
                           seconds=1.0, seed=0).x_train[:8]


@pytest.fixture
def prog(dev, clips):
    """The full-width esc10-mp program, calibrated on seeded clips."""
    return make_pipeline(numerics="fixed").calibrate_fixed(clips)


def _exact(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,L,o", [(37, 7, 0), (256, 256, 1), (5, 600, 3),
                                   (9, 33, 5)])
def test_stream_octave_q_kernel_matches_plain(dev, prog, S, L, o):
    g = torch.Generator().manual_seed(L)
    stages = prog.bank.octaves
    st = stages[o]
    emit = st.lp_q is not None
    Fn, T1 = st.bp_q.shape[0], 15
    n = torch.randint(0, L + 1, (S,), generator=g, dtype=torch.int32)
    n[0], n[1] = 0, L
    x = torch.randint(-128, 128, (S, L), generator=g, dtype=torch.int32)
    x = torch.where(torch.arange(L)[None] < n[:, None], x, 0)
    args = [t.to(dev) for t in (
        x, n, torch.randint(0, 2, (S,), generator=g, dtype=torch.int32),
        torch.randint(-128, 128, (S, T1), generator=g, dtype=torch.int32),
        torch.randint(0, 1 << 20, (S, Fn), generator=g, dtype=torch.int32),
        torch.randint(0, 128, (S,), generator=g, dtype=torch.int32))]
    kw = dict(stage=st, next_spec=stages[o + 1].in_spec if emit else None,
              emit_next=emit, update_amax=(o == 0))
    reset_launches()
    got = fir_mp_stream_octave_q(*args, **kw)
    assert LAUNCHES["fir_mp_stream_octave_q"] == 1
    want = ref.fir_mp_stream_octave_q(*args, **kw)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            _exact(a, b)
    assert torch.equal(got[0][0], args[4][0])      # the n == 0 slot
    assert torch.equal(got[1][0], args[3][0])


@pytest.mark.parametrize("S,L,served", [(256, 256, True), (37, 700, False),
                                        (5, 1, False), (9, 33, False),
                                        (21, 8, False), (21, 600, False)])
def test_stream_cascade_q_kernel_matches_plain(dev, prog, S, L, served):
    """The int cascade in one launch against the per-octave plain loop,
    exactly: a served wave, two blocks at octave 0, mixed valid counts,
    odd phases, CTAs of 32 to 256 threads (the plan's, by L)."""
    g = torch.Generator().manual_seed(S + L)
    O = len(prog.bank.octaves)
    F = prog.bank.octaves[0].bp_q.shape[0]
    n = _valid_counts(g, S, L, served)
    x, delays, cons, acc, amax = _registers(g, S, L, n, O, F, 15,
                                            fixed=(-128, 128))
    args = [x.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
            tuple(t.to(dev) for t in cons), acc.to(dev), amax.to(dev)]
    reset_launches()
    got = fir_mp_stream_cascade_q(prog, *args)
    assert LAUNCHES["fir_mp_stream_cascade_q"] == 1
    assert LAUNCHES["fir_mp_stream_octave_q"] == 0
    want = ref.fir_mp_stream_q(prog, *args)
    for gs, ws in zip(got[:2], want[:2]):
        for a, b in zip(gs, ws):
            _exact(a, b)
    _exact(got[2], want[2])
    _exact(got[3], want[3])
    inert = args[1] == 0
    assert torch.equal(got[2][inert], args[4][inert])


@pytest.mark.parametrize("B,N", [(1, 5), (3, 300), (8, 4000)])
def test_bank_q_kernel_matches_plain(dev, prog, B, N):
    g = torch.Generator().manual_seed(N)
    x = torch.randint(-600, 600, (B, N), generator=g,
                      dtype=torch.int32).to(dev)
    reset_launches()
    calls = 0
    for st in prog.bank.octaves[::2]:
        for H, spec, gq, it in ((st.bp_q, st.band_spec, st.gamma_bp,
                                 st.iters_bp),
                                (st.lp_q, st.lp_spec, st.gamma_lp,
                                 st.iters_lp)):
            if H is None:
                continue
            kw = dict(gamma_q=gq, iters=it, qmin=spec.qmin, qmax=spec.qmax)
            _exact(fir_mp_bank_q_kernel(x, H, **kw),
                   ref.fir_mp_bank_q(x, H, **kw))
            _exact(fir_mp_bank_q_kernel(x, H, accumulate=True, **kw),
                   ref.fir_mp_bank_q_accumulate(x, H, **kw))
            calls += 2
    assert LAUNCHES["fir_mp_bank_q"] == calls == 12


@pytest.mark.parametrize("B,N", [(1, 5), (1, 255), (3, 301), (8, 4000),
                                 (8, 16000)])
def test_oneshot_cascade_q_kernel_matches_plain(dev, prog, B, N):
    """The whole int one-shot cascade in one launch equals the plain
    per-octave composition bit for bit, with the full esc10-mp program:
    ADC codes over their whole 8-bit range, odd and short lengths."""
    g = torch.Generator().manual_seed(N)
    s = prog.bank.signal
    xq = torch.randint(s.qmin, s.qmax + 1, (B, N), generator=g,
                       dtype=torch.int32).to(dev)
    reset_launches()
    got = fir_mp_oneshot_cascade_q(prog.bank, xq)
    assert LAUNCHES["fir_mp_oneshot_cascade_q"] == 1
    assert LAUNCHES["fir_mp_bank_q"] == 0
    _exact(got, ref.fir_mp_oneshot_cascade_q(prog.bank, xq))


@pytest.mark.parametrize("M,M_lp,octaves", [(12, 5, 4), (16, 8, 2),
                                            (3, 6, 1)])
def test_oneshot_cascade_q_generic_taps_match_plain(dev, clips, M, M_lp,
                                                    octaves):
    """Tap counts other than the configuration's 16 / 6 run the generic
    body: the same bits."""
    cfg = FILTERBANK._replace(num_octaves=octaves, filters_per_octave=4,
                              bp_taps=M, lp_taps=M_lp, numerics="fixed")
    fb = FilterBank(cfg, device=dev)
    bank = fx.compile_bank(cfg, fb.bp_by_octave, fb.lp_filters, amax=1.0)
    xq = fx.quantize_signal(bank, torch.from_numpy(clips[:5, :777]).to(dev))
    got = fir_mp_oneshot_cascade_q(bank, xq)
    _exact(got, ref.fir_mp_oneshot_cascade_q(bank, xq))
    # the one-stage entry on the same generic widths, both modes
    st = bank.octaves[0]
    kw = dict(gamma_q=st.gamma_bp, iters=st.iters_bp,
              qmin=st.band_spec.qmin, qmax=st.band_spec.qmax)
    x0 = fx.rescale(xq, st.sig_shift)
    _exact(fir_mp_bank_q_kernel(x0, st.bp_q, **kw),
           ref.fir_mp_bank_q(x0, st.bp_q, **kw))
    _exact(fir_mp_bank_q_kernel(x0, st.bp_q, accumulate=True, **kw),
           ref.fir_mp_bank_q_accumulate(x0, st.bp_q, **kw))


def test_fixed_oneshot_apply_runs_one_cascade_launch(dev, clips):
    """One fixed ``apply`` launches the int cascade once and no one-stage
    kernel; its p and phi codes equal the torch-op path's exactly."""
    pipe = make_pipeline(numerics="fixed")
    prog = pipe.calibrate_fixed(clips)
    x = torch.from_numpy(clips).to(dev)
    reset_launches()
    p, phi = pipe.apply(x, return_features=True)
    assert (LAUNCHES["fir_mp_oneshot_cascade_q"],
            LAUNCHES["fir_mp_bank_q"]) == (1, 0)
    p2, phi2 = fx.predict(prog, x, use_pallas=False)
    torch.cuda.synchronize()
    assert torch.equal(p, p2) and torch.equal(phi, phi2)


def test_int_kernels_refuse_float_carried_codes(dev, prog):
    """What the int kernels refuse of float-carried codes: a call whose
    codes mix float32 and int32, and codes in any other dtype (both
    carriers are taken alone; the tests below)."""
    st = prog.bank.octaves[0]
    x = torch.zeros(2, 16, device=dev)
    for bad in (x.double(), x.long()):
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            fir_mp_oneshot_cascade_q(prog.bank, bad)
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            fir_mp_bank_q_kernel(bad, st.bp_q, gamma_q=st.gamma_bp,
                                 iters=st.iters_bp, qmin=st.band_spec.qmin,
                                 qmax=st.band_spec.qmax)
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="mixed carriers"):
        fir_mp_stream_octave_q(x, i32(2), i32(2), i32(2, 15), i32(2, 5),
                               i32(2), stage=st,
                               next_spec=prog.bank.octaves[1].in_spec)


# -- the fake-quant twin: the int kernels' float32 instances ------------------


def _twin(got_f, got_i, want_f):
    """A float-carrier kernel's output: float32, the int kernel's codes
    (every value an integer below 2**24 here) and its plain version's,
    exactly (+0 and -0 equal, as codes)."""
    torch.cuda.synchronize()
    assert got_f.dtype == want_f.dtype == torch.float32
    assert got_i.dtype == torch.int32
    assert float(got_i.abs().max()) < 2 ** 24
    assert torch.equal(got_f, got_i.float())
    assert torch.equal(got_f, want_f)


def _f32(args, counters=(1, 2)):
    """The codes of a kernel call's args on the float carrier; the args at
    ``counters`` (valid counts, phases, consumed) stay int32."""
    return [t if k in counters else
            (tuple(a.float() for a in t) if isinstance(t, tuple)
             else t.float()) for k, t in enumerate(args)]


@pytest.mark.parametrize("S,L,o", [(37, 7, 0), (256, 256, 1), (9, 33, 5)])
def test_stream_octave_q_float_carrier(dev, prog, S, L, o):
    g = torch.Generator().manual_seed(L + 1)
    stages = prog.bank.octaves
    st = stages[o]
    emit = st.lp_q is not None
    Fn, T1 = st.bp_q.shape[0], 15
    n = torch.randint(0, L + 1, (S,), generator=g, dtype=torch.int32)
    n[0], n[1] = 0, L
    x = torch.randint(-128, 128, (S, L), generator=g, dtype=torch.int32)
    x = torch.where(torch.arange(L)[None] < n[:, None], x, 0)
    args = [t.to(dev) for t in (
        x, n, torch.randint(0, 2, (S,), generator=g, dtype=torch.int32),
        torch.randint(-128, 128, (S, T1), generator=g, dtype=torch.int32),
        torch.randint(0, 1 << 20, (S, Fn), generator=g, dtype=torch.int32),
        torch.randint(0, 128, (S,), generator=g, dtype=torch.int32))]
    kw = dict(stage=st, next_spec=stages[o + 1].in_spec if emit else None,
              emit_next=emit, update_amax=(o == 0))
    fargs = _f32(args)
    reset_launches()
    got = fir_mp_stream_octave_q(*fargs, **kw)
    assert LAUNCHES["fir_mp_stream_octave_q_f32"] == 1
    assert LAUNCHES["fir_mp_stream_octave_q"] == 0
    got_i = fir_mp_stream_octave_q(*args, **kw)
    want = ref.fir_mp_stream_octave_q(*fargs, **kw)
    for a, b, c in zip(got, got_i, want):
        if c is None:
            assert a is None
        else:
            _twin(a, b, c)


@pytest.mark.parametrize("S,L,served", [(256, 256, True), (37, 700, False)])
def test_stream_cascade_q_float_carrier(dev, prog, S, L, served):
    g = torch.Generator().manual_seed(S + L + 1)
    O = len(prog.bank.octaves)
    F = prog.bank.octaves[0].bp_q.shape[0]
    n = _valid_counts(g, S, L, served)
    x, delays, cons, acc, amax = _registers(g, S, L, n, O, F, 15,
                                            fixed=(-128, 128))
    args = [x.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
            tuple(t.to(dev) for t in cons), acc.to(dev), amax.to(dev)]
    fargs = _f32(args, counters=(1, 3))
    reset_launches()
    got = fir_mp_stream_cascade_q(prog, *fargs)
    assert LAUNCHES["fir_mp_stream_cascade_q_f32"] == 1
    assert LAUNCHES["fir_mp_stream_cascade_q"] == 0
    got_i = fir_mp_stream_cascade_q(prog, *args)
    want = ref.fir_mp_stream_q(prog, *fargs)
    for a, b, c in zip(got[0], got_i[0], want[0]):
        _twin(a, b, c)
    for a, c in zip(got[1], want[1]):       # consumed counters stay int32
        assert torch.equal(a, c) and a.dtype == torch.int32
    _twin(got[2], got_i[2], want[2])
    _twin(got[3], got_i[3], want[3])


@pytest.mark.parametrize("B,N", [(1, 5), (3, 301), (8, 16000)])
def test_oneshot_cascade_q_float_carrier(dev, prog, B, N):
    g = torch.Generator().manual_seed(N + 1)
    s = prog.bank.signal
    xq = torch.randint(s.qmin, s.qmax + 1, (B, N), generator=g,
                       dtype=torch.int32).to(dev)
    reset_launches()
    got = fir_mp_oneshot_cascade_q(prog.bank, xq.float())
    assert LAUNCHES["fir_mp_oneshot_cascade_q_f32"] == 1
    assert LAUNCHES["fir_mp_oneshot_cascade_q"] == 0
    _twin(got, fir_mp_oneshot_cascade_q(prog.bank, xq),
          ref.fir_mp_oneshot_cascade_q(prog.bank, xq.float()))
    # the one-stage entry, both modes, on octave 0's stage
    st = prog.bank.octaves[0]
    kw = dict(gamma_q=st.gamma_bp, iters=st.iters_bp,
              qmin=st.band_spec.qmin, qmax=st.band_spec.qmax)
    x0 = fx.rescale(xq, st.sig_shift)
    for acc in (False, True):
        fn = ref.fir_mp_bank_q_accumulate if acc else ref.fir_mp_bank_q
        _twin(fir_mp_bank_q_kernel(x0.float(), st.bp_q, accumulate=acc,
                                   **kw),
              fir_mp_bank_q_kernel(x0, st.bp_q, accumulate=acc, **kw),
              fn(x0.float(), st.bp_q, **kw))


def test_float_carrier_right_shift_past_32_is_minus_one(dev, prog):
    """A right shift by 140 (past 32, into f32's denormals) of a negative
    float-carried code is -1, of another code 0, as on int32: the kernel
    keeps denormals (flushed to zero, floor would give -0, and every
    window would differ from the int kernel's)."""
    import dataclasses
    stages = prog.bank.octaves
    st = dataclasses.replace(stages[0], sig_shift=-140)
    g = torch.Generator().manual_seed(140)
    S, L, T1 = 16, 64, 15
    x = torch.randint(-128, 128, (S, L), generator=g, dtype=torch.int32)
    args = [t.to(dev) for t in (
        x, torch.full((S,), L, dtype=torch.int32),
        torch.zeros(S, dtype=torch.int32),
        torch.randint(-128, 128, (S, T1), generator=g, dtype=torch.int32),
        torch.zeros(S, st.bp_q.shape[0], dtype=torch.int32),
        torch.zeros(S, dtype=torch.int32))]
    fargs = _f32(args)
    kw = dict(stage=st, next_spec=stages[1].in_spec, emit_next=True)
    shifted = fx.rescale(fargs[0], -140)
    assert torch.equal(shifted, torch.where(fargs[0] < 0, -1.0, 0.0))
    got = fir_mp_stream_octave_q(*fargs, **kw)
    got_i = fir_mp_stream_octave_q(*args, **kw)
    want = ref.fir_mp_stream_octave_q(*fargs, **kw)
    for a, b, c in zip(got, got_i, want):
        _twin(a, b, c)


def test_float_carrier_sums_past_2_24_are_deterministic(dev, prog):
    """A long clip (a full-scale 6.8 kHz tone) whose accumulators pass
    2**24: the float instance gives the same bits on two runs (its sums
    run in a fixed order) and stays within 2 n 2**-24 |sum| of the plain
    version (n terms per column: any order of n nonnegative f32 adds errs
    by at most (n - 1) 2**-24 of the sum)."""
    s = prog.bank.signal
    B, N = 1, 2 << 20            # ~1.6 x 2**24 summed in octave 0's 4th band
    tone = torch.cos(2 * np.pi * 6800.0 / FILTERBANK.fs
                     * torch.arange(N, dtype=torch.float64))
    xq = torch.round(s.qmax * tone).clamp(s.qmin, s.qmax).float()[None].to(
        dev)
    a = fir_mp_oneshot_cascade_q(prog.bank, xq)
    b = fir_mp_oneshot_cascade_q(prog.bank, xq)
    want = ref.fir_mp_oneshot_cascade_q(prog.bank, xq)
    torch.cuda.synchronize()
    assert float(a.abs().max()) > 2 ** 24
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    F = prog.bank.octaves[0].bp_q.shape[0]
    n = torch.tensor([-(-N // 2 ** o) for o in range(len(prog.bank.octaves))
                      for _ in range(F)], dtype=torch.float32, device=dev)
    bound = 2 * n * 2.0 ** -24 * torch.maximum(a.abs(), want.abs())
    assert bool(((a - want).abs() <= bound).all())


def test_fixed_predict_float_carrier_on_the_card(dev, clips, prog):
    """fixed.predict(carrier="float", use_pallas=True): one launch of the
    float instance, the int carrier's p and phi exactly."""
    x = torch.from_numpy(clips).to(dev)
    reset_launches()
    p_f, phi_f = fx.predict(prog, x, carrier="float", use_pallas=True)
    assert (LAUNCHES["fir_mp_oneshot_cascade_q_f32"],
            LAUNCHES["fir_mp_oneshot_cascade_q"]) == (1, 0)
    p_i, phi_i = fx.predict(prog, x, use_pallas=True)
    torch.cuda.synchronize()
    assert torch.equal(p_f, p_i) and torch.equal(phi_f, phi_i)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fixed_served_codes_equal_oneshot_on_the_card(dev, clips, impl):
    pipe = make_pipeline(numerics="fixed", stream_impl=impl)
    prog = pipe.calibrate_fixed(clips)
    S = 8
    server = StreamServer(pipe, capacity=S, max_chunk=256)
    ids = [f"s{i}" for i in range(S)]
    for sid in ids:
        server.open(sid)
    reset_launches()
    for r in range(5):
        server.feed([(sid, clips[i, r * 160:(r + 1) * 160])
                     for i, sid in enumerate(ids)])
    # one graph replay per wave, each one cascade launch (plus the warm-up
    # run before the bucket's capture), no per-octave launch
    assert server.step_counts()["replays"] == 5
    assert LAUNCHES["fir_mp_stream_cascade_q"] == (5 + 1 if impl == "pallas"
                                                   else 0)
    assert LAUNCHES["fir_mp_stream_octave_q"] == 0
    assert server.state.acc.dtype == torch.int32
    p, _ = pipe.apply(torch.zeros(S, 0, device=dev), server.state)
    x = torch.from_numpy(np.ascontiguousarray(clips[:, :800])).to(dev)
    p_q, _, s_q = fx.infer_q(prog, fx.quantize_signal(prog, x),
                             use_pallas=True)
    _exact(server.state.acc, s_q)
    _exact(torch.round(p / prog.out_spec.scale).to(torch.int32), p_q)


# ---------------------------------------------------------------------------
# the MP solve kernels and the transformer decode step
# ---------------------------------------------------------------------------


# shape -> the path it takes at either weight dtype: w and x tiles resident
# in shared memory, or read from device memory in every pass
MP_LINEAR_PATHS = {
    (1, 300, 37): "resident",       # O off the tile, d off 256
    (3, 1000, 131): "resident",     # a ragged batch tile
    (5, 129, 8): "resident",
    (2, 4096, 1024): "resident",    # the k/v projection
    (2, 4096, 1000): "resident",    # ... with a ragged O
    (2, 12288, 100): "resident",    # the down projection's d
    (2, 12288, 4096): "resident",   # the down projection
    (2, 20000, 9): "global",        # too wide for shared memory
    (2, 40000, 9): "global",
    (2, 80000, 9): "global",
}


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,d,O", list(MP_LINEAR_PATHS))
def test_mp_linear_kernel_matches_plain(dev, B, d, O, w_dtype):
    """Odd shapes (O off the column tile, d off the thread count, B = 1,
    a ragged batch tile), decode shapes (the k/v and down projections),
    the down projection's d on a few columns, and d too wide for the
    resident tiles; w in float32 and in bf16, which the kernel reads as
    it is (the plain version gets w.float())."""
    rng = np.random.default_rng(B * d + O)
    x = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, O))
                          / np.sqrt(d)).astype(np.float32))
    x, w = x.to(dev), w.to(dev).to(w_dtype)
    reset_launches()
    got = mp_linear_kernel(x, w, 8.0)
    assert LAUNCHES["mp_linear"] == 1 and tuple(got.shape) == (B, O)
    _close(got, ref.mp_linear(x, w.float(), 8.0))


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,tile_to", [(1, 8), (1, 4), (1, 2), (2, 8),
                                       (2, 4), (2, 2), (3, 4), (3, 2)])
def test_mp_linear_kernel_each_tile_width(dev, B, tile_to, w_dtype):
    """Every resident tile the kernel has (batch rows 1, 2, 4 by B; 8, 4
    or 2 columns, asked for), on a ragged O and a d off the thread
    count."""
    d, O = 1000, 37
    rng = np.random.default_rng(100 * B + tile_to)
    x = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, O))
                          / np.sqrt(d)).astype(np.float32))
    x, w = x.to(dev), w.to(dev).to(w_dtype)
    plan = mp_linear_plan(B, d, O, w_dtype, tile_to=tile_to)
    assert plan["fits"] and plan["resident"] and plan["TO"] == tile_to
    _close(mp_linear_kernel(x, w, 8.0, tile_to=tile_to),
           ref.mp_linear(x, w.float(), 8.0))


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_mp_linear_plan_takes_each_path(dev, w_dtype):
    """The shapes above reach the paths they are there for; a tile asked
    for that does not fit is refused."""
    for (B, d, O), path in MP_LINEAR_PATHS.items():
        plan = mp_linear_plan(B, d, O, w_dtype)
        got = "resident" if plan["resident"] else "global"
        assert got == path, (B, d, O, plan)
        assert plan["per_sm"] >= 1 and plan["waves"] > 0, plan
    assert not mp_linear_plan(2, 80000, 9, w_dtype, tile_to=2)["fits"]
    x = torch.zeros(2, 80000, device=dev)
    with pytest.raises(ValueError, match="outside what the kernel takes"):
        mp_linear_kernel(x, torch.zeros(80000, 9, device=dev).to(w_dtype),
                         8.0, tile_to=2)
    # every decode shape of qwen3-8b at B = 2 gives each SM a CTA (to
    # within 1/32) in resident tiles
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, O, dt in ((4096, 4096, torch.bfloat16), (4096, 1024, torch.bfloat16),
                     (4096, 12288, torch.bfloat16),
                     (12288, 4096, torch.bfloat16),
                     (4096, 152064, torch.float32)):
        plan = mp_linear_plan(2, d, O, dt)
        assert plan["resident"] and plan["ctas"] * 32 >= sms * 31, plan


def test_mp_linear_op_on_the_card(dev):
    x = torch.randn(2, 3, 64, device=dev)
    w = torch.randn(64, 5, device=dev) / 8
    y = mp_linear_op(x, w, 4.0)
    assert tuple(y.shape) == (2, 3, 5)
    _close(y, ref.mp_linear(x.reshape(6, 64), w, 4.0).reshape(2, 3, 5))
    with pytest.raises(TypeError, match="float32"):
        mp_linear_kernel(x[0].bfloat16(), w, 4.0)


# the backward's shapes: B = 1, O under one column tile, d off the
# thread count and off the grads pass's position and column tiles, a
# ragged batch tile, the k/v projection's and the down projection's d, a d
# too wide for the resident tiles of the levels-writing forward, and more
# rows than one row block of the grads pass
MP_LINEAR_BWD_SHAPES = [(1, 300, 37), (3, 1000, 131), (5, 129, 3),
                        (7, 257, 300), (4, 4096, 1024), (4, 12288, 100),
                        (2, 20000, 9), (70, 200, 260)]


LEVEL_TOL = 1e-6   # x (1 + |z|): two exact solves summing in other orders


def _same_levels(lv, want, near):
    """z within LEVEL_TOL of ``want``'s, 1 / k bit for bit except on a
    branch ``near`` a level, where two solves may take the operand on
    either side."""
    zk, zp = lv[..., :2], want[..., :2]
    assert bool(((zk - zp).abs() <= LEVEL_TOL * (1 + zp.abs())).all())
    assert bool(((lv[..., 2:] == want[..., 2:]) | near).all())


def _check_bwd(x, w, g, gamma):
    """The backward pass by pass: the levels-writing forward's y bit for
    bit the forward alone's; its levels against the sort's and against the
    plain form of the kernel's solve (``_same_levels``); the grads pass
    against the plain dx and dw on its own levels (within TOL), the same
    bits twice, and against the plain version, elementwise where no
    operand of a row or column sits at a level."""
    y, lv = mp_linear_kernel(x, w, gamma, levels=True)
    assert torch.equal(y, mp_linear_kernel(x, w, gamma))
    dx, dw = mp_linear_grads_kernel(x, w, g, lv)
    want = ref.mp_linear_levels(x, w, gamma)
    torch.cuda.synchronize()
    near = ref.mp_linear_near_level(x, w, want[..., :2], LEVEL_TOL)
    _same_levels(lv, want, near)
    _same_levels(lv, ref.mp_linear_with_levels(x, w, gamma)[1], near)
    own_dx, own_dw = ref.mp_linear_bwd_from_levels(x, w, g, lv)
    _close(dx, own_dx)
    _close(dw, own_dw)
    again = mp_linear_grads_kernel(x, w, g, lv)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    want_dx, want_dw = ref.mp_linear_bwd(x, w, g, gamma)
    tie = near.any(-1)                                  # (B, O)
    rows, cols = ~tie.any(1), ~tie.any(0)
    if bool(rows.any()):
        _close(dx[rows], want_dx[rows])
    if bool(cols.any()):
        _close(dw[:, cols], want_dw[:, cols])
    return dx, dw, int(tie.sum())


def _bwd_case(B, d, O, w_dtype, dev, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d, O))
                          / np.sqrt(d)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, O)).astype(np.float32))
    return x.to(dev), w.to(dev).to(w_dtype), g.to(dev)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,d,O", MP_LINEAR_BWD_SHAPES)
def test_mp_linear_bwd_kernel_matches_plain(dev, B, d, O, w_dtype):
    """dx and dw of the backward (the levels-writing forward, then the
    grads pass) against the plain version (the sort-based solve), w in
    float32 and in bf16 (the plain version gets w.float()), pass by pass
    (``_check_bwd``). Tolerance: TOL x (1 + max |plain|), the sums'
    order."""
    x, w, g = _bwd_case(B, d, O, w_dtype, dev, 7 * B + d + O)
    reset_launches()
    got = mp_linear_bwd_kernel(x, w, g, 8.0)
    assert LAUNCHES["mp_linear_bwd"] == 1 and LAUNCHES["mp_linear"] == 1
    dx, dw, _ = _check_bwd(x, w, g, 8.0)
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)
    assert tuple(dx.shape) == (B, d) and tuple(dw.shape) == (d, O)


@pytest.mark.parametrize("B,d,O,w_dtype", [
    (64, 12288, 4096, torch.bfloat16),    # the down projection, not resident
    (64, 4096, 1024, torch.bfloat16),     # k / v
    (62, 4096, 152064, torch.float32)])   # the head
def test_mp_linear_levels_forward_at_train_shapes(dev, B, d, O, w_dtype):
    """The train step's own plans (BB = 4; resident and not): the
    levels-writing forward's y bit for bit the forward alone's; its levels
    on a few columns (the first, and the ragged last chunk's) against the
    plain form's and the sort's; the grads pass the same bits twice, and
    its dw on those columns against the plain grads on its levels."""
    x, w, g = _bwd_case(B, d, O, w_dtype, dev, B + d + O)
    x = x.bfloat16().float()     # the model's activations are bf16-valued
    plan = mp_linear_plan(B, d, O, w_dtype)
    assert plan["BB"] == 4, plan
    y, lv = mp_linear_kernel(x, w, 8.0, levels=True)
    assert torch.equal(y, mp_linear_kernel(x, w, 8.0))
    cols = torch.cat([torch.arange(8), torch.arange(O - 8, O)]).to(dev)
    wc, lc, gc = w[:, cols].float(), lv[:, cols], g[:, cols]
    near = ref.mp_linear_near_level(x, wc, lc[..., :2], LEVEL_TOL)
    _same_levels(lc, ref.mp_linear_with_levels(x, wc, 8.0)[1], near)
    _same_levels(lc, ref.mp_linear_levels(x, wc, 8.0), near)
    dx, dw = mp_linear_grads_kernel(x, w, g, lv)
    again = mp_linear_grads_kernel(x, w, g, lv)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)
    _close(dw[:, cols], ref.mp_linear_bwd_from_levels(x, wc, gc, lc)[1])
    assert bool(torch.isfinite(dx).all())


def test_mp_linear_bwd_kernel_levels_below_zero(dev):
    """Small operands under gamma 8: every level below 0 (the count of
    operands above it is 2 d less the pairs with one member above, and the
    masks' threshold is the float below -z), with some operands outside
    [z, -z], pass by pass (``_check_bwd``)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((0.05 * rng.standard_normal((5, 48))).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((0.05 * rng.standard_normal((48, 70))).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((5, 70)).astype(
        np.float32)).to(dev)
    _, lv = mp_linear_kernel(x, w, 8.0, levels=True)
    assert bool((lv[..., :2] < 0).all())
    dx, dw, _ = _check_bwd(x, w, g, 8.0)
    assert bool((dx != 0).any()) and bool((dw != 0).any())


def test_mp_linear_bwd_kernel_solves_ties_exactly(dev):
    """Integer operands: levels land exactly on operands (ties at the
    support's edge), where the exact solve and the sort agree bit for bit
    (every sum exact) and a bisection midpoint would not (gamma = 3 puts
    the midpoints off the integers)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-3, 4, (6, 50)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (50, 70)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((6, 70)).astype(np.float32))
    x, w, g = x.to(dev), w.to(dev), g.to(dev)
    _, lv = mp_linear_kernel(x, w, 3.0, levels=True)
    dx, dw = mp_linear_grads_kernel(x, w, g, lv)
    assert torch.equal(lv, ref.mp_linear_levels(x, w, 3.0))
    want_dx, want_dw = ref.mp_linear_bwd(x, w, g, 3.0)
    _close(dx, want_dx)
    _close(dw, want_dw)


def test_mp_linear_autograd_launches_the_backward_kernel(dev, monkeypatch):
    """Autograd through ``ops.mp_linear`` on CUDA tensors: one forward and
    one backward launch per call (the forward writes the levels, the
    backward solves none), never the plain backward."""
    def no_plain(*a, **k):
        raise AssertionError("the plain backward ran on the card")
    monkeypatch.setattr(ref, "mp_linear_bwd", no_plain)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(
        np.float32)).to(dev).requires_grad_()
    w = torch.from_numpy((rng.standard_normal((64, 5)) / 8).astype(
        np.float32)).to(dev).bfloat16().requires_grad_()
    reset_launches()
    y = mp_linear_op(x, w, 4.0)
    (y * y).sum().backward()
    assert LAUNCHES["mp_linear"] == 1 and LAUNCHES["mp_linear_bwd"] == 1
    assert x.grad.dtype == torch.float32 and w.grad.dtype == torch.bfloat16
    monkeypatch.undo()
    want_dx, want_dw = ref.mp_linear_bwd(
        x.detach().reshape(6, 64), w.detach().float(),
        2 * y.detach().reshape(6, 5), 4.0)
    _close(x.grad.reshape(6, 64), want_dx)
    # dw comes back rounded to w's bf16: within one bf16 ulp
    torch.testing.assert_close(w.grad.float(), want_dw, rtol=2 ** -8,
                               atol=TOL * (1 + float(want_dw.abs().max())))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "deepseek-moe-16b"])
def test_remat_train_step_is_bit_equal_on_the_card(dev, arch):
    """An MP train step's loss and every gradient, with remat on and
    off, bit for bit on the card: the recomputed forward launches write
    the same levels again (the smoke config, f32 compute; deepseek's
    groups of 8 tokens in 2 chunks, so the MoE chunk is recomputed too).
    Under remat the forwards are launched twice per scanned block."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.distributed.steps import make_loss_fn
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = dataclasses.replace(get_smoke(arch), mp_mode=True,
                              compute_dtype="float32", remat=False,
                              moe_group_size=8, moe_group_chunk=2)
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32))).to(dev)
    runs = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        reset_launches()
        loss = make_loss_fn(c)(leaves, {"tokens": toks})
        loss.backward()
        torch.cuda.synchronize()
        runs.append((loss.detach(), [p.grad for p in tree_leaves(leaves)],
                     LAUNCHES["mp_linear"], LAUNCHES["mp_linear_bwd"]))
    (l0, g0, f0, b0), (l1, g1, f1, b1) = runs
    assert torch.isfinite(l0) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert b0 == b1 == f0 and f0 < f1 < 2 * f0 + 1


def test_fit_on_the_card(dev):
    """``fit`` at the smoke bank on the card: its features in one launch of
    the one-shot cascade kernel, its losses within 1e-3 x (1 + max) of the
    same fit on the CPU (the plain cascade, the same params and batches;
    the sorts and sums run in other orders), and the trained pipeline
    deploys fixed (one launch of the int cascade kernel)."""
    import dataclasses
    from repro_torch.configs.esc10_mp import FILTERBANK_SMOKE, TRAIN
    ds = make_esc10_like(per_class_train=3, per_class_test=2, fs=4000.0,
                         seconds=0.5, seed=0)
    cfg = FILTERBANK_SMOKE._replace(use_pallas=True)
    tc = dataclasses.replace(TRAIN, num_steps=20)
    reset_launches()
    pipe, losses = InFilterPipeline.fit(cfg, ds.x_train, ds.y_train, 10, tc,
                                        device=dev)
    assert LAUNCHES["fir_mp_oneshot_cascade"] == 1
    cpu_pipe, cpu_losses = InFilterPipeline.fit(cfg, ds.x_train, ds.y_train,
                                                10, tc, device="cpu")
    np.testing.assert_allclose(pipe.mu.cpu().numpy(), cpu_pipe.mu.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(losses, cpu_losses, rtol=0,
                               atol=1e-3 * (1 + max(cpu_losses)))
    fixed = InFilterPipeline(cfg._replace(numerics="fixed"), pipe.bp_taps,
                             pipe.lp_taps, pipe.mu, pipe.sigma,
                             pipe.clf.params, device=dev)
    fixed.calibrate_fixed(ds.x_train)
    reset_launches()
    p = fixed.apply(ds.x_test)
    assert LAUNCHES["fir_mp_oneshot_cascade_q"] == 1
    assert bool(torch.isfinite(p).all()) and float(p.abs().max()) <= 1.0


@pytest.mark.parametrize("R,m", [(1, 8), (7, 100), (33, 257), (5, 2000),
                                 (4096, 32), (300, 31), (300, 33), (77, 64),
                                 (77, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mp_waterfill_kernel_matches_plain(dev, R, m, dtype):
    """Rows of one lane (m <= 32) and of groups of 2, 4 and 16 lanes, the
    boundaries between group widths (31 / 33, 64 / 65), a row longer than
    the register path (m > 1024), and the bank's m = 32."""
    L = torch.from_numpy(np.random.default_rng(R + m).standard_normal(
        (R, m)).astype(np.float32) * 3).to(dev).to(dtype)
    reset_launches()
    got = mp_waterfill_kernel(L, 4.0)
    assert LAUNCHES["mp_waterfill"] == 1 and got.dtype == dtype
    want = ref.mp_waterfill(L, 4.0)
    if dtype == torch.float32:
        _close(got, want)
    else:   # both solve in float32; rounding to bf16 may differ by an ulp
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=0,
                                   rtol=2 ** -7)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_decode_step_through_the_kernel_matches_plain(dev, compute_dtype):
    """qwen3-8b at its smoke size, MP mode: one decode step on the card
    (7 projections x 3 layers + the head = 22 launches) against the same
    params on the CPU, where every projection runs the plain version."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), mp_mode=True,
                              compute_dtype=compute_dtype)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_dev = {k: ([{n: {m: t.to(dev) for m, t in sub.items()}
                    for n, sub in layer.items()} for layer in v]
                  if k == "layers" else
                  (v.to(dev) if isinstance(v, torch.Tensor)
                   else {m: t.to(dev) for m, t in v.items()}))
              for k, v in params.items()}
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    want, _ = T.decode_step(params, cfg, tok, T.init_cache(cfg, 2, 2,
                                                           device="cpu"), pos)
    reset_launches()
    got, _ = T.decode_step(on_dev, cfg, tok.to(dev),
                           T.init_cache(cfg, 2, 2, device=dev), pos.to(dev))
    assert LAUNCHES["mp_linear"] == 7 * 3 + 1
    tol = 1e-4 if compute_dtype == "float32" else 3e-2
    torch.cuda.synchronize()
    bound = tol * (1 + float(want.float().abs().max()))
    assert float((got.float().cpu() - want.float()).abs().max()) <= bound


# ---------------------------------------------------------------------------
# the served step as one CUDA graph per bucket
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_captured_step_equals_eager_across_buckets_and_churn(
        dev, clips, numerics, impl):
    """The server's graph replays against ``_session_step`` run eagerly on
    the same waves, bit for bit: decisions and every register, across
    bucket changes (256 -> 512 -> 256 -> 512) and a slot opened and
    closed between replays; one replay per wave, one capture per bucket."""
    pipe = make_pipeline(numerics=numerics, stream_impl=impl)
    if numerics == "fixed":
        pipe.calibrate_fixed(clips)
    S = 8
    reset_launches()
    server = StreamServer(pipe, capacity=S, max_chunk=512)
    ids = [f"s{i}" for i in range(S - 1)]
    for sid in ids:
        server.open(sid)
    state = pl.set_active(pipe.init_session(S, active=np.zeros(S, bool)),
                          list(range(S - 1)), True)
    rng = np.random.default_rng(0)
    lens = [160, 160, 300, 160, 17, 160, 512, 160]
    buckets = set()
    for r, n in enumerate(lens):
        if r == 2:
            assert server.open("v").slot == S - 1
            pl.set_active(pl.clear_slots(state, [S - 1]), [S - 1], True)
        if r == 5:
            server.close("v")
            pl.set_active(state, [S - 1], False)
        sids = ids + (["v"] if 2 <= r < 5 else [])
        reqs = [(sid, rng.standard_normal(n if k % 2 == 0 else 160)
                 .astype(np.float32)) for k, sid in enumerate(sids)]
        res = server.feed(reqs)
        L = bucket_length(max(len(c) for _, c in reqs), 16, 512)
        buckets.add(L)
        chunk = np.zeros((S, L), np.float32)
        valid = np.zeros(S, np.int32)
        for k, (_, c) in enumerate(reqs):
            slot = S - 1 if k == S - 1 else k
            chunk[slot, :len(c)] = c
            valid[slot] = len(c)
        state, p, _ = pipe._session_step(state,
                                         torch.from_numpy(chunk).to(dev),
                                         torch.from_numpy(valid).to(dev))
        for k, fr in enumerate(res):
            row = p[S - 1 if k == S - 1 else k].cpu()
            label = int(torch.argmax(row))
            assert (fr.label, fr.confidence) == (label, float(row[label]))
    torch.cuda.synchronize()
    for a, b in zip(server.state.tensors(), state.tensors()):
        assert torch.equal(a, b)
    counts = server.step_counts()
    assert counts["replays"] == len(lens) and counts["eager_runs"] == 0
    assert counts["captures"] == len(buckets) == 2
    key = ("fir_mp_stream_cascade_q" if numerics == "fixed"
           else "fir_mp_stream_cascade")
    # the eager run above launched once per wave as well
    assert LAUNCHES[key] == ((2 * len(lens) + counts["captures"])
                             if impl == "pallas" else 0)


def test_async_pipeline_on_the_card_equals_feed(dev, clips):
    pipe = make_pipeline()
    S = 8
    sync = StreamServer(pipe, capacity=S, max_chunk=256)
    asy = StreamServer(pipe, capacity=S, max_chunk=256,
                       coalesce_watermark=2)
    ids = [f"s{i}" for i in range(S)]
    for srv in (sync, asy):
        for sid in ids:
            srv.open(sid)
    for r in range(4):
        reqs = [(sid, clips[i, r * 160:(r + 1) * 160])
                for i, sid in enumerate(ids)]
        want = sync.feed(reqs)
        tickets = [asy.submit(reqs[k:k + 2]) for k in range(0, S, 2)]
        assert asy.steps_run == 4 * (r + 1)          # the watermark fired
        while asy.poll(tickets[-1]) is None:
            pass                                     # CUDA events
        got = [x for t in tickets for x in t.results]
        assert [(x.label, x.confidence, x.samples_seen) for x in got] == \
            [(x.label, x.confidence, x.samples_seen) for x in want]
    torch.cuda.synchronize()
    for a, b in zip(sync.state.tensors(), asy.state.tensors()):
        assert torch.equal(a, b)


def test_failed_replay_poisons_the_server(dev, monkeypatch):
    pipe = make_pipeline()
    server = StreamServer(pipe, capacity=4, max_chunk=256)
    server.open("a")
    x = np.zeros(160, np.float32)
    server.feed([("a", x)])                          # captured, replayed

    def fail(self):
        raise RuntimeError("CUDA error: forced replay failure")

    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay", fail)
    with pytest.raises(RuntimeError, match="wave 1") as ei:
        server.feed([("a", x)])
    assert "forced replay failure" in str(ei.value.__cause__)
    monkeypatch.undo()
    for call in (lambda: server.feed([("a", x)]), lambda: server.open("b"),
                 lambda: server.drain()):
        with pytest.raises(RuntimeError, match="poisoned.*wave 1"):
            call()
    assert "bucket 256" in server.stats()["poisoned"]
