"""Port vs reference: the fixed-point twin (numerics="fixed"), on the CPU.

Every integer output must match exactly (tests/test_golden.py gates the
``*_fixed*_q`` entries the same way). Inputs are seeded numpy arrays given
to both packages; the reference's parameters cross the bridge, and golden
pipelines are built under ``jax.threefry_partitionable(False)`` as
tests/test_torch_pipeline.py does.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from golden_cases import CASES, GOLDEN_DIR, build_pipeline, make_audio
from repro.core import fixed as fx_ref
from repro.core import quant as quant_ref
from repro.kernels.fir_mp import fir_mp_bank_q_pallas
from repro.kernels.fir_mp import fir_mp_stream_octave_q as pallas_stream_q
from repro_torch import bridge
from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.core import fixed as fx
from repro_torch.core import pipeline as pl
from repro_torch.core import quant
from repro_torch.kernels import LAUNCHES, ref, reset_launches
from repro_torch.kernels.fir_mp import (fir_mp_bank_q_kernel,
                                        fir_mp_stream_octave_q)
from repro_torch.serving import StreamServer


def _reference(case):
    with jax.threefry_partitionable(False):
        return build_pipeline(case)


def _port(ref_pipe, **overrides):
    return bridge.pipeline_from_numpy(
        ref_pipe.config, [np.asarray(t) for t in ref_pipe.bp_taps],
        [np.asarray(t) for t in ref_pipe.lp_taps], np.asarray(ref_pipe.mu),
        np.asarray(ref_pipe.sigma), [np.asarray(a) for a in ref_pipe.clf],
        device="cpu", **overrides)


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _carry(a, carrier):
    """numpy codes -> (port tensor, reference array) on one carrier."""
    dt = np.int32 if carrier == "int" else np.float32
    a = np.asarray(a, dt)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


# ---------------------------------------------------------------------------
# core.quant, fixed half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8, 10, 12])
def test_fixed_point_spec_and_pow2_spec_match_reference(bits):
    rng = np.random.default_rng(bits)
    for amax in [1e-3, 0.37, 1.0, 2.5, 127.0, 1000.0,
                 *rng.uniform(0.01, 50, 4)]:
        got = quant.pow2_spec_for(None, bits, amax=float(amax))
        want = quant_ref.pow2_spec_for(None, bits, amax=float(amax))
        assert tuple(got) == tuple(want)
        assert (got.qmin, got.qmax, got.scale, got.amax) == \
            (want.qmin, want.qmax, want.scale, want.amax)
        x = (rng.standard_normal(300) * amax * 1.3).astype(np.float32)
        x[:4] = np.float32([0.5, -0.5, 1.5, -2.5]) * np.float32(got.scale)
        for dtype, jdt in ((torch.int32, jnp.int32),
                           (torch.float32, jnp.float32)):
            q = got.quantize(x, dtype=dtype)
            _eq(q, want.quantize(x, dtype=jdt))
            _eq(got.dequantize(q), want.dequantize(want.quantize(x)))
    t = np.random.default_rng(0).standard_normal((3, 7)).astype(np.float32)
    assert tuple(quant.pow2_spec_for(torch.from_numpy(t), bits)) == \
        tuple(quant_ref.pow2_spec_for(t, bits))


# ---------------------------------------------------------------------------
# core.fixed primitives, on both carriers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carrier", ["int", "float"])
def test_shifts_and_rescale_match_reference(carrier):
    rng = np.random.default_rng(1)
    q = rng.integers(-3000, 3000, (4, 41))
    qt, qj = _carry(q, carrier)
    ks = np.arange(41) - 20 if carrier == "float" else np.arange(41)
    for k in (0, 1, 5, 31, 32, 33, 40):
        _eq(fx.shift_right(qt, k), fx_ref.shift_right(qj, k), f"shr {k}")
        _eq(fx.shift_left(qt, k), fx_ref.shift_left(qj, k), f"shl {k}")
        _eq(fx.rescale(qt, -k), fx_ref.rescale(qj, -k), f"rescale -{k}")
        _eq(fx.rescale(qt, k), fx_ref.rescale(qj, k), f"rescale {k}")
    # per-column shift counts up to 40 (in range for the float carrier)
    k_arr = np.asarray(ks if carrier == "int" else np.clip(ks, -20, 20),
                       np.int32)
    k_arr = np.where(np.arange(41) % 2 == 0, k_arr, -k_arr)
    _eq(fx.rescale(qt, k_arr), fx_ref.rescale(qj, jnp.asarray(k_arr)),
        "array rescale")


@pytest.mark.parametrize("carrier", ["int", "float"])
def test_mp_solvers_match_reference(carrier):
    rng = np.random.default_rng(2)
    L = rng.integers(-500, 500, (5, 3, 33))
    Lt, Lj = _carry(L, carrier)
    for gamma in (1, 37, 512):
        it = fx.bisect_iters(gamma)
        assert it == fx_ref.bisect_iters(gamma)
        _eq(fx.fxp_mp_bisect(Lt, gamma, it), fx_ref.fxp_mp_bisect(Lj, gamma, it))
        _eq(fx.fxp_mpabs(Lt, gamma, it), fx_ref.fxp_mpabs(Lj, gamma, it))
    spec = quant.FixedPointSpec(bits=10, exp=-6)
    wt, wj = _carry(rng.integers(-300, 300, (1, 33)), carrier)
    _eq(fx.fxp_mp_dot(Lt, wt, 64, 9, spec),
        fx_ref.fxp_mp_dot(Lj, wj, 64, 9, quant_ref.FixedPointSpec(10, -6)))


@pytest.mark.parametrize("carrier", ["int", "float"])
@pytest.mark.parametrize("pad", [True, False])
def test_fir_primitives_match_reference(carrier, pad):
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (2, 3, 90))
    H = rng.integers(-200, 200, (4, 16))
    xt, xj = _carry(x, carrier)
    spec = quant.FixedPointSpec(bits=10, exp=-7)
    spec_r = quant_ref.FixedPointSpec(bits=10, exp=-7)
    want = fx_ref.fxp_fir_bank(xj, jnp.asarray(H), 512, 12, spec_r, pad=pad)
    for chunk_n in (1024, 16):   # blocking changes memory, not values
        _eq(fx.fxp_fir_bank(xt, H, 512, 12, spec, chunk_n=chunk_n, pad=pad),
            want, f"fir_bank chunk_n={chunk_n}")
    h = rng.integers(-128, 128, 6)
    _eq(fx.fxp_fir_shift_add(xt, h, pad=pad),
        fx_ref.fxp_fir_shift_add(xj, h, pad=pad))
    valid = np.asarray([5, 90]).reshape(2, 1, 1)
    y = np.array(want)
    _eq(fx.fxp_hwr_accumulate(torch.from_numpy(y), torch.from_numpy(valid)),
        fx_ref.fxp_hwr_accumulate(jnp.asarray(y), jnp.asarray(valid)))
    assert [fx._csd(v) for v in (0, 7, -13, 200)] == \
        [fx_ref._csd(v) for v in (0, 7, -13, 200)]


# ---------------------------------------------------------------------------
# lowering: the compiled program equals the reference's, field by field
# ---------------------------------------------------------------------------


def _assert_tree_equal(got, want, path="prog"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_compiled_program_equals_reference(name):
    case = CASES[name]
    ref_pipe = _reference(case)
    x = make_audio(case)
    want = fx_ref.compile_pipeline(ref_pipe, calibration_audio=x)
    got = fx.compile_pipeline(_port(ref_pipe), calibration_audio=x)
    # the octave gains are floor(log2(amax / peak)) over each package's own
    # float low-pass cascade
    assert [o.in_spec.exp for o in got.bank.octaves] == \
        [o.in_spec.exp for o in want.bank.octaves]
    tree = bridge.program_to_numpy(want)
    _assert_tree_equal(bridge.program_to_numpy(got), tree)
    # and the bridge carries the reference's program over unchanged
    _assert_tree_equal(
        bridge.program_to_numpy(bridge.program_from_numpy(tree)), tree)


# ---------------------------------------------------------------------------
# golden fixtures: every *_fixed*_q entry, exactly
# ---------------------------------------------------------------------------


def _stream_fixed(pipe, x, chunk):
    pipe.calibrate_fixed(x)
    state = pipe.init_session(x.shape[0])
    for i in range(0, x.shape[1], chunk):
        p, state = pipe.apply(x[:, i:i + chunk], state)
    scale = pipe.fixed_program().out_spec.scale
    return np.round(p.numpy() / scale).astype(np.int32), state


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_fixed_entries(name):
    case = CASES[name]
    want = dict(np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")))
    ref_pipe = _reference(case)
    x = make_audio(case)
    prog = fx.compile_pipeline(_port(ref_pipe), calibration_audio=x)
    for use_pallas in (False, True):    # the bank kernels' plain versions
        p_q, phi_q, s_q = fx.infer_q(prog, fx.quantize_signal(prog, x),
                                     use_pallas=use_pallas)
        _eq(p_q, want["p_fixed_q"], f"{name}: p_fixed_q")
        _eq(phi_q, want["phi_fixed_q"], f"{name}: phi_fixed_q")
        _eq(s_q, want["acc_fixed_q"], f"{name}: acc_fixed_q")
    for impl, key in (("xla", "stream_fixed_q"),
                      ("pallas", "stream_fixed_pallas_q")):
        pipe = _port(ref_pipe, numerics="fixed", stream_impl=impl)
        p_s, state = _stream_fixed(pipe, x, case["chunk"])
        _eq(p_s, want[f"p_{key}"], f"{name}: p_{key}")
        _eq(state.acc, want[f"acc_{key}"], f"{name}: acc_{key}")
        assert state.acc.dtype == state.delays[0].dtype == torch.int32


# ---------------------------------------------------------------------------
# the integer kernels' plain versions vs the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _smoke_program(seed=0):
    case = dict(CASES["esc_mp_f32"], seed=seed)
    ref_pipe = _reference(case)
    x = make_audio(case)
    return (fx_ref.compile_pipeline(ref_pipe, calibration_audio=x),
            fx.compile_pipeline(_port(ref_pipe), calibration_audio=x))


@pytest.mark.parametrize("accumulate", [False, True])
def test_plain_bank_q_matches_pallas(accumulate):
    prog_r, prog = _smoke_program()
    rng = np.random.default_rng(4)
    for o, lp in ((0, False), (1, False), (0, True)):
        st, st_r = prog.bank.octaves[o], prog_r.bank.octaves[o]
        H, spec = (st.lp_q, st.lp_spec) if lp else (st.bp_q, st.band_spec)
        g, it = (st.gamma_lp, st.iters_lp) if lp else (st.gamma_bp,
                                                       st.iters_bp)
        x = rng.integers(-300, 300, (3, 130)).astype(np.int32)
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
        # the wrapper routes a CPU tensor to the plain version, uncounted
        reset_launches()
        assert torch.equal(fir_mp_bank_q_kernel(
            torch.from_numpy(x), H, accumulate=accumulate, **kw), got)
        assert LAUNCHES["fir_mp_bank_q"] == 0
        # carrier-generic: float-carried codes give the same integers
        _eq((ref.fir_mp_bank_q_accumulate if accumulate
             else ref.fir_mp_bank_q)(torch.from_numpy(x).float(), H, **kw),
            np.asarray(got).astype(np.float32))
        assert st_r.gamma_bp == st.gamma_bp


@pytest.mark.parametrize("S,L,o,emit,update_amax", [
    (5, 7, 0, True, True), (3, 600, 1, True, False), (4, 9, 2, False, False)])
def test_plain_stream_octave_q_matches_pallas(monkeypatch, S, L, o, emit,
                                              update_amax):
    # the reference names TPUCompilerParams, which newer JAX calls
    # CompilerParams; interpret mode ignores it either way
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    prog_r, prog = _smoke_program(seed=S)
    st, st_r = prog.bank.octaves[o], prog_r.bank.octaves[o]
    nxt = prog.bank.octaves[o + 1].in_spec if emit else None
    nxt_r = prog_r.bank.octaves[o + 1].in_spec if emit else None
    rng = np.random.default_rng(L)
    T1, Fn = 15, st.bp_q.shape[0]
    n = rng.integers(0, L + 1, S).astype(np.int32)
    n[0], n[1], n[-1] = 0, L, 1           # an inert slot, a full one, one
    x = rng.integers(-128, 128, (S, L)).astype(np.int32)
    x[np.arange(L)[None] >= n[:, None]] = 0
    args = (x, n, rng.integers(0, 2, S).astype(np.int32),
            rng.integers(-128, 128, (S, T1)).astype(np.int32),
            rng.integers(0, 5000, (S, Fn)).astype(np.int32),
            rng.integers(0, 100, S).astype(np.int32))
    want = pallas_stream_q(
        *map(jnp.asarray, args), stage=st_r, next_spec=nxt_r,
        emit_next=emit, update_amax=update_amax, interpret=True)
    got = ref.fir_mp_stream_octave_q(
        *map(torch.from_numpy, args), stage=st, next_spec=nxt,
        emit_next=emit, update_amax=update_amax)
    for g, w, what in zip(got[:3], want[:3], ("acc", "delay", "amax")):
        _eq(g, w, what)
    if emit:
        _eq(got[3], np.asarray(want[3])[:, :(L + 1) // 2], "y_next")
    else:
        assert got[3] is None and want[3] is None
    inert = n == 0
    _eq(got[0].numpy()[inert], args[4][inert])
    _eq(got[1].numpy()[inert], args[3][inert])
    # the wrapper routes CPU tensors to the plain version, uncounted
    reset_launches()
    again = fir_mp_stream_octave_q(
        *map(torch.from_numpy, args), stage=st, next_spec=nxt,
        emit_next=emit, update_amax=update_amax)
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(again, got))
    assert LAUNCHES["fir_mp_stream_octave_q"] == 0


# ---------------------------------------------------------------------------
# sessions: chunked == one-shot, inert slots, int32 registers, serving
# ---------------------------------------------------------------------------


def _fixed_pipe(impl, audio, seed=0):
    pipe = make_pipeline(smoke=True, device="cpu", numerics="fixed",
                         stream_impl=impl, seed=seed)
    pipe.calibrate_fixed(audio)
    return pipe


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_random_chunkings_equal_oneshot_codes(impl):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    pipe = _fixed_pipe(impl, x)
    prog = pipe.fixed_program()
    p_one, phi_one, s_one = fx.infer_q(prog, fx.quantize_signal(prog, x))
    state = pipe.init_session(4, active=[True, True, True, False])
    pos = np.zeros(3, int)
    for L in (0, 1, 1, 37, 0, 64, 5, 200, 300):
        chunk = np.zeros((4, L), np.float32)
        valid = np.zeros(4, np.int32)
        for s in range(3):
            take = min(L if (s + L) % 3 else L // 2, 300 - pos[s])
            chunk[s, :take] = x[s, pos[s]:pos[s] + take]
            valid[s] = take
            pos[s] += take
        chunk[3] = 9.0                     # the inactive slot's junk
        before = bridge.session_to_numpy(state)
        p, phi, state = pipe.apply(chunk, state, valid=valid,
                                   return_features=True)
        after = bridge.session_to_numpy(state)
        for b, a in zip((*before[0], *before[1], *before[2:5]),
                        (*after[0], *after[1], *after[2:5])):
            np.testing.assert_array_equal(b[3], a[3])   # slot 3 is inert
        assert state.acc.dtype == state.amax.dtype == torch.int32
        assert all(d.dtype == torch.int32 for d in state.delays)
    assert pos.tolist() == [300] * 3
    _eq(state.acc[:3], s_one)
    _eq(state.count[:3], np.full(3, 300, np.int32))
    _eq(torch.round(p[:3] / prog.out_spec.scale).to(torch.int32), p_one)
    _eq(torch.round(phi[:3] / prog.phi.scale).to(torch.int32), phi_one)
    assert int(state.amax[0]) == int(fx.quantize_signal(prog, x[0]).abs().max())


def test_cascades_agree_and_carriers_agree():
    """The kernel cascade (plain versions here) and the torch-op cascade
    give the same registers; the torch-op step gives the same integers on
    float-carried registers."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 250)).astype(np.float32)
    states = {}
    for impl in ("xla", "pallas"):
        pipe = _fixed_pipe(impl, x)
        state = pipe.init_session(2)
        for i in range(0, 250, 64):
            _, state = pipe.apply(x[:, i:i + 64], state)
        states[impl] = bridge.session_to_numpy(state)
    for a, b in zip(states["xla"][2:], states["pallas"][2:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((*states["xla"][0], *states["xla"][1]),
                    (*states["pallas"][0], *states["pallas"][1])):
        np.testing.assert_array_equal(a, b)
    prog = pipe.fixed_program()
    leaves = bridge.session_to_numpy(pipe.init_session(2))
    f32 = pl.SessionState(
        tuple(torch.from_numpy(d.astype(np.float32)) for d in leaves[0]),
        tuple(torch.from_numpy(c) for c in leaves[1]),
        torch.from_numpy(leaves[2].astype(np.float32)),
        torch.from_numpy(leaves[3].astype(np.float32)),
        torch.from_numpy(leaves[4]), torch.from_numpy(leaves[5]))
    n = torch.full((2,), 250, dtype=torch.int32)
    for carrier, st in (("int", pipe.init_session(2)), ("float", f32)):
        xq = fx.quantize_signal(prog, x, carrier=carrier)
        st, p_q, _ = fx.session_step_q(prog, st, xq, n)
        states[carrier] = (st.acc.to(torch.int64), p_q.to(torch.int64))
    assert torch.equal(states["int"][0], states["float"][0])
    assert torch.equal(states["int"][1], states["float"][1])
    assert states["int"][0].numpy().tolist() == \
        states["xla"][2].astype(np.int64).tolist()


def test_stream_server_serves_fixed_codes():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 200)).astype(np.float32)
    pipe = _fixed_pipe("pallas", x)
    server = StreamServer(pipe, capacity=4, max_chunk=64, min_chunk=16)
    for sid in ("a", "b", "c"):
        server.open(sid)
    for a, b in ((0, 50), (50, 51), (51, 200)):
        res = server.feed([(sid, x[i, a:b]) for i, sid in
                           enumerate(("a", "b", "c"))])
    assert server.stats()["numerics"] == "fixed"
    assert server.state.acc.dtype == torch.int32
    p_one = pipe.apply(x)
    for i, fr in enumerate(res):
        assert fr.samples_seen == 200
        assert fr.label == int(torch.argmax(p_one[i]))
        assert fr.confidence == float(p_one[i, fr.label])
    p, _ = pipe.apply(np.zeros((4, 0), np.float32), server.state)
    assert torch.equal(p[:3], p_one)


def test_filterbank_and_pipeline_fixed_match_reference():
    case = dict(CASES["esc_mp_bisect"])
    case["cfg"] = dict(case["cfg"], numerics="fixed", fixed_amax=2.0)
    ref_pipe = _reference(case)
    x = make_audio(case)
    port = _port(ref_pipe)
    for rp, pp in ((ref_pipe, port),):
        _eq(pp.apply(x), rp.apply(jnp.asarray(x)), "p")
        _eq(pp.features(x), rp.features(jnp.asarray(x)), "phi")
    from repro.core.filterbank import FilterBank as FBRef
    from repro_torch.core.filterbank import FilterBank, FilterBankConfig
    cfg = FilterBankConfig(**case["cfg"])
    _eq(FilterBank(cfg, device="cpu").accumulate(x),
        FBRef(ref_pipe.config).accumulate(jnp.asarray(x)), "accumulate")
    with pytest.raises(ValueError, match="no effect under"):
        port.features(x, amax=1.0)
    amax = port.init_session(2, amax=3.0).amax
    assert amax.dtype == torch.int32 and math.isclose(
        float(amax[0]), min(round(3.0 / port.fixed_program().signal.scale),
                            port.fixed_program().signal.qmax))
