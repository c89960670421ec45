"""Port vs reference: the fixed-point IR (``repro_torch.ir``) on the golden
``esc_mp_bisect`` case, on the CPU.

The port's one-shot ``fixed.infer_q`` and per-chunk ``fixed.session_step_q``
are traced into aten graphs (``repro_torch.analysis.traverse``), lowered to
the IR and run through the interpreter, the torch re-emitter and the
compiled C. Every back end must land exactly on the JAX package's integer
codes for the same seeded input, and on the committed golden entries. The
census must equal the reference's census of the same case's jaxpr, split
the way the port counts: the port folds the input-free index arithmetic
and loop counters that the reference's walk counts, so the port's census
is the reference's census of its input-dependent equations, and the two
parts add up to the reference's whole census.
"""

import shutil
import subprocess
from collections import Counter
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_cases import CASES, GOLDEN_DIR, build_pipeline, make_audio
from ir_reference import reference_index_overhead
from repro.analysis import legality as ref_legality
from repro.analysis import traverse as ref_traverse
from repro.core import fixed as fx_ref
from repro_torch import bridge
from repro_torch.analysis import legality, traverse
from repro_torch.analysis.intervals import Interval
from repro_torch.analysis.targets import (session_envelope, session_fn,
                                          session_inputs)
from repro_torch.core import fixed as fx
from repro_torch.ir import (BuildError, build_program, census_program)
from repro_torch.ir import emit_torch
from repro_torch.ir import interp as ir_interp
from repro_torch.ir.cgen import emit_c

CASE = CASES["esc_mp_bisect"]
CHUNK = CASE["chunk"]


# ---------------------------------------------------------------------------
# the reference's census, split into input-dependent and input-free parts
# ---------------------------------------------------------------------------

# call-like primitives: this JAX names the staged call ``jit``
_REF_CALLS = ("pjit", "jit", "closed_call", "custom_vjp_call",
              "custom_jvp_call", "remat", "checkpoint")


def _eqn_census(e, scale: int) -> Counter:
    """The reference's census rule for one leaf equation."""
    L = ref_legality
    name, n, c = e.primitive.name, L._out_elems(e), Counter()
    if name in L.MUL_OPS:
        c["shift" if L.literal_pow2_multiplicand(e) else "multiply"] += n
    elif name in L.ADD_OPS:
        c["add"] += n
    elif name in L.CMP_OPS:
        c["compare"] += n
    elif name in L.SHIFT_OPS:
        c["shift"] += n
    elif name in L.REDUCE_ADD_OPS:
        c["add"] += max(L._in_elems(e) - n, 0)
    elif name in L.REDUCE_CMP_OPS:
        c["compare"] += max(L._in_elems(e) - n, 0)
    return Counter({k: v * scale for k, v in c.items()})


def ref_census_split(closed) -> tuple:
    """(input-dependent, input-free) census of a reference jaxpr: a
    dependence walk through calls and scans (carries to a fixpoint)."""
    from jax._src.core import Literal
    parts = (Counter(), Counter())

    def run(jaxpr, dep_in, scale, record):
        dep = dict(zip(list(jaxpr.constvars) + list(jaxpr.invars), dep_in))
        def rd(v):
            return (not isinstance(v, Literal)) and dep.get(v, False)

        for e in jaxpr.eqns:
            ins = [rd(v) for v in e.invars]
            name = e.primitive.name
            if name in _REF_CALLS:
                sub = e.params.get("jaxpr") or e.params.get("call_jaxpr")
                j = getattr(sub, "jaxpr", sub)
                outs = run(j, [False] * len(j.constvars) + ins, scale,
                           record)
            elif name == "scan":
                j = e.params["jaxpr"].jaxpr
                nc, nk = e.params["num_consts"], e.params["num_carry"]
                cons = [False] * len(j.constvars)
                carry = ins[nc:nc + nk]
                while True:
                    o = run(j, cons + ins[:nc] + carry + ins[nc + nk:], 1,
                            False)
                    new = [a or b for a, b in zip(carry, o[:nk])]
                    if new == carry:
                        break
                    carry = new
                o = run(j, cons + ins[:nc] + carry + ins[nc + nk:],
                        scale * int(e.params["length"]), record)
                outs = carry + o[nk:]
            else:
                d = any(ins)
                outs = [d] * len(e.outvars)
                if record:
                    parts[0 if d else 1].update(_eqn_census(e, scale))
            for v, d in zip(e.outvars, outs):
                dep[v] = d
        return [rd(v) for v in jaxpr.outvars]

    j = closed.jaxpr
    run(j, [False] * len(j.constvars) + [True] * len(j.invars), 1, True)
    return parts


def ref_census(closed, monkeypatch) -> Counter:
    """``repro.analysis.legality.census_jaxpr`` with the walk recursing
    into this JAX's ``jit`` calls, as it recursed into ``pjit``."""
    monkeypatch.setattr(ref_traverse, "CALL_PRIMS",
                        ref_traverse.CALL_PRIMS + ("jit",))
    return ref_legality.census_jaxpr(closed)


# ---------------------------------------------------------------------------
# fixtures: the golden case in both packages, lowered once per module
# ---------------------------------------------------------------------------


def _reference_pipe(case):
    with jax.threefry_partitionable(False):
        return build_pipeline(case)


def port_pipe(ref_pipe, **overrides):
    return bridge.pipeline_from_numpy(
        ref_pipe.config, [np.asarray(t) for t in ref_pipe.bp_taps],
        [np.asarray(t) for t in ref_pipe.lp_taps], np.asarray(ref_pipe.mu),
        np.asarray(ref_pipe.sigma), [np.asarray(a) for a in ref_pipe.clf],
        device="cpu", **overrides)


def golden_oneshot():
    """The golden one-shot program in both packages, the port's traced
    and lowered (typed from the quantizer's code range)."""
    ref_pipe = _reference_pipe(CASE)
    x = make_audio(CASE)
    prog_ref = fx_ref.compile_pipeline(ref_pipe, calibration_audio=x)
    prog = fx.compile_pipeline(port_pipe(ref_pipe), calibration_audio=x)
    xq = fx.quantize_signal(prog, x)
    tr = traverse.trace(fx.infer_q, xq, program=prog)
    sig = Interval(int(prog.signal.qmin), int(prog.signal.qmax))
    ir = build_program(tr, name="oneshot_q", in_intervals=[sig])
    xq_ref = jnp.asarray(xq.numpy())
    fn_ref = lambda q: fx_ref.infer_q(prog_ref, q)         # noqa: E731
    jaxpr = jax.make_jaxpr(fn_ref)(xq_ref)
    want = [np.asarray(v) for v in jax.jit(fn_ref)(xq_ref)]
    return SimpleNamespace(name="oneshot_q", prog=prog, tr=tr, ir=ir,
                           jaxpr=jaxpr, args=[xq.numpy()], want=want,
                           sig=sig)


def golden_session():
    """One golden-chunking int32 session step in both packages."""
    case = dict(CASE, cfg=dict(CASE["cfg"], numerics="fixed"))
    ref_pipe = _reference_pipe(case)
    x = make_audio(CASE)
    ref_pipe.calibrate_fixed(x)
    prog_ref = ref_pipe.fixed_program()
    pipe = port_pipe(ref_pipe)
    pipe.calibrate_fixed(x)
    prog = pipe.fixed_program()
    state = pipe.init_session(x.shape[0])
    n_oct = len(state.delays)
    xq = fx.quantize_signal(prog, x[:, :CHUNK])
    nv = torch.full((x.shape[0],), CHUNK, dtype=torch.int32)
    flat = (*state.delays, *state.consumed, state.acc, state.amax,
            state.count, state.active, xq, nv)
    fn = session_fn(fx.session_step_q, n_oct)
    tr = traverse.trace(fn, *flat, program=prog)
    acc_iv = session_envelope(prog, x.shape[1])["acc_interval"]
    in_ivs = session_inputs(prog, state, CHUNK, acc_iv)
    ir = build_program(tr, name="session_step_q", in_intervals=in_ivs)

    st_ref = ref_pipe.init_session(x.shape[0])
    leaves, treedef = jax.tree_util.tree_flatten(st_ref)

    def fn_ref(*a):
        st = jax.tree_util.tree_unflatten(treedef, a[:len(leaves)])
        st2, p_q, phi_q = fx_ref.session_step_q(prog_ref, st, a[-2], a[-1])
        return tuple(jax.tree_util.tree_leaves(st2)) + (p_q, phi_q)

    args = [t.numpy() for t in flat]
    ref_args = [jnp.asarray(a) for a in args]
    jaxpr = jax.make_jaxpr(fn_ref)(*ref_args)
    want = [np.asarray(v) for v in jax.jit(fn_ref)(*ref_args)]
    return SimpleNamespace(name="session_step_q", prog=prog, tr=tr, ir=ir,
                           jaxpr=jaxpr, args=args, want=want, fn=fn,
                           in_ivs=in_ivs)


@pytest.fixture(scope="module")
def oneshot():
    return golden_oneshot()


@pytest.fixture(scope="module")
def session():
    return golden_session()


@pytest.fixture(params=["oneshot", "session"])
def program(request, oneshot, session):
    return oneshot if request.param == "oneshot" else session


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


def run_c(prog, inputs, tmpdir):
    """Compile the emitted C with ``gcc -std=c99 -O1``, run it on raw
    little-endian inputs and read its raw outputs."""
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler on PATH")
    src = tmpdir / "program.c"
    src.write_text(emit_c(prog))
    exe = tmpdir / "program"
    subprocess.run([cc, "-std=c99", "-O1", "-o", str(exe), str(src)],
                   check=True)
    blob = b""
    for r, v in zip((prog.regs[i] for i in prog.inputs), inputs):
        v = np.asarray(v)
        blob += (v.astype(np.uint8) if r.dtype == "i1"
                 else v.astype("<i4")).tobytes()
    inp, outp = tmpdir / "in.bin", tmpdir / "out.bin"
    inp.write_bytes(blob)
    subprocess.run([str(exe), str(inp), str(outp)], check=True)
    raw = outp.read_bytes()
    outs, off = [], 0
    for i in prog.outputs:
        r = prog.regs[i]
        if r.dtype == "i1":
            outs.append(np.frombuffer(raw, np.uint8, r.size, off)
                        .astype(bool).reshape(r.shape))
            off += r.size
        else:
            outs.append(np.frombuffer(raw, "<i4", r.size, off)
                        .reshape(r.shape))
            off += 4 * r.size
    assert off == len(raw)
    return outs


# ---------------------------------------------------------------------------
# back-end parity: interpreter / torch re-emitter / compiled C, all exact
# ---------------------------------------------------------------------------


def test_interpreter_matches_reference(program):
    _assert_all_equal(ir_interp.run(program.ir, program.args), program.want)


def test_interpreter_matches_golden_fixture(oneshot):
    golden = np.load(f"{GOLDEN_DIR}/esc_mp_bisect.npz")
    p_q, phi_q, s_q = ir_interp.run(oneshot.ir, oneshot.args)
    np.testing.assert_array_equal(p_q, golden["p_fixed_q"])
    np.testing.assert_array_equal(phi_q, golden["phi_fixed_q"])
    np.testing.assert_array_equal(s_q, golden["acc_fixed_q"])


def test_torch_emitter_matches_reference(program):
    fn = emit_torch.emit(program.ir)
    _assert_all_equal(fn(*[torch.from_numpy(a) for a in program.args]),
                      program.want)


def test_c_reference_matches_reference(program, tmp_path):
    _assert_all_equal(run_c(program.ir, program.args, tmp_path),
                      program.want)


def test_session_outputs_keep_the_reference_leaf_order(session):
    """18 inputs and outputs: the 16 session registers in the reference's
    leaf order, then (chunk, n) in and (p_q, phi_q) out."""
    n = len(session.want)
    assert len(session.ir.inputs) == len(session.ir.outputs) == n
    assert [session.ir.regs[o].shape for o in session.ir.outputs] == \
        [w.shape for w in session.want]
    # the active flags pass through as their own input register
    assert session.ir.outputs[n - 3] == session.ir.inputs[n - 3]
    assert session.ir.regs[session.ir.outputs[n - 3]].dtype == "i1"


# ---------------------------------------------------------------------------
# census: the reference's, with its input-free index arithmetic folded
# ---------------------------------------------------------------------------


def test_census_equals_reference_census(program, monkeypatch):
    """One-shot: the port's census IS the reference's input-dependent
    census. Session step: it differs by the index work
    ``ir_reference.reference_index_overhead`` names, exactly."""
    ours = census_program(program.ir)
    assert dict(ours) == dict(legality.census(program.tr))
    dep, free = ref_census_split(program.jaxpr)
    if program.name == "session_step_q":
        S, L = program.args[-2].shape
        delta = reference_index_overhead(
            program.prog, S, L, program.args[0].shape[1])
        assert delta and all(v != 0 for v in delta.values())
        assert dict(ours + delta) == dict(dep)
    else:
        assert dict(ours) == dict(dep)
    # the two parts are the reference's own census, whole
    assert dict(dep + free) == dict(ref_census(program.jaxpr, monkeypatch))
    assert ours["multiply"] == 0 and ours["transcendental_or_div"] == 0
    assert ours["add"] > 0 and ours["compare"] > 0 and ours["shift"] > 0
    # what the port folds is index arithmetic and loop counters only
    assert free["multiply"] == 0 and free["transcendental_or_div"] == 0


def test_legality_ok_and_counts_what_census_counts(oneshot):
    r = legality.check_legality(oneshot.tr)
    assert r.ok and not r.violations
    assert dict(r.legal_ops) == dict(legality.census(oneshot.tr))


# ---------------------------------------------------------------------------
# register typing from the interval pass
# ---------------------------------------------------------------------------


def test_register_typing_from_intervals(oneshot):
    ir = oneshot.ir
    typed = [r for r in ir.regs if r.interval is not None]
    assert len(typed) > len(ir.regs) // 2
    for r in typed:
        assert r.required_bits is not None and r.required_bits <= 32
        assert r.interval[0] <= r.interval[1]
    x = ir.regs[ir.inputs[0]]
    assert x.interval == (oneshot.sig.lo, oneshot.sig.hi)
    assert x.required_bits == 8
    assert ir.meta["interval_ok"] and ir.meta["max_required_bits"] <= 32
    # every register holds its values: run the program and check
    seen = {}
    ir_interp.run(ir, oneshot.args,
                  trace=lambda ins, vals: seen.update(zip(ins.dests, vals)))
    for r in typed:
        if r.idx in seen and r.dtype == "i32":
            v = np.asarray(seen[r.idx])
            assert r.interval[0] <= v.min() and v.max() <= r.interval[1]
    table = ir.register_table()
    assert [row["reg"] for row in table] == list(range(len(ir.regs)))


def test_tracing_leaves_the_constant_caches_real(oneshot):
    """Tracing runs on fake tensors: neither the program's device-constant
    cache nor ``device_scalar``'s may keep one, or the next real call
    would compute on it."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.core.mp import device_scalar
    device_scalar.cache_clear()
    xq = torch.from_numpy(oneshot.args[0])
    traverse.trace(fx.infer_q, xq, program=oneshot.prog)
    cached = vars(oneshot.prog.bank.octaves[0]).get("_device_consts", {})
    assert not any(isinstance(t, FakeTensor) for t in cached.values())
    _assert_all_equal(fx.infer_q(oneshot.prog, xq), oneshot.want)


def test_nodes_are_named_by_source_location(oneshot):
    names = [oneshot.tr.name(n) for n in oneshot.tr.calls()]
    assert any("fixed.py:" in s and "(fxp_mpabs)" in s for s in names)
    assert all("@" in s for s in names)


# ---------------------------------------------------------------------------
# the multiplierless contract is a build error
# ---------------------------------------------------------------------------


def _trace(fn, *args):
    return traverse.trace(fn, *args)


A = torch.arange(-4, 4, dtype=torch.int32)
A_IV = Interval(-4, 3)


def test_general_multiply_is_a_build_error():
    with pytest.raises(BuildError, match=r"mul@test_torch_ir\.py:\d+"):
        build_program(_trace(lambda u, v: u * v, A, A), name="bad_mul",
                      in_intervals=[A_IV, A_IV])


def test_float_program_is_a_build_error():
    a = torch.arange(8, dtype=torch.float32)
    with pytest.raises(BuildError, match="float"):
        build_program(_trace(lambda u: u + 1.0, a), name="float",
                      in_intervals=[Interval(0, 7)])


def test_divide_is_a_build_error():
    with pytest.raises(BuildError):
        build_program(_trace(lambda u, v: torch.floor_divide(u, v), A, A),
                      name="bad_div", in_intervals=[A_IV, A_IV])


@pytest.mark.parametrize("fn, iv, why", [
    # x & 15 may index past the end of x's 8 elements
    (lambda x: x[x & 15], A_IV, "index may leave"),
    # x << 40 in int64 does not fit the int32 register it would be held in
    (lambda x: (x.long() << 40) > 0, A_IV, "not proven to fit"),
])
def test_unproven_index_and_wide_int64_are_build_errors(fn, iv, why):
    with pytest.raises(BuildError, match=why):
        build_program(_trace(fn, A), name="unproven", in_intervals=[iv])


def test_pow2_literal_multiply_folds_to_shift():
    tr = _trace(lambda u: u * 8, A)
    ir = build_program(tr, name="p2", in_intervals=[A_IV])
    shifts = [i for i in ir.body if i.op == "shl"]
    assert len(shifts) == 1 and shifts[0].attrs["imm"] == 3
    assert census_program(ir)["shift"] == 8
    np.testing.assert_array_equal(ir_interp.run(ir, [A.numpy()])[0],
                                  A.numpy() * 8)


def test_index_math_is_folded_but_input_multiplies_are_judged():
    """``2 * arange`` reaches no input: folded, counted nowhere. A multiply
    of an input by 2 is a shift; by 3 it is a violation (and a build
    error)."""
    def gather_even(x):
        idx = 2 * torch.arange(4)
        return x[idx] + 1

    tr = _trace(gather_even, A)
    assert legality.check_legality(tr).ok
    c = legality.census(tr)
    assert c == Counter({"add": 4})
    ir = build_program(tr, name="even", in_intervals=[A_IV])
    np.testing.assert_array_equal(ir_interp.run(ir, [A.numpy()])[0],
                                  A.numpy()[0::2] + 1)

    assert legality.check_legality(_trace(lambda x: x * 2, A)).ok
    r = legality.check_legality(_trace(lambda x: x * 3, A))
    assert not r.ok and r.violations[0].primitive == "aten.mul.Tensor"
    assert legality.census(_trace(lambda x: x * 3, A))["multiply"] == 8
    # a multiply hidden behind an input-dependent index is still judged
    r = legality.check_legality(_trace(lambda x: x[(x & 3) * 3 % 8], A))
    assert not r.ok


@pytest.mark.parametrize("k", [0, 1, 31, 32, 33])
def test_shift_counts_of_32_and_over(k, tmp_path):
    """int32 shifts by 32 or more give the sign (right) or 0 (left) in
    torch; the interpreter, the torch re-emitter and the C agree."""
    x = torch.tensor([-7, -1, 0, 1, 1 << 30, -(1 << 31)], dtype=torch.int32)
    kk = torch.full_like(x, k)

    def fn(v, s):
        return (torch.bitwise_left_shift(v, s),
                torch.bitwise_right_shift(v, s), v << k, v >> k)

    ir = build_program(_trace(fn, x, kk), name="shifts", in_intervals=[
        Interval(-(1 << 31), (1 << 31) - 1), Interval(k, k)])
    want = fn(x, kk)
    args = [x.numpy(), kk.numpy()]
    _assert_all_equal(ir_interp.run(ir, args), want)
    _assert_all_equal(emit_torch.emit(ir)(x, kk), want)
    _assert_all_equal(run_c(ir, args, tmp_path), want)
