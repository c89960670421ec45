"""Port vs reference: the static-analysis tier (``repro_torch.analysis``)
at the smoke config, on the CPU.

The port's targets (``analysis.targets.build_targets``) are traced from its
own ``make_pipeline(numerics="fixed")`` program; the reference's from its
own. The interval proofs must agree: out intervals equal or tighter, the
same ``max_required_bits``, no overflow, and the same session envelope.
The reference's passes run on its jaxprs traced under ``jax.disable_jit``
(calls inlined, loops unrolled), since its walk does not recurse into this
JAX's ``jit`` calls. The census must decompose exactly: the reference's
input-dependent census is the port's plus the block padding and index work
that ``ir_reference.reference_block_padding`` /
``reference_index_overhead`` name.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

from ir_reference import reference_block_padding, reference_index_overhead
from repro.analysis import intervals as ref_iv
from repro.analysis import targets as ref_targets
from repro.core import fixed as fx_ref
from repro_torch.analysis import (Interval, analyze_intervals, census,
                                  check_legality, lint_determinism, trace)
from repro_torch.analysis import report as rp
from repro_torch.analysis import targets as tg
from repro_torch.core import fixed as fx
from test_torch_ir import golden_oneshot, ref_census, ref_census_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = ("oneshot_q", "oneshot_q_cascade", "session_step_q",
         "stream_cascade_q")


@pytest.fixture(scope="module")
def port():
    targets, meta = tg.build_targets(smoke=True, device="cpu", names=FIXED)
    by = {t.name: t for t in targets}
    report = rp.build_report(targets, meta, top_registers=5)
    return SimpleNamespace(targets=by, meta=meta, report=report)


@pytest.fixture(scope="module")
def reference():
    """The reference's smoke programs, jaxprs and interval results."""
    pipe = ref_targets._fixed_pipeline(True)
    prog = pipe.fixed_program()
    n = 1600
    env = ref_targets.session_envelope(prog, n)
    xq = jnp.zeros((1, n), jnp.int32)
    state = pipe.init_session(1)
    chunk = jnp.zeros((1, ref_targets.CHUNK_LEN), jnp.int32)
    nv = jnp.zeros((1,), jnp.int32)
    one = lambda q: fx_ref.infer_q(prog, q)                      # noqa: E731
    step = lambda st, q, v: fx_ref.session_step_q(prog, st, q, v)  # noqa
    with jax.disable_jit():
        flat1 = jax.make_jaxpr(one)(xq)
        flat2 = jax.make_jaxpr(step)(state, chunk, nv)
    iv1 = ref_iv.analyze_intervals(flat1, [ref_targets._signal_iv(prog)])
    iv2 = ref_iv.analyze_intervals(flat2, ref_targets._session_inputs(
        prog, state, ref_targets.CHUNK_LEN, env["acc_interval"]))
    return SimpleNamespace(
        prog=prog, env=env, n=n, intervals={"oneshot_q": iv1,
                                            "session_step_q": iv2},
        jaxprs={"oneshot_q": jax.make_jaxpr(one)(xq),
                "session_step_q": jax.make_jaxpr(step)(state, chunk, nv)})


# ---------------------------------------------------------------------------
# the interval proof, against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["oneshot_q", "session_step_q"])
def test_smoke_intervals_match_reference(port, reference, name):
    ours = port.report["targets"][name]["intervals"]
    want = reference.intervals[name]
    assert ours["ok"] and want.ok and not ours["violations"]
    assert ours["max_required_bits"] == want.max_required_bits
    got = [Interval(*iv) for iv in ours["out_intervals"]]
    assert len(got) == len(want.out_intervals)
    for g, w in zip(got, want.out_intervals):
        assert w.lo <= g.lo and g.hi <= w.hi, (name, g, w)
    # at the smoke config none is tighter: the reference's unroll limit
    # covers every loop, so neither pass widens
    assert got == list(want.out_intervals)
    assert ours["min_headroom_bits"] >= 0


@pytest.mark.parametrize("smoke", [True, False])
def test_session_envelope_matches_reference(smoke):
    """Field by field, on each package's own program (the bank, which alone
    sets the envelope, is the same design in both)."""
    from repro_torch.configs.esc10_mp import make_pipeline
    n = 1600 if smoke else 16000
    prog = make_pipeline(smoke=smoke, numerics="fixed",
                         device="cpu").fixed_program()
    want = ref_targets.session_envelope(
        ref_targets._fixed_pipeline(smoke).fixed_program(), n)
    got = tg.session_envelope(prog, n)
    assert set(got) == set(want)
    assert tuple(got["acc_interval"]) == tuple(want["acc_interval"])
    for k in ("envelope_samples", "max_safe_session_samples"):
        assert got[k] == want[k], k
    if not smoke:
        with open(os.path.join(ROOT, "ANALYSIS.json")) as f:
            meta = json.load(f)["meta"]
        assert list(got["acc_interval"]) == meta["acc_envelope"]
        assert got["max_safe_session_samples"] == \
            meta["max_safe_session_samples"]


def test_meta_matches_reference_schema(port, reference):
    m = port.meta
    assert m["acc_envelope"] == [int(v) for v in
                                 reference.env["acc_interval"]]
    assert m["max_safe_session_samples"] == \
        reference.env["max_safe_session_samples"]
    assert m["session_bound_counter"] == ref_targets.SESSION_BOUND
    assert m["chunk_len"] == ref_targets.CHUNK_LEN == tg.CHUNK_LEN


# ---------------------------------------------------------------------------
# legality, determinism and the report's gate over every fixed target
# ---------------------------------------------------------------------------


def test_fixed_targets_pass_every_gate(port):
    assert port.report["ok"]
    for name in FIXED:
        s = port.report["targets"][name]
        assert s["gate"] and s["legality"]["ok"], name
        assert s["determinism"]["ok"] and s["intervals"]["ok"], name
        assert s["legality"]["legal_ops"] == dict(
            sorted(census(port.targets[name].traced).items()))
        assert "multiply" not in s["legality"]["legal_ops"]
    summary = rp.summarize(port.report)
    assert "analysis: OK (smoke config)" in summary


def test_cascade_targets_prove_the_same_contract(port):
    """The plain kernel versions prove the same outputs, except the stream
    cascade's accumulator bound: it sums its partials per block of the
    chunk, so its hull is a little wider (as the reference's Pallas
    stream target's is)."""
    r = port.report["targets"]
    one, casc = (r[n]["intervals"] for n in ("oneshot_q",
                                             "oneshot_q_cascade"))
    assert casc["out_intervals"] == one["out_intervals"]
    step, stream = (r[n]["intervals"] for n in ("session_step_q",
                                                "stream_cascade_q"))
    acc = len(step["out_intervals"]) - 6     # delays, consumed, then acc
    for i, (a, b) in enumerate(zip(step["out_intervals"],
                                   stream["out_intervals"])):
        if i == acc:
            assert b[0] == a[0] and b[1] >= a[1]
        else:
            assert a == b, i
    for a, b in ((one, casc), (step, stream)):
        assert a["max_required_bits"] == b["max_required_bits"]


# ---------------------------------------------------------------------------
# the census, against the reference's, decomposed exactly
# ---------------------------------------------------------------------------


def test_smoke_census_decomposes_into_the_reference(port, reference,
                                                    monkeypatch):
    ours = census(port.targets["oneshot_q"].traced)
    dep, free = ref_census_split(reference.jaxprs["oneshot_q"])
    pad = reference_block_padding(port.targets["oneshot_q"].program,
                                     reference.n)
    assert pad["add"] > 0
    assert dict(ours + pad) == dict(dep)
    assert dict(dep + free) == dict(ref_census(reference.jaxprs["oneshot_q"],
                                               monkeypatch))
    t = port.targets["session_step_q"]
    ours = census(t.traced)
    dep, _ = ref_census_split(reference.jaxprs["session_step_q"])
    S, L = t.example[-2].shape
    delta = reference_index_overhead(t.program, S, L,
                                        t.example[0].shape[1])
    assert dict(ours + delta) == dict(dep)


# ---------------------------------------------------------------------------
# the interval pass on small programs: tight, and it rejects overflow
# ---------------------------------------------------------------------------


X = torch.zeros(4, dtype=torch.int32)


def test_interval_arithmetic_is_tight():
    def f(x):
        return (x << 2) + x - x.amax()
    r = analyze_intervals(trace(f, X), [Interval(-128, 127)])
    assert r.ok
    assert r.out_intervals[0] == Interval(-767, 763)
    assert r.min_headroom_bits == 21


def test_interval_pass_rejects_seeded_overflow_by_name():
    def f(q):
        return (q << 24) + (q << 24)
    r = analyze_intervals(trace(f, X), [Interval(-128, 127)])
    assert not r.ok
    v = r.violations[0]
    assert v.primitive == "add" and v.required_bits == 33
    assert v.name.startswith("add@test_torch_analysis.py:")


def test_injected_accumulator_overflow_is_reported():
    """Shift the golden program's accumulators left by 30: the pass must
    report the shift, named by the port's source line."""
    g = golden_oneshot()

    def bad(prog, q):
        return fx.shift_left(fx.infer_q(prog, q)[2], 30)

    tr = trace(bad, torch.from_numpy(g.args[0]), program=g.prog)
    r = analyze_intervals(tr, [g.sig])
    assert not r.ok
    v = r.violations[-1]
    assert v.primitive == "bitwise_left_shift"
    assert "fixed.py:" in v.source and "(shift_left)" in v.source
    assert v.required_bits > 32
    assert analyze_intervals(g.tr, [g.sig]).ok


# ---------------------------------------------------------------------------
# determinism lint and legality on small programs
# ---------------------------------------------------------------------------


def test_float_op_in_fixed_program_gates():
    xf = torch.zeros(8)
    r = lint_determinism(trace(lambda x: torch.exp(x) + 1.0, xf),
                         numerics="fixed")
    assert not r.ok and r.findings[0].kind == "float_in_fixed"
    r = lint_determinism(trace(lambda x: x.sum(), xf), numerics="float")
    assert r.ok and r.findings[0].kind == "free_tree_reduction"
    assert lint_determinism(trace(lambda x: x.sum(), X),
                            numerics="fixed").ok


def test_legality_names_the_offending_mul():
    r = check_legality(trace(lambda x: x * x, X))
    assert not r.ok
    assert r.violations[0].primitive == "aten.mul.Tensor"
    assert "test_torch_analysis.py:" in r.violations[0].source


def test_analysis_cli_writes_the_report_it_gates_on(port, monkeypatch,
                                                     tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(tg, "build_targets", lambda **kw: (
        list(port.targets.values()), port.meta))
    out = tmp_path / "report.json"
    assert main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and sorted(rep["targets"]) == sorted(FIXED)
    assert rep["meta"] == json.loads(json.dumps(port.meta))
    assert "analysis: OK (smoke config)" in capsys.readouterr().out
