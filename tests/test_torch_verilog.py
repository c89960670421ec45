"""Port vs reference: the Verilog back end of the port's IR
(``repro_torch.ir.verilog``), the in-repo cycle simulator and the
cross-back-end differential harness, on the CPU.

The port's netlist of the golden ``esc_mp_bisect`` programs (narrow
interval-proven registers, one time-multiplexed FSM, shift/add/compare
datapath) must replay the JAX package's integer codes exactly, against the
IR interpreter, the torch re-emitter, the compiled C and the committed
golden entries. The simulator is held to account too: its vectorized path
must equal its statement-by-statement path.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import given, settings, st
from golden_cases import GOLDEN_DIR
from repro_torch.analysis import traverse
from repro_torch.analysis.intervals import Interval
from repro_torch.ir import build_program, emit_torch
from repro_torch.ir import interp as ir_interp
from repro_torch.ir import vsim
from repro_torch.ir.alloc import allocate
from repro_torch.ir.cgen import emit_rom_mem
from repro_torch.ir.debug import Divergence, first_divergence
from repro_torch.ir.verilog import emit_testbench, emit_verilog
from test_torch_ir import golden_oneshot, golden_session, run_c


def _netlist(prog):
    """Emit, parse, and bundle a program's netlist with its ROM images."""
    alloc = allocate(prog)
    text = emit_verilog(prog, alloc)
    return SimpleNamespace(
        alloc=alloc, text=text, net=vsim.parse_netlist(text),
        loader=vsim.rom_loader_from_mems(emit_rom_mem(prog)))


@pytest.fixture(scope="module")
def oneshot():
    g = golden_oneshot()
    return SimpleNamespace(**vars(g), **vars(_netlist(g.ir)))


@pytest.fixture(scope="module")
def session():
    """The golden session step, typed from the session contract."""
    g = golden_session()
    return SimpleNamespace(**vars(g), **vars(_netlist(g.ir)))


def _small_fn(x):
    """Covers the emitter's tricky paths: pad, slices, an unrolled carry
    chain, unfold and a data-dependent index gather, reductions, shifts."""
    a = torch.abs(x)
    b = torch.where(x > 0, a, -(a >> 1))
    c = F.pad(b, (2, 1))
    d = c[:, 2:10]
    carry = torch.zeros(3, dtype=torch.int32)
    ys = []
    for t in range(d.shape[1]):
        carry = torch.clamp_min(carry + d[:, t], 0)
        ys.append(carry - d[:, t])
    ys = torch.stack(ys)
    w = d.unfold(-1, 3, 1).amax(-1)
    rows = torch.arange(3)[:, None]
    g = b[rows, torch.clamp(x, 0, 7).long()]
    s = ys.sum(0).to(torch.int32) + d.amax(1) + (w.sum(1).to(torch.int32)
                                                 << 2)
    return s, carry, g


@pytest.fixture(scope="module")
def small():
    x0 = torch.arange(-12, 12, dtype=torch.int32).reshape(3, 8)
    tr = traverse.trace(_small_fn, x0)
    ir = build_program(tr, name="small", in_intervals=[Interval(-100, 100)])
    return SimpleNamespace(ir=ir, x0=x0.numpy(), want=_small_fn(x0),
                           **vars(_netlist(ir)))


def _assert_all_equal(got, expected):
    assert len(got) == len(expected)
    for g, e in zip(got, expected):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        e = e.numpy() if isinstance(e, torch.Tensor) else np.asarray(e)
        np.testing.assert_array_equal(g, e)


# ---------------------------------------------------------------------------
# netlist parity: golden programs, bit for bit
# ---------------------------------------------------------------------------


def test_netlist_matches_infer_q_and_golden_fixture(oneshot):
    """vsim(program.v) == the reference's fixed.infer_q == golden codes."""
    outs = vsim.run_netlist(oneshot.net, oneshot.args, oneshot.loader)
    _assert_all_equal(outs, oneshot.want)
    golden = np.load(f"{GOLDEN_DIR}/esc_mp_bisect.npz")
    np.testing.assert_array_equal(outs[0], golden["p_fixed_q"])
    np.testing.assert_array_equal(outs[1], golden["phi_fixed_q"])
    np.testing.assert_array_equal(outs[2], golden["acc_fixed_q"])


def test_netlist_matches_session_step(session):
    outs = vsim.run_netlist(session.net, session.args, session.loader)
    _assert_all_equal(outs, session.want)


def test_netlist_matches_c_reference(oneshot, tmp_path):
    outs = vsim.run_netlist(oneshot.net, oneshot.args, oneshot.loader)
    _assert_all_equal(run_c(oneshot.ir, oneshot.args, tmp_path), outs)


@settings(max_examples=6)
@given(st.integers(0, 2**31 - 1))
def test_random_inputs_all_backends_agree(oneshot, seed):
    """Random ADC codes across the quantizer's range: interpreter, torch
    re-emitter, the simulated netlist and the port's own infer_q land on
    the same integer codes."""
    from repro_torch.core import fixed as fx
    rng = np.random.default_rng(seed)
    xq = rng.integers(oneshot.sig.lo, oneshot.sig.hi + 1,
                      size=oneshot.args[0].shape).astype(np.int32)
    want = ir_interp.run(oneshot.ir, [xq])
    _assert_all_equal(emit_torch.emit(oneshot.ir)(torch.from_numpy(xq)),
                      want)
    _assert_all_equal(vsim.run_netlist(oneshot.net, [xq], oneshot.loader),
                      want)
    _assert_all_equal(fx.infer_q(oneshot.prog, torch.from_numpy(xq)), want)


# ---------------------------------------------------------------------------
# the simulator held to account: fast == slow, iverilog when present
# ---------------------------------------------------------------------------


def test_vectorized_equals_slow_path(small):
    fast = vsim.run_netlist(small.net, [small.x0], small.loader)
    slow = vsim.run_netlist(small.net, [small.x0], small.loader,
                            vectorize=False)
    _assert_all_equal(slow, fast)
    _assert_all_equal(fast, ir_interp.run(small.ir, [small.x0]))
    _assert_all_equal(fast, small.want)


@pytest.mark.skipif(not vsim.have_iverilog(),
                    reason="iverilog not installed")
def test_iverilog_matches_interpreter(small):
    outs = vsim.run_iverilog(small.text,
                             emit_testbench(small.ir, small.alloc),
                             [small.x0], rom_mems=emit_rom_mem(small.ir))
    _assert_all_equal(outs, ir_interp.run(small.ir, [small.x0]))


def test_emission_deterministic(small, oneshot):
    assert emit_verilog(small.ir, small.alloc) == small.text
    rebuilt = build_program(oneshot.tr, name="oneshot_q",
                            in_intervals=[oneshot.sig])
    assert emit_verilog(rebuilt, allocate(rebuilt)) == oneshot.text


# ---------------------------------------------------------------------------
# first-divergence localization
# ---------------------------------------------------------------------------


def test_first_divergence_clean_is_none(small, oneshot):
    assert first_divergence(small.ir, small.net, [small.x0],
                            small.loader) is None
    assert first_divergence(oneshot.ir, oneshot.net, oneshot.args,
                            oneshot.loader) is None


def test_first_divergence_locates_corruption(small):
    """Flip one add to a sub in the netlist text: the locator must name a
    concrete state, instruction and register."""
    assert "t2 = t0 + t1;" in small.text
    bad = small.text.replace("t2 = t0 + t1;", "t2 = t0 - t1;", 1)
    d = first_divergence(small.ir, bad, [small.x0], small.loader)
    assert isinstance(d, Divergence)
    assert d.reg.startswith("r") and d.flat_index >= 0
    assert d.got != d.want
    assert f"state {d.state}" in str(d)


# ---------------------------------------------------------------------------
# allocator: widths are the interval-proven minima
# ---------------------------------------------------------------------------


def test_allocator_widths_and_report(oneshot):
    alloc = oneshot.alloc
    rom_regs = set(oneshot.ir.rom_of_reg)
    n = bits = 0
    for r in oneshot.ir.regs:
        if r.idx in rom_regs:
            assert alloc.width(r.idx) == 32   # $readmemh image carrier
            continue
        assert alloc.width(r.idx) == r.storage_bits, r.idx
        assert 1 <= alloc.width(r.idx) <= 32
        if r.interval is not None and r.dtype == "i32":
            lo, hi = r.interval
            assert -(1 << (r.storage_bits - 1)) <= lo
            assert hi <= (1 << (r.storage_bits - 1)) - 1
            if r.storage_bits > 1:    # the minimum: one bit less fails
                w = r.storage_bits - 1
                assert lo < -(1 << (w - 1)) or hi > (1 << (w - 1)) - 1
        n += 1
        bits += alloc.width(r.idx) * r.size
    rep = alloc.report["registers"]
    assert rep["count"] == n
    assert rep["bits_allocated"] == bits
    assert sum(rep["width_histogram"].values()) == n
    assert 0.0 <= rep["carrier_saving"] < 1.0
    assert rep["carrier_saving"] > 0.2
    assert alloc.report["datapath"]["adder_sites"] > 0


def test_emit_cli_writes_the_artifacts(oneshot, monkeypatch, tmp_path):
    """``python -m repro_torch.ir.emit`` writes the C, the netlist (held
    to the interpreter as it is written), the ROM images and the JSON."""
    import json

    from repro_torch.analysis import targets as tg
    from repro_torch.ir import census_program
    from repro_torch.ir.emit import main
    t = tg.Target(name="oneshot_q", traced=oneshot.tr, numerics="fixed",
                  n_samples=600, in_intervals=[oneshot.sig], assumptions={},
                  gate=True)
    monkeypatch.setattr(tg, "build_targets", lambda **kw: ([t], {}))
    assert main(["--out-dir", str(tmp_path), "--device", "cpu"]) == 0
    d = tmp_path / "oneshot_q"
    assert (d / "program.v").read_text() == oneshot.text
    assert len(list((d / "rom").glob("*.mem"))) == len(oneshot.ir.roms)
    doc = json.loads((d / "ir.json").read_text())
    assert doc["census"] == dict(sorted(census_program(oneshot.ir).items()))
    assert doc["num_instrs"] == oneshot.ir.num_instrs()
    assert json.loads((d / "alloc.json").read_text()) == oneshot.alloc.report
