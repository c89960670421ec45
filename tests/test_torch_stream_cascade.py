"""The session step's octave cascade, port vs reference, on the CPU.

On the card the cascade is one launch of the stream kernel
(``kernels.fir_mp.fir_mp_stream_cascade`` / ``..._cascade_q``); on CPU
tensors the same entry points run the plain per-octave loop
(``kernels.ref.fir_mp_stream`` / ``fir_mp_stream_q``), which is what the
kernel is held to on the card. Here that plain cascade is held bit for bit
against the reference's Pallas cascade (``repro.kernels.ops.fir_mp_stream``
and ``fir_mp_stream_q``, interpret mode), and the host side of the kernel
route (launch plan, packed tables, device routing) is checked.

Inputs are seeded numpy arrays given to both packages; the smoke bank
(``FILTERBANK_SMOKE``: 3 octaves of 3 filters, 16 / 6 taps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.configs.esc10_mp import make_pipeline as make_ref_pipeline
from repro.core import fixed as fx_ref
from repro.kernels import ops as ref_ops
from repro_torch import bridge
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.fir_mp import (STAGE_FIELDS, STAGE_HEAD,
                                        STAGE_MAX_BP, STAGE_WORDS,
                                        STREAM_OCTAVE_FIELDS,
                                        STREAM_Q_OCTAVE_FIELDS,
                                        STREAM_MAX_THREADS,
                                        fir_mp_stream_cascade,
                                        _cascade_inputs, _cascade_outputs,
                                        _cascade_q_inputs, _program_table,
                                        fir_mp_stream_cascade_q, pack_stages,
                                        stream_octave_rows,
                                        stream_q_octave_rows, stream_plan)

T1 = 15   # max(16, 6) - 1


@pytest.fixture(autouse=True)
def _pallas_names(monkeypatch):
    # the reference names TPUCompilerParams, which newer JAX calls
    # CompilerParams; interpret mode ignores it either way
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


@pytest.fixture(scope="module")
def ref_pipe():
    return make_ref_pipeline(smoke=True)


@pytest.fixture(scope="module")
def progs():
    """The reference's smoke program, calibrated on seeded audio, and the
    port's copy of it through the bridge."""
    pipe = make_ref_pipeline(smoke=True, numerics="fixed")
    x = np.random.default_rng(0).standard_normal((4, 2000)).astype(
        np.float32) * 0.3
    prog_r = fx_ref.compile_pipeline(pipe, calibration_audio=x)
    return prog_r, bridge.program_from_numpy(bridge.program_to_numpy(prog_r))


def _registers(seed, S, L, octaves, P, *, codes=None):
    """numpy (chunk, n, delays, consumed, acc, amax): valid counts 0, full,
    odd and random; consumed counters of both parities (odd phases); the
    chunk zeroed past n. Float registers, or int32 codes in ``codes``."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, L + 1, S).astype(np.int32)
    n[0], n[1], n[2] = 0, L, L - 1 if L % 2 == 0 else L
    consumed = tuple(rng.integers(0, 1000, S).astype(np.int32)
                     for _ in range(octaves))
    if codes is None:
        chunk = rng.standard_normal((S, L)).astype(np.float32)
        delays = tuple(rng.standard_normal((S, T1)).astype(np.float32)
                       for _ in range(octaves))
        acc = rng.random((S, P)).astype(np.float32)
        amax = rng.random(S).astype(np.float32)
    else:
        lo, hi = codes
        chunk = rng.integers(lo, hi + 1, (S, L)).astype(np.int32)
        delays = tuple(rng.integers(lo, hi + 1, (S, T1)).astype(np.int32)
                       for _ in range(octaves))
        acc = rng.integers(0, 1 << 20, (S, P)).astype(np.int32)
        amax = rng.integers(0, 100, S).astype(np.int32)
    chunk[np.arange(L)[None] >= n[:, None]] = 0
    return chunk, n, delays, consumed, acc, amax


def _both(regs):
    """The registers as (port tensors, reference arrays)."""
    chunk, n, delays, consumed, acc, amax = regs
    t = torch.from_numpy
    port = (t(chunk), t(n), tuple(map(t, delays)), tuple(map(t, consumed)),
            t(acc), t(amax))
    jx = (jnp.asarray(chunk), jnp.asarray(n), tuple(map(jnp.asarray, delays)),
          tuple(map(jnp.asarray, consumed)), jnp.asarray(acc),
          jnp.asarray(amax))
    return port, jx


def _equal(got, want):
    """(delays, consumed, acc, amax) of both packages, bit for bit."""
    for g, w in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# (a), (b): the plain cascades against the reference's, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,L,solver,update_amax", [
    (5, 40, "newton", True),
    (5, 40, "newton", False),      # the quant_bits route: amax as given
    (5, 40, "bisect", True),
    (3, 520, "newton", True),      # two blocks at octave 0
])
def test_plain_cascade_matches_reference(ref_pipe, S, L, solver,
                                         update_amax):
    c = ref_pipe.config
    O, F = c.num_octaves, c.filters_per_octave
    port, jx = _both(_registers(S * L, S, L, O, O * F))
    bp = [np.array(h) for h in ref_pipe.bp_taps]
    lp = [np.array(h) for h in ref_pipe.lp_taps]
    kw = dict(solver=solver, update_amax=update_amax)
    want = ref_ops.fir_mp_stream(*jx, tuple(map(jnp.asarray, bp)),
                                 tuple(map(jnp.asarray, lp)), c.gamma_f, **kw)
    reset_launches()
    got = ops.fir_mp_stream(*port, tuple(map(torch.from_numpy, bp)),
                            tuple(map(torch.from_numpy, lp)), c.gamma_f, **kw)
    _equal(got, want)
    if not update_amax:
        assert got[3] is port[5]
    # the n == 0 slot keeps its registers bit for bit
    assert torch.equal(got[2][0], port[4][0])
    assert all(torch.equal(d[0], d0[0]) for d, d0 in zip(got[0], port[2]))
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


@pytest.mark.parametrize("S,L", [(5, 40), (3, 520)])
def test_plain_cascade_q_matches_reference(progs, S, L):
    prog_r, prog = progs
    st = prog.bank.octaves
    P = sum(s.bp_q.shape[0] for s in st)
    spec = st[0].in_spec
    port, jx = _both(_registers(S + L, S, L, len(st), P,
                                codes=(spec.qmin, spec.qmax)))
    want = ref_ops.fir_mp_stream_q(prog_r, *jx)
    reset_launches()
    got = ops.fir_mp_stream_q(prog, *port)
    _equal(got, want)
    assert torch.equal(got[2][0], port[4][0])
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


# ---------------------------------------------------------------------------
# (c): the launch plan and the packed tables
# ---------------------------------------------------------------------------


def test_stream_plan_sizes_the_served_wave():
    plan = stream_plan(256, 5, 16, 6, T1, octaves=6)
    assert plan["block_len"] == (256, 128, 64, 32, 16, 8)
    assert plan["blocks"] == (1,) * 6
    # both branches of every (position, filter) pair and kept position
    assert plan["items_per_block"][0] == 2 * (256 * 5 + 128)
    assert plan["items_per_block"][-1] == 2 * 8 * 5     # the last keeps none
    assert plan["threads"] == STREAM_MAX_THREADS
    assert plan["scratch"] == 128
    head = T1 + 256 + 32 + 5 * 16 + 8 + 5 * 256 + 5
    # the float kernel: group sums and per-warp maxima; the int kernel:
    # its running amax
    assert plan["smem_bytes"] == 4 * (head + 5 * 16 + STREAM_MAX_THREADS // 32)
    assert stream_plan(256, 5, 16, 6, T1, octaves=6,
                       integer=True)["smem_bytes"] == 4 * (head + 1)
    # cached per shape, read-only
    assert stream_plan(256, 5, 16, 6, T1, octaves=6) is plan
    with pytest.raises(TypeError):
        plan["threads"] = 32
    # two blocks at octave 0, one octave (the one-octave entry), few items
    plan = stream_plan(700, 5, 16, 6, T1, octaves=2)
    assert plan["block_len"] == (512, 512) and plan["blocks"] == (2, 1)
    one = stream_plan(5, 3, 16, 6, T1)
    assert one["scratch"] == 0 and one["threads"] == 32 * 2   # 2 x 29 items


@pytest.mark.parametrize("L,threads", [(1, 32), (4, 64), (8, 96), (16, 192),
                                       (600, STREAM_MAX_THREADS)])
def test_stream_plan_threads_follow_the_largest_block(L, threads):
    """Threads per CTA: the first octave's items (2 x (positions x 5
    filters + kept)) rounded up to a warp, at most the kernels' bound;
    the card tests run the cascades at each of these shapes."""
    assert stream_plan(L, 5, 16, 6, T1, octaves=6)["threads"] == threads


@pytest.mark.parametrize("kw,match", [
    (dict(F=33), "F = 33"), (dict(M=17), "M = 17"),
    (dict(M_lp=9), "M_lp = 9"), (dict(T1=32), "T1 = 32"),
    (dict(octaves=9), "octaves = 9"), (dict(T1=4), "delay line"),
    (dict(F=0), "F = 0"), (dict(L=0), "L = 0"),
])
def test_stream_plan_refuses_shapes_outside_the_kernels(kw, match):
    args = dict(L=256, F=5, M=16, M_lp=6, T1=T1)
    extra = {k: kw.pop(k) for k in ("octaves",) if k in kw}
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        stream_plan(args["L"], args["F"], args["M"], args["M_lp"],
                    args["T1"], **extra)


def test_float_table_rows_and_scales(ref_pipe):
    O, S = 3, 4
    F = ref_pipe.config.filters_per_octave
    bp = [torch.from_numpy(np.array(h)) for h in ref_pipe.bp_taps]
    lp = [torch.from_numpy(np.array(h)) for h in ref_pipe.lp_taps][:O - 1]
    lp = lp + [None]
    d_in = [torch.zeros(S, T1) for _ in range(O)]
    d_out = torch.empty(O, S, T1)
    c_in = [torch.zeros(S, dtype=torch.int32) for _ in range(O)]
    c_out = torch.empty(O, S, dtype=torch.int32)
    rows, scales = stream_octave_rows(d_in, d_out, c_in, c_out, bp, lp)
    assert rows.shape == (O, len(STREAM_OCTAVE_FIELDS))
    field = {k: i for i, k in enumerate(STREAM_OCTAVE_FIELDS)}
    for o in range(O):
        r = rows[o]
        assert r[field["delay_in"]] == d_in[o].data_ptr()
        assert r[field["delay_out"]] == d_out[o].data_ptr()
        assert r[field["phase_in"]] == c_in[o].data_ptr()
        assert r[field["consumed_out"]] == c_out[o].data_ptr()
        assert r[field["bp"]] == bp[o].data_ptr()
        assert r[field["lp"]] == (lp[o].data_ptr() if o < O - 1 else 0)
        assert (r[field["F"]], r[field["col"]], r[field["emit"]]) == \
            (F, o * F, int(o < O - 1))
    np.testing.assert_array_equal(scales, np.float32([1.0, 2.0, 4.0]))
    # the one-octave entry: no consumed counter out, the scale it was given
    rows, scales = stream_octave_rows(d_in[:1], d_out[:1], c_in[:1], [None],
                                      bp[:1], [None], [0.5])
    assert rows[0, field["consumed_out"]] == 0 and rows[0, field["emit"]] == 0
    assert scales.tolist() == [0.5]
    q = stream_q_octave_rows(d_in, d_out, c_in, [None] * O, [0, 3, 6])
    assert q.shape == (O, len(STREAM_Q_OCTAVE_FIELDS))
    assert q[:, -1].tolist() == [0, 3, 6] and (q[:, 3] == 0).all()


def test_stage_table_fields_and_reversed_taps(progs):
    _, prog = progs
    st = prog.bank.octaves
    nxt = [st[o + 1].in_spec for o in range(len(st) - 1)] + [None]
    table = pack_stages(st, nxt, T1)
    assert table.shape == (len(st), STAGE_WORDS) and table.dtype == np.int32
    f = {k: i for i, k in enumerate(STAGE_FIELDS)}
    for o, s in enumerate(st):
        row = table[o]
        F, M = s.bp_q.shape
        emit = s.lp_q is not None
        assert emit == (o < len(st) - 1) == bool(row[f["emit"]])
        lp_spec = s.lp_spec if emit else s.band_spec
        next_spec = nxt[o] if emit else s.band_spec
        want = dict(F=F, M=M, M_lp=s.lp_q.shape[1] if emit else 0, T1=T1,
                    sig_shift=s.sig_shift, lp_sig_shift=s.lp_sig_shift,
                    lp_out_shift=s.lp_out_shift, acc_shift=s.acc_shift,
                    gamma_bp=s.gamma_bp, iters_bp=s.iters_bp,
                    gamma_lp=s.gamma_lp, iters_lp=s.iters_lp,
                    band_qmin=s.band_spec.qmin, band_qmax=s.band_spec.qmax,
                    lp_qmin=lp_spec.qmin, lp_qmax=lp_spec.qmax,
                    next_qmin=next_spec.qmin, next_qmax=next_spec.qmax,
                    emit=int(emit))
        assert {k: int(row[f[k]]) for k in STAGE_FIELDS} == want
        assert not row[len(STAGE_FIELDS):STAGE_HEAD].any()
        # each band-pass row reversed (conv order w = h[::-1]), then zeros
        bp = row[STAGE_HEAD:STAGE_HEAD + F * M].reshape(F, M)
        np.testing.assert_array_equal(bp, np.asarray(s.bp_q)[:, ::-1])
        assert not row[STAGE_HEAD + F * M:STAGE_HEAD + STAGE_MAX_BP].any()
        lp = row[STAGE_HEAD + STAGE_MAX_BP:]
        if emit:
            M_lp = s.lp_q.shape[1]
            np.testing.assert_array_equal(lp[:M_lp],
                                          np.asarray(s.lp_q)[0, ::-1])
            assert not lp[M_lp:].any()
        else:
            assert not lp.any()
    with pytest.raises(ValueError, match="no low-pass taps"):
        pack_stages(st[-1:], [st[0].in_spec], T1)


def test_program_record_is_packed_once_per_program(progs):
    """What the int cascades read of a program, made on the first call and
    cached on its bank: the stage table, filters per octave, tap lengths
    and each octave's first accumulator column."""
    _, prog = progs
    st = prog.bank.octaves
    rec = _program_table(prog.bank, T1, "cpu")
    table, Fs, M, M_lp, cols = rec
    nxt = [st[o + 1].in_spec for o in range(len(st) - 1)] + [None]
    np.testing.assert_array_equal(table.numpy(), pack_stages(st, nxt, T1))
    assert Fs == tuple(s.bp_q.shape[0] for s in st)
    assert (M, M_lp) == (st[0].bp_q.shape[1], st[0].lp_q.shape[1])
    assert cols == tuple(int(c) for c in np.cumsum((0,) + Fs[:-1]))
    assert _program_table(prog.bank, T1, "cpu") is rec
    assert _program_table(prog.bank, T1 + 1, "cpu") is not rec


@pytest.mark.parametrize("integer", [False, True])
def test_cascade_inputs_and_outputs(ref_pipe, progs, integer):
    """The cascades' host parts: the inputs as the kernels read them and
    the plan they launch with, the fresh outputs, and shapes or dtypes the
    kernels do not take refused before any pointer reaches them."""
    c = ref_pipe.config
    S, L = 4, 24
    if integer:
        _, prog = progs
        st = prog.bank.octaves
        O = len(st)
        _, Fs, M, M_lp, _ = _program_table(prog.bank, T1, "cpu")
        port, _ = _both(_registers(5, S, L, O, sum(Fs), codes=(-100, 100)))
        plan, ins = _cascade_q_inputs(*port, Fs, M, M_lp)
        assert plan is stream_plan(L, max(Fs), M, M_lp, T1, octaves=O,
                                   integer=True)
        # every code on the float carrier is taken; a mix, or another
        # dtype, raises
        chunk, n, delays, consumed, acc, amax = port
        flt = (chunk.float(), n, tuple(d.float() for d in delays), consumed,
               acc.float(), amax.float())
        _, ins_f = _cascade_q_inputs(*flt, Fs, M, M_lp)
        assert [t.dtype for t in (ins_f[0], *ins_f[2], ins_f[4], ins_f[5])] \
            == [torch.float32] * (O + 3)
        bad = (port[0].float(),) + port[1:]
        with pytest.raises(ValueError, match="mixed carriers"):
            _cascade_q_inputs(*bad, Fs, M, M_lp)
        wide = (port[0].double(),) + port[1:]
        with pytest.raises(ValueError, match="carried in int32 or in "
                                             "float32"):
            _cascade_q_inputs(*wide, Fs, M, M_lp)
        short = port[:4] + (port[4][:, 1:],) + port[5:]
        with pytest.raises(ValueError, match="acc must have shape"):
            _cascade_q_inputs(*short, Fs, M, M_lp)
    else:
        O, F = c.num_octaves, c.filters_per_octave
        port, _ = _both(_registers(5, S, L, O, O * F))
        bp = [torch.from_numpy(np.array(h)) for h in ref_pipe.bp_taps]
        lp = [torch.from_numpy(np.array(h)) for h in ref_pipe.lp_taps]
        plan, ins = _cascade_inputs(*port, bp, lp[:O - 1])
        assert plan is stream_plan(L, F, c.bp_taps, c.lp_taps, T1, octaves=O)
        assert len(ins[6]) == O and len(ins[7]) == O - 1
        bad = (port[0].double(),) + port[1:]
        with pytest.raises(TypeError, match="chunk must be float32"):
            _cascade_inputs(*bad, bp, lp[:O - 1])
        with pytest.raises(ValueError, match="lp_taps\\[1\\] must have"):
            _cascade_inputs(*port, bp, [lp[0], lp[1][1:]])
    # contiguous, in the kernels' dtypes; the registers as given
    for t in ins[:2] + ins[4:6] + tuple(ins[2]) + tuple(ins[3]):
        assert t.is_contiguous()
    assert ins[1].dtype == torch.int32 and ins[0] is port[0]
    acc, amax = ins[4], ins[5]
    d_out, c_out, acc_out, amax_out, scratch = _cascade_outputs(
        plan, acc, amax, O, T1=T1)
    assert d_out.shape == (O, S, T1) and d_out.dtype == acc.dtype
    assert c_out.shape == (O, S) and c_out.dtype == torch.int32
    assert acc_out.shape == acc.shape and amax_out.shape == amax.shape
    assert scratch.shape == (S, (L + 1) // 2) == (S, plan["scratch"])
    none = _cascade_outputs(plan, acc, amax, 1, T1=T1, update_amax=False)
    assert none[3] is None and none[4] is None


# ---------------------------------------------------------------------------
# (d): device routing
# ---------------------------------------------------------------------------


def test_cpu_tensors_route_to_the_plain_cascades(ref_pipe, progs):
    c = ref_pipe.config
    O, F = c.num_octaves, c.filters_per_octave
    port, _ = _both(_registers(1, 4, 24, O, O * F))
    bp = tuple(torch.from_numpy(np.array(h)) for h in ref_pipe.bp_taps)
    lp = tuple(torch.from_numpy(np.array(h)) for h in ref_pipe.lp_taps)
    reset_launches()
    got = fir_mp_stream_cascade(*port, bp, lp, c.gamma_f)
    want = ref.fir_mp_stream(*port, bp, lp, c.gamma_f)
    _equal(got, tuple(t if isinstance(t, tuple) else t.numpy()
                      for t in want[:2]) + tuple(t.numpy() for t in want[2:]))
    _, prog = progs
    st = prog.bank.octaves
    portq, _ = _both(_registers(2, 4, 24, len(st),
                                sum(s.bp_q.shape[0] for s in st),
                                codes=(-100, 100)))
    got = fir_mp_stream_cascade_q(prog, *portq)
    want = ref.fir_mp_stream_q(prog, *portq)
    for g, w in zip(got[0] + got[1] + got[2:], want[0] + want[1] + want[2:]):
        assert torch.equal(g, w)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}


def test_mixed_devices_and_bad_arguments_raise(ref_pipe, progs):
    c = ref_pipe.config
    O, F = c.num_octaves, c.filters_per_octave
    port, _ = _both(_registers(3, 4, 24, O, O * F))
    bp = tuple(torch.from_numpy(np.array(h)) for h in ref_pipe.bp_taps)
    lp = tuple(torch.from_numpy(np.array(h)) for h in ref_pipe.lp_taps)
    meta = (port[0].to("meta"),) + port[1:]
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_stream_cascade(*meta, bp, lp, c.gamma_f)
    _, prog = progs
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_stream_cascade_q(prog, *meta)
    with pytest.raises(ValueError, match="unknown MP solver"):
        fir_mp_stream_cascade(*port, bp, lp, c.gamma_f, solver="sgd")
    with pytest.raises(ValueError, match="consumed counters"):
        fir_mp_stream_cascade(port[0], port[1], port[2], port[3][:1],
                              *port[4:], bp, lp, c.gamma_f)
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
