"""The float one-shot bank's multirate cascade, port vs reference, on the
CPU.

On the card ``core.filterbank.multirate_accumulate`` (MP, ``use_pallas``)
runs the whole cascade in one launch of the one-shot bank kernel
(``kernels.fir_mp.fir_mp_oneshot_cascade``); on CPU tensors the same entry
point runs the plain composition (``kernels.ref.fir_mp_oneshot_cascade``),
which is what the kernel is held to, bit for bit, on the card. Here the
plain cascade is held against the reference's ``multirate_accumulate``
through its Pallas kernels (interpret mode) at the repo's f32 kernel gate,
and the host side of the kernel route (work plan, octave table, routing,
refusals) is checked.

Inputs are seeded numpy arrays given to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filterbank as ref_fb
from repro_torch.core import filterbank as fbm
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.fir_mp import (ONESHOT_KINDS, ONESHOT_MAX_OCTAVES,
                                        ONESHOT_OCTAVE_FIELDS,
                                        fir_mp_oneshot_cascade,
                                        oneshot_octave_rows, oneshot_plan)

ATOL = 2e-5   # the repo's f32 kernel gate (tests/test_kernels.py)
KEEP, BAND, OUT = (ONESHOT_KINDS.index(k) for k in ("keep", "band", "out"))


def _bank(octaves, F=3, M=16, M_lp=6, fs=8000.0):
    cfg = fbm.FilterBankConfig(fs=fs, num_octaves=octaves,
                               filters_per_octave=F, bp_taps=M, lp_taps=M_lp,
                               use_pallas=True)
    return fbm.FilterBank(cfg, device="cpu")


def _x(B, N, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, N)).astype(np.float32)


def test_plain_cascade_is_the_per_octave_composition():
    """Octave o's HWR sums times 2^o, then the even positions of its
    low-pass hand on: the one-stage ops composed, bit for bit."""
    fb = _bank(3)
    x = torch.from_numpy(_x(2, 130, 1))
    parts, x_o = [], x
    for o in range(3):
        parts.append(ops.fir_mp_bank_accumulate(x_o, fb.bp_by_octave[o], 4.0)
                     * (2.0 ** o))
        if o < 2:
            x_o = ops.fir_mp(x_o, fb.lp_filters[o], 4.0)[..., ::2]
    got = ref.fir_mp_oneshot_cascade(x, fb.bp_by_octave, fb.lp_filters, 4.0)
    assert got.shape == (2, 9)
    assert torch.equal(got, torch.cat(parts, -1))


@pytest.mark.parametrize("B,N,octaves", [(1, 37, 2), (2, 130, 3),
                                         (2, 300, 3)])
def test_plain_cascade_matches_reference_pallas(B, N, octaves):
    fb = _bank(octaves)
    ref_cfg = ref_fb.FilterBankConfig(**fb.config._asdict())
    x = _x(B, N, N)
    want = ref_fb.multirate_accumulate(
        jnp.asarray(x), [jnp.asarray(h.numpy()) for h in fb.bp_by_octave],
        [jnp.asarray(h.numpy()) for h in fb.lp_filters], ref_cfg)
    got = ref.fir_mp_oneshot_cascade(torch.from_numpy(x), fb.bp_by_octave,
                                      fb.lp_filters, fb.config.gamma_f)
    assert tuple(got.shape) == want.shape == (B, 3 * octaves)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_multirate_accumulate_routes_cpu_tensors_to_the_plain_cascade(
        monkeypatch):
    calls = []
    plain = ref.fir_mp_oneshot_cascade

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(ref, "fir_mp_oneshot_cascade", spy)
    fb = _bank(3)
    x = torch.from_numpy(_x(2, 64, 2))
    reset_launches()
    s = fbm.multirate_accumulate(x, fb.bp_by_octave, fb.lp_filters,
                                 fb.config)
    assert calls == [(2, 64)]
    assert torch.equal(s, plain(x, fb.bp_by_octave, fb.lp_filters, 4.0))
    # leading dims are the caller's: one row in, one row of sums out
    assert torch.equal(fbm.multirate_accumulate(
        x[0], fb.bp_by_octave, fb.lp_filters, fb.config), s[0])
    # the CPU path runs no kernel, so nothing is counted
    assert LAUNCHES == {k: 0 for k in LAUNCHES}
    # the torch-op solvers (no use_pallas) and MAC mode keep their loop
    for cfg in (fb.config._replace(use_pallas=False),
                fb.config._replace(mode="mac")):
        fbm.multirate_accumulate(x, fb.bp_by_octave, fb.lp_filters, cfg)
    assert len(calls) == 2


def test_cascade_wrapper_refuses_mixed_devices():
    fb = _bank(2)
    meta = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_oneshot_cascade(meta, fb.bp_by_octave, fb.lp_filters, 4.0)
    bps = (fb.bp_by_octave[0], fb.bp_by_octave[1].to("meta"))
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        fir_mp_oneshot_cascade(torch.zeros(2, 64), bps, fb.lp_filters, 4.0)


@pytest.mark.parametrize("case,match", [
    ("x_1d", "x must be \\(B, N\\)"), ("bp_shape", "bp_taps\\[1\\]"),
    ("lp_shape", "lp_taps\\[1\\]"), ("lp_count", "need 2 low-pass"),
    ("octaves", "1 to 8 octaves"), ("M", "M = 17"),
])
def test_cascade_wrapper_refuses_bad_shapes(case, match):
    fb = _bank(3)
    x = torch.zeros(2, 64)
    bps, lps = list(fb.bp_by_octave), list(fb.lp_filters)
    if case == "x_1d":
        x = x[0]
    elif case == "bp_shape":
        bps[1] = bps[1][:2]
    elif case == "lp_shape":
        lps[1] = torch.zeros(7)
    elif case == "lp_count":
        lps = lps[:1]
    elif case == "octaves":
        bps, lps = bps * 3, lps * 4
    else:
        bps = [torch.zeros(3, 17)] * 3
    with pytest.raises(ValueError, match=match):
        fir_mp_oneshot_cascade(x, bps, lps, 4.0)


def test_oneshot_plan_sizes_the_clips():
    """B = 8 clips of 16000 samples, 5 filters, 6 octaves on a grid of 528
    CTAs: 496 kept low-pass items and 5000 band-pass items in one launch;
    each low-pass stage sits where the CTAs of the stage before it take
    their next items, band-pass items of octave 0 between. One launch runs
    the whole queue."""
    plan = oneshot_plan(8, 16000, 5, octaves=6, ctas=528)
    assert plan["lens"] == (16000, 8000, 4000, 2000, 1000, 500)
    assert plan["tiles"] == (63, 32, 16, 8, 4, 2)
    assert plan["keep_tiles"] == (32, 16, 8, 4, 2)
    segs = plan["segments"].tolist()
    # (kind, octave, items, first item of its kind and octave)
    assert [(s[0], s[1], s[3], s[4]) for s in segs] == [
        (KEEP, 0, 256, 0), (BAND, 0, 528 - 256, 0),
        (KEEP, 1, 128, 0), (BAND, 0, 256 - 128, 272),
        (KEEP, 2, 64, 0), (BAND, 0, 128 - 64, 400),
        (KEEP, 3, 32, 0), (BAND, 0, 64 - 32, 464),
        (KEEP, 4, 16, 0), (BAND, 0, 2520 - 496, 496),
        (BAND, 1, 1280, 0), (BAND, 2, 640, 0), (BAND, 3, 320, 0),
        (BAND, 4, 160, 0), (BAND, 5, 80, 0)]
    starts = np.cumsum([0] + [s[3] for s in segs])
    assert [s[2] for s in segs] == starts[:-1].tolist()
    assert plan["items"] == 5496
    # scratch: x_1..x_5 (8 rows each), then the partials
    assert plan["sig_off"] == (0, 0, 64000, 96000, 112000, 120000)
    assert plan["part_off"][0] == 124000
    assert plan["scratch"] == 124000 + 8 * 5 * (63 + 32 + 16 + 8 + 4 + 2)
    # counters: one queue head, ready per row of x_1..x_5, done per
    # (row, filter) and octave
    assert plan["ready_off"] == (0, 1, 9, 17, 25, 33)
    assert plan["done_off"][0] == 41
    assert plan["counters"] == 1 + 5 * 8 + 6 * 40
    # cached per shape, read-only
    assert oneshot_plan(8, 16000, 5, octaves=6, ctas=528) is plan
    with pytest.raises(TypeError):
        plan["items"] = 0
    with pytest.raises(ValueError):
        plan["segments"][0, 0] = 1


@pytest.mark.parametrize("B,N,F,octaves,ctas", [
    (8, 16000, 5, 6, 528), (8, 16000, 5, 6, 0), (1, 5, 5, 6, 528),
    (3, 301, 4, 8, 100), (2, 40000, 3, 8, 5000)])
def test_oneshot_plan_queue_covers_every_item_after_its_input(B, N, F,
                                                              octaves, ctas):
    """Every item of every kind and octave is queued once, in order; an
    item that reads x_o (o >= 1) comes after every keep item that writes
    it, so a wait is only ever on an earlier item."""
    plan = oneshot_plan(B, N, F, octaves=octaves, ctas=ctas)
    segs = plan["segments"].tolist()
    seen, keep_done_at = {}, {}
    for kind, o, start, count, offset in segs:
        assert offset == seen.get((kind, o), 0)
        seen[(kind, o)] = offset + count
        if kind == KEEP:
            keep_done_at[o] = start + count
        if o >= 1:                      # reads x_o, written by keep o - 1
            assert keep_done_at.get(o - 1, 1 << 40) <= start
    want = {(KEEP, o): B * k for o, k in enumerate(plan["keep_tiles"])}
    want.update({(BAND, o): B * F * t for o, t in enumerate(plan["tiles"])})
    assert seen == want
    assert plan["items"] == sum(want.values()) == segs[-1][2] + segs[-1][3]


def test_oneshot_plan_one_stage_forms():
    # one octave: the one-stage accumulate mode, band items only
    band = oneshot_plan(3, 300, 5)
    assert band["segments"].tolist() == [[BAND, 0, 0, 3 * 5 * 2, 0]]
    assert band["scratch"] == 30 and band["counters"] == 1 + 15
    # the output mode: every position of one octave, no scratch
    out = oneshot_plan(3, 300, 5, output=True)
    assert out["segments"].tolist() == [[OUT, 0, 0, 30, 0]]
    assert out["scratch"] == 0 and out["counters"] == 1
    assert oneshot_plan(1, 5, 1, octaves=6)["lens"] == (5, 3, 2, 1, 1, 1)


@pytest.mark.parametrize("kw,match", [
    (dict(B=0), "B = 0"), (dict(N=0), "N = 0"), (dict(F=0), "F = 0"),
    (dict(octaves=ONESHOT_MAX_OCTAVES + 1), "octaves = 9"),
    (dict(octaves=2, output=True), "output mode runs one octave"),
])
def test_oneshot_plan_refuses_shapes_outside_the_kernel(kw, match):
    args = dict(B=2, N=100, F=5)
    args.update({k: kw.pop(k) for k in ("B", "N", "F") if k in kw})
    with pytest.raises(ValueError, match=match):
        oneshot_plan(args["B"], args["N"], args["F"], **kw)


def test_octave_rows_point_into_scratch_and_counters():
    fb = _bank(3)
    B, N = 2, 600
    plan = oneshot_plan(B, N, 3, octaves=3)
    x = torch.zeros(B, N)
    scratch = torch.empty(plan["scratch"])
    counters = torch.zeros(plan["counters"], dtype=torch.int32)
    rows = oneshot_octave_rows(plan, x, fb.bp_by_octave, fb.lp_filters,
                               scratch, counters)
    f = {k: rows[:, i].tolist() for i, k in enumerate(ONESHOT_OCTAVE_FIELDS)}
    sp, cp = scratch.data_ptr(), counters.data_ptr()
    assert f["src"] == [x.data_ptr(), sp + 4 * plan["sig_off"][1],
                        sp + 4 * plan["sig_off"][2]]
    assert f["dst"] == f["src"][1:] + [0]          # x_{o+1}, none at the end
    assert f["bp"] == [h.data_ptr() for h in fb.bp_by_octave]
    assert f["fir"] == [h.data_ptr() for h in fb.lp_filters] + [0]
    assert f["ready_in"] == [0, cp + 4, cp + 4 * 3]
    assert f["ready_out"] == f["ready_in"][1:] + [0]
    assert f["done"] == [cp + 4 * o for o in plan["done_off"]]
    assert f["n"] == [600, 300, 150] and f["tiles"] == [3, 2, 1]
    assert f["out_len"] == [300, 150, 0] and f["fir_tiles"] == [2, 1, 0]
    # a row of x_o is ready once every keep item of its stage wrote it
    assert f["ready_target"] == [0, 2, 1]
    assert f["col"] == [0, 3, 6] and f["scale_exp"] == [0, 1, 2]
    # the output mode: one row, out items into y (B, F, N)
    out = oneshot_plan(B, N, 3, output=True)
    y = torch.empty(B, 3, N)
    row = oneshot_octave_rows(out, x, [], [fb.bp_by_octave[0]], None,
                              counters, y)[0].tolist()
    assert row == [x.data_ptr(), 0, fb.bp_by_octave[0].data_ptr(),
                   y.data_ptr(), 0, 0, 0, 0, N, 3, 3, 3, N, 1, 0, 0, 0]
