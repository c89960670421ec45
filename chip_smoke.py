#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports ``src/repro_torch``; no JAX,
nothing of the reference package). Phases, each failing loudly:

1. device  — a CUDA card must be present; prints ``nvidia-smi``'s name and
             power limit.
2. build   — compiles every CUDA source (one nvcc each, in parallel).
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes: max abs diff, kernel ms (CUDA events,
             warmed up, many launches), plain ms, and the launches this
             phase made. Tolerance: every output within
             1e-5 * (1 + max |plain|).
4. serve   — the full esc10-mp bank (30 bands) behind a StreamServer of 256
             slots: 256 sessions, 50 rounds of 160-sample packets (10 ms at
             16 kHz). The stream kernel must launch 6 times per wave; the
             decisions must be finite, within [-1, 1], and the final p
             within 1e-5 of the torch-op cascade (stream_impl="xla")
             served the same feeds on the card.
5. one-shot — ``apply(x)`` through the bank kernels (use_pallas=True) on
             8 x 16000 samples against the plain path (use_pallas=False,
             solver="bisect"): phi within 1e-4 * (1 + max |phi|), p within
             5e-3 (the two paths bisect with different sum orders).

Then one ``{"kernels": [...]}`` line, the card line again, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_OPS_PER_S = 33.5e12   # H100 SXM f32 lane ops/s (67 TFLOP/s, FMA = 2)
HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-5
ONESHOT_PHI_TOL = 1e-4
ONESHOT_P_TOL = 5e-3


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device-side ms per call of ``fn`` over ``reps`` calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, its bound KERNEL_TOL * (1 + max |want|))."""
    d = float((got - want).abs().max())
    return d, KERNEL_TOL * (1.0 + float(want.abs().max()))


# -- operation counts for the bounds (what these inputs need) ---------------


def ops_newton(M: int, iters: int = 12) -> int:
    """f32 ops of one mpabs_newton over M lanes: init (add, abs, max per
    lane); per step 2M x (sub, max, compare, count add), two adjacent-pair
    trees + join, then sub, max, div, add."""
    return 3 * M + iters * (8 * M + 2 * (M - 1) + 1 + 4)


def ops_bisect(M: int, iters: int = 26) -> int:
    """f32 ops of one bisection over M lanes and 2M branch operands:
    init (add, abs, max per lane, sub); per step mid (add, mul), 2M x
    (sub, max) plus 2M - 1 adds, compare, 2 selects; final add, mul."""
    return 3 * M + 1 + iters * (2 + 4 * M + 2 * M - 1 + 3) + 2


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- phases ------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"build: {secs:.2f} s for {list(_build.SOURCES)}")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return secs


def phase_stream_kernel(fb, gen):
    """fir_mp_stream_octave vs plain at the serve path's six octave shapes:
    S = 256 slots, L = 256 (the 160-sample packet's bucket) then 128, ...,
    8; valid counts mixed (0 and odd included), random phases."""
    import torch
    from repro_torch.core.filterbank import accumulate_block_len
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels.fir_mp import fir_mp_stream_octave
    dev = torch.device("cuda")
    reset_launches()
    c = fb.config
    S, L, T1 = 256, 256, max(c.bp_taps, c.lp_taps) - 1
    F = c.filters_per_octave
    err, ms, plain_ms, ops, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    for o in range(c.num_octaves):
        Lo = -(-L // 2 ** o)
        n = torch.randint(0, Lo + 1, (S,), generator=gen, dtype=torch.int32)
        n[:8] = 0
        n[8:16] = Lo
        n[16:24] = torch.arange(8, dtype=torch.int32) * 2 % Lo + 1  # odd
        x = torch.randn(S, Lo, generator=gen)
        if o == 0:   # the main path zeroes invalid tails of the chunk
            x = torch.where(torch.arange(Lo)[None] < n[:, None], x, 0.0)
        emit = o < c.num_octaves - 1
        args = [t.to(dev) for t in (
            x, n, torch.randint(0, 2, (S,), generator=gen, dtype=torch.int32),
            torch.randn(S, T1, generator=gen), torch.rand(S, F, generator=gen),
            torch.rand(S, generator=gen))]
        args += [fb.bp_by_octave[o],
                 fb.lp_filters[o] if emit else torch.zeros(1, device=dev)]
        kw = dict(scale=2.0 ** o, solver=c.solver, emit_next=emit,
                  update_amax=(o == 0))
        got = fir_mp_stream_octave(*args, c.gamma_f, **kw)
        want = ref.fir_mp_stream_octave(*args, c.gamma_f, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if w is None:
                continue
            d, tol = max_err(g, w)
            if not d <= tol:
                raise AssertionError(
                    f"fir_mp_stream_octave octave {o}: max |diff| {d} > {tol}")
            err = max(err, d)
        inert = args[1].cpu() == 0
        for g, w in ((got[0], args[4]), (got[1], args[3])):
            if not torch.equal(g.cpu()[inert], w.cpu()[inert]):
                raise AssertionError(f"octave {o}: an n == 0 slot moved")
        ms += cuda_ms(lambda: fir_mp_stream_octave(*args, c.gamma_f, **kw),
                      50)
        plain_ms += cuda_ms(
            lambda: ref.fir_mp_stream_octave(*args, c.gamma_f, **kw), 3)
        nv = n.long()
        kept = (torch.clamp_min(nv - args[2].cpu().long() + 1, 0) // 2
                if emit else nv * 0)
        ops += (int(nv.sum()) * F * (2 * ops_newton(c.bp_taps) + 1)
                + int(kept.sum()) * (2 * ops_newton(c.lp_taps) + 1))
        LB = accumulate_block_len(Lo)
        nbytes += 4 * (S * Lo + 2 * S + 2 * S * T1 + 2 * S * F + 2 * S
                       + F * c.bp_taps + c.lp_taps
                       + (S * -(-Lo // LB) * LB // 2 if emit else 0))
    b_ms, b_by = bound_ms(ops, nbytes)
    row = dict(name="fir_mp_stream_octave", shapes=f"S={S} L={L}..{Lo}",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by,
               launches_here=LAUNCHES["fir_mp_stream_octave"])
    log({"kernel_vs_plain": row})
    return row


def phase_bank_kernels(fb, x):
    """fir_mp_bank (both modes) and fir_mp (single LP filter) vs plain at
    the one-shot path's shapes: B = 8 rows, N = 16000 then each octave's
    decimated length."""
    import torch
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels.fir_mp import fir_mp_bank_kernel, fir_mp_kernel
    c = fb.config
    reset_launches()
    B, N = x.shape
    F = c.filters_per_octave
    rows = {}
    for name in ("fir_mp_bank", "fir_mp"):
        rows[name] = dict(name=name, max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                          ops=0.0, nbytes=0.0)
    x_o = x
    for o in range(c.num_octaves):
        N_o = x_o.shape[1]
        H = fb.bp_by_octave[o]
        for acc in (True, False):
            got = fir_mp_bank_kernel(x_o, H, c.gamma_f, accumulate=acc)
            want = (ref.fir_mp_bank_accumulate if acc else ref.fir_mp_bank)(
                x_o, H, c.gamma_f)
            d, tol = max_err(got, want)
            if not d <= tol:
                raise AssertionError(f"fir_mp_bank octave {o} accumulate="
                                     f"{acc}: max |diff| {d} > {tol}")
            rows["fir_mp_bank"]["max_abs_err"] = max(
                rows["fir_mp_bank"]["max_abs_err"], d)
        r = rows["fir_mp_bank"]    # the main path runs accumulate mode
        r["ms"] += cuda_ms(lambda: fir_mp_bank_kernel(
            x_o, H, c.gamma_f, accumulate=True), 20)
        r["plain_ms"] += cuda_ms(lambda: ref.fir_mp_bank_accumulate(
            x_o, H, c.gamma_f), 2)
        r["ops"] += B * N_o * F * (2 * ops_bisect(c.bp_taps) + 1)
        r["nbytes"] += 4 * (B * N_o + F * c.bp_taps + B * F)
        if o == c.num_octaves - 1:
            break
        h = fb.lp_filters[o]
        got = fir_mp_kernel(x_o, h, c.gamma_f)
        want = ref.fir_mp(x_o, h, c.gamma_f)
        d, tol = max_err(got, want)
        if not d <= tol:
            raise AssertionError(f"fir_mp octave {o}: max |diff| {d} > {tol}")
        r = rows["fir_mp"]
        r["max_abs_err"] = max(r["max_abs_err"], d)
        r["ms"] += cuda_ms(lambda: fir_mp_kernel(x_o, h, c.gamma_f), 20)
        r["plain_ms"] += cuda_ms(lambda: ref.fir_mp(x_o, h, c.gamma_f), 2)
        r["ops"] += B * N_o * (2 * ops_bisect(c.lp_taps) + 1)
        r["nbytes"] += 4 * (2 * B * N_o + c.lp_taps)
        x_o = want[:, ::2].contiguous()
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("ops"), r.pop("nbytes"))
        r["shapes"] = f"B={B} N={N}..{x_o.shape[1]}"
        r["launches_here"] = LAUNCHES[r["name"]]
        log({"kernel_vs_plain": r})
    return rows


def serve(pipe, audio, rounds: int, packet: int):
    """Open one session per audio row, feed ``rounds`` packets each;
    returns (server, final p, per-round seconds)."""
    import torch
    from repro_torch.serving import StreamServer
    S = audio.shape[0]
    server = StreamServer(pipe, capacity=S, max_chunk=256)
    ids = [f"s{i:03d}" for i in range(S)]
    for sid in ids:
        server.open(sid)
    secs, results = [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        res = server.feed([(sid, audio[i, r * packet:(r + 1) * packet])
                           for i, sid in enumerate(ids)])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        results.extend(res)
    for fr in results:
        if not (math.isfinite(fr.confidence) and -1 <= fr.confidence <= 1):
            raise AssertionError(f"bad decision {fr}")
    p, _ = pipe.apply(torch.zeros(S, 0), server.state)   # pure readout
    return server, p, secs


def step_breakdown(pipe, state, S: int) -> dict:
    """Where a serve step's time goes, on one (S, 256) wave of 160-sample
    packets: the whole session step, its octave cascade (6 stream kernel
    launches and the glue around them) and the kernel machine readout, each
    timed alone with CUDA events; then the step under torch.profiler for
    the device's busy share and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = pipe.device
    g = torch.Generator().manual_seed(1)
    chunk = torch.randn(S, 256, generator=g).to(dev)
    valid = torch.full((S,), 160, dtype=torch.int32, device=dev)
    chunk[:, 160:] = 0
    phi = (state.acc - pipe.mu) / pipe.sigma
    out = dict(
        session_step_ms=cuda_ms(
            lambda: pipe._session_step(state, chunk, valid), 20),
        cascade_ms=cuda_ms(
            lambda: pipe._cascade_pallas(state, chunk, valid), 20),
        readout_ms=cuda_ms(lambda: pipe.clf(phi, exact=False), 20))
    reps = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pipe._session_step(state, chunk, valid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = sorted(((getattr(e, "self_device_time_total", 0.0), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy_us = sum(t for t, _ in kern)
    out["profiled_step_ms"] = wall / reps * 1e3
    out["device_busy_share"] = (busy_us * 1e-6 / wall) if busy_us else None
    out["device_kernels_per_step"] = (
        sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / reps)
    out["stream_kernel_device_us_per_step"] = sum(
        t for t, k in kern if "fir_mp_stream_octave_kernel" in k) / reps
    out["top_device_us_per_step"] = [[k[:60], t / reps] for t, k in kern[:6]]
    return out


def phase_serve(audio):
    import torch
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    pipe = make_pipeline()                   # full 30-band bank, on cuda
    if pipe.config.num_filters != 30 or pipe.device.type != "cuda":
        raise AssertionError("make_pipeline() must give the 30-band bank "
                             "on cuda")
    serve(pipe, audio[:, :2 * 160], 2, 160)  # warm-up on a throwaway server
    reset_launches()
    server, p, secs = serve(pipe, audio, 50, 160)
    launches = LAUNCHES["fir_mp_stream_octave"]
    waves = server.steps_run
    if not (waves > 0 and launches == 6 * waves):
        raise AssertionError(f"stream kernel launched {launches} times for "
                             f"{waves} waves (want 6 per wave)")
    if not (torch.isfinite(p).all() and p.abs().max() <= 1):
        raise AssertionError("final decisions not finite / outside [-1, 1]")
    plain = make_pipeline(stream_impl="xla", use_pallas=False)
    _, p_plain, secs_plain = serve(plain, audio, 50, 160)
    d = float((p - p_plain).abs().max())
    if not d <= SERVE_TOL:
        raise AssertionError(f"served p vs torch-op cascade: {d} > "
                             f"{SERVE_TOL}")
    S = audio.shape[0]
    step_ms = sorted(secs)[len(secs) // 2] * 1e3
    breakdown = step_breakdown(pipe, server.state, S)
    out = dict(phase="serve", streams=S, waves=waves,
               stream_kernel_launches=launches, step_ms_median=step_ms,
               step_ms_mean=sum(secs) / len(secs) * 1e3,
               streams_per_s=S * len(secs) / sum(secs),
               plain_step_ms_median=sorted(secs_plain)[len(secs) // 2] * 1e3,
               max_abs_diff_vs_plain=d, **breakdown)
    log(out)
    return launches


def phase_oneshot(x):
    import torch
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.core.pipeline import InFilterPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    pipe = make_pipeline()
    plain = InFilterPipeline(
        pipe.config._replace(use_pallas=False, solver="bisect"),
        pipe.bp_taps, pipe.lp_taps, pipe.mu, pipe.sigma, pipe.clf.params,
        device="cuda")
    pipe.apply(x)                            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    p, phi = pipe.apply(x, return_features=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    if launches["fir_mp_bank"] != 6 or launches["fir_mp"] != 5:
        raise AssertionError(f"one-shot launches {launches}: want 6 bank "
                             "and 5 single-filter")
    t0 = time.perf_counter()
    p2, phi2 = plain.apply(x, return_features=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    dphi = float((phi - phi2).abs().max())
    dp = float((p - p2).abs().max())
    tol = ONESHOT_PHI_TOL * (1 + float(phi2.abs().max()))
    if not (torch.isfinite(p).all() and dphi <= tol and dp <= ONESHOT_P_TOL):
        raise AssertionError(f"one-shot vs plain: phi {dphi} (tol {tol}), "
                             f"p {dp} (tol {ONESHOT_P_TOL})")
    log(dict(phase="oneshot", shape=list(x.shape), ms=ms, plain_ms=plain_ms,
             max_abs_diff_phi=dphi, max_abs_diff_p=dp, launches=launches))
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.configs.esc10_mp import FILTERBANK
    from repro_torch.core.filterbank import FilterBank
    from repro_torch.data.acoustic import make_esc10_like

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = phase_build()
    fb = FilterBank(FILTERBANK, device="cuda")
    gen = torch.Generator().manual_seed(0)
    stream_row = phase_stream_kernel(fb, gen)

    # seeded synthetic ESC-10-like audio (numpy), 1 s clips at 16 kHz
    clips = make_esc10_like(per_class_train=26, per_class_test=1,
                            fs=16000.0, seconds=1.0, seed=0).x_train
    x1 = torch.from_numpy(np.ascontiguousarray(clips[:8])).cuda()
    bank_rows = phase_bank_kernels(fb, x1)

    serve_launches = phase_serve(clips[:256, :50 * 160])
    oneshot_launches = phase_oneshot(x1)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(stream_row, route="cuda", source=src + "fir_mp_stream.cu",
             replaces="src/repro/kernels/fir_mp.py:279",
             launches=serve_launches, library_ms=None),
        dict(bank_rows["fir_mp_bank"], route="cuda",
             source=src + "fir_mp_bank.cu",
             replaces="src/repro/kernels/fir_mp.py:112",
             launches=oneshot_launches["fir_mp_bank"], library_ms=None),
        dict(bank_rows["fir_mp"], route="cuda",
             source=src + "fir_mp_bank.cu",
             replaces="src/repro/kernels/fir_mp.py:382",
             launches=oneshot_launches["fir_mp"], library_ms=None),
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total: {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    log(card)
    log({"kernels": [{k: r[k] for k in keys} for r in kernels]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
