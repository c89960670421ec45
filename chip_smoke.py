#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py    # every phase below

Runs from the root of a checkout (it imports ``src/repro_torch``; no JAX,
nothing of the reference package). Phases, each failing loudly:

1. device  — a CUDA card must be present; prints ``nvidia-smi``'s name and
             power limit.
2. build   — compiles every CUDA source (one nvcc each, in parallel);
             prints ptxas's registers and spills per kernel, the SASS
             census of the stream kernels' band-pass solve step (FP32 or
             INT and all instructions per operand lane per iteration), of
             the one-shot bank kernel's bisection steps (one loop per
             window width) and of the int one-shot cascade's steps (one
             loop per window width, both branches of a dot in it: its
             instructions per branch step against the count of
             ``ops_int_dot_min``, 31 at 16 lanes and 16 at 6).
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes: max abs diff, kernel ms (CUDA events,
             warmed up, many launches), plain ms, and the launches this
             phase made. Tolerance: every output within
             1e-5 * (1 + max |plain|). The float stream kernel twice: its
             one-octave entry at the six octave shapes of a wave, and the
             cascade (all six octaves in one launch) on a served wave
             (n = 160 of 256, fresh and one wave later with odd phases)
             and on mixed valid counts at L = 700, every delay line,
             consumed counter (exactly), acc and amax, n == 0 slots bit for
             bit. The cascade's row is timed on the served wave: ms by CUDA
             events over back-to-back calls, as every row (the wrapper's
             host work outlasts the kernel, so this is host time), its
             device_ms by torch.profiler, the wrapper's host microseconds
             part by part (checks and conversions, output allocations, the
             octave table, the C launch call, the cached and uncached
             launch plan), and the one-octave entries' device time per
             octave of the same wave (the octave profile). The one-shot
             bank: its one-stage entries (fir_mp_bank, fir_mp) at each
             octave's shapes, with the device time per launch of one
             apply's bank through them (the route before the cascade);
             then the cascade (fir_mp_oneshot_cascade: the whole bank of
             one apply in one launch) bit for bit against its plain
             version on the clips and on odd lengths, with its device
             time by the profiler and its bound (each low-pass at its
             kept positions; at all of them beside).
4. serve   — the full esc10-mp bank (30 bands) behind a StreamServer of 256
             slots, 50 waves of 160-sample packets (10 ms at 16 kHz):
             255 regular sessions, stream 0 sending 300 samples in wave 10
             and 20 in wave 11 (a bucket change, 256 -> 512 -> 256), and
             the last slot churned between replays (one visitor opened
             before wave 5 and closed before wave 20, another opened
             before wave 30 on cleared registers). The served step runs
             as one CUDA graph per bucket: the server must count one
             replay per wave and one capture per bucket, and the stream
             cascade's launches must be the replays plus one warm-up run
             per capture (the one-octave kernel none). Every decision and
             every register must equal, bit for bit, an eager run of
             ``pipe._session_step`` on the same waves; the decisions must
             be finite, within [-1, 1], and the final p within 1e-5 of the
             torch-op cascade (stream_impl="xla") served the same waves.
             Printed, not gated: feed() and the step, captured against
             eager, in alternating pairs (host ms; device ms by CUDA
             events), the captured step's device time part by part (each
             part captured alone and replayed: masking, the cascade,
             standardize, the readout, the copies around them, and the
             whole step), and the eager step's breakdown under the
             profiler.
   serving tier — on the card at 256 slots: submit / poll / drain with a
             coalescing watermark against feed(), eviction of 32 sessions
             to a temporary checkpoint_dir and reopening them, and a
             2-shard StreamRouter against one server, each bit for bit
             (decisions and every register); the poisoned-server contract
             with a step forced to raise and with a graph replay forced
             to fail.
5. one-shot — ``apply(x)`` through the cascade kernel (use_pallas=True,
             one launch, no one-stage launch) on 8 x 16000 samples against
             the plain path (use_pallas=False, solver="bisect"): phi within
             1e-4 * (1 + max |phi|), p within 5e-3 (the two paths bisect
             with different sum orders); then where its time goes: the
             filter bank against standardize + readout (CUDA events) and,
             under the profiler, each one's and the whole apply's device
             kernels, device busy us and busy share.
6. int kernels — the fixed-point twin (numerics="fixed") at full width,
             its program calibrated on the seeded clips: the int stream
             kernel's one-octave entry on the 6 octaves of one wave (S =
             256, L = 256, mixed valid counts) and its cascade on the cases
             of phase 3 (the clips' ADC codes); the int one-shot kernel's
             one-stage entry (fir_mp_bank_q) in both modes at the 6 + 5
             stage shapes of one ``apply`` (B = 8, N = 16000), with the
             device time per launch of one apply's bank through it (the
             route before the cascade); then the int one-shot cascade
             (fir_mp_oneshot_cascade_q: the whole bank of one fixed apply
             in one launch) on the clips' ADC codes and on odd lengths
             (B = 1 and N < 256 among them), with its device time by the
             profiler, grid and items. Gate: every output exactly equal
             (int32, torch.equal). The stream cascade's row as phase 3's.
             The bounds count the cheapest exact step (the stream
             kernel's) in the instructions the card issues (three-input
             adds), the one-shot cascade's low-pass at its kept positions;
             the count at every position and the reference algorithm's
             are printed beside.
7. fixed serve — phase 4's waves through a fixed pipeline, with phase 4's
             gates (one replay per wave, one capture per bucket, the int
             cascade's launches, captured bit for bit the eager step); the
             final codes and accumulators exactly those of the torch-op
             integer cascade (stream_impl="xla") on the same waves, and,
             for the 255 regular streams, of one-shot ``infer_q`` on the
             8000 samples each was fed (one int one-shot cascade launch);
             phase 4's timings.
8. fixed one-shot — ``apply(x)`` on 8 x 16000 through the int one-shot
             cascade (one launch, no one-stage launch) against the torch-op
             path: p and phi codes exactly equal; then where its time goes,
             as phase 5's: the bank (quantize + cascade) against the
             readout (standardize_q + classifier_q) by CUDA events, the
             bank's device time and records, and under the profiler the
             apply's and the readout's device kernels, busy us and share.
9. MP kernels — ``mp_linear`` against its plain version at every distinct
             projection shape of qwen3-8b decode at B = 2, on the dtypes
             ``decode_step`` gives it (bf16 layer weights read as they
             are, the f32 head, bf16-valued f32 activations; the plain
             version gets ``w.float()``), with the tile each shape takes
             (BB, TO, CTAs, CTAs per SM, waves), its time with no
             bisection step (staging, max pass, launch), the SASS census
             of its hot loop (FP32 and all instructions per (b, o, i) per
             step), and a sweep of every tile width that fits each shape
             (each held to the same gate, its time and waves printed), and
             ``mp_waterfill`` through ``ops.mp_waterfill`` at the bank's
             per-position MP solves of one served wave (256 x 30 x 160
             rows of 32) and at 8 x 257, with the layout it takes there
             (lanes per row, elements per lane). Gate: every output within
             1e-5 * (1 + max |plain|). Kernel ms per decode step (CUDA
             events), plain ms, bound.
10. train — esc10-mp ``InFilterPipeline.fit`` at full width (30 bands)
             on 260 seeded synthetic 1 s clips at 16 kHz (26 per class)
             under ``configs.esc10_mp.TRAIN`` (600 SGD steps, gamma
             annealed from 4 over 200). Gates: the features in one
             one-shot cascade launch, within the one-shot phase's phi
             tolerance of the plain path (bisect, torch ops) on the first
             32 clips; the first 20 losses within 1e-3 x (1 + max) of the
             same 20 steps run by the port on the CPU from the same params
             and batches; every loss finite and the last below the first;
             the trained pipeline deploys through ``calibrate_fixed`` and a
             fixed ``apply`` in one int cascade launch, p finite in
             [-1, 1]. Printed: held-out accuracy (float and fixed), the
             features' ms, ms per step (host; device busy by the
             profiler), kernels per step, the 600 steps' seconds.
11. LM train and MP backward — ``make_train_step`` at full width and
             depth 2 (1.63 G params, B = 2, S = 32 from ``TokenStream``,
             MP mode, AdamW): three steps on one batch, 15 forward and 15
             backward launches each, losses finite and falling, grad norms
             finite; ms per step, peak memory, and one more step profiled:
             the forward's launches (all writing levels under grad; one
             that does not fails), the backward's grads pass, the rest.
             Then one more step whose 15 forward launches must all write
             levels (checked at the wrapper, without the profiler) and
             whose 15 grads passes are recorded (x, w,
             g and the levels lv the forward wrote, as the step gives
             them: 64 rows for the projections, 62 for the head), and on
             each of them: the levels-writing forward's y bit for bit the
             forward alone's and its levels the step's again; those
             levels within 1e-6 x (1 + |z|) of the sort's and every
             support the sort's except on a branch with an operand within
             that of its level (counted and printed); the grads pass
             (``csrc/mp_linear_bwd.cu``) the same bits twice, within 1e-5
             x max (the step's gradients lie far below 1) of the plain dx
             and dw on its own levels and of the plain version on the
             rows and columns no such branch feeds (their counts
             printed); the control (dv's sign flipped) must miss. Row 6b's
             ms is the grads launch plus what the levels add to the
             forward (the levels-writing forward minus the forward alone),
             summed over the 15 calls with the plain ms; its bound counts
             the same work in its cheapest form: Newton from the forward's
             bracket with the passes these inputs need, and one fused mask
             pass (counted here, its levels held to the sort's too); the
             bounds of a backward that solves its own levels (the
             sort-based form, and a levels pass in the old kernel's form)
             and the same work as the rule reads are printed beside.
             The forward alone gets its own bound per call (and summed):
             ``ops_mp_linear`` at the train shapes, x and w read once, y
             written, beside its ms (``forward_x_bound``).
12. decode — ``DECODE``'s configs in MP mode (gamma 8, bf16 compute,
             seeded random f32 masters on the card) at full width, each
             served by ``serve_decode`` (B = 2, 4 prompt + 4 generated,
             greedy): qwen3-8b (36 layers, vocab 151,936),
             deepseek-moe-16b (28 layers: a dense first layer, 2 shared +
             64 routed experts top-6), mamba2-2.7b (64 layers, tied head),
             jamba-v0.1-52b cut to one period of 8 layers (1 attention, 7
             Mamba, 4 MoE of 16 experts: 52 G f32 masters do not fit one
             card) and internvl2-2b (24 layers; first a ``forward`` over 16
             patch embeddings, cut from 1,024, and the 4 prompt tokens,
             held as the decode step is, its f32 forward gated the same
             way). Gates: the mp_linear launches per step equal the layer
             plan's count (``mp_launches_per_step``: 7 x 36 + 1 = 253 for
             qwen3-8b), every logit finite; one served step's calls
             recorded and each shape held against the plain version on its
             own operands (KERNEL_TOL), its device time by the profiler
             (mp_linear, the copies, the ten longest kernels) against the
             bound at these shapes; f32-compute steps through the kernel at
             pos 0 and pos 4 (over the prompt's cache), and at pos 4 with
             each layer's weights cast to bf16 as the served step casts
             them (the kernel then reads bf16 w as when served), at full
             depth, within 1e-3 x max |plain| of the same steps with
             ``models.layers.mp_linear`` swapped for the plain version
             (mamba2: 2e-4, where a 22-step solve lands within 1e-3), the
             kernel at 22 bisection steps outside it (24, 20, 18 printed),
             and for MoE the same experts chosen by both paths (both
             routers in f32 there, see ``gated_run``). The bf16 served
             step's gap at pos 4 is printed, not gated. Bounds count the
             cheapest exact form of the MP step.
13. encoder — hubert-xlarge at full width and depth (48 layers,
             LayerNorm, GELU, not causal): ``forward`` over B = 2 x 64
             frames, 289 launches (6 per layer and the head; the frame
             projection is a torch product, as in the reference), logits
             finite; its calls held shape by shape; the f32 forward over
             the first 4 layers within 3e-5 x max |plain| of the plain
             version's, the kernel at 22 bisection steps outside it
             (``HUBERT_GATE``: the f32 sums leave 26 steps little room).
14. IR — the fixed-point IR and static-analysis tier
             (``repro_torch.analysis``, ``repro_torch.ir``) on the port's
             programs at the full esc10-mp config: the five targets traced
             (``oneshot_q``, ``session_step_q``, the plain kernel versions
             ``oneshot_q_cascade`` and ``stream_cascade_q``, and
             ``float_oneshot`` for the lint) and the four fixed ones
             lowered, with nodes, instructions, registers and seconds per
             target. Gates: legality and determinism clean on the four
             fixed targets; the session envelope (``meta``) equal to the
             committed ``ANALYSIS.json``'s, and ``oneshot_q``'s and
             ``session_step_q``'s out intervals each inside the committed
             one (the tighter ones named) with the same
             ``max_required_bits`` and no overflow. Each census is printed
             beside the committed ``artifacts/ir/<t>/ir.json``'s, with the
             difference split into what ``tests/ir_reference.py`` names
             (the reference's padded bank blocks, its data-dependent
             index normalization) and the rest, which must equal that
             module's ``COMMITTED_INPUT_FREE`` (the reference's input-free
             index arithmetic and loop counters, which the port folds,
             pinned against the live reference by
             ``tests/test_torch_ir_full.py``). Then on the card:
             ``oneshot_q``'s program re-emitted to torch
             (``ir.emit_torch``) on 8 seeded 1 s clips, one per call,
             exactly equal to ``infer_q`` through the int one-shot
             cascade kernel and to the plain path; ``session_step_q``'s
             program over 100 chunks of 160 of one clip, every register
             and output exactly equal at every step to the card's session
             step through the int stream cascade kernel, the last p_q
             equal to one-shot ``infer_q`` of the same second. The C of
             an ``esc_mp_bisect``-shaped program and of the smoke config
             compiled with ``gcc -std=c99 -O1``, run, exactly equal to the
             interpreter; at the full config the C and Verilog emission
             timed, their bytes printed. The re-emitter's ms per clip and
             per step are printed beside the card line (not a metric).
Then one ``{"kernels": [...]}`` line, the card line again, and as the last
line ``{"ok": true, "device": {...}}``. A kernel off the main path (the
one-stage bank entries, float and int, and mp_waterfill) reports the
launches of its own phase; ``main_path_launches`` beside says the main
path made none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

F32_OPS_PER_S = 33.5e12   # H100 SXM f32 lane ops/s (67 TFLOP/s, FMA = 2)
INT32_OPS_PER_S = 16.7e12  # H100 SXM int32 lanes: 64/SM x 132 SMs x 1.98 GHz
HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-5
SERVE_TOL = 1e-5
ONESHOT_PHI_TOL = 1e-4
ONESHOT_P_TOL = 5e-3
DECODE_TOL = 1e-3         # x max |plain logit|: the f32 step, kernel vs plain
CONTROL_ITERS = (24, 22, 20, 18)   # coarser solves: the controls
CONTROL_GATE_ITERS = 22   # ... of which this one must miss the decode gate
MP_GAMMA = 8.0            # qwen3-8b's mp_gamma
WATERFILL_GAMMA = 4.0     # the esc10-mp bank's gamma_f


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


def ops_newton_steps(u, gamma: float, iters: int = 12) -> tuple[int, int]:
    """f32 ops of the float stream kernel's Newton solves of mpabs over the
    operand windows u (..., M), counted step by step in the form the
    kernel runs, with z following the reference's iteration on these
    windows: the start (abs, max per lane, sub: 2M + 1); per step with
    z >= 0 a sub, max, compare and count add per lane and one tree (4M +
    M - 1), with z < 0 two subs, a max, compare and count add per lane, two
    trees and their join and the count's M (5M + 2 (M - 1) + 2); either
    way the sub, max, divide and add of the update (4). Returns (these
    ops, the reference's form's: ``ops_newton`` per solve)."""
    import torch
    from repro_torch.core.mp import tree_sum
    M = u.shape[-1]
    P = 1 << (M - 1).bit_length()
    a = torch.nn.functional.pad(u.abs(), (0, P - M))
    lane = torch.arange(P, device=u.device) < M
    z = a.amax(-1) - gamma
    neg_steps = 0
    for _ in range(iters):
        neg_steps += int((z < 0).sum())
        zc = z[..., None]
        tp = torch.where(lane, torch.clamp_min(a - zc, 0), 0.0)
        tn = torch.where(lane, torch.clamp_min(-a - zc, 0), 0.0)
        cnt = ((a > zc) & lane).sum(-1) + ((-a > zc) & lane).sum(-1)
        z = z + (tree_sum(tp) + tree_sum(tn) - gamma) / torch.clamp_min(
            cnt.float(), 1.0)
    solves = z.numel()
    pos_steps = solves * iters - neg_steps
    ops = (solves * (3 * M + 1 + 4 * iters) + pos_steps * (5 * M - 1)
           + neg_steps * (7 * M))
    return ops, solves * ops_newton(M, iters)


def ops_bisect(M: int, iters: int = 26) -> int:
    """f32 ops of one bisection over M lanes and 2M branch operands:
    init (add, abs, max per lane, sub); per step mid (add, mul), 2M x
    (sub, max) plus 2M - 1 adds, compare, 2 selects; final add, mul."""
    return 3 * M + 1 + iters * (2 + 4 * M + 2 * M - 1 + 3) + 2


def ops_int_dot(M: int, iters: int) -> int:
    """int32 ops of one fxp_mp_dot over M lanes: operands (add or sub,
    then a two-sided clamp) for u and v; per mpabs the init (abs, max per
    lane, sub) and per step mid (add, shift), 2M x (sub, max) plus 2M
    adds, compare, 2 selects; then the final sub."""
    mpabs = 2 * M + 1 + iters * (2 + 6 * M + 3)
    return 6 * M + 2 * mpabs + 1


def ops_int_dot_min(M: int, iters: int) -> int:
    """int32 instructions of one fxp_mp_dot over M lanes in the cheapest
    exact form of a step, the one the int stream kernel runs, counted as
    the card issues them (one lane op each; an add takes three inputs): a
    lane's two hinges relu(t - mid) + relu(-t - mid) equal max(|t|, |mid|)
    - mid. The operands, add or sub and a two-sided clamp (6M for u and
    v); each mpabs takes |t| per lane, their max and lo (2M), then per
    step mid (add, shift), |mid|, the seed -M mid (one multiply-add), a
    max per lane, the M + 1 terms in ceil(M / 2) three-input adds, the
    compare and 2 selects (M + ceil(M / 2) + 7: 31 at M = 16, where the
    kernel's loop takes 34 with its loop control, PERF.md §6); then the
    final sub. About 0.35 of ``ops_int_dot`` at M = 16."""
    step = M + -(-M // 2) + 7
    mpabs = 2 * M + iters * step
    return 6 * M + 2 * mpabs + 1


def ops_mp_linear(B: int, d: int, O: int, iters: int = 26) -> int:
    """f32 ops that mp_linear needs on (B, d) x (d, O), counted from the
    cheapest exact form of a bisection step, the one the kernel runs: a
    branch's hinge pair [t - mid]_+ + [-t - mid]_+ equals
    max(|t| - |mid|, 0), plus 2 |mid| when mid < 0, so per (b, o, i) and
    step each of u = x + w and v = x - w costs its add, the subtraction
    of |mid| from |t|, the max with 0 and the accumulating add (8 for
    both; abs is an operand modifier). Before the steps, the max pass
    (u, v and a max of each |.|: 4). Per (b, o) and step, for each branch
    the mid (add, mul), |mid|, the compare with 0, 2 d |mid| and its add,
    the compare with gamma and two selects (16 for both); then the two
    final mids and their difference (5). About 212 per (b, o, i)."""
    return B * O * (d * (4 + 8 * iters) + 16 * iters + 5)


def ops_mp_linear_reference(B: int, d: int, O: int, iters: int = 26) -> int:
    """A side figure, not the bound: f32 ops of the reference's algorithm
    as its Pallas body (and this port's kernel) runs it: per (b, o, i) the
    max pass (6) and per step u, v and per branch two hinges (sub, max)
    and two adds (14); per (b, o) and step the two mids (add, mul), two
    compares and four selects (10); the final 5. About 370 per (b, o, i)."""
    return B * O * (d * (6 + 14 * iters) + 10 * iters + 5)


def ops_waterfill(R: int, m: int, iters: int = 26) -> int:
    """f32 ops of mp_waterfill on (R, m): the max (1 per element), per step
    a sub, max and add per element and mid (add, mul), compare and select
    per row; then the row's start (sub) and final mid (add, mul)."""
    return R * (m * (1 + 3 * iters) + 5 * iters + 3)


def bound_ms(ops: float, nbytes: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_ops, t_bytes = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# -- phases ------------------------------------------------------------------


def ptxas_report(text: str) -> dict:
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` output."""
    out, entry, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)), *spills)
    return out


def short_entry(name: str) -> str:
    """A readable name for a kernel instantiation's mangled symbol, e.g.
    mp_linear<bf16,BB=2,TO=8,res> (mp_linear_levels<...> with LEVELS),
    mp_linear_grads<bf16>, fir_mp_stream<16,6> or mp_waterfill_rows<32,1>
    (elements per lane, lanes per row); others are shortened."""
    m = re.search(r"mp_linear_kernelI([tf])Li(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                  name)
    if m:
        wt = "bf16" if m.group(1) == "t" else "f32"
        res = "res" if m.group(4) == "1" else "global"
        kind = "mp_linear_levels" if m.group(5) == "1" else "mp_linear"
        return f"{kind}<{wt},BB={m.group(2)},TO={m.group(3)},{res}>"
    m = re.search(r"mp_linear_grads_kernelI([tf])E", name)
    if m:
        return f"mp_linear_grads<{'bf16' if m.group(1) == 't' else 'f32'}>"
    if "mp_linear_dx_sum_kernel" in name:
        return "mp_linear_dx_sum"
    m = re.search(r"(fir_mp_stream(?:_q)?|fir_mp_oneshot(?:_q)?|"
                  r"mp_waterfill_rows)_kernelILi(\d+)ELi(\d+)E", name)
    if m:
        return f"{m.group(1)}<{m.group(2)},{m.group(3)}>"
    return name.replace("_ZN12_GLOBAL__N_1", "")[:48]


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"build: {secs:.2f} s for {list(_build.SOURCES)}")
    for name in _build.SOURCES:
        rep = ptxas_report(_build.build_log(name))
        if rep:
            log({"ptxas": name, "registers_spill_st_ld":
                 {short_entry(k): v for k, v in rep.items()}})
    for name in ("fir_mp_stream", "fir_mp_stream_q"):
        for entry, census in sass_census(_build.lib_path(name),
                                         solve_census).items():
            log({"sass_solve_step": entry, **census})
    for entry, census in sass_census(_build.lib_path("fir_mp_bank"),
                                     bisect_census).items():
        log({"sass_bisect_step": entry, **census})
    for entry, census in sass_census(_build.lib_path("fir_mp_bank_q"),
                                     int_dot_census).items():
        log({"sass_int_dot_step": entry, **census})
    return secs


def inner_loops(lines: list) -> list:
    """The opcodes of each innermost loop (a branch back to an earlier
    address that holds no other such loop) of one function's SASS."""
    ops, at, loops = [], {}, []
    for line in lines:
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if not m:
            continue
        at[int(m.group(1), 16)] = len(ops)
        ops.append(m.group(3).split(".")[0])
        t = re.search(r"\bBRA\s+(0x[0-9a-f]+)", line)
        if t and int(t.group(1), 16) in at:
            loops.append((at[int(t.group(1), 16)], len(ops)))
    return [ops[a:b] for a, b in loops
            if not any(a <= c and e <= b and (c, e) != (a, b)
                       for c, e in loops)]


def loop_census(lines: list) -> dict:
    """The hot loop of one function's SASS: of the innermost loops that
    hold an FMNMX, the one with the most FADDs. Its opcode counts and, per
    (b, o, i) -- each has one FMNMX per branch -- its FP32 and all
    instructions."""
    bodies = [b for b in inner_loops(lines) if "FMNMX" in b]
    if not bodies:
        return {"loop": None}
    body = max(bodies, key=lambda o: o.count("FADD"))
    fp = sum(o in ("FADD", "FMUL", "FFMA", "FMNMX") for o in body)
    per = body.count("FMNMX") / 2
    return {"loop_instructions": len(body),
            "opcodes": {o: body.count(o) for o in sorted(set(body))},
            "fp32_per_boi": fp / per, "all_per_boi": len(body) / per}


def sass_census(lib: Path, census=loop_census) -> dict:
    """``census`` (``loop_census`` by default) of every function in a
    built library, by ``short_entry`` name, from ``cuobjdump -sass``."""
    from repro_torch.kernels._build import nvcc_path
    tool = Path(nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, name, lines = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out[short_entry(name)] = census(lines)
            name, lines = m.group(1), []
        else:
            lines.append(line)
    return out


def solve_census(lines: list, lanes: int = 16) -> dict:
    """The band-pass solve step of a stream kernel's SASS: of the
    innermost loops, the float Newton iteration (the loop with MUFU, the
    divide's reciprocal, and the most FADDs: its fast path counted, the
    slow-path subroutine not) or, without one, the integer bisection step
    (the loop with the most VIMNMX). Its opcodes, all and FP32 (FADD,
    FMUL, FFMA, FMNMX) or INT instructions per iteration, and per operand
    lane (``lanes``, the 16 band-pass taps)."""
    bodies = inner_loops(lines)
    newton = [b for b in bodies if "MUFU" in b]
    if newton:
        body = max(newton, key=lambda o: o.count("FADD"))
        kind = "newton"
        sel = sum(o in ("FADD", "FMUL", "FFMA", "FMNMX") for o in body)
    else:
        ints = [b for b in bodies if "VIMNMX" in b or "IMNMX" in b]
        if not ints:
            return {"loop": None}
        body = max(ints, key=lambda o: o.count("VIMNMX") + o.count("IMNMX"))
        kind = "bisect_int"
        sel = sum(o not in ("BRA", "BSSY", "BSYNC", "LDS", "STS", "LDG",
                            "STG") and not o.startswith("F") for o in body)
    return {"loop": kind, "instructions": len(body),
            "fp32" if kind == "newton" else "int": sel,
            "per_lane": len(body) / lanes,
            ("fp32" if kind == "newton" else "int") + "_per_lane":
                sel / lanes,
            "opcodes": {o: body.count(o) for o in sorted(set(body))}}


def bisect_census(lines: list) -> dict:
    """The bisection steps of the one-shot bank kernel's SASS: each
    innermost loop that holds an FMNMX (one per window width: two FMNMX per
    operand lane and branch, so lanes = FMNMX / 4), its instructions, FP32
    ones (FADD, FMUL, FFMA, FMNMX) and both per lane, and its opcodes."""
    steps = []
    for body in inner_loops(lines):
        if "FMNMX" not in body:
            continue
        lanes = body.count("FMNMX") / 4
        fp = sum(o in ("FADD", "FMUL", "FFMA", "FMNMX") for o in body)
        steps.append(dict(lanes=lanes, instructions=len(body), fp32=fp,
                          per_lane=len(body) / lanes,
                          opcodes={o: body.count(o)
                                   for o in sorted(set(body))}))
    return {"steps": steps}


def int_dot_census(lines: list) -> dict:
    """The bisection steps of the int one-shot kernel's SASS: each
    innermost loop that holds a VIMNMX (one per window width; both
    branches of a dot step in it, one max per operand lane and branch, so
    lanes = VIMNMX / 2), its instructions, their half (one branch's step)
    and the step that ``ops_int_dot_min`` counts at those lanes (M +
    ceil(M / 2) + 7), and its opcodes."""
    steps = []
    for body in inner_loops(lines):
        if "VIMNMX" not in body:
            continue
        lanes = body.count("VIMNMX") // 2
        steps.append(dict(lanes=lanes, instructions=len(body),
                          per_branch_step=len(body) / 2,
                          counted_step=lanes + -(-lanes // 2) + 7,
                          opcodes={o: body.count(o)
                                   for o in sorted(set(body))}))
    return {"steps": steps}


def is_stream_kernel(name: str, numerics: str) -> bool:
    """Whether a profiled kernel name is the float or the int stream
    kernel (every kernel built from csrc/fir_mp_stream*.cu)."""
    if numerics == "fixed":
        return "fir_mp_stream_q" in name
    return "fir_mp_stream" in name and "fir_mp_stream_q" not in name


def is_oneshot_kernel(name: str) -> bool:
    """Whether a profiled kernel is the float one-shot bank kernel
    (csrc/fir_mp_bank.cu: the cascade and the one-stage entries)."""
    return "fir_mp_oneshot_kernel" in name


def is_bank_q_kernel(name: str) -> bool:
    """Whether a profiled kernel is the int one-shot kernel (the cascade
    and its one-stage entry; before the cascade, fir_mp_bank_q_kernel)."""
    return "fir_mp_oneshot_q" in name or "fir_mp_bank_q" in name


def device_us(fn, mine, reps: int = 10, tries: int = 3) -> dict:
    """Device time of ``fn()`` under torch.profiler, per call: the launches
    of the kernel that ``mine(name)`` picks, in order, their total, every
    kernel's total, and how many kernels each call launched. The launches
    a call makes are counted by the wrappers (``LAUNCHES``); a profile
    that lost a launch's record is taken again, up to ``tries`` times,
    after which a call of one launch is timed by the records that came
    (some profiles of one-launch calls came back a record short). Where
    no profile traced anything on the device (torch.profiler has been seen
    to return no device records at all), every device time is None and the
    call's CUDA-event time (launch gaps included) stands apart as
    ``events_us``; ``timed_by`` says which (``device_fields``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES
    before = sum(LAUNCHES.values())
    fn()
    torch.cuda.synchronize()
    per = sum(LAUNCHES.values()) - before
    traced = False
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        traced = traced or bool(evs)
        picked = [e for e in evs if mine(e.name)]
        if per > 0 and len(picked) == per * reps:
            break
    else:
        if per > 0 and not traced:
            log(f"device_us: the profiler traced nothing on the device in "
                f"{tries} tries; device time not measured, CUDA events "
                f"apart")
            return dict(launch_us=None, kernel_us=None, all_us=None,
                        kernels_per_call=None,
                        events_us=cuda_ms(fn, reps) * 1e3,
                        timed_by="cuda_events")
        if not (per == 1 and len(picked) >= reps // 2):
            raise AssertionError(
                f"profiled {len(picked)} kernel launches in {reps} calls "
                f"of {per} launches each: "
                f"{sorted({e.name[:60] for e in evs})}")
    calls = len(picked) // per      # the calls whose records all came
    us = [0.0] * per
    for i, e in enumerate(picked):
        us[i % per] += e.time_range.elapsed_us() / calls
    return dict(launch_us=us, kernel_us=sum(us),
                all_us=sum(e.time_range.elapsed_us() for e in evs) / calls,
                kernels_per_call=len(evs) / calls, events_us=None,
                timed_by="profiler")


def device_fields(prof: dict, b_ms: float | None = None) -> dict:
    """A row's device time from ``device_us``'s result: ``device_ms`` (the
    picked kernel's launches) and, given the bound, ``x_bound`` from it.
    Where the profiler traced nothing both are None, and the CUDA-event
    time is ``events_ms``; ``device_timed_by`` says which."""
    us = prof["kernel_us"]
    ev = prof["events_us"]
    out = dict(device_ms=None if us is None else us * 1e-3,
               events_ms=None if ev is None else ev * 1e-3,
               device_timed_by=prof["timed_by"])
    if b_ms is not None:
        out["x_bound"] = (None if us is None else out["device_ms"] / b_ms)
    return out


def profiled(fn, reps: int = 10) -> dict:
    """``fn()`` ``reps`` times under torch.profiler: per call the wall ms
    (host clock, synchronized), the device's busy us (every kernel's and
    copy's own time) and busy share, the device kernels, and the six
    largest device-time names (us per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kern = sorted(((getattr(e, "self_device_time_total", 0.0), e.key)
                   for e in dev), reverse=True)
    busy_us = sum(t for t, _ in kern)
    return dict(wall_ms=wall / reps * 1e3, busy_us=busy_us / reps,
                busy_share=(busy_us * 1e-6 / wall) if busy_us else None,
                kernels=sum(e.count for e in dev) / reps,
                by_name_us={k: t / reps for t, k in kern},
                top_us=[[k[:60], t / reps] for t, k in kern[:6]])


def octave_chain(octave, chunk, n, delays, consumed, acc, amax, steps):
    """The served cascade octave by octave through a one-octave entry
    (``octave``, with ``steps[o]`` its keyword arguments at octave o and
    ``steps[o]["F"]`` its accumulator columns): one launch per octave, as
    the serve path ran it before the cascade kernel."""
    import torch
    x_o, n_o, col = chunk, n, 0
    for o, kw in enumerate(steps):
        kw = dict(kw)
        F = kw.pop("F")
        start = consumed[o] & 1
        _, _, _, y = octave(x_o, n_o, start, delays[o],
                            acc[:, col:col + F].contiguous(),
                            amax if o == 0 else torch.zeros_like(amax), **kw)
        col += F
        if y is not None:
            x_o = y[:, :(x_o.shape[1] + 1) // 2].contiguous()
            n_o = torch.clamp_min(n_o - start + 1, 0) >> 1
    return None


def float_steps(fb):
    """``octave_chain``'s per-octave keywords for the float bank."""
    import torch
    c = fb.config
    O = c.num_octaves
    return [dict(F=c.filters_per_octave, H=fb.bp_by_octave[o],
                 lp=(fb.lp_filters[o] if o < O - 1 else
                     torch.zeros(1, device=fb.bp_by_octave[o].device)),
                 gamma=c.gamma_f, scale=2.0 ** o, solver=c.solver,
                 emit_next=o < O - 1, update_amax=o == 0)
            for o in range(O)]


def fixed_steps(prog):
    """``octave_chain``'s per-octave keywords for the fixed program."""
    st = prog.bank.octaves
    return [dict(F=s.bp_q.shape[0], stage=s,
                 next_spec=st[o + 1].in_spec if s.lp_q is not None else None,
                 emit_next=s.lp_q is not None, update_amax=o == 0)
            for o, s in enumerate(st)]


def cascade_case(kind: str, S: int, L: int, octaves: int, P: int, T1: int,
                 gen, clips=None, codes=None):
    """Inputs (chunk, n, delays, consumed, acc, amax) on the CPU for one
    cascade check. ``served``: a served wave, n = 160 of an L = 256 bucket
    for every slot, the seeded clips' samples (``codes`` turns floats
    into ADC codes), fresh registers. ``mixed``: valid counts 0, full, odd
    and random, random registers (int codes within ``codes``'s range when
    given as (lo, hi)) and consumed counters of both parities."""
    import torch
    if kind == "served":
        n = torch.full((S,), 160, dtype=torch.int32)
        chunk = torch.zeros(S, L)
        chunk[:, :160] = torch.from_numpy(clips[:S, :160].copy())
        regs = dict(dtype=torch.float32) if codes is None else dict(
            dtype=torch.int32)
        delays = tuple(torch.zeros(S, T1, **regs) for _ in range(octaves))
        consumed = tuple(torch.zeros(S, dtype=torch.int32)
                         for _ in range(octaves))
        acc, amax = torch.zeros(S, P, **regs), torch.zeros(S, **regs)
        if codes is not None:
            chunk = codes(chunk)
        return chunk, n, delays, consumed, acc, amax
    n = torch.randint(0, L + 1, (S,), generator=gen, dtype=torch.int32)
    n[:8] = 0
    n[8:16] = L
    n[16:24] = torch.arange(8, dtype=torch.int32) * 2 % L + 1   # odd
    consumed = tuple(torch.randint(0, 1 << 20, (S,), generator=gen,
                                   dtype=torch.int32) for _ in range(octaves))
    if codes is None:
        chunk = torch.randn(S, L, generator=gen)
        delays = tuple(torch.randn(S, T1, generator=gen)
                       for _ in range(octaves))
        acc, amax = torch.rand(S, P, generator=gen), torch.rand(S, generator=gen)
    else:
        lo, hi = codes
        i32 = dict(generator=gen, dtype=torch.int32)
        chunk = torch.randint(lo, hi + 1, (S, L), **i32)
        delays = tuple(torch.randint(lo, hi + 1, (S, T1), **i32)
                       for _ in range(octaves))
        acc = torch.randint(0, 1 << 22, (S, P), **i32)
        amax = torch.randint(0, 128, (S,), **i32)
    chunk = torch.where(torch.arange(L)[None] < n[:, None], chunk,
                        torch.zeros((), dtype=chunk.dtype))
    return chunk, n, delays, consumed, acc, amax


def advanced(case, out, clips, codes=None):
    """The served case one wave later: the registers ``out`` of the first
    wave, consumed counters advanced by the slot index (odd phases at
    every octave for odd slots), the clips' next 160 samples."""
    import torch
    chunk, n, _, _, _, _ = case
    S = chunk.shape[0]
    delays, consumed, acc, amax = out
    step = torch.arange(S, dtype=torch.int32, device=consumed[0].device)
    nxt = torch.zeros(chunk.shape)
    nxt[:, :160] = torch.from_numpy(clips[:S, 160:320].copy())
    if codes is not None:
        nxt = codes(nxt)
    return (nxt.to(chunk.device), n, delays,
            tuple(c + step for c in consumed), acc, amax)


def check_cascade(got, want, case, what: str, exact_ints: bool) -> float:
    """Every output of a cascade kernel against its plain version: each
    delay line, acc and amax within KERNEL_TOL * (1 + max |plain|) (float)
    or exactly (int), every consumed counter exactly; the registers of the
    n == 0 slots bit for bit. Returns the max |diff| (0 for int)."""
    import torch
    err = 0.0
    pairs = ([(f"delays[{o}]", g, w) for o, (g, w) in
              enumerate(zip(got[0], want[0]))]
             + [("acc", got[2], want[2]), ("amax", got[3], want[3])])
    for name, g, w in pairs:
        if exact_ints:
            exact(g, w, f"{what} {name}")
            continue
        d, tol = max_err(g, w)
        if not d <= tol:
            raise AssertionError(f"{what} {name}: max |diff| {d} > {tol}")
        err = max(err, d)
    for o, (g, w) in enumerate(zip(got[1], want[1])):
        exact(g, w, f"{what} consumed[{o}]")
    inert = case[1] == 0
    if not (torch.equal(got[2][inert], case[4][inert]) and all(
            torch.equal(g[inert], d[inert])
            for g, d in zip(got[0], case[2]))):
        raise AssertionError(f"{what}: an n == 0 slot moved")
    return err


def cascade_solve_ops(fb, case) -> tuple[int, int]:
    """f32 ops the float cascade needs on ``case`` (L <= 512: one block per
    octave), Newton solver: every valid band-pass (position, filter) and
    every kept low-pass position solves mpabs(w + x) and mpabs(w - x) and
    takes their difference; the solves counted by ``ops_newton_steps`` on
    the windows the plain cascade sees. Returns (these ops, the
    reference's form's)."""
    import torch
    from repro_torch.kernels import ref
    c = fb.config
    if c.solver != "newton":
        raise ValueError("the served bank solves by Newton")
    chunk, n, delays, consumed, acc, amax = case
    O, F = c.num_octaves, c.filters_per_octave
    M, M_lp, T1 = c.bp_taps, c.lp_taps, delays[0].shape[1]
    dev = chunk.device
    ops = ops_ref = 0

    def solve(w, taps, count):
        nonlocal ops, ops_ref
        t = taps.flip(-1)
        u = torch.cat([t + w, t - w])
        k, k_ref = ops_newton_steps(u, c.gamma_f)
        ops, ops_ref = ops + k + count, ops_ref + k_ref + count

    x_o, n_o = chunk, n.long()
    for o in range(O):
        L_o = x_o.shape[1]
        if L_o > 512:
            raise ValueError("cascade_solve_ops counts one block per octave")
        start = (consumed[o] & 1).long()
        buf = torch.cat([delays[o][:, T1 - (M - 1):], x_o], 1)
        valid = torch.arange(L_o, device=dev)[None] < n_o[:, None]
        w = buf.unfold(1, M, 1)[:, :L_o][valid]               # (N, M)
        solve(w[:, None, :], fb.bp_by_octave[o][None], w.shape[0] * F)
        if o == O - 1:
            break
        n_next = torch.clamp_min(n_o - start + 1, 0) >> 1
        J = int(n_next.max())
        bufl = torch.cat([delays[o][:, T1 - (M_lp - 1):], x_o], 1)
        idx = (start[:, None, None] + 2 * torch.arange(J, device=dev)[:, None]
               + torch.arange(M_lp, device=dev))
        keep = torch.arange(J, device=dev)[None] < n_next[:, None]
        wl = bufl[torch.arange(bufl.shape[0], device=dev)[:, None, None],
                  idx.clamp_max(bufl.shape[1] - 1)][keep]      # (K, M_lp)
        solve(wl, fb.lp_filters[o], wl.shape[0])
        _, _, _, y = ref.fir_mp_stream_octave(
            x_o, n_o.int(), start.int(), delays[o], acc[:, :F].contiguous(),
            amax, fb.bp_by_octave[o], fb.lp_filters[o], c.gamma_f,
            solver=c.solver)
        x_o, n_o = y[:, :(L_o + 1) // 2], n_next
    return ops, ops_ref


def served_counts(n, consumed) -> list:
    """(valid count, kept low-pass count) per octave of a cascade on these
    inputs: each octave's phase is consumed & 1 and the next valid count
    max(n - phase + 1, 0) >> 1 (the last octave keeps none)."""
    import torch
    out, n_o = [], n.long().cpu()
    for o, c in enumerate(consumed):
        nxt = torch.clamp_min(n_o - (c.long().cpu() & 1) + 1, 0) >> 1
        out.append((n_o, nxt if o < len(consumed) - 1 else n_o * 0))
        n_o = nxt
    return out


def cascade_bytes(S: int, L: int, octaves: int, P: int, T1: int,
                  taps: int) -> int:
    """Bytes a cascade must move: the chunk and n read once; each octave's
    delay line and consumed counter read and written; acc and amax read
    and written; the taps (or tap codes) read once."""
    return 4 * (S * L + S + octaves * (2 * S * T1 + 2 * S) + 2 * S * P
                + 2 * S + taps)


def host_split(whole, parts: dict, reps: int = 200) -> dict:
    """Host microseconds per call, by the host clock over ``reps`` calls,
    of each part of a cascade wrapper (``parts``: name -> that part called
    on the inputs the wrapper got) and of the whole wrapper (``whole``);
    ``rest`` is the whole less its parts (routing, the launch count, the
    result tuples). Launches are queued, not waited for: at these sizes
    the host is the slower side."""
    import torch
    out = {}
    for name, fn in list(parts.items()) + [("whole", whole)]:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    out["rest"] = out["whole"] - sum(out[k] for k in parts)
    return out


def plan_us(args: tuple, kw: dict, reps: int = 2000) -> dict:
    """Host microseconds of one ``stream_plan`` call, cached (as the
    wrappers call it) and computed afresh."""
    from repro_torch.kernels.fir_mp import stream_plan
    out = {}
    for name, fn in (("plan_cached", stream_plan),
                     ("plan_uncached", stream_plan.__wrapped__)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args, **kw)
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    return out


def phase_stream_kernel(fb, gen, clips):
    """The float stream kernel against its plain versions: the one-octave
    entry at the serve path's six octave shapes (S = 256 slots, L = 256
    then 128, ..., 8; valid counts mixed, 0 and odd included, random
    phases), then the cascade (one launch for all six octaves) on a
    served wave (n = 160 of 256 for every slot, fresh and one wave later
    with odd phases) and on mixed valid counts at L = 700 (two blocks at
    octave 0); then the cascade's times, bound and host split."""
    import torch
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    fm = importlib.import_module("repro_torch.kernels.fir_mp")
    from repro_torch.kernels.fir_mp import (fir_mp_stream_cascade,
                                            fir_mp_stream_octave,
                                            stream_plan)
    dev = torch.device("cuda")
    reset_launches()
    c = fb.config
    S, L, T1 = 256, 256, max(c.bp_taps, c.lp_taps) - 1
    F, O = c.filters_per_octave, c.num_octaves
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for o in range(O):
        Lo = -(-L // 2 ** o)
        n = torch.randint(0, Lo + 1, (S,), generator=gen, dtype=torch.int32)
        n[:8] = 0
        n[8:16] = Lo
        n[16:24] = torch.arange(8, dtype=torch.int32) * 2 % Lo + 1  # odd
        x = torch.randn(S, Lo, generator=gen)
        if o == 0:   # the main path zeroes invalid tails of the chunk
            x = torch.where(torch.arange(Lo)[None] < n[:, None], x, 0.0)
        emit = o < O - 1
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
    octave_entry = dict(shapes=f"S={S} L={L}..{Lo}", ms=ms, plain_ms=plain_ms,
                        max_abs_err=err,
                        launches_here=LAUNCHES["fir_mp_stream_octave"])

    # the cascade: one launch per wave
    taps = (fb.bp_by_octave, fb.lp_filters, c.gamma_f)
    kw = dict(solver=c.solver)

    def on_dev(case):
        chunk, n, delays, consumed, acc, amax = case
        return (chunk.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
                tuple(t.to(dev) for t in consumed), acc.to(dev), amax.to(dev))

    served = on_dev(cascade_case("served", S, L, O, O * F, T1, gen, clips))
    cases = {"served": served}
    cases["served, one wave later"] = on_dev(advanced(
        served, ref.fir_mp_stream(*served, *taps, **kw), clips))
    cases["mixed, L = 700"] = on_dev(cascade_case("mixed", S, 700, O, O * F,
                                                  T1, gen))
    reset_launches()
    for name, case in cases.items():
        for upd in (True, False):
            k = dict(kw, update_amax=upd)
            err = max(err, check_cascade(
                fir_mp_stream_cascade(*case, *taps, **k),
                ref.fir_mp_stream(*case, *taps, **k), case,
                f"fir_mp_stream_cascade ({name}, update_amax={upd})", False))
    launches_here = LAUNCHES["fir_mp_stream_cascade"]
    run = lambda: fir_mp_stream_cascade(*served, *taps, **kw)  # noqa: E731
    prof = device_us(run, lambda k: is_stream_kernel(k, "float"))
    counts = served_counts(served[1], served[3])
    ops, ops_ref = cascade_solve_ops(fb, served)
    nb = cascade_bytes(S, L, O, O * F, T1,
                       O * F * c.bp_taps + (O - 1) * c.lp_taps)
    b_ms, b_by = bound_ms(ops, nb)
    k_ms = cuda_ms(run, 50)
    chain = device_us(lambda: octave_chain(fir_mp_stream_octave, *served,
                                           float_steps(fb)),
                      lambda k: is_stream_kernel(k, "float"))
    plan_args = (L, F, c.bp_taps, c.lp_taps, T1)
    plan = stream_plan(*plan_args, octaves=O)
    # the wrapper's host work, part by part, on the served wave
    chunk, n, delays, consumed, acc, amax = served
    bps, lps = fb.bp_by_octave[:O], list(fb.lp_filters[:O - 1])
    _, ins = fm._cascade_inputs(chunk, n, delays, consumed, acc, amax, bps,
                                lps)
    outs = fm._cascade_outputs(plan, acc, amax, O, T1=T1)
    rows = fm.stream_octave_rows(ins[2], outs[0], ins[3], outs[1], ins[6],
                                 ins[7] + [None])
    host = host_split(run, {
        "inputs": lambda: fm._cascade_inputs(chunk, n, delays, consumed, acc,
                                             amax, bps, lps),
        "outputs": lambda: fm._cascade_outputs(plan, acc, amax, O, T1=T1),
        "rows": lambda: fm.stream_octave_rows(ins[2], outs[0], ins[3],
                                              outs[1], ins[6],
                                              ins[7] + [None]),
        "launch": lambda: fm._stream_launch(
            ins[0], ins[1], ins[4], ins[5], outs[2], outs[3], outs[4], *rows,
            L=L, P=O * F, ystride=plan["scratch"], M=c.bp_taps,
            M_lp=c.lp_taps, T1=T1, gamma=c.gamma_f, solver=c.solver,
            update_amax=True, cascade=True, plan=plan)})
    host.update(plan_us(plan_args, dict(octaves=O)))
    row = dict(name="fir_mp_stream_cascade",
               shapes=f"S={S} L={L} n=160, {O} octaves (a served wave)",
               max_abs_err=err, ms=k_ms, **device_fields(prof, b_ms),
               plain_ms=cuda_ms(lambda: ref.fir_mp_stream(*served, *taps,
                                                          **kw), 3),
               bound_ms=b_ms, bound_by=b_by, x_bound_events=k_ms / b_ms,
               bound_ms_reference_algorithm=bound_ms(ops_ref, nb)[0],
               threads=plan["threads"], smem_bytes=plan["smem_bytes"],
               valid_per_octave=[int(nv[0]) for nv, _ in counts],
               launches_here=launches_here, host_us=host,
               one_octave_entry=octave_entry,
               one_octave_chain_device_us=chain["launch_us"])
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
    launches_here = dict(LAUNCHES)
    # device time per launch of the route before the cascade: per octave
    # the band-pass sums, then the low-pass at every position
    chain = device_us(lambda: one_stage_chain(fb, x), is_oneshot_kernel)
    lu = chain["launch_us"]      # None: the profiler traced nothing
    per_octave = {"fir_mp_bank": lu and lu[0::2], "fir_mp": lu and lu[1::2]}
    # without a profile the events time the whole chain, both kernels
    ev = chain["events_us"]
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("ops"), r.pop("nbytes"))
        r["shapes"] = f"B={B} N={N}..{x_o.shape[1]}"
        r["launches_here"] = launches_here[r["name"]]
        r["device_ms"] = (sum(per_octave[r["name"]]) * 1e-3 if lu
                          else None)
        r["device_timed_by"] = chain["timed_by"]
        r["chain_events_ms"] = None if ev is None else ev * 1e-3
        r["per_octave_device_us"] = per_octave[r["name"]]
        log({"kernel_vs_plain": r})
    return rows


def one_stage_chain(fb, x):
    """One float apply's bank through the one-stage entries, as the main
    path ran it before the cascade kernel: per octave the band-pass sums
    (x 2^o) and the low-pass at every position, its even ones kept."""
    import torch
    from repro_torch.kernels.fir_mp import fir_mp_bank_kernel, fir_mp_kernel
    c = fb.config
    parts, x_o = [], x
    for o in range(c.num_octaves):
        parts.append(fir_mp_bank_kernel(x_o, fb.bp_by_octave[o], c.gamma_f,
                                        accumulate=True) * (2.0 ** o))
        if o < c.num_octaves - 1:
            x_o = fir_mp_kernel(x_o, fb.lp_filters[o], c.gamma_f)[:, ::2]
    return torch.cat(parts, dim=-1)


def oneshot_ops(c, B: int, N: int, kept_only: bool = True):
    """(f32 ops, bytes) the one-shot cascade needs on x (B, N): every
    band-pass (position, filter) of every octave and each low-pass at its
    kept positions (at all of them unless ``kept_only``: the reference's
    count), each solve two bisections (``ops_bisect``) and their
    difference; x read once, the taps, s (B, P) written once."""
    F, O = c.filters_per_octave, c.num_octaves
    ops, N_o = 0, N
    for o in range(O):
        ops += B * N_o * F * (2 * ops_bisect(c.bp_taps) + 1)
        if o < O - 1:
            kept = (N_o + 1) // 2
            ops += (B * (kept if kept_only else N_o)
                    * (2 * ops_bisect(c.lp_taps) + 1))
            N_o = kept
    nbytes = 4 * (B * N + O * F * c.bp_taps + (O - 1) * c.lp_taps + B * O * F)
    return ops, nbytes


def phase_oneshot_cascade(fb, x):
    """The one-shot cascade kernel (the whole multirate bank of one apply
    in one launch) against its plain version, bit for bit: on the clips
    (B = 8, N = 16000) and on odd lengths; its times (CUDA events; device
    time by torch.profiler), its bound (low-pass at the kept positions; at every position beside), the
    grid and the work items."""
    import torch
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels._build import load
    from repro_torch.kernels.fir_mp import (fir_mp_oneshot_cascade,
                                            oneshot_plan)
    c = fb.config
    taps = (fb.bp_by_octave, fb.lp_filters, c.gamma_f)
    g = torch.Generator().manual_seed(2)
    cases = {"clips": x}
    for shape in ((1, 5), (3, 301), (5, 1027)):
        cases[f"random {shape}"] = torch.randn(*shape, generator=g).to(
            x.device)
    reset_launches()
    for name, xc in cases.items():
        want = ref.fir_mp_oneshot_cascade(xc, *taps)
        got = fir_mp_oneshot_cascade(xc, *taps)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"fir_mp_oneshot_cascade ({name}) is not bit for bit its "
                f"plain version: max |diff| "
                f"{float((got - want).abs().max())}")
    launches_here = LAUNCHES["fir_mp_oneshot_cascade"]
    B, N = x.shape
    run = lambda: fir_mp_oneshot_cascade(x, *taps)  # noqa: E731
    prof = device_us(run, is_oneshot_kernel)
    ops, nb = oneshot_ops(c, B, N)
    b_ms, b_by = bound_ms(ops, nb)
    plan = oneshot_plan(B, N, c.filters_per_octave, octaves=c.num_octaves)
    row = dict(name="fir_mp_oneshot_cascade",
               shapes=f"B={B} N={N}, {c.num_octaves} octaves",
               max_abs_err=0.0, ms=cuda_ms(run, 20),
               **device_fields(prof, b_ms),
               plain_ms=cuda_ms(lambda: ref.fir_mp_oneshot_cascade(x, *taps),
                                2),
               bound_ms=b_ms, bound_by=b_by,
               bound_ms_all_positions=bound_ms(
                   oneshot_ops(c, B, N, kept_only=False)[0], nb)[0],
               device_kernels_per_call=prof["kernels_per_call"],
               grid=load("fir_mp_oneshot_ctas")(0), items=plan["items"],
               launches_here=launches_here)
    log({"kernel_vs_plain": row})
    return row


SERVE_MAX_CHUNK = 512      # the ladder's top bucket: a 300-sample packet
CHURN = {5: [("open", "v1")], 20: [("close", "v1")], 30: [("open", "v2")]}


def serve_schedule(audio, rounds: int, packet: int) -> list:
    """The waves phases 4 and 7 serve, one per round: ``[(lifecycle ops
    before the wave, requests), ...]``. Rows 0..S-2 are the regular
    sessions s000.., one packet each per round; row 0 gets 300 samples in
    round 10 and 20 in round 11 (a bucket change, 256 -> 512 -> 256, and
    still every regular stream's first rounds x packet samples in order).
    The last slot churns between replays: visitor v1 (row S-1 from its
    first sample) opens before round 5 and closes before round 20; v2 (row
    S-1 from its first sample again, on cleared registers) opens before
    round 30."""
    S = audio.shape[0]
    pos = [0] * S
    sched = []
    for r in range(rounds):
        ops = CHURN.get(r, [])
        if ("open", "v2") in ops:
            pos[S - 1] = 0
        reqs = []
        for i in range(S - 1):
            n = {(0, 10): 300, (0, 11): 20}.get((i, r), packet)
            reqs.append((f"s{i:03d}", audio[i, pos[i]:pos[i] + n]))
            pos[i] += n
        vis = "v1" if 5 <= r < 20 else "v2" if r >= 30 else None
        if vis:
            reqs.append((vis, audio[S - 1, pos[S - 1]:pos[S - 1] + packet]))
            pos[S - 1] += packet
        sched.append((ops, reqs))
    return sched


def slot_of(sid: str, S: int) -> int:
    """The slot ``serve`` gives a session of ``serve_schedule``."""
    return S - 1 if sid.startswith("v") else int(sid[1:])


def serve(pipe, sched, S: int):
    """Serve ``sched`` through a fresh StreamServer of S slots (on the card:
    one captured graph per bucket, one replay per wave). Returns (server,
    per-round results, per-round feed() seconds)."""
    import torch
    from repro_torch.serving import StreamServer
    server = StreamServer(pipe, capacity=S, max_chunk=SERVE_MAX_CHUNK)
    for i in range(S - 1):
        server.open(f"s{i:03d}")
    secs, results = [], []
    for ops, reqs in sched:
        for op, sid in ops:
            getattr(server, op)(sid)
            if op == "open" and server.session(sid).slot != slot_of(sid, S):
                raise AssertionError(f"{sid} opened in slot "
                                     f"{server.session(sid).slot}")
        t0 = time.perf_counter()
        res = server.feed(reqs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        results.append(res)
    for fr in (fr for res in results for fr in res):
        if not (math.isfinite(fr.confidence) and -1 <= fr.confidence <= 1):
            raise AssertionError(f"bad decision {fr}")
    return server, results, secs


def serve_eager(pipe, sched, S: int):
    """The same waves through ``pipe._session_step`` run eagerly, op by op,
    on one state of S slots (the lifecycle ops as the server makes them):
    returns (final state, per-round p on the host)."""
    import numpy as np
    import torch
    from repro_torch.core import pipeline as pl
    from repro_torch.serving import bucket_length
    state = pipe.init_session(S, active=np.zeros(S, bool))
    pl.set_active(state, list(range(S - 1)), True)
    ps = []
    for ops, reqs in sched:
        for op, _ in ops:
            if op == "open":
                pl.clear_slots(state, [S - 1])
            pl.set_active(state, [S - 1], op == "open")
        L = bucket_length(max(len(c) for _, c in reqs), 16, SERVE_MAX_CHUNK)
        chunk = np.zeros((S, L), np.float32)
        valid = np.zeros(S, np.int32)
        for sid, c in reqs:
            chunk[slot_of(sid, S), :len(c)] = c
            valid[slot_of(sid, S)] = len(c)
        state, p, _ = pipe._session_step(state,
                                         torch.from_numpy(chunk).cuda(),
                                         torch.from_numpy(valid).cuda())
        ps.append(p.cpu())
    return state, ps


def check_captured_vs_eager(server, results, state, ps, what: str) -> None:
    """Gate: every served decision is the eager step's on its wave (label
    and confidence, bit for bit), and every register of the server's state
    equals the eager state's bit for bit."""
    import torch
    S = server.capacity
    for r, (res, p) in enumerate(zip(results, ps)):
        for fr in res:
            row = p[slot_of(fr.session_id, S)]
            label = int(torch.argmax(row))
            if (fr.label, fr.confidence) != (label, float(row[label])):
                raise AssertionError(
                    f"{what}: round {r} {fr.session_id}: captured "
                    f"{(fr.label, fr.confidence)} != eager "
                    f"{(label, float(row[label]))}")
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(server.state.tensors(), state.tensors())):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: register {k} of the captured "
                                 "server differs from the eager step's")


def check_step_counts(server, sched, launches: int, key: str) -> dict:
    """Gate: one graph replay per wave and one capture per bucket (counted
    by the server's step), and the stream kernel's ``LAUNCHES`` are the
    replays plus one warm-up run per capture."""
    from repro_torch.serving import bucket_length
    counts = server.step_counts()
    buckets = sorted({bucket_length(max(len(c) for _, c in reqs), 16,
                                    SERVE_MAX_CHUNK) for _, reqs in sched})
    waves = server.steps_run
    if not (waves == len(sched) and counts["replays"] == waves
            and counts["captures"] == len(buckets)
            and counts["graphs"] == buckets and counts["eager_runs"] == 0
            and launches == waves + counts["captures"]):
        raise AssertionError(
            f"{waves} waves, buckets {buckets}: step counts {counts}, "
            f"{key} launches {launches} (want one replay per wave, one "
            "capture per bucket, launches = replays + warm-ups)")
    return dict(counts, buckets=buckets)


def serve_timing(pipe, audio, rounds: int = 24, packet: int = 160) -> dict:
    """feed() and the session step, captured against eager, in alternating
    pairs in one run (the order flips every pair; host clock, synchronized,
    ms). Captured: a StreamServer of S slots. Eager: the synchronous feed
    the port served with before (stage on the host, copy to the card,
    ``_session_step`` op by op, read the decisions back). The step alone:
    one call of the server's step on its static inputs (a graph replay)
    against one eager ``_session_step`` on the same wave, host ms and
    device ms by CUDA events."""
    import numpy as np
    import torch
    from repro_torch.serving import StreamServer
    S = audio.shape[0]
    dev = pipe.device
    server = StreamServer(pipe, capacity=S, max_chunk=SERVE_MAX_CHUNK)
    ids = [f"t{i:03d}" for i in range(S)]
    for sid in ids:
        server.open(sid)
    state = pipe.init_session(S)

    def eager_feed(r):
        nonlocal state
        batch = np.zeros((S, 256), np.float32)
        batch[:, :packet] = audio[:, r * packet:(r + 1) * packet]
        valid = np.full(S, packet, np.int32)
        state, p, _ = pipe._session_step(
            state, torch.from_numpy(batch).to(dev),
            torch.from_numpy(valid).to(dev))
        p = p.cpu().numpy()
        return p.argmax(1)

    def captured_feed(r):
        return server.feed([(sid, audio[i, r * packet:(r + 1) * packet])
                            for i, sid in enumerate(ids)])

    def pairs(fns: dict, n: int) -> dict:
        out = {k: [] for k in fns}
        for i in range(n):
            order = list(fns) if i % 2 == 0 else list(fns)[::-1]
            for k in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k](i)
                torch.cuda.synchronize()
                out[k].append((time.perf_counter() - t0) * 1e3)
        return out

    captured_feed(0)                    # capture the bucket's graph
    eager_feed(0)
    feeds = pairs({"captured": lambda i: captured_feed(1 + i),
                   "eager": lambda i: eager_feed(1 + i)}, rounds)
    step = server._step
    chunk, valid = step.inputs(server.state, 256)
    steps = pairs({"captured": lambda i: step(pipe, server.state, chunk,
                                              valid),
                   "eager": lambda i: pipe._session_step(state, chunk,
                                                         valid)}, 20)
    med = lambda v: sorted(v)[len(v) // 2]   # noqa: E731
    return dict(
        card=card_line(),
        feed_ms_median=dict(captured=med(feeds["captured"]),
                            eager=med(feeds["eager"])),
        feed_ms_pairs=[[c, e] for c, e in zip(feeds["captured"],
                                              feeds["eager"])],
        step_host_ms_median=dict(captured=med(steps["captured"]),
                                 eager=med(steps["eager"])),
        step_device_ms=dict(
            captured=cuda_ms(lambda: step(pipe, server.state, chunk, valid),
                             20),
            eager=cuda_ms(lambda: pipe._session_step(state, chunk, valid),
                          20)))


def captured_parts_ms(parts: dict, reps: int = 50) -> dict:
    """Each part of the step captured as a CUDA graph of its own (after a
    warm-up run on a side stream) and replayed ``reps`` times between CUDA
    events: device ms per replay, part by part."""
    import torch
    from repro_torch.kernels._wrap import take_captured
    out = {}
    for name, fn in parts.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        out[name] = cuda_ms(graph.replay, reps)
    take_captured()
    out["sum_of_parts"] = sum(v for k, v in out.items() if k != "step")
    return out


def step_parts(pipe, numerics: str) -> dict:
    """The parts of the captured float or fixed step on one (256, 256) wave
    of 160-sample packets: masking (and, fixed, the ADC quantize), the
    octave cascade (one stream kernel launch), standardize, the readout,
    and the copies a served wave makes around them (the staged chunk and
    counts to the card, the new registers into the state, the decisions
    back), beside the whole step (session step + register copies)."""
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels.ops import fir_mp_stream_q
    S = 256
    st = pipe.init_session(S)
    chunk, valid = wave(pipe, S)
    pos0 = torch.arange(256, device=chunk.device)[None, :]
    n = torch.where(st.active, valid, 0)
    host_chunk = chunk.cpu().pin_memory()
    host_valid = valid.cpu().pin_memory()
    new, p, _ = pipe._session_step(st, chunk, valid)
    p_host = torch.empty(p.shape, pin_memory=True)

    def copies():
        chunk.copy_(host_chunk, non_blocking=True)
        valid.copy_(host_valid, non_blocking=True)
        for d, s in zip(st.tensors(), new.tensors()):
            if d is not s:
                d.copy_(s)
        p_host.copy_(p, non_blocking=True)

    def whole():
        out, _, _ = pipe._session_step(st, chunk, valid)
        for d, s in zip(st.tensors(), out.tensors()):
            if d is not s:
                d.copy_(s)

    if numerics == "fixed":
        prog = pipe.fixed_program()
        xq = torch.where(pos0 < n[:, None], fx.quantize_signal(prog, chunk),
                         0)
        phi_q = fx.standardize_q(prog, st.acc)
        parts = dict(
            mask_quantize=lambda: torch.where(
                pos0 < torch.where(st.active, valid, 0)[:, None],
                fx.quantize_signal(prog, chunk), 0),
            cascade=lambda: fir_mp_stream_q(prog, xq, n, st.delays,
                                            st.consumed, st.acc, st.amax),
            standardize=lambda: fx.standardize_q(prog, st.acc),
            readout=lambda: prog.out_spec.dequantize(
                fx.classifier_q(prog.clf, phi_q)))
    else:
        xm = torch.where(pos0 < n[:, None], chunk, 0.0)
        phi = (st.acc - pipe.mu) / pipe.sigma
        parts = dict(
            mask=lambda: torch.where(
                pos0 < torch.where(st.active, valid, 0)[:, None], chunk,
                0.0),
            cascade=lambda: pipe._cascade_pallas(st, xm, n),
            standardize=lambda: (st.acc - pipe.mu) / pipe.sigma,
            readout=lambda: pipe.clf(phi, exact=False))
    return captured_parts_ms(dict(parts, copies=copies, step=whole))


def wave(pipe, S: int):
    """One (S, 256) wave of 160-sample packets on the card: (chunk, valid)."""
    import torch
    dev = pipe.device
    g = torch.Generator().manual_seed(1)
    chunk = torch.randn(S, 256, generator=g).to(dev)
    valid = torch.full((S,), 160, dtype=torch.int32, device=dev)
    chunk[:, 160:] = 0
    return chunk, valid


def step_breakdown(step, cascade, readout, numerics: str) -> dict:
    """Where a serve step's time goes, on one wave: the whole session step,
    its octave cascade (one stream kernel launch and what surrounds it)
    and the kernel machine readout, each timed alone with CUDA events; then
    the step under torch.profiler for the device's busy share and its top
    kernels (``numerics`` picks the stream kernel, ``is_stream_kernel``)."""
    out = dict(session_step_ms=cuda_ms(step, 20),
               cascade_ms=cuda_ms(cascade, 20),
               readout_ms=cuda_ms(readout, 20))
    prof = profiled(step)
    out["profiled_step_ms"] = prof["wall_ms"]
    out["device_busy_share"] = prof["busy_share"]
    out["device_kernels_per_step"] = prof["kernels"]
    out["stream_kernel_device_us_per_step"] = sum(
        t for k, t in prof["by_name_us"].items()
        if is_stream_kernel(k, numerics))
    out["top_device_us_per_step"] = prof["top_us"]
    return out


def phase_serve(audio):
    import torch
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    pipe = make_pipeline()                   # full 30-band bank, on cuda
    if pipe.config.num_filters != 30 or pipe.device.type != "cuda":
        raise AssertionError("make_pipeline() must give the 30-band bank "
                             "on cuda")
    S = audio.shape[0]
    sched = serve_schedule(audio, 50, 160)
    serve(pipe, serve_schedule(audio[:, :1600], 10, 160)[:2], S)  # warm-up
    reset_launches()
    server, results, secs = serve(pipe, sched, S)
    launches = LAUNCHES["fir_mp_stream_cascade"]
    if LAUNCHES["fir_mp_stream_octave"]:
        raise AssertionError("the one-octave stream kernel launched "
                             f"{LAUNCHES['fir_mp_stream_octave']} times")
    counts = check_step_counts(server, sched, launches,
                               "fir_mp_stream_cascade")
    state, ps = serve_eager(pipe, sched, S)
    check_captured_vs_eager(server, results, state, ps, "float serve")
    p, _ = pipe.apply(torch.zeros(S, 0), server.state)   # pure readout
    if not (torch.isfinite(p).all() and p.abs().max() <= 1):
        raise AssertionError("final decisions not finite / outside [-1, 1]")
    plain = make_pipeline(stream_impl="xla", use_pallas=False)
    plain_server, _, secs_plain = serve(plain, sched, S)
    p_plain, _ = plain.apply(torch.zeros(S, 0), plain_server.state)
    d = float((p - p_plain).abs().max())
    if not d <= SERVE_TOL:
        raise AssertionError(f"served p vs torch-op cascade: {d} > "
                             f"{SERVE_TOL}")
    step_ms = sorted(secs)[len(secs) // 2] * 1e3
    chunk, valid = wave(pipe, S)
    phi = (state.acc - pipe.mu) / pipe.sigma
    breakdown = step_breakdown(
        lambda: pipe._session_step(state, chunk, valid),
        lambda: pipe._cascade_pallas(state, chunk, valid),
        lambda: pipe.clf(phi, exact=False), "float")
    out = dict(phase="serve", streams=S, waves=server.steps_run,
               stream_kernel_launches=launches, step_counts=counts,
               captured_equals_eager=True, step_ms_median=step_ms,
               step_ms_mean=sum(secs) / len(secs) * 1e3,
               streams_per_s=S * len(secs) / sum(secs),
               plain_step_ms_median=sorted(secs_plain)[len(secs) // 2] * 1e3,
               max_abs_diff_vs_plain=d,
               timing_pairs=serve_timing(pipe, audio),
               captured_parts_device_ms=step_parts(pipe, "float"),
               eager=breakdown)
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
    if (launches["fir_mp_oneshot_cascade"], launches["fir_mp_bank"],
            launches["fir_mp"]) != (1, 0, 0):
        raise AssertionError(f"one-shot launches {launches}: want one "
                             "cascade and no one-stage bank launch")
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
             max_abs_diff_phi=dphi, max_abs_diff_p=dp, launches=launches,
             **oneshot_breakdown(pipe, x)))
    return launches


def oneshot_breakdown(pipe, x) -> dict:
    """Where a float one-shot apply's time goes: the filter bank
    (``multirate_accumulate``) against standardize + readout, each timed
    alone by CUDA events; the bank's device time and device records per
    call (``device_us``, which takes a profile again when a record was
    lost); standardize + readout and the whole apply under torch.profiler
    (device kernels, device busy us and share)."""
    from repro_torch.core.filterbank import multirate_accumulate
    bank = lambda: multirate_accumulate(  # noqa: E731
        x, pipe.bp_taps, pipe.lp_taps, pipe.config)
    s = bank()
    rest = lambda: pipe.clf((s - pipe.mu) / pipe.sigma,  # noqa: E731
                            exact=False)
    dev = device_us(bank, is_oneshot_kernel)
    out = dict(bank_ms=cuda_ms(bank, 10), readout_ms=cuda_ms(rest, 10),
               bank_kernel_device_us=dev["kernel_us"],
               bank_device_us=dev["all_us"],
               bank_events_us=dev["events_us"],
               bank_device_timed_by=dev["timed_by"],
               bank_device_records=dev["kernels_per_call"])
    for k, fn in (("apply", lambda: pipe.apply(x)), ("readout", rest)):
        r = profiled(fn)
        out[f"{k}_wall_ms"] = r["wall_ms"]
        out[f"{k}_device_us"] = r["busy_us"]
        out[f"{k}_device_kernels"] = r["kernels"]
        out[f"{k}_device_busy_share"] = r["busy_share"]
    return out


# -- the fixed-point twin (numerics="fixed") -----------------------------------


def exact(got, want, what: str) -> None:
    """Integer outputs must be equal, int32, bit for bit."""
    import torch
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or want.dtype != torch.int32 \
            or not torch.equal(got, want):
        d = (got.long() - want.long()).abs().max()
        raise AssertionError(f"{what}: not exactly equal (max |diff| "
                             f"{int(d)}, dtypes {got.dtype} {want.dtype})")


def fixed_pipeline(cal, **kw):
    """The full-width fixed pipeline on cuda, calibrated on ``cal``."""
    from repro_torch.configs.esc10_mp import make_pipeline
    pipe = make_pipeline(numerics="fixed", **kw)
    if pipe.config.num_filters != 30 or pipe.device.type != "cuda":
        raise AssertionError("make_pipeline(numerics='fixed') must give the "
                             "30-band bank on cuda")
    return pipe, pipe.calibrate_fixed(cal)


def phase_int_stream_kernel(prog, gen, clips):
    """The int stream kernel against its plain versions, exactly: the
    one-octave entry at one wave's six octave shapes (S = 256 slots, L =
    256 then 128, ..., 8; valid counts mixed, 0 and odd included, random
    phases, register codes in their 8-bit range), then the cascade (one
    launch) on a served wave (n = 160 of 256, the clips' ADC codes, fresh
    and one wave later with odd phases) and on mixed valid counts at L =
    700; then the cascade's times, bound and host split."""
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    fm = importlib.import_module("repro_torch.kernels.fir_mp")
    from repro_torch.kernels.fir_mp import (fir_mp_stream_cascade_q,
                                            fir_mp_stream_octave_q,
                                            stream_plan)
    dev = torch.device("cuda")
    reset_launches()
    stages = prog.bank.octaves
    S, L, T1 = 256, 256, 15
    ms, plain_ms = 0.0, 0.0
    i32 = dict(generator=gen, dtype=torch.int32)
    for o, st in enumerate(stages):
        Fn, M = st.bp_q.shape
        Lo = -(-L // 2 ** o)
        n = torch.randint(0, Lo + 1, (S,), **i32)
        n[:8] = 0
        n[8:16] = Lo
        n[16:24] = torch.arange(8, dtype=torch.int32) * 2 % Lo + 1  # odd
        x = torch.randint(st.in_spec.qmin, st.in_spec.qmax + 1, (S, Lo),
                          **i32)
        if o == 0:   # the main path zeroes invalid tails of the chunk
            x = torch.where(torch.arange(Lo)[None] < n[:, None], x, 0)
        emit = st.lp_q is not None
        args = [t.to(dev) for t in (
            x, n, torch.randint(0, 2, (S,), **i32),
            torch.randint(st.in_spec.qmin, st.in_spec.qmax + 1, (S, T1),
                          **i32),
            torch.randint(0, 1 << 22, (S, Fn), **i32),
            torch.randint(0, 128, (S,), **i32))]
        kw = dict(stage=st, next_spec=stages[o + 1].in_spec if emit else None,
                  emit_next=emit, update_amax=(o == 0))
        got = fir_mp_stream_octave_q(*args, **kw)
        want = ref.fir_mp_stream_octave_q(*args, **kw)
        for g, w, what in zip(got, want, ("acc", "delay", "amax", "y_next")):
            if w is not None:
                exact(g, w, f"fir_mp_stream_octave_q octave {o} {what}")
        inert = args[1] == 0
        for g, w in ((got[0], args[4]), (got[1], args[3])):
            if not torch.equal(g[inert], w[inert]):
                raise AssertionError(f"octave {o}: an n == 0 slot moved")
        ms += cuda_ms(lambda: fir_mp_stream_octave_q(*args, **kw), 50)
        plain_ms += cuda_ms(lambda: ref.fir_mp_stream_octave_q(*args, **kw),
                            3)
    octave_entry = dict(shapes=f"S={S} L={L}..{Lo}", ms=ms, plain_ms=plain_ms,
                        launches_here=LAUNCHES["fir_mp_stream_octave_q"])

    # the cascade: one launch per wave
    O = len(stages)
    Fs = [st.bp_q.shape[0] for st in stages]
    P, M, M_lp = sum(Fs), stages[0].bp_q.shape[1], stages[0].lp_q.shape[1]
    spec = stages[0].in_spec

    def codes(x):
        return fx.quantize_signal(prog, x)

    def on_dev(case):
        chunk, n, delays, consumed, acc, amax = case
        return (chunk.to(dev), n.to(dev), tuple(d.to(dev) for d in delays),
                tuple(t.to(dev) for t in consumed), acc.to(dev), amax.to(dev))

    served = on_dev(cascade_case("served", S, L, O, P, T1, gen, clips,
                                 codes=codes))
    cases = {"served": served}
    cases["served, one wave later"] = on_dev(advanced(
        served, ref.fir_mp_stream_q(prog, *served), clips, codes))
    cases["mixed, L = 700"] = on_dev(cascade_case(
        "mixed", S, 700, O, P, T1, gen, codes=(spec.qmin, spec.qmax)))
    reset_launches()
    for name, case in cases.items():
        check_cascade(fir_mp_stream_cascade_q(prog, *case),
                      ref.fir_mp_stream_q(prog, *case), case,
                      f"fir_mp_stream_cascade_q ({name})", True)
    launches_here = LAUNCHES["fir_mp_stream_cascade_q"]
    run = lambda: fir_mp_stream_cascade_q(prog, *served)  # noqa: E731
    prof = device_us(run, lambda k: is_stream_kernel(k, "fixed"))
    counts = served_counts(served[1], served[3])
    ops = ops_ref = 0
    for (nv, kp), st in zip(counts, stages):
        Fn = st.bp_q.shape[0]
        lp = ((int(kp.sum()), st.lp_q.shape[1], st.iters_lp)
              if st.lp_q is not None else (0, 1, 0))
        for count, acc_ops in ((ops_int_dot_min, "ops"),
                               (ops_int_dot, "ref")):
            k = (int(nv.sum()) * Fn * (count(M, st.iters_bp) + 2)
                 + lp[0] * (count(lp[1], lp[2]) + 4))
            if acc_ops == "ops":
                ops += k
            else:
                ops_ref += k
    nb = cascade_bytes(S, L, O, P, T1,
                       sum(st.bp_q.size + (st.lp_q.size if st.lp_q is not None
                                           else 0) for st in stages))
    b_ms, b_by = bound_ms(ops, nb, INT32_OPS_PER_S)
    chain = device_us(lambda: octave_chain(fir_mp_stream_octave_q, *served,
                                           fixed_steps(prog)),
                      lambda k: is_stream_kernel(k, "fixed"))
    plan_args = (L, max(Fs), M, M_lp, T1)
    plan = stream_plan(*plan_args, octaves=O, integer=True)
    # the wrapper's host work, part by part, on the served wave
    chunk, n, delays, consumed, acc, amax = served
    table, Fs_t, _, _, cols = fm._program_table(prog.bank, T1, chunk.device)
    _, ins = fm._cascade_q_inputs(chunk, n, delays, consumed, acc, amax,
                                  Fs_t, M, M_lp)
    outs = fm._cascade_outputs(plan, acc, amax, O, T1=T1)
    rows = fm.stream_q_octave_rows(ins[2], outs[0], ins[3], outs[1], cols)
    host = host_split(run, {
        "program_table": lambda: fm._program_table(prog.bank, T1,
                                                   chunk.device),
        "inputs": lambda: fm._cascade_q_inputs(chunk, n, delays, consumed,
                                               acc, amax, Fs_t, M, M_lp),
        "outputs": lambda: fm._cascade_outputs(plan, acc, amax, O, T1=T1),
        "rows": lambda: fm.stream_q_octave_rows(ins[2], outs[0], ins[3],
                                                outs[1], cols),
        "launch": lambda: fm._stream_q_launch(
            ins[0], ins[1], ins[4], ins[5], outs[2], outs[3], outs[4], table,
            rows, L=L, P=P, ystride=plan["scratch"], F_max=max(Fs), M=M,
            M_lp=M_lp, T1=T1, update_amax=True, cascade=True, plan=plan)})
    host.update(plan_us(plan_args, dict(octaves=O, integer=True)))
    k_ms = cuda_ms(run, 50)
    row = dict(name="fir_mp_stream_cascade_q",
               shapes=f"S={S} L={L} n=160, {O} octaves (a served wave)",
               max_abs_err=0.0, ms=k_ms, **device_fields(prof, b_ms),
               plain_ms=cuda_ms(lambda: ref.fir_mp_stream_q(prog, *served),
                                3),
               bound_ms=b_ms, bound_by=b_by, x_bound_events=k_ms / b_ms,
               bound_ms_reference_algorithm=bound_ms(ops_ref, nb,
                                                     INT32_OPS_PER_S)[0],
               threads=plan["threads"], smem_bytes=plan["smem_bytes"],
               valid_per_octave=[int(nv[0]) for nv, _ in counts],
               launches_here=launches_here, host_us=host,
               one_octave_entry=octave_entry,
               one_octave_chain_device_us=chain["launch_us"])
    log({"kernel_vs_plain": row})
    return row


def phase_int_bank_kernel(prog, x):
    """The int one-shot kernel's one-stage entry (fir_mp_bank_q) vs plain
    at the 6 + 5 stage shapes of one fixed ``apply`` on x (B, N): per
    octave the band-pass and the low-pass, each in both modes, on the real
    cascade of codes; its times over the calls the route before the
    cascade made (band-pass in accumulate mode, low-pass in output mode)
    and that route's device time per launch. Its bound counts the cheapest
    exact step in the instructions the card issues (``ops_int_dot_min``),
    the reference algorithm's count (``ops_int_dot``) beside."""
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels.fir_mp import fir_mp_bank_q_kernel
    reset_launches()
    B, N = x.shape
    ms, plain_ms, ops, ops_ref, nbytes = 0.0, 0.0, 0.0, 0.0, 0.0
    x_o = fx.quantize_signal(prog, x)
    stages = prog.bank.octaves
    for o, st in enumerate(stages):
        N_o = x_o.shape[1]
        calls = [(fx.rescale(x_o, st.sig_shift).contiguous(), st.bp_q,
                  st.band_spec, st.gamma_bp, st.iters_bp, True)]
        if st.lp_q is not None:
            calls.append((fx.rescale(x_o, st.lp_sig_shift).contiguous(),
                          st.lp_q, st.lp_spec, st.gamma_lp, st.iters_lp,
                          False))
        for xs, H, spec, g, it, main_acc in calls:
            kw = dict(gamma_q=g, iters=it, qmin=spec.qmin, qmax=spec.qmax)
            for acc in (True, False):
                fn = (ref.fir_mp_bank_q_accumulate if acc
                      else ref.fir_mp_bank_q)
                exact(fir_mp_bank_q_kernel(xs, H, accumulate=acc, **kw),
                      fn(xs, H, **kw),
                      f"fir_mp_bank_q octave {o} F={H.shape[0]} "
                      f"accumulate={acc}")
            fn = ref.fir_mp_bank_q_accumulate if main_acc else ref.fir_mp_bank_q
            ms += cuda_ms(lambda: fir_mp_bank_q_kernel(
                xs, H, accumulate=main_acc, **kw), 20)
            plain_ms += cuda_ms(lambda: fn(xs, H, **kw), 2)
            Fn, M = H.shape
            acc_ops = 2 if main_acc else 0
            ops += B * N_o * Fn * (ops_int_dot_min(M, it) + acc_ops)
            ops_ref += B * N_o * Fn * (ops_int_dot(M, it) + acc_ops)
            nbytes += 4 * (B * N_o + Fn * M
                           + (B * Fn if main_acc else B * Fn * N_o))
        if st.lp_q is not None:
            y_lp = ref.fir_mp_bank_q(calls[1][0], st.lp_q, st.gamma_lp,
                                     st.iters_lp, st.lp_spec.qmin,
                                     st.lp_spec.qmax)[:, 0]
            x_o = fx._clamp(fx.rescale(y_lp, st.lp_out_shift),
                            stages[o + 1].in_spec)[:, ::2].contiguous()
    b_ms, b_by = bound_ms(ops, nbytes, INT32_OPS_PER_S)
    launches_here = LAUNCHES["fir_mp_bank_q"]
    xq = fx.quantize_signal(prog, x)
    chain = device_us(lambda: int_one_stage_chain(prog.bank, xq),
                      is_bank_q_kernel)
    row = dict(name="fir_mp_bank_q", shapes=f"B={B} N={N}..{N_o}",
               max_abs_err=0.0, ms=ms, **device_fields(chain, b_ms),
               launch_device_us=chain["launch_us"], plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by,
               bound_ms_reference_algorithm=bound_ms(ops_ref, nbytes,
                                                     INT32_OPS_PER_S)[0],
               launches_here=launches_here)
    log({"kernel_vs_plain": row})
    return row


def int_one_stage_chain(bank, xq):
    """One fixed apply's bank through the one-stage entry, as the main
    path ran it before the cascade kernel: per octave the band-pass sums
    (<< acc_shift) and the low-pass at every position, requantized, its
    even positions kept."""
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels.fir_mp import fir_mp_bank_q_kernel
    parts, x_o = [], xq
    for o, st in enumerate(bank.octaves):
        s = fir_mp_bank_q_kernel(
            fx.rescale(x_o, st.sig_shift).contiguous(), st.bp_q,
            gamma_q=st.gamma_bp, iters=st.iters_bp, qmin=st.band_spec.qmin,
            qmax=st.band_spec.qmax, accumulate=True)
        parts.append(fx.shift_left(s, st.acc_shift))
        if st.lp_q is not None:
            y = fir_mp_bank_q_kernel(
                fx.rescale(x_o, st.lp_sig_shift).contiguous(), st.lp_q,
                gamma_q=st.gamma_lp, iters=st.iters_lp,
                qmin=st.lp_spec.qmin, qmax=st.lp_spec.qmax)[:, 0]
            x_o = fx._clamp(fx.rescale(y, st.lp_out_shift),
                            bank.octaves[o + 1].in_spec)[:, ::2].contiguous()
    return torch.cat(parts, dim=-1)


def oneshot_q_ops(bank, B: int, N: int, *, kept_only: bool = True,
                  step=None):
    """(int32 instructions, bytes) the int one-shot cascade needs on x (B,
    N): every band-pass (position, filter) of every octave, a solve
    (``step``, ``ops_int_dot_min`` by default) and its HWR add (2), and
    each low-pass at its kept positions (at all of them unless
    ``kept_only``: the reference's count); x read once, the tap codes,
    the sums (B, P) written once."""
    step = step or ops_int_dot_min
    ops, N_o, taps = 0, N, 0
    for st in bank.octaves:
        Fn, M = st.bp_q.shape
        ops += B * N_o * Fn * (step(M, st.iters_bp) + 2)
        taps += Fn * M
        if st.lp_q is not None:
            kept = (N_o + 1) // 2
            M_lp = st.lp_q.shape[-1]
            ops += (B * (kept if kept_only else N_o)
                    * step(M_lp, st.iters_lp))
            taps += M_lp
            N_o = kept
    P = sum(st.bp_q.shape[0] for st in bank.octaves)
    return ops, 4 * (B * N + taps + B * P)


def phase_oneshot_cascade_q(prog, x):
    """The int one-shot cascade kernel (the whole bank of one fixed apply
    in one launch) against its plain version, exactly (torch.equal): on
    the clips' ADC codes (B = 8, N = 16000) and on odd lengths (one row
    shorter than a tile among them); its times (CUDA events; device time
    and records by torch.profiler), its bound (low-pass at the kept
    positions; at every position and in the reference's step form
    beside), the grid and the work items."""
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import LAUNCHES, ref, reset_launches
    from repro_torch.kernels._build import load
    from repro_torch.kernels.fir_mp import (fir_mp_oneshot_cascade_q,
                                            oneshot_plan)
    bank = prog.bank
    sig = bank.signal
    g = torch.Generator().manual_seed(3)
    cases = {"clips": fx.quantize_signal(prog, x)}
    for shape in ((1, 5), (1, 201), (3, 301), (5, 1027)):
        cases[f"random {shape}"] = torch.randint(
            sig.qmin, sig.qmax + 1, shape, generator=g,
            dtype=torch.int32).to(x.device)
    reset_launches()
    for name, xc in cases.items():
        exact(fir_mp_oneshot_cascade_q(bank, xc),
              ref.fir_mp_oneshot_cascade_q(bank, xc),
              f"fir_mp_oneshot_cascade_q ({name}) vs its plain version")
    launches_here = LAUNCHES["fir_mp_oneshot_cascade_q"]
    if launches_here != len(cases) or LAUNCHES["fir_mp_bank_q"] != 0:
        raise AssertionError(f"int cascade launches {dict(LAUNCHES)}: want "
                             f"{len(cases)} cascades, no one-stage launch")
    xq = cases["clips"]
    B, N = xq.shape
    run = lambda: fir_mp_oneshot_cascade_q(bank, xq)  # noqa: E731
    prof = device_us(run, is_bank_q_kernel)
    ops, nb = oneshot_q_ops(bank, B, N)
    b_ms, b_by = bound_ms(ops, nb, INT32_OPS_PER_S)
    O = len(bank.octaves)
    F = bank.octaves[0].bp_q.shape[0]
    plan = oneshot_plan(B, N, F, octaves=O, integer=True)
    row = dict(name="fir_mp_oneshot_cascade_q",
               shapes=f"B={B} N={N}, {O} octaves",
               max_abs_err=0.0, ms=cuda_ms(run, 20),
               **device_fields(prof, b_ms),
               device_records_per_call=prof["kernels_per_call"],
               plain_ms=cuda_ms(
                   lambda: ref.fir_mp_oneshot_cascade_q(bank, xq), 2),
               bound_ms=b_ms, bound_by=b_by,
               bound_ms_all_positions=bound_ms(
                   oneshot_q_ops(bank, B, N, kept_only=False)[0], nb,
                   INT32_OPS_PER_S)[0],
               bound_ms_reference_algorithm=bound_ms(
                   oneshot_q_ops(bank, B, N, kept_only=False,
                                 step=ops_int_dot)[0], nb,
                   INT32_OPS_PER_S)[0],
               grid=load("fir_mp_oneshot_q_ctas")(0), items=plan["items"],
               launches_here=launches_here)
    log({"kernel_vs_plain": row})
    return row


def phase_fixed_serve(audio, cal):
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import fir_mp_stream_q
    pipe, prog = fixed_pipeline(cal)
    plain, prog_plain = fixed_pipeline(cal, stream_impl="xla")
    if [o.in_spec for o in prog.bank.octaves] != \
            [o.in_spec for o in prog_plain.bank.octaves]:
        raise AssertionError("the two fixed pipelines calibrated different "
                             "octave gains on the same audio")
    S = audio.shape[0]
    sched = serve_schedule(audio, 50, 160)
    serve(pipe, serve_schedule(audio[:, :1600], 10, 160)[:2], S)  # warm-up
    reset_launches()
    server, results, secs = serve(pipe, sched, S)
    launches = LAUNCHES["fir_mp_stream_cascade_q"]
    if LAUNCHES["fir_mp_stream_octave_q"]:
        raise AssertionError("the one-octave int stream kernel launched "
                             f"{LAUNCHES['fir_mp_stream_octave_q']} times")
    counts = check_step_counts(server, sched, launches,
                               "fir_mp_stream_cascade_q")
    state_e, ps = serve_eager(pipe, sched, S)
    check_captured_vs_eager(server, results, state_e, ps, "fixed serve")
    state = server.state
    if state.acc.dtype != torch.int32 or state.delays[0].dtype != torch.int32:
        raise AssertionError("fixed registers must stay int32")
    scale = prog.out_spec.scale
    p, _ = pipe.apply(torch.zeros(S, 0), state)           # pure readout
    p_q = torch.round(p / scale).to(torch.int32)
    plain_server, _, secs_plain = serve(plain, sched, S)
    p_plain, _ = plain.apply(torch.zeros(S, 0), plain_server.state)
    exact(p_q, torch.round(p_plain / scale).to(torch.int32),
          "served p codes vs the torch-op integer cascade")
    exact(state.acc, plain_server.state.acc,
          "served accumulators vs the torch-op integer cascade")
    # the regular streams were each fed their row's first 50 x 160 samples
    x = torch.from_numpy(audio[:S - 1, :50 * 160].copy()).cuda()
    reset_launches()
    p_one, _, s_one = fx.infer_q(prog, fx.quantize_signal(prog, x),
                                 use_pallas=True)
    if (LAUNCHES["fir_mp_oneshot_cascade_q"], LAUNCHES["fir_mp_bank_q"]) \
            != (1, 0):
        raise AssertionError(f"infer_q(use_pallas=True) launches "
                             f"{dict(LAUNCHES)}: want one int cascade")
    exact(p_q[:S - 1], p_one, "served p codes vs one-shot infer_q")
    exact(state.acc[:S - 1], s_one, "served accumulators vs one-shot "
                                    "infer_q")
    chunk, valid = wave(pipe, S)
    xq = fx.quantize_signal(prog, chunk)
    breakdown = step_breakdown(
        lambda: pipe._session_step(state_e, chunk, valid),
        lambda: fir_mp_stream_q(prog, xq, valid, state_e.delays,
                                state_e.consumed, state_e.acc,
                                state_e.amax),
        lambda: fx.readout_q(prog, state_e.acc), "fixed")
    step_ms = sorted(secs)[len(secs) // 2] * 1e3
    octaves = prog.bank.octaves
    log(dict(phase="fixed_serve", streams=S, waves=server.steps_run,
             signal_exp=prog.signal.exp,
             octave_gains=[prog.signal.exp - o.in_spec.exp for o in octaves],
             iters_bp=[o.iters_bp for o in octaves],
             iters_lp=[o.iters_lp for o in octaves if o.lp_q is not None],
             iters_readout=[prog.clf.iters1, prog.clf.iters_n],
             stream_kernel_launches=launches, step_counts=counts,
             captured_equals_eager=True, step_ms_median=step_ms,
             step_ms_mean=sum(secs) / len(secs) * 1e3,
             streams_per_s=S * len(secs) / sum(secs),
             plain_step_ms_median=sorted(secs_plain)[len(secs) // 2] * 1e3,
             codes_equal_plain=True, codes_equal_oneshot=True,
             timing_pairs=serve_timing(pipe, audio),
             captured_parts_device_ms=step_parts(pipe, "fixed"),
             eager=breakdown))
    return launches



# -- the serving tier: async pipeline, eviction, router, poison ---------------


def same_results(got, want, what: str) -> None:
    key = lambda rs: [(r.session_id, r.label, r.confidence,  # noqa: E731
                       r.samples_seen) for r in rs]
    if key(got) != key(want):
        raise AssertionError(f"{what}: results differ")


def same_rows(a, b, ids, what: str) -> None:
    """Every register row of each session, bit for bit, in two servers
    (or a router and a server) whatever slots they hold."""
    import torch
    torch.cuda.synchronize()
    for sid in ids:
        sa, sb = a.session(sid), b.session(sid)
        srv_a = a.shard(a.shard_of(sid)) if hasattr(a, "shard") else a
        for x, y in zip(srv_a.state.tensors(), b.state.tensors()):
            if not torch.equal(x[sa.slot], y[sb.slot]):
                raise AssertionError(f"{what}: {sid}'s registers differ")


def phase_serving_tier(audio):
    """The serving tier on the card at 256 slots, float: submit / poll /
    drain against feed(), eviction to checkpoints and reopening, a 2-shard
    router against one server (each bit for bit), and the poisoned-server
    contract (a step forced to raise, a replay forced to fail)."""
    import tempfile
    from unittest import mock

    import torch
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.serving import StreamRouter, StreamServer
    pipe = make_pipeline()
    S = audio.shape[0]
    ids = [f"m{i:03d}" for i in range(S)]
    rounds = [[(sid, audio[i, r * 160:(r + 1) * 160])
               for i, sid in enumerate(ids)] for r in range(10)]
    kw = dict(capacity=S, max_chunk=256)
    out = dict(phase="serving_tier", streams=S)

    # submit / poll / drain with a watermark == feed()
    sync, asy = StreamServer(pipe, **kw), StreamServer(
        pipe, coalesce_watermark=64, **kw)
    for srv in (sync, asy):
        for sid in ids:
            srv.open(sid)
    polled = 0
    for reqs in rounds:
        want = sync.feed(reqs)
        tickets = [asy.submit(reqs[g::4]) for g in range(4)]  # 64 each
        t0 = time.perf_counter()
        while asy.poll(tickets[-1]) is None and \
                time.perf_counter() - t0 < 5:
            pass
        polled += tickets[-1].done
        asy.drain()
        got = [None] * len(reqs)
        for g, t in enumerate(tickets):
            got[g::4] = t.results
        same_results(got, want, "async vs feed()")
    same_rows(asy, sync, ids, "async vs feed()")
    out["async"] = dict(equal=True, waves=asy.steps_run,
                        resolved_by_poll=polled,
                        step_counts=asy.step_counts())

    # eviction to named checkpoints, then reopening
    with tempfile.TemporaryDirectory() as d:
        ev = StreamServer(pipe, checkpoint_dir=d, **kw)
        ref = StreamServer(pipe, **kw)
        for srv in (ev, ref):
            for sid in ids:
                srv.open(sid)
        parked, rest = ids[:32], ids[32:]
        for r in range(10):
            if r == 4:
                for sid in parked:
                    ev.evict(sid)
            if r == 6:
                for sid in parked:       # LIFO free slots: they move
                    ev.open(sid)
            reqs = [q for q in rounds[r]
                    if 4 <= r < 6 and q[0] in rest or not 4 <= r < 6]
            same_results(ev.feed(reqs), ref.feed(reqs), "eviction")
        moved = sum(ev.session(s).slot != ref.session(s).slot
                    for s in parked)
        same_rows(ev, ref, ids, "evicted and reopened")
        out["eviction"] = dict(equal=True, parked=len(parked),
                               moved_slots=moved)

    # a 2-shard router == one server
    router = StreamRouter(pipe, num_shards=2, **kw)
    single = StreamServer(pipe, **kw)
    for sid in ids:
        router.open(sid)
        single.open(sid)
    for reqs in rounds[:6]:
        same_results(router.feed(reqs), single.feed(reqs), "router")
    same_rows(router, single, ids, "router")
    out["router"] = dict(equal=True, shards=[
        srv.stats()["resident"] for srv in router.shards])

    # the poisoned-server contract
    def poisoned(srv, what):
        try:
            srv.feed(rounds[1][:8])
        except RuntimeError as e:
            first = str(e)
        else:
            raise AssertionError(f"{what}: feed did not raise")
        try:
            srv.open("late")
        except RuntimeError as e:
            if "poisoned" not in str(e) or "wave 1" not in str(e):
                raise AssertionError(f"{what}: {e}")
        else:
            raise AssertionError(f"{what}: a poisoned server took a call")
        return dict(error=first, stats_poisoned=srv.stats()["poisoned"])

    srv = StreamServer(pipe, capacity=8, max_chunk=256)
    for sid in ids[:8]:
        srv.open(sid)
    srv.feed(rounds[0][:8])

    def bad_step(p, state, chunk, valid):
        raise RuntimeError("forced step failure")

    srv._step = bad_step
    out["poison_step"] = poisoned(srv, "step forced to raise")
    srv = StreamServer(pipe, capacity=8, max_chunk=256)
    for sid in ids[:8]:
        srv.open(sid)
    srv.feed(rounds[0][:8])                    # captured
    with mock.patch.object(torch.cuda.CUDAGraph, "replay",
                           side_effect=RuntimeError("forced replay failure")):
        out["poison_replay"] = poisoned(srv, "replay forced to fail")
    log(out)
    return out


def phase_fixed_oneshot(x, cal):
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.kernels import LAUNCHES, reset_launches
    pipe, prog = fixed_pipeline(cal)
    pipe.apply(x)                            # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    p, phi = pipe.apply(x, return_features=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(LAUNCHES)
    if (launches["fir_mp_oneshot_cascade_q"], launches["fir_mp_bank_q"]) \
            != (1, 0):
        raise AssertionError(f"fixed one-shot launches {launches}: want one "
                             "int cascade and no one-stage launch")
    t0 = time.perf_counter()
    p2, phi2 = fx.predict(prog, x, use_pallas=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    codes = lambda t, spec: torch.round(t / spec.scale).to(torch.int32)
    exact(codes(p, prog.out_spec), codes(p2, prog.out_spec),
          "fixed one-shot p codes vs the torch-op path")
    exact(codes(phi, prog.phi), codes(phi2, prog.phi),
          "fixed one-shot phi codes vs the torch-op path")
    log(dict(phase="fixed_oneshot", shape=list(x.shape), ms=ms,
             plain_ms=plain_ms, codes_equal_plain=True, launches=launches,
             **fixed_oneshot_breakdown(pipe, prog, x)))
    return launches


def fixed_oneshot_breakdown(pipe, prog, x) -> dict:
    """Where a fixed one-shot apply's time goes, as ``oneshot_breakdown``
    for the float one: the bank (ADC quantize + ``bank_accumulate_q``, the
    int cascade) against the readout (``standardize_q`` +
    ``classifier_q``), each timed alone by CUDA events; the bank's device
    time and device records per call (memset and cascade); the readout
    and the whole apply under torch.profiler (device kernels, device busy
    us and share)."""
    from repro_torch.core import fixed as fx
    bank = lambda: fx.bank_accumulate_q(  # noqa: E731
        prog.bank, fx.quantize_signal(prog, x), use_pallas=True)
    s = bank()
    rest = lambda: fx.classifier_q(  # noqa: E731
        prog.clf, fx.standardize_q(prog, s))
    dev = device_us(bank, is_bank_q_kernel)
    out = dict(bank_ms=cuda_ms(bank, 10), readout_ms=cuda_ms(rest, 10),
               bank_kernel_device_us=dev["kernel_us"],
               bank_device_us=dev["all_us"],
               bank_events_us=dev["events_us"],
               bank_device_timed_by=dev["timed_by"],
               bank_device_records=dev["kernels_per_call"])
    for k, fn in (("apply", lambda: pipe.apply(x)), ("readout", rest)):
        r = profiled(fn)
        out[f"{k}_wall_ms"] = r["wall_ms"]
        out[f"{k}_device_us"] = r["busy_us"]
        out[f"{k}_device_kernels"] = r["kernels"]
        out[f"{k}_device_busy_share"] = r["busy_share"]
    return out


# -- the transformer decode slice: qwen3-8b in MP mode -------------------------


def decode_shapes(cfg) -> list:
    """(d, O, calls per decode step, weights bf16-rounded) for each
    distinct mp_linear shape of one decode step: the seven projections of
    every layer (their weights cast to the compute dtype, as the reference
    casts them) and the f32 LM head."""
    D, hd = cfg.d_model, cfg.head_dim
    per_layer = {}
    for d, O in ((D, cfg.num_heads * hd), (D, cfg.num_kv_heads * hd),
                 (D, cfg.num_kv_heads * hd), (cfg.num_heads * hd, D),
                 (D, cfg.d_ff), (D, cfg.d_ff), (cfg.d_ff, D)):
        per_layer[(d, O)] = per_layer.get((d, O), 0) + 1
    return ([(d, O, n * cfg.num_layers, True)
             for (d, O), n in per_layer.items()]
            + [(D, cfg.padded_vocab, 1, False)])


def phase_mp_kernels(cfg):
    """mp_linear vs plain at every decode shape (B = 2), summed per decode
    step; mp_waterfill through ``ops.mp_waterfill`` at one served wave's
    bank solves, whose launch is counted as that op's path (no model path
    calls it, as in the reference), then vs plain there and at 8 x 257."""
    import torch
    from repro_torch.kernels import LAUNCHES, _build, ref, reset_launches
    from repro_torch.kernels.mp_kernels import (mp_linear_kernel,
                                                mp_linear_plan,
                                                mp_waterfill_kernel,
                                                mp_waterfill_plan)
    from repro_torch.kernels.ops import mp_waterfill
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    B = 2
    lin = dict(name="mp_linear", max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    ops, ops_ref, nbytes, shapes, plans, tiles = 0.0, 0.0, 0.0, [], [], []
    for d, O, n, rounded in decode_shapes(cfg):
        # the dtypes decode_step gives the kernel: bf16 layer weights (the
        # per-step cast of the masters), the f32 head; bf16-valued x
        x = torch.randn(B, d, generator=g, device=dev).bfloat16().float()
        w = torch.randn(d, O, generator=g, device=dev).mul_(d ** -0.5)
        if rounded:
            w = w.bfloat16()
        wf = w.float()
        plan = dict(d=d, O=O, w=str(w.dtype).replace("torch.", ""),
                    **mp_linear_plan(B, d, O, w.dtype))
        plans.append(plan)
        got = mp_linear_kernel(x, w, MP_GAMMA)
        want = ref.mp_linear(x, wf, MP_GAMMA)
        err, tol = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"mp_linear d={d} O={O}: max |diff| {err} "
                                 f"> {tol}")
        k_ms = cuda_ms(lambda: mp_linear_kernel(x, w, MP_GAMMA),
                       3 if O > 50000 else 10)
        # no bisection step: the tile staging, the max pass and the launch
        setup_ms = cuda_ms(lambda: mp_linear_kernel(x, w, MP_GAMMA, 0),
                           3 if O > 50000 else 10)
        p_ms = cuda_ms(lambda: ref.mp_linear(x, wf, MP_GAMMA), 1)
        nb = 4 * B * d + w.element_size() * d * O + 4 * B * O
        b_ms, _ = bound_ms(ops_mp_linear(B, d, O), nb)
        shapes.append(dict(d=d, O=O, w=plan["w"], calls_per_step=n, ms=k_ms,
                           ms_no_steps=setup_ms, plain_ms=p_ms, bound_ms=b_ms,
                           x_bound=k_ms / b_ms, max_abs_err=err))
        lin["max_abs_err"] = max(lin["max_abs_err"], err)
        lin["ms"] += n * k_ms
        lin["plain_ms"] += n * p_ms
        for to in (8, 4, 2):    # every width that fits, against the plain
            tile = mp_linear_plan(B, d, O, w.dtype, tile_to=to)
            if not tile["fits"]:
                continue
            err, tol = max_err(mp_linear_kernel(x, w, MP_GAMMA, tile_to=to),
                               want)
            if not err <= tol:
                raise AssertionError(f"mp_linear d={d} O={O} TO={to}: max "
                                     f"|diff| {err} > {tol}")
            t_ms = cuda_ms(lambda: mp_linear_kernel(x, w, MP_GAMMA,
                                                    tile_to=to),
                           3 if O > 50000 else 10)
            tiles.append(dict(d=d, O=O, w=plan["w"], TO=to,
                              chosen=bool(plan["resident"]) and to == plan["TO"],
                              ctas=tile["ctas"], per_sm=tile["per_sm"],
                              waves=tile["waves"],
                              last_wave_fill=tile["last_wave_fill"], ms=t_ms,
                              x_bound=t_ms / b_ms, max_abs_err=err))
        ops += n * ops_mp_linear(B, d, O)
        ops_ref += n * ops_mp_linear_reference(B, d, O)
        nbytes += n * nb
    log({"mp_linear_plans": plans})
    log({"mp_linear_tiles": tiles})
    census = sass_census(_build.lib_path("mp_linear"))
    for pl in plans:
        key = (f"mp_linear<{'bf16' if pl['w'] == 'bfloat16' else 'f32'},"
               f"BB={pl['BB']},TO={pl['TO']},"
               f"{'res' if pl['resident'] else 'global'}>")
        log({"sass_hot_loop": key, **census.get(key, {"loop": None})})
    lin["bound_ms"], lin["bound_by"] = bound_ms(ops, nbytes)
    lin["bound_ms_reference_algorithm"] = bound_ms(ops_ref, nbytes)[0]
    lin["x_bound"] = lin["ms"] / lin["bound_ms"]
    lin["shapes"] = f"B={B}, per decode step: {shapes}"
    log({"kernel_vs_plain": lin})

    # mp_waterfill: the op's own path, counted, at one wave's bank solves
    S, F, L, m = 256, 30, 160, 32
    Lw = torch.randn(S, F, L, m, generator=g, device=dev).mul_(3.0)
    reset_launches()
    z = mp_waterfill(Lw, WATERFILL_GAMMA)
    launches = LAUNCHES["mp_waterfill"]
    if launches != 1 or tuple(z.shape) != (S, F, L):
        raise AssertionError(f"ops.mp_waterfill: {launches} launches, shape "
                             f"{tuple(z.shape)}")
    L2 = Lw.reshape(-1, m)
    R = L2.shape[0]
    wf = dict(name="mp_waterfill", max_abs_err=0.0)
    for Lc in (L2, torch.randn(8, 257, generator=g, device=dev) * 3):
        err, tol = max_err(mp_waterfill_kernel(Lc, WATERFILL_GAMMA),
                           ref.mp_waterfill(Lc, WATERFILL_GAMMA))
        if not err <= tol:
            raise AssertionError(f"mp_waterfill {tuple(Lc.shape)}: max "
                                 f"|diff| {err} > {tol}")
        wf["max_abs_err"] = max(wf["max_abs_err"], err)
    err, _ = max_err(z.reshape(-1), ref.mp_waterfill(L2, WATERFILL_GAMMA))
    wf["max_abs_err"] = max(wf["max_abs_err"], err)
    wf["ms"] = cuda_ms(lambda: mp_waterfill_kernel(L2, WATERFILL_GAMMA), 20)
    wf["plain_ms"] = cuda_ms(lambda: ref.mp_waterfill(L2, WATERFILL_GAMMA), 2)
    wf["bound_ms"], wf["bound_by"] = bound_ms(ops_waterfill(R, m),
                                              4 * (R * m + R))
    wf["x_bound"] = wf["ms"] / wf["bound_ms"]
    wf["layout"] = {str(mm): dict(mp_waterfill_plan(mm)) for mm in (m, 257)}
    wf["shapes"] = f"R={R} m={m}; 8 x 257"
    wf["launches_here"] = launches
    log({"kernel_vs_plain": wf})
    return lin, wf


# -- training: esc10-mp fit, the MP backward and the qwen3-8b train step -------


TRAIN_CPU_STEPS = 20      # fit's first steps, held against the CPU's
TRAIN_LOSS_TOL = 1e-3     # x (1 + max |CPU loss|) over those steps
FEATURE_GATE_CLIPS = 32   # clips whose features are held against plain
LEVEL_TOL = 1e-6          # x (1 + |z|): the backward's levels vs the sort
LM_BATCH, LM_SEQ, LM_STEPS = 2, 32, 3


def phase_train():
    """esc10-mp ``InFilterPipeline.fit`` at full width on the card (30
    bands, 260 seeded 1 s clips, ``configs.esc10_mp.TRAIN``: 600 steps),
    then deployed fixed."""
    import numpy as np
    import torch
    from repro_torch.configs.esc10_mp import FILTERBANK, TRAIN
    from repro_torch.core import trainer
    from repro_torch.core.filterbank import FilterBank
    from repro_torch.core.pipeline import InFilterPipeline
    from repro_torch.data.acoustic import make_esc10_like
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = FILTERBANK._replace(use_pallas=True)
    ds = make_esc10_like(per_class_train=26, per_class_test=4, fs=16000.0,
                         seconds=1.0, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(ds.x_train)).cuda()
    x_test = torch.from_numpy(np.ascontiguousarray(ds.x_test)).cuda()
    y_test = torch.from_numpy(ds.y_test).cuda()

    # fit, timed whole; its features in one cascade launch
    reset_launches()
    t0 = time.perf_counter()
    pipe, losses = InFilterPipeline.fit(cfg, ds.x_train, ds.y_train, 10,
                                        TRAIN, device="cuda")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = dict(LAUNCHES)
    if fit_launches["fir_mp_oneshot_cascade"] != 1:
        raise AssertionError(f"fit's features: {fit_launches}")
    if not (all(math.isfinite(v) for v in losses)
            and len(losses) == TRAIN.num_steps and losses[-1] < losses[0]):
        raise AssertionError(f"fit's losses: first {losses[:3]}, last "
                             f"{losses[-3:]}")

    # the features through the kernel against the plain path
    fb = FilterBank(cfg, device="cuda")
    s = fb.accumulate(x)
    torch.cuda.synchronize()
    feat_ms = cuda_ms(lambda: fb.accumulate(x), 3)
    plain = FilterBank(cfg._replace(use_pallas=False, solver="bisect"),
                       device="cuda")
    n = FEATURE_GATE_CLIPS
    t0 = time.perf_counter()
    s_plain = plain.accumulate(x[:n])
    torch.cuda.synchronize()
    feat_plain_ms = (time.perf_counter() - t0) * 1e3
    phi = (s - pipe.mu) / pipe.sigma
    phi_plain = (s_plain - pipe.mu) / pipe.sigma
    dphi = float((phi[:n] - phi_plain).abs().max())
    tol = ONESHOT_PHI_TOL * (1 + float(phi_plain.abs().max()))
    if not dphi <= tol:
        raise AssertionError(f"fit's features vs plain: {dphi} > {tol}")

    # the first steps against the port on the CPU, same params and batches
    cpu_cfg = dataclasses.replace(TRAIN, num_steps=TRAIN_CPU_STEPS)
    _, cpu_losses = trainer.train(phi.cpu(), ds.y_train, 10, cpu_cfg,
                                  device="cpu")
    cpu_gap = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    cpu_tol = TRAIN_LOSS_TOL * (1 + max(abs(v) for v in cpu_losses))
    if not cpu_gap <= cpu_tol:
        raise AssertionError(f"fit's first {TRAIN_CPU_STEPS} losses, card "
                             f"vs CPU: {cpu_gap} > {cpu_tol}")

    # the step: host ms over the 600 steps, device time under the profiler
    t0 = time.perf_counter()
    trainer.train(phi, ds.y_train, 10, TRAIN, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    prof_steps = 20
    prof = profiled(lambda: trainer.train(
        phi, ds.y_train, 10, dataclasses.replace(TRAIN, num_steps=prof_steps),
        device="cuda"), reps=1)

    # held-out accuracy, float, then the fixed deploy (one int cascade)
    acc = float((pipe.apply(x_test).argmax(-1) == y_test).float().mean())
    fixed = InFilterPipeline(cfg._replace(numerics="fixed"), pipe.bp_taps,
                             pipe.lp_taps, pipe.mu, pipe.sigma,
                             pipe.clf.params, device="cuda")
    fixed.calibrate_fixed(ds.x_train[:8])
    reset_launches()
    p_fixed = fixed.apply(x_test)
    torch.cuda.synchronize()
    fixed_launches = dict(LAUNCHES)
    if fixed_launches["fir_mp_oneshot_cascade_q"] != 1 or not (
            bool(torch.isfinite(p_fixed).all())
            and float(p_fixed.abs().max()) <= 1.0):
        raise AssertionError(f"fixed deploy: {fixed_launches}, p in "
                             f"[{float(p_fixed.min())}, "
                             f"{float(p_fixed.max())}]")
    acc_fixed = float((p_fixed.argmax(-1) == y_test).float().mean())
    log(dict(phase="train", config="esc10-mp FILTERBANK", clips=len(ds.y_train),
             steps=TRAIN.num_steps, first_loss=losses[0],
             last_loss=losses[-1], fit_s=fit_s,
             features_ms=feat_ms, features_plain_ms_32_clips=feat_plain_ms,
             features_max_abs_diff_phi=dphi, features_tol=tol,
             cpu_steps=TRAIN_CPU_STEPS, cpu_max_loss_gap=cpu_gap,
             cpu_tol=cpu_tol, train_600_steps_s=train_s,
             host_ms_per_step=train_s * 1e3 / TRAIN.num_steps,
             device_busy_ms_per_step=prof["busy_us"] * 1e-3 / prof_steps,
             device_busy_share=prof["busy_share"],
             kernels_per_step=prof["kernels"] / prof_steps,
             top_device_us_per_step=[[k, t / prof_steps]
                                     for k, t in prof["top_us"]],
             held_out_accuracy=acc, held_out_accuracy_fixed=acc_fixed,
             test_clips=len(ds.y_test)))


def ops_mp_linear_grads(B: int, d: int, O: int, passes: int) -> int:
    """f32 ops of row 6b's work, what the backward adds to the forward's
    bisection, in its cheapest exact form: per level the exact tail from
    the bracket the forward's steps leave, ``passes`` Newton passes summed
    over the B x O x 2 levels, each of a level's passes but its last a
    count and sum in one (per operand t, the compare of |t| with the
    level's threshold, |.| being an operand modifier, and two predicated
    adds: 4), its last pass the count alone (3), and 4 per level and pass
    for the step; then one fused mask pass per (b, o, i) (u, v, and per
    branch a compare, a sign and two predicated adds: 10), with g / k
    formed once per (b, o) and branch."""
    levels = 2 * B * O
    return (d * (4 * passes - levels) + 4 * passes + B * O * d * 10
            + levels)


def ops_mp_linear_grads_as_read(B: int, d: int, O: int, passes: int) -> int:
    """A side figure, not the bound: the same work as the rule reads, with
    no threshold on |t|: per pass and operand t, |t| - z, the max with 0,
    its sum, the compare and its count (6), 4 per level and pass for the
    step, and per (b, o, i) u, v, four compares, two sign subtractions, two
    products by g / k and per sum an add and the accumulate (14)."""
    return B * O * d * 14 + passes * (6 * d + 4)


def ops_mp_linear_bwd_kernel_form(B: int, d: int, O: int,
                                  iters: int = 26) -> int:
    """A side figure, not the bound: f32 ops of a backward that runs its
    own levels pass, the forward's steps (``ops_mp_linear``) plus an exact
    solve of at least three passes per (b, o, i): a count (per branch the
    add, two compares and two adds: 10 for u and v), a sum (two selects
    more: 14) and a recount (10); then dx and dw, each per (b, o, i) the
    two operands, four compares, two sign subtractions, two products and
    the accumulate (11 each, 22). About 268 per (b, o, i)."""
    return ops_mp_linear(B, d, O, iters) + B * O * d * (10 + 14 + 10 + 22)


def ops_mp_linear_bwd_reference(B: int, d: int, O: int) -> int:
    """A side figure: f32 ops of the reference's rule as its jnp runs it,
    per (b, o) and branch the sort of 2d operands (2d log2(2d)
    compare-exchanges), the cumsum, the 2d candidate levels (sub, div)
    and compares, then per (b, o, i) the masks (two compares, a
    subtraction, a division per branch), g (m_u -+ m_v) and the two sums
    (12)."""
    m = 2 * d
    per_branch = m * max(1, math.ceil(math.log2(m))) + m + 3 * m
    return B * O * (2 * per_branch + 12 * d)


def newton_passes(x, w, gamma, iters: int, cap: int = 64):
    """(passes, z): per (b, o) and branch (u, v) the passes Newton from
    the left takes to the exact level of [t; -t] on these inputs, the
    last one the pass that finds the support's count unchanged, or back
    at the one of two passes before (an operand within rounding of the
    level, which the recomputed z then puts on either side in turn), and
    the level it ends at; blocked as the plain backward. Newton starts
    from the left end of the bracket that ``iters`` bisection steps leave
    (the forward's, as the plain version computes it). ``cap`` stops a
    level that has not settled (the most passes is printed beside)."""
    import torch
    from repro_torch.kernels import ref
    w = w.float()
    B, d = x.shape
    O = w.shape[1]
    passes = torch.zeros((B, O, 2), dtype=torch.int32, device=x.device)
    z_out = torch.empty((B, O, 2), dtype=torch.float32, device=x.device)
    ob = max(1, min(O, ref.LINEAR_BLOCK // max(1, B * d)))
    for o in range(0, O, ob):
        wb = w[:, o:o + ob].T[None]
        for j, t in enumerate((x[:, None, :] + wb, x[:, None, :] - wb)):
            L = torch.cat([t, -t], dim=-1)
            z = ref._mpabs_bracket(t, gamma, iters)[0]
            k_prev = k_prev2 = torch.full_like(z, -1.0)
            done = torch.zeros(z.shape, dtype=torch.bool, device=x.device)
            n = torch.zeros(z.shape, dtype=torch.int32, device=x.device)
            for _ in range(cap):
                above = L > z[..., None]
                k = above.sum(-1).float()
                n += (~done).int()
                done |= (k == k_prev) | (k == k_prev2)
                s = torch.where(above, L, 0.0).sum(-1)
                z = torch.where(done, z, (s - gamma) / k.clamp_min(1.0))
                k_prev2, k_prev = k_prev, k
                if bool(done.all()):
                    break
            passes[:, o:o + ob, j] = n
            z_out[:, o:o + ob, j] = z
    return passes, z_out


def phase_train_lm(cfg):
    """qwen3-8b at full width, depth 2, MP mode: ``make_train_step`` on
    one TokenStream batch (B = 2, S = 32), three steps, one more under the
    profiler, then one more whose grads passes are recorded (x, w, g and
    the forward's levels lv as ``ops.mp_linear``'s backward passes them)
    for ``phase_mp_backward``."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenStream
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_state, step = make_train_step(cfg, AdamWConfig(
        lr=3e-4, warmup_steps=1, total_steps=10))
    state = init_state(torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    n_params = T.param_count(state.params)
    toks = TokenStream(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0).batch(0)
    batch = {"tokens": torch.as_tensor(toks).to(dev)}
    per_step = 7 * cfg.num_layers + 1
    reset_launches()
    losses, norms, step_ms = [], [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(LAUNCHES)
    want = per_step * LM_STEPS
    if (launches["mp_linear"], launches["mp_linear_bwd"]) != (want, want):
        raise AssertionError(f"train step launches {launches}: want "
                             f"{per_step} forward and backward per step")
    if not (all(math.isfinite(v) for v in losses + norms)
            and losses[-1] < losses[0]):
        raise AssertionError(f"train step: losses {losses}, grad norms "
                             f"{norms}")
    # under grad every forward launch writes levels; the backward runs the
    # grads pass and its partials' sum, and no bisection. A profile that
    # traced nothing on the device (torch.profiler has been seen to return
    # no device records at all) is taken again on another step, twice at
    # most; the recorded step below checks the forwards' levels at the
    # wrapper whatever the profiler gives.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            prof_ms = (time.perf_counter() - t0) * 1e3
        parts = {"forward_with_levels": 0.0, "forward_alone": 0.0,
                 "backward_grads": 0.0, "other": 0.0}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            t = getattr(e, "self_device_time_total", 0.0) * 1e-3
            lv = re.search(r"mp_linear_kernel<.*,\s*(true|false)>", e.key)
            if lv:
                parts["forward_with_levels" if lv.group(1) == "true"
                      else "forward_alone"] += t
            elif ("mp_linear_grads_kernel" in e.key
                  or "mp_linear_dx_sum_kernel" in e.key):
                parts["backward_grads"] += t
            else:
                parts["other"] += t
        busy = sum(parts.values())
        if busy:
            break
    else:
        log("train_lm: the profiler traced nothing on the device in 3 "
            "steps; the step's device split is not measured")
        parts = None
    if parts and (parts["forward_alone"]
                  or not parts["forward_with_levels"]):
        raise AssertionError(f"train step: forward kernels {parts}: every "
                             "forward under grad must write levels")
    log(dict(phase="train_lm", arch=cfg.name, layers=cfg.num_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size, mp_mode=True,
             batch=LM_BATCH, seq=LM_SEQ, params=n_params,
             losses=losses, grad_norms=norms, ms_per_step=step_ms,
             profiled_step_ms=prof_ms, device_ms=parts,
             device_busy_ms=busy,
             grads_share_of_device=parts["backward_grads"] / busy
             if parts else None,
             mp_linear_launches=launches["mp_linear"],
             mp_linear_bwd_launches=launches["mp_linear_bwd"],
             peak_memory_bytes=torch.cuda.max_memory_allocated()))
    calls, fwd_levels = [], []
    real, real_fwd = ops.mp_linear_grads_kernel, ops.mp_linear_kernel

    def record(x, w, g, lv):
        # detached: a saved tensor would hold the step's autograd graph
        calls.append((x.detach(), w.detach(), g.detach(), lv.detach()))
        return real(x, w, g, lv)

    def record_fwd(*args, **kw):
        fwd_levels.append(bool(kw.get("levels", False)))
        return real_fwd(*args, **kw)

    ops.mp_linear_grads_kernel, ops.mp_linear_kernel = record, record_fwd
    try:
        state, m = step(state, batch)
        float(m["loss"])
    finally:
        ops.mp_linear_grads_kernel, ops.mp_linear_kernel = real, real_fwd
    if len(calls) != per_step:
        raise AssertionError(f"recorded {len(calls)} backward calls, want "
                             f"{per_step}")
    if fwd_levels != [True] * per_step:
        raise AssertionError(f"train step forwards' levels {fwd_levels}: "
                             f"every forward under grad must write levels")
    del state, m
    gc.collect()
    torch.cuda.empty_cache()
    return (launches["mp_linear_bwd"], parts and parts["backward_grads"],
            calls)


def phase_mp_backward(calls, layers: int, gamma: float):
    """The backward against its plain version on the grads passes of one
    depth-``layers`` train step (``phase_train_lm``'s record: the step's
    own x, w, g and the levels its forward wrote), pass by pass; returns
    its kernels-line row (ms: the grads launch plus what the levels add to
    the forward, plain ms and bound summed over those calls)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mp_kernels import (mp_linear_grads_kernel,
                                                mp_linear_kernel)
    iters = ref.DEFAULT_ITERS
    row = dict(name="mp_linear_bwd", max_abs_err=0.0, ms=0.0, plain_ms=0.0,
               grads_ms=0.0, levels_added_ms=0.0, forward_ms=0.0,
               forward_with_levels_ms=0.0, plain_grads_ms=0.0,
               memory_allocated_at_start=torch.cuda.memory_allocated())
    ops = ops_read = ops_kernel = ops_ref = nbytes = 0.0
    fwd_ops = fwd_nbytes = 0.0
    per_call = []
    for x, w, gy, lv in calls:
        t_call = time.perf_counter()
        (B, d), O = x.shape, w.shape[1]
        wf = w.float()
        # the levels-writing forward: y the forward alone's, bit for bit,
        # and the step's own levels again
        y_lv, lv2 = mp_linear_kernel(x, w, gamma, iters, levels=True)
        y_same = bool(torch.equal(y_lv, mp_linear_kernel(x, w, gamma, iters)))
        lv_same = bool(torch.equal(lv2, lv))
        del y_lv, lv2
        dx, dw = mp_linear_grads_kernel(x, w, gy, lv)
        dx2, dw2 = mp_linear_grads_kernel(x, w, gy, lv)
        twice = bool(torch.equal(dx, dx2) and torch.equal(dw, dw2))
        del dx2, dw2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_dx, want_dw = ref.mp_linear_bwd(x, wf, gy, gamma)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        want_lv = ref.mp_linear_levels(x, wf, gamma)
        zk, zp = lv[..., :2], want_lv[..., :2]
        z_gap = float(((zk - zp).abs() / (1 + zp.abs())).max())
        near = ref.mp_linear_near_level(x, wf, zp, LEVEL_TOL)
        k_off = int(((lv[..., 2:] != want_lv[..., 2:]) & ~near).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        own_dx, own_dw = ref.mp_linear_bwd_from_levels(x, wf, gy, lv)
        torch.cuda.synchronize()
        pg_ms = (time.perf_counter() - t0) * 1e3
        # every gate at KERNEL_TOL x the compared tensor's own max: the
        # step's gradients lie far below 1, where 1e-5 x (1 + max) would
        # hold nothing (nor tell the control from the kernel)
        t_dx = KERNEL_TOL * float(own_dx.abs().max())
        t_dw = KERNEL_TOL * float(own_dw.abs().max())
        e_dx = float((dx - own_dx).abs().max())
        e_dw = float((dw - own_dw).abs().max())
        # against the plain version, elementwise on the rows of dx and the
        # columns of dw that no near-level branch feeds
        tie = near.any(-1)
        rows, cols = ~tie.any(1), ~tie.any(0)
        clean = (float((dx[rows] - want_dx[rows]).abs().max())
                 if rows.any() else 0.0,
                 float((dw[:, cols] - want_dw[:, cols]).abs().max())
                 if cols.any() else 0.0)
        tol_dx = KERNEL_TOL * float(want_dx.abs().max())
        tol_dw = KERNEL_TOL * float(want_dw.abs().max())
        # the control: dv's sign flipped on the kernel's own levels
        flip = lv.clone()
        flip[..., 3] = -flip[..., 3]
        c_dx, c_dw = ref.mp_linear_bwd_from_levels(x, wf, gy, flip)
        ctl = (float((c_dx - own_dx).abs().max()),
               float((c_dw - own_dw).abs().max()))
        # the bound's form on these inputs: Newton's passes from the
        # forward's bracket, and its levels
        passes, z_newton = newton_passes(x, w, gamma, iters)
        n_gap = float(((z_newton - zp).abs() / (1 + zp.abs())).max())
        fails = []
        if not (y_same and lv_same):
            fails.append(f"levels forward: y the same bits {y_same}, the "
                         f"step's levels again {lv_same}")
        if not twice:
            fails.append("the grads pass gave other bits a second time")
        if not z_gap <= LEVEL_TOL:
            fails.append(f"levels {z_gap}")
        if k_off:
            fails.append(f"{k_off} supports off the sort's away from a tie")
        if not (e_dx <= t_dx and e_dw <= t_dw):
            fails.append(f"dx {e_dx} / dw {e_dw} on its own levels")
        if not (clean[0] <= tol_dx and clean[1] <= tol_dw):
            fails.append(f"dx {clean[0]} / dw {clean[1]} vs plain off ties")
        if not (ctl[0] > t_dx and ctl[1] > t_dw):
            fails.append(f"the flipped control passes: {ctl}")
        if not n_gap <= LEVEL_TOL:
            fails.append(f"the bound's Newton levels {n_gap} off the sort's")
        if fails:
            raise AssertionError(
                f"mp_linear_bwd B={B} d={d} O={O} (call {len(per_call)}): "
                + "; ".join(fails) + f"; gates dx {t_dx} / {tol_dx}, dw "
                f"{t_dw} / {tol_dw}")
        reps = 3 if O > 50000 else 5
        f_ms = cuda_ms(lambda: mp_linear_kernel(x, w, gamma, iters), reps)
        # the forward alone against its own bound at these train shapes:
        # the cheapest exact bisection step, x and w read once, y written
        f_ops = ops_mp_linear(B, d, O, iters)
        f_nb = 4 * B * d + w.element_size() * d * O + 4 * B * O
        f_b_ms, _ = bound_ms(f_ops, f_nb)
        fl_ms = cuda_ms(lambda: mp_linear_kernel(x, w, gamma, iters,
                                                 levels=True), reps)
        g_ms = cuda_ms(lambda: mp_linear_grads_kernel(x, w, gy, lv), reps)
        k_ms = g_ms + fl_ms - f_ms
        nb = (4 * B * d * 2 + w.element_size() * d * O + 4 * B * O
              + 4 * d * O)
        n_passes = int(passes.sum())
        c_ops = ops_mp_linear_grads(B, d, O, n_passes)
        c_read = ops_mp_linear_grads_as_read(B, d, O, n_passes)
        b_ms, _ = bound_ms(c_ops, nb)
        err = max(float((dx - want_dx).abs().max()),
                  float((dw - want_dw).abs().max()))
        per_call.append(dict(
            B=B, d=d, O=O, w=str(w.dtype).replace("torch.", ""), ms=k_ms,
            grads_ms=g_ms, forward_ms=f_ms, forward_bound_ms=f_b_ms,
            forward_x_bound=f_ms / f_b_ms, forward_with_levels_ms=fl_ms,
            plain_ms=p_ms, plain_grads_ms=pg_ms, bound_ms=b_ms,
            x_bound=k_ms / b_ms, bound_ms_as_read=bound_ms(c_read, nb)[0],
            newton_passes_from_bracket_mean=n_passes / passes.numel(),
            newton_passes_from_bracket_max=int(passes.max()),
            max_abs_err=err, max_abs_err_own_levels=max(e_dx, e_dw),
            max_abs_err_off_ties=max(clean), level_gap=z_gap,
            newton_level_gap=n_gap, branches_near_a_level=int(near.sum()),
            pairs_near_a_level=int(tie.sum()),
            dx_rows_checked=int(rows.sum()), dw_cols_checked=int(cols.sum()),
            gates=(t_dx, t_dw, tol_dx, tol_dw), control_err=ctl,
            check_s=time.perf_counter() - t_call))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += k_ms
        row["grads_ms"] += g_ms
        row["levels_added_ms"] += fl_ms - f_ms
        row["forward_ms"] += f_ms
        fwd_ops += f_ops
        fwd_nbytes += f_nb
        row["forward_with_levels_ms"] += fl_ms
        row["plain_ms"] += p_ms
        row["plain_grads_ms"] += pg_ms
        ops += c_ops
        ops_read += c_read
        ops_kernel += ops_mp_linear_bwd_kernel_form(B, d, O, iters)
        ops_ref += ops_mp_linear_bwd_reference(B, d, O)
        nbytes += nb
        del dx, dw, want_dx, want_dw, want_lv, own_dx, own_dw, c_dx, c_dw
        del passes, z_newton, near, flip
    row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes)
    row["bound_ms_as_read"] = bound_ms(ops_read, nbytes)[0]
    row["bound_ms_levels_pass_form"] = bound_ms(ops_kernel, nbytes)[0]
    row["bound_ms_reference_algorithm"] = bound_ms(ops_ref, nbytes)[0]
    row["x_bound"] = row["ms"] / row["bound_ms"]
    row["forward_bound_ms"], row["forward_bound_by"] = bound_ms(fwd_ops,
                                                                fwd_nbytes)
    row["forward_x_bound"] = row["forward_ms"] / row["forward_bound_ms"]
    row["calls"] = (f"one depth-{layers} train step's {len(calls)} "
                    f"backward calls: {per_call}")
    log({"kernel_vs_plain": row})
    torch.cuda.empty_cache()
    return row


# -- decode in MP mode: qwen3-8b and the rest of the zoo (MoE, Mamba-2, the
# hybrid, the VLM), then the audio encoder, each at full width -------------


DECODE = (
    # arch, layers served (None: all), the f32 gate (x max |plain|), the
    # control's bisection steps (it must miss the gate), why. The gate is
    # 1e-3 with a 22-step control where that control misses it; mamba2's
    # 22-step control lands within 1e-3 (5.3e-4 / 6.6e-4 at pos 0 / 4 on
    # the H100), so its gate is the stricter 2e-4
    ("qwen3-8b", None, DECODE_TOL, CONTROL_GATE_ITERS, "dense: 36 layers, "
     "SwiGLU, the f32 head"),
    ("deepseek-moe-16b", None, DECODE_TOL, CONTROL_GATE_ITERS, "MoE: a "
     "peeled dense layer, 2 shared + 64 routed experts top-6"),
    ("mamba2-2.7b", None, 2e-4, CONTROL_GATE_ITERS, "SSM: the SSD decode "
     "state, a tied head"),
    # 52 G f32 masters do not fit one card: one period (1 attention, 7
    # Mamba, 4 MoE layers of 16 experts)
    ("jamba-v0.1-52b", 8, DECODE_TOL, CONTROL_GATE_ITERS, "the periodic "
     "plan"),
    ("internvl2-2b", None, DECODE_TOL, CONTROL_GATE_ITERS, "the VLM prefix "
     "(16 patches), then decode"),
)
VLM_PATCHES = 16          # cut from internvl2's 1,024: a length, not a shape
HUBERT_FRAMES = 64
HUBERT_GATE_LAYERS = 4    # the encoder's f32 gate runs the first 4 of 48
# the encoder's gate, 3e-5 with a 22-step control: the f32 sums over d =
# 1,280-5,120 bound how far 26 steps get ahead of fewer. On the H100, at 4
# layers (and at 12), the kernel sits 1.9e-5 from the plain version and a
# 22-step solve 5.1e-5, so 3e-5 leaves ~1.6x on either side
HUBERT_GATE = (3e-5, CONTROL_GATE_ITERS)
DECODE_B, DECODE_PROMPT, DECODE_GEN = 2, 4, 4


def mp_cfg(arch: str, layers=None):
    """``arch`` at full width in MP mode (gamma 8, its bf16 compute),
    ``layers`` deep if given."""
    from repro_torch.configs import get_arch
    cfg = dataclasses.replace(get_arch(arch), mp_mode=True,
                              mp_gamma=MP_GAMMA)
    return cfg if layers is None else dataclasses.replace(
        cfg, num_layers=layers)


def mp_launches_per_step(cfg) -> int:
    """The mp_linear calls of one decode step (or one forward) as the
    layer plan gives them: 4 per attention mixer, 2 per Mamba mixer, a
    dense FFN's projections (3 SwiGLU, 2 GELU), a MoE FFN's shared
    experts (one SwiGLU, 3; the router and the routed experts are torch
    products), and the head."""
    from repro_torch.models.transformer import _layer_plan
    plan = _layer_plan(cfg)

    def layer(mixer, is_moe):
        n = 4 if mixer == "attn" else 2
        if is_moe:
            return n + (3 if cfg.num_shared_experts else 0)
        return n + ((2 if cfg.norm == "ln" else 3) if cfg.d_ff > 0 else 0)

    if plan["kind"] == "uniform":
        n = (plan["n_prefix"] * layer("attn", False)
             + plan["n_scan"] * layer(plan["mixer"], plan["is_moe"]))
    else:
        n = plan["n_groups"] * sum(layer(m, e) for m, e in plan["subs"])
    return n + 1


def clone_tree(t):
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [clone_tree(v) for v in t]
    return t.clone()


def mp_calls(fn) -> dict:
    """Run ``fn()`` with ``models.layers.mp_linear`` recording its calls:
    {(rows, d, O, w dtype): [x (rows, d), w, calls]}, the first call's
    operands kept per shape."""
    from unittest import mock

    import torch
    from repro_torch.models import layers
    real = layers.mp_linear
    seen = {}

    def rec(x, w, gamma, **kw):
        x2 = x.reshape(-1, x.shape[-1])
        key = (x2.shape[0], x2.shape[1], w.shape[1],
               str(w.dtype).replace("torch.", ""))
        ent = seen.setdefault(key, [x2.detach().clone(), w.detach(), 0])
        ent[2] += 1
        return real(x, w, gamma, **kw)

    with torch.no_grad(), mock.patch.object(layers, "mp_linear", rec):
        fn()
    return seen


def mp_shapes_row(seen: dict, gamma: float, what: str) -> dict:
    """mp_linear against its plain version on each recorded shape's
    operands (the main path's own x and w), gated at KERNEL_TOL; kernel
    ms by CUDA events, plain ms, and the bound at these shapes
    (``ops_mp_linear``: the cheapest exact step; x, w read once, y
    written), each summed over the calls of one step."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.mp_kernels import mp_linear_kernel
    import torch
    row = dict(name="mp_linear", at=what, max_abs_err=0.0, ms=0.0,
               plain_ms=0.0)
    ops = nbytes = 0.0
    shapes = []
    for (rows, d, O, wdt), (x, w, n) in seen.items():
        got = mp_linear_kernel(x, w, gamma)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref.mp_linear(x, w.float(), gamma)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        err, tol = max_err(got, want)
        if not err <= tol:
            raise AssertionError(f"mp_linear {what} rows={rows} d={d} O={O} "
                                 f"w={wdt}: max |diff| {err} > {tol}")
        k_ms = cuda_ms(lambda: mp_linear_kernel(x, w, gamma),
                       3 if rows * d * O > 2e9 else 10)
        nb = 4 * rows * d + w.element_size() * d * O + 4 * rows * O
        b_ms, _ = bound_ms(ops_mp_linear(rows, d, O), nb)
        shapes.append(dict(rows=rows, d=d, O=O, w=wdt, calls=n, ms=k_ms,
                           plain_ms=p_ms, bound_ms=b_ms, x_bound=k_ms / b_ms,
                           max_abs_err=err))
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"] += n * k_ms
        row["plain_ms"] += n * p_ms
        ops += n * ops_mp_linear(rows, d, O)
        nbytes += n * nb
    row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes)
    row["x_bound"] = row["ms"] / row["bound_ms"]
    row["shapes"] = shapes
    return row


def mp_device_ms(fn) -> dict:
    """``fn()`` once under torch.profiler: mp_linear's device ms, the
    copies' (the per-step bf16 weight casts, the cache copies), every
    kernel's, and the ten longest (None where nothing was traced)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = sorted(((getattr(e, "self_device_time_total", 0.0), e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(t for t, _ in by_name)
    if not busy:
        return dict(mp_linear=None, copies=None, busy=None, top=None)
    return dict(mp_linear=sum(t for t, k in by_name
                              if "mp_linear_kernel" in k) * 1e-3,
                copies=sum(t for t, k in by_name if "copy" in k) * 1e-3,
                busy=busy * 1e-3,
                top=[(k[:90], t * 1e-3) for t, k in by_name[:10]])


def routes_of(scores: list, k: int) -> list:
    """The expert ids picked from each recorded (T, E) score tensor."""
    import torch
    return [torch.sort(s, dim=-1, descending=True, stable=True)
            .indices[:, :k].cpu() for s in scores]


def gated_run(fn, moe_routes: bool):
    """``fn(mp)`` under no_grad with ``models.layers.mp_linear`` swapped
    for ``mp`` (the kernel when None): (result as float32, scores). With
    ``moe_routes`` the MoE layers' own selection scores are recorded, and
    every run but the plain version's selects by the last plain run's
    scores (the same experts; its gates, from its own logits, stay its
    own): a gap then measures the products, and a selection of its own
    that differs (~1e-6 of sum order moving a score across the 2^-10
    grid) shows in its scores. The MoE router runs in float32 here: as
    the reference's, it is a bf16 product whatever the compute dtype,
    which rounds its input to bf16, so those ~1e-6 differences would move
    a router logit by a bf16 step now and then."""
    import contextlib
    from unittest import mock

    import torch
    from repro_torch.models import layers, moe
    plain_scores = []

    def run(mp=None):
        scores = []
        real = moe._route_scores

        def rec(logits):
            s = real(logits)
            scores.append(s.detach().clone())
            if mp is plain_mp or len(plain_scores) < len(scores):
                return s
            return plain_scores[len(scores) - 1]

        swap = (mock.patch.object(layers, "mp_linear", mp) if mp
                else contextlib.nullcontext())
        keep = (mock.patch.object(moe, "_route_scores", rec)
                if moe_routes else contextlib.nullcontext())
        f32_router = mock.patch.dict(layers.linear.__kwdefaults__,
                                     {"compute_dtype": torch.float32})
        with torch.no_grad(), swap, keep, f32_router:
            out = fn().float()
        torch.cuda.synchronize()
        if mp is plain_mp:
            plain_scores[:] = scores
        return out, scores

    return run


def plain_mp(x, w, gamma):
    from repro_torch.kernels import ref
    y = ref.mp_linear(x.reshape(-1, x.shape[-1]), w, gamma)
    return y.reshape(*x.shape[:-1], w.shape[1])


def coarse_mp(iters: int):
    from repro_torch.kernels import ops

    def mp(x, w, gamma):
        return ops.mp_linear(x, w, gamma, iters=iters)
    return mp


def gap_row(run) -> tuple:
    """The kernel against the plain version through ``run`` (from
    ``gated_run``; the plain version first, whose routes the kernel's run
    takes), timed on the host: (the row, both outputs, both scores)."""
    t0 = time.perf_counter()
    want, s_p = run(plain_mp)
    p_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, s_k = run()
    k_s = time.perf_counter() - t0
    top = float(want.abs().max())
    diff = float((got - want).abs().max())
    return dict(max_abs_diff=diff, max_abs_plain=top, rel=diff / top,
                kernel_s=k_s, plain_s=p_s), got, want, s_k, s_p


def gate_row(run, k: int | None, name: str, tol: float, control: int,
             experts_gated: bool = True) -> dict:
    """``gap_row`` gated: within ``tol`` x max |plain|, the control (the
    kernel at ``control`` bisection steps) outside it, the outputs finite
    and, for MoE (``k`` experts per token), the same expert ids chosen by
    both on their own scores (printed only, if not ``experts_gated``);
    the controls of CONTROL_ITERS printed. Returns the row with its
    ``fails``."""
    import torch
    row, got, want, s_k, s_p = gap_row(run)
    top = row["max_abs_plain"]
    controls = {it: float((run(coarse_mp(it))[0] - want).abs().max())
                / top for it in sorted({*CONTROL_ITERS, control},
                                       reverse=True)}
    row = dict(check=name, **row, gate=tol, control_iters=control,
               control_rel=controls)
    fails = []
    if not bool(torch.isfinite(got).all()):
        fails.append("not finite")
    if not row["rel"] <= tol:
        fails.append(f"kernel vs plain {row['max_abs_diff']} > {tol} x "
                     f"{top}")
    if not controls[control] > tol:
        fails.append(f"the gate cannot tell a {control}-step solve from "
                     f"the kernel: {controls}")
    if k is not None:
        ids_k, ids_p = routes_of(s_k, k), routes_of(s_p, k)
        row["moe_calls"] = len(ids_k)
        row["experts_identical"] = (len(ids_k) == len(ids_p) > 0 and all(
            torch.equal(a, b) for a, b in zip(ids_k, ids_p)))
        row["experts_gated"] = experts_gated
        row["routes_differing"] = sum(
            int((a != b).any(-1).sum()) for a, b in zip(ids_k, ids_p))
        if experts_gated and not row["experts_identical"]:
            fails.append("the kernel path and the plain path chose other "
                         "experts")
    row["fails"] = fails
    return row


def free_card() -> int:
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def init_params(cfg):
    """``cfg``'s seeded random f32 masters on the card, and the seconds."""
    import torch
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def held_forward(params, cfg, batch: dict, positions: int) -> tuple:
    """``forward`` over ``batch``, warm, then timed: its launches against
    the layer plan, the logits finite and (B, positions, padded vocab);
    its mp_linear calls recorded and each shape held against the plain
    version, its device time by the profiler. Returns (the phase's
    fields, the kernels-line row)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer as T
    per_fwd = mp_launches_per_step(cfg)
    B = next(iter(batch.values())).shape[0]

    def fwd():
        return T.forward(params, cfg, batch)

    with torch.no_grad():
        fwd()                                               # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        lg = fwd()
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    launches = LAUNCHES["mp_linear"]
    finite = bool(torch.isfinite(lg.float()).all())
    if launches != per_fwd or not finite or tuple(lg.shape) != (
            B, positions, cfg.padded_vocab):
        raise AssertionError(f"{cfg.name} forward: {launches} launches "
                             f"(want {per_fwd}), logits {tuple(lg.shape)}, "
                             f"finite {finite}")
    del lg
    seen = mp_calls(fwd)
    row = mp_shapes_row(seen, cfg.mp_gamma, f"{cfg.name} forward")
    del seen
    dev_ms = mp_device_ms(fwd)
    row.update(launches=launches, device_ms=dev_ms["mp_linear"],
               device_timed_by="profiler" if dev_ms["mp_linear"] else None)
    fields = dict(forward_ms=fwd_ms, forward_positions=positions,
                  forward_mp_linear_launches=launches,
                  forward_mp_linear_launches_by_plan=per_fwd,
                  forward_mp_linear_device_ms=dev_ms["mp_linear"],
                  forward_device_busy_ms=dev_ms["busy"],
                  forward_mp_linear_ms=row["ms"],
                  forward_mp_linear_bound_ms=row["bound_ms"],
                  forward_mp_linear_x_bound=(
                      dev_ms["mp_linear"] / row["bound_ms"]
                      if dev_ms["mp_linear"] else None),
                  forward_mp_linear_plain_ms=row["plain_ms"])
    return fields, row


def phase_decode(arch: str, layers, tol: float, control: int, why: str,
                 card: str) -> tuple:
    """One config (``DECODE``) served by ``serve_decode`` (B = 2, 4 prompt
    + 4 generated, greedy, MP mode, bf16 compute, seeded random f32
    masters on the card): launches per step against the layer plan,
    every logit finite; one served step's mp_linear calls recorded and
    each shape held against the plain version, its device time by the
    profiler. The gate: f32-compute steps through the kernel at pos 0 and
    pos 4 (over the prompt's cache), and at pos 4 again with each layer's
    weights cast to bf16 as the served step casts them (so that the
    kernel reads bf16 w as when served), within ``tol`` x max |plain| of
    the plain version's, the ``control``-step solve outside, the same
    experts chosen; the bf16 served step's gap at pos 4 printed, not
    gated. For the VLM, first a ``forward`` over 16 patches and the
    prompt, held the same way (``held_forward``, its f32 forward gated).
    Returns (the phase's line, its kernels-line rows)."""
    import contextlib
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_decode
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    resident = free_card()
    cfg = mp_cfg(arch, layers)
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    params, init_s = init_params(cfg)
    per_step = mp_launches_per_step(cfg)
    k = cfg.num_experts_per_tok if cfg.num_experts else None
    B, prompt_len, gen = DECODE_B, DECODE_PROMPT, DECODE_GEN
    out = dict(phase="decode", arch=cfg.name, family=cfg.family, why=why,
               layers=cfg.num_layers, layers_full=mp_cfg(arch).num_layers,
               d_model=cfg.d_model, vocab=cfg.vocab_size,
               mp_gamma=cfg.mp_gamma, compute_dtype=cfg.compute_dtype,
               batch=B, prompt_len=prompt_len, gen=gen,
               params=T.param_count(params),
               active_params=T.active_param_count(cfg, params),
               param_bytes=4 * T.param_count(params),
               memory_resident_before=resident, init_s=init_s, card=card)
    rows, gates = [], []
    if cfg.vlm_patches:
        # the VLM's prefix: 16 patch embeddings before the prompt's tokens
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, prompt_len)), dtype=torch.int32,
            device=dev)
        batch = {"tokens": toks, "patches": torch.randn(
            B, VLM_PATCHES, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))}
        fields, row = held_forward(params, cfg, batch,
                                   VLM_PATCHES + prompt_len)
        out.update(fields)
        rows.append(row)
        gates.append(gate_row(
            gated_run(lambda: T.forward(params, c32, batch), False), None,
            f"{arch} f32 forward over {VLM_PATCHES} patches", tol, control))
        del batch
    serve_decode(cfg, params, B, 1, 0, seed=1)             # warm-up
    reset_launches()
    res = serve_decode(cfg, params, B, prompt_len, gen, seed=0)
    launches = LAUNCHES["mp_linear"]
    steps = prompt_len + gen
    if launches != per_step * steps:
        raise AssertionError(f"{arch}: mp_linear launched {launches} times "
                             f"in {steps} steps (want {per_step} per step)")
    for i, lg in enumerate(res.logits):
        if tuple(lg.shape) != (B, cfg.vocab_size) or \
                not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{arch} step {i}: logits "
                                 f"{tuple(lg.shape)} not finite / of the "
                                 "wrong shape")
    out.update(prefill_ms=res.prefill_s * 1e3,
               prefill_ms_per_step=res.prefill_s * 1e3 / prompt_len,
               decode_ms_per_step=res.decode_s * 1e3 / gen,
               tokens_per_s=B * gen / res.decode_s,
               mp_linear_launches=launches, mp_linear_launches_per_step=
               launches / steps, mp_linear_launches_per_step_by_plan=per_step,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               generated=res.tokens.tolist())

    prompts = torch.as_tensor(res.prompts, dtype=torch.int32, device=dev)
    first = torch.as_tensor(res.tokens[:, :1], dtype=torch.int32,
                            device=dev)

    def at(i):
        return torch.full((B,), i, dtype=torch.int32, device=dev)

    def casts(bf16_w: bool):
        """Each layer's weights cast to bf16 whatever the compute dtype
        (``_constrain`` as the served step runs it), if ``bf16_w``."""
        if not bf16_w:
            return contextlib.nullcontext()
        real = T._constrain
        return mock.patch.object(T, "_constrain", lambda p, c: real(
            p, dataclasses.replace(c, compute_dtype="bfloat16")))

    def prompt_cache(c, n, bf16_w=False):
        cache = T.init_cache(c, B, prompt_len + 1, device=dev)
        with torch.no_grad(), casts(bf16_w):
            for i in range(n):
                _, cache = T.decode_step(params, c, prompts[:, i:i + 1],
                                         cache, at(i))
        return cache

    def stepper(c, cache, i, bf16_w=False):
        tok = prompts[:, :1] if i == 0 else first

        def step():
            with casts(bf16_w):
                return T.decode_step(params, c, tok, clone_tree(cache),
                                     at(i))[0]
        return step

    # one served step at the first generated position: its calls, each
    # shape against the plain version on its own operands, its device
    # time by the profiler, and its gap from the plain version's step
    served = stepper(cfg, prompt_cache(cfg, prompt_len), prompt_len)
    seen = mp_calls(served)
    if sum(n for _, _, n in seen.values()) != per_step:
        raise AssertionError(f"{arch}: recorded {seen.keys()} calls")
    row = mp_shapes_row(seen, cfg.mp_gamma, f"{cfg.name} decode step")
    del seen
    dev_ms = mp_device_ms(served)
    row.update(launches=launches, device_ms=dev_ms["mp_linear"],
               device_timed_by="profiler" if dev_ms["mp_linear"] else None)
    rows.insert(0, row)
    out.update(mp_linear_device_ms_per_step=dev_ms["mp_linear"],
               copy_device_ms_per_step=dev_ms["copies"],
               device_busy_ms_per_step=dev_ms["busy"],
               top_kernels_per_step=dev_ms["top"],
               mp_linear_ms_per_step=row["ms"],
               mp_linear_bound_ms_per_step=row["bound_ms"],
               mp_linear_x_bound=(dev_ms["mp_linear"] / row["bound_ms"]
                                  if dev_ms["mp_linear"] else None),
               mp_linear_plain_ms_per_step=row["plain_ms"],
               bf16_step_vs_plain=gap_row(gated_run(served,
                                                    k is not None))[0])
    del served

    # the gate: f32-compute steps at pos 0 and pos 4, full depth, and at
    # pos 4 with the served step's bf16 weights (its experts printed: a
    # route flipped there by the sum order is no fault of the product)
    for name, i, bf16_w in (("f32", 0, False), ("f32", prompt_len, False),
                            ("f32, bf16 w", prompt_len, True)):
        step = stepper(c32, prompt_cache(c32, i, bf16_w), i, bf16_w)
        gates.append(dict(gate_row(gated_run(step, k is not None), k,
                                   f"{arch} {name} step at pos {i}", tol,
                                   control, experts_gated=not bf16_w),
                          pos=i))
        del step
    out["gate"] = gates
    log(out)
    for r in rows:
        log({"kernel_vs_plain": r})
    del params, res
    free_card()
    fails = [f"{c['check']}: {'; '.join(c['fails'])}" for c in gates
             if c["fails"]]
    if fails:
        raise AssertionError(" | ".join(fails))
    return out, rows


def phase_encoder(card: str) -> dict:
    """hubert-xlarge at full width and depth (48 layers) in MP mode:
    ``forward`` over B = 2 x 64 frames (bf16 compute, seeded f32 masters)
    through ``held_forward`` (289 launches: 6 per layer and the head; the
    frame projection is a torch product); and, on the first 4 layers,
    the f32-compute forward through the kernel within ``HUBERT_GATE``'s
    3e-5 x max |plain| of the plain version's, the 22-step control
    outside. Returns the kernels-line row."""
    import torch
    from repro_torch.models import transformer as T
    dev = torch.device("cuda")
    resident = free_card()
    cfg = mp_cfg("hubert-xlarge")
    params, init_s = init_params(cfg)
    B = DECODE_B
    frames = torch.randn(B, HUBERT_FRAMES, cfg.d_model, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    batch = {"frames": frames}
    fields, row = held_forward(params, cfg, batch, HUBERT_FRAMES)
    c32 = dataclasses.replace(cfg, compute_dtype="float32",
                              num_layers=HUBERT_GATE_LAYERS)
    cut = dict(params, layers=params["layers"][:HUBERT_GATE_LAYERS])
    gate = gate_row(gated_run(lambda: T.forward(cut, c32, batch), False),
                    None, f"hubert f32 forward, first {HUBERT_GATE_LAYERS} "
                    "layers", *HUBERT_GATE)
    out = dict(phase="encoder", arch=cfg.name, family=cfg.family,
               layers=cfg.num_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, mp_gamma=cfg.mp_gamma,
               compute_dtype=cfg.compute_dtype, batch=B,
               frames=HUBERT_FRAMES, params=T.param_count(params),
               memory_resident_before=resident, init_s=init_s, **fields,
               frames_per_s=B * HUBERT_FRAMES / (fields["forward_ms"] * 1e-3),
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               gate=dict(gate, layers=HUBERT_GATE_LAYERS), card=card)
    log(out)
    log({"kernel_vs_plain": row})
    del params, cut, batch, frames
    free_card()
    if gate["fails"]:
        raise AssertionError(f"{gate['check']}: " + "; ".join(gate["fails"]))
    return row


# -- the fixed-point IR and static-analysis tier --------------------------------

IR_COMMITTED = {"oneshot_q": "oneshot_q", "session_step_q": "session_step_q",
                "oneshot_q_cascade": "oneshot_q_pallas",
                "stream_cascade_q": "stream_pallas"}
IR_CLIPS = 8
IR_STEPS = 100            # chunks of CHUNK_LEN: one second of one clip


def ir_committed(target: str) -> dict:
    path = ROOT / "artifacts" / "ir" / IR_COMMITTED[target] / "ir.json"
    doc = json.loads(path.read_text())
    return {k: doc[k] for k in ("census", "num_instrs", "num_registers")}


def ir_gate_intervals(name: str, got: dict, want: dict) -> dict:
    """Out intervals inside the committed ones (tighter ones named), the
    same max_required_bits, no overflow."""
    if not got["ok"] or got["violations"]:
        raise AssertionError(f"IR {name}: interval proof failed: "
                             f"{got['violations'][:3]}")
    if len(got["out_intervals"]) != len(want["out_intervals"]):
        raise AssertionError(f"IR {name}: {len(got['out_intervals'])} "
                             f"outputs, committed {len(want['out_intervals'])}")
    tighter = []
    for i, (g, w) in enumerate(zip(got["out_intervals"],
                                   want["out_intervals"])):
        if g[0] < w[0] or g[1] > w[1]:
            raise AssertionError(f"IR {name}: out interval {i} {g} wider "
                                 f"than the committed {w}")
        if g != w:
            tighter.append(dict(output=i, port=g, committed=w))
    if got["max_required_bits"] != want["max_required_bits"]:
        raise AssertionError(
            f"IR {name}: max_required_bits {got['max_required_bits']}, "
            f"committed {want['max_required_bits']}")
    return dict(out_intervals=got["out_intervals"],
                max_required_bits=got["max_required_bits"],
                min_headroom_bits=got["min_headroom_bits"], tighter=tighter)


def golden_like_program():
    """A program of the golden ``esc_mp_bisect`` case's shape (fs 4 kHz, 2
    octaves, 2 filters, bisection; 600 samples), its weights drawn by the
    port from seeds (the golden weights come from JAX's PRNG)."""
    import numpy as np
    import torch
    from repro_torch.core import fixed as fx
    from repro_torch.core import kernel_machine as km
    from repro_torch.core.filterbank import FilterBank, FilterBankConfig
    from repro_torch.core.pipeline import InFilterPipeline
    cfg = FilterBankConfig(fs=4000.0, num_octaves=2, filters_per_octave=2,
                           mode="mp", gamma_f=4.0, solver="bisect")
    fb = FilterBank(cfg, device="cpu")
    P = cfg.num_filters
    rng = np.random.default_rng(13)
    clf = km.init_params(torch.Generator().manual_seed(13), P, 5)
    mu = torch.from_numpy((rng.standard_normal(P) * 0.1).astype(np.float32))
    sigma = torch.from_numpy(
        (np.abs(rng.standard_normal(P)) + 0.5).astype(np.float32))
    pipe = InFilterPipeline.from_filterbank(fb, clf, mu, sigma)
    x = rng.standard_normal((1, 600)).astype(np.float32)
    x[:, 0] = 2.5
    return fx.compile_pipeline(pipe, calibration_audio=x)


def c_matches_interp(cases, tmp: Path) -> list:
    """For each ``(tag, prog, in_intervals)``: emit the C, compile it with
    ``gcc -std=c99 -O1`` (all cases at once, one gcc each), run it on
    seeded inputs and hold its outputs exactly to the interpreter's."""
    import numpy as np
    from repro_torch.ir import interp as ir_interp
    from repro_torch.ir.cgen import emit_c
    from repro_torch.ir.emit import seeded_inputs
    jobs = []
    for tag, prog, _ in cases:
        d = tmp / tag
        d.mkdir(parents=True, exist_ok=True)
        (d / "program.c").write_text(emit_c(prog))
        jobs.append(subprocess.Popen(
            ["gcc", "-std=c99", "-O1", "-o", str(d / "program"),
             str(d / "program.c")]))
    t0 = time.perf_counter()
    for job in jobs:
        if job.wait(timeout=600) != 0:
            raise AssertionError(f"IR C: gcc exited {job.returncode}")
    compile_s = time.perf_counter() - t0
    rows = []
    for tag, prog, in_intervals in cases:
        d = tmp / tag
        inputs = seeded_inputs(prog, in_intervals)
        blob = b""
        for r, v in zip((prog.regs[i] for i in prog.inputs), inputs):
            blob += (np.asarray(v).astype(np.uint8) if r.dtype == "i1"
                     else np.asarray(v).astype("<i4")).tobytes()
        (d / "in.bin").write_bytes(blob)
        subprocess.run([str(d / "program"), str(d / "in.bin"),
                        str(d / "out.bin")], check=True, timeout=600)
        raw, off = (d / "out.bin").read_bytes(), 0
        for i, want in zip(prog.outputs, ir_interp.run(prog, inputs)):
            r = prog.regs[i]
            dt, w = (np.uint8, 1) if r.dtype == "i1" else ("<i4", 4)
            got = np.frombuffer(raw, dt, r.size, off).reshape(r.shape)
            off += w * r.size
            if not np.array_equal(got.astype(np.asarray(want).dtype), want):
                raise AssertionError(f"IR C {tag}: output {i} differs from "
                                     "the interpreter")
        if off != len(raw):
            raise AssertionError(f"IR C {tag}: {len(raw)} output bytes, "
                                 f"expected {off}")
        rows.append(dict(case=tag, instrs=prog.num_instrs(),
                         c_bytes=len((d / "program.c").read_bytes()),
                         equal_interpreter=True))
    return dict(cases=rows, gcc_parallel_s=compile_s)


def phase_ir(card: str, clips) -> dict:
    """The IR and static-analysis tier at the full config, then its torch
    re-emission on the card against the int kernels (see the module
    docstring, phase 14)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.analysis import report as rp
    from repro_torch.analysis import targets as tg
    from repro_torch.analysis.legality import census
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.core import fixed as fx
    from repro_torch.core.pipeline import SessionState
    from repro_torch.ir import build_program, census_program, emit_torch
    from repro_torch.ir.alloc import allocate
    from repro_torch.ir.cgen import emit_c
    from repro_torch.ir.verilog import emit_verilog
    from repro_torch.kernels import LAUNCHES, reset_launches
    sys.path.insert(0, str(ROOT / "tests"))
    import ir_reference as ir_ref
    from ir_reference import census_diff

    committed = json.loads((ROOT / "ANALYSIS.json").read_text())
    t0 = time.perf_counter()
    targets, meta = tg.build_targets(smoke=False, device="cuda")
    by = {t.name: t for t in targets}
    for k in ("acc_envelope", "max_safe_session_samples",
              "envelope_samples", "session_bound_counter", "chunk_len"):
        if meta[k] != committed["meta"][k]:
            raise AssertionError(f"IR meta {k}: {meta[k]}, committed "
                                 f"{committed['meta'][k]}")
    rows, progs = [], {}
    for t in targets:
        t1 = time.perf_counter()
        sec = rp.analyze_target(t)
        row = dict(target=t.name, numerics=t.numerics,
                   nodes=t.traced.num_nodes(), trace_s=t.seconds,
                   legality_ok=sec["legality"]["ok"],
                   determinism_ok=sec["determinism"]["ok"],
                   determinism_findings=sec["determinism"]["num_findings"])
        if t.numerics == "fixed":
            if not (sec["legality"]["ok"] and sec["determinism"]["ok"]):
                raise AssertionError(
                    f"IR {t.name}: legality {sec['legality']['violations'][:3]}"
                    f" determinism {sec['determinism']['findings'][:3]}")
            prog = build_program(t.traced, name=t.name,
                                 in_intervals=t.in_intervals)
            progs[t.name] = prog
            c = {k: int(v) for k, v in sorted(census_program(prog).items())}
            if c != {k: int(v) for k, v in sorted(census(t.traced).items())}:
                raise AssertionError(f"IR {t.name}: IR census != graph "
                                     "census")
            if c.get("multiply") or c.get("transcendental_or_div"):
                raise AssertionError(f"IR {t.name}: not multiplierless {c}")
            ref = ir_committed(t.name)
            row.update(instrs=prog.num_instrs(), registers=len(prog.regs),
                       roms=len(prog.roms), rom_bytes=prog.rom_bytes(),
                       census=c, committed=IR_COMMITTED[t.name],
                       committed_census=ref["census"],
                       committed_instrs=ref["num_instrs"],
                       committed_registers=ref["num_registers"],
                       committed_minus_port=census_diff(ref["census"], c))
            if t.name in ("oneshot_q", "session_step_q"):
                want = committed["targets"][t.name]["intervals"]
                row["intervals"] = ir_gate_intervals(t.name,
                                                     sec["intervals"], want)
                if t.name == "oneshot_q":
                    named = ir_ref.reference_block_padding(t.program,
                                                           t.n_samples)
                    row["reference_block_padding"] = dict(named)
                else:
                    S, L = t.example[-2].shape
                    named = ir_ref.reference_index_overhead(
                        t.program, S, L, t.example[0].shape[1])
                    row["reference_index_overhead"] = dict(named)
                rest = census_diff(census_diff(ref["census"], c), named)
                row["rest_input_free"] = rest
                pinned = ir_ref.COMMITTED_INPUT_FREE[t.name]
                if {k: v for k, v in rest.items() if v} != pinned:
                    raise AssertionError(
                        f"IR {t.name}: committed census - port census - "
                        f"named work = {rest}, want the reference's "
                        f"input-free census {pinned}")
            else:
                iv = sec["intervals"]
                if not iv["ok"]:
                    raise AssertionError(f"IR {t.name}: interval proof "
                                         f"failed {iv['violations'][:3]}")
                row["intervals"] = dict(
                    out_intervals=iv["out_intervals"],
                    max_required_bits=iv["max_required_bits"],
                    committed=committed["targets"][IR_COMMITTED[t.name]]
                    ["intervals"]["out_intervals"])
        else:
            row["legality_violations"] = [
                v["primitive"] + "@" + v["source"]
                for v in sec["legality"]["violations"][:3]]
        row["analysis_s"] = time.perf_counter() - t1
        log(dict(phase="ir_target", **row))
        rows.append(row)
    build_s = time.perf_counter() - t0

    # emission at the full config: timed, sizes printed
    emitted = []
    for name in ("oneshot_q", "session_step_q"):
        prog = progs[name]
        t1 = time.perf_counter()
        c_text = emit_c(prog)
        c_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        v_text = emit_verilog(prog, allocate(prog))
        v_s = time.perf_counter() - t1
        emitted.append(dict(target=name, c_bytes=len(c_text), c_emit_s=c_s,
                            verilog_bytes=len(v_text), verilog_emit_s=v_s))
        del c_text, v_text
    log(dict(phase="ir_emission_full", targets=emitted))

    # 2. oneshot_q re-emitted on the card vs row 4's kernel and the plain path
    t = by["oneshot_q"]
    prog_q = t.program
    fn1 = emit_torch.emit(progs["oneshot_q"])
    dev = torch.device("cuda")
    clip_ms = []
    reset_launches()
    for i in range(IR_CLIPS):
        x = torch.from_numpy(np.ascontiguousarray(clips[i:i + 1])).to(dev)
        xq = fx.quantize_signal(prog_q, x)
        got = fn1(xq)
        for want, what in ((fx.infer_q(prog_q, xq, use_pallas=True),
                            "int cascade kernel"),
                           (fx.infer_q(prog_q, xq, use_pallas=False),
                            "plain path")):
            for g, w, leaf in zip(got, want, ("p_q", "phi_q", "s_q")):
                exact(g, w, f"IR oneshot_q clip {i} {leaf} vs the {what}")
        clip_ms.append(cuda_ms(lambda: fn1(xq), 1))
    if LAUNCHES["fir_mp_oneshot_cascade_q"] != IR_CLIPS:
        raise AssertionError(f"IR: {dict(LAUNCHES)}: want one int cascade "
                             "launch per clip")

    # 3. session_step_q re-emitted on the card vs row 5's kernel, 100 steps
    pipe = make_pipeline(numerics="fixed", device=dev)
    fn2 = emit_torch.emit(progs["session_step_q"])
    o = len(prog_q.bank.octaves)
    state = pipe.init_session(1)
    leaves = [*state.delays, *state.consumed, state.acc, state.amax,
              state.count, state.active]
    x = torch.from_numpy(np.ascontiguousarray(clips[0:1])).to(dev)
    xq_all = fx.quantize_signal(prog_q, x)
    n = torch.full((1,), tg.CHUNK_LEN, dtype=torch.int32, device=dev)
    step_ms = []
    reset_launches()
    for k in range(IR_STEPS):
        chunk = xq_all[:, k * tg.CHUNK_LEN:(k + 1) * tg.CHUNK_LEN]
        chunk = chunk.contiguous()
        got = fn2(*leaves, chunk, n)
        st = SessionState(tuple(leaves[:o]), tuple(leaves[o:2 * o]),
                          *leaves[2 * o:2 * o + 4])
        st2, p_q, phi_q = pipe._cascade_pallas_fixed(prog_q, st, chunk, n)
        want = [*st2.delays, *st2.consumed, st2.acc, st2.amax, st2.count,
                st2.active, p_q, phi_q]
        if len(got) != len(want):
            raise AssertionError(f"IR session: {len(got)} outputs, want "
                                 f"{len(want)}")
        for j, (g, w) in enumerate(zip(got, want)):
            if g.dtype == torch.bool:
                if not torch.equal(g, w):
                    raise AssertionError(f"IR session step {k} leaf {j}")
            else:
                exact(g, w, f"IR session step {k} leaf {j} vs the int "
                            "stream cascade kernel")
        if k % 25 == 0:
            step_ms.append(cuda_ms(lambda: fn2(*leaves, chunk, n), 1))
        leaves = list(got[:len(leaves)])
    if LAUNCHES["fir_mp_stream_cascade_q"] != IR_STEPS:
        raise AssertionError(f"IR: {dict(LAUNCHES)}: want one int stream "
                             "cascade launch per step")
    exact(got[-2], fx.infer_q(prog_q, xq_all[:, :IR_STEPS * tg.CHUNK_LEN])[0],
          "IR session: last p_q vs one-shot infer_q of the same second")

    # 4. C of a golden-shaped program and of the smoke config, compiled
    from repro_torch.analysis.intervals import Interval
    from repro_torch.analysis.traverse import trace
    gold = golden_like_program()
    sig = Interval(int(gold.signal.qmin), int(gold.signal.qmax))
    xg = torch.zeros((1, 600), dtype=torch.int32)
    cases = [("esc_mp_bisect", build_program(
        trace(fx.infer_q, xg, program=gold), name="oneshot_q",
        in_intervals=[sig]), [sig])]
    smoke, _ = tg.build_targets(smoke=True, device="cuda",
                                names=("oneshot_q", "session_step_q"))
    for st_ in smoke:
        cases.append((f"smoke_{st_.name}", build_program(
            st_.traced, name=st_.name, in_intervals=st_.in_intervals),
            st_.in_intervals))
    with tempfile.TemporaryDirectory() as tmp:
        log(dict(phase="ir_c", **c_matches_interp(cases, Path(tmp))))
    out = dict(phase="ir", build_s=build_s, card=card,
               emit_torch_ms_per_clip=clip_ms,
               emit_torch_ms_per_step=step_ms, clips=IR_CLIPS,
               steps=IR_STEPS, exact_vs_kernels=True,
               total_s=time.perf_counter() - t0)
    log(out)
    return out


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
    # seeded synthetic ESC-10-like audio (numpy), 1 s clips at 16 kHz
    clips = make_esc10_like(per_class_train=26, per_class_test=1,
                            fs=16000.0, seconds=1.0, seed=0).x_train
    stream_row = phase_stream_kernel(fb, gen, clips)
    x1 = torch.from_numpy(np.ascontiguousarray(clips[:8])).cuda()
    bank_rows = phase_bank_kernels(fb, x1)
    cascade_row = phase_oneshot_cascade(fb, x1)

    serve_launches = phase_serve(clips[:256, :50 * 160])
    phase_serving_tier(clips[:256, :10 * 160])
    oneshot_launches = phase_oneshot(x1)

    cal = clips[:8]
    _, prog = fixed_pipeline(cal)
    int_stream_row = phase_int_stream_kernel(prog, gen, clips)
    int_bank_row = phase_int_bank_kernel(prog, x1)
    int_cascade_row = phase_oneshot_cascade_q(prog, x1)
    fixed_serve_launches = phase_fixed_serve(clips[:256, :50 * 160], cal)
    fixed_oneshot_launches = phase_fixed_oneshot(x1, cal)

    qwen = mp_cfg("qwen3-8b")
    lin_row, wf_row = phase_mp_kernels(qwen)

    phase_train()
    qwen2 = dataclasses.replace(qwen, num_layers=2)
    bwd_launches, bwd_device_ms, bwd_calls = phase_train_lm(qwen2)
    bwd_row = phase_mp_backward(bwd_calls, qwen2.num_layers, qwen2.mp_gamma)
    del bwd_calls

    decoded = [phase_decode(*d, card) for d in DECODE]
    qwen_out = decoded[0][0]
    decode_rows = [r for _, rows in decoded for r in rows]
    decode_rows.append(phase_encoder(card))
    phase_ir(card, clips)

    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        dict(stream_row, route="cuda", source=src + "fir_mp_stream.cu",
             replaces="src/repro/kernels/fir_mp.py:279",
             launches=serve_launches, library_ms=None),
        dict(cascade_row, route="cuda", source=src + "fir_mp_bank.cu",
             replaces="src/repro/kernels/fir_mp.py:112",
             also_replaces="src/repro/kernels/fir_mp.py:382",
             launches=oneshot_launches["fir_mp_oneshot_cascade"],
             library_ms=None),
        dict(bank_rows["fir_mp_bank"], route="cuda",
             source=src + "fir_mp_bank.cu",
             replaces="src/repro/kernels/fir_mp.py:112",
             launches=bank_rows["fir_mp_bank"]["launches_here"],
             main_path_launches=oneshot_launches["fir_mp_bank"],
             library_ms=None),
        dict(bank_rows["fir_mp"], route="cuda",
             source=src + "fir_mp_bank.cu",
             replaces="src/repro/kernels/fir_mp.py:382",
             launches=bank_rows["fir_mp"]["launches_here"],
             main_path_launches=oneshot_launches["fir_mp"], library_ms=None),
        dict(int_cascade_row, route="cuda", source=src + "fir_mp_bank_q.cu",
             replaces="src/repro/kernels/fir_mp.py:515",
             launches=fixed_oneshot_launches["fir_mp_oneshot_cascade_q"],
             library_ms=None),
        dict(int_bank_row, route="cuda", source=src + "fir_mp_bank_q.cu",
             replaces="src/repro/kernels/fir_mp.py:515",
             launches=int_bank_row["launches_here"],
             main_path_launches=fixed_oneshot_launches["fir_mp_bank_q"],
             library_ms=None),
        dict(int_stream_row, route="cuda", source=src + "fir_mp_stream_q.cu",
             replaces="src/repro/kernels/fir_mp.py:682",
             launches=fixed_serve_launches, library_ms=None),
        dict(lin_row, route="cuda", source=src + "mp_linear.cu",
             replaces="src/repro/kernels/mp_linear.py:89",
             launches=qwen_out["mp_linear_launches"],
             device_ms=qwen_out["mp_linear_device_ms_per_step"],
             device_timed_by=("profiler"
                              if qwen_out["mp_linear_device_ms_per_step"]
                              else None),
             library_ms=None),
        dict(bwd_row, route="cuda", source=src + "mp_linear_bwd.cu",
             replaces="src/repro/kernels/ops.py:73",
             launches=bwd_launches, device_ms=bwd_device_ms,
             device_timed_by="profiler" if bwd_device_ms else None,
             library_ms=None),
        dict(wf_row, route="cuda", source=src + "mp_waterfill.cu",
             replaces="src/repro/kernels/mp_waterfill.py:46",
             launches=wf_row["launches_here"], library_ms=None),
    ] + [dict(r, route="cuda", source=src + "mp_linear.cu",
              replaces="src/repro/kernels/mp_linear.py:89", library_ms=None)
         for r in decode_rows]
    keys = ("name", "at", "route", "source", "replaces", "also_replaces",
            "launches", "main_path_launches", "max_abs_err", "ms",
            "device_ms", "device_timed_by", "plain_ms", "bound_ms",
            "bound_by", "x_bound", "library_ms")
    log(f"total: {time.perf_counter() - t_start:.1f} s (build {build_s:.1f} s)")
    log(card)
    log({"kernels": [{k: r.get(k) for k in keys} for r in kernels]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
