"""The yardstick: the operations and bytes the classifier's work needs,
as functions of the shapes, the configuration and the integer program
the reference compiles, whatever kernel does the work.

Frozen from the port's proof script (``chip_smoke.py``: ``ops_newton``,
``ops_int_dot_min``, ``cascade_bytes``, ``oneshot_q_ops``), with one
change: every float MP solve counts as monotone Newton at 12 steps, the
cheaper of the port's two float solvers (the one-shot kernel bisects 26
times), each step in its cheapest exact form. An integer solve is
bisection to one code (``bit_length(gamma) + 2`` steps), each step in the
cheapest exact form the integer datapath allows.

A (position, filter) of a band-pass and a kept position of a low-pass
each need one eq. 9 product: two MP solves over the window's M taps
(each over 2M branch operands) and their difference. Bytes: each input
read once and each output written once.
"""

from __future__ import annotations

NEWTON_STEPS = 12


def f32_solve(M: int, steps: int = NEWTON_STEPS) -> int:
    """One MP([u; -u]) over M lanes by monotone Newton: the start (abs,
    max per lane, sub: 3M + 1); per step a sub, max, compare and count add
    per lane and one add tree (5M - 1), then the update (4)."""
    return 3 * M + 1 + steps * (5 * M - 1 + 4)


def f32_dot(M: int) -> int:
    """One eq. 9 product over M taps: two solves and a difference."""
    return 2 * f32_solve(M) + 1


def int_dot(M: int, iters: int) -> int:
    """One eq. 9 product on the integer grid, in the cheapest exact step
    form (``chip_smoke.ops_int_dot_min``): the operands (6M), per solve
    |t|, max and lo (2M) and per step M + ceil(M / 2) + 7, the final sub."""
    step = M + -(-M // 2) + 7
    return 6 * M + 2 * (2 * M + iters * step) + 1


def positions(N: int, octaves: int) -> list:
    """(band-pass positions, kept low-pass positions) per octave of an
    N-sample input: octave o+1 keeps the even positions of octave o."""
    out = []
    for o in range(octaves):
        kept = (N + 1) // 2 if o < octaves - 1 else 0
        out.append((N, kept))
        N = kept
    return out


def bank_ops(cfg: dict, prog: dict | None, rows: int, N: int) -> int:
    """Operations of the octave cascade over ``rows`` inputs of N samples:
    per band-pass (position, filter) a product and its HWR add (2), per
    kept low-pass position a product (float) or a product and its
    requantization (4, int). ``prog`` is the reference's integer program
    for a fixed configuration, None for float."""
    b = cfg["bank"]
    F, M, M_lp = int(b["filters_per_octave"]), int(b["bp_taps"]), \
        int(b["lp_taps"])
    ops = 0
    for o, (n, kept) in enumerate(positions(N, int(b["num_octaves"]))):
        if prog is None:
            ops += n * F * (f32_dot(M) + 2) + kept * f32_dot(M_lp)
        else:
            st = prog["stages"][o]
            ops += n * F * (int_dot(M, st["iters_bp"]) + 2)
            if kept:
                ops += kept * (int_dot(M_lp, st["iters_lp"]) + 4)
    return rows * ops


def readout_ops(cfg: dict, prog: dict | None, rows: int) -> int:
    """Operations of the readout over ``rows`` feature vectors: the
    standardization (2 per band float, 6 int: subtract, two shifts, add,
    clamp), the 2C operand sets of 2P + 1 (an add per operand, a clamp
    too on the int grid), the 2C solves over them and the C solves over
    [z+, z-], and p (4 per class). A float solve over m lanes is Newton
    (m + 1 to start, 5m + 3 per step); an int one bisection (m + 1 to
    start, 3m + 4 per step)."""
    b, c = cfg["bank"], cfg["classifier"]
    P = int(b["num_octaves"]) * int(b["filters_per_octave"])
    C = int(c["num_classes"])
    m = 2 * P + 1
    if prog is None:
        solve = lambda lanes, it: lanes + 1 + it * (5 * lanes + 3)
        it1 = itn = NEWTON_STEPS
        ops = 2 * P + 2 * C * 2 * P
    else:
        solve = lambda lanes, it: lanes + 1 + it * (3 * lanes + 4)
        it1, itn = prog["iters1"], prog["iters_n"]
        ops = 6 * P + 2 * C * 2 * P * 3
    ops += 2 * C * solve(m, it1) + C * solve(2, itn) + 4 * C
    return rows * ops


def stream_bytes(cfg: dict, S: int, L: int) -> int:
    """Bytes a served wave's cascade must move (``chip_smoke.
    cascade_bytes``): the chunk and valid counts read once; per octave the
    delay line (T - 1 samples) and the consumed counter read and written;
    the accumulators and amax read and written; the taps read once."""
    b = cfg["bank"]
    O, F = int(b["num_octaves"]), int(b["filters_per_octave"])
    M, M_lp = int(b["bp_taps"]), int(b["lp_taps"])
    T1, P = max(M, M_lp) - 1, O * F
    taps = O * F * M + (O - 1) * M_lp
    return 4 * (S * L + S + O * (2 * S * T1 + 2 * S) + 2 * S * P + 2 * S
                + taps)


def oneshot_bytes(cfg: dict, B: int, N: int) -> int:
    """Bytes a one-shot cascade must move: x read once, the taps, the sums
    (B, P) written once."""
    b = cfg["bank"]
    O, F = int(b["num_octaves"]), int(b["filters_per_octave"])
    taps = O * F * int(b["bp_taps"]) + (O - 1) * int(b["lp_taps"])
    return 4 * (B * N + taps + B * O * F)

