"""Plain reference of the fixed-point twin: the integer datapath of the
FPGA design (8-bit signals and weights, a 10-bit internal path, 32-bit
accumulators; add, subtract, shift and compare only), worked out here
again from the configuration, the calibration audio and the classifier.

Formats are symmetric fixed point with power-of-two scales: value = q 2^e,
q in [-2^(b-1), 2^(b-1) - 1]. A format is the finest such scale whose
largest code reaches the range it must cover. A right shift floors.

    ADC:        8 bits covering the calibration audio's peak
    octave o:   its 8-bit register sits 2^g_o finer than the ADC, with
                g_o = clip(floor(log2(full scale / peak of octave o's
                signal in the float cascade)), 0, 8), g_0 = 0
    a stage:    taps rounded to 8 bits at their own scale, aligned onto a
                10-bit grid covering max |h| + the register's range; the
                MP solve is integer bisection over that grid: hi = max
                |u|, lo = hi - gamma, mid = (lo + hi) >> 1, until the
                interval is one code wide (bit_length(gamma) + 2 steps)
    acc:        32 bits at the finest (band exponent + o) of the octaves
    standardize: (s - mu) times 2^(acc - phi exponents) / sigma as the best
                two-term signed power-of-two sum, clamped to 8 bits
                covering phi_amax
    classifier: weights on 8 bits at their own scale, aligned onto a
                10-bit operand grid covering max w + phi_amax; integer
                bisection as above

Integer tensors are int32, as the datapath: sums wrap as its adders do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import filterbank as fl

ELEMENTS_PER_BLOCK = 1 << 20   # batch rows x positions per solve block


# -- formats ------------------------------------------------------------------


def fmt(bits: int, cover: float) -> tuple:
    """(bits, exp): the finest power-of-two scale whose largest code
    reaches ``cover``."""
    qmax = (1 << (bits - 1)) - 1
    exp = math.ceil(math.log2(cover / qmax) - 1e-12)
    while math.ldexp(qmax, exp) < cover:
        exp += 1
    return bits, exp


def lo_hi(f: tuple) -> tuple:
    return -(1 << (f[0] - 1)), (1 << (f[0] - 1)) - 1


def amax_of(f: tuple) -> float:
    return math.ldexp(lo_hi(f)[1], f[1])


def codes(x: np.ndarray, f: tuple) -> np.ndarray:
    """Round half to even onto the format's grid, saturating."""
    lo, hi = lo_hi(f)
    q = np.round(np.asarray(x, np.float64) / math.ldexp(1.0, f[1]))
    return np.clip(q, lo, hi).astype(np.int64)


def shift(q, k: int):
    """q 2^k: a left shift, or a floor right shift for k < 0 (numpy or
    torch integers)."""
    return q << k if k >= 0 else q >> -k


def iters_for(gamma_q: int) -> int:
    return max(2, int(gamma_q).bit_length() + 2)


# -- compiling the program from the float design ----------------------------


def compile_program(cfg: dict, bp, lp, clf: dict, cal: np.ndarray,
                    device, signal_bits: int | None = None) -> dict:
    """The integer program: formats, tap and weight codes, shifts and
    gammas. ``cal`` (B, N) float32 is the calibration audio; the octave
    gains come from the float cascade's peaks on it (f64, exact MP).
    ``signal_bits`` overrides the configuration's register width (the
    control runs at fewer bits)."""
    bank = cfg["bank"]
    sb = int(signal_bits or cfg["fixed"]["signal_bits"])
    ib = sb + 2
    gamma_f = float(bank["gamma_f"])
    full = float(np.max(np.abs(cal))) or 1.0
    x = torch.as_tensor(cal, device=device).to(torch.float64)
    gains = [0] + [int(np.clip(0 if pk <= 0 else
                               math.floor(math.log2(full / pk)), 0, 8))
                   for pk in fl.peaks(x, lp, gamma_f)]
    signal = fmt(sb, full)
    regs = [(sb, signal[1] - g) for g in gains]

    def stage(h, reg):
        h = np.asarray(h, np.float64)
        rom_f = fmt(sb, float(np.max(np.abs(h))) or 1.0)
        rom = codes(h, rom_f)
        grid = fmt(ib, float(np.max(np.abs(h))) + amax_of(reg))
        return shift(rom, rom_f[1] - grid[1]).astype(np.int32), grid

    O = len(bp)
    stages = []
    for o in range(O):
        taps, band = stage(bp[o], regs[o])
        st = dict(reg=regs[o], taps=taps, band=band,
                  gamma_bp=max(1, round(gamma_f / math.ldexp(1.0, band[1]))))
        if o < O - 1:
            lp_taps, lp_grid = stage(np.asarray(lp[o])[None], regs[o])
            st.update(lp_taps=lp_taps, lp_grid=lp_grid,
                      gamma_lp=max(1, round(gamma_f
                                            / math.ldexp(1.0, lp_grid[1]))))
        stages.append(st)
    acc_exp = min(st["band"][1] + o for o, st in enumerate(stages))
    for o, st in enumerate(stages):
        st["acc_shift"] = st["band"][1] + o - acc_exp
        st["iters_bp"] = iters_for(st["gamma_bp"])
        if "lp_taps" in st:
            st["iters_lp"] = iters_for(st["gamma_lp"])

    # standardization: 2^(acc - phi exps) / sigma ~ 2^k1 + sign 2^k2
    phi = fmt(sb, float(cfg["fixed"]["phi_amax"]))
    mu = np.asarray(clf["mu"], np.float64)
    sigma = np.asarray(clf["sigma"], np.float64)
    mu_q = np.round(mu / math.ldexp(1.0, acc_exp)).astype(np.int32)
    terms = []
    for g in math.ldexp(1.0, acc_exp - phi[1]) / np.maximum(sigma, 1e-30):
        best = None
        for k1 in (math.floor(math.log2(g)), math.ceil(math.log2(g))):
            for sign, k2 in [(0, k1 - 1)] + [(s, k1 - d) for s in (-1, 1)
                                             for d in range(1, 7)]:
                err = abs(math.ldexp(1.0, k1) + sign * math.ldexp(1.0, k2)
                          - g) / g
                if best is None or err < best[0]:
                    best = (err, k1, k2, sign)
        terms.append(best[1:])

    # classifier grids
    wp = np.maximum(np.asarray(clf["w_pos"], np.float64), 0.0)
    wn = np.maximum(np.asarray(clf["w_neg"], np.float64), 0.0)
    bias = float(max(np.max(np.abs(clf["b_pos"])),
                     np.max(np.abs(clf["b_neg"])), 0.0))
    wmax = float(max(wp.max(), wn.max(), 1e-6))
    operand = fmt(ib, max(wmax + amax_of(phi), bias, 1.0))
    rom_f = fmt(sb, max(wmax, bias, 1e-6))
    k = rom_f[1] - operand[1]
    gamma1 = float(np.exp(np.float32(clf["log_gamma1"])))
    g1 = max(1, round(gamma1 / math.ldexp(1.0, operand[1])))
    gn = max(1, round(1.0 / math.ldexp(1.0, operand[1])))
    return dict(
        gains=tuple(gains), signal=signal, stages=stages, acc_exp=acc_exp,
        phi=phi, mu_q=mu_q, terms=np.asarray(terms, np.int64),
        operand=operand, phi_shift=phi[1] - operand[1],
        wp=shift(codes(wp, rom_f), k).astype(np.int32),
        wn=shift(codes(wn, rom_f), k).astype(np.int32),
        bpos=codes(clf["b_pos"], operand).astype(np.int32),
        bneg=codes(clf["b_neg"], operand).astype(np.int32),
        gamma1=g1, gamman=gn, iters1=iters_for(g1), iters_n=iters_for(gn))


# -- running it ---------------------------------------------------------------


def adc(prog: dict, x: torch.Tensor) -> torch.Tensor:
    """float32 audio -> int32 ADC codes (half to even, saturating)."""
    lo, hi = lo_hi(prog["signal"])
    q = torch.round(x.to(torch.float64) / math.ldexp(1.0, prog["signal"][1]))
    return torch.clamp(q, lo, hi).to(torch.int32)


def _clamp(q, f):
    lo, hi = lo_hi(f)
    return torch.clamp(q, lo, hi)


def bisect_abs(u: torch.Tensor, gamma: int, iters: int) -> torch.Tensor:
    """Integer MP([u; -u], gamma) along the last axis."""
    hi = u.abs().amax(-1)
    lo = hi - gamma
    for _ in range(iters):
        mid = (lo + hi) >> 1
        m = mid[..., None]
        h = (torch.clamp_min(u - m, 0).sum(-1, dtype=torch.int32)
             + torch.clamp_min(-u - m, 0).sum(-1, dtype=torch.int32))
        low = h > gamma
        lo = torch.where(low, mid, lo)
        hi = torch.where(low, hi, mid)
    return hi


def bisect(L: torch.Tensor, gamma: int, iters: int) -> torch.Tensor:
    """Integer MP(L, gamma) along the last axis."""
    hi = L.amax(-1)
    lo = hi - gamma
    for _ in range(iters):
        mid = (lo + hi) >> 1
        low = torch.clamp_min(L - mid[..., None], 0).sum(
            -1, dtype=torch.int32) > gamma
        lo = torch.where(low, mid, lo)
        hi = torch.where(low, hi, mid)
    return hi


def _fir_at(x, taps, grid, gamma, iters, positions: slice, stride: int = 1):
    """Integer MP FIR of register codes x (B, N) already on the stage's
    grid, zero history, at ``range(N)[positions]`` every ``stride``:
    taps (F, M) -> (B, Q, F)."""
    M = taps.shape[-1]
    xp = F.pad(x, (M - 1, 0))
    win = xp[:, positions.start:positions.stop + M - 1].unfold(-1, M, 1)
    w = win[:, ::stride, None, :]
    hr = taps.flip(-1)
    u = _clamp(hr + w, grid)
    v = _clamp(hr - w, grid)
    return bisect_abs(u, gamma, iters) - bisect_abs(v, gamma, iters)


def cascade(prog: dict, xq: torch.Tensor, segment: int):
    """ADC codes xq (B, N) int32 -> (sums (B, N // segment, P) int32: the
    accumulator increments of each run of ``segment`` input samples;
    signals: each octave's register codes (B, N_o))."""
    B, N = xq.shape
    dev = xq.device
    stages = prog["stages"]
    Q = max(512, ELEMENTS_PER_BLOCK // B)
    parts, signals = [], []
    x_o = xq
    for o, st in enumerate(stages):
        signals.append(x_o)
        taps = torch.as_tensor(st["taps"], device=dev)
        g_in = shift(x_o, st["reg"][1] - st["band"][1])
        N_o = x_o.shape[1]
        seg_o = segment >> o
        acc = torch.zeros(B, N // segment, taps.shape[0], dtype=torch.int64,
                          device=dev)
        for s in range(0, N_o, Q):
            e = min(N_o, s + Q)
            y = torch.clamp_min(_fir_at(g_in, taps, st["band"],
                                        st["gamma_bp"], st["iters_bp"],
                                        slice(s, e)), 0)
            acc.index_add_(1, torch.arange(s, e, device=dev) // seg_o,
                           y.to(torch.int64))
        parts.append(_wrap(acc << st["acc_shift"]))
        if "lp_taps" in st:
            h = torch.as_tensor(st["lp_taps"], device=dev)
            g_lp = shift(x_o, st["reg"][1] - st["lp_grid"][1])
            kept = []
            for s in range(0, N_o, 2 * Q):
                e = min(N_o, s + 2 * Q)
                kept.append(_fir_at(g_lp, h, st["lp_grid"], st["gamma_lp"],
                                    st["iters_lp"], slice(s, e), 2)[..., 0])
            nxt = stages[o + 1]["reg"]
            x_o = _clamp(shift(torch.cat(kept, 1),
                                st["lp_grid"][1] - nxt[1]), nxt)
    return torch.cat(parts, -1), signals


def _wrap(q: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's complement wrap, as 32-bit adders."""
    return (((q + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def running(sums: torch.Tensor) -> torch.Tensor:
    """The accumulator registers after each run: int32 running sums."""
    return _wrap(torch.cumsum(sums.to(torch.int64), 1))


def readout(prog: dict, acc: torch.Tensor) -> tuple:
    """acc (B, P) int32 -> (p codes (B, C), phi codes (B, P))."""
    dev = acc.device
    t = torch.as_tensor(prog["terms"], device=dev)
    diff = acc - torch.as_tensor(prog["mu_q"], device=dev)
    k1, k2, sign = t[:, 0], t[:, 1], t[:, 2]

    def sh(q, k):
        kk = k.to(torch.int32)
        return torch.where(kk >= 0, q << torch.clamp_min(kk, 0),
                           q >> torch.clamp_min(-kk, 0))

    t1, t2 = sh(diff, k1), sh(diff, k2)
    phi = torch.where(sign > 0, t1 + t2, torch.where(sign < 0, t1 - t2, t1))
    phi = _clamp(phi, prog["phi"]).to(torch.int32)
    K = phi << prog["phi_shift"]
    opf = prog["operand"]
    wp = torch.as_tensor(prog["wp"], device=dev)
    wn = torch.as_tensor(prog["wn"], device=dev)

    def z_of(a, b, bias):
        ops = torch.cat([_clamp(a[None] + K[:, :, None], opf),
                         _clamp(b[None] - K[:, :, None], opf),
                         torch.as_tensor(bias, device=dev)[None, None, :]
                         .expand(K.shape[0], 1, -1)], 1)
        return bisect(ops.movedim(1, -1), prog["gamma1"], prog["iters1"])

    z_pos = z_of(wp, wn, prog["bpos"])
    z_neg = z_of(wn, wp, prog["bneg"])
    z = bisect(torch.stack([z_pos, z_neg], -1), prog["gamman"],
               prog["iters_n"])
    return torch.clamp_min(z_pos - z, 0) - torch.clamp_min(z_neg - z, 0), phi
