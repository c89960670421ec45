"""Plain float reference of the in-filter classifier, in any torch dtype.

Written from the paper's equations (a multirate octave bank of MP FIR
filters, half-wave rectified and accumulated, then the MP template kernel
machine) and from the configuration's numbers alone: the taps are
designed here again, the MP solves are exact (monotone Newton run until
it stops moving to within a few units in the last place: in exact
arithmetic it lands on the root in finitely many steps), and every sum
is an ordinary one. It imports nothing of the system under test.

    MP(L, gamma):     z with sum_i [L_i - z]_+ = gamma
    mp_dot(w, x):     MP([w + x; -(w + x)]) - MP([w - x; -(w - x)])  (eq. 9)
    band:             y_p(n) = mp_dot(h_p reversed, x[n-M+1 .. n]), zero
                      history; octave o+1 is the low-pass of octave o at
                      its even positions
    features:         s_p = 2^o sum_n max(0, y_p(n))
    classifier:       z+ = MP([w+ + K, w- - K, b+], g1), z- likewise with
                      w+ and w- swapped, z = MP([z+, z-], 1),
                      p = [z+ - z]_+ - [z- - z]_+
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# blocks bound the (B, Q, F, M) operand tensors of one solve
ELEMENTS_PER_BLOCK = 1 << 20   # batch rows x positions per solve block
MAX_NEWTON_STEPS = 64


# -- taps (windowed sinc, Hamming window) -----------------------------------


def _hamming(m: int) -> np.ndarray:
    n = np.arange(m)
    return 0.54 - 0.46 * np.cos(2 * np.pi * n / (m - 1))


def lowpass(taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Unity-DC-gain windowed-sinc low-pass, float32 as deployed."""
    fc = cutoff / fs
    n = np.arange(taps) - (taps - 1) / 2.0
    h = 2 * fc * np.sinc(2 * fc * n) * _hamming(taps)
    return (h / h.sum()).astype(np.float32)


def bandpass(taps: int, f_lo: float, f_hi: float, fs: float) -> np.ndarray:
    """Difference of two windowed-sinc low-passes, scaled to unit gain at
    the band's centre, float32 as deployed."""
    n = np.arange(taps) - (taps - 1) / 2.0
    h = (2 * (f_hi / fs) * np.sinc(2 * (f_hi / fs) * n)
         - 2 * (f_lo / fs) * np.sinc(2 * (f_lo / fs) * n)) * _hamming(taps)
    w = 2 * np.pi * (f_lo + f_hi) / 2.0 / fs
    gain = np.abs(np.sum(h * np.exp(-1j * w * np.arange(taps))))
    return (h / max(gain, 1e-6)).astype(np.float32)


def design(bank: dict) -> tuple:
    """(band-pass taps per octave (F, M), low-pass taps per /2 stage) from
    the configuration's ``bank`` block: octave o covers [fs / 2^(o+2),
    fs / 2^(o+1)] at rate fs / 2^o, split into equal bands."""
    if bank["spacing"] != "octave":
        raise ValueError(f"spacing {bank['spacing']!r} is not modelled")
    fs, octaves = float(bank["fs"]), int(bank["num_octaves"])
    per = int(bank["filters_per_octave"])
    bp, lp = [], []
    for o in range(octaves):
        f_hi = fs / 2.0 / 2 ** o
        edges = np.linspace(f_hi / 2.0, f_hi, per + 1)
        rate = fs / 2 ** o
        bp.append(np.stack([bandpass(int(bank["bp_taps"]), edges[p],
                                     edges[p + 1], rate)
                            for p in range(per)]))
        if o < octaves - 1:
            lp.append(lowpass(int(bank["lp_taps"]), rate / 4.0, rate))
    return bp, lp


# -- MP solves ----------------------------------------------------------------


def _converged(z_next: torch.Tensor, z: torch.Tensor) -> bool:
    """No z moved by more than a few units in the last place (a Newton step
    in floating point can flip the last bit back and forth forever)."""
    tol = 8 * torch.finfo(z.dtype).eps
    return bool(((z_next - z).abs() <= tol * (1 + z.abs())).all())


def mp(L: torch.Tensor, gamma) -> torch.Tensor:
    """MP(L, gamma) along the last axis, by monotone Newton from the left
    (z0 = max L - gamma) until no z moves, in L's dtype."""
    g = torch.as_tensor(gamma, dtype=L.dtype, device=L.device)
    z = L.amax(-1) - g
    for step in range(MAX_NEWTON_STEPS):
        d = L - z[..., None]
        h = torch.clamp_min(d, 0).sum(-1, dtype=L.dtype)
        k = (d > 0).sum(-1).to(L.dtype)
        z_next = z + (h - g) / torch.clamp_min(k, 1)
        if step % 2 == 1 and _converged(z_next, z):
            return z_next
        z = z_next
    return z


def mpabs(u: torch.Tensor, gamma) -> torch.Tensor:
    """MP([u; -u], gamma) along the last axis: the u and -u branches summed
    without forming the concatenation."""
    a = u.abs()
    g = torch.as_tensor(gamma, dtype=u.dtype, device=u.device)
    z = a.amax(-1) - g
    for step in range(MAX_NEWTON_STEPS):
        zc = z[..., None]
        h = (torch.clamp_min(a - zc, 0).sum(-1, dtype=u.dtype)
             + torch.clamp_min(-a - zc, 0).sum(-1, dtype=u.dtype))
        k = ((a > zc).sum(-1) + (-a > zc).sum(-1)).to(u.dtype)
        z_next = z + (h - g) / torch.clamp_min(k, 1)
        if step % 2 == 1 and _converged(z_next, z):
            return z_next
        z = z_next
    return z


def fir_at(x: torch.Tensor, taps: torch.Tensor, gamma, positions: slice,
           stride: int = 1) -> torch.Tensor:
    """MP FIR outputs of x (B, N) with zero history at positions
    ``range(N)[positions]`` taken every ``stride``: taps (F, M) ->
    (B, Q, F)."""
    F_, M = taps.shape
    xp = F.pad(x, (M - 1, 0))
    start, stop = positions.start, positions.stop
    win = xp[:, start:stop + M - 1].unfold(-1, M, 1)[:, ::stride]
    hr = taps.flip(-1)                                    # (F, M)
    w = win[:, :, None, :]
    return mpabs(hr + w, gamma) - mpabs(hr - w, gamma)


# -- the bank -----------------------------------------------------------------


def cascade(x: torch.Tensor, bp, lp, gamma, segment: int):
    """The octave cascade over x (B, N) in x's dtype.

    Returns (sums (B, N // segment, P): the renormalized HWR band sums of
    each run of ``segment`` input samples, octave-o position j falling in
    the run of input sample 2^o j; signals: each octave's input (B, N_o)).
    ``segment`` is a multiple of 2^(octaves - 1) dividing N."""
    B, N = x.shape
    O = len(bp)
    if N % segment or segment % (1 << (O - 1)):
        raise ValueError(f"segment {segment} must divide N = {N} and be a "
                         f"multiple of {1 << (O - 1)}")
    dt, dev = x.dtype, x.device
    Q = max(512, ELEMENTS_PER_BLOCK // B)
    parts, signals = [], []
    x_o = x
    for o in range(O):
        signals.append(x_o)
        taps = torch.as_tensor(bp[o], device=dev).to(dt)
        N_o = x_o.shape[1]
        seg_o = segment >> o
        acc = torch.zeros(B, N // segment, taps.shape[0], dtype=dt,
                          device=dev)
        for s in range(0, N_o, Q):
            e = min(N_o, s + Q)
            y = torch.clamp_min(fir_at(x_o, taps, gamma, slice(s, e)), 0)
            seg_of = torch.arange(s, e, device=dev) // seg_o
            acc.index_add_(1, seg_of, y)
        parts.append(acc * (2.0 ** o))
        if o < O - 1:
            h = torch.as_tensor(lp[o], device=dev).to(dt)[None]
            kept = []
            for s in range(0, N_o, 2 * Q):
                e = min(N_o, s + 2 * Q)
                kept.append(fir_at(x_o, h, gamma, slice(s, e), 2)[..., 0])
            x_o = torch.cat(kept, 1)
    return torch.cat(parts, -1), signals


def peaks(x: torch.Tensor, lp, gamma) -> list:
    """max |signal| of each octave after the first: the low-pass cascade
    of x (B, N) at its kept positions."""
    out, x_o = [], x
    for h in lp:
        h = torch.as_tensor(h, device=x.device).to(x.dtype)[None]
        x_o = fir_at(x_o, h, gamma, slice(0, x_o.shape[1]), 2)[..., 0]
        out.append(float(x_o.abs().max()))
    return out


# -- the classifier -----------------------------------------------------------


def classify(K: torch.Tensor, clf: dict) -> torch.Tensor:
    """p (B, C) from the kernel vector K (B, P), in K's dtype; ``clf``
    holds w_pos, w_neg (P, C), b_pos, b_neg (C,) and gamma1."""
    dt, dev = K.dtype, K.device
    t = {k: torch.as_tensor(np.asarray(v), device=dev).to(dt)
         for k, v in clf.items() if k != "gamma1"}
    wp, wn = torch.relu(t["w_pos"]), torch.relu(t["w_neg"])
    Kp, Kn = K[:, :, None], -K[:, :, None]

    def z_of(a, b, bias):
        ops = torch.cat([a[None] + Kp, b[None] + Kn,
                         bias[None, None, :].expand(K.shape[0], 1, -1)], 1)
        return mp(ops.movedim(1, -1), clf["gamma1"])

    z_pos = z_of(wp, wn, t["b_pos"])
    z_neg = z_of(wn, wp, t["b_neg"])
    z = mp(torch.stack([z_pos, z_neg], -1), 1.0)
    return torch.relu(z_pos - z) - torch.relu(z_neg - z)
