"""Bit-true fixed-point "hardware twin" of the in-filter pipeline.

The paper's headline (§III-A, §V, Tables I/II) is that the whole in-filter
kernel machine runs MULTIPLIERLESS: 8-bit fixed-point signals and weights,
a 10-bit internal path, and a datapath of adders, shifters and comparators
only. This module executes that datapath: signal quantization, the
multirate MP FIR bank, HWR + accumulate, standardization and the MP kernel
machine readout run on integer tensors with add, subtract, compare and
shift.

Why the integer path is exact (the parity contract the tests hold):

* Every format is a :class:`repro_torch.core.quant.FixedPointSpec` with a
  power-of-two scale, so a format change is a bit shift: left shifts are
  exact, right shifts floor, identically in int32 and in a float carrier
  (``floor(ldexp(q, -k))``).
* The MP solve is integer bisection (:func:`fxp_mp_bisect`): the midpoint
  is an arithmetic right shift and the constraint sum an exact integer sum,
  so the answer is LSB-deterministic.
* Integer addition is associative, so HWR accumulation needs none of the
  float path's fixed-tree ordering: any order gives the same bits, and
  chunked session accumulation is exactly one-shot accumulation.

Carriers: every ``fxp_*`` function is dtype-generic. On int32 it runs the
integer datapath; on float32 tensors carrying integer values it runs the
fake-quant twin, bit for bit the same while magnitudes stay below 2**24.
Every sum here returns the carrier's dtype (``torch.sum`` of int32 would
give int64).

Program constants (taps, ROMs, shift tables, specs, gammas, iteration
counts) are host-side: numpy arrays and Python ints, built by
:func:`compile_bank` / :func:`compile_pipeline` from the float pipeline and
a calibrated ADC full scale. Under ``use_pallas`` the one-shot bank routes
to the integer CUDA one-shot kernel, one launch for the whole cascade
(``kernels.fir_mp_oneshot_cascade_q``); the session step's kernel route
is ``kernels.fir_mp_stream_q``, chosen by ``InFilterPipeline``.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.core.mp import device_scalar
from repro_torch.core.quant import FixedPointSpec, pow2_spec_for

__all__ = [
    "FixedBankProgram",
    "FixedClassifier",
    "FixedPointProgram",
    "OctaveStage",
    "calibrate_octave_gains",
    "compile_bank",
    "compile_pipeline",
    "fxp_fir_bank",
    "fxp_fir_shift_add",
    "fxp_hwr_accumulate",
    "fxp_mp_bisect",
    "fxp_mp_dot",
    "fxp_mpabs",
    "bank_accumulate_q",
    "standardize_q",
    "classifier_q",
    "infer_q",
    "quantize_signal",
    "predict",
    "readout_q",
    "session_step_q",
    "shift_left",
    "shift_right",
    "rescale",
]


# ---------------------------------------------------------------------------
# carrier-generic shift/add/compare primitives
# ---------------------------------------------------------------------------


def _floatp(q: torch.Tensor) -> bool:
    return q.dtype.is_floating_point


def _carrier(like: torch.Tensor) -> torch.dtype:
    return torch.float32 if _floatp(like) else torch.int32


def _c(a, like: torch.Tensor) -> torch.Tensor:
    """A program constant on the carrier dtype and device of ``like``. A
    scalar comes from the shared device-scalar cache; an array is copied
    over (steps that run per wave pass cached tensors, :func:`_rom`)."""
    dtype = _carrier(like)
    if isinstance(a, torch.Tensor):
        return a.to(device=like.device, dtype=dtype)
    if isinstance(a, numbers.Number):
        return device_scalar(float(a) if dtype == torch.float32 else int(a),
                             dtype, like.device)
    return torch.as_tensor(np.asarray(a), device=like.device).to(dtype)


def _rom(owner, name: str, like: torch.Tensor, *, make=None,
         shift: bool = False) -> torch.Tensor:
    """The program array ``owner.<name>`` (or ``make()``) as a tensor on
    ``like``'s device: int32 under ``shift`` (shift counts), else the
    carrier dtype of ``like``. Made once per (name, dtype, device) and
    cached on ``owner``, a frozen program object (the cache sits in its
    instance dict, outside its fields), as ``kernels.fir_mp`` caches its
    device tables: a step that reads it copies nothing from the host, so
    it can run inside a captured CUDA graph."""
    dtype = torch.int32 if shift else _carrier(like)
    cache = vars(owner).setdefault("_device_consts", {})
    key = (name, dtype, str(like.device))
    t = cache.get(key)
    if t is None:
        a = make() if make is not None else getattr(owner, name)
        t = cache[key] = torch.as_tensor(np.ascontiguousarray(a),
                                         device=like.device).to(dtype)
    return t


def _shift_count(k, like: torch.Tensor):
    """A shift count as an int32 tensor on ``like``'s device (or an int)."""
    if isinstance(k, (int, np.integer)):
        return int(k)
    return torch.as_tensor(np.asarray(k) if not isinstance(k, torch.Tensor)
                           else k, device=like.device).to(torch.int32)


def _shift_tensor(k, like: torch.Tensor) -> torch.Tensor:
    """A shift count from :func:`_shift_count` as an int32 tensor (an int
    from the shared device-scalar cache)."""
    if isinstance(k, int):
        return device_scalar(k, torch.int32, like.device)
    return k


def _sum(q: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum in the carrier's dtype (int32 wraps like XLA's int32 sum)."""
    return q.sum(dim).to(q.dtype)


def shift_right(q: torch.Tensor, k) -> torch.Tensor:
    """Arithmetic (floor) shift right by ``k`` >= 0, an int or an int
    array. Int carrier: ``q >> k`` (counts of 32 or more give the sign).
    Float carrier: ``floor(ldexp(q, -k))``."""
    k = _shift_count(k, q)
    if _floatp(q):
        return torch.floor(torch.ldexp(q, -_shift_tensor(k, q)))
    return torch.bitwise_right_shift(q, k)


def shift_left(q: torch.Tensor, k) -> torch.Tensor:
    """Shift left by ``k`` >= 0 (exact in both carriers; int counts of 32
    or more give 0)."""
    k = _shift_count(k, q)
    if _floatp(q):
        return torch.ldexp(q, _shift_tensor(k, q))
    return torch.bitwise_left_shift(q, k)


def rescale(q: torch.Tensor, k) -> torch.Tensor:
    """Multiply codes by 2**k: left shift for k >= 0, floor right shift for
    k < 0 — the format-conversion primitive (pow2 scales only)."""
    if isinstance(k, (int, np.integer)):
        k = int(k)
        return shift_left(q, k) if k >= 0 else shift_right(q, -k)
    k = _shift_count(k, q)
    return torch.where(k >= 0, shift_left(q, torch.clamp_min(k, 0)),
                       shift_right(q, torch.clamp_min(-k, 0)))


def _clamp(q: torch.Tensor, spec: FixedPointSpec) -> torch.Tensor:
    """Saturating clamp onto a spec's representable range."""
    return torch.clamp(q, spec.qmin, spec.qmax)


def _relu(q: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(q, 0)


# ---------------------------------------------------------------------------
# integer MP solve (bisection: add/compare/shift only)
# ---------------------------------------------------------------------------


def bisect_iters(gamma_q: int) -> int:
    """Iterations until the integer bisection interval (initial width
    gamma_q, halving each step) collapses to one LSB."""
    return max(2, int(gamma_q).bit_length() + 2)


def fxp_mp_bisect(L: torch.Tensor, gamma_q, iters: int) -> torch.Tensor:
    """z = MP(L, gamma) on the fixed-point grid, along the last axis: the
    smallest grid point reached with ``sum_i [L_i - z]_+ <= gamma_q``."""
    gamma_q = _c(gamma_q, L)
    hi = L.amax(-1)
    lo = hi - gamma_q
    for _ in range(iters):
        mid = shift_right(lo + hi, 1)
        too_low = _sum(_relu(L - mid[..., None]), -1) > gamma_q
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    return hi


def fxp_mpabs(u: torch.Tensor, gamma_q, iters: int) -> torch.Tensor:
    """MP([u; -u], gamma) without the concatenation (eq. 9's operand
    form): the constraint is the u branch plus the -u branch."""
    gamma_q = _c(gamma_q, u)
    hi = u.abs().amax(-1)
    lo = hi - gamma_q
    for _ in range(iters):
        mid = shift_right(lo + hi, 1)[..., None]
        h = _sum(_relu(u - mid), -1) + _sum(_relu(-u - mid), -1)
        too_low = h > gamma_q
        lo = torch.where(too_low, mid[..., 0], lo)
        hi = torch.where(too_low, hi, mid[..., 0])
    return hi


def fxp_mp_dot(win: torch.Tensor, w: torch.Tensor, gamma_q, iters: int,
               spec: FixedPointSpec) -> torch.Tensor:
    """Multiplierless inner product (eq. 9) on the grid: <w, win> ~=
    mpabs(w + win) - mpabs(w - win), operand sums saturated onto ``spec``
    (the 10-bit internal path) before the solve."""
    u = _clamp(w + win, spec)
    v = _clamp(w - win, spec)
    return fxp_mpabs(u, gamma_q, iters) - fxp_mpabs(v, gamma_q, iters)


# ---------------------------------------------------------------------------
# integer FIR primitives
# ---------------------------------------------------------------------------


def fxp_fir_bank(x: torch.Tensor, H, gamma_q, iters: int,
                 spec: FixedPointSpec, chunk_n: Optional[int] = 1024,
                 pad: bool = True) -> torch.Tensor:
    """Multi-filter MP FIR on the integer grid: x (..., N), H (F, M) ->
    (..., F, N), causal with zero history. Long signals solve in
    ``chunk_n``-position blocks (every window solve is independent, so the
    blocking changes memory, not values).

    ``pad=False`` computes only the fully covered positions: output p's
    window is ``x[p .. p+M-1]``, shape (..., F, N-M+1) — the session step's
    delay-splice form."""
    H = _c(H, x)
    Fn, M = H.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xp = F.pad(x2, (M - 1, 0)) if pad else x2
    N = xp.shape[-1] - M + 1
    hr = H.flip(-1).reshape(Fn, 1, 1, M)
    Q = N if chunk_n is None else max(1, min(N, chunk_n))
    ys = []
    for s in range(0, N, Q) if N > 0 else ():
        win = xp[:, s:s + min(Q, N - s) + M - 1].unfold(-1, M, 1)
        ys.append(fxp_mp_dot(win[None], hr, gamma_q, iters, spec))
    y = (torch.cat(ys, dim=-1) if ys else
         x2.new_zeros(Fn, x2.shape[0], 0))                 # (F, B, N)
    return y.movedim(0, 1).reshape(*lead, Fn, N)


def _csd(v: int) -> list:
    """Canonical signed-digit decomposition: v == sum(sign << bit) with no
    two adjacent nonzero digits — the minimal shift/add realization of a
    constant multiplier."""
    v = int(v)
    terms = []
    k = 0
    while v != 0:
        if v & 1:
            r = 2 - (v & 3)  # +1 when v % 4 == 1, -1 when v % 4 == 3
            terms.append((r, k))
            v -= r
        v >>= 1
        k += 1
    return terms


def fxp_fir_shift_add(x: torch.Tensor, h_q, pad: bool = True) -> torch.Tensor:
    """Constant-coefficient FIR as unrolled CSD shift/adds: y(n) =
    sum_k h[k] x(n-k), every tap a sum of signed powers of two (the MAC
    mode's multiplierless FIR). ``h_q`` are host integers (the ROM);
    outputs carry scale 2**(x.exp + h.exp). ``pad=False`` keeps only the
    fully covered positions."""
    h_q = np.asarray(h_q)
    assert h_q.ndim == 1
    M = h_q.shape[0]
    xp = F.pad(x, (M - 1, 0)) if pad else x
    N = xp.shape[-1] - M + 1
    y = x.new_zeros(*x.shape[:-1], N)
    for k_tap in range(M):
        sk = xp[..., M - 1 - k_tap:M - 1 - k_tap + N]
        for sign, bit in _csd(int(h_q[k_tap])):
            t = shift_left(sk, bit)
            y = y + t if sign > 0 else y - t
    return y


def fxp_hwr_accumulate(y: torch.Tensor, valid=None) -> torch.Tensor:
    """s = sum_n [y_n]_+ over the last axis, in the carrier's dtype.
    ``valid`` (broadcastable to ``y.shape[:-1]``, e.g. ``n[:, None]`` for a
    (S, F, l) bank output) zeroes positions >= valid first."""
    h = _relu(y)
    if valid is not None:
        pos = torch.arange(y.shape[-1], device=y.device)
        valid = torch.as_tensor(valid, device=y.device)
        h = torch.where(pos < valid[..., None], h, torch.zeros_like(h))
    return _sum(h, -1)


# ---------------------------------------------------------------------------
# compiled programs: static taps/ROMs/shift tables + per-stage specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OctaveStage:
    """One octave's static datapath: band-pass taps and the anti-aliasing
    low-pass feeding the next octave, with their internal formats.

    ``in_spec`` is this octave's 8-bit signal register format; its exp may
    sit below the ADC's by a calibrated static pre-gain (a left shift baked
    into the design, see :func:`calibrate_octave_gains`)."""
    in_spec: FixedPointSpec      # 8-bit octave signal register format
    bp_q: np.ndarray             # (F, M) int32 taps, aligned to band_spec
    band_spec: FixedPointSpec    # 10-bit internal format of the BP stage
    sig_shift: int               # in_spec.exp - band_spec.exp
    gamma_bp: int                # gamma_f on the band grid
    iters_bp: int
    acc_shift: int               # (band exp + octave renorm) -> acc exp
    lp_q: Optional[np.ndarray]   # (1, M_lp) int32, None for the last octave
    lp_spec: Optional[FixedPointSpec]
    lp_sig_shift: int            # in_spec.exp - lp_spec.exp
    gamma_lp: int
    iters_lp: int
    lp_out_shift: int            # lp_spec.exp -> next octave's register exp
    # MAC (shift-add) mode: raw ROM taps + product-grid rescales
    bp_rom: Optional[np.ndarray] = None   # (F, M) host ints at rom exp
    lp_rom: Optional[np.ndarray] = None
    bp_prod_shift: int = 0       # (in + rom exp) -> band exp
    lp_prod_shift: int = 0       # (in + rom exp) -> lp_spec exp


@dataclasses.dataclass(frozen=True)
class FixedBankProgram:
    """Integer multirate filter bank: quantized signal in, 32-bit per-band
    accumulators out. Built by :func:`compile_bank`."""
    mode: str                    # "mp" | "mac"
    signal: FixedPointSpec       # 8-bit ADC format (exp from fixed_amax)
    acc: FixedPointSpec          # 32-bit accumulator format
    octaves: tuple               # OctaveStage per octave

    @property
    def num_filters(self) -> int:
        return sum(int(o.bp_q.shape[0]) for o in self.octaves)


@dataclasses.dataclass(frozen=True)
class FixedClassifier:
    """MP kernel machine ROMs on the classifier operand grid."""
    wp_q: np.ndarray             # (P, C) int32 at spec.exp
    wn_q: np.ndarray
    bpos_q: np.ndarray           # (C,)
    bneg_q: np.ndarray
    spec: FixedPointSpec         # 10-bit operand/output format
    phi_shift: int               # phi.exp - spec.exp (align K)
    gamma1_q: int
    gamman_q: int
    iters1: int
    iters_n: int


@dataclasses.dataclass(frozen=True)
class FixedPointProgram:
    """The audio -> decision integer program: bank + standardization shift
    table + classifier. Standardization is shift-add: 1/sigma (folded with
    the acc -> phi grid change) is a per-band two-term CSD reciprocal
    ``2**k1 + sign * 2**k2``, so phi costs two shifts and one add/select
    per band — no divider."""
    bank: FixedBankProgram
    mu_q: np.ndarray             # (P,) int32 at bank.acc.exp
    phi_shift_q: np.ndarray      # (P,) int32: leading CSD shift per band
    phi_shift2_q: np.ndarray     # (P,) int32: second CSD term's shift
    phi_sign2_q: np.ndarray      # (P,) int32 in {-1, 0, +1}
    phi: FixedPointSpec          # 8-bit standardized-feature format
    clf: FixedClassifier

    @property
    def signal(self) -> FixedPointSpec:
        return self.bank.signal

    @property
    def out_spec(self) -> FixedPointSpec:
        return self.clf.spec


def _plan_bits(cfg):
    """(signal, taps, internal) bits from a FilterBankConfig: 8-bit signals
    and weights, a (bits+2)-bit internal path — the paper's 8/10 split."""
    signal_bits = cfg.quant_bits if cfg.quant_bits is not None else 8
    return signal_bits, signal_bits, signal_bits + 2


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def calibrate_octave_gains(cfg, lp_taps, audio, max_gain: int = 8) -> tuple:
    """Static per-octave pre-gains (left shifts) from calibration audio.

    Runs the port's FLOAT low-pass cascade (``filterbank.single_fir``, on
    the device of ``lp_taps``) on ``audio`` and returns
    ``g_o = clip(floor(log2(full_scale / peak_o)), 0, max_gain)`` per
    octave, with ``g_0 = 0``: deep octaves carry ever smaller signals, and
    the gain recovers their resolution with a shift."""
    from repro_torch.core import filterbank as fbm
    fcfg = cfg._replace(numerics="float", quant_bits=None)
    amax = float(cfg.fixed_amax)
    dev = lp_taps[0].device if isinstance(lp_taps[0], torch.Tensor) \
        else torch.device("cpu")
    x_o = torch.as_tensor(np.atleast_2d(np.asarray(audio, np.float32)),
                          device=dev)
    gains = [0]
    for o in range(cfg.num_octaves - 1):
        h = torch.as_tensor(lp_taps[o], dtype=torch.float32, device=dev)
        x_o = fbm.single_fir(x_o, h, fcfg)[..., ::2].contiguous()
        peak = float(x_o.abs().max())
        g = 0 if peak <= 0 else math.floor(math.log2(amax / peak))
        gains.append(int(np.clip(g, 0, max_gain)))
    return tuple(gains)


def compile_bank(cfg, bp_taps, lp_taps, *, amax: float | None = None,
                 signal_bits: int | None = None,
                 internal_bits: int | None = None,
                 octave_gains=None) -> FixedBankProgram:
    """Lower float taps (per-octave (F, M) band-pass, per-stage low-pass)
    to the integer bank program, host-side. ``amax`` is the ADC full scale
    (default ``cfg.fixed_amax``), a static calibration: inputs beyond it
    saturate. ``octave_gains`` (from :func:`calibrate_octave_gains`) bakes
    a left-shift pre-gain into each octave's register format."""
    if cfg.mode not in ("mp", "mac"):
        raise ValueError(f"numerics='fixed' supports mode 'mp' or 'mac', "
                         f"got {cfg.mode!r}")
    sb, tb, ib = _plan_bits(cfg)
    if signal_bits is not None:
        sb = tb = signal_bits
        ib = signal_bits + 2
    if internal_bits is not None:
        ib = internal_bits
    amax = float(cfg.fixed_amax if amax is None else amax)
    signal = pow2_spec_for(None, sb, amax=amax)
    num_oct = cfg.num_octaves
    if octave_gains is None:
        octave_gains = (0,) * num_oct
    octave_gains = tuple(int(g) for g in octave_gains)
    if len(octave_gains) != num_oct or octave_gains[0] != 0 \
            or any(g < 0 for g in octave_gains):
        raise ValueError(f"octave_gains must be {num_oct} ints >= 0 with "
                         f"gains[0] == 0, got {octave_gains}")
    in_specs = [FixedPointSpec(bits=sb, exp=signal.exp - g)
                for g in octave_gains]

    def stage_for(h, in_spec: FixedPointSpec):
        """(ROM ints, ROM spec, internal spec, taps aligned to it). The
        internal exp covers |h|max + the octave register range (the MP
        operand range u = h +- x) at ``ib`` bits."""
        h = np.asarray(h, np.float64)
        rom_spec = pow2_spec_for(h, tb)
        rom = np.clip(np.round(h / rom_spec.scale),
                      rom_spec.qmin, rom_spec.qmax).astype(np.int64)
        if cfg.mode == "mp":
            cover = float(np.max(np.abs(h))) + in_spec.amax
        else:
            # shift-add MAC: output range is the l1 gain times the signal
            cover = max(float(np.sum(np.abs(h), axis=-1).max()), 1.0) \
                * in_spec.amax
        spec = pow2_spec_for(None, ib, amax=cover)
        k = rom_spec.exp - spec.exp
        aligned = rom * (1 << k) if k >= 0 else rom >> (-k)
        return rom, rom_spec, spec, np.asarray(aligned, np.int32)

    pre = []
    for o in range(num_oct):
        bp_rom, bp_rom_spec, band_spec, bp_q = stage_for(_host(bp_taps[o]),
                                                         in_specs[o])
        if o < num_oct - 1:
            lp_rom, lp_rom_spec, lp_spec, lp_q = stage_for(
                _host(lp_taps[o])[None, :], in_specs[o])
        else:
            lp_rom = lp_rom_spec = lp_spec = lp_q = None
        pre.append((bp_rom, bp_rom_spec, band_spec, bp_q,
                    lp_rom, lp_rom_spec, lp_spec, lp_q))
    # accumulator grid: the finest (band exp + octave renorm) over octaves
    acc_exp = min(p[2].exp + o for o, p in enumerate(pre))
    acc = FixedPointSpec(bits=32, exp=acc_exp)
    stages = []
    for o, (bp_rom, bp_rom_spec, band_spec, bp_q,
            lp_rom, lp_rom_spec, lp_spec, lp_q) in enumerate(pre):
        in_spec = in_specs[o]
        gamma_bp = max(1, int(round(cfg.gamma_f / band_spec.scale)))
        if lp_spec is not None:
            gamma_lp = max(1, int(round(cfg.gamma_f / lp_spec.scale)))
            lp_sig_shift = in_spec.exp - lp_spec.exp
            lp_out_shift = lp_spec.exp - in_specs[o + 1].exp
            lp_prod_shift = (in_spec.exp + lp_rom_spec.exp) - lp_spec.exp
        else:
            gamma_lp = 1
            lp_sig_shift = lp_out_shift = lp_prod_shift = 0
        stages.append(OctaveStage(
            in_spec=in_spec, bp_q=bp_q, band_spec=band_spec,
            sig_shift=in_spec.exp - band_spec.exp,
            gamma_bp=gamma_bp, iters_bp=bisect_iters(gamma_bp),
            acc_shift=band_spec.exp + o - acc_exp,
            lp_q=lp_q, lp_spec=lp_spec, lp_sig_shift=lp_sig_shift,
            gamma_lp=gamma_lp, iters_lp=bisect_iters(gamma_lp),
            lp_out_shift=lp_out_shift,
            bp_rom=bp_rom, lp_rom=lp_rom,
            bp_prod_shift=(in_spec.exp + bp_rom_spec.exp) - band_spec.exp,
            lp_prod_shift=lp_prod_shift,
        ))
    return FixedBankProgram(mode=cfg.mode, signal=signal, acc=acc,
                            octaves=tuple(stages))


def compile_pipeline(pipe, *, amax: float | None = None,
                     signal_bits: int | None = None,
                     internal_bits: int | None = None,
                     phi_amax: float = 4.0,
                     octave_gains=None,
                     calibration_audio=None) -> FixedPointProgram:
    """Lower an ``InFilterPipeline`` to the full integer program, host-side.

    Standardization becomes subtract-and-shift (two-term CSD reciprocal
    sigma); mu and the classifier ROMs quantize onto their stage grids.
    ``calibration_audio`` (host array) sets the ADC full scale (when
    ``amax`` is None) and the per-octave register pre-gains; or pass
    ``octave_gains``. One-shot :func:`infer_q` and chunked
    :func:`session_step_q` run this one program to identical codes."""
    from repro_torch.core import kernel_machine as km

    cfg = pipe.config
    if calibration_audio is not None:
        cal = np.asarray(calibration_audio, np.float32)
        if amax is None:
            amax = float(np.max(np.abs(cal))) or 1.0
        if octave_gains is None:
            octave_gains = calibrate_octave_gains(
                cfg._replace(fixed_amax=amax), pipe.lp_taps, cal)
    bank = compile_bank(cfg, [_host(t) for t in pipe.bp_taps],
                        [_host(t) for t in pipe.lp_taps],
                        amax=amax, signal_bits=signal_bits,
                        internal_bits=internal_bits,
                        octave_gains=octave_gains)
    _, tb, ib = _plan_bits(cfg)
    if signal_bits is not None:
        tb, ib = signal_bits, signal_bits + 2
    if internal_bits is not None:
        ib = internal_bits

    mu = _host(pipe.mu).astype(np.float64)
    sigma = _host(pipe.sigma).astype(np.float64)
    mu_q = np.asarray(np.round(mu / bank.acc.scale), np.int32)
    # phi = (s - mu) * g with g = 2**(acc.exp - phi.exp) / sigma, realized
    # as the best two-term CSD approximation g ~= 2**k1 + sign * 2**k2
    phi = pow2_spec_for(None, tb, amax=phi_amax)
    g = math.ldexp(1.0, bank.acc.exp - phi.exp) / np.maximum(sigma, 1e-30)
    k1s, k2s, s2s = [], [], []
    for gi in g:
        best = (math.inf, 0, 0, 0)
        for k1 in (math.floor(math.log2(gi)), math.ceil(math.log2(gi))):
            for sign, k2 in [(0, k1 - 1)] + [(s, k1 - d)
                                             for s in (-1, 1)
                                             for d in range(1, 7)]:
                approx = math.ldexp(1.0, k1) + sign * math.ldexp(1.0, k2)
                err = abs(approx - gi) / gi
                if err < best[0]:
                    best = (err, k1, k2, sign)
        k1s.append(best[1])
        k2s.append(best[2])
        s2s.append(best[3])
    phi_shift_q = np.asarray(k1s, np.int32)
    phi_shift2_q = np.asarray(k2s, np.int32)
    phi_sign2_q = np.asarray(s2s, np.int32)

    # classifier operand grid: cover |w|max + |phi|max at internal bits
    params = km.MPKernelMachineParams(*(_host(t) for t in pipe.clf.params))
    wp = np.maximum(params.w_pos.astype(np.float64), 0.0)
    wn = np.maximum(params.w_neg.astype(np.float64), 0.0)
    bias_amax = float(max(np.max(np.abs(params.b_pos)),
                          np.max(np.abs(params.b_neg)), 0.0))
    wmax = float(max(wp.max(), wn.max(), 1e-6))
    cover = max(wmax + phi.amax, bias_amax, 1.0)
    cspec = pow2_spec_for(None, ib, amax=cover)
    rom_spec = pow2_spec_for(None, tb, amax=max(wmax, bias_amax, 1e-6))
    wp_q, wn_q, bpos_q, bneg_q = km.quantize_params(params, rom_spec, cspec)
    gamma1 = float(np.exp(params.log_gamma1))
    gamma1_q = max(1, int(round(gamma1 / cspec.scale)))
    gamman_q = max(1, int(round(1.0 / cspec.scale)))
    clf = FixedClassifier(
        wp_q=wp_q, wn_q=wn_q, bpos_q=bpos_q, bneg_q=bneg_q, spec=cspec,
        phi_shift=phi.exp - cspec.exp,
        gamma1_q=gamma1_q, gamman_q=gamman_q,
        iters1=bisect_iters(gamma1_q), iters_n=bisect_iters(gamman_q))
    if clf.phi_shift < 0:
        raise ValueError("classifier operand grid coarser than phi grid "
                         f"(phi exp {phi.exp} < operand exp {cspec.exp})")
    return FixedPointProgram(bank=bank, mu_q=mu_q, phi_shift_q=phi_shift_q,
                             phi_shift2_q=phi_shift2_q,
                             phi_sign2_q=phi_sign2_q, phi=phi, clf=clf)


# ---------------------------------------------------------------------------
# program execution (int32 carrier = the hardware twin; float carrier =
# the fake-quant simulation — bit-identical by construction)
# ---------------------------------------------------------------------------


def quantize_signal(prog, x, carrier: str = "int") -> torch.Tensor:
    """ADC: float audio -> signal-format codes, int32 (``carrier="int"``)
    or float-carried (``carrier="float"``), on ``x``'s device."""
    if carrier not in ("int", "float"):
        raise ValueError(f"carrier must be 'int' or 'float', got {carrier!r}")
    signal = prog.signal
    dtype = torch.int32 if carrier == "int" else torch.float32
    return signal.quantize(x, dtype=dtype)


def bank_accumulate_q(bank: FixedBankProgram, xq: torch.Tensor, *,
                      use_pallas: bool = False) -> torch.Tensor:
    """Quantized signal (B, N) -> 32-bit accumulators (B, P) at
    ``bank.acc`` (the renormalization by 2**octave is in ``acc_shift``).

    ``use_pallas`` (MP mode) runs the whole cascade in one launch of the
    integer CUDA one-shot kernel (``kernels.fir_mp_oneshot_cascade_q``;
    its plain version, this loop's composition, for CPU tensors); MAC
    mode always runs the shift-add FIR."""
    mp = bank.mode == "mp"
    if use_pallas and mp:
        from repro_torch.kernels import fir_mp_oneshot_cascade_q
        s = fir_mp_oneshot_cascade_q(bank, xq.reshape(-1, xq.shape[-1]))
        return s.reshape(*xq.shape[:-1], s.shape[-1])
    x_o = xq
    parts = []
    for o, st in enumerate(bank.octaves):
        if mp:
            s = fxp_hwr_accumulate(fxp_fir_bank(
                rescale(x_o, st.sig_shift), _rom(st, "bp_q", x_o),
                st.gamma_bp, st.iters_bp, st.band_spec))
        else:
            bands = [rescale(fxp_fir_shift_add(x_o, st.bp_rom[f]),
                             st.bp_prod_shift)
                     for f in range(st.bp_rom.shape[0])]
            s = fxp_hwr_accumulate(_clamp(torch.stack(bands, dim=-2),
                                          st.band_spec))
        parts.append(shift_left(s, st.acc_shift))
        if st.lp_q is not None:
            if mp:
                y_lp = fxp_fir_bank(rescale(x_o, st.lp_sig_shift),
                                    _rom(st, "lp_q", x_o), st.gamma_lp,
                                    st.iters_lp, st.lp_spec)[..., 0, :]
            else:
                y_lp = _clamp(rescale(fxp_fir_shift_add(x_o, st.lp_rom[0]),
                                      st.lp_prod_shift), st.lp_spec)
            # requantize onto the NEXT octave's 8-bit register bank (its
            # exp carries that octave's calibrated pre-gain), then ÷2
            x_o = _clamp(rescale(y_lp, st.lp_out_shift),
                         bank.octaves[o + 1].in_spec)[..., ::2]
    return torch.cat(parts, dim=-1)


def standardize_q(prog: FixedPointProgram, s_q: torch.Tensor) -> torch.Tensor:
    """32-bit accumulators -> 8-bit standardized kernel vector: subtract
    the mu ROM, then the per-band two-term CSD reciprocal sigma."""
    diff = s_q - _rom(prog, "mu_q", s_q)
    t1 = rescale(diff, _rom(prog, "phi_shift_q", s_q, shift=True))
    t2 = rescale(diff, _rom(prog, "phi_shift2_q", s_q, shift=True))
    s2 = _rom(prog, "phi_sign2_q", s_q, shift=True)
    phi = torch.where(s2 > 0, t1 + t2, torch.where(s2 < 0, t1 - t2, t1))
    return _clamp(phi, prog.phi)


def classifier_q(clf: FixedClassifier, K_q: torch.Tensor) -> torch.Tensor:
    """Integer MP kernel machine (paper eq. 2-7): the operand layout of
    ``kernel_machine.forward``, solved by integer bisection."""
    K = shift_left(K_q, clf.phi_shift)          # phi grid -> operand grid
    Kp = K[:, :, None]
    Kn = -K[:, :, None]
    wp = _rom(clf, "wp_q", K_q)
    wn = _rom(clf, "wn_q", K_q)

    def z_of(a, b, bias):
        ops = torch.cat([_clamp(a[None] + Kp, clf.spec),
                         _clamp(b[None] + Kn, clf.spec)], dim=1)
        bias_col = _rom(clf, bias, K_q)[None, None, :].expand(
            ops.shape[0], 1, ops.shape[2])
        ops = torch.cat([ops, bias_col], dim=1)     # (B, 2P+1, C)
        return fxp_mp_bisect(ops.movedim(1, -1), clf.gamma1_q, clf.iters1)

    z_pos = z_of(wp, wn, "bpos_q")
    z_neg = z_of(wn, wp, "bneg_q")
    z = fxp_mp_bisect(torch.stack([z_pos, z_neg], dim=-1), clf.gamman_q,
                      clf.iters_n)
    return _relu(z_pos - z) - _relu(z_neg - z)


def infer_q(prog: FixedPointProgram, xq: torch.Tensor, *,
            use_pallas: bool = False):
    """The integer inference program: signal codes in, (p_q, phi_q, s_q)
    codes out. ``use_pallas`` runs the bank through the integer CUDA
    kernel, bit for bit the torch-op path."""
    with tracing.span("fixed.infer_q"):
        with tracing.span("fixed.bank"):
            s_q = bank_accumulate_q(prog.bank, xq, use_pallas=use_pallas)
        with tracing.span("fixed.readout"):
            phi_q = standardize_q(prog, s_q)
            p_q = classifier_q(prog.clf, phi_q)
    return p_q, phi_q, s_q


def predict(prog: FixedPointProgram, x, carrier: str = "int", *,
            use_pallas: bool = False):
    """Float audio (B, N) -> dequantized (p, phi). ``p`` carries scale
    ``2**clf.spec.exp`` (the [-1, 1] signed confidence)."""
    xq = quantize_signal(prog, x, carrier=carrier)
    p_q, phi_q, _ = infer_q(prog, xq, use_pallas=use_pallas)
    return prog.out_spec.dequantize(p_q), prog.phi.dequantize(phi_q)


# ---------------------------------------------------------------------------
# integer session streaming: every SessionState register is an integer on
# the fixed-point grid, and chunked execution is bit for bit the one-shot
# program
# ---------------------------------------------------------------------------


def readout_q(prog: FixedPointProgram, acc_q: torch.Tensor):
    """Readout from the 32-bit accumulator registers: (p_q, phi_q)."""
    phi_q = standardize_q(prog, acc_q)
    return classifier_q(prog.clf, phi_q), phi_q


def session_step_q(prog: FixedPointProgram, state, chunk_q: torch.Tensor,
                   n: torch.Tensor):
    """One slot-batched INTEGER session step in torch ops: codes in, codes
    out. The plain counterpart of the stream kernel's cascade
    (``kernels.fir_mp_stream_q``).

    ``state`` is a ``SessionState`` whose registers are on the grid: each
    octave's delay line holds that octave's 8-bit register codes, ``acc``
    the 32-bit accumulators, ``amax`` the running max |signal code|
    (telemetry: the ADC grid is static). ``chunk_q`` (S, L) is ADC codes
    with positions >= ``n`` zeroed; ``n`` (S,) effective valid counts.

    Every band value at a global position is one LSB-deterministic
    bisection over a window of register codes, the delay lines carry those
    codes across chunk boundaries (zero registers == the one-shot zero
    padding) and integer addition is associative: any chunking reproduces
    one-shot :func:`infer_q` bit for bit, from the first chunk. Returns
    ``(state', p_q, phi_q)``. Carrier-generic.
    """
    bank = prog.bank
    S, L = chunk_q.shape
    if L == 0:
        p_q, phi_q = readout_q(prog, state.acc)
        return state, p_q, phi_q
    dev = chunk_q.device
    T1 = state.delays[0].shape[1]
    amax = torch.maximum(state.amax, chunk_q.abs().amax(-1))
    rows = torch.arange(S, device=dev)[:, None]
    tail = torch.arange(T1, device=dev)[None, :]
    x_o, n_o = chunk_q, n.to(torch.int32)
    l_max = L
    delays, consumed, parts = [], [], []
    for o, st in enumerate(bank.octaves):
        M_bp = st.bp_q.shape[-1]
        # in-chunk position p sits at buf[T1 + p] with its FIR history
        buf = torch.cat([state.delays[o], x_o], dim=1)
        buf_bp = buf[:, T1 - (M_bp - 1):]
        if bank.mode == "mp":
            band = fxp_fir_bank(rescale(buf_bp, st.sig_shift),
                                _rom(st, "bp_q", buf_bp), st.gamma_bp,
                                st.iters_bp, st.band_spec,
                                pad=False)                   # (S, F, l_max)
        else:
            bands = [rescale(fxp_fir_shift_add(buf_bp, st.bp_rom[f],
                                               pad=False), st.bp_prod_shift)
                     for f in range(st.bp_rom.shape[0])]
            band = _clamp(torch.stack(bands, dim=-2), st.band_spec)
        parts.append(shift_left(fxp_hwr_accumulate(band, n_o[:, None]),
                                st.acc_shift))
        # the last T1 valid samples become the delay line (n_o == 0 slots
        # re-read their old registers: inert)
        delays.append(buf[rows, n_o.long()[:, None] + tail])
        consumed.append(state.consumed[o] + n_o)
        if st.lp_q is not None:
            M_lp = st.lp_q.shape[-1]
            # ÷2 keeps even GLOBAL positions: the slot's phase is its
            # octave-sample parity (bit-and, not a divider)
            start = torch.bitwise_and(state.consumed[o], 1)       # (S,)
            l_next = (l_max + 1) // 2
            buf_lp = buf[:, T1 - (M_lp - 1):]
            if bank.mode == "mp":
                # solve ONLY the kept positions: stride-2 window gather
                xw = F.pad(rescale(buf_lp, st.lp_sig_shift), (0, 1))
                widx = (2 * torch.arange(l_next, device=dev)[:, None]
                        + torch.arange(M_lp, device=dev)[None, :])
                win = xw[rows[:, :, None],
                         start.long()[:, None, None] + widx[None]]
                w_lp = _rom(st, "lp_q_reversed", xw,
                            make=lambda: st.lp_q[0, ::-1])
                kept = fxp_mp_dot(win, w_lp, st.gamma_lp, st.iters_lp,
                                  st.lp_spec)
            else:
                y_lp = _clamp(rescale(fxp_fir_shift_add(
                    buf_lp, st.lp_rom[0], pad=False), st.lp_prod_shift),
                    st.lp_spec)
                y_pad = F.pad(y_lp, (0, 2 * l_next + 1 - l_max))
                kept = y_pad[rows, start.long()[:, None]
                             + 2 * torch.arange(l_next, device=dev)[None]]
            x_o = _clamp(rescale(kept, st.lp_out_shift),
                         bank.octaves[o + 1].in_spec)
            # kept-count update: an arithmetic shift, not a divide
            n_o = torch.bitwise_right_shift(
                torch.clamp_min(n_o - start + 1, 0), 1)
            l_max = l_next
    acc = state.acc + torch.cat(parts, dim=-1)
    state = state._replace(delays=tuple(delays), consumed=tuple(consumed),
                           acc=acc, amax=amax, count=state.count + n)
    p_q, phi_q = readout_q(prog, acc)
    return state, p_q, phi_q
