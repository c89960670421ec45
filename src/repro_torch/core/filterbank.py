"""Multirate MP FIR filter bank (paper §III-C/D).

The input (fs = 16 kHz) feeds octave 0's band-pass filters directly; a
low-pass anti-aliasing filter + ÷2 downsampler feeds each later octave.
Per band: B_p(n) = FIR(x, h_p) in the MP domain, d_p(n) = max(0, B_p(n)),
s_p = sum_n d_p(n). The taps are precomputed constants (numpy windowed
sinc, copied from the reference so the port needs no JAX).

Under ``use_pallas`` the MP FIR routes to the hand-written CUDA kernels
(``repro_torch.kernels``) — on a CPU tensor those wrappers run their plain
PyTorch versions; otherwise the torch-op solvers in ``core.mp`` run.
With ``numerics="fixed"``, ``FilterBank.accumulate`` runs the integer
datapath of ``core.fixed`` instead; the functions here are the float
engine and refuse a fixed config.
"""

from __future__ import annotations

from typing import Literal, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import mp as mp_mod
from repro_torch.core.quant import fake_quant
from repro_torch.device import resolve_device

__all__ = [
    "FilterBankConfig",
    "FilterBank",
    "STREAM_BLOCK",
    "accumulate_block_len",
    "hwr_accumulate",
    "design_lowpass",
    "design_bandpass",
    "greenwood",
    "single_fir",
    "single_fir_valid",
    "bank_fir",
    "bank_fir_valid",
    "bank_accumulate",
    "quant_signal",
    "multirate_accumulate",
]

# Every path that sums HWR'd band outputs over positions (one-shot
# accumulate, the torch-op session step, the CUDA stream kernel) reduces in
# one order: a tree_sum per block of accumulate_block_len(l) positions,
# then one sequential add per block in ascending order.
STREAM_BLOCK = 512


def accumulate_block_len(n: int) -> int:
    """Next power of two >= n, clamped to [2, STREAM_BLOCK]. Always even,
    so the ÷2 decimator's kept-sample alignment is constant per block."""
    b = 2
    while b < n and b < STREAM_BLOCK:
        b <<= 1
    return b


def hwr_accumulate(y: torch.Tensor, valid=None) -> torch.Tensor:
    """s = sum_p HWR(y[..., p]) in the shared blocked order.

    ``valid`` (broadcastable to ``y.shape[:-1]``, e.g. ``n[:, None]`` for a
    (S, F, l) bank output) masks positions >= valid to exactly +0.0.
    """
    l = y.shape[-1]
    h = torch.clamp_min(y, 0.0)
    if valid is not None:
        pos = torch.arange(l, device=y.device)
        valid = torch.as_tensor(valid, device=y.device)
        h = torch.where(pos < valid[..., None], h, 0.0)
    if l == 0:
        return y.new_zeros(y.shape[:-1])
    lb = accumulate_block_len(l)
    nb = -(-l // lb)
    h = F.pad(h, (0, nb * lb - l))
    s = mp_mod.tree_sum(h.reshape(*y.shape[:-1], nb, lb))
    out = s[..., 0]
    for k in range(1, nb):            # sequential adds, ascending blocks
        out = out + s[..., k]
    return out


# ---------------------------------------------------------------------------
# FIR design (windowed sinc, numpy; the reference's, copied)
# ---------------------------------------------------------------------------


def _hamming(M: int) -> np.ndarray:
    n = np.arange(M)
    return 0.54 - 0.46 * np.cos(2 * np.pi * n / (M - 1))


def design_lowpass(num_taps: int, cutoff: float, fs: float) -> np.ndarray:
    """Windowed-sinc low-pass FIR, cutoff in Hz, unity DC gain."""
    fc = cutoff / fs
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 2 * fc * np.sinc(2 * fc * n)
    h = h * _hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def design_bandpass(num_taps: int, f_lo: float, f_hi: float,
                    fs: float) -> np.ndarray:
    """Band-pass as a difference of two low-passes, Hamming windowed, peak
    gain ~1 at the centre frequency."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = (2 * (f_hi / fs) * np.sinc(2 * (f_hi / fs) * n)
         - 2 * (f_lo / fs) * np.sinc(2 * (f_lo / fs) * n))
    h = h * _hamming(num_taps)
    fc = (f_lo + f_hi) / 2.0
    w = 2 * np.pi * fc / fs
    gain = np.abs(np.sum(h * np.exp(-1j * w * np.arange(num_taps))))
    return (h / max(gain, 1e-6)).astype(np.float32)


def greenwood(x: np.ndarray, fmin: float = 100.0,
              fmax: float = 8000.0) -> np.ndarray:
    """Greenwood cochlear frequency-position map scaled to [fmin, fmax]."""
    A, a, k = 165.4, 2.1, 0.88
    raw = A * (10 ** (a * x) - k)
    lo, hi = raw.min(), raw.max()
    return fmin + (raw - lo) * (fmax - fmin) / (hi - lo)


# ---------------------------------------------------------------------------
# Filtering primitives (shared by the one-shot and the session paths)
# ---------------------------------------------------------------------------


def _mac_fir_bank(x: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Multiplier baseline: x (B, N), H (F, M) -> (B, F, N), causal, zero
    initial state, as an explicit window product (no cuDNN)."""
    M = H.shape[-1]
    win = F.pad(x, (M - 1, 0)).unfold(-1, M, 1)          # (B, N, M)
    return torch.einsum("bnm,fm->bfn", win, H.flip(-1))


def single_fir(x: torch.Tensor, h: torch.Tensor,
               cfg: "FilterBankConfig") -> torch.Tensor:
    """x (B, N), h (M,) -> (B, N)."""
    if cfg.mode == "mac":
        return _mac_fir_bank(x, h[None])[:, 0]
    if cfg.use_pallas:
        from repro_torch.kernels import fir_mp
        return fir_mp(x, h, cfg.gamma_f)
    return mp_mod.mp_conv1d(x, h, cfg.gamma_f, exact=False,
                            solver=cfg.solver)


def bank_fir(x: torch.Tensor, taps: torch.Tensor,
             cfg: "FilterBankConfig") -> torch.Tensor:
    """Whole-octave band-pass: x (B, N), taps (F, M) -> (B, F, N)."""
    if cfg.mode == "mac":
        return _mac_fir_bank(x, taps)
    if cfg.use_pallas:
        from repro_torch.kernels import fir_mp_bank
        return fir_mp_bank(x, taps, cfg.gamma_f)
    return mp_mod.mp_conv1d_bank(x, taps, cfg.gamma_f, exact=False,
                                 solver=cfg.solver)


def single_fir_valid(x: torch.Tensor, h: torch.Tensor,
                     cfg: "FilterBankConfig") -> torch.Tensor:
    """Valid-mode FIR: x (B, N), h (M,) -> (B, N-M+1); window p covers
    x[p..p+M-1]. Shared positions match the padded form bitwise."""
    M = h.shape[0]
    if cfg.mode == "mp" and not cfg.use_pallas:
        return mp_mod.mp_conv1d(x, h, cfg.gamma_f, exact=False,
                                solver=cfg.solver, pad=False)
    return single_fir(x, h, cfg)[..., M - 1:]


def bank_fir_valid(x: torch.Tensor, taps: torch.Tensor,
                   cfg: "FilterBankConfig") -> torch.Tensor:
    """Valid-mode octave band-pass: x (B, N), taps (F, M) ->
    (B, F, N-M+1). See ``single_fir_valid``."""
    M = taps.shape[-1]
    if cfg.mode == "mp" and not cfg.use_pallas:
        return mp_mod.mp_conv1d_bank(x, taps, cfg.gamma_f, exact=False,
                                     solver=cfg.solver, pad=False)
    return bank_fir(x, taps, cfg)[..., M - 1:]


def bank_accumulate(x: torch.Tensor, taps: torch.Tensor,
                    cfg: "FilterBankConfig") -> torch.Tensor:
    """s_p = sum_n HWR(B_p(n)) for one octave: x (B, N) -> (B, F). MP under
    ``use_pallas`` fuses FIR + HWR + accumulate in the bank kernel."""
    if cfg.mode == "mp" and cfg.use_pallas:
        from repro_torch.kernels import fir_mp_bank_accumulate
        return fir_mp_bank_accumulate(x, taps, cfg.gamma_f)
    return hwr_accumulate(bank_fir(x, taps, cfg))


def quant_signal(x: torch.Tensor, cfg: "FilterBankConfig",
                 amax=None) -> torch.Tensor:
    """Symmetric per-stream signal quantization (no-op without
    ``quant_bits``). Each row's scale is its own amax, or the ``amax``
    given (the session path passes its running (S,) amax)."""
    if cfg.quant_bits is None:
        return x
    if amax is None:
        amax = x.abs().amax(-1, keepdim=True)
    else:
        amax = torch.as_tensor(amax, dtype=x.dtype, device=x.device)
        if amax.ndim == x.ndim - 1:
            amax = amax[..., None]
    return fake_quant(x, cfg.quant_bits, amax=amax)


def _require_float_numerics(cfg: "FilterBankConfig", fn: str) -> None:
    if cfg.numerics == "fixed":
        raise ValueError(
            f"{fn} does not support numerics='fixed': this is the float "
            "engine and ignores the fixed-point program; go through "
            "FilterBank.accumulate or InFilterPipeline.apply/predict "
            "(repro_torch.core.fixed)")
    if cfg.numerics != "float":
        raise ValueError(f"unknown numerics {cfg.numerics!r}: "
                         "expected 'float' or 'fixed'")


def multirate_accumulate(x: torch.Tensor, bp_taps, lp_taps,
                         cfg: "FilterBankConfig",
                         amax=None) -> torch.Tensor:
    """Full-bank accumulator readout: x (B, N) -> s (B, P); octave o's sums
    are renormalized by 2^o. MP under ``use_pallas`` runs the whole
    cascade in the one-shot cascade kernel (the same bits as the loop
    through the one-stage kernels)."""
    _require_float_numerics(cfg, "multirate_accumulate")
    x = quant_signal(x, cfg, amax)
    if cfg.mode == "mp" and cfg.use_pallas:
        from repro_torch.kernels import fir_mp_oneshot_cascade
        O = cfg.num_octaves
        s = fir_mp_oneshot_cascade(x.reshape(-1, x.shape[-1]), bp_taps[:O],
                                   lp_taps[:O - 1], cfg.gamma_f)
        return s.reshape(*x.shape[:-1], s.shape[-1])
    parts = []
    x_o = x
    for o in range(cfg.num_octaves):
        parts.append(bank_accumulate(x_o, bp_taps[o], cfg) * (2.0 ** o))
        if o < cfg.num_octaves - 1:
            x_o = single_fir(x_o, lp_taps[o], cfg)[..., ::2]
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Filter bank
# ---------------------------------------------------------------------------


class FilterBankConfig(NamedTuple):
    """Field names and allowed values are the reference's, so a reference
    config crosses the bridge unchanged. ``use_pallas`` routes the one-shot
    MP FIR through the CUDA bank kernels (float, or the integer bank kernel
    under ``numerics="fixed"``); ``stream_impl="pallas"`` runs the session
    step through the CUDA stream kernel of its numerics ("xla" is the
    torch-op cascade). ``numerics="fixed"`` is the bit-true int32 twin
    (``core.fixed``): power-of-two fixed point, add/sub/shift/compare
    only; ``fixed_amax`` is its static ADC full scale (inputs beyond it
    saturate)."""
    fs: float = 16000.0
    num_octaves: int = 6
    filters_per_octave: int = 5
    bp_taps: int = 16
    lp_taps: int = 6
    mode: Literal["mp", "mac"] = "mp"
    gamma_f: float = 4.0
    use_pallas: bool = False
    spacing: Literal["octave", "greenwood"] = "octave"
    quant_bits: int | None = None
    solver: Literal["newton", "bisect"] = "newton"
    stream_impl: Literal["xla", "pallas"] = "xla"
    numerics: Literal["float", "fixed"] = "float"
    fixed_amax: float = 1.0

    @property
    def num_filters(self) -> int:
        return self.num_octaves * self.filters_per_octave


class FilterBank:
    """Precomputed multirate filter bank.

    ``bp_taps`` / ``lp_tap_list`` hold the numpy taps (identical to the
    reference's); ``bp_by_octave`` / ``lp_filters`` the stacked tensors on
    ``device`` (``cuda`` unless given).
    """

    def __init__(self, config: FilterBankConfig, device=None):
        if config.numerics not in ("float", "fixed"):
            raise ValueError(f"unknown numerics {config.numerics!r}: "
                             "expected 'float' or 'fixed'")
        if config.numerics == "fixed" and config.mode not in ("mp", "mac"):
            raise ValueError(
                f"numerics='fixed' has no {config.mode!r}-mode datapath")
        self.config = c = config
        self._fixed_bank = None   # lazy compile_bank cache
        self.device = resolve_device(device)
        nyq = c.fs / 2.0
        self.bp_taps: list[np.ndarray] = []
        self.octave_of: list[int] = []
        for o in range(c.num_octaves):
            f_hi, f_lo = nyq / (2 ** o), nyq / (2 ** (o + 1))
            rate = c.fs / (2 ** o)
            if c.spacing == "octave":
                edges = np.linspace(f_lo, f_hi, c.filters_per_octave + 1)
            else:
                edges = greenwood(np.linspace(0, 1, c.filters_per_octave + 1),
                                  f_lo, f_hi)
            for p in range(c.filters_per_octave):
                self.bp_taps.append(
                    design_bandpass(c.bp_taps, edges[p], edges[p + 1], rate))
                self.octave_of.append(o)
        self.lp_tap_list = [
            design_lowpass(c.lp_taps, (c.fs / 2 ** o) / 4.0, c.fs / 2 ** o)
            for o in range(c.num_octaves - 1)
        ]
        if c.quant_bits is not None:
            q = lambda h: fake_quant(torch.from_numpy(h), c.quant_bits).numpy()
            self.bp_taps = [q(h) for h in self.bp_taps]
            self.lp_tap_list = [q(h) for h in self.lp_tap_list]
        Fo = c.filters_per_octave
        self._bp_by_octave = tuple(
            torch.from_numpy(np.stack(self.bp_taps[o * Fo:(o + 1) * Fo]))
            .to(self.device) for o in range(c.num_octaves))
        self._lp = tuple(torch.from_numpy(h).to(self.device)
                         for h in self.lp_tap_list)

    @property
    def bp_by_octave(self) -> tuple:
        """Stacked (F, M) band-pass taps per octave."""
        return self._bp_by_octave

    @property
    def lp_filters(self) -> tuple:
        """Anti-aliasing low-pass taps per ÷2 stage."""
        return self._lp

    def fixed_bank(self):
        """The compiled integer bank program (``numerics="fixed"``), built
        once from these float taps (``core.fixed.compile_bank``)."""
        if self._fixed_bank is None:
            from repro_torch.core import fixed
            self._fixed_bank = fixed.compile_bank(
                self.config, self._bp_by_octave, self._lp)
        return self._fixed_bank

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """s_p = sum_n HWR(B_p(n)) for every filter: x (B, N) -> (B, P).

        With ``numerics="fixed"`` this runs the integer datapath and
        dequantizes the 32-bit accumulators."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if self.config.numerics == "fixed":
            from repro_torch.core import fixed
            bank = self.fixed_bank()
            return bank.acc.dequantize(fixed.bank_accumulate_q(
                bank, fixed.quantize_signal(bank, x),
                use_pallas=self.config.use_pallas))
        return multirate_accumulate(x, self._bp_by_octave, self._lp,
                                    self.config)
