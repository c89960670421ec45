"""Wrappers of the hand-written CUDA kernels for the MP FIR.

* ``fir_mp_stream_cascade`` — ``csrc/fir_mp_stream.cu``, the float
  session step's whole octave cascade in one launch (replaces the
  reference's per-octave loop of Pallas ``fir_mp_stream_octave`` calls);
* ``fir_mp_stream_octave`` — the same kernel on one octave (replaces the
  Pallas ``fir_mp_stream_octave``);
* ``fir_mp_oneshot_cascade`` — ``csrc/fir_mp_bank.cu``, the float
  one-shot bank's whole multirate cascade in one launch (replaces the
  reference's per-octave loop of Pallas ``fir_mp_bank_pallas`` and
  ``fir_mp_pallas`` calls in ``multirate_accumulate``);
* ``fir_mp_bank_kernel`` — the same kernel on one stage, the one-shot
  bank (replaces ``fir_mp_bank_pallas``);
* ``fir_mp_kernel`` — the same with one filter (replaces
  ``fir_mp_pallas``);
* ``fir_mp_stream_cascade_q`` / ``fir_mp_stream_octave_q`` —
  ``csrc/fir_mp_stream_q.cu``, the integer session step, whole cascade or
  one octave (replaces ``fir_mp_stream_octave_q``);
* ``fir_mp_oneshot_cascade_q`` — ``csrc/fir_mp_bank_q.cu``, the integer
  one-shot bank's whole multirate cascade in one launch (replaces the
  reference's per-octave loop of Pallas ``fir_mp_bank_q_pallas`` calls in
  ``core.fixed.bank_accumulate_q``);
* ``fir_mp_bank_q_kernel`` — the same kernel on one stage, the one-shot
  integer bank, both modes (replaces ``fir_mp_bank_q_pallas``).

A CUDA tensor launches the kernel on ``torch.cuda.current_stream()``; a CPU
tensor runs the plain PyTorch version in ``kernels.ref``; any other device
raises. There is no fallback from one to the other. Outputs are allocated
here with ``torch.empty``; a refused launch raises at once. The integer
kernels take codes on either carrier of the reference's integer datapath:
int32 (the hardware twin) or integer values carried in float32 (the
fake-quant twin), each through its own instance of the kernel, which
computes on that carrier (:func:`_carrier`). All the codes of one call
share a carrier (a mix, or another dtype, raises on either device); the
tap and stage tables stay int32 and the kernels read them onto it.

The two stream kernels take a launch plan (:func:`stream_plan`: threads,
shared bytes, scratch) and a table of per-octave rows packed here
(:func:`stream_octave_rows`, :func:`stream_q_octave_rows`); the integer
one also reads the compiled stage constants from a device table
(:func:`pack_stages`), packed once per program. The one-shot bank kernels
take a work plan (:func:`oneshot_plan`: items, scratch and counter
layout) and a table of per-octave rows (:func:`oneshot_octave_rows`,
:func:`oneshot_q_octave_rows`); the integer one reads its stage constants
from the same stage table as the int stream kernel.

Each launch is counted in ``kernels._wrap.LAUNCHES`` (``count_launch``).
"""

from __future__ import annotations

import functools
import itertools
import types

import numpy as np
import torch

from repro_torch.core.filterbank import accumulate_block_len
from repro_torch.kernels import ref
from repro_torch.kernels._wrap import (_check, _expect, _f32, _on_cuda,
                                       _stream, count_launch)

__all__ = ["fir_mp_stream_cascade", "fir_mp_stream_octave",
           "fir_mp_bank_kernel", "fir_mp_kernel", "fir_mp_oneshot_cascade",
           "oneshot_plan", "oneshot_octave_rows", "oneshot_ctas",
           "fir_mp_stream_cascade_q", "fir_mp_stream_octave_q",
           "fir_mp_oneshot_cascade_q", "oneshot_q_octave_rows",
           "fir_mp_bank_q_kernel", "stream_plan",
           "stream_octave_rows", "stream_q_octave_rows", "pack_stages"]

_SOLVERS = {"newton": 0, "bisect": 1}

# -- the stream kernels' launch plan and tables --------------------------------

STREAM_MAX_THREADS = 256   # the kernels' __launch_bounds__ (PERF.md §6)
STREAM_MAX_OCTAVES = 8
STREAM_MAX_F = 32          # filters per octave
STREAM_MAX_M = 16          # band-pass taps
STREAM_MAX_M_LP = 8        # low-pass taps
STREAM_MAX_T1 = 31         # delay-line length
# shared words beside the per-block arrays: the stage header, the low-pass
# lanes, the group sums per filter and the per-warp maxima
_HEAD, _LP_LANES, _SEG = 32, 8, 16
# the int64 fields of one octave row, in the order of the C enums
STREAM_OCTAVE_FIELDS = ("delay_in", "delay_out", "phase_in", "consumed_out",
                        "bp", "lp", "F", "col", "emit")
STREAM_Q_OCTAVE_FIELDS = ("delay_in", "delay_out", "phase_in",
                          "consumed_out", "col")
# the int32 header of one compiled stage in the device table, in the order
# of csrc/fir_mp_stream_q.cu; the (F, M) band-pass codes follow at
# STAGE_HEAD (rows reversed), the low-pass codes at STAGE_HEAD +
# STAGE_MAX_BP (reversed)
STAGE_FIELDS = ("F", "M", "M_lp", "T1", "sig_shift", "lp_sig_shift",
                "lp_out_shift", "acc_shift", "gamma_bp", "iters_bp",
                "gamma_lp", "iters_lp", "band_qmin", "band_qmax", "lp_qmin",
                "lp_qmax", "next_qmin", "next_qmax", "emit")
STAGE_HEAD, STAGE_MAX_BP = _HEAD, 512
STAGE_WORDS = STAGE_HEAD + STAGE_MAX_BP + _LP_LANES


@functools.lru_cache(maxsize=64)
def stream_plan(L: int, F: int, M: int, M_lp: int, T1: int, *,
                octaves: int = 1, integer: bool = False):
    """The launch plan of a stream kernel (the float one, or the int one
    under ``integer``) for chunks of L samples over ``octaves`` octaves of
    at most F filters, M band-pass taps, M_lp low-pass taps and a delay
    line of T1. Cached per shape, read-only.

    Per octave o (L_o = ceil(L / 2^o)): the block length LB_o, the blocks,
    and the work items of a full block (each band-pass (position, filter)
    pair and each kept low-pass position, in two branches: the most a
    block can hold; the kernel sizes its loop to the valid counts).
    ``threads`` per CTA: as many as the largest block's items, rounded up
    to a warp, capped at ``STREAM_MAX_THREADS``; ``smem_bytes`` the
    kernel's dynamic shared memory; ``scratch`` the length of the per-slot
    row that carries the kept signal from octave to octave (0 for one
    octave). Shapes outside the kernels raise ValueError, as the kernels
    refuse them."""
    for name, val, lo, hi in (("F", F, 1, STREAM_MAX_F),
                              ("M", M, 1, STREAM_MAX_M),
                              ("M_lp", M_lp, 1, STREAM_MAX_M_LP),
                              ("T1", T1, 0, STREAM_MAX_T1),
                              ("octaves", octaves, 1, STREAM_MAX_OCTAVES),
                              ("L", L, 1, None)):
        if val < lo or (hi is not None and val > hi):
            raise ValueError(f"stream kernels: {name} = {val} outside "
                             f"[{lo}, {hi if hi is not None else 'inf'}]")
    if M - 1 > T1 or M_lp - 1 > T1:
        raise ValueError(f"stream kernels: the delay line (T1 = {T1}) must "
                         f"hold M - 1 = {M - 1} and M_lp - 1 = {M_lp - 1}")
    lens, blocks, items = [], [], []
    L_o = L
    for o in range(octaves):
        LB = accumulate_block_len(L_o)
        lens.append(LB)
        blocks.append(-(-L_o // LB))
        emit = o < octaves - 1 or octaves == 1
        items.append(2 * (min(L_o, LB) * F + (LB // 2 if emit else 0)))
        L_o = (L_o + 1) // 2
    LB0 = lens[0]
    # [delay line | block], the stage header, the taps, the low-pass lanes,
    # the F x LB HWR values, then the float kernel's group sums, partials
    # and per-warp maxima, or the int kernel's partials and running amax
    words = T1 + LB0 + _HEAD + F * M + _LP_LANES + F * LB0 + F
    words += 1 if integer else F * _SEG + STREAM_MAX_THREADS // 32
    return types.MappingProxyType(dict(
        threads=min(STREAM_MAX_THREADS, -(-max(items) // 32) * 32),
        smem_bytes=4 * words, scratch=(L + 1) // 2 if octaves > 1 else 0,
        block_len=tuple(lens), blocks=tuple(blocks),
        items_per_block=tuple(items)))


def stream_octave_rows(delays, delays_out, phases, consumed_out, bp_taps,
                       lp_taps, scales=None):
    """The float stream kernel's table: one int64 row per octave in
    ``STREAM_OCTAVE_FIELDS`` order (the tensors' addresses; F; the first
    accumulator column, octaves laid out F after F; whether the octave
    emits, i.e. has low-pass taps) and the f32 scales, 2^o unless given.
    ``consumed_out`` may hold None (the one-octave entry writes none);
    ``lp_taps[o]`` None for an octave that does not emit."""
    O = len(delays)
    rows, col = [], 0
    for d, do, ph, co, bp, lp in zip(delays, delays_out, phases,
                                     consumed_out, bp_taps, lp_taps):
        F = bp.shape[0]
        rows.append((d.data_ptr(), do.data_ptr(), ph.data_ptr(),
                     0 if co is None else co.data_ptr(), bp.data_ptr(),
                     0 if lp is None else lp.data_ptr(), F, col,
                     int(lp is not None)))
        col += F
    return (np.array(rows, np.int64), _octave_scales(O) if scales is None
            else np.asarray(scales, np.float32))


@functools.lru_cache(maxsize=None)
def _octave_scales(O: int) -> np.ndarray:
    """2^o for o < O, as the float kernel reads them (read-only)."""
    scales = np.float32(2.0) ** np.arange(O, dtype=np.float32)
    scales.flags.writeable = False
    return scales


def stream_q_octave_rows(delays, delays_out, phases, consumed_out, cols):
    """The int stream kernel's table: one int64 row per octave in
    ``STREAM_Q_OCTAVE_FIELDS`` order; its constants live in the stage
    table (:func:`pack_stages`)."""
    return np.asarray([(d.data_ptr(), do.data_ptr(), ph.data_ptr(),
                        0 if co is None else co.data_ptr(), c)
                       for d, do, ph, co, c in zip(delays, delays_out, phases,
                                                   consumed_out, cols)],
                      np.int64).reshape(len(delays),
                                        len(STREAM_Q_OCTAVE_FIELDS))


def pack_stages(stages, next_specs, T1: int) -> np.ndarray:
    """The int stream kernel's stage table: one row of ``STAGE_WORDS``
    int32 per compiled ``OctaveStage``: the ``STAGE_FIELDS`` header, the
    band-pass codes with each row reversed (conv order w = h[::-1]) at
    ``STAGE_HEAD``, the low-pass codes reversed after ``STAGE_MAX_BP``.
    ``next_specs[o]`` is the next octave's register spec, or None for a
    stage that emits no low-pass output (its low-pass fields then hold the
    band spec's bounds and zeros, which the kernel never reads)."""
    table = np.zeros((len(stages), STAGE_WORDS), np.int32)
    for o, (st, nxt) in enumerate(zip(stages, next_specs)):
        bp = _host_codes(st.bp_q)
        F, M = bp.shape
        emit = nxt is not None
        if emit and st.lp_q is None:
            raise ValueError(f"stage {o} has no low-pass taps to emit with")
        if F * M > STAGE_MAX_BP:
            raise ValueError(f"stage {o}: F x M = {F * M} tap codes exceed "
                             f"the table's {STAGE_MAX_BP}")
        lp = _host_codes(st.lp_q).reshape(-1) if emit else np.zeros(0, np.int32)
        lp_spec = st.lp_spec if emit else st.band_spec
        nxt = nxt if emit else st.band_spec
        head = dict(F=F, M=M, M_lp=lp.shape[0], T1=T1, sig_shift=st.sig_shift,
                    lp_sig_shift=st.lp_sig_shift,
                    lp_out_shift=st.lp_out_shift, acc_shift=st.acc_shift,
                    gamma_bp=st.gamma_bp, iters_bp=st.iters_bp,
                    gamma_lp=st.gamma_lp, iters_lp=st.iters_lp,
                    band_qmin=st.band_spec.qmin, band_qmax=st.band_spec.qmax,
                    lp_qmin=lp_spec.qmin, lp_qmax=lp_spec.qmax,
                    next_qmin=nxt.qmin, next_qmax=nxt.qmax, emit=int(emit))
        table[o, :len(STAGE_FIELDS)] = [head[k] for k in STAGE_FIELDS]
        table[o, STAGE_HEAD:STAGE_HEAD + F * M] = bp[:, ::-1].reshape(-1)
        lp0 = STAGE_HEAD + STAGE_MAX_BP
        table[o, lp0:lp0 + lp.shape[0]] = lp[::-1]
    return table


def _device_table(owner, key, make, device) -> torch.Tensor:
    """``make()`` on ``device``, cached on ``owner`` (a frozen program
    object: the cache sits in its instance dict, outside its fields)."""
    cache = vars(owner).setdefault("_cuda_stream_tables", {})
    key = (str(device), key)
    if key not in cache:
        cache[key] = torch.from_numpy(make()).to(device)
    return cache[key]


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


CARRIERS = (torch.int32, torch.float32)


def _launch_key(kernel: str, codes: torch.Tensor) -> str:
    """The ``LAUNCHES`` key of an int kernel's launch: its name for the
    int32 instance, ``<name>_f32`` for the float-carrier one."""
    return kernel if codes.dtype == torch.int32 else f"{kernel}_f32"


def _carrier(kernel: str, *codes) -> torch.dtype:
    """The carrier of one call's codes, given as (name, tensor) pairs:
    int32 (the hardware twin) or float32 carrying integer values (the
    fake-quant twin). Every code of a call shares it: another dtype, or a
    mix of the two, raises ValueError."""
    seen = {}
    for name, t in codes:
        if t.dtype not in CARRIERS:
            raise ValueError(
                f"{kernel}: {name} is {t.dtype}; the int kernels take codes "
                "carried in int32 or in float32 (integer values) only")
        seen.setdefault(t.dtype, name)
    if len(seen) > 1:
        got = ", ".join(f"{name} {dt}" for dt, name in seen.items())
        raise ValueError(
            f"{kernel}: mixed carriers ({got}): the codes of one call "
            "(signal, delay lines, accumulators, amax) share one carrier, "
            "int32 or float32")
    return next(iter(seen))


def _host_codes(a) -> np.ndarray:
    """Program constants (tap codes) as a contiguous int32 host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=np.int32)


def _stream_launch(x, n, acc, amax, acc_out, amax_out, y, rows, scales, *,
                   L, P, ystride, M, M_lp, T1, gamma, solver, update_amax,
                   cascade, plan):
    from repro_torch.kernels._build import load
    S = x.shape[0]
    return load("fir_mp_stream")(
        x.data_ptr(), n.data_ptr(), acc.data_ptr(), amax.data_ptr(),
        acc_out.data_ptr(), None if amax_out is None else amax_out.data_ptr(),
        None if y is None else y.data_ptr(), rows.ctypes.data,
        scales.ctypes.data, rows.shape[0], S, L, P, ystride, M, M_lp, T1,
        float(gamma), _SOLVERS[solver], int(update_amax), int(cascade),
        plan["threads"], plan["smem_bytes"], _stream())


def fir_mp_stream_cascade(chunk, n, delays, consumed, acc, amax, bp_taps,
                          lp_taps, gamma, *, solver: str = "newton",
                          update_amax: bool = True):
    """The float session step's octave cascade: one launch on the card,
    the plain per-octave loop (``ref.fir_mp_stream``) on the CPU.

    chunk (S, L), invalid tails zeroed (and quantized, if deployed
    quantized: then pass the already-updated running amax and
    ``update_amax=False``); n (S,) valid counts (0 for inert slots);
    ``delays[o]`` (S, T1) and ``consumed[o]`` (S,) int32 per octave; acc
    (S, P), P = octaves x F; amax (S,); ``bp_taps[o]`` (F, M),
    ``lp_taps[o]`` (M_lp,) for every octave but the last. Each octave's
    phase is ``consumed[o] & 1``, the next valid count
    ``max(n - phase + 1, 0) >> 1``; amax rises at octave 0 under
    ``update_amax`` (otherwise ``amax`` comes back as given). Returns
    ``(delays', consumed', acc', amax')``, bit for bit
    ``ref.fir_mp_stream``; a slot with n == 0 gets its registers back."""
    if solver not in _SOLVERS:
        raise ValueError(f"unknown MP solver: {solver!r}")
    O = len(delays)
    if len(consumed) != O or len(bp_taps) < O or len(lp_taps) < O - 1:
        raise ValueError(f"{O} delay lines need {O} consumed counters, "
                         f"{O} band-pass and {O - 1} low-pass tap sets")
    bps, lps = bp_taps[:O], lp_taps[:O - 1]
    if not _on_cuda(chunk, n, acc, amax, *delays, *consumed, *bps, *lps):
        return ref.fir_mp_stream(chunk, n, delays, consumed, acc, amax,
                                 bp_taps, lp_taps, gamma, solver=solver,
                                 update_amax=update_amax)
    plan, ins = _cascade_inputs(chunk, n, delays, consumed, acc, amax, bps,
                                lps)
    chunk, n, delays, consumed, acc, amax, bps, lps = ins
    (S, L), (Fn, M), T1 = chunk.shape, bps[0].shape, delays[0].shape[1]
    M_lp = lps[0].shape[0] if lps else 1
    delays_out, consumed_out, acc_out, amax_out, scratch = _cascade_outputs(
        plan, acc, amax, O, T1=T1, update_amax=update_amax)
    rows, scales = stream_octave_rows(delays, delays_out, consumed,
                                      consumed_out, bps, lps + [None])
    code = _stream_launch(chunk, n, acc, amax, acc_out, amax_out, scratch,
                          rows, scales, L=L, P=O * Fn,
                          ystride=plan["scratch"], M=M, M_lp=M_lp, T1=T1,
                          gamma=gamma, solver=solver,
                          update_amax=update_amax, cascade=True, plan=plan)
    if code:
        _check(code, "fir_mp_stream_cascade", f"S={S} L={L} octaves={O} "
                                              f"F={Fn} M={M} T1={T1} "
                                              f"M_lp={M_lp}")
    count_launch("fir_mp_stream_cascade")
    return (tuple(delays_out.unbind(0)), tuple(consumed_out.unbind(0)),
            acc_out, amax_out if update_amax else amax)


def _cascade_inputs(chunk, n, delays, consumed, acc, amax, bps, lps):
    """The float cascade's checks and conversions on CUDA tensors: its
    launch plan and the inputs as the kernel reads them (contiguous, f32
    or int32). Shapes the kernel does not take raise."""
    O = len(delays)
    S, L = chunk.shape
    Fn, M = bps[0].shape
    T1 = delays[0].shape[1]
    M_lp = lps[0].shape[0] if lps else 1
    for o in range(O):
        _expect(f"delays[{o}]", delays[o], (S, T1))
        _expect(f"consumed[{o}]", consumed[o], (S,))
        _expect(f"bp_taps[{o}]", bps[o], (Fn, M))
        if o < O - 1:
            _expect(f"lp_taps[{o}]", lps[o], (M_lp,))
    for name, t, shape in (("n", n, (S,)), ("acc", acc, (S, O * Fn)),
                           ("amax", amax, (S,))):
        _expect(name, t, shape)
    plan = stream_plan(L, Fn, M, M_lp, T1, octaves=O)
    return plan, (_f32(chunk, "chunk"), _i32(n),
                  [_f32(d, f"delays[{o}]") for o, d in enumerate(delays)],
                  [_i32(c) for c in consumed], _f32(acc, "acc"),
                  _f32(amax, "amax"),
                  [_f32(h, f"bp_taps[{o}]") for o, h in enumerate(bps)],
                  [_f32(h, f"lp_taps[{o}]") for o, h in enumerate(lps)])


def _cascade_outputs(plan, acc, amax, O, *, T1, update_amax=True):
    """A cascade's fresh outputs beside acc (S, P) and amax (S,), in their
    dtype: the delay lines (O, S, T1), the consumed counters (O, S) int32,
    acc', amax' (None unless ``update_amax``) and the scratch row (None
    for one octave)."""
    S, dev = acc.shape[0], acc.device
    return (torch.empty((O, S, T1), dtype=acc.dtype, device=dev),
            torch.empty((O, S), dtype=torch.int32, device=dev),
            torch.empty_like(acc),
            torch.empty_like(amax) if update_amax else None,
            torch.empty((S, plan["scratch"]), dtype=acc.dtype, device=dev)
            if O > 1 else None)


def fir_mp_stream_octave(x, n, start, delay, acc, amax, H, lp, gamma, *,
                         scale: float = 1.0, solver: str = "newton",
                         emit_next: bool = True, update_amax: bool = False):
    """One octave of the stateful session step (the stream kernel with one
    table row).

    x (S, L) this octave's chunk (octave 0: invalid tails zeroed); n (S,)
    valid counts; start (S,) ÷2 phase; delay (S, T1) delay line; acc
    (S, F) this octave's accumulators; amax (S,) running amax (updated only
    under ``update_amax``); H (F, M) band-pass taps; lp (M_lp,) low-pass
    taps (unused without ``emit_next``). Returns ``(acc', delay', amax',
    y_next | None)``; y_next is (S, ceil(L/LB) * LB // 2), every kept
    low-pass position of every block, the next octave's signal in its
    first ``(L + 1) // 2`` columns.
    """
    if solver not in _SOLVERS:
        raise ValueError(f"unknown MP solver: {solver!r}")
    if not _on_cuda(x, n, start, delay, acc, amax, H, lp):
        return ref.fir_mp_stream_octave(
            x, n, start, delay, acc, amax, H, lp, gamma, scale=scale,
            solver=solver, emit_next=emit_next, update_amax=update_amax)
    S, L = x.shape
    Fn, M = H.shape
    T1 = delay.shape[1]
    M_lp = lp.shape[0]
    for name, t, shape in (("n", n, (S,)), ("start", start, (S,)),
                           ("delay", delay, (S, T1)), ("acc", acc, (S, Fn)),
                           ("amax", amax, (S,)), ("lp", lp, (M_lp,))):
        _expect(name, t, shape)
    plan = stream_plan(L, Fn, M, M_lp, T1)
    LB = plan["block_len"][0]
    ystride = plan["blocks"][0] * (LB // 2)
    x, delay, acc, amax, H, lp = (
        _f32(t, nm) for t, nm in ((x, "x"), (delay, "delay"), (acc, "acc"),
                                  (amax, "amax"), (H, "H"), (lp, "lp")))
    n, start = _i32(n), _i32(start)
    acc_o = torch.empty_like(acc)
    delay_o = torch.empty_like(delay)
    amax_o = torch.empty_like(amax)
    y_next = (torch.empty((S, ystride), dtype=x.dtype, device=x.device)
              if emit_next else None)
    rows, scales = stream_octave_rows([delay], [delay_o], [start], [None],
                                      [H], [lp if emit_next else None],
                                      [scale])
    code = _stream_launch(x, n, acc, amax, acc_o, amax_o, y_next, rows,
                          scales, L=L, P=Fn, ystride=ystride, M=M,
                          M_lp=M_lp, T1=T1, gamma=gamma, solver=solver,
                          update_amax=update_amax, cascade=False, plan=plan)
    _check(code, "fir_mp_stream_octave",
           f"S={S} L={L} F={Fn} M={M} T1={T1} M_lp={M_lp}")
    count_launch("fir_mp_stream_octave")
    return acc_o, delay_o, amax_o, y_next


# -- the one-shot bank kernel: plan, table, wrappers ----------------------------

ONESHOT_MAX_OCTAVES = 8
ONESHOT_MAX_M = 16         # taps of either filter
# work item kinds, in the order of the C enum
ONESHOT_KINDS = ("keep", "band", "out")
# the int64 fields of one octave row, in the order of the C enum
ONESHOT_OCTAVE_FIELDS = ("src", "bp", "fir", "dst", "partial", "ready_in",
                         "ready_out", "done", "n", "tiles", "fir_F",
                         "fir_tiles", "out_len", "stride", "ready_target",
                         "col", "scale_exp")


def _frozen(a) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.int32)
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=64)
def oneshot_plan(B: int, N: int, F: int, *, octaves: int = 1,
                 output: bool = False, ctas: int = 0, integer: bool = False):
    """The work plan of the one-shot bank kernel (the float one, or the int
    one under ``integer``) on x (B, N) with F band-pass filters per octave
    over ``octaves`` octaves, or, under ``output``, one octave's F outputs
    at every position (the one-stage output mode). Cached per shape,
    read-only.

    Per octave o: its signal's length ``lens[o]`` (N, then ceil(N_o / 2)),
    its band tiles ceil(N_o / 256) and the keep tiles of its low-pass,
    ceil(N_{o+1} / 256) per row. Work items hold 256 outputs: a (row,
    kept tile) of a low-pass stage ("keep"), a (row, filter, tile) of an
    octave's band-pass ("band") or of the output mode ("out").
    ``segments`` (int32 rows: kind index in ``ONESHOT_KINDS``, octave,
    first queue item, items, first item of that kind and octave) give the
    queue order: keep stage o, then band-pass items to fill the CTAs that
    the stage before it frees (``ctas``, the grid, for the first stage;
    band items of octaves <= o, octave 0 first), then keep stage o + 1,
    and so on; then every band item left. One launch runs the whole
    queue. ``ctas`` is a scheduling hint only (0: no band items before
    the second keep stage). Scratch (f32 words): x_o (B, N_o) at
    ``sig_off[o]`` for o >= 1, then octave o's partials (B, F, tiles) at
    ``part_off[o]``. Counters (uint32 words, zeroed per call): the queue
    head, then per octave o >= 1 a ready counter per row at
    ``ready_off[o]``, then a done counter per (row, filter) at
    ``done_off[o]``. Under ``integer`` the band sums are integers, which
    add in any order: there are no partials and no done counters, the
    scratch holds the signals x_o only (on the codes' carrier) and the
    counters the head and the ready counters; on float32-carried codes the
    int kernel's ordered sums take partials and done counters that
    ``_oneshot_q_launch`` sizes beside the plan. Shapes outside the kernel
    raise ValueError, as the kernel refuses them."""
    for name, val, hi in (("B", B, None), ("N", N, None), ("F", F, None),
                          ("octaves", octaves, ONESHOT_MAX_OCTAVES)):
        if val < 1 or (hi is not None and val > hi):
            raise ValueError(f"one-shot bank kernel: {name} = {val} outside "
                             f"[1, {hi if hi is not None else 'inf'}]")
    if output and octaves != 1:
        raise ValueError("the one-shot bank kernel's output mode runs one "
                         f"octave, not {octaves}")
    T = ref.BANK_TILE
    lens = [N]
    for _ in range(octaves - 1):
        lens.append((lens[-1] + 1) // 2)
    tiles = tuple(-(-n // T) for n in lens)
    keep = tuple(-(-n // T) for n in lens[1:])
    segments = []
    taken = {}                  # (kind, octave) -> items queued so far
    band_left = [B * F * t for t in tiles]

    def queue(kind, o, count):
        k = ONESHOT_KINDS.index(kind)
        if segments and segments[-1][:2] == [k, o]:   # extend the last one
            segments[-1][3] += count
        else:
            start = segments[-1][2] + segments[-1][3] if segments else 0
            segments.append([k, o, start, count, taken.get((k, o), 0)])
        taken[(k, o)] = taken.get((k, o), 0) + count

    def fill(count, last_octave):
        for o in range(last_octave + 1):
            n = min(count, band_left[o])
            if n > 0:
                queue("band", o, n)
                band_left[o] -= n
                count -= n

    if output:
        queue("out", 0, B * F * tiles[0])
    else:
        freed = ctas
        for o, k in enumerate(keep):
            queue("keep", o, B * k)
            fill(freed - B * k, o)
            freed = B * k
        fill(sum(band_left), octaves - 1)
    items = segments[-1][2] + segments[-1][3]
    if items >= 2 ** 31:
        raise ValueError(f"one-shot bank kernel: {items} work items exceed "
                         "int32")
    sig_off, part_off, words = [0] * octaves, [0] * octaves, 0
    for o in range(1, octaves):
        sig_off[o], words = words, words + B * lens[o]
    ready_off, done_off, ctr = [0] * octaves, [0] * octaves, 1
    for o in range(1, octaves):
        ready_off[o], ctr = ctr, ctr + B
    if not (output or integer):
        for o in range(octaves):
            part_off[o], words = words, words + B * F * tiles[o]
            done_off[o], ctr = ctr, ctr + B * F
    return types.MappingProxyType(dict(
        F=F, output=output, integer=integer, lens=tuple(lens), tiles=tiles,
        keep_tiles=keep,
        segments=_frozen(segments).reshape(-1, 5), items=items,
        sig_off=tuple(sig_off), part_off=tuple(part_off), scratch=words,
        ready_off=tuple(ready_off), done_off=tuple(done_off), counters=ctr))


@functools.lru_cache(maxsize=None)
def oneshot_ctas(device_index: int, integer: bool = False) -> int:
    """CTAs of the one-shot kernel (the int one under ``integer``) the card
    holds at once (occupancy x SMs, for the configuration's 16 / 6 taps):
    the plan's scheduling hint."""
    from repro_torch.kernels._build import load
    with torch.cuda.device(device_index):
        return int(load("fir_mp_oneshot_q_ctas" if integer
                        else "fir_mp_oneshot_ctas")(0))


def oneshot_octave_rows(plan, x, bp_taps, fir_taps, scratch, counters,
                        y=None) -> np.ndarray:
    """The one-shot kernel's table: one int64 row per octave of ``plan`` in
    ``ONESHOT_OCTAVE_FIELDS`` order. A cascade's octave o reads x (o = 0)
    or its signal in ``scratch``, runs its band items with
    ``bp_taps[o]`` (F, M) and, but for the last octave, its keep items
    with the low-pass ``fir_taps[o]`` (M_lp,); its sums go to columns
    o F .. o F + F - 1 times 2^o. The output mode's one row runs out items
    with ``fir_taps[0]`` (F, M) into ``y`` (B, F, N)."""
    O, F = len(plan["lens"]), plan["F"]
    lens, tiles, keep = plan["lens"], plan["tiles"], plan["keep_tiles"]
    rows = np.zeros((O, len(ONESHOT_OCTAVE_FIELDS)), np.int64)
    if plan["output"]:
        rows[0] = (x.data_ptr(), 0, fir_taps[0].data_ptr(), y.data_ptr(), 0,
                   0, 0, 0, lens[0], tiles[0], F, tiles[0], lens[0], 1, 0, 0,
                   0)
        return rows
    sp, cp = scratch.data_ptr(), counters.data_ptr()
    for o in range(O):
        last = o == O - 1
        rows[o] = (x.data_ptr() if o == 0 else sp + 4 * plan["sig_off"][o],
                   bp_taps[o].data_ptr(),
                   0 if last else fir_taps[o].data_ptr(),
                   0 if last else sp + 4 * plan["sig_off"][o + 1],
                   sp + 4 * plan["part_off"][o],
                   0 if o == 0 else cp + 4 * plan["ready_off"][o],
                   0 if last else cp + 4 * plan["ready_off"][o + 1],
                   cp + 4 * plan["done_off"][o],
                   lens[o], tiles[o], 1, 0 if last else keep[o],
                   0 if last else lens[o + 1], 2,
                   0 if o == 0 else keep[o - 1], o * F, o)
    return rows


def _oneshot_launch(plan, x, bps, firs, *, sums, y, M, M_fir, gamma, iters):
    """Allocate the plan's scratch and zeroed counters, pack its table and
    launch its queue; the band sums land in ``sums`` (B, P), the output
    mode's values in ``y``. Returns the C code."""
    from repro_torch.kernels._build import load
    dev = x.device
    scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=dev)
    counters = torch.zeros(plan["counters"], dtype=torch.int32, device=dev)
    rows = oneshot_octave_rows(plan, x, bps, firs, scratch, counters, y)
    segs, F = plan["segments"], plan["F"]
    return load("fir_mp_bank")(
        None if sums is None else sums.data_ptr(), counters.data_ptr(),
        rows.ctypes.data, rows.shape[0], segs.ctypes.data, segs.shape[0],
        x.shape[0], F,
        F if sums is None else sums.shape[1], M, M_fir, float(gamma),
        int(iters), _stream())


def _oneshot_shapes(x, bps, lps) -> tuple:
    """(F, M, M_lp) of a cascade's taps; shapes the kernel does not take
    raise, on either device."""
    O = len(bps)
    if not 1 <= O <= ONESHOT_MAX_OCTAVES:
        raise ValueError(f"the one-shot cascade takes 1 to "
                         f"{ONESHOT_MAX_OCTAVES} octaves, got {O}")
    if len(lps) != O - 1:
        raise ValueError(f"{O} octaves need {O - 1} low-pass tap sets, got "
                         f"{len(lps)}")
    if x.ndim != 2 or bps[0].ndim != 2:
        raise ValueError(f"x must be (B, N) and bp_taps[0] (F, M), got "
                         f"{tuple(x.shape)} and {tuple(bps[0].shape)}")
    F, M = bps[0].shape
    M_lp = lps[0].shape[0] if lps else 1
    for o, h in enumerate(bps):
        _expect(f"bp_taps[{o}]", h, (F, M))
    for o, h in enumerate(lps):
        _expect(f"lp_taps[{o}]", h, (M_lp,))
    for name, m in (("M", M), ("M_lp", M_lp)):
        if not 1 <= m <= ONESHOT_MAX_M:
            raise ValueError(f"one-shot bank kernel: {name} = {m} outside "
                             f"[1, {ONESHOT_MAX_M}]")
    return F, M, M_lp


def fir_mp_oneshot_cascade(x, bp_taps, lp_taps, gamma, *,
                           iters: int = ref.DEFAULT_ITERS):
    """The float one-shot bank's whole multirate cascade: one launch on
    the card, the plain composition (``ref.fir_mp_oneshot_cascade``) on
    the CPU.

    x (B, N), already quantized if deployed so; ``bp_taps[o]`` (F, M) per
    octave, ``lp_taps[o]`` (M_lp,) for every octave but the last. Returns
    s (B, O F): octave o's HWR sums over its N_o positions times 2^o in
    columns o F .. o F + F - 1, bit for bit the plain version. Octave o's
    low-pass is solved at its kept positions only."""
    O = len(bp_taps)
    bps, lps = tuple(bp_taps), tuple(lp_taps[:max(O - 1, 0)])
    F, M, M_lp = _oneshot_shapes(x, bps, lps)
    if not _on_cuda(x, *bps, *lps):
        return ref.fir_mp_oneshot_cascade(x, bps, lps, gamma, iters)
    B, N = x.shape
    plan = oneshot_plan(B, N, F, octaves=O,
                        ctas=oneshot_ctas(x.device.index))
    x = _f32(x, "x")
    bps = [_f32(h, f"bp_taps[{o}]") for o, h in enumerate(bps)]
    lps = [_f32(h, f"lp_taps[{o}]") for o, h in enumerate(lps)]
    sums = torch.empty((B, O * F), dtype=x.dtype, device=x.device)
    code = _oneshot_launch(plan, x, bps, lps, sums=sums, y=None, M=M,
                           M_fir=M_lp, gamma=gamma, iters=iters)
    if code:
        _check(code, "fir_mp_oneshot_cascade", f"B={B} N={N} octaves={O} "
                                               f"F={F} M={M} M_lp={M_lp}")
    count_launch("fir_mp_oneshot_cascade")
    return sums


def _one_stage(x, H, gamma, accumulate, iters, key):
    """The one-shot kernel on one stage: the band items of one octave
    (HWR sums (B, F)) or the out items of every position ((B, F, N))."""
    x, H = _f32(x, "x"), _f32(H, "H")
    if x.ndim != 2 or H.ndim != 2:
        raise ValueError(f"x must be (B, N) and H (F, M), got "
                         f"{tuple(x.shape)} and {tuple(H.shape)}")
    B, N = x.shape
    Fn, M = H.shape
    plan = oneshot_plan(B, N, Fn, output=not accumulate)
    if accumulate:
        out = torch.empty((B, Fn), dtype=x.dtype, device=x.device)
        code = _oneshot_launch(plan, x, [H], [], sums=out, y=None, M=M,
                               M_fir=1, gamma=gamma, iters=iters)
    else:
        out = torch.empty((B, Fn, N), dtype=x.dtype, device=x.device)
        code = _oneshot_launch(plan, x, [], [H], sums=None, y=out, M=M,
                               M_fir=M, gamma=gamma, iters=iters)
    _check(code, key, f"B={B} N={N} F={Fn} M={M}")
    count_launch(key)
    return out


def fir_mp_bank_kernel(x, H, gamma, *, accumulate: bool = False,
                       iters: int = ref.DEFAULT_ITERS):
    """One-shot bank, one stage: x (B, N), H (F, M) -> y (B, F, N), or the
    HWR sums (B, F) under ``accumulate`` (the cascade kernel on one
    octave)."""
    if not _on_cuda(x, H):
        fn = ref.fir_mp_bank_accumulate if accumulate else ref.fir_mp_bank
        return fn(x, H, gamma, iters)
    return _one_stage(x, H, gamma, accumulate, iters, "fir_mp_bank")


def fir_mp_kernel(x, h, gamma, *, accumulate: bool = False,
                  iters: int = ref.DEFAULT_ITERS):
    """Single filter: x (B, N), h (M,) -> y (B, N), or (B,) under
    ``accumulate`` — the one-stage bank with ``H = h[None]``."""
    if not _on_cuda(x, h):
        fn = ref.fir_mp_accumulate if accumulate else ref.fir_mp
        return fn(x, h, gamma, iters)
    return _one_stage(x, h[None], gamma, accumulate, iters, "fir_mp")[:, 0]


def _stream_q_launch(x, n, acc, amax, acc_out, amax_out, y, stages, rows,
                     *, L, P, ystride, F_max, M, M_lp, T1, update_amax,
                     cascade, plan):
    """The int stream kernel's C call, on x's carrier."""
    from repro_torch.kernels._build import load
    S = x.shape[0]
    return load("fir_mp_stream_q")(
        x.data_ptr(), n.data_ptr(), acc.data_ptr(), amax.data_ptr(),
        acc_out.data_ptr(), amax_out.data_ptr(),
        None if y is None else y.data_ptr(), stages.data_ptr(),
        rows.ctypes.data, rows.shape[0], S, L, P, ystride, F_max, M, M_lp,
        T1, int(update_amax), int(cascade), int(x.dtype == torch.float32),
        plan["threads"], plan["smem_bytes"], _stream())


def fir_mp_stream_cascade_q(prog, chunk_q, n, delays, consumed, acc, amax):
    """The integer session step's octave cascade: one launch on the card,
    the plain per-octave loop (``ref.fir_mp_stream_q``) on the CPU; the
    kernel route of ``core.fixed.session_step_q``, with the same
    registers.

    ``prog`` the compiled ``core.fixed.FixedPointProgram`` (MP mode);
    chunk_q (S, L) ADC codes with invalid tails zeroed, L >= 1 (the caller
    handles the L == 0 readout); n (S,) effective valid counts; the
    registers as in ``SessionState``: the codes (chunk, delay lines, acc,
    amax) on one carrier, int32 or float32 (:func:`_carrier`), the
    consumed counters int32. Per octave the phase is
    ``consumed & 1`` and the next valid count ``max(n - phase + 1, 0) >>
    1``; amax rises at octave 0. The stage constants travel in a device
    table packed once per program and cached on it
    (:func:`_program_table`). Returns ``(delays', consumed', acc',
    amax')``, bit for bit ``ref.fir_mp_stream_q``."""
    bank = prog.bank
    if bank.mode != "mp":
        raise ValueError(
            f"fir_mp_stream_cascade_q runs the MP stream kernel; it has no "
            f"{bank.mode!r}-mode variant (use fixed.session_step_q)")
    O = len(bank.octaves)
    if len(delays) != O or len(consumed) != O:
        raise ValueError(f"the program has {O} octaves: pass {O} delay "
                         f"lines and consumed counters")
    if not _on_cuda(chunk_q, n, acc, amax, *delays, *consumed):
        _stream_carrier(chunk_q, delays, acc, amax)
        return ref.fir_mp_stream_q(prog, chunk_q, n, delays, consumed, acc,
                                   amax)
    key = "fir_mp_stream_cascade_q"
    T1 = delays[0].shape[1]
    table, Fs, M, M_lp, cols = _program_table(bank, T1, chunk_q.device)
    plan, ins = _cascade_q_inputs(chunk_q, n, delays, consumed, acc, amax,
                                  Fs, M, M_lp)
    chunk_q, n, delays, consumed, acc, amax = ins
    delays_out, consumed_out, acc_out, amax_out, scratch = _cascade_outputs(
        plan, acc, amax, O, T1=T1)
    rows = stream_q_octave_rows(delays, delays_out, consumed, consumed_out,
                                cols)
    S, L = chunk_q.shape
    code = _stream_q_launch(chunk_q, n, acc, amax, acc_out, amax_out, scratch,
                            table, rows, L=L, P=acc.shape[1],
                            ystride=plan["scratch"], F_max=max(Fs), M=M,
                            M_lp=M_lp, T1=T1, update_amax=True, cascade=True,
                            plan=plan)
    if code:
        _check(code, key, f"S={S} L={L} octaves={O} F={list(Fs)} M={M} "
                          f"T1={T1} M_lp={M_lp}")
    count_launch(_launch_key(key, chunk_q))
    return (tuple(delays_out.unbind(0)), tuple(consumed_out.unbind(0)),
            acc_out, amax_out)


def _program_table(bank, T1: int, device):
    """What the int cascades need of a compiled program's bank
    (``core.fixed.FixedBankProgram``), made once per (bank, T1, device) and
    cached on it: the stage table on ``device`` (:func:`pack_stages`), the
    filters per octave, the band-pass and low-pass lengths and each
    octave's first accumulator column."""
    cache = vars(bank).setdefault("_cuda_stream_tables", {})
    key = ("cascade", T1, str(device))
    if key not in cache:
        stages = bank.octaves
        Fs = tuple(st.bp_q.shape[0] for st in stages)
        Ms = {st.bp_q.shape[1] for st in stages}
        M_lps = {st.lp_q.shape[-1] for st in stages if st.lp_q is not None}
        if len(Ms) != 1 or len(M_lps) > 1:
            raise ValueError(f"the int kernels take one band-pass and one "
                             f"low-pass length, got {sorted(Ms)} and "
                             f"{sorted(M_lps)}")
        nxt = [stages[o + 1].in_spec if st.lp_q is not None else None
               for o, st in enumerate(stages[:-1])] + [None]
        table = torch.from_numpy(pack_stages(stages, nxt, T1)).to(device)
        cols = tuple(itertools.accumulate((0,) + Fs[:-1]))
        cache[key] = (table, Fs, Ms.pop(), M_lps.pop() if M_lps else 1,
                      cols)
    return cache[key]


def _stream_carrier(chunk_q, delays, acc, amax) -> torch.dtype:
    """The carrier of an int cascade's codes (:func:`_carrier`)."""
    return _carrier("fir_mp_stream_cascade_q", ("chunk_q", chunk_q),
                    *((f"delays[{o}]", d) for o, d in enumerate(delays)),
                    ("acc", acc), ("amax", amax))


def _cascade_q_inputs(chunk_q, n, delays, consumed, acc, amax, Fs, M, M_lp):
    """The int cascade's checks and conversions on CUDA tensors: its launch
    plan and the inputs as the kernel reads them (contiguous codes on one
    carrier, int32 or float32; a mix or another dtype raises)."""
    S, L = chunk_q.shape
    _stream_carrier(chunk_q, delays, acc, amax)
    T1 = delays[0].shape[1]
    for o in range(len(delays)):
        _expect(f"delays[{o}]", delays[o], (S, T1))
        _expect(f"consumed[{o}]", consumed[o], (S,))
    for name, t, shape in (("n", n, (S,)), ("acc", acc, (S, sum(Fs))),
                           ("amax", amax, (S,))):
        _expect(name, t, shape)
    plan = stream_plan(L, max(Fs), M, M_lp, T1, octaves=len(delays),
                       integer=True)
    return plan, (chunk_q.contiguous(), _i32(n),
                  [d.contiguous() for d in delays],
                  [_i32(c) for c in consumed], acc.contiguous(),
                  amax.contiguous())


def fir_mp_stream_octave_q(x, n, start, delay, acc, amax, *, stage,
                           next_spec=None, emit_next: bool = True,
                           update_amax: bool = False):
    """One octave of the integer session step (the int stream kernel with
    one stage).

    x (S, L) this octave's register codes (octave 0: invalid tails zeroed);
    n (S,) valid counts; start (S,) ÷2 phases; delay (S, T1) delay-line
    codes; acc (S, F) accumulators; amax (S,) running max |code| (updated
    only under ``update_amax``); x, delay, acc and amax on one carrier,
    int32 or float32 (:func:`_carrier`); ``stage`` the compiled
    ``core.fixed.OctaveStage`` (taps, shifts, gammas, iterations, clamp
    bounds); ``next_spec`` the next octave's register spec (required with
    ``emit_next``). Returns ``(acc', delay', amax', y_next | None)``,
    y_next (S, (L + 1) // 2) next-octave codes on the carrier.
    """
    key = "fir_mp_stream_octave_q"
    if emit_next and next_spec is None:
        raise ValueError("emit_next needs the next octave's next_spec")
    _carrier(key, ("x", x), ("delay", delay), ("acc", acc), ("amax", amax))
    if not _on_cuda(x, n, start, delay, acc, amax):
        return ref.fir_mp_stream_octave_q(
            x, n, start, delay, acc, amax, stage=stage, next_spec=next_spec,
            emit_next=emit_next, update_amax=update_amax)
    S, L = x.shape
    Fn, M = stage.bp_q.shape
    T1 = delay.shape[1]
    M_lp = stage.lp_q.shape[-1] if emit_next else 1
    for name, t, shape in (("n", n, (S,)), ("start", start, (S,)),
                           ("delay", delay, (S, T1)), ("acc", acc, (S, Fn)),
                           ("amax", amax, (S,))):
        _expect(name, t, shape)
    plan = stream_plan(L, Fn, M, M_lp, T1, integer=True)
    x, delay, acc, amax = (t.contiguous() for t in (x, delay, acc, amax))
    n, start = _i32(n), _i32(start)
    nxt = next_spec if emit_next else None
    table = _device_table(stage, ("octave", nxt, T1),
                          lambda: pack_stages([stage], [nxt], T1), x.device)
    acc_o = torch.empty_like(acc)
    delay_o = torch.empty_like(delay)
    amax_o = torch.empty_like(amax)
    l_next = (L + 1) // 2
    y_next = (torch.empty((S, l_next), dtype=x.dtype, device=x.device)
              if emit_next else None)
    rows = stream_q_octave_rows([delay], [delay_o], [start], [None], [0])
    code = _stream_q_launch(x, n, acc, amax, acc_o, amax_o, y_next, table,
                            rows, L=L, P=Fn, ystride=l_next, F_max=Fn, M=M,
                            M_lp=M_lp, T1=T1, update_amax=update_amax,
                            cascade=False, plan=plan)
    _check(code, key, f"S={S} L={L} F={Fn} M={M} T1={T1} M_lp={M_lp}")
    count_launch(_launch_key(key, x))
    return acc_o, delay_o, amax_o, y_next


# -- the one-shot integer bank kernel -----------------------------------------

# the int64 fields of one octave row of the int one-shot kernel, in the
# order of its C enum
ONESHOT_Q_OCTAVE_FIELDS = ("src", "dst", "ready_in", "ready_out", "n",
                           "tiles", "fir_F", "fir_tiles", "out_len", "stride",
                           "ready_target", "col")


def oneshot_q_octave_rows(plan, x, scratch, counters, y=None) -> np.ndarray:
    """The int one-shot kernel's table: one int64 row per octave of an
    ``integer`` ``plan`` in ``ONESHOT_Q_OCTAVE_FIELDS`` order. A cascade's
    octave o reads x (o = 0) or its signal in ``scratch`` and, but for the
    last octave, writes x_{o+1} there; its sums go to columns o F .. o F +
    F - 1. The output mode's one row runs out items into ``y`` (B, F, N).
    The stage constants are the stage table's (:func:`pack_stages`)."""
    O, F = len(plan["lens"]), plan["F"]
    lens, tiles, keep = plan["lens"], plan["tiles"], plan["keep_tiles"]
    rows = np.zeros((O, len(ONESHOT_Q_OCTAVE_FIELDS)), np.int64)
    if plan["output"]:
        rows[0] = (x.data_ptr(), y.data_ptr(), 0, 0, lens[0], tiles[0], F,
                   tiles[0], lens[0], 1, 0, 0)
        return rows
    sp, cp = scratch.data_ptr(), counters.data_ptr()
    for o in range(O):
        last = o == O - 1
        rows[o] = (x.data_ptr() if o == 0 else sp + 4 * plan["sig_off"][o],
                   0 if last else sp + 4 * plan["sig_off"][o + 1],
                   0 if o == 0 else cp + 4 * plan["ready_off"][o],
                   0 if last else cp + 4 * plan["ready_off"][o + 1],
                   lens[o], tiles[o], 1, 0 if last else keep[o],
                   0 if last else lens[o + 1], 2,
                   0 if o == 0 else keep[o - 1], o * F)
    return rows


def _oneshot_q_launch(plan, x, table, *, P, M, M_lp, y=None):
    """Zero one buffer for the band sums (B, P) and the plan's counters,
    allocate its scratch, pack its table and launch its queue on x's
    carrier. On float32 the sums land in order (the kernel's header): the
    buffer also holds a done counter per accumulator column, and the tile
    partials (B F sum(tiles) f32) are allocated beside it. Returns (the
    sums, or None in the output mode, the C code)."""
    from repro_torch.kernels._build import load
    dev, B = x.device, x.shape[0]
    flt = x.dtype == torch.float32
    nsum = 0 if plan["output"] else B * P
    ndone = nsum if flt else 0
    ctr = plan["counters"]
    buf = torch.zeros(nsum + ctr + ndone, dtype=torch.int32, device=dev)
    sums = None if plan["output"] else buf[:nsum].view(x.dtype).view(B, P)
    counters = buf[nsum:nsum + ctr]
    scratch = torch.empty(plan["scratch"], dtype=x.dtype, device=dev)
    partials = (torch.empty(B * plan["F"] * sum(plan["tiles"]),
                            dtype=torch.float32, device=dev)
                if ndone else None)
    rows = oneshot_q_octave_rows(plan, x, scratch, counters, y)
    segs = plan["segments"]
    code = load("fir_mp_bank_q")(
        None if sums is None else sums.data_ptr(), counters.data_ptr(),
        table.data_ptr(), rows.ctypes.data, rows.shape[0], segs.ctypes.data,
        segs.shape[0], B, plan["F"], P, M, M_lp, int(flt),
        None if partials is None else partials.data_ptr(),
        buf[nsum + ctr:].data_ptr() if ndone else None, _stream())
    return sums, code


def _oneshot_q_shapes(bank) -> tuple:
    """(F, M, M_lp) of an MP bank's octaves; banks the cascade does not
    take raise, on either device: MAC mode, unequal filter counts or tap
    lengths, and a low-pass missing before the last octave."""
    if bank.mode != "mp":
        raise ValueError(
            f"fir_mp_oneshot_cascade_q runs the MP bank; it has no "
            f"{bank.mode!r}-mode variant (use fixed.bank_accumulate_q)")
    st = bank.octaves
    Fs = {s.bp_q.shape[0] for s in st}
    Ms = {s.bp_q.shape[1] for s in st}
    M_lps = {s.lp_q.shape[-1] for s in st[:-1] if s.lp_q is not None}
    if len(Fs) != 1 or len(Ms) != 1 or len(M_lps) > 1:
        raise ValueError(f"the one-shot int cascade takes one filter count "
                         f"and one band-pass and one low-pass length, got "
                         f"F {sorted(Fs)}, M {sorted(Ms)}, M_lp "
                         f"{sorted(M_lps)}")
    if any(s.lp_q is None for s in st[:-1]) or st[-1].lp_q is not None:
        raise ValueError("every octave but the last needs its low-pass, "
                         "and the last has none")
    for s in st:
        for spec in (s.band_spec, s.lp_spec):
            if spec is not None:
                _operand_bounds(spec.qmin, spec.qmax)
    return Fs.pop(), Ms.pop(), M_lps.pop() if M_lps else 1


def _operand_bounds(qmin: int, qmax: int) -> None:
    """The int one-shot kernel clamps operands onto [qmin, qmax] with
    qmin > -2**31 and qmax >= 0 (``fxp::clamp_mag``); other bounds raise."""
    if not -2 ** 31 < qmin <= qmax or qmax < 0:
        raise ValueError(f"operand bounds [{qmin}, {qmax}]: the int one-shot "
                         f"kernel takes -2**31 < qmin <= qmax, qmax >= 0")


def _oneshot_q_inputs(xq, M: int, M_lp: int, key: str) -> torch.Tensor:
    """The int one-shot cascade's checks on a card's tensor: xq as the
    kernel reads it (contiguous codes, int32 or float32; another dtype and
    tap lengths beyond the stage table raise)."""
    if not (M <= ONESHOT_MAX_M and M_lp <= _LP_LANES):
        raise ValueError(f"{key}: M = {M} and M_lp = {M_lp} must be at most "
                         f"{ONESHOT_MAX_M} and {_LP_LANES}")
    _carrier(key, ("xq", xq))
    return xq.contiguous()


def fir_mp_oneshot_cascade_q(bank, xq):
    """The integer one-shot bank's whole multirate cascade: one launch on
    the card, the plain composition (``ref.fir_mp_oneshot_cascade_q``) on
    the CPU; the kernel route of ``core.fixed.bank_accumulate_q`` (MP,
    ``use_pallas``).

    ``bank`` the compiled ``core.fixed.FixedBankProgram`` (MP mode); xq
    (B, N) ADC codes, int32 or float32-carried. Returns the accumulators
    (B, O F) on xq's carrier, octave o's ``shift_left(sum max(y, 0),
    acc_shift)`` in columns o F .. o F + F - 1, bit for bit the plain
    version while the sums stay below 2**24 (float32 past it: the same
    bits on every run, within the rounding of the sums' two orders of the
    plain version). Octave o's low-pass is solved at its kept positions
    only. The stage constants travel in the int stream kernel's device
    stage table (:func:`pack_stages`), packed once per bank and cached on
    it."""
    key = "fir_mp_oneshot_cascade_q"
    if xq.ndim != 2:
        raise ValueError(f"xq must be (B, N), got {tuple(xq.shape)}")
    F, M, M_lp = _oneshot_q_shapes(bank)
    if not _on_cuda(xq):
        _carrier(key, ("xq", xq))
        return ref.fir_mp_oneshot_cascade_q(bank, xq)
    xq = _oneshot_q_inputs(xq, M, M_lp, key)
    B, N = xq.shape
    O = len(bank.octaves)
    # the delay length a session of this bank keeps: the serving path's
    # table, shared (the one-shot kernel does not read T1)
    table = _program_table(bank, max(M, M_lp) - 1, xq.device)[0]
    plan = oneshot_plan(B, N, F, octaves=O, integer=True,
                        ctas=oneshot_ctas(xq.device.index, integer=True))
    sums, code = _oneshot_q_launch(plan, xq, table, P=O * F, M=M, M_lp=M_lp)
    if code:
        _check(code, key, f"B={B} N={N} octaves={O} F={F} M={M} "
                          f"M_lp={M_lp}")
    count_launch(_launch_key(key, xq))
    return sums


def _one_stage_table(H: np.ndarray, gamma_q: int, iters: int, qmin: int,
                     qmax: int, device) -> torch.Tensor:
    """One stage-table record (:func:`pack_stages`) for the one-stage
    entry: H the band-pass codes, no rescale, no shift, no low-pass."""
    _operand_bounds(int(qmin), int(qmax))
    bounds = ref._Bounds(int(qmin), int(qmax))
    stage = types.SimpleNamespace(
        bp_q=H, band_spec=bounds, sig_shift=0, acc_shift=0,
        gamma_bp=int(gamma_q), iters_bp=int(iters), lp_q=None, lp_spec=None,
        lp_sig_shift=0, lp_out_shift=0, gamma_lp=0, iters_lp=0)
    return torch.from_numpy(pack_stages([stage], [None], 0)).to(device)


def fir_mp_bank_q_kernel(xq, H_q, *, gamma_q: int, iters: int, qmin: int,
                         qmax: int, accumulate: bool = False):
    """One-shot integer bank, one stage: xq (B, N) codes on the stage grid,
    H_q (F, M) tap codes (host array or tensor) -> (B, F, N) band codes,
    or the integer HWR sums (B, F) under ``accumulate`` (the cascade
    kernel on one octave: its band items, or out items at every
    position), on xq's carrier (int32 or float32)."""
    key = "fir_mp_bank_q"
    _carrier(key, ("xq", xq))
    if not _on_cuda(xq):
        fn = ref.fir_mp_bank_q_accumulate if accumulate else ref.fir_mp_bank_q
        return fn(xq, H_q, gamma_q, iters, qmin, qmax)
    xq = xq.contiguous()
    H = _host_codes(H_q)
    if xq.ndim != 2 or H.ndim != 2:
        raise ValueError(f"xq must be (B, N) and H_q (F, M), got "
                         f"{tuple(xq.shape)} and {H.shape}")
    B, N = xq.shape
    Fn, M = H.shape
    table = _one_stage_table(H, gamma_q, iters, qmin, qmax, xq.device)
    plan = oneshot_plan(B, N, Fn, output=not accumulate, integer=True)
    y = (None if accumulate else
         torch.empty((B, Fn, N), dtype=xq.dtype, device=xq.device))
    sums, code = _oneshot_q_launch(plan, xq, table, P=Fn, M=M, M_lp=1, y=y)
    _check(code, key, f"B={B} N={N} F={Fn} M={M}")
    count_launch(_launch_key(key, xq))
    return sums if accumulate else y
