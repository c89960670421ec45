"""The in-filter pipeline: audio in, class decisions out (paper Fig. 1).

    audio -> multirate octave bank of MP FIR filters -> HWR + accumulate
          -> standardize -> MP template kernel machine -> p in [-1, 1]

``InFilterPipeline`` is an ``nn.Module`` whose taps and standardization
statistics are buffers and whose classifier weights are frozen
parameters, all on one device. :meth:`InFilterPipeline.fit` makes one from
labelled audio (features, standardization, MP-aware training). ``apply``
is the one entry point:

* stateless, ``apply(x)``: one-shot ``audio (B, N) -> p (B, C)``;
* stateful, ``apply(chunk, state)``: the slot-batched session step. A
  :class:`SessionState` packs S streams ("slots") into stacked registers:
  per-octave FIR delay lines, per-octave sample counts (their parity is the
  ÷2 decimator phase), per-band accumulators, the running amax, per-slot
  sample counts and the admission mask. Per-slot ``valid`` counts let one
  call carry packets of different lengths; a slot with no valid samples
  (or inactive) gets its registers back bit for bit.

The session step copies nothing from the host and never waits for the
card (its constants are made once per pipeline or program and cached on
the device), so ``serving.make_batched_step`` can capture it as one CUDA
graph per chunk bucket. The deprecated one-cohort shims of the reference
(:class:`StreamingState`, ``init_state``, ``step``, ``stream``) run on it.

``config.stream_impl`` picks the session step's octave cascade:
``"pallas"`` is the CUDA stream kernel (``kernels.fir_mp_stream``; its
plain PyTorch version on the CPU), ``"xla"`` the torch-op cascade. Both
add in the same blocked order, so they agree bit for bit.

With ``config.numerics == "fixed"`` both paths run the bit-true int32 twin
(``core.fixed``): audio quantizes onto the static calibrated ADC grid and
every stage adds, subtracts, shifts and compares integers; outputs are
dequantized at the surface. The session registers are int32 codes
(delay lines on each octave's 8-bit register grid, 32-bit accumulators,
the running max |ADC code|), and since the grid is static and integer
addition associative, chunked decisions equal one-shot ``apply(x)`` bit
for bit under any chunking, from the first chunk. ``stream_impl="pallas"``
runs that step through the int stream kernel (``kernels.fir_mp_stream_q``),
``"xla"`` through ``core.fixed.session_step_q``; ``use_pallas`` runs the
one-shot bank through the int bank kernel. The program is compiled on the
host (:meth:`InFilterPipeline.fixed_program`, or
:meth:`InFilterPipeline.calibrate_fixed` on calibration audio).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import tracing
from repro_torch.core import filterbank as fbm
from repro_torch.core import kernel_machine as km
from repro_torch.core import mp as mp_mod
from repro_torch.core.filterbank import FilterBank, FilterBankConfig
from repro_torch.device import resolve_device

__all__ = ["InFilterPipeline", "SessionState", "StreamingState",
           "clear_slots", "set_active", "take_slot", "put_slot"]


class SessionState(NamedTuple):
    """Slot-batched streaming registers, stacked (S, ...).

    delays:   per octave, (S, T-1), T = max(bp_taps, lp_taps): the last
              T-1 samples of that octave's input (zeros at start).
    consumed: per octave, (S,) int32 octave samples seen; parity = phase.
    acc:      (S, P) running renormalized per-band accumulators.
    amax:     (S,) running max |input| (the quantization range under
              ``quant_bits``).
    Float numerics carry delays/acc/amax in float32; ``numerics="fixed"``
    carries them as int32 codes (amax: max |ADC code|, telemetry only).
    count:    (S,) int32 input samples consumed.
    active:   (S,) bool admission mask; inactive slots are inert.
    """
    delays: tuple
    consumed: tuple
    acc: torch.Tensor
    amax: torch.Tensor
    count: torch.Tensor
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.acc.shape[0]

    def registers(self) -> tuple:
        """The registers a fresh session zeroes: every tensor but
        ``active``, in field order (delays and consumed flattened)."""
        return (*self.delays, *self.consumed, self.acc, self.amax,
                self.count)

    def tensors(self) -> tuple:
        """Every register tensor, in field order (delays and consumed
        flattened)."""
        return (*self.registers(), self.active)


class StreamingState(NamedTuple):
    """DEPRECATED one-cohort streaming state (the reference's pre-session
    API, kept for its ``init_state`` / ``step`` callers): a view of
    :class:`SessionState` whose B streams all share one age (0-d int32
    ``consumed`` per octave); ``amax`` is the per-stream running amax."""
    delays: tuple
    consumed: tuple
    acc: torch.Tensor
    amax: torch.Tensor


class InFilterPipeline(nn.Module):
    """Config + taps + classifier + standardization, on one device."""

    def __init__(self, config: FilterBankConfig, bp_taps, lp_taps, mu, sigma,
                 clf: km.MPKernelMachineParams, device=None):
        super().__init__()
        if config.numerics not in ("float", "fixed"):
            raise ValueError(f"unknown numerics {config.numerics!r}: "
                             "expected 'float' or 'fixed'")
        self.config = config
        self._fixed_prog = None          # lazy compile_pipeline cache
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.num_octaves = len(bp_taps)
        for o, t in enumerate(bp_taps):
            self.register_buffer(f"bp_{o}", torch.as_tensor(t, **f32))
        for o, t in enumerate(lp_taps):
            self.register_buffer(f"lp_{o}", torch.as_tensor(t, **f32))
        self.num_lp = len(lp_taps)
        self.register_buffer("mu", torch.as_tensor(mu, **f32))
        self.register_buffer("sigma", torch.as_tensor(sigma, **f32))
        self.clf = km.MPKernelMachine(
            km.MPKernelMachineParams(*(torch.as_tensor(t, **f32)
                                       for t in clf))).requires_grad_(False)

    @classmethod
    def from_filterbank(cls, fb: FilterBank, clf, mu, sigma
                        ) -> "InFilterPipeline":
        return cls(fb.config, fb.bp_by_octave, fb.lp_filters, mu, sigma, clf,
                   device=fb.device)

    @classmethod
    def fit(cls, config: FilterBankConfig, x_train, y_train,
            num_classes: int, train_cfg=None, device=None):
        """Extract features, standardize, train the MP kernel machine
        (``core.trainer``) and pack the deployable pipeline. Returns
        (pipeline, loss trace).

        The features are ``FilterBank.accumulate`` on all of ``x_train``
        (B, N): on the card under ``use_pallas`` one launch of the one-shot
        cascade kernel (the int one under ``numerics="fixed"``). mu and
        sigma are their mean and sample standard deviation (+ 1e-6) over
        the clips. ``device`` is ``cuda`` unless given (raises without a
        card)."""
        from repro_torch.core import trainer
        if train_cfg is None:
            train_cfg = trainer.TrainConfig()
        fb = FilterBank(config, device=device)
        with torch.no_grad():
            s = fb.accumulate(x_train)
        mu = s.mean(0)
        sigma = s.std(0, correction=1) + 1e-6
        K = (s - mu) / sigma
        params, losses = trainer.train(K, y_train, num_classes, train_cfg,
                                       device=fb.device)
        return cls.from_filterbank(fb, params, mu, sigma), losses

    @property
    def bp_taps(self) -> tuple:
        """Per octave: (F, M) band-pass taps."""
        return tuple(getattr(self, f"bp_{o}") for o in range(self.num_octaves))

    @property
    def lp_taps(self) -> tuple:
        """Per ÷2 stage: (M_lp,) anti-aliasing taps."""
        return tuple(getattr(self, f"lp_{o}") for o in range(self.num_lp))

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- the entry point ------------------------------------------------------

    @torch.no_grad()
    def apply(self, x, state: SessionState | None = None, *, valid=None,
              return_features: bool = False):
        """Stateless: ``x (B, N) -> p (B, C)`` (``(p, phi)`` with
        ``return_features``). Stateful: ``x (S, L)`` one chunk per slot,
        ``valid`` per-slot sample counts (None: every row full); returns
        ``(p, state')`` or ``(p, phi, state')``."""
        if state is None:
            with tracing.span("pipeline.apply"):
                x = self._tensor(x)
                if self.config.numerics == "fixed":
                    from repro_torch.core import fixed
                    p, phi = fixed.predict(self.fixed_program(), x,
                                           use_pallas=self.config.use_pallas)
                    return (p, phi) if return_features else p
                with tracing.span("pipeline.features"):
                    phi = self.features(x)
                with tracing.span("pipeline.readout"):
                    p = self.clf(phi, exact=False)
                return (p, phi) if return_features else p
        x = self._tensor(x)
        if x.ndim != 2 or x.shape[0] != state.capacity:
            raise ValueError(
                f"chunk shape {tuple(x.shape)} does not match session "
                f"capacity {state.capacity}: expected ({state.capacity}, L)")
        if valid is None:
            valid = torch.full((state.capacity,), x.shape[1],
                               dtype=torch.int32, device=self.device)
        state, p, phi = self._session_step(state, x, valid)
        return (p, phi, state) if return_features else (p, state)

    def predict(self, x):
        """Alias for stateless ``apply(x)``."""
        return self.apply(x)

    def features(self, x, amax=None) -> torch.Tensor:
        """audio (B, N) -> standardized kernel vector Phi (B, P). Under
        ``numerics="fixed"``: the integer path's dequantized 8-bit phi."""
        if self.config.numerics == "fixed":
            if amax is not None:
                raise ValueError(
                    "features(amax=...) has no effect under "
                    "numerics='fixed' — the ADC full scale is the static "
                    "config.fixed_amax / fixed_program(amax=...) "
                    "calibration")
            from repro_torch.core import fixed
            prog = self.fixed_program()
            _, phi_q, _ = fixed.infer_q(
                prog, fixed.quantize_signal(prog, self._tensor(x)),
                use_pallas=self.config.use_pallas)
            return prog.phi.dequantize(phi_q)
        s = fbm.multirate_accumulate(self._tensor(x), self.bp_taps,
                                     self.lp_taps, self.config, amax=amax)
        return (s - self.mu) / self.sigma

    def fixed_program(self, **overrides):
        """The compiled integer program (lazy; cached for the call with no
        overrides — the program ``apply``, ``features`` and the session
        step run). ``overrides`` go to ``core.fixed.compile_pipeline``
        (amax, signal_bits, internal_bits, phi_amax, octave_gains,
        calibration_audio) and give a fresh, uncached program."""
        from repro_torch.core import fixed
        if overrides:
            return fixed.compile_pipeline(self, **overrides)
        if self._fixed_prog is None:
            self._fixed_prog = fixed.compile_pipeline(self)
        return self._fixed_prog

    def calibrate_fixed(self, calibration_audio, **overrides):
        """Compile the integer program calibrated on ``calibration_audio``
        (ADC full scale + per-octave register pre-gains) and pin it as this
        pipeline's program. Returns it."""
        from repro_torch.core import fixed
        self._fixed_prog = fixed.compile_pipeline(
            self, calibration_audio=calibration_audio, **overrides)
        return self._fixed_prog

    # -- session streaming ----------------------------------------------------

    @property
    def _delay_len(self) -> int:
        return max(self.config.bp_taps, self.config.lp_taps) - 1

    def init_session(self, capacity: int, *, amax=None,
                     active=None) -> SessionState:
        """Fresh state for ``capacity`` streams on this pipeline's device.
        ``amax`` pre-seeds the running range (scalar or (S,)); ``active``
        sets the admission mask (default: all active). Under
        ``numerics="fixed"`` every register is int32 and a float ``amax``
        seed is converted to ADC codes."""
        c = self.config
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        # the registers' type: int32 codes, or float32
        reg = i32 if c.numerics == "fixed" else dict(dtype=torch.float32,
                                                     device=dev)
        if amax is None:
            amax_t = torch.zeros(capacity, **reg)
        elif c.numerics == "fixed":
            amax_t = self.fixed_program().signal.quantize(
                torch.as_tensor(amax, dtype=torch.float32, device=dev).abs()
            ).expand(capacity).clone()
        else:
            amax_t = torch.as_tensor(amax, **reg).expand(capacity).clone()
        active_t = (torch.ones(capacity, dtype=torch.bool, device=dev)
                    if active is None else
                    torch.as_tensor(active, dtype=torch.bool,
                                    device=dev).clone())
        return SessionState(
            delays=tuple(torch.zeros(capacity, self._delay_len, **reg)
                         for _ in range(c.num_octaves)),
            consumed=tuple(torch.zeros(capacity, **i32)
                           for _ in range(c.num_octaves)),
            acc=torch.zeros(capacity, c.num_filters, **reg),
            amax=amax_t,
            count=torch.zeros(capacity, **i32),
            active=active_t,
        )

    @torch.no_grad()
    def _session_step(self, state: SessionState, chunk: torch.Tensor,
                      valid: torch.Tensor):
        """Consume one (S, L) chunk with per-slot valid counts; returns
        (state', p (S, C), phi (S, P))."""
        c = self.config
        if c.numerics == "fixed":
            return self._session_step_fixed(state, chunk, valid)
        S, L = chunk.shape
        valid = torch.as_tensor(valid, dtype=torch.int32, device=self.device)
        n = torch.where(state.active, valid, 0).to(torch.int32)
        if L == 0:
            # a zero-length chunk is a pure readout: no register moves
            phi = (state.acc - self.mu) / self.sigma
            return state, self.clf(phi, exact=False), phi
        pos0 = torch.arange(L, device=chunk.device)[None, :]
        chunk = torch.where(pos0 < n[:, None], chunk, 0.0)
        if c.stream_impl == "pallas":
            state = self._cascade_pallas(state, chunk, n)
        elif c.stream_impl == "xla":
            state = self._cascade_xla(state, chunk, n)
        else:
            raise ValueError(f"unknown stream_impl {c.stream_impl!r}: "
                             "expected 'xla' or 'pallas'")
        phi = (state.acc - self.mu) / self.sigma
        return state, self.clf(phi, exact=False), phi

    @torch.no_grad()
    def _session_step_fixed(self, state: SessionState, chunk: torch.Tensor,
                            valid: torch.Tensor):
        """The int32 session step: quantize the chunk onto the static ADC
        grid, zero invalid positions, and run the integer cascade —
        ``stream_impl="xla"`` through ``fixed.session_step_q``, "pallas"
        through the int stream kernel (the same registers and decisions).
        Returns (state', p, phi), dequantized."""
        from repro_torch.core import fixed
        c = self.config
        if c.stream_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown stream_impl {c.stream_impl!r}: "
                             "expected 'xla' or 'pallas'")
        prog = self.fixed_program()
        S, L = chunk.shape
        valid = torch.as_tensor(valid, dtype=torch.int32, device=self.device)
        n = torch.where(state.active, valid, 0).to(torch.int32)
        xq = fixed.quantize_signal(prog, chunk)
        pos0 = torch.arange(L, device=chunk.device)[None, :]
        xq = torch.where(pos0 < n[:, None], xq, 0)
        if c.stream_impl == "pallas":
            state, p_q, phi_q = self._cascade_pallas_fixed(prog, state, xq,
                                                           n)
        else:
            state, p_q, phi_q = fixed.session_step_q(prog, state, xq, n)
        return (state, prog.out_spec.dequantize(p_q),
                prog.phi.dequantize(phi_q))

    # -- deprecated one-cohort streaming shims --------------------------------

    def init_state(self, batch: int, dtype=torch.float32) -> StreamingState:
        """DEPRECATED: use ``init_session``. One cohort of ``batch``
        streams that advance in lockstep (0-d per-octave ages). The port's
        float registers are float32 (int32 codes under
        ``numerics="fixed"``), so a float pipeline takes no other
        ``dtype``."""
        if self.config.numerics == "float" and dtype != torch.float32:
            raise ValueError(f"the port's float registers are float32, "
                             f"got dtype {dtype}")
        sess = self.init_session(batch)
        return StreamingState(
            delays=sess.delays,
            consumed=tuple(torch.zeros((), dtype=torch.int32,
                                       device=self.device)
                           for _ in sess.consumed),
            acc=sess.acc, amax=sess.amax)

    def step(self, state: StreamingState, chunk):
        """DEPRECATED: use ``apply``. Consume one (B, L) chunk; returns
        ``(state', p (B, C))``: the session step on the cohort lifted to a
        ``SessionState`` (every row the same age), collapsed back."""
        chunk = self._tensor(chunk)
        B, L = chunk.shape
        i32 = dict(dtype=torch.int32, device=self.device)
        sess = SessionState(
            delays=state.delays,
            consumed=tuple(c.to(torch.int32).expand(B).contiguous()
                           for c in state.consumed),
            acc=state.acc, amax=state.amax,
            count=state.consumed[0].to(torch.int32).expand(B).contiguous(),
            active=torch.ones(B, dtype=torch.bool, device=self.device))
        sess, p, _ = self._session_step(sess, chunk,
                                        torch.full((B,), L, **i32))
        return StreamingState(sess.delays,
                              tuple(c[0] for c in sess.consumed), sess.acc,
                              sess.amax), p

    def stream(self, chunks, *, dtype=None) -> torch.Tensor:
        """Classify an iterable of (B, L_i) chunks; returns the final p.
        Memory stays fixed whatever the stream's length.

        ``dtype`` fixes the stream's dtype up front (None: the first
        chunk's; float64 chunks count as float32, as JAX takes them).
        A chunk of another dtype raises rather than silently changing the
        registers' type mid-stream."""
        state = p = None
        if dtype is not None:
            dtype = _torch_dtype(dtype)
        for chunk in chunks:
            chunk = torch.as_tensor(chunk)
            if chunk.dtype == torch.float64:
                chunk = chunk.float()
            if dtype is None:
                dtype = chunk.dtype
            if chunk.dtype != dtype:
                raise ValueError(
                    f"stream() chunk dtype {chunk.dtype} != stream dtype "
                    f"{dtype}; cast explicitly (mixed-dtype chunks would "
                    "silently change the streaming registers' type)")
            if state is None:
                state = self.init_state(chunk.shape[0], dtype)
            state, p = self.step(state, chunk)
        if p is None:
            raise ValueError("stream() needs at least one chunk")
        return p

    def _cascade_pallas_fixed(self, prog, state: SessionState,
                              xq: torch.Tensor, n: torch.Tensor):
        """Integer octave cascade through the int stream kernel
        (``kernels.fir_mp_stream_q``), then the readout: bit for bit
        ``fixed.session_step_q``. Returns (state', p_q, phi_q)."""
        from repro_torch.core import fixed
        if self.config.mode != "mp":
            raise ValueError(
                f"stream_impl='pallas' runs the MP stream kernel; it has no "
                f"{self.config.mode!r}-mode variant (use stream_impl='xla')")
        if xq.shape[1] > 0:
            from repro_torch.kernels import fir_mp_stream_q
            delays, consumed, acc, amax = fir_mp_stream_q(
                prog, xq, n, state.delays, state.consumed, state.acc,
                state.amax)
            state = SessionState(delays, consumed, acc, amax,
                                 state.count + n, state.active)
        # a zero-length chunk is a pure readout: no register moves
        p_q, phi_q = fixed.readout_q(prog, state.acc)
        return state, p_q, phi_q

    def _cascade_pallas(self, state: SessionState, chunk: torch.Tensor,
                        n: torch.Tensor) -> SessionState:
        """Octave cascade through the stream kernel."""
        c = self.config
        if c.mode != "mp":
            raise ValueError(
                f"stream_impl='pallas' runs the MP stream kernel; it has no "
                f"{c.mode!r}-mode variant (use stream_impl='xla')")
        from repro_torch.kernels import fir_mp_stream
        if c.quant_bits is not None:
            # quantizing needs the updated running amax before filtering,
            # so the update cannot fold into the kernel's sweep
            amax = torch.maximum(state.amax, chunk.abs().amax(-1))
            chunk = fbm.quant_signal(chunk, c, amax=amax)
            update_amax = False
        else:
            amax = state.amax
            update_amax = True
        delays, consumed, acc, amax = fir_mp_stream(
            chunk, n, state.delays, state.consumed, state.acc, amax,
            self.bp_taps, self.lp_taps, c.gamma_f, solver=c.solver,
            update_amax=update_amax)
        return SessionState(delays, consumed, acc, amax, state.count + n,
                            state.active)

    def _cascade_xla(self, state: SessionState, chunk: torch.Tensor,
                     n: torch.Tensor) -> SessionState:
        """Octave cascade in torch ops: per-octave [delay, chunk] splice
        (the counterpart of the reference's XLA cascade)."""
        c = self.config
        S, L = chunk.shape
        dev = chunk.device
        amax = torch.maximum(state.amax, chunk.abs().amax(-1))
        if c.quant_bits is not None:
            chunk = fbm.quant_signal(chunk, c, amax=amax)
        T1 = self._delay_len
        M_bp, M_lp = c.bp_taps, c.lp_taps
        rows = torch.arange(S, device=dev)[:, None]
        tail = torch.arange(T1, device=dev)[None, :]
        x_o, n_o = chunk, n
        l_max = L
        delays, consumed, parts = [], [], []
        for o in range(c.num_octaves):
            # in-chunk sample p sits at buf position T1 + p
            buf = torch.cat([state.delays[o], x_o], dim=1)
            y = fbm.bank_fir_valid(buf[:, T1 - (M_bp - 1):],
                                   self.bp_taps[o], c)        # (S, F, l_max)
            parts.append(fbm.hwr_accumulate(y, n_o[:, None]) * (2.0 ** o))
            # the last T1 valid samples become the delay line
            delays.append(buf[rows, n_o.long()[:, None] + tail])
            consumed.append(state.consumed[o] + n_o)
            if o < c.num_octaves - 1:
                # ÷2 keeps even global indices: the first kept in-chunk
                # index is the slot's phase
                start = torch.remainder(state.consumed[o], 2).long()
                l_next = (l_max + 1) // 2
                buf_lp = buf[:, T1 - (M_lp - 1):]
                j2 = 2 * torch.arange(l_next, device=dev)
                if c.mode == "mp" and not c.use_pallas:
                    # solve only the kept positions
                    buf_lp = torch.nn.functional.pad(buf_lp, (0, 1))
                    widx = j2[:, None] + torch.arange(M_lp, device=dev)[None]
                    win = buf_lp[rows[:, :, None], start[:, None, None]
                                 + widx[None]]            # (S, l_next, M_lp)
                    kept = mp_mod._mp_dot_fast(win, self.lp_taps[o].flip(0),
                                               c.gamma_f, c.solver)
                else:
                    y_lp = fbm.single_fir_valid(buf_lp, self.lp_taps[o], c)
                    y_pad = torch.nn.functional.pad(
                        y_lp, (0, 2 * l_next + 1 - l_max))
                    kept = y_pad[rows, start[:, None] + j2[None]]
                x_o = kept
                n_o = torch.clamp_min(torch.div(
                    n_o - start.to(torch.int32) + 1, 2,
                    rounding_mode="floor"), 0).to(torch.int32)
                l_max = l_next
        acc = state.acc + torch.cat(parts, dim=-1)
        return SessionState(tuple(delays), tuple(consumed), acc, amax,
                            state.count + n, state.active)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


# ---------------------------------------------------------------------------
# slot surgery (admission bookkeeping for serving code)
# ---------------------------------------------------------------------------


def _index(slots, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(slots, dtype=torch.long, device=like.device)


def clear_slots(state: SessionState, slots) -> SessionState:
    """Zero the registers of ``slots`` (fresh-tenant admission), IN PLACE:
    the state's tensors are written and the same state is returned.
    ``active`` is left alone — pair with :func:`set_active`."""
    idx = _index(slots, state.acc)
    for t in state.registers():
        t[idx] = 0
    return state


def set_active(state: SessionState, slots, value: bool) -> SessionState:
    """Set the admission mask of ``slots``, IN PLACE (returns ``state``)."""
    state.active[_index(slots, state.active)] = bool(value)
    return state


def take_slot(state: SessionState, slot: int) -> SessionState:
    """One slot's registers as an unbatched row (copies)."""
    return SessionState(
        delays=tuple(d[slot].clone() for d in state.delays),
        consumed=tuple(c[slot].clone() for c in state.consumed),
        acc=state.acc[slot].clone(), amax=state.amax[slot].clone(),
        count=state.count[slot].clone(), active=state.active[slot].clone())


def put_slot(state: SessionState, slot: int, row: SessionState
             ) -> SessionState:
    """Write a row from :func:`take_slot` into ``slot``, IN PLACE (returns
    ``state``)."""
    for dst, src in zip(state.tensors(), row.tensors()):
        dst[slot] = src
    return state
