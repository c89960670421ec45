"""The standard analysis targets: the port's deployed integer programs,
traced, with the reference's worst-case input contracts.

Each :class:`Target` pairs a traced graph (``traverse.trace``) with one
:class:`~repro_torch.analysis.intervals.Interval` per program input. The
contracts are copied from ``repro.analysis.targets``:

* **ADC codes** are ``FixedPointSpec.qmin..qmax``: the quantizer clamps.
* **Delay-line registers** hold each octave's 8-bit register codes
  (``OctaveStage.in_spec``).
* **Session accumulators** stay inside the 1-second one-shot envelope
  (:func:`session_envelope`), which also gives the longest session before
  any int32 accumulator can overflow.
* **Sample counters** are bounded by ``SESSION_BOUND`` (2^30 samples).

The programs are traced on the CPU with fake tensors: ``fixed.infer_q``
(``oneshot_q``), ``fixed.session_step_q`` over the flattened session
registers (``session_step_q``), and the same two with the bank routed
through the integer kernels' plain versions (``kernels.ref``'s
``fir_mp_oneshot_cascade_q`` and ``fir_mp_stream_q``, which the wrappers
run on CPU tensors): ``oneshot_q_cascade`` and ``stream_cascade_q``, the
counterparts of the reference's Pallas census targets. The CUDA kernels
themselves are opaque to ``torch.fx``. ``float_oneshot`` is the float
pipeline, for the determinism lint only.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Callable, Optional

import torch

from repro_torch.analysis.intervals import BOOL, Interval
from repro_torch.analysis.traverse import Traced, trace

__all__ = ["CHUNK_LEN", "SESSION_BOUND", "Target", "build_targets",
           "session_envelope", "session_fn", "session_inputs"]

# counter registers: 2^30 octave samples (~18 h @ 16 kHz)
SESSION_BOUND = 1 << 30

INT32_MAX = (1 << 31) - 1

# one 10 ms sensor packet at 16 kHz
CHUNK_LEN = 160


@dataclasses.dataclass
class Target:
    """One traced program plus its analysis contract."""
    name: str
    traced: Traced
    numerics: str                     # "fixed" | "float"
    n_samples: int                    # input samples per call
    in_intervals: Optional[list]      # None: skip the interval pass
    assumptions: dict                 # input name -> contract
    gate: bool                        # violations fail the analysis
    fn: Callable = None               # fn(program, *example) runs it
    program: object = None            # the program (or pipeline) fn reads
    example: tuple = ()               # the CPU inputs it was traced with
    seconds: float = 0.0              # trace time


def _signal_iv(prog) -> Interval:
    s = prog.signal
    return Interval(int(s.qmin), int(s.qmax))


def _shift_int(v: int, k: int) -> int:
    return v << k if k >= 0 else v >> (-k)


def session_envelope(prog, n_envelope: int) -> dict:
    """Closed-form session accumulator bounds: per octave the accumulator
    gains at most ``band_spec.qmax << acc_shift`` per octave sample, and a
    length-``N`` session delivers ``ceil(N / 2**o)`` octave samples.
    Returns the worst-case ``acc`` interval for ``n_envelope`` input
    samples and the longest session before any int32 accumulator can
    overflow."""
    acc_hi = 0
    max_safe = None
    for o, st in enumerate(prog.bank.octaves):
        qmax = int(st.band_spec.qmax)
        shift = int(st.acc_shift)
        n_o = -(-n_envelope // (1 << o))          # ceil
        acc_hi = max(acc_hi, _shift_int(n_o * qmax, shift))
        g = Fraction(qmax * 2 ** max(shift, 0),
                     2 ** (o + max(-shift, 0)))
        safe_o = int(Fraction(INT32_MAX) / g) if g > 0 else None
        if safe_o is not None:
            max_safe = safe_o if max_safe is None else min(max_safe, safe_o)
    return {
        "acc_interval": Interval(0, acc_hi),
        "envelope_samples": n_envelope,
        "max_safe_session_samples": max_safe,
    }


def _state_leaves(state) -> list:
    return [*state.delays, *state.consumed, state.acc, state.amax,
            state.count, state.active]


def session_fn(step: Callable, n_octaves: int) -> Callable:
    """``fn(prog, *flat)`` over the flattened session registers, chunk and
    valid counts -> the flattened registers, p_q and phi_q: ``step(prog,
    state, chunk_q, n)`` with the reference's leaf order."""
    from repro_torch.core.pipeline import SessionState

    def fn(prog, *flat):
        o = n_octaves
        state = SessionState(tuple(flat[:o]), tuple(flat[o:2 * o]),
                             *flat[2 * o:2 * o + 4])
        st2, p_q, phi_q = step(prog, state, flat[-2], flat[-1])
        return (*_state_leaves(st2), p_q, phi_q)

    return fn


def session_inputs(prog, state, chunk_len: int, acc_iv: Interval) -> list:
    """One Interval per flattened input of :func:`session_fn`."""
    sig = _signal_iv(prog)
    counter = Interval(0, SESSION_BOUND)
    octs = prog.bank.octaves
    return ([Interval(int(octs[o].in_spec.qmin), int(octs[o].in_spec.qmax))
             for o in range(len(state.delays))]
            + [counter for _ in state.consumed]
            + [acc_iv, Interval(0, max(abs(sig.lo), sig.hi)), counter, BOOL,
               sig, Interval(0, chunk_len)])


def _fixed_program(smoke: bool, device, seed: int = 0):
    from repro_torch.configs.esc10_mp import make_pipeline
    pipe = make_pipeline(smoke=smoke, seed=seed, numerics="fixed",
                         device=device)
    return pipe, pipe.fixed_program()


def _traced(name, fn, example, program, **kw) -> Target:
    import time
    t0 = time.perf_counter()
    tr = trace(fn, *example, program=program)
    return Target(name=name, traced=tr, fn=fn, program=program,
                  example=example,
                  seconds=time.perf_counter() - t0, **kw)


def build_targets(smoke: bool = False, device=None,
                  names: Optional[tuple] = None) -> tuple:
    """Build the standard target set (or the ``names`` of it). Returns
    ``(targets, meta)``; ``meta`` carries the session envelope figures.
    The pipeline is made on ``device`` (the card unless ``"cpu"``); the
    programs are traced on the CPU."""
    from repro_torch.core import fixed
    from repro_torch.core.pipeline import InFilterPipeline

    n = 1600 if smoke else 16000               # 1 s of audio at full config
    pipe, prog = _fixed_program(smoke, device)
    sig = _signal_iv(prog)
    env = session_envelope(prog, n)
    acc_iv = env["acc_interval"]
    want = lambda name: names is None or name in names     # noqa: E731

    adc = (f"ADC codes in [{sig.lo}, {sig.hi}] "
           f"(FixedPointSpec {prog.signal.bits}-bit, clamped quantizer)")
    xq = torch.zeros((1, n), dtype=torch.int32)
    targets = []
    if want("oneshot_q"):
        targets.append(_traced(
            "oneshot_q", lambda p, q: fixed.infer_q(p, q), (xq,), prog,
            numerics="fixed", n_samples=n, in_intervals=[sig],
            assumptions={"xq": adc}, gate=True))
    if want("oneshot_q_cascade"):
        targets.append(_traced(
            "oneshot_q_cascade",
            lambda p, q: fixed.infer_q(p, q, use_pallas=True), (xq,), prog,
            numerics="fixed", n_samples=n, in_intervals=[sig],
            assumptions={"xq": adc}, gate=True))

    session_assumptions = {
        "chunk_q": adc,
        "delays[o]": "octave signal-register codes (OctaveStage.in_spec, "
                     "written only by the clamped requantizers)",
        "consumed/count": f"<= {SESSION_BOUND} octave samples "
                          "(~18 h @ 16 kHz)",
        "acc": f"within the {n}-sample one-shot envelope "
               f"{acc_iv!r}; max int32-safe session = "
               f"{env['max_safe_session_samples']} input samples",
        "amax": "running max |ADC code| (telemetry)",
        "n": f"valid counts in [0, {CHUNK_LEN}]",
    }
    state = pipe.init_session(1)
    state = type(state)(*[tuple(t.cpu() for t in f) if isinstance(f, tuple)
                          else f.cpu() for f in state])
    example = (*_state_leaves(state),
               torch.zeros((1, CHUNK_LEN), dtype=torch.int32),
               torch.zeros((1,), dtype=torch.int32))
    n_oct = len(prog.bank.octaves)
    in_ivs = session_inputs(prog, state, CHUNK_LEN, acc_iv)
    if want("session_step_q"):
        targets.append(_traced(
            "session_step_q", session_fn(fixed.session_step_q, n_oct),
            example, prog, numerics="fixed", n_samples=CHUNK_LEN,
            in_intervals=in_ivs, assumptions=session_assumptions,
            gate=True))
    if want("stream_cascade_q"):
        cascade = lambda p, st, q, v: InFilterPipeline._cascade_pallas_fixed(
            pipe, p, st, q, v)                           # noqa: E731
        targets.append(_traced(
            "stream_cascade_q", session_fn(cascade, n_oct), example, prog,
            numerics="fixed", n_samples=CHUNK_LEN, in_intervals=in_ivs,
            assumptions=session_assumptions, gate=True))
    if want("float_oneshot"):
        from repro_torch.configs.esc10_mp import make_pipeline
        pipe_f = make_pipeline(smoke=smoke, device="cpu")
        x = torch.zeros((1, n), dtype=torch.float32)
        targets.append(_traced(
            "float_oneshot", lambda p, a: p.apply(a), (x,), pipe_f,
            numerics="float", n_samples=n, in_intervals=None,
            assumptions={"x": "float32 audio (reference path — lint only)"},
            gate=False))

    meta = {
        "config": "smoke" if smoke else "full",
        "envelope_samples": env["envelope_samples"],
        "acc_envelope": [int(acc_iv.lo), int(acc_iv.hi)],
        "max_safe_session_samples": env["max_safe_session_samples"],
        "session_bound_counter": SESSION_BOUND,
        "chunk_len": CHUNK_LEN,
    }
    return targets, meta

