"""Offline classification of recordings: batches of clips through
``InFilterPipeline.apply`` (float) or ``core.fixed.infer_q`` (the fixed
twin: the ADC's codes in; p, phi and the bank's 32-bit sums out), back to
back.

Batch k takes ``batch`` consecutive clips of a seeded pool in pinned host
memory (wrapping round), copies them to the card, classifies them and
reads the outputs back. The server, the captured step and the stream
kernel are not on this path.

The check: ``check_clips`` clips drawn from the seed among those the
window decided; their p and features held against the reference's, and
for the twin the bank's sums too, each as its value (code times the
program's scale).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import audio, checks, counts, system, trace


def run(env) -> dict:
    cfg, mix, device, spans = env.cfg, env.mix, env.device, env.spans
    B = int(mix["batch"])
    fs = float(cfg["bank"]["fs"])
    N = int(round(float(mix["clip_seconds"]) * fs))
    n_pool = int(mix["pool_clips"])
    if n_pool % B:
        raise ValueError("pool_clips must be a multiple of batch")
    pool_np = audio.clips(system.subseed(env.seed, system.TRAFFIC), n_pool,
                          N, fs)
    env.mark("pool")
    cuda = device.type == "cuda"
    pool = torch.from_numpy(pool_np)
    if cuda:
        pool = pool.pin_memory()
    clf = system.draw_classifier(cfg, env.seed, device)
    cal = system.calibration_audio(cfg, env.seed)
    pipe = system.build(cfg, clf, device, cal)
    env.mark("pipeline")
    classify, scales = _entry(pipe)

    batches = 0
    outs = []                    # per batch: (first clip, outputs on host)

    def run_batches(n: int, record: bool = True):
        nonlocal batches
        for _ in range(n):
            first = (batches * B) % n_pool
            with spans("h2d"):
                x = pool[first:first + B].to(device, non_blocking=True)
            with spans("apply"):
                y = classify(x)
            with spans("readback"):
                y = [t.cpu() for t in y]
            if record:
                outs.append((first, y))
            batches += 1

    run_batches(int(mix["warm_batches"]), record=False)
    if cuda:
        torch.cuda.synchronize()
    env.mark("warm")
    env.settle()
    host0 = {k: len(v) for k, v in spans.seconds.items()}
    t0 = time.perf_counter()
    env.window_started(t0)
    done = 0
    while time.perf_counter() - t0 < env.seconds:
        run_batches(1)
        done += 1
    window_s = time.perf_counter() - t0
    env.window_ended()
    host = {k: sum(v[host0.get(k, 0):]) for k, v in spans.seconds.items()}
    tr = None
    if env.trace and cuda:
        tr = trace.profile(lambda n: run_batches(n, record=False),
                           int(mix["trace_batches"]), spans)

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del pipe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rng = np.random.default_rng(system.subseed(env.seed, system.SAMPLE))
    picks = np.sort(rng.choice(done * B, min(int(mix["check_clips"]),
                                             done * B), replace=False))
    got = [torch.stack([outs[i // B][1][k][i % B] for i in picks]).double()
           * 2.0 ** e for k, e in enumerate(scales)]
    clf_h = system.host(clf)
    ref = checks.Reference(cfg, clf_h, cal, device)
    out = dict(
        window_s=window_s, units=done, rows=B, audio_s=done * B * N / fs,
        host_s=host, trace=tr, memory_peak_bytes=peak,
        attempted=done * B, failed=0, kind_of_mix="clips",
        reference=ref, inputs=dict(
            x=pool_np[[outs[i // B][0] + i % B for i in picks]],
            **dict(zip(("p", "phi", "s"), got))))
    prog = ref.prog
    cascade = counts.bank_ops(cfg, prog, B, N)
    out.update(cascade_ops=cascade,
               cascade_bytes=counts.oneshot_bytes(cfg, B, N),
               step_ops=cascade + counts.readout_ops(cfg, prog, B),
               ops_kind="int32" if prog is not None else "f32")
    if env.check:
        t = time.perf_counter()
        out["numbers"] = compare(ref, **out["inputs"])
        out["check_s"] = time.perf_counter() - t
    return out


def _entry(pipe):
    """(the timed call: a batch of audio on the card -> its outputs, the
    power-of-two exponent of each output's scale: 0 for float values)."""
    if pipe.config.numerics != "fixed":
        return (lambda x: pipe.apply(x, return_features=True)), (0, 0)
    from repro_torch.core import fixed
    prog = pipe.fixed_program()

    def classify(x):
        return fixed.infer_q(prog, fixed.quantize_signal(prog, x),
                             use_pallas=pipe.config.use_pallas)
    return classify, (prog.out_spec.exp, prog.phi.exp, prog.bank.acc.exp)


def observe_reference(ref: checks.Reference, x: np.ndarray) -> tuple:
    """The reference's (p, phi, the bank's sums) of clips x (R, N), as
    values (the twin's codes times their scales, exact in float64)."""
    sums, _ = ref.cascade(x, x.shape[1])
    acc = ref.running(sums)[:, -1]
    p, phi = ref.readout(acc)
    return p.cpu(), phi.cpu(), ref.values(acc).cpu()


def compare(ref: checks.Reference, x, p, phi, s=None) -> dict:
    """The numbers ``correct`` is decided on: the port's p and phi (and
    the twin's sums ``s``) of the sampled clips x against the
    reference's."""
    p_ref, phi_ref, s_ref = observe_reference(ref, x)
    if ref.fixed:
        return {"codes_differing": checks.differ(p, p_ref)
                + checks.differ(phi, phi_ref) + checks.differ(s, s_ref)}
    return {"phi_gap": checks.rel_gap(phi, phi_ref),
            "p_gap": checks.gap(p, p_ref)}


def control(ctrl: checks.Reference, x, p, phi, s=None) -> dict:
    """``compare``'s inputs with the control's outputs in place of the
    port's."""
    p_c, phi_c, s_c = observe_reference(ctrl, x)
    return dict(x=x, p=p_c, phi=phi_c, **({} if s is None else {"s": s_c}))
