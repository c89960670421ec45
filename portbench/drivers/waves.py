"""Live sensor streams through ``serving.StreamServer``, in waves.

A closed loop: ``streams`` sensors stay connected all run; a wave carries
one packet of ``packet`` samples from every stream; each round submits
``inflight`` waves back to back through ``StreamServer.submit`` (a wave
is staged and launched while the one before it still runs), then waits
for the last one's event and resolves the round with ``poll``. A packet's
decision time runs from its wave's ``submit`` to the ``poll`` that
resolved it.

A stream is classified in windows of ``session_packets`` packets (the
length of an ESC-10 clip), as the paper's classifier decides per clip:
at a window's end the stream's session is closed and opened again, so its
registers start from zero. Windows are staggered: the streams fall into
G = session_packets / inflight groups (stream i into i mod G), and group
g's first window is cut short by ``inflight g`` packets, so one group
restarts in every round, between rounds. Each window plays one recording
from its start: a clip of a seeded pool of ``pool_clips`` distinct clips,
drawn from the seed per (group, window) as a permutation of the pool, so
the streams of a group play distinct clips and streams of different
groups are at different points of theirs: no two streams play the same
audio in step.

The check: ``check_streams`` streams drawn from the seed; every decision
they were served after the warm-up, and their registers at the end, held
against the reference's run of the same packets, window by window from
zero registers.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import audio, checks, counts, system, trace

# (stream, window) draws kept; window k of a stream reuses draw k mod this
DRAWN_WINDOWS = 1024


def schedule(mix: dict, cfg: dict, seed: int) -> dict:
    """The traffic of a seed: ``pool`` (clips, Ls, L) float32, and per
    stream its window phase ``offset`` (in packets) and, per window, the
    ``clip`` it plays."""
    fs = float(cfg["bank"]["fs"])
    L, S = int(mix["packet"]), int(mix["streams"])
    Ls, inflight = int(mix["session_packets"]), int(mix["inflight"])
    if Ls % inflight:
        raise ValueError("session_packets must be a multiple of inflight, "
                         "so that windows restart between rounds")
    G, M = Ls // inflight, int(mix["pool_clips"])
    if M * G < S:
        raise ValueError(f"pool_clips must be at least streams / {G}: a "
                         "group's streams play distinct clips")
    pool = audio.clips(system.subseed(seed, system.TRAFFIC), M, Ls * L, fs)
    rng = np.random.default_rng(system.subseed(seed, system.TRAFFIC) + 1)
    perms = rng.random((G, DRAWN_WINDOWS, M)).argsort(-1)
    i = np.arange(S)
    return dict(pool=pool.reshape(M, Ls, L), offset=inflight * (i % G),
                clip=perms[i % G, :, i // G])


def position(sched: dict, wave: int):
    """Per stream at ``wave``: (window index, packet index in it)."""
    Ls = sched["pool"].shape[1]
    t = wave + sched["offset"]
    return t // Ls, t % Ls


def packets(sched: dict, stream: int, waves) -> np.ndarray:
    """Stream ``stream``'s packets at ``waves``: (len(waves), L)."""
    Ls = sched["pool"].shape[1]
    t = np.asarray(waves) + sched["offset"][stream]
    return sched["pool"][sched["clip"][stream, (t // Ls) % DRAWN_WINDOWS],
                         t % Ls]


def run(env) -> dict:
    cfg, mix, device, spans = env.cfg, env.mix, env.device, env.spans
    from repro_torch.serving import StreamServer

    S, L = int(mix["streams"]), int(mix["packet"])
    fs = float(cfg["bank"]["fs"])
    sched = schedule(mix, cfg, env.seed)
    Ls = sched["pool"].shape[1]
    flat = sched["pool"].reshape(-1, L)
    env.mark("pool")
    clf = system.draw_classifier(cfg, env.seed, device)
    cal = system.calibration_audio(cfg, env.seed)
    pipe = system.build(cfg, clf, device, cal)
    env.mark("pipeline")
    server = StreamServer(pipe, capacity=S, max_chunk=int(mix["max_chunk"]),
                          min_chunk=int(mix["min_chunk"]),
                          coalesce_watermark=S)
    ids = [f"s{i:04d}" for i in range(S)]
    for sid in ids:
        server.open(sid)
    env.mark("open")
    rng = np.random.default_rng(system.subseed(env.seed, system.SAMPLE))
    sample = np.sort(rng.choice(S, int(mix["check_streams"]), replace=False))
    cuda = device.type == "cuda"
    streams = np.arange(S)

    waves = 0
    served = []                 # per checked wave: (wave, labels, confs)
    lat = []                    # per wave of the window: seconds

    def rounds(n: int, record=None, checked: bool = True):
        nonlocal waves
        for _ in range(n):
            if waves:
                with spans("reopen"):
                    for i in np.flatnonzero(position(sched, waves)[1] == 0):
                        server.close(ids[i])
                        server.open(ids[i])
            tickets = []
            for _ in range(int(mix["inflight"])):
                with spans("stage"):
                    k, j = position(sched, waves)
                    rows = sched["clip"][streams, k % DRAWN_WINDOWS] * Ls + j
                    reqs = [(ids[i], flat[rows[i]]) for i in range(S)]
                t = time.perf_counter()
                with spans("submit"):
                    tickets.append((waves, t, server.submit(reqs)))
                waves += 1
            if cuda:
                with spans("wait"):
                    ev = torch.cuda.Event()
                    ev.record()
                    ev.synchronize()
            with spans("resolve"):
                res = server.poll(tickets[-1][2])
            t_done = time.perf_counter()
            if res is None:
                raise RuntimeError("the round did not resolve after its "
                                   "last wave's event")
            for k, t, tk in tickets:
                if record is not None:
                    record.append(t_done - t)
                if checked:
                    r = [tk.results[i] for i in sample]
                    served.append((k, [x.label for x in r],
                                   [x.confidence for x in r]))

    # set-up ends with the cell's one bucket captured and warm
    rounds(int(mix["warm_rounds"]), checked=False)
    if cuda:
        torch.cuda.synchronize()
    env.mark("warm")
    env.settle()
    host0 = {k: len(v) for k, v in spans.seconds.items()}
    t0 = time.perf_counter()
    env.window_started(t0)
    while time.perf_counter() - t0 < env.seconds:
        rounds(1, record=lat)
    window_s = time.perf_counter() - t0
    env.window_ended()
    window_waves = len(lat)
    host = {k: sum(v[host0.get(k, 0):]) for k, v in spans.seconds.items()}
    tr = None
    if env.trace and cuda:
        tr = trace.profile(lambda n: rounds(n), int(mix["trace_rounds"]),
                           spans)
        if tr is not None:
            tr["units"] = int(mix["trace_rounds"]) * int(mix["inflight"])

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    st = server.state
    slots = [server.session(ids[i]).slot for i in sample]
    regs = dict(acc=st.acc[slots].cpu(),
                delays=[d[slots].cpu() for d in st.delays],
                consumed=[c[slots].cpu() for c in st.consumed])
    prog_check = (np.asarray([k for k, _, _ in served]),
                  np.asarray([lab for _, lab, _ in served]).T,
                  np.asarray([cf for _, _, cf in served]).T)
    del server, pipe, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    clf_h = system.host(clf)
    ref = checks.Reference(cfg, clf_h, cal, device)
    out = dict(
        window_s=window_s, units=window_waves, rows=S,
        audio_s=window_waves * S * L / fs,
        latencies_s=lat, host_s=host, trace=tr, memory_peak_bytes=peak,
        attempted=window_waves * S, failed=0, kind_of_mix="stream",
        reference=ref,
        inputs=dict(x=_windows(sched, sample, waves), segment=L,
                    served=prog_check, regs=regs))
    out.update(_yardstick(cfg, ref.prog, S, L))
    if env.check:
        t = time.perf_counter()
        out["numbers"] = compare(ref, **out["inputs"])
        out["check_s"] = time.perf_counter() - t
    return out


def _windows(sched: dict, sample, waves: int) -> list:
    """Per checked stream, its windows up to ``waves``: [(first wave,
    packets (n, L))], each played from zero registers."""
    Ls = sched["pool"].shape[1]
    out = []
    for i in sample:
        starts = [0] + list(range(Ls - sched["offset"][i], waves, Ls))
        ends = starts[1:] + [waves]
        out.append([(s, packets(sched, i, np.arange(s, e)))
                    for s, e in zip(starts, ends)])
    return out


def _yardstick(cfg: dict, prog, S: int, L: int) -> dict:
    """Operations and bytes of one wave: the cascade, and the whole step
    (cascade and readout)."""
    cascade = counts.bank_ops(cfg, prog, S, L)
    return dict(cascade_ops=cascade,
                cascade_bytes=counts.stream_bytes(cfg, S, L),
                step_ops=cascade + counts.readout_ops(cfg, prog, S),
                ops_kind="int32" if prog is not None else "f32")


def observe_reference(ref: checks.Reference, x: list, segment: int,
                      waves_checked: np.ndarray) -> tuple:
    """What the reference serves for the checked streams' windows ``x``
    (see ``_windows``): p (R, K, C), labels and confidences (R, K) at the
    checked waves, and the registers at the end."""
    Ls = max(len(pk) for w in x for _, pk in w)
    rows, where = [], {}
    for r, w in enumerate(x):
        for s, pk in w:
            for j in range(len(pk)):
                where[(r, s + j)] = (len(rows), j)
            rows.append(np.pad(pk, ((0, Ls - len(pk)), (0, 0))).reshape(-1))
    # zero padding after a window's end changes none of its outputs
    sums, _ = ref.cascade(np.stack(rows), segment)
    acc = ref.running(sums)                          # (windows, Ls, P)
    pick = [where[(r, int(k))] for r in range(len(x)) for k in waves_checked]
    a = torch.as_tensor([q for q, _ in pick], device=acc.device)
    b = torch.as_tensor([j for _, j in pick], device=acc.device)
    p, _ = ref.readout(acc[a, b])
    p = p.reshape(len(x), len(waves_checked), -1).cpu()
    ends = []
    for w in x:
        sums, signals = ref.cascade(w[-1][1].reshape(1, -1), segment)
        ends.append((ref.running(sums)[0, -1].cpu(),
                     [d[0].cpu() for d in ref.registers(signals)],
                     [s.shape[1] for s in signals]))
    regs = dict(acc=torch.stack([e[0] for e in ends]),
                delays=[torch.stack(d) for d in zip(*[e[1] for e in ends])],
                consumed=[torch.as_tensor(c)
                          for c in zip(*[e[2] for e in ends])])
    return p, p.argmax(-1).numpy(), p.max(-1).values.numpy(), regs


def compare(ref: checks.Reference, x, segment, served, regs) -> dict:
    """The numbers ``correct`` is decided on (see the module docstring):
    the served decisions and registers ``served`` / ``regs`` against the
    reference ``ref`` run on the same windows x."""
    waves_checked, labels, confs = served
    p_ref, _, _, want = observe_reference(ref, x, segment, waves_checked)
    R, K = labels.shape
    flat = p_ref.reshape(R * K, -1)
    if ref.fixed:
        p_lab = flat.gather(1, torch.as_tensor(labels.reshape(-1))[:, None])
        return {"codes_differing": (
            int((flat.argmax(1).numpy() != labels.reshape(-1)).sum())
            + checks.differ(p_lab[:, 0], confs.reshape(-1))
            + checks.differ(regs["acc"], want["acc"])
            + sum(checks.differ(a, b) for a, b in zip(regs["delays"],
                                                     want["delays"]))
            + sum(checks.differ(a, b) for a, b in zip(regs["consumed"],
                                                     want["consumed"])))}
    conf_gap, label_gap = checks.decision_gaps(labels.reshape(-1),
                                               confs.reshape(-1), flat)
    return {"conf_gap": conf_gap, "label_gap": label_gap,
            "acc_gap": checks.rel_gap(regs["acc"], want["acc"]),
            "delay_gap": max(checks.gap(a, b) for a, b in
                             zip(regs["delays"], want["delays"])),
            "consumed_differing": sum(
                checks.differ(a, b) for a, b in zip(regs["consumed"],
                                                    want["consumed"]))}


def control(ctrl: checks.Reference, x, segment, served, regs) -> dict:
    """``compare``'s inputs with the control's decisions and registers in
    place of the port's."""
    _, labels, confs, want = observe_reference(ctrl, x, segment, served[0])
    return dict(x=x, segment=segment, served=(served[0], labels, confs),
                regs=want)
