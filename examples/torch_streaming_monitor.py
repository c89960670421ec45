"""Continuous acoustic monitoring with the port's streaming pipeline.

The paper's deployment story: audio goes in at the sensor, ONLY class
decisions come out (remote monitoring over limited bandwidth). This example
trains an ``InFilterPipeline`` on synthetic ESC-10 clips, then simulates a
long environmental recording by concatenating held-out clips and pushes it
through the stateful streaming API in sensor-sized chunks (10 ms frames),
each chunk one launch of the session-step CUDA kernel for the whole octave
cascade. The state (FIR delay lines, decimator phases, per-band
accumulators) is a few KB regardless of how long the stream runs, exactly
the FPGA's register footprint. The counterpart of
examples/streaming_monitor.py.

    PYTHONPATH=src python examples/torch_streaming_monitor.py [--fast] \
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.filterbank import FilterBankConfig
from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.core.trainer import TrainConfig
from repro_torch.data.acoustic import ESC10_CLASSES, make_esc10_like
from repro_torch.serving import StreamServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    fs = 4000.0 if args.fast else 8000.0
    octaves = 4 if args.fast else 5
    per_tr = 4 if args.fast else 12

    # 1. train the deployable pipeline: taps + classifier + statistics in one
    ds = make_esc10_like(per_class_train=per_tr, per_class_test=2,
                         fs=fs, seconds=0.5, seed=0)
    cfg = FilterBankConfig(fs=fs, num_octaves=octaves, filters_per_octave=5,
                           mode="mp", gamma_f=4.0, use_pallas=True,
                           stream_impl="pallas")
    pipe, losses = InFilterPipeline.fit(
        cfg, ds.x_train, ds.y_train, num_classes=10,
        train_cfg=TrainConfig(num_steps=150 if args.fast else 400),
        device=args.device)
    print(f"trained: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{cfg.num_filters} bands")

    # 2. one-shot check on the held-out clips (one bank-kernel launch)
    p = pipe.predict(ds.x_test)
    acc = float((p.argmax(-1).cpu().numpy() == ds.y_test).mean())
    print(f"one-shot test acc: {acc:.3f}")

    # 3. continuous mode: a 'long recording' of back-to-back events, chunked
    #    into 10 ms frames, one session slot per event so each decision is
    #    clean. The slot-batched SessionState carries FIR delay lines,
    #    per-slot decimator phases, accumulators, and the running amax;
    #    apply() is the same entry point as the one-shot call above.
    order = np.argsort(ds.y_test, kind="stable")
    events = np.ascontiguousarray(ds.x_test[order])     # (E, N) events
    stream = torch.from_numpy(events).to(pipe.device)
    chunk = int(fs * 0.010)                            # 10 ms sensor frames
    state = pipe.init_session(stream.shape[0])
    n = stream.shape[1]
    for i in range(0, n, chunk):
        p_now, state = pipe.apply(stream[:, i:i + chunk], state)
    pred = p_now.argmax(-1).cpu().numpy()
    truth = ds.y_test[order]
    acc_stream = float((pred == truth).mean())
    state_bytes = sum(t.numel() * t.element_size() for t in state.tensors())
    print(f"streamed  test acc: {acc_stream:.3f} "
          f"({n // chunk} chunks of {chunk} samples, "
          f"state = {state_bytes / stream.shape[0]:.0f} B/stream)")
    for e in range(0, stream.shape[0], max(1, stream.shape[0] // 5)):
        print(f"  event {e}: true={ESC10_CLASSES[truth[e]]:14s} "
              f"decided={ESC10_CLASSES[pred[e]]:14s} "
              f"confidence={float(p_now[e, pred[e]]):+.2f}")

    # 4. deployment-shaped serving: the same events as LOGICAL sessions on a
    #    fixed-capacity StreamServer; sensors come and go, the server
    #    multiplexes them onto slots and one step (on the card, one captured
    #    CUDA graph replay) advances all resident streams per packet
    server = StreamServer(pipe, capacity=min(4, events.shape[0]),
                          max_chunk=max(16, 1 << (chunk - 1).bit_length()))
    ids = [f"sensor-{e}" for e in range(server.capacity)]
    for sid in ids:
        server.open(sid)
    results = []
    for i in range(0, n, chunk):
        results = server.feed([(sid, events[e, i:i + chunk])
                               for e, sid in enumerate(ids)])
    ok = sum(r.label == truth[e] for e, r in enumerate(results))
    print(f"served    {len(ids)} sessions x {n // chunk} packets: "
          f"{ok}/{len(ids)} correct, stats={server.stats()}")
    return acc_stream


if __name__ == "__main__":
    main()
