"""Serving launcher: acoustic stream sessions and LLM decode, one CLI.

Acoustic stream serving (the paper's deployment: only classified data
leaves the device), on the card unless ``--device cpu``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch esc10-mp \\
        --smoke --streams 16 --chunk 160 --rounds 25 [--device cpu]

Every sensor stream is a session of one ``StreamServer`` (or of a
``StreamRouter`` with ``--shards`` > 1); each round feeds one packet per
stream, and all resident streams advance in one session step per wave (on
the card one CUDA graph replay).

LLM decode, for every decoder of the zoo (the prompt goes through decode
slots one token at a time, then each step feeds back the token it chose:
greedy, or with ``--temperature`` > 0 drawn from a generator seeded with
``--seed``; a VLM decodes text-only prompts; the encoder is refused):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --smoke --batch 4 --prompt-len 16 --gen 32 [--temperature 0.8] \\
        [--device cpu]

:func:`serve_decode` is that loop as a function.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.steps import make_serve_step
from repro_torch.models import transformer as T

__all__ = ["DecodeResult", "serve_decode", "main"]

ACOUSTIC_ARCH = "esc10-mp"


class DecodeResult(NamedTuple):
    tokens: np.ndarray        # (B, gen) generated tokens, int32
    prompts: np.ndarray       # (B, prompt_len) the seeded prompt tokens
    logits: list              # every step's (B, vocab_size) f32 logits
    prefill_s: float          # host seconds for the prompt, synchronized
    decode_s: float           # host seconds for the generated tokens


def serve_decode(cfg, params: dict, batch: int, prompt_len: int, gen: int,
                 seed: int = 0, device=None,
                 temperature: float = 0.0) -> DecodeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens, drawn with
    numpy from ``seed`` as the reference draws them, and generate ``gen``
    more: greedily, or at ``temperature`` > 0 each drawn from
    ``softmax(logits / temperature)`` by a ``torch.Generator`` seeded with
    ``seed`` (the same seed, the same tokens; JAX's PRNG draws others).

    The prompt goes through decode slots one token at a time (teacher
    forcing), as in the reference, and the token after it is greedy there
    as here; then each step feeds back the token it chose. The cache holds
    ``prompt_len + gen`` positions (a sliding window caps it). ``params``
    must live on ``device`` (``cuda`` unless given).
    """
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    if prompt_len < 1:
        raise ValueError("serve_decode needs a prompt of at least 1 token")
    dev = resolve_device(device)
    B = batch
    total = prompt_len + gen
    cache_len = total if cfg.sliding_window is None \
        else min(total, cfg.sliding_window)
    cache = T.init_cache(cfg, B, cache_len, device=dev)
    step = make_serve_step(cfg)
    draw, gen_rng = step, None
    if temperature > 0:
        draw = make_serve_step(cfg, temperature)
        gen_rng = torch.Generator(device=dev).manual_seed(seed)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, prompt_len))
    toks = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    logits_kept = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    with torch.no_grad():
        t0 = time.perf_counter()
        for i in range(prompt_len):
            pos = torch.full((B,), i, dtype=torch.int32, device=dev)
            nxt, logits, cache = step(params, toks[:, i:i + 1], cache, pos)
            logits_kept.append(logits)
        sync()
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        tok, generated = nxt, []
        for i in range(gen):
            pos = torch.full((B,), prompt_len + i, dtype=torch.int32,
                             device=dev)
            tok, logits, cache = draw(params, tok, cache, pos, gen_rng)
            logits_kept.append(logits)
            generated.append(tok.cpu().numpy())
        sync()
        decode_s = time.perf_counter() - t0
    tokens = (np.concatenate(generated, axis=1) if generated
              else np.zeros((B, 0), np.int32))
    return DecodeResult(tokens, prompts, logits_kept, prefill_s, decode_s)


def serve_acoustic(args) -> list:
    """Serve ``args.streams`` synthetic sensor streams of esc10-mp for
    ``args.rounds`` packets of ``args.chunk`` samples; returns the last
    round's results."""
    from repro_torch.configs.esc10_mp import make_pipeline
    from repro_torch.serving import StreamRouter, StreamServer

    dev = resolve_device(args.device)
    pipe = make_pipeline(smoke=args.smoke, seed=args.seed,
                         stream_impl=args.stream_impl,
                         numerics=args.numerics,
                         fixed_amax=args.fixed_amax, device=dev)
    fs = pipe.config.fs
    # the bucket ladder needs a power-of-two max_chunk: the packet's bucket
    max_chunk = max(16, 1 << (args.chunk - 1).bit_length())
    if args.shards > 1:
        server = StreamRouter(pipe, num_shards=args.shards,
                              capacity=args.streams, max_chunk=max_chunk)
    else:
        server = StreamServer(pipe, capacity=args.streams,
                              max_chunk=max_chunk)
    rng = np.random.default_rng(args.seed)
    ids = [f"mic-{i:03d}" for i in range(args.streams)]
    for sid in ids:
        server.open(sid)
    audio = rng.standard_normal(
        (args.streams, args.rounds * args.chunk)).astype(np.float32)

    callers = max(1, min(4, args.streams))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    results = []
    for r in range(args.rounds):
        sl = slice(r * args.chunk, (r + 1) * args.chunk)
        reqs = [(sid, audio[i, sl]) for i, sid in enumerate(ids)]
        if args.use_async:
            # independent callers coalesce into shared waves; one drain
            # resolves the round (bit for bit the synchronous feed)
            tickets = [server.submit(reqs[g::callers])
                       for g in range(callers)]
            server.drain()
            results = [res for t in tickets for res in t.results]
        else:
            results = server.feed(reqs)
    wall = time.perf_counter() - t0
    fed = args.streams * args.rounds
    print(f"arch={ACOUSTIC_ARCH} streams={args.streams} "
          f"chunk={args.chunk} ({args.chunk / fs * 1e3:.0f} ms) "
          f"rounds={args.rounds} shards={args.shards} "
          f"async={args.use_async} numerics={pipe.config.numerics} "
          f"device={dev}")
    print(f"served {fed} chunks in {wall * 1e3:.0f} ms "
          f"({fed / max(wall, 1e-9):.0f} chunks/s, "
          f"{fed * args.chunk / max(wall, 1e-9) / 1e6:.2f} Msamples/s, "
          f"stats={server.stats()})")
    for res in results[:4]:
        print(f"  {res.session_id}: label={res.label} "
              f"confidence={res.confidence:+.3f} "
              f"samples={res.samples_seen}")
    return results


def _decode(args) -> np.ndarray:
    from repro_torch.configs import get_arch, get_smoke

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    dev = resolve_device(args.device)
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                    device=dev)
    res = serve_decode(cfg, params, args.batch, args.prompt_len, args.gen,
                       seed=args.seed, device=dev,
                       temperature=args.temperature)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} temperature={args.temperature} device={dev}")
    print(f"prefill {res.prefill_s * 1e3:.0f} ms, decode "
          f"{res.decode_s * 1e3:.0f} ms "
          f"({args.gen * args.batch / max(res.decode_s, 1e-9):.1f} tok/s)")
    print("sample generation:", res.tokens[0][:16].tolist())
    return res.tokens


def main(argv=None):
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=sorted(ARCH_IDS) + [ACOUSTIC_ARCH],
                    required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; the card (cuda) unless given, e.g. "
                         "'cpu' to run the plain PyTorch versions")
    # LLM decode knobs
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; above: sampled from softmax(logits / "
                         "temperature) by a generator seeded with --seed")
    # acoustic stream knobs
    ap.add_argument("--streams", type=int, default=16,
                    help="esc10-mp: concurrent sensor sessions (slots)")
    ap.add_argument("--chunk", type=int, default=160,
                    help="esc10-mp: sensor packet length in samples")
    ap.add_argument("--rounds", type=int, default=25,
                    help="esc10-mp: packets fed per stream")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="esc10-mp: feed through submit()/drain() (4 "
                         "callers per round) instead of feed(); the same "
                         "decisions bit for bit")
    ap.add_argument("--shards", type=int, default=1,
                    help="esc10-mp: >1 serves through a StreamRouter with "
                         "this many StreamServer shards (crc32 of the "
                         "stream id; one shared step)")
    ap.add_argument("--stream-impl", choices=["xla", "pallas"],
                    default="pallas",
                    help="esc10-mp: the session step's octave cascade: "
                         "'pallas' the CUDA stream kernel (its plain "
                         "version on the CPU), 'xla' torch ops")
    ap.add_argument("--numerics", choices=["float", "fixed"],
                    default="float",
                    help="esc10-mp: 'fixed' serves the bit-true int32 twin")
    ap.add_argument("--fixed-amax", type=float, default=None,
                    help="esc10-mp: ADC full scale for --numerics fixed "
                         "(default: the config's 1.0; the synthetic sensors "
                         "peak around 4)")
    args = ap.parse_args(argv)
    if args.arch == ACOUSTIC_ARCH:
        return serve_acoustic(args)
    return _decode(args)


if __name__ == "__main__":
    main()
