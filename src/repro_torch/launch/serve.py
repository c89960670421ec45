"""Token-by-token decode serving of a transformer config: the prefill and
generate loop of the reference's ``repro.launch.serve._serve_decode``,
without its argparse front end (the port's CLI is queued in ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.steps import make_serve_step
from repro_torch.models import transformer as T

__all__ = ["DecodeResult", "serve_decode"]


class DecodeResult(NamedTuple):
    tokens: np.ndarray        # (B, gen) generated tokens, int32
    prompts: np.ndarray       # (B, prompt_len) the seeded prompt tokens
    logits: list              # every step's (B, vocab_size) f32 logits
    prefill_s: float          # host seconds for the prompt, synchronized
    decode_s: float           # host seconds for the generated tokens


def serve_decode(cfg, params: dict, batch: int, prompt_len: int, gen: int,
                 seed: int = 0, device=None) -> DecodeResult:
    """Serve ``batch`` random prompts of ``prompt_len`` tokens, drawn with
    numpy from ``seed`` as the reference draws them, and generate ``gen``
    more, greedily.

    The prompt goes through decode slots one token at a time (teacher
    forcing), as in the reference; then each step feeds back the token it
    chose. The cache holds ``prompt_len + gen`` positions (a sliding window
    caps it). ``params`` must live on ``device`` (``cuda`` unless given).
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
            tok, logits, cache = step(params, tok, cache, pos)
            logits_kept.append(logits)
            generated.append(tok.cpu().numpy())
        sync()
        decode_s = time.perf_counter() - t0
    tokens = (np.concatenate(generated, axis=1) if generated
              else np.zeros((B, 0), np.int32))
    return DecodeResult(tokens, prompts, logits_kept, prefill_s, decode_s)
