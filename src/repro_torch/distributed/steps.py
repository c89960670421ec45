"""The serving step: the counterpart of the reference's
``repro.distributed.steps.make_serve_step`` (training steps come with the
training slice, ROADMAP.md)."""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T

__all__ = ["make_serve_step"]


def make_serve_step(cfg, temperature: float = 0.0):
    """``serve_step(params, tokens, cache, cur_pos, generator=None)`` ->
    (next tokens (B, 1) int32, logits (B, vocab_size) f32, cache).

    Greedy (argmax, the first index on ties, as ``jnp.argmax``) when
    ``temperature == 0``; else one categorical draw per row from
    ``softmax(logits / temperature)`` with ``generator``, which a sampling
    step requires (the reference falls back to argmax without its key; here
    that raises, so a sampling configuration never returns greedy tokens
    unnoticed).
    """
    def serve_step(params, tokens, cache, cur_pos, generator=None):
        if temperature > 0.0 and generator is None:
            raise ValueError(f"serve_step samples at temperature "
                             f"{temperature}: pass a torch.Generator")
        logits, cache = T.decode_step(params, cfg, tokens, cache, cur_pos)
        logits = logits[:, 0, :cfg.vocab_size].float()
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = logits.argmax(dim=-1)
        return next_tok.to(torch.int32)[:, None], logits, cache

    return serve_step
