"""AdamW + cosine schedule + global-norm clipping, as plain functions on
tensors: the counterpart of ``repro.optim.adamw``, not ``torch.optim.AdamW``
(whose decay and epsilon placement differ).

Params, gradients and moments are trees (nested dicts, lists and tuples of
tensors); the moments are float32 trees congruent with the params. The
update is functional, as in the reference: it returns new trees and
leaves its inputs as they are. Its scalars (the step count, the learning
rate, the bias corrections) are 0-d tensors on the params' device, so an
update never waits for the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "cosine_schedule",
           "global_norm", "adamw_update", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor   # 0-d int32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the congruent ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac`` of it
    at ``total_steps``; float32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics): the gradients clipped to
    a global norm of ``grad_clip``, the moments updated, and each param
    moved by lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p) with the
    bias-corrected moments; metrics ``grad_norm`` and ``lr`` (0-d)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    count = state.count + 1
    lr = cosine_schedule(cfg, count)
    cf = count.to(torch.float32)
    base = lambda b: torch.full((), b, dtype=torch.float32, device=cf.device)
    b1c = 1 - torch.pow(base(cfg.b1), cf)
    b2c = 1 - torch.pow(base(cfg.b2), cf)

    mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g, state.mu,
                  grads)
    nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) * g * g, state.nu,
                  grads)

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        return (p - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(mu, nu, count), {"grad_norm": gnorm,
                                                   "lr": lr}
