"""AdamW + cosine schedule + global-norm clipping, as plain functions on
tensors: the counterpart of ``repro.optim.adamw``, not ``torch.optim.AdamW``
(whose decay and epsilon placement differ).

Params, gradients and moments are trees (nested dicts, lists and tuples of
tensors); the moments are float32 trees congruent with the params. The
update is functional, as in the reference: it returns new trees and
leaves its inputs as they are. Leaves may be ``DTensor``s (sharded
training): the update is elementwise on each shard, and the clipping norm
is the norm over the whole mesh. Its scalars (the step count, the learning
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
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
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


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf together, a plain 0-d tensor, the leaves'
    squares added in tree order. A ``DTensor`` leaf counts over the whole
    mesh, not over this rank's shard: the local sums of squares of the
    leaves of one placement are summed over the mesh dims they are sharded
    on in one all-reduce."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    sqs, groups = [], {}
    for i, g in enumerate(tree_leaves(tree)):
        if _is_dtensor(g):
            key = (id(g.device_mesh), tuple(g.placements))
            groups.setdefault(key, (g, []))[1].append(i)
            g = g.to_local()
        sqs.append(torch.sum(torch.square(g.to(torch.float32))))
    for g, idx in groups.values():
        full = DTensor.from_local(
            torch.stack([sqs[i] for i in idx]), g.device_mesh,
            [Partial() if p.is_shard() else Replicate()
             for p in g.placements]).full_tensor()
        for j, i in enumerate(idx):
            sqs[i] = full[j]
    total = 0
    for sq in sqs:
        total = total + sq
    return torch.sqrt(total)


def _shardwise(fn):
    """``fn`` on plain tensors, applied to ``DTensor`` leaves shard by
    shard (the update is elementwise): the result is placed as the first
    argument. A leaf placed otherwise is redistributed to it first."""
    def apply(first, *rest):
        if not _is_dtensor(first):
            return fn(first, *rest)
        from torch.distributed.tensor import DTensor
        local = [first.to_local()] + [
            (r if r.placements == first.placements else
             r.redistribute(first.device_mesh, first.placements)).to_local()
            for r in rest]
        return DTensor.from_local(fn(*local), first.device_mesh,
                                  first.placements, run_check=False,
                                  shape=first.shape, stride=first.stride())
    return apply


def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics): the gradients clipped to
    a global norm of ``grad_clip``, the moments updated, and each param
    moved by lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p) with the
    bias-corrected moments; metrics ``grad_norm`` and ``lr`` (0-d)."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)

    count = state.count + 1
    lr = cosine_schedule(cfg, count)
    cf = count.to(torch.float32)
    base = lambda b: torch.full((), b, dtype=torch.float32, device=cf.device)
    b1c = 1 - torch.pow(base(cfg.b1), cf)
    b2c = 1 - torch.pow(base(cfg.b2), cf)

    def first(m, g):
        return cfg.b1 * m + (1 - cfg.b1) * (g.to(torch.float32) * scale)

    def second(v, g):
        g = g.to(torch.float32) * scale
        return cfg.b2 * v + (1 - cfg.b2) * g * g

    def upd(p, m, v):
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p
        return (p - lr * step).to(p.dtype)

    mu = tree_map(_shardwise(first), state.mu, grads)
    nu = tree_map(_shardwise(second), state.nu, grads)
    new_params = tree_map(_shardwise(upd), params, mu, nu)
    return new_params, AdamWState(mu, nu, count), {"grad_norm": gnorm,
                                                   "lr": lr}
