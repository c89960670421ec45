"""MP-aware training of the kernel machine (paper §III, §V): backprop
*through* the MP approximation with gamma annealing, so the learned
weights absorb the water-filling approximation error.

The counterpart of ``repro.core.trainer``. The classifier's output p is a
signed confidence in [-1, 1] (one-vs-all per class); the loss is a hinge
on p with a margin, plus weight decay on the templates, optionally with
8-bit quantization-aware training (``fake_quant`` on every weight, with a
straight-through gradient). SGD with momentum; gamma_scale is annealed
linearly from ``gamma_anneal_start`` to 1.

The step runs on the device of the features with torch autograd through
``core.mp.mp_exact``'s rule. The batches are the reference's: indices
from ``np.random.default_rng(cfg.seed)``, drawn in the same sequence, all
before the first step, so a step copies nothing from the host; its one
host read is the loss, which the reference also takes every step.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kernel_machine as km
from repro_torch.core.quant import fake_quant
from repro_torch.device import resolve_device

__all__ = ["TrainConfig", "TrainState", "loss_fn", "train", "evaluate"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 400
    lr: float = 0.5
    momentum: float = 0.9
    batch_size: int = 64
    gamma_anneal_start: float = 4.0   # gamma_scale annealed start -> 1.0
    gamma_anneal_steps: int = 150
    weight_decay: float = 1e-5
    quant_bits: int | None = None     # QAT bit width for weights
    margin: float = 0.5
    seed: int = 0


class TrainState(NamedTuple):
    params: km.MPKernelMachineParams
    velocity: km.MPKernelMachineParams
    step: int


def _maybe_quant(params: km.MPKernelMachineParams, bits: int | None):
    if bits is None:
        return params
    return params._replace(
        w_pos=fake_quant(params.w_pos, bits),
        w_neg=fake_quant(params.w_neg, bits),
        b_pos=fake_quant(params.b_pos, bits),
        b_neg=fake_quant(params.b_neg, bits),
    )


def loss_fn(params: km.MPKernelMachineParams, K: torch.Tensor,
            y_onehot: torch.Tensor, gamma_scale: float,
            cfg: TrainConfig) -> torch.Tensor:
    """Margin loss on the signed confidence p (targets {-1, +1} one-vs-all)
    plus weight decay on w+ and w-."""
    p = km.forward(_maybe_quant(params, cfg.quant_bits), K, gamma_scale)
    target = 2.0 * y_onehot - 1.0
    loss = torch.mean(torch.relu(cfg.margin - target * p))
    wd = cfg.weight_decay * (torch.sum(params.w_pos ** 2)
                             + torch.sum(params.w_neg ** 2))
    return loss + wd


def gamma_scale_at(step: int, cfg: TrainConfig) -> float:
    """The annealed gamma_scale of a step, in float32 as the reference's
    jitted step computes it."""
    f32 = np.float32
    frac = np.minimum(f32(step) / f32(cfg.gamma_anneal_steps), f32(1.0))
    return float(f32(cfg.gamma_anneal_start) * (f32(1.0) - frac)
                 + f32(1.0) * frac)


def batch_indices(M: int, cfg: TrainConfig) -> np.ndarray:
    """(num_steps, min(batch_size, M)) indices: the reference's draws, one
    ``integers`` call per step from ``default_rng(cfg.seed)``."""
    rng = np.random.default_rng(cfg.seed)
    b = min(cfg.batch_size, M)
    out = np.zeros((cfg.num_steps, b), np.int64)
    for t in range(cfg.num_steps):
        out[t] = rng.integers(0, M, size=b)
    return out


def _labels(y) -> torch.Tensor:
    if isinstance(y, torch.Tensor):
        return y.to(torch.long)
    return torch.as_tensor(np.asarray(y), dtype=torch.long)


def train(K_train, y_train, num_classes: int,
          cfg: TrainConfig = TrainConfig(), device=None
          ) -> tuple[km.MPKernelMachineParams, list[float]]:
    """Minibatch SGD + momentum with gamma annealing.

    K_train (M, P) standardized kernel features, y_train (M,) int labels,
    moved to ``device`` (``cuda`` unless given; raises without a card).
    Returns the trained params and the loss trace.

    The initial params are ``km.init_params`` drawn from
    ``torch.Generator().manual_seed(cfg.seed)``: other values than the
    reference draws from ``jax.random`` with the same seed (the parity
    tests give both packages the same start).
    """
    dev = resolve_device(device)
    K = torch.as_tensor(K_train, dtype=torch.float32).to(dev)
    y = _labels(y_train).to(dev)
    M, P = K.shape
    init = km.init_params(torch.Generator().manual_seed(cfg.seed), P,
                          num_classes, device=dev)
    params = km.MPKernelMachineParams(
        *(t.detach().clone().requires_grad_(True) for t in init))
    velocity = km.MPKernelMachineParams(*(torch.zeros_like(t)
                                          for t in params))
    y1h = torch.nn.functional.one_hot(y, num_classes).to(torch.float32)
    idx = torch.as_tensor(batch_indices(M, cfg)).to(dev)
    state = TrainState(params, velocity, 0)
    losses: list[float] = []
    for t in range(cfg.num_steps):
        state, loss = _step(state, K, y1h, idx[t], cfg)
        losses.append(float(loss))
    return (km.MPKernelMachineParams(*(p.detach() for p in state.params)),
            losses)


def _step(state: TrainState, K: torch.Tensor, y1h: torch.Tensor,
          batch: torch.Tensor, cfg: TrainConfig):
    """One SGD step: v = momentum v - lr g; p = p + v (in place)."""
    params, velocity, step = state
    loss = loss_fn(params, K[batch], y1h[batch], gamma_scale_at(step, cfg),
                   cfg)
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, v, g in zip(params, velocity, grads):
            v.mul_(cfg.momentum).sub_(g.mul_(cfg.lr))
            p.add_(v)
    return TrainState(params, velocity, step + 1), loss.detach()


def evaluate(params: km.MPKernelMachineParams, K, y,
             quant_bits: int | None = None) -> float:
    """Accuracy of argmax p (the first class on ties, as ``jnp.argmax``)
    on K (M, P) against the labels y (M,)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=params.w_pos.device)
    y = _labels(y).to(K.device)
    with torch.no_grad():
        p = km.forward(_maybe_quant(params, quant_bits), K, 1.0)
        pred = torch.argmax(p, dim=-1)
        return float((pred == y).to(torch.float32).mean())
