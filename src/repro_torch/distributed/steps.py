"""Train and serve step builders: the counterpart of the reference's
``repro.distributed.steps``.

``make_train_step(cfg, opt, mesh=None)`` -> (init_state, train_step): the
chunked cross-entropy loss (``make_loss_fn``), its gradients by torch
autograd (through ``kernels.ops.mp_linear``'s backward kernel in MP mode),
averaged over ``accum`` microbatches, and one AdamW update.

Under a mesh (a ``DeviceMesh``, one process per rank) the params and the
AdamW moments are ``DTensor``s placed by ``sharding.param_specs``; each
step takes the global batch and keeps its rows of it (``batch_specs``:
split over the DP axes). Every layer's weights are gathered on use
(``models.transformer._constrain``), so each MP product sees its whole
``d`` on local tensors; the gradient of a gathered weight is each rank's
partial sum over its rows, reduced onto the weight's shards. The loss is
the mean over the global batch: each rank divides its sum by the global
count of labelled positions, and the reported loss is summed over the DP
axes. No compute is split over 'model' (ROADMAP.md).

``make_serve_step(cfg)`` -> the decode step producing next-token ids.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, tree_leaves, tree_map)

__all__ = ["TrainState", "make_train_step", "make_serve_step",
           "make_loss_fn"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor   # 0-d int32


def _dp_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the mesh's DP axes (the same on every rank);
    ``x`` itself without a mesh."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dp = sh.data_axes(mesh)
    return DTensor.from_local(
        x, mesh, [Partial() if a in dp else Replicate()
                  for a in sh.axis_sizes(mesh)]).full_tensor()


def _local_rows(batch: dict, mesh, accum: int) -> dict:
    """This rank's rows of the global batch, as ``batch_specs`` splits
    them (all of them where the DP axes do not divide the batch). With
    ``accum`` > 1 the global batch is cut into its microbatches first and
    each is split, so microbatch a holds the same rows as on one device."""
    if mesh is None:
        return batch
    index, count = sh.data_shard(mesh)
    specs = sh.batch_specs(batch, mesh)
    out = {}
    for k, v in batch.items():
        if not (specs[k] and specs[k][0]):
            out[k] = v
            continue
        if v.shape[0] % (accum * count):
            raise ValueError(f"batch {v.shape[0]} does not split into "
                             f"{accum} microbatches over {count} shards")
        micro = v.reshape(accum, count, -1, *v.shape[1:])[:, index]
        out[k] = micro.reshape(-1, *v.shape[1:])
    return out


def _hidden_and_labels(params, cfg, batch):
    """The final hidden states aligned with their labels, per modality
    (the reference's ``_labels_and_logits``): audio frames with their own
    labels, every frame and no shift; else next-token prediction, a VLM's
    patch positions dropped before the shift."""
    h = T.forward(params, cfg, batch, return_hidden=True)
    if cfg.audio_frontend:
        return h, batch["labels"].long()
    if cfg.vlm_patches:
        h = h[:, cfg.vlm_patches:]
    return h[:, :-1], batch["tokens"][:, 1:].long()


def _chunk_ce(hc, lc, head, cfg):
    """The summed cross entropy of one sequence chunk: its logits through
    the head (an MP product in ``mp_mode``), labels < 0 masked."""
    logits = L.linear(hc, head, mp_mode=cfg.mp_mode, mp_gamma=cfg.mp_gamma,
                      compute_dtype=L.cdt(cfg)).float()
    m = logits.amax(-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    valid = lc >= 0
    gold = torch.where(valid, logits.gather(
        -1, lc.clamp_min(0)[..., None])[..., 0], 0.0)
    return ((logz - gold) * valid.float()).sum()


def make_loss_fn(cfg, seq_chunk: int = 1024, mesh=None):
    """Chunked cross entropy: the head (through ``layers.linear``, so an
    MP product in ``mp_mode``) and the softmax run one sequence chunk of
    ``seq_chunk`` positions at a time, so the (B, S, V) logits never exist
    at once; under ``cfg.remat`` each chunk is recomputed in the backward
    (the reference's ``jax.checkpoint(chunk_ce)``). Labels per modality
    (``_hidden_and_labels``): audio ``batch["labels"]`` per frame, else
    the next tokens (after a VLM's patches). Mean over the labelled
    positions (labels >= 0); under ``mesh``, this rank's share of the mean
    over the global batch (its sum over the global count)."""
    chunk_ce = L.remat(_chunk_ce, cfg)

    def loss_fn(params, batch):
        h, labels = _hidden_and_labels(params, cfg, batch)
        head = T.head(params, cfg)
        S2 = h.shape[1]
        C = min(seq_chunk, S2)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for c0 in range(0, S2, C):
            tot = tot + chunk_ce(h[:, c0:c0 + C], labels[:, c0:c0 + C],
                                 head, cfg)
        n = torch.clamp_min(_dp_sum((labels >= 0).sum().float(), mesh), 1.0)
        return tot / n

    return loss_fn


def make_train_step(cfg, opt: AdamWConfig, accum: int = 1, mesh=None):
    """``accum`` > 1 splits the batch (this rank's rows of it, under
    ``mesh``; every entry, ``tokens``, ``frames``, ``labels``, ``patches``,
    by its leading dim) into that many microbatches whose gradients are
    averaged before the one AdamW update."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch DeviceMesh, got "
                            f"{type(mesh).__name__}")
    loss_fn = make_loss_fn(cfg, mesh=mesh)

    def init_state(generator: torch.Generator, device=None) -> TrainState:
        params = T.init(cfg, generator, device=device)
        dev = tree_leaves(params)[0].device
        if mesh is not None:
            params = sh.shard_tree(params, sh.param_specs(params, mesh),
                                   mesh)
        return TrainState(params=params, opt=adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32, device=dev))

    def value_and_grad(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)
        loss.backward()
        return (_dp_sum(loss.detach(), mesh),
                tree_map(lambda p: p.grad, leaves))

    def grads_of(params, batch):
        if accum == 1:
            return value_and_grad(params, batch)
        first = next(iter(batch.values()))
        B = first.shape[0]
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} "
                             "microbatches")
        mb = B // accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=first.device)
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        for a in range(accum):
            micro = {k: v[a * mb:(a + 1) * mb] for k, v in batch.items()}
            loss, g = value_and_grad(params, micro)
            loss_sum = loss_sum + loss
            gsum = tree_map(torch.add, gsum, g)
        scale = 1.0 / accum
        return loss_sum * scale, tree_map(lambda g: g * scale, gsum)

    def train_step(state: TrainState, batch):
        loss, grads = grads_of(state.params,
                               _local_rows(batch, mesh, accum))
        new_params, new_opt, om = adamw_update(opt, grads, state.opt,
                                               state.params)
        metrics = {"loss": loss, **om}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return init_state, train_step


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
