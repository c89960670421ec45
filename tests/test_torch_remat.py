"""``cfg.remat`` in the port: the same losses and gradients, bit for bit.

Under ``remat`` the port recomputes in the backward what the reference
wraps in ``jax.checkpoint``: each scanned block on the uniform plan
(``models.transformer.forward``), each period group around each sublayer
on the periodic plan, the SSD chunk body (``models.ssm.mamba_block``), the
MoE group chunk (``models.moe.moe_block``, when there is more than one
chunk) and the loss's sequence chunk (``distributed.steps.make_loss_fn``).
Recomputing runs the same ops on the same inputs, so on the CPU every loss
and every gradient leaf must be equal bit for bit with remat on and off;
in MP mode the recomputed products write their levels again, and the
backward must not see the difference either. Params come from the port's
own ``init`` (seeded): this file holds the port against itself; the
reference's gradients are held in ``tests/test_torch_train_zoo.py``.

It also pins the MP forward count of one train step under remat on the
uniform plan (``models.transformer.mp_train_launches``, which
``chip_smoke.py``'s launch gates use): every scanned block and every loss
chunk twice (forward and recompute), the peeled prefix once; the backward
once per product.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.distributed.steps import make_loss_fn
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves, tree_map

B, S = 2, 32

CASES = {
    # name: (arch, config changes, the loss's sequence chunk)
    "uniform_dense": ("qwen3-8b", dict(num_layers=2), 1024),
    "uniform_mp": ("qwen3-8b", dict(num_layers=2, mp_mode=True), 1024),
    "periodic": ("jamba-v0.1-52b", dict(num_layers=4, moe_group_size=16,
                                         moe_group_chunk=2), 1024),
    "ssd_chunk_mp": ("mamba2-2.7b", dict(num_layers=2, ssm_chunk=8,
                                         mp_mode=True), 1024),
    "moe_group_chunk_mp": ("deepseek-moe-16b", dict(
        moe_group_size=8, moe_group_chunk=2, mp_mode=True), 1024),
    "loss_chunk": ("internvl2-2b", dict(num_layers=1), 7),
    "loss_chunk_audio": ("hubert-xlarge", dict(num_layers=1), 5),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.audio_frontend:
        return {"frames": torch.as_tensor(rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)),
            "labels": torch.as_tensor(toks)}
    b = {"tokens": torch.as_tensor(toks)}
    if cfg.vlm_patches:
        b["patches"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.vlm_patches, cfg.d_model)).astype(np.float32))
    return b


def _loss_and_grads(cfg, params, batch, seq_chunk):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = make_loss_fn(cfg, seq_chunk=seq_chunk)(leaves, batch)
    loss.backward()
    return loss.detach(), tree_leaves(tree_map(lambda p: p.grad, leaves))


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_is_bit_equal(case):
    arch, kw, seq_chunk = CASES[case]
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              remat=False, **kw)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _batch(cfg)
    if cfg.mp_mode:     # the plain MP product is slow on the CPU: one row
        batch = {k: v[:1] for k, v in batch.items()}
    loss, grads = _loss_and_grads(cfg, params, batch, seq_chunk)
    loss_r, grads_r = _loss_and_grads(dataclasses.replace(cfg, remat=True),
                                      params, batch, seq_chunk)
    assert torch.isfinite(loss) and torch.equal(loss, loss_r)
    assert len(grads) == len(grads_r)
    for i, (a, b) in enumerate(zip(grads, grads_r)):
        assert a is not None and torch.isfinite(a).all(), i
        assert torch.equal(a, b), i


def test_ssd_gradient_is_finite_through_the_masked_exp():
    """The SSD's upper triangle is masked to -inf before the exp: with
    decays that overflow exp(diff) there, no gradient is NaN."""
    cfg = dataclasses.replace(get_smoke("mamba2-2.7b"), num_layers=1,
                              compute_dtype="float32", ssm_chunk=16)
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["layers"][0]["mamba"]["a_log"] = torch.full_like(
        params["layers"][0]["mamba"]["a_log"], 6.0)   # A ~ -400 per step
    _, grads = _loss_and_grads(cfg, params, _batch(cfg), 1024)
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "deepseek-moe-16b",
                                  "internvl2-2b", "hubert-xlarge"])
def test_mp_launches_per_train_step_follow_the_plan(arch, monkeypatch):
    """One MP train step's forward and backward products, counted where
    ``ops.mp_linear`` calls its kernels, against
    ``models.transformer.mp_train_launches`` with remat off and on."""
    calls = {"forward": 0, "backward": 0}
    real_f, real_b = ops.mp_linear_kernel, ops.mp_linear_bwd_kernel

    def fwd(*a, **k):
        calls["forward"] += 1
        return real_f(*a, **k)

    def bwd(*a, **k):
        calls["backward"] += 1
        return real_b(*a, **k)

    monkeypatch.setattr(ops, "mp_linear_kernel", fwd)
    monkeypatch.setattr(ops, "mp_linear_bwd_kernel", bwd)
    for remat in (False, True):
        cfg = dataclasses.replace(get_smoke(arch), mp_mode=True,
                                  remat=remat)
        params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
        batch = {k: v[:1, :8] for k, v in _batch(cfg).items()}
        calls.update(forward=0, backward=0)
        _loss_and_grads(cfg, params, batch, 1024)
        positions = 8 + cfg.vlm_patches
        assert (calls["forward"], calls["backward"]) == \
            T.mp_train_launches(cfg, positions), (remat, calls)
