"""Port vs reference: training the zoo's families, on the CPU.

The reference's params (``repro.models.transformer.init`` at a smoke
config cut to the fewest layers its plan allows) cross into the port
through ``bridge``; both packages take the same numpy batch, built as each
launcher builds it (tokens; a VLM's patches before its tokens; an audio
encoder's frames with a label per frame), and the port's autograd of
``make_loss_fn`` is held against ``jax.grad`` of the reference's, leaf by
leaf:

* float, f32 compute: deepseek-moe-16b (the peeled dense layer, shared
  experts, and drops: groups of 8 tokens at capacity 2, in 2 chunks),
  mixtral-8x22b (top-2, sliding window), mamba2-2.7b (the SSD scan's
  backward), jamba-v0.1-52b (one period of the hybrid plan: attention,
  Mamba, MoE), internvl2-2b (the patch offset), hubert-xlarge (frame
  labels, no shift);
* MP mode and the step with ``accum``: tests/test_torch_train_zoo_mp.py.

Both routers run in float32, as in tests/test_torch_archs.py: the
reference's router is a bf16 product whatever the compute dtype, and the
~1e-6 by which the two packages' f32 paths differ would now and then move
a router logit by a bf16 step, another expert.

Tolerances, those of tests/test_torch_train_lm.py: each gradient leaf
within ``TOL`` = 1e-5 x its max |reference| in float, ``MP_GRAD_TOL`` =
1e-2 in MP mode. One exception, measured: the SSD's ``a_log`` and
``dt_bias`` gradients are sums over every position that cancel to a few
1e-4, and at jamba's 4 sublayers the reference's own gradients move by
up to 2.4e-5 of that max between two chunkings of the same scan
(``ssm_chunk`` 16 and 8); so those two leaves of each Mamba mixer
(``SSD_SUMS``) are held within the larger of ``TOL`` and twice the
reference's own gap between those chunkings, and every other leaf within
``TOL``. The loss within 1e-5 x (1 + |reference|) (1e-4 in MP mode).

The MP cases and the step live in tests/test_torch_train_zoo_mp.py, which
imports this file's helpers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.distributed import steps as ref_steps
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.distributed import steps
from repro_torch.launch.train import make_batch, step_config
from repro_torch.models import layers as PL
from repro_torch.optim import adamw

TOL = 1e-5
SSD_SUMS = ("a_log", "dt_bias")   # the leaves the chunking floor covers
B, S = 2, 16

FLOAT = {
    # arch: config changes (depth: the fewest layers the plan allows)
    "deepseek-moe-16b": dict(num_layers=2, moe_group_size=8,
                             moe_group_chunk=2),
    "mixtral-8x22b": dict(num_layers=1),
    "mamba2-2.7b": dict(num_layers=1),
    "jamba-v0.1-52b": dict(num_layers=4),
    "internvl2-2b": dict(num_layers=1),
    "hubert-xlarge": dict(num_layers=1),
}


@pytest.fixture(autouse=True)
def f32_router(monkeypatch):
    """Both packages' router in float32 (see the module's docstring), one
    torch thread (the plain MP product is thousands of tiny ops)."""
    monkeypatch.setitem(RL.linear.__kwdefaults__, "compute_dtype",
                        jnp.float32)
    monkeypatch.setitem(PL.linear.__kwdefaults__, "compute_dtype",
                        torch.float32)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_get_smoke(arch), **kw),
            dataclasses.replace(get_smoke(arch), **kw))


def _params(rc, pc):
    with jax.threefry_partitionable(False):
        r = jax.tree.map(np.asarray, jax.jit(
            lambda k: RT.init(rc, k))(jax.random.PRNGKey(0)))
    return r, bridge.arch_params_from_numpy(r, pc, device="cpu")


def _batch(cfg, batch: int, seq: int, seed: int = 1) -> dict:
    """The launcher's batch (``launch.train.make_batch``) of ``batch``
    rows of ``seq`` tokens (a VLM's patches take their share of seq)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return make_batch(cfg, toks, rng)


def _grads(pc, p_params, batch):
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                            p_params)
    loss = steps.make_loss_fn(pc)(leaves, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), bridge.arch_params_to_numpy(
        adamw.tree_map(lambda p: p.grad, leaves))


def _ref_grads(rc, r_params, batch):
    loss, g = jax.jit(jax.value_and_grad(ref_steps.make_loss_fn(rc)))(
        jax.tree.map(jnp.asarray, r_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def _leaf_gaps(got, want) -> list:
    """Per leaf, max |got - want| over the leaf's max |want|."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    out = []
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        out.append(float(np.max(np.abs(a - b)) / np.max(np.abs(b))))
    return out


@pytest.mark.parametrize("arch", sorted(FLOAT))
def test_float_gradients_match_reference(arch):
    rc, pc = _configs(arch, **FLOAT[arch])
    rc, pc = step_config(rc, S), step_config(pc, S)
    r_params, p_params = _params(rc, pc)
    batch = _batch(pc, B, S)
    loss, got = _grads(pc, p_params, batch)
    want_loss, want = _ref_grads(rc, r_params, batch)
    assert np.isfinite(loss)
    assert abs(loss - want_loss) <= TOL * (1 + abs(want_loss))
    gaps = _leaf_gaps(got, want)
    bounds = [TOL] * len(gaps)
    if pc.ssm_state:   # the reference's own f32 floor, on the SSD's sums
        other = _ref_grads(dataclasses.replace(rc, ssm_chunk=8), r_params,
                           batch)[1]
        paths = [path[-1].key for path, _ in
                 jax.tree_util.tree_flatten_with_path(want)[0]]
        bounds = [max(TOL, 2 * f) if k in SSD_SUMS else TOL
                  for k, f in zip(paths, _leaf_gaps(other, want))]
    assert all(g <= b for g, b in zip(gaps, bounds)), (gaps, bounds)
    if arch == "deepseek-moe-16b":   # the capacity path dropped some
        no_drop = dataclasses.replace(pc, moe_capacity_factor=None)
        assert abs(_grads(no_drop, p_params, batch)[0] - loss) > 1e-4


def test_elastic_trains_token_families_and_refuses_frames_and_patches(
        tmp_path):
    """``launch.elastic`` on one gloo rank: the MoE family trains through
    both phases (a save on one mesh, a restore on the other); the audio
    encoder and the VLM, whose embedding needs frames or patches, raise
    ``ValueError`` before any step."""
    from repro_torch.launch import elastic
    from torch_mesh_ranks import one_rank_group
    with one_rank_group(tmp_path):
        l1, l2 = elastic.main(["--arch", "deepseek-moe-16b", "--ckpt-dir",
                               str(tmp_path / "moe"), "--steps-per-phase",
                               "2", "--device", "cpu"])
        assert len(l1) == len(l2) == 2 and np.all(np.isfinite(l1 + l2))
        for arch, what in (("hubert-xlarge", "frames"),
                           ("internvl2-2b", "patches")):
            with pytest.raises(ValueError, match=what):
                elastic.main(["--arch", arch, "--ckpt-dir",
                              str(tmp_path / arch), "--device", "cpu"])
