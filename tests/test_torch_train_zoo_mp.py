"""Port vs reference: MP-mode training of the zoo, and a step with
``accum``, on the CPU (the helpers, configs and router fixture are
tests/test_torch_train_zoo.py's).

* MP mode, mamba2-2.7b and deepseek-moe-16b (its dense layer and one MoE
  layer, groups of 4 tokens: the capacity path drops): every product the
  reference sends through ``L.linear(..., mp_mode=...)`` through
  ``ops.mp_linear`` (its plain version and the reference's sort-based VJP
  on the CPU) against the reference's Pallas ``mp_linear`` in interpret
  mode and its custom VJP, each gradient leaf within ``MP_GRAD_TOL`` =
  1e-2 x its max |reference| (tests/test_torch_train_lm.py's); the
  control, the float product's gradients, must miss that gate;
* one ``make_train_step`` with ``accum = 2`` on a VLM batch against the
  reference's step: loss and grad norm within ``STEP_TOL`` = 1e-4 x (1 +
  max), the first moments (0.1 x the clipped gradient) within 1e-5 x each
  leaf's max, the params within 1e-5 in each leaf's L2 norm (Adam's first
  step moves an entry by lr x g / (|g| + eps), so an entry whose gradient
  is ~eps moves with g's last bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro_torch import bridge
from repro_torch.distributed import steps
from repro_torch.optim import adamw
from test_torch_train_zoo import (TOL, _batch, _configs, _grads,  # noqa: F401
                                  _leaf_gaps, _params, _ref_grads,
                                  f32_router)

STEP_TOL = 1e-4
MP_GRAD_TOL = 1e-2
MP = {"mamba2-2.7b": dict(num_layers=1),
      "deepseek-moe-16b": dict(num_layers=2, moe_group_size=4)}


@pytest.mark.parametrize("arch", sorted(MP))
def test_mp_gradients_match_reference(arch):
    rc, pc = _configs(arch, mp_mode=True, **MP[arch])
    r_params, p_params = _params(rc, pc)
    batch = _batch(pc, 1, 8)
    loss, got = _grads(pc, p_params, batch)
    want_loss, want = _ref_grads(rc, r_params, batch)
    assert abs(loss - want_loss) <= STEP_TOL * (1 + abs(want_loss))
    gaps = _leaf_gaps(got, want)
    assert max(gaps) <= MP_GRAD_TOL, gaps
    control = _grads(dataclasses.replace(pc, mp_mode=False), p_params,
                     batch)[1]
    assert max(_leaf_gaps(control, want)) > MP_GRAD_TOL


def test_vlm_train_step_with_accum_matches_reference():
    """``make_train_step(accum=2)`` on a VLM batch of 4 rows (8 patches, 8
    tokens): each microbatch splits tokens and patches alike."""
    rc, pc = _configs("internvl2-2b", num_layers=1)
    r_params, p_params = _params(rc, pc)
    batch = _batch(pc, 4, 16)
    assert batch["tokens"].shape == (4, 8)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
    _, r_step = ref_steps.make_train_step(rc, ref_adamw.AdamWConfig(**kw),
                                          accum=2)
    _, p_step = steps.make_train_step(pc, adamw.AdamWConfig(**kw), accum=2)
    rp = jax.tree.map(jnp.asarray, r_params)
    r_new, rm = jax.jit(r_step)(
        ref_steps.TrainState(rp, ref_adamw.adamw_init(rp),
                             jnp.zeros((), jnp.int32)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    p_new, pm = p_step(
        steps.TrainState(p_params, adamw.adamw_init(p_params),
                         torch.zeros((), dtype=torch.int32)),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        want = float(rm[k])
        assert abs(float(pm[k]) - want) <= STEP_TOL * (1 + abs(want)), k
    mu = bridge.arch_params_to_numpy(p_new.opt.mu)
    assert max(_leaf_gaps(mu, jax.tree.map(np.asarray, r_new.opt.mu))) \
        <= TOL
    got = bridge.arch_params_to_numpy(p_new.params)
    for a, b in zip(jax.tree.leaves(got),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 r_new.params))):
        assert np.linalg.norm(a - b) <= TOL * np.linalg.norm(b)
