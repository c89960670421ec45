"""Port vs reference: ``mp_linear``'s backward as the card runs it, on the
CPU.

On the card the training forward writes the exact water levels
(``mp_kernels.mp_linear_kernel(..., levels=True)``: the bisection, then
Newton from the bracket's left end) and the backward runs one grads pass
on them (``mp_linear_grads_kernel``). Their plain versions,
``kernels.ref.mp_linear_with_levels`` and ``ref.mp_linear_bwd_from_
levels``, which the CPU wrappers run, are held here against the
reference:

* y of the levels-writing form is ``ref.mp_linear``'s, bit for bit;
* its levels against the reference's ``core.mp.mp_exact`` of [t; -t]
  (z within 1e-6 x (1 + |z|); the count of operands above z the same
  except on a branch with an operand within that of its level);
* the grads from those levels against ``jax.vjp`` of the reference's
  ``ops.mp_linear`` (its Pallas forward in interpret mode, its jnp custom
  VJP), within 1e-5 x the tensor's max |reference|, elementwise on the
  rows of dx and the columns of dw that no near-level branch feeds (a
  branch with an operand within 1e-6 x (1 + |z|) of its level, where the
  two solves' levels differ in their bits and may take the operand on
  either side); a control with dv's sign flipped must miss that gate.

Cases, from numpy seeds: float inputs; bf16-valued inputs (multiples of
1/8, w handed to the port as bf16) whose levels land on operands (exact
ties; every sum exact, so both solves agree bit for bit); and small
operands under a large gamma, where every level lies below 0 and some
operands lie outside [z, -z].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mp as ref_mp
from repro.kernels import ops as pallas_ops
from repro_torch.kernels import ref
from repro_torch.kernels.mp_kernels import (mp_linear_bwd_kernel,
                                            mp_linear_grads_kernel,
                                            mp_linear_grads_plan,
                                            mp_linear_kernel)

LEVEL_TOL = 1e-6   # x (1 + |z|): two exact solves summing in other orders
GRAD_TOL = 1e-5    # x the tensor's max |reference|: the sums' order


def _case(kind):
    rng = np.random.default_rng({"float": 0, "ties": 1, "negative": 2}[kind])
    if kind == "float":
        x = rng.standard_normal((4, 48)).astype(np.float32)
        w = (rng.standard_normal((48, 9)) / 6).astype(np.float32)
        gamma = 8.0
    elif kind == "ties":   # bf16-valued; gamma = 3 puts the bisection's
        # midpoints off the operands, the exact levels on them
        x = (rng.integers(-16, 17, (8, 12)) / 8).astype(np.float32)
        w = (rng.integers(-16, 17, (12, 20)) / 8).astype(np.float32)
        gamma = 3.0
    else:   # 96 operands of ~0.07 under gamma 8: every z < 0, and some
        # operands lie outside [z, -z], so the masks are not all 0
        x = (0.05 * rng.standard_normal((3, 48))).astype(np.float32)
        w = (0.05 * rng.standard_normal((48, 5))).astype(np.float32)
        gamma = 8.0
    g = rng.standard_normal((x.shape[0], w.shape[1])).astype(np.float32)
    return x, w, g, gamma


def _port_w(kind, w):
    wt = torch.from_numpy(w)
    return wt.bfloat16() if kind == "ties" else wt


def _ref_levels(x, w, gamma):
    """(z (B, O, 2), k (B, O, 2)) by the reference's mp_exact."""
    u = x[:, None, :] + w.T[None]
    v = x[:, None, :] - w.T[None]
    zs, ks = [], []
    for t in (u, v):
        L = np.concatenate([t, -t], axis=-1)
        z = np.asarray(ref_mp.mp_exact(jnp.asarray(L), jnp.float32(gamma)))
        zs.append(z)
        ks.append((L > z[..., None]).sum(-1))
    return np.stack(zs, -1), np.stack(ks, -1)


def _ref_grads(x, w, g, gamma):
    _, vjp = jax.vjp(lambda a, b: pallas_ops.mp_linear(a, b, gamma),
                     jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _near(x, w, lv, z_ref):
    """(B, O, 2): branches with an operand within LEVEL_TOL of the level
    where the port's level and the reference's differ in their bits."""
    zr = torch.from_numpy(z_ref)
    near = ref.mp_linear_near_level(torch.from_numpy(x), torch.from_numpy(w),
                                    zr, LEVEL_TOL)
    return near & (lv[..., :2] != zr)


@pytest.mark.parametrize("kind", ["float", "ties", "negative"])
def test_levels_forward_gives_mp_linear_s_y(kind):
    x, w, _, gamma = _case(kind)
    xt, wt = torch.from_numpy(x), _port_w(kind, w)
    y, lv = ref.mp_linear_with_levels(xt, wt, gamma)
    assert torch.equal(y, ref.mp_linear(xt, wt, gamma))
    assert lv.shape == (x.shape[0], w.shape[1], 4)
    assert lv.dtype == torch.float32
    # the wrapper on CPU tensors runs this plain form
    y2, lv2 = mp_linear_kernel(xt, wt, gamma, levels=True)
    assert torch.equal(y2, y) and torch.equal(lv2, lv)
    assert torch.equal(mp_linear_kernel(xt, wt, gamma), y)


@pytest.mark.parametrize("kind", ["float", "ties", "negative"])
def test_levels_match_reference_mp_exact(kind):
    x, w, _, gamma = _case(kind)
    _, lv = ref.mp_linear_with_levels(torch.from_numpy(x), _port_w(kind, w),
                                      gamma)
    z_ref, k_ref = _ref_levels(x, w, gamma)
    zr = torch.from_numpy(z_ref)
    assert bool(((lv[..., :2] - zr).abs() <= LEVEL_TOL * (1 + zr.abs())).all())
    inv_k = torch.from_numpy(1.0 / np.maximum(k_ref, 1).astype(np.float32))
    off = ~ref.mp_linear_near_level(torch.from_numpy(x), torch.from_numpy(w),
                                    zr, LEVEL_TOL)
    assert bool((lv[..., 2:] == inv_k)[off].all())
    # the sort-based levels of the plain backward are the reference's too
    srt = ref.mp_linear_levels(torch.from_numpy(x), torch.from_numpy(w),
                               gamma)
    assert bool(((srt[..., :2] - zr).abs() <= LEVEL_TOL * (1 + zr.abs())).all())
    assert bool((srt[..., 2:] == inv_k)[off].all())
    if kind == "ties":     # every sum exact: the same bits, the supports too
        assert torch.equal(lv[..., :2], zr)
        assert torch.equal(lv[..., 2:], inv_k)
        assert bool((~off).any())          # the levels sit on operands
    if kind == "negative":
        assert bool((lv[..., :2] < 0).all())


@pytest.mark.parametrize("kind", ["float", "ties", "negative"])
def test_grads_from_levels_match_reference_vjp(kind):
    x, w, g, gamma = _case(kind)
    xt, wt, gt = torch.from_numpy(x), _port_w(kind, w), torch.from_numpy(g)
    _, lv = ref.mp_linear_with_levels(xt, wt, gamma)
    want_dx, want_dw = _ref_grads(x, w, g, gamma)
    tie = _near(x, w, lv, _ref_levels(x, w, gamma)[0]).any(-1)    # (B, O)
    rows, cols = ~tie.any(1), ~tie.any(0)
    assert bool(rows.any()) and bool(cols.any())
    gate = (GRAD_TOL * float(np.abs(want_dx).max()),
            GRAD_TOL * float(np.abs(want_dw).max()))

    def err(dx, dw):
        return (float(np.abs(dx.numpy()[rows] - want_dx[rows]).max()),
                float(np.abs(dw.numpy()[:, cols] - want_dw[:, cols]).max()))

    dx, dw = ref.mp_linear_bwd_from_levels(xt, wt, gt, lv)
    e = err(dx, dw)
    assert e[0] <= gate[0] and e[1] <= gate[1], (e, gate)
    # the wrapper on CPU tensors runs this plain form
    dx2, dw2 = mp_linear_grads_kernel(xt, wt, gt, lv)
    assert torch.equal(dx2, dx) and torch.equal(dw2, dw)
    # the control: dv's sign flipped misses the gate
    flip = lv.clone()
    flip[..., 3] = -flip[..., 3]
    c = err(*ref.mp_linear_bwd_from_levels(xt, wt, gt, flip))
    assert c[0] > gate[0] and c[1] > gate[1], (c, gate)
    # a caller with no levels on the CPU gets the sort-based rule
    sdx, sdw = mp_linear_bwd_kernel(xt, wt, gt, gamma)
    sdx2, sdw2 = ref.mp_linear_bwd(xt, wt, gt, gamma)
    assert torch.equal(sdx, sdx2) and torch.equal(sdw, sdw2)


@pytest.mark.parametrize("d,O,groups,per_group", [
    (4096, 152064, 66, 18),   # the head: 16 waves of 2 CTAs per SM
    (4096, 1024, 8, 1),       # k / v: one chunk per group
    (12288, 4096, 16, 2),     # down
    (4096, 12288, 48, 2),     # gate / up
    (40, 7, 1, 1)])           # one group: no partials
def test_grads_plan_covers_every_column(d, O, groups, per_group):
    """The grads pass's grid on a 132-SM card: every 128-column chunk in
    one group, no group empty."""
    plan = mp_linear_grads_plan(d, O, 132)
    chunks = -(-O // 128)
    assert (plan["groups"], plan["chunks_per_group"]) == (groups, per_group)
    assert (groups - 1) * per_group < chunks <= groups * per_group
    assert plan["tiles"] == -(-d // 64)
