"""The port's MP solve ops against the reference's, on the CPU.

* ``kernels.ref.mp_waterfill`` / ``ops.mp_waterfill`` (the plain version
  of ``csrc/mp_waterfill.cu``) against the reference's
  ``ops.mp_waterfill``, whose Pallas kernel runs in interpret mode here;
* ``kernels.ref.mp_linear`` / ``ops.mp_linear`` (the plain version of
  ``csrc/mp_linear.cu``) against the reference's ``ops.mp_linear``;
* ``core.mp.mp_linear`` (the blocked pure path, sort and bisection)
  against the reference's ``core.mp.mp_linear``;
* the CUDA kernel's step form (``max(|t| - |mid|, 0)`` summed, plus
  ``2 d |mid|`` when ``mid < 0``), written out here in torch, against the
  reference's kernel and the plain version, where mid stays below 0, above
  0, or crosses it;
* bf16 weights: the wrapper and ``layers.linear`` take them as they come,
  with the bits of the float32 path.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are the repo's kernel gates (tests/test_kernels.py): 2e-5 for
float32, 3e-2 for bfloat16. The two sides bisect with their sums in
different orders, so a comparison right at gamma may go either way; the
bracket still holds the root within the sums' rounding.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import mp as ref_mp
from repro.kernels import ops as pallas_ops
from repro_torch.core import mp as port_mp
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.kernels.mp_kernels import (mp_linear_kernel,
                                            mp_waterfill_kernel)
from repro_torch.models import layers

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX-side numpy array and a torch tensor."""
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16)
        return a, torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    a = a.astype(np.float32)
    return a, torch.from_numpy(a)


@pytest.mark.parametrize("rows,m", [(1, 8), (7, 100), (64, 128), (33, 257),
                                    (256, 31), (300, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mp_waterfill_matches_reference(rows, m, dtype):
    rng = np.random.default_rng(rows * 1000 + m)
    L_np, L = _both(rng.standard_normal((rows, m)) * 3, dtype)
    want = np.asarray(pallas_ops.mp_waterfill(jnp.asarray(L_np), 2.0),
                      np.float32)
    for got in (ref.mp_waterfill(L, 2.0), ops.mp_waterfill(L, 2.0)):
        assert got.dtype == L.dtype and tuple(got.shape) == (rows,)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=ATOL[dtype], rtol=ATOL[dtype])


def test_mp_waterfill_leading_batch_dims():
    L_np = np.random.default_rng(0).standard_normal((3, 5, 40)).astype(
        np.float32)
    got = ops.mp_waterfill(torch.from_numpy(L_np), 1.0)
    assert tuple(got.shape) == (3, 5)
    want = np.asarray(pallas_ops.mp_waterfill(L_np, 1.0))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("B,d,O", [(1, 16, 8), (5, 64, 37), (8, 128, 128),
                                   (13, 1024, 10), (3, 256, 200)])
def test_mp_linear_matches_reference(B, d, O):
    rng = np.random.default_rng(B * 100 + O)
    x = (rng.standard_normal((B, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((d, O)) * 0.5).astype(np.float32)
    want = np.asarray(pallas_ops.mp_linear(x, w, 1.5))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for got in (ref.mp_linear(xt, wt, 1.5), ops.mp_linear(xt, wt, 1.5)):
        assert tuple(got.shape) == (B, O)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_mp_linear_leading_batch_dims():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    w = rng.standard_normal((16, 5)).astype(np.float32)
    got = ops.mp_linear(torch.from_numpy(x), torch.from_numpy(w), 1.0)
    assert tuple(got.shape) == (2, 3, 5)
    want = np.asarray(pallas_ops.mp_linear(x, w, 1.0))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_plain_mp_linear_blocks_over_outputs(monkeypatch):
    """The plain version solves O in blocks; the block size changes no
    value."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 50)).astype(np.float32))
    whole = ref.mp_linear(x, w, 2.0)
    monkeypatch.setattr(ref, "LINEAR_BLOCK", 3 * 24 * 7)   # 8 blocks of 7
    assert torch.equal(ref.mp_linear(x, w, 2.0), whole)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("block_out", [128, 16])
def test_core_mp_linear_matches_reference(exact, block_out):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 3, 24)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((24, 40)) * 0.5).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    want = np.asarray(ref_mp.mp_linear(x, w, 1.5, b=b, exact=exact,
                                       block_out=block_out))
    got = port_mp.mp_linear(torch.from_numpy(x), torch.from_numpy(w), 1.5,
                            b=torch.from_numpy(b), exact=exact,
                            block_out=block_out)
    assert tuple(got.shape) == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_mp_linear_is_forward_only():
    """Since the training slice ``ops.mp_linear`` is differentiable: its
    gradients are the plain backward's (``ref.mp_linear_bwd``) on the CPU;
    under no_grad it runs the forward alone."""
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)
    g = torch.randn(2, 3)
    ops.mp_linear(x, w, 1.0).backward(g)
    want_dx, want_dw = ref.mp_linear_bwd(x.detach(), w.detach(), g, 1.0)
    assert torch.equal(x.grad, want_dx) and torch.equal(w.grad, want_dw)
    with torch.no_grad():
        assert tuple(ops.mp_linear(x, w, 1.0).shape) == (2, 3)
    with pytest.raises(ValueError, match="does not match"):
        port_mp.mp_linear(torch.randn(2, 7), w, 1.0)


def test_mp_kernel_wrappers_route_by_device():
    """CPU tensors run the plain versions (no launch counted); other
    devices raise rather than falling back."""
    x, w, L = torch.randn(2, 8), torch.randn(8, 3), torch.randn(4, 9)
    reset_launches()
    assert torch.equal(mp_linear_kernel(x, w, 1.0), ref.mp_linear(x, w, 1.0))
    assert torch.equal(mp_waterfill_kernel(L, 1.0), ref.mp_waterfill(L, 1.0))
    assert LAUNCHES["mp_linear"] == 0 and LAUNCHES["mp_waterfill"] == 0
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        mp_linear_kernel(x.to("meta"), w.to("meta"), 1.0)
    with pytest.raises(ValueError, match="all-CUDA \\(one card\\) or all-CPU"):
        mp_waterfill_kernel(L.to("meta"), 1.0)


def _step_form_mp_linear(x, w, gamma, iters=26):
    """The CUDA kernel's arithmetic per bisection step, in torch: per branch
    h = sum_i max(|t_i| - |mid|, 0), plus 2 d |mid| when mid < 0, added
    once after the sum. Returns y and the sign of every mid (steps, 2, B,
    O)."""
    d = x.shape[1]
    a = torch.stack([x[:, None, :] + w.T[None], x[:, None, :] - w.T[None]]
                    ).abs()                                 # (2, B, O, d)
    hi = a.amax(-1)
    lo = hi - gamma
    signs = []
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        amid = mid.abs()
        h = torch.clamp_min(a - amid[..., None], 0).sum(-1)
        h = torch.where(mid < 0, h + 2.0 * d * amid, h)
        signs.append(torch.sign(mid))
        too_low = h > gamma
        lo = torch.where(too_low, mid, lo)
        hi = torch.where(too_low, hi, mid)
    z = (lo + hi) * 0.5
    return z[0] - z[1], torch.stack(signs)


# gamma per regime: below every max |t| (every mid > 0); 1.3 x the largest
# sum |t| (mids of both signs); a multiple of it at which every mid of
# these inputs stays < 0 while the roots stay above -max |t|
@pytest.mark.parametrize("d,regime,factor", [
    (512, "positive", 0.5), (512, "mixed", 1.3), (512, "negative", 4.4),
    (12288, "positive", 0.5), (12288, "mixed", 1.3),
    (12288, "negative", 4.0)])
def test_kernel_step_form_matches_reference(d, regime, factor):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((2, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((d, 3)) * 0.5).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    a = torch.stack([xt[:, None, :] + wt.T[None], xt[:, None, :] - wt.T[None]]
                    ).abs()
    gamma = factor * float(a.amax(-1).min() if regime == "positive"
                           else a.sum(-1).max())
    got, signs = _step_form_mp_linear(xt, wt, gamma)
    if regime == "positive":
        assert bool((signs > 0).all())
    elif regime == "negative":
        assert bool((signs < 0).all())
    else:
        assert bool((signs > 0).any()) and bool((signs < 0).any())
    want = np.asarray(pallas_ops.mp_linear(x, w, gamma))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), ref.mp_linear(xt, wt, gamma),
                               atol=2e-5, rtol=0)


def test_mp_linear_kernel_takes_bf16_weights():
    """On the CPU route a bf16 w gives the bits of w.float(); a float16
    or float64 w raises on either route."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 9)).astype(
        np.float32)).bfloat16()
    reset_launches()
    assert torch.equal(mp_linear_kernel(x, w, 2.0),
                       mp_linear_kernel(x, w.float(), 2.0))
    assert LAUNCHES["mp_linear"] == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_mp_linear_kernel_refuses_other_weight_dtypes(dtype):
    x, w = torch.randn(2, 8), torch.randn(8, 3).to(dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mp_linear_kernel(x, w, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mp_linear_kernel(x.to("meta"), w.to("meta"), 1.0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_mp_linear_op_widens_other_weight_dtypes(dtype):
    """``ops.mp_linear`` owns the widening of a w whose dtype the kernel
    does not read: the result is bit for bit that of ``w.float()``."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 3, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 5)).astype(
        np.float32)).to(dtype)
    assert torch.equal(ops.mp_linear(x, w, 2.0),
                       ops.mp_linear(x, w.float(), 2.0))
    got = layers.linear(x, w, mp_mode=True, mp_gamma=2.0,
                        compute_dtype=torch.float32)
    assert torch.equal(got, ops.mp_linear(x, w.float(), 2.0))


def test_mp_linear_kernel_tile_width_is_checked():
    """``tile_to`` (a tile width to run the kernel in) is 0, 2, 4 or 8 on
    either route; on the CPU route it does not change the result."""
    x, w = torch.randn(2, 8), torch.randn(8, 3)
    assert torch.equal(mp_linear_kernel(x, w, 1.0, tile_to=4),
                       mp_linear_kernel(x, w, 1.0))
    for bad in (1, 3, 16):
        with pytest.raises(ValueError, match="tile_to"):
            mp_linear_kernel(x, w, 1.0, tile_to=bad)
        with pytest.raises(ValueError, match="tile_to"):
            mp_linear_kernel(x.to("meta"), w.to("meta"), 1.0, tile_to=bad)


@pytest.mark.parametrize("compute", [torch.bfloat16, torch.float32])
def test_linear_mp_mode_takes_bf16_weights_as_they_come(compute):
    """``layers.linear`` hands a bf16 w to the kernel unwidened; the result
    is bit for bit the one of the float32 widening it made before."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 1, 48)).astype(
        np.float32)).to(compute)
    w = torch.from_numpy((rng.standard_normal((48, 20)) / 7).astype(
        np.float32)).bfloat16()
    got = layers.linear(x, w, mp_mode=True, mp_gamma=8.0,
                        compute_dtype=compute)
    want = ops.mp_linear(x.float(), w.float(), 8.0).to(compute)
    assert got.dtype == compute and torch.equal(got, want)
