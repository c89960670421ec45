"""The port's MP solve ops against the reference's, on the CPU.

* ``kernels.ref.mp_waterfill`` / ``ops.mp_waterfill`` (the plain version
  of ``csrc/mp_waterfill.cu``) against the reference's
  ``ops.mp_waterfill``, whose Pallas kernel runs in interpret mode here;
* ``kernels.ref.mp_linear`` / ``ops.mp_linear`` (the plain version of
  ``csrc/mp_linear.cu``) against the reference's ``ops.mp_linear``;
* ``core.mp.mp_linear`` (the blocked pure path, sort and bisection)
  against the reference's ``core.mp.mp_linear``.

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
    x = torch.randn(2, 8, requires_grad=True)
    w = torch.randn(8, 3)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.mp_linear(x, w, 1.0)
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
