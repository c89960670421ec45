"""Port vs reference: MP solvers, fake quantization and the kernel machine.

The same numpy inputs go through ``repro.core`` (JAX, CPU) and
``repro_torch.core`` (PyTorch, CPU); results are compared as numpy at
ATOL = 1e-5, the repo's float gate (tests/test_golden.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernel_machine as km_ref
from repro.core import mp as mp_ref
from repro.core import quant as quant_ref
from repro_torch.core import kernel_machine as km
from repro_torch.core import mp
from repro_torch.core import quant

ATOL = 1e-5


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("n", [1, 2, 5, 16, 61, 64])
def test_tree_sum_bitwise(n):
    h = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    got = mp.tree_sum(torch.from_numpy(h)).numpy()
    np.testing.assert_array_equal(got, np.asarray(mp_ref.tree_sum(h)))


def test_tree_sum_adjacent_pair_order():
    # ((a+b)+(c+d)) differs from the half-split ((a+c)+(b+d)) here
    h = np.array([1e8, 1.0, -1e8, 1.0], np.float32)
    want = (np.float32(1e8) + np.float32(1.0)) + (np.float32(-1e8)
                                                   + np.float32(1.0))
    assert mp.tree_sum(torch.from_numpy(h)).item() == want


@pytest.mark.parametrize("shape,gamma", [((4, 7), 0.5), ((2, 3, 16), 4.0),
                                         ((5, 33), 4.0)])
def test_solvers_match_reference(shape, gamma):
    L = (np.random.default_rng(sum(shape)).standard_normal(shape) * 2
         ).astype(np.float32)
    Lt = torch.from_numpy(L)
    _close(mp.mp_exact(Lt, gamma), mp_ref.mp_exact(L, gamma))
    _close(mp.mp_bisect(Lt, gamma), mp_ref.mp_bisect(L, gamma))
    _close(mp.mp_newton(Lt, gamma), mp_ref.mp_newton(L, gamma))
    _close(mp.mpabs(Lt, gamma), mp_ref.mpabs(L, gamma))
    _close(mp.mpabs(Lt, gamma, exact=False),
           mp_ref.mpabs(L, gamma, exact=False))
    _close(mp.mpabs_newton(Lt, gamma), mp_ref.mpabs_newton(L, gamma))


@pytest.mark.parametrize("solver", ["newton", "bisect"])
def test_mp_dot_fast_operand_order(solver):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    got = mp._mp_dot_fast(torch.from_numpy(x), torch.from_numpy(w), 4.0,
                          solver)
    _close(got, mp_ref._mp_dot_fast(x, w, 4.0, solver))
    _close(mp.mp_dot(torch.from_numpy(x), torch.from_numpy(w), 4.0),
           mp_ref.mp_dot(x, w, 4.0))


@pytest.mark.parametrize("pad,solver,exact", [(True, "newton", False),
                                              (False, "newton", False),
                                              (False, "bisect", False),
                                              (True, "newton", True)])
def test_mp_conv1d_matches_reference(pad, solver, exact):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40)).astype(np.float32)
    h = rng.standard_normal(6).astype(np.float32) * 0.3
    got = mp.mp_conv1d(torch.from_numpy(x), torch.from_numpy(h), 4.0,
                       exact=exact, solver=solver, pad=pad)
    _close(got, mp_ref.mp_conv1d(x, h, 4.0, exact=exact, solver=solver,
                                 pad=pad))


@pytest.mark.parametrize("pad,chunk_n", [(True, None), (False, 16)])
def test_mp_conv1d_bank_matches_reference(pad, chunk_n):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    H = rng.standard_normal((4, 16)).astype(np.float32) * 0.2
    got = mp.mp_conv1d_bank(torch.from_numpy(x), torch.from_numpy(H), 4.0,
                            exact=False, chunk_n=chunk_n, pad=pad)
    want = mp_ref.mp_conv1d_bank(x, H, 4.0, exact=False, chunk_n=chunk_n,
                                 pad=pad)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("bits", [4, 8])
def test_fake_quant_matches_reference(bits):
    rng = np.random.default_rng(bits)
    x = rng.standard_normal((4, 30)).astype(np.float32)
    amax = np.abs(x).max(-1, keepdims=True)
    got = quant.fake_quant(torch.from_numpy(x), bits,
                           amax=torch.from_numpy(amax))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(quant_ref.fake_quant(x, bits, amax=amax)))
    np.testing.assert_array_equal(
        quant.fake_quant(torch.from_numpy(x), bits).numpy(),
        np.asarray(quant_ref.fake_quant(jnp.asarray(x), bits)))
    assert quant.spec_for(x, bits) == quant_ref.spec_for(x, bits)


def test_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    np.testing.assert_array_equal(torch.round(x).numpy(),
                                  np.asarray(jnp.round(x.numpy())))


@pytest.mark.parametrize("exact", [False, True])
def test_kernel_machine_matches_reference(exact):
    rng = np.random.default_rng(11)
    P, C = 9, 5
    leaves = [rng.uniform(-0.1, 0.5, (P, C)).astype(np.float32),
              rng.uniform(-0.1, 0.5, (P, C)).astype(np.float32),
              rng.standard_normal(C).astype(np.float32) * 0.1,
              rng.standard_normal(C).astype(np.float32) * 0.1,
              np.float32(np.log(8.0))]
    K = rng.standard_normal((4, P)).astype(np.float32) * 2
    ref = km_ref.MPKernelMachineParams(*(jnp.asarray(a) for a in leaves))
    port = km.MPKernelMachine(km.MPKernelMachineParams(
        *(torch.as_tensor(a) for a in leaves)))
    # the module's weights are parameters (trainable): detach its output
    _close(port(torch.from_numpy(K), exact=exact).detach(),
           km_ref.forward(ref, jnp.asarray(K), exact=exact))


def test_init_params_seeded_shapes():
    a = km.init_params(torch.Generator().manual_seed(0), 30, 10)
    b = km.init_params(torch.Generator().manual_seed(0), 30, 10)
    assert a.w_pos.shape == (30, 10) and a.b_neg.shape == (10,)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert 0 <= float(a.w_pos.min()) and float(a.w_pos.max()) < 0.5
    assert torch.isclose(torch.exp(a.log_gamma1), torch.tensor(8.0))
