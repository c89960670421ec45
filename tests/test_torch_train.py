"""Port vs reference: MP-aware training of the kernel machine.

The same numpy inputs go through ``repro.core`` (JAX, CPU) and
``repro_torch.core`` (PyTorch, CPU): the gradients of ``mp_exact`` and
``fake_quant``, of the training loss in all five classifier leaves, then
``trainer.train`` and ``InFilterPipeline.fit`` end to end from the same
initial params (both packages' ``init_params`` are patched to return
them; the reference draws its own from ``jax.random`` otherwise).

Tolerances:
  * ``mp_exact`` and ``fake_quant`` gradients: exact up to float32
    rounding (1e-6), on inputs with and without ties: the support masks
    agree wherever no operand lies within rounding of z, and the tie cases
    use small integers, where both solves are exact;
  * loss gradients: 1e-5 x (1 + max |reference|): the two forward solves
    sum in other orders;
  * short training runs (20 SGD steps on blobs): losses and params
    within 1e-4 x (1 + max |reference|): the reference's step is jitted
    and XLA may fuse its sums in another order, a difference that
    momentum carries from step to step; accuracies equal;
  * ``fit`` (30 steps, 10 classes): mu and sigma within 1e-4, the first 5
    losses within 1e-5, all 30 within 1e-3 and the params within 1e-2 x
    (1 + max |reference|); the held-out decisions (argmax) equal. At the
    same params the two gradients agree to 1e-9 (the weights) and 4e-7
    (log_gamma1, a sum of -g / k over every solve, in another order);
    from step 5 on, SGD at lr 0.5 with momentum 0.9 grows that into
    ~6e-3 on the weights by step 30.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import esc10_mp as ref_esc
from repro.core import kernel_machine as km_ref
from repro.core import mp as mp_ref
from repro.core import pipeline as pipe_ref
from repro.core import quant as quant_ref
from repro.core import trainer as trainer_ref
from repro.core.filterbank import FilterBank as RefFilterBank
from repro_torch.configs import esc10_mp
from repro_torch.core import kernel_machine as km
from repro_torch.core import mp
from repro_torch.core import quant
from repro_torch.core import trainer
from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.data.acoustic import make_esc10_like

GRAD_TOL = 1e-5
TRAIN_TOL = 1e-4
FIT_LOSS_TOL, FIT_PARAM_TOL = 1e-3, 1e-2


def _close(got, want, tol, scale=True):
    want = np.asarray(want)
    bound = tol * ((1.0 + float(np.max(np.abs(want)))) if scale else 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=bound, rtol=0)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


# -- mp_exact and fake_quant gradients ---------------------------------------


def _mp_cases():
    rng = np.random.default_rng(0)
    return {
        "random": (rng.standard_normal((4, 7, 9)).astype(np.float32) * 2,
                   np.float32(3.0)),
        # small integers: duplicated operands, and levels that land on an
        # operand (ties at the support's edge)
        "ties": (rng.integers(-3, 4, (6, 12)).astype(np.float32),
                 np.float32(2.0)),
        "one_operand_level": (np.array([[3.0, 1.0, 1.0, 0.0]], np.float32),
                              np.float32(2.0)),
        "negative_level": (rng.standard_normal((3, 5)).astype(np.float32)
                           * 0.1, np.float32(8.0)),
    }


@pytest.mark.parametrize("case", list(_mp_cases()))
def test_mp_exact_grad_matches_reference(case):
    L, gamma = _mp_cases()[case]
    g = np.random.default_rng(1).standard_normal(L.shape[:-1]).astype(
        np.float32)
    z_ref, vjp = jax.vjp(mp_ref.mp_exact, jnp.asarray(L), jnp.asarray(gamma))
    dL_ref, dgamma_ref = vjp(jnp.asarray(g))
    Lt = torch.from_numpy(L).requires_grad_()
    gt = torch.tensor(gamma).requires_grad_()
    z = mp.mp_exact(Lt, gt)
    z.backward(torch.from_numpy(g))
    _close(_np(z), z_ref, 1e-6)
    _close(_np(Lt.grad), dL_ref, 1e-6)
    _close(_np(gt.grad), dgamma_ref, 1e-6)


def test_mp_exact_grad_reduces_to_gamma_shape():
    """A per-row gamma (..., ) gets its own gradient, -g / k per row."""
    L = np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32)
    gam = torch.tensor([1.0, 2.0, 4.0], requires_grad=True)
    Lt = torch.from_numpy(L)
    z = mp.mp_exact(Lt, gam)
    z.sum().backward()
    k = (Lt > z.detach()[:, None]).sum(-1).float()
    torch.testing.assert_close(gam.grad, -1.0 / k)


@pytest.mark.parametrize("amax", [None, 1.0])
def test_fake_quant_grad_matches_reference(amax):
    """Inside the range (straight through), outside it (zero) and at its
    edge, where a code lands exactly on qmax (half: the clip's max and min
    split their gradient at ties, in jnp as in torch)."""
    x = np.array([0.3, -1.0, 1.0, 0.999, 2.0, -2.0, -0.5, 0.0], np.float32)
    c = np.arange(1, 9, dtype=np.float32)
    f_ref = lambda v: jnp.sum(quant_ref.fake_quant(v, 8, amax=amax) * c)
    want = jax.grad(f_ref)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (quant.fake_quant(xt, 8, amax=amax) * torch.from_numpy(c)).sum(
        ).backward()
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(want))
    np.testing.assert_array_equal(
        _np(quant.fake_quant(torch.from_numpy(x), 8, amax=amax)),
        np.asarray(quant_ref.fake_quant(jnp.asarray(x), 8, amax=amax)))


# -- the kernel machine's loss ------------------------------------------------


def _params_np(P, C, seed, gamma1=8.0):
    rng = np.random.default_rng(seed)
    return km_ref.MPKernelMachineParams(
        w_pos=(rng.random((P, C)) * 0.5).astype(np.float32),
        w_neg=(rng.random((P, C)) * 0.5).astype(np.float32),
        b_pos=(rng.standard_normal(C) * 0.1).astype(np.float32),
        b_neg=(rng.standard_normal(C) * 0.1).astype(np.float32),
        log_gamma1=np.float32(np.log(gamma1)))


@pytest.mark.parametrize("quant_bits", [None, 8])
def test_loss_grads_match_reference(quant_bits):
    """jax.grad of the reference's loss against the port's autograd in
    all five leaves, at an annealed gamma_scale."""
    P, C, M = 8, 3, 32
    rng = np.random.default_rng(4)
    K = rng.standard_normal((M, P)).astype(np.float32)
    y = rng.integers(0, C, M)
    y1h = np.eye(C, dtype=np.float32)[y]
    p_np = _params_np(P, C, 5)
    cfg_r = trainer_ref.TrainConfig(quant_bits=quant_bits)
    cfg_t = trainer.TrainConfig(quant_bits=quant_bits)
    loss_r, g_r = jax.value_and_grad(trainer_ref.loss_fn)(
        km_ref.MPKernelMachineParams(*map(jnp.asarray, p_np)),
        jnp.asarray(K), jnp.asarray(y1h), 2.5, cfg_r)
    params = km.MPKernelMachineParams(
        *(torch.tensor(np.asarray(a)).requires_grad_() for a in p_np))
    loss = trainer.loss_fn(params, torch.from_numpy(K),
                           torch.from_numpy(y1h), 2.5, cfg_t)
    grads = torch.autograd.grad(loss, params)
    _close(loss.item(), loss_r, GRAD_TOL)
    for name, got, want in zip(km.MPKernelMachineParams._fields, grads, g_r):
        assert got.shape == tuple(np.shape(want)), name
        _close(_np(got), want, GRAD_TOL)


def test_kernel_machine_module_trains_its_parameters():
    p_np = _params_np(6, 3, 7)
    mod = km.MPKernelMachine(km.MPKernelMachineParams(
        *(torch.tensor(np.asarray(a)) for a in p_np)))
    names = [n for n, _ in mod.named_parameters()]
    assert names == list(km.MPKernelMachineParams._fields)
    K = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (5, 6)).astype(np.float32))
    mod(K, gamma_scale=2.0).sum().backward()
    assert all(p.grad is not None for p in mod.parameters())


# -- training end to end ---------------------------------------------------------


def _blobs(n=40, P=8, C=3, seed=0):
    """tests/test_kernel_machine.py's blobs."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((C, P)) * 2.0
    X, y = [], []
    for c in range(C):
        X.append(centers[c] + 0.5 * rng.standard_normal((n, P)))
        y.extend([c] * n)
    X = np.concatenate(X).astype(np.float32)
    y = np.asarray(y)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def _same_start(monkeypatch, p_np):
    """Both packages' init_params return ``p_np``."""
    monkeypatch.setattr(km_ref, "init_params", lambda key, P, C, gamma1=8.0:
                        km_ref.MPKernelMachineParams(*map(jnp.asarray, p_np)))
    monkeypatch.setattr(km, "init_params",
                        lambda gen, P, C, gamma1=8.0, device=None:
                        km.MPKernelMachineParams(*(
                            torch.tensor(np.asarray(a)).to(device)
                            for a in p_np)))


def _check_params(got: km.MPKernelMachineParams, want,
                  tol=TRAIN_TOL) -> None:
    for name, a, b in zip(km.MPKernelMachineParams._fields, got, want):
        _close(_np(a), b, tol)


@pytest.mark.parametrize("quant_bits", [None, 8])
def test_train_matches_reference(monkeypatch, quant_bits):
    K, y = _blobs()
    p0 = _params_np(8, 3, 9)
    _same_start(monkeypatch, p0)
    kw = dict(num_steps=20, lr=0.5, batch_size=64, gamma_anneal_start=4.0,
              gamma_anneal_steps=10, quant_bits=quant_bits, seed=3)
    want, losses_r = trainer_ref.train(jnp.asarray(K), jnp.asarray(y), 3,
                                       trainer_ref.TrainConfig(**kw))
    got, losses = trainer.train(K, y, 3, trainer.TrainConfig(**kw),
                                device="cpu")
    _close(losses, losses_r, TRAIN_TOL)
    _check_params(got, want)
    assert trainer.evaluate(got, K, y, quant_bits) == \
        trainer_ref.evaluate(want, jnp.asarray(K), jnp.asarray(y),
                             quant_bits)


def test_fit_matches_reference(monkeypatch):
    """``fit`` at the smoke bank, 3 clips per class: features, mu, sigma,
    the loss trace, the trained params and the held-out accuracy."""
    ds = make_esc10_like(per_class_train=3, per_class_test=2, fs=4000.0,
                         seconds=0.5, seed=0)
    p0 = _params_np(esc10_mp.FILTERBANK_SMOKE.num_filters, 10, 11)
    _same_start(monkeypatch, p0)
    tc = dict(num_steps=30, lr=0.5, gamma_anneal_start=4.0,
              gamma_anneal_steps=10)
    want, losses_r = pipe_ref.InFilterPipeline.fit(
        ref_esc.FILTERBANK_SMOKE, ds.x_train, ds.y_train, 10,
        trainer_ref.TrainConfig(**tc))
    got, losses = InFilterPipeline.fit(
        esc10_mp.FILTERBANK_SMOKE, ds.x_train, ds.y_train, 10,
        trainer.TrainConfig(**tc), device="cpu")
    _close(_np(got.mu), want.mu, TRAIN_TOL)
    _close(_np(got.sigma), want.sigma, TRAIN_TOL)
    _close(losses[:5], losses_r[:5], GRAD_TOL)
    _close(losses, losses_r, FIT_LOSS_TOL)
    _check_params(got.clf.params, want.clf, FIT_PARAM_TOL)
    p_test = got.apply(ds.x_test)
    p_ref = jax.jit(lambda x: want.apply(x))(jnp.asarray(ds.x_test))
    assert np.array_equal(_np(p_test.argmax(-1)),
                          np.asarray(jnp.argmax(p_ref, -1)))


def test_fit_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InFilterPipeline.fit(esc10_mp.FILTERBANK_SMOKE,
                             np.zeros((2, 400), np.float32), [0, 1], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train(np.zeros((2, 3), np.float32), [0, 1], 2)


def test_fit_deploys_fixed():
    """A trained pipeline calibrates its int twin and runs a fixed apply
    as it comes, bit for bit the reference's twin of the same trained
    params and statistics."""
    ds = make_esc10_like(per_class_train=2, per_class_test=1, fs=4000.0,
                         seconds=0.5, seed=1)
    pipe, _ = InFilterPipeline.fit(
        esc10_mp.FILTERBANK_SMOKE, ds.x_train, ds.y_train, 10,
        trainer.TrainConfig(num_steps=30), device="cpu")
    cfg = esc10_mp.FILTERBANK_SMOKE._replace(numerics="fixed")
    fixed = InFilterPipeline(cfg, pipe.bp_taps, pipe.lp_taps, pipe.mu,
                             pipe.sigma, pipe.clf.params, device="cpu")
    fixed.calibrate_fixed(ds.x_train)
    p = fixed.apply(ds.x_test)
    assert p.shape == (10, 10) and bool(torch.isfinite(p).all())
    assert float(p.abs().max()) <= 1.0
    ref = pipe_ref.InFilterPipeline.from_filterbank(
        RefFilterBank(ref_esc.FILTERBANK_SMOKE._replace(numerics="fixed")),
        km_ref.MPKernelMachineParams(*(jnp.asarray(_np(t))
                                       for t in pipe.clf.params)),
        jnp.asarray(_np(pipe.mu)), jnp.asarray(_np(pipe.sigma)))
    ref.calibrate_fixed(jnp.asarray(ds.x_train))
    np.testing.assert_array_equal(
        _np(p), np.asarray(jax.jit(lambda x: ref.apply(x))(
            jnp.asarray(ds.x_test))))


# -- the paper's behaviour, in the port alone (tests/test_kernel_machine.py) --


def test_training_reaches_high_accuracy_on_blobs():
    K, y = _blobs()
    cfg = trainer.TrainConfig(num_steps=250, lr=0.5, batch_size=64,
                              gamma_anneal_start=4.0, gamma_anneal_steps=100)
    params, losses = trainer.train(K, y, 3, cfg, device="cpu")
    assert trainer.evaluate(params, K, y) > 0.9
    assert losses[-1] < losses[0]


def test_quantization_aware_training_8bit():
    K, y = _blobs(seed=1)
    cfg = trainer.TrainConfig(num_steps=250, lr=0.5, batch_size=64,
                              quant_bits=8)
    params, _ = trainer.train(K, y, 3, cfg, device="cpu")
    assert trainer.evaluate(params, K, y, quant_bits=8) > 0.85


def test_gamma_annealing_does_not_hurt():
    K, y = _blobs(seed=2)
    accs = {}
    for start in (1.0, 4.0):
        cfg = trainer.TrainConfig(num_steps=150, lr=0.5,
                                  gamma_anneal_start=start,
                                  gamma_anneal_steps=75, seed=3)
        p, _ = trainer.train(K, y, 3, cfg, device="cpu")
        accs[start] = trainer.evaluate(p, K, y)
    assert accs[4.0] >= accs[1.0] - 0.05, accs


def test_esc10_train_config_is_the_reference_s():
    assert dataclasses.asdict(esc10_mp.TRAIN) == dataclasses.asdict(
        ref_esc.TRAIN)
