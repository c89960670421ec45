"""Port vs reference: the MP-mode LM train step, on the CPU.

Inputs are drawn with numpy from a seed (params from the reference's
``init`` at the qwen3-8b smoke width, 1 layer, 5 positions, crossing
into the port through ``bridge``) and go through both packages:

* the plain ``mp_linear`` backward (``kernels.ref.mp_linear_bwd``, what
  ``ops.mp_linear``'s autograd runs on CPU tensors) against ``jax.vjp``
  of the reference's ``ops.mp_linear`` (its Pallas forward in interpret
  mode, its jnp custom VJP);
* ``adamw_update`` (clip included), ``TokenStream``, ``chunked_attention``
  (output and gradients), ``forward`` and the chunked loss with
  ``mp_mode`` off and on, and one ``make_train_step`` step (accum 1 and
  2);
* ``launch.train.main``, resumed from a checkpoint.

Tolerances, each as a multiple of (1 + max |reference|) unless said:
  * mp_linear backward: 1e-5, the sums' order; the masks come from the
    exact levels on both sides (ties: integer operands, where both are
    exact). Controls that must miss: dv's sign flipped, and masks taken at
    the forward's bisection midpoint instead of the exact level (on the
    tie case);
  * adamw_update, chunked_attention (float32), forward and loss (float32
    compute): 1e-5; bf16 attention 2e-2 (p and ds rounded to bf16 on both
    sides, in other orders);
  * the train step (float32 compute, MP mode): loss and grad norm 1e-4,
    the decode slice's MP gate (tests/test_torch_transformer.py: the two
    forward solves sum in other orders, and an operand within rounding of
    its level flips a mask of the backward);
  * the gradients, leaf by leaf, as a multiple of that leaf's max
    |reference|: 1e-5 with mp_mode off; 1e-2 with it on (measured up to
    1.4e-3 here, 4.7e-3 at 2 layers and 8 positions, in the smallest
    leaves, the FFN's input projections, where one flipped mask weighs
    most against the leaf's scale);
  * both moments, leaf by leaf: within 1e-2 x the leaf's max |reference|
    (mu is 0.1 g, nu 0.05 g^2 after one step) and never looser than the
    1e-4 x (1 + max) they were held to before;
  * the params after the step, element by element: 1e-5 plus what the
    measured gradient difference can move AdamW's first update, lr *
    g / (|g| + eps): at most lr * |g - g_ref| / (min(|g|, |g_ref|) +
    eps), and never more than the 2 lr between its two directions (the
    optimizer's eps is 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.data.tokens import TokenStream as RefTokenStream
from repro.distributed import steps as ref_steps
from repro.kernels import ops as pallas_ops
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.optim import adamw as ref_adamw
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.distributed import steps
from repro_torch.distributed.monitor import StragglerMonitor
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_launch
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from torch_mesh_ranks import one_rank_group

TOL = 1e-5
STEP_TOL = 1e-4
MP_GRAD_TOL = 1e-2   # x a leaf's max |reference|, mp_mode on
B, S = 2, 5


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    bound = tol * (1.0 + float(np.max(np.abs(want))))
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=bound, rtol=0)


def _gap(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / (1.0 + np.max(np.abs(want))))


# -- mp_linear's backward -------------------------------------------------------


def _lin_case(kind):
    rng = np.random.default_rng(0 if kind == "random" else 1)
    if kind == "random":
        x = rng.standard_normal((3, 40)).astype(np.float32)
        w = (rng.standard_normal((40, 7)) / 6).astype(np.float32)
        gamma = 8.0
    else:   # small integers: levels land on operands, and gamma = 3 puts
        # the bisection's midpoints off the integers (the bracket's width
        # is 3 / 2^n), so at a tie the midpoint falls on either side
        x = rng.integers(-3, 4, (16, 12)).astype(np.float32)
        w = rng.integers(-3, 4, (12, 32)).astype(np.float32)
        gamma = 3.0
    g = rng.standard_normal((x.shape[0], w.shape[1])).astype(np.float32)
    return x, w, g, gamma


def _ref_grads(x, w, g, gamma):
    _, vjp = jax.vjp(lambda a, b: pallas_ops.mp_linear(a, b, gamma),
                     jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _bisect_masks(t, gamma):
    """The control's masks: at the forward's bisection midpoint."""
    z = ref._mpabs_bisect(t, gamma, ref.DEFAULT_ITERS)[..., None]
    s_pos, s_neg = (t > z).float(), (-t > z).float()
    return (s_pos - s_neg) / torch.clamp_min((s_pos + s_neg).sum(
        -1, keepdim=True), 1.0)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_mp_linear_backward_matches_reference(kind):
    x, w, g, gamma = _lin_case(kind)
    want_dx, want_dw = _ref_grads(x, w, g, gamma)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ops.mp_linear(xt, wt, gamma).backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), want_dx)
    _close(wt.grad.numpy(), want_dw)
    # controls: a wrong rule misses the gate
    xb, wb = torch.from_numpy(x)[:, None, :], torch.from_numpy(w).T[None]
    gy = torch.from_numpy(g)[..., None]
    du = ref.mp_exact_masks(xb + wb, gamma)
    dv = ref.mp_exact_masks(xb - wb, gamma)
    assert _gap((gy * (du + dv)).sum(1), want_dx) > TOL     # dv's sign
    if kind == "ties":
        bu, bv = _bisect_masks(xb + wb, gamma), _bisect_masks(xb - wb, gamma)
        assert _gap((gy * (bu + bv)).sum(0).T, want_dw) > TOL


def test_plain_backward_blocks_over_rows_and_outputs(monkeypatch):
    x, w, g, gamma = _lin_case("random")
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    dx, dw = ref.mp_linear_bwd(xt, wt, gt, gamma)
    monkeypatch.setattr(ref, "LINEAR_BLOCK", 40 * 2)   # 2 rows, 1 column
    dx2, dw2 = ref.mp_linear_bwd(xt, wt, gt, gamma)
    torch.testing.assert_close(dx2, dx, atol=1e-6, rtol=0)
    assert torch.equal(dw2, dw)


def test_mp_linear_bf16_weight_gets_a_bf16_gradient():
    x, w, g, gamma = _lin_case("random")
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    ops.mp_linear(torch.from_numpy(x), wt, gamma).backward(
        torch.from_numpy(g))
    assert wt.grad.dtype == torch.bfloat16
    _, want = ref.mp_linear_bwd(torch.from_numpy(x), wt.detach().float(),
                                torch.from_numpy(g), gamma)
    assert torch.equal(wt.grad, want.bfloat16())


# -- AdamW, tokens, the monitor ------------------------------------------------------


def test_adamw_matches_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=1.0)
    rcfg, pcfg = (ref_adamw.AdamWConfig(**cfg_kw),
                  adamw.AdamWConfig(**cfg_kw))
    r_params = jax.tree.map(jnp.asarray, tree)
    r_state = ref_adamw.adamw_init(r_params)
    p_params = adamw.tree_map(torch.from_numpy, tree)
    p_state = adamw.adamw_init(p_params)
    for step in range(4):
        # gradients of norm ~3: the clip scales every step
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.8)
                         .astype(np.float32), tree)
        r_params, r_state, rm = ref_adamw.adamw_update(
            rcfg, jax.tree.map(jnp.asarray, g), r_state, r_params)
        p_params, p_state, pm = adamw.adamw_update(
            pcfg, adamw.tree_map(torch.from_numpy, g), p_state, p_params)
        assert float(pm["grad_norm"]) > 1.0
        _close(float(pm["grad_norm"]), rm["grad_norm"])
        _close(float(pm["lr"]), rm["lr"])
        for got, want in zip(adamw.tree_leaves((p_params, p_state.mu,
                                                p_state.nu)),
                             jax.tree.leaves((r_params, r_state.mu,
                                              r_state.nu))):
            _close(got.numpy(), want)
        assert int(p_state.count) == int(r_state.count) == step + 1
    for s in (0, 1, 3, 6, 9):
        _close(float(adamw.cosine_schedule(pcfg, torch.tensor(s))),
               ref_adamw.cosine_schedule(rcfg, jnp.asarray(s)))


def test_token_stream_is_the_reference_s():
    for kw in (dict(seed=0), dict(seed=3, num_shards=2, shard=1)):
        r = RefTokenStream(512, 24, 4, **kw)
        p = TokenStream(512, 24, 4, **kw)
        for step in (0, 1, 7):
            np.testing.assert_array_equal(p.batch(step), r.batch(step))


def test_straggler_monitor():
    m = StragglerMonitor(threshold=1.5, stall_timeout_s=10.0)
    for t in range(4):
        for src, dt in (("a", 1.0), ("b", 1.0), ("c", 3.0)):
            m.record(src, dt, now=float(t))
    assert m.verdict("a", now=4.0) == "ok"
    assert m.stragglers(now=4.0) == ["c"]
    assert m.verdict("a", now=20.0) == "stall"


# -- attention ----------------------------------------------------------------------


@pytest.mark.parametrize("Sq,H,Hk,window,causal,qc,kc,dtype", [
    (8, 4, 2, None, True, 4, 4, "float32"),      # GQA, 2 x 2 chunks
    (11, 4, 4, None, True, 4, 8, "float32"),     # Sq off the chunk
    (13, 4, 2, 5, True, 4, 4, "float32"),        # sliding window
    (9, 2, 1, None, False, 4, 4, "float32"),     # encoder, padded keys
    (10, 4, 2, None, True, 4, 4, "bfloat16"),
])
def test_chunked_attention_matches_reference(Sq, H, Hk, window, causal, qc,
                                             kc, dtype):
    rng = np.random.default_rng(Sq + H)
    hd = 8
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (2, Sq, H, hd), (2, Sq, Hk, hd), (2, Sq, Hk, hd), (2, Sq, H, hd)))
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    r_out, vjp = jax.vjp(lambda a, b, c: RL.chunked_attention(a, b, c, **kw),
                         *(jnp.asarray(a, jdt) for a in (q, k, v)))
    r_grads = vjp(jnp.asarray(do, jdt))
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = layers.chunked_attention(*ts, **kw)
    out.backward(torch.from_numpy(do).to(tdt))
    tol = TOL if dtype == "float32" else 2e-2
    assert out.dtype == tdt
    _close(out.float().detach().numpy(), np.asarray(r_out, np.float32), tol)
    for t, want in zip(ts, r_grads):
        assert t.grad.dtype == tdt
        _close(t.grad.float().numpy(), np.asarray(want, np.float32), tol)


# -- forward, loss and the train step ------------------------------------------------


def _setup(mp_mode: bool, layers_n: int = 1):
    kw = dict(mp_mode=mp_mode, compute_dtype="float32", num_layers=layers_n)
    rc = dataclasses.replace(ref_get_smoke("qwen3-8b"), **kw)
    pc = dataclasses.replace(get_smoke("qwen3-8b"), **kw)
    r_params = jax.tree.map(np.asarray, RT.init(rc, jax.random.PRNGKey(0)))
    p_params = bridge.arch_params_from_numpy(r_params, pc, device="cpu")
    toks = TokenStream(pc.vocab_size, S, B * 2, seed=1).batch(0)
    return rc, pc, r_params, p_params, toks


@pytest.mark.parametrize("mp_mode", [False, True])
def test_forward_and_loss_match_reference(mp_mode):
    rc, pc, r_params, p_params, toks = _setup(mp_mode)
    batch_r, batch_p = {"tokens": jnp.asarray(toks[:B])}, \
        {"tokens": torch.as_tensor(toks[:B])}
    logits = T.forward(p_params, pc, batch_p)
    loss = steps.make_loss_fn(pc, seq_chunk=3)(p_params, batch_p)
    want, want_loss = jax.jit(lambda p, b: (
        RT.forward(p, rc, b),
        ref_steps.make_loss_fn(rc, seq_chunk=3)(p, b)))(
            jax.tree.map(jnp.asarray, r_params), batch_r)
    assert tuple(logits.shape) == (B, S, pc.padded_vocab)
    _close(logits.detach().numpy(), want)
    _close(float(loss), want_loss)


def _leaf_close(got, want, tol):
    """Within tol x the leaf's own max |want|."""
    bound = tol * float(np.max(np.abs(want)))
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)


@pytest.mark.parametrize("mp_mode", [False, True])
def test_loss_gradients_match_reference(mp_mode):
    """The port's autograd of ``make_loss_fn`` against ``jax.grad`` of the
    reference's, leaf by leaf, each within its own scale. Control: with
    mp_mode on, the float product's gradients miss the MP gate."""
    rc, pc, r_params, p_params, toks = _setup(mp_mode)
    r_grads = jax.jit(jax.grad(ref_steps.make_loss_fn(rc)))(
        jax.tree.map(jnp.asarray, r_params), {"tokens": jnp.asarray(toks)})
    want = jax.tree.leaves(jax.tree.map(np.asarray, r_grads))

    def grads(cfg):
        leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                                p_params)
        steps.make_loss_fn(cfg)(
            leaves, {"tokens": torch.as_tensor(toks)}).backward()
        return list(_leaves_with_path(bridge.arch_params_to_numpy(
            adamw.tree_map(lambda p: p.grad, leaves))))

    tol = MP_GRAD_TOL if mp_mode else TOL
    for (path, a), b in zip(grads(pc), want):
        assert a.shape == b.shape, path
        _leaf_close(a, b, tol)
    if mp_mode:
        plain = grads(dataclasses.replace(pc, mp_mode=False))
        assert max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                   for (_, a), b in zip(plain, want)) > MP_GRAD_TOL


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One MP-mode step from the same params: loss, grad norm, the new
    params and both moments (every projection and the head through
    ``ops.mp_linear`` and its backward)."""
    rc, pc, r_params, p_params, toks = _setup(True)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-6)
    _, r_step = ref_steps.make_train_step(rc, ref_adamw.AdamWConfig(**kw),
                                          accum=accum)
    _, p_step = steps.make_train_step(pc, adamw.AdamWConfig(**kw),
                                      accum=accum)
    rp = jax.tree.map(jnp.asarray, r_params)
    r_state = ref_steps.TrainState(rp, ref_adamw.adamw_init(rp),
                                   jnp.zeros((), jnp.int32))
    p_state = steps.TrainState(p_params, adamw.adamw_init(p_params),
                               torch.zeros((), dtype=torch.int32))
    r_new, rm = jax.jit(r_step)(r_state, {"tokens": jnp.asarray(toks)})
    p_new, pm = p_step(p_state, {"tokens": torch.as_tensor(toks)})
    _close(float(pm["loss"]), rm["loss"], STEP_TOL)
    _close(float(pm["grad_norm"]), rm["grad_norm"], STEP_TOL)
    assert int(p_new.step) == 1 and int(p_new.opt.count) == 1
    ref_leaves = lambda t: jax.tree.leaves(jax.tree.map(np.asarray, t))
    moments = {}
    for name, got, want in (("mu", p_new.opt.mu, r_new.opt.mu),
                            ("nu", p_new.opt.nu, r_new.opt.nu)):
        got = bridge.arch_params_to_numpy(got)
        moments[name] = list(zip(_leaves_with_path(got), ref_leaves(want)))
        for (path, a), b in moments[name]:
            assert a.shape == b.shape, (name, path)
            top = float(np.abs(b).max())
            bound = min(STEP_TOL * (1.0 + top), MP_GRAD_TOL * top)
            assert np.all(np.abs(a - b) <= bound), (name, path)
    got = bridge.arch_params_to_numpy(p_new.params)
    lr, b1, eps = float(rm["lr"]), 0.9, kw["eps"]
    for (path, a), b, ((_, m), m_ref) in zip(
            _leaves_with_path(got), ref_leaves(r_new.params),
            moments["mu"]):
        assert a.shape == b.shape, path
        g, g_ref = m / (1 - b1), m_ref / (1 - b1)
        moved = np.abs(g - g_ref) / (np.minimum(np.abs(g), np.abs(g_ref))
                                     + eps)
        bound = (lr * np.minimum(2.0, moved)
                 + TOL * (1.0 + float(np.abs(b).max())))
        assert np.all(np.abs(a - b) <= bound), path


def _leaves_with_path(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


def test_train_step_loss_falls_on_one_batch():
    """Three MP-mode steps on one batch: finite, falling loss."""
    _, pc, _, p_params, toks = _setup(True)
    _, p_step = steps.make_train_step(pc, adamw.AdamWConfig(
        lr=3e-3, warmup_steps=1, total_steps=10))
    state = steps.TrainState(p_params, adamw.adamw_init(p_params),
                             torch.zeros((), dtype=torch.int32))
    losses = []
    for _ in range(3):
        state, m = p_step(state, {"tokens": torch.as_tensor(toks[:1])})
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- the launcher -------------------------------------------------------------------


def test_launch_train_resumes_from_a_checkpoint(tmp_path, capsys):
    """3 steps with a checkpoint after step 2; the final one removed, a
    second run resumes at step 2 and repeats the first run's last loss
    bit for bit."""
    args = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--warmup", "1", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--device", "cpu"]
    first = train_launch.main(args)
    assert len(first) == 3 and all(np.isfinite(first))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    import shutil
    shutil.rmtree(tmp_path / "step_00000003")
    again = train_launch.main(args)
    assert "resumed from step 2" in capsys.readouterr().out
    assert again == first[2:]


def test_launch_train_refuses_a_mesh_and_runs_on_the_card_by_default(
        monkeypatch, tmp_path):
    """A mesh is no longer refused: ``--mesh-data 2`` on one process trains
    on a (1, 1) mesh (clamped to the one rank, as the reference clamps to
    its devices), with the losses of the run without it; what is refused
    is a mesh argument that is not a ``DeviceMesh``."""
    args = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--warmup", "1", "--device", "cpu"]
    with one_rank_group(tmp_path):
        meshed = train_launch.main(args + ["--mesh-data", "2"])
    assert meshed == train_launch.main(args)
    with pytest.raises(TypeError, match="DeviceMesh"):
        steps.make_train_step(get_smoke("qwen3-8b"), adamw.AdamWConfig(),
                              mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1"])
