"""The port's transformer decode path against the reference's, on the CPU.

The reference params come from ``repro.models.transformer.init`` at the
``qwen3-8b`` smoke size (3 layers, d_model 64) and cross into the port
through ``bridge`` as numpy; both packages then decode the same seeded
tokens for 4 steps at B = 2. The reference's MP projections run its
Pallas ``mp_linear`` kernel in interpret mode; the port's run the plain
version of ``csrc/mp_linear.cu``.

Tolerances, each as a multiple of max |reference| (the logits are ~0.2,
so a "1 +" in the scale would loosen them five-fold):
  * float32 compute, MP and float modes: 1e-4 (logits and caches) — the
    two MP solves sum in different orders, and RMSNorm of the small k
    projections magnifies that; the MP logits land within 3.7e-5, and a
    solve two bisection steps short (22 of 26) misses by 4.6e-4, which
    ``test_decode_mp_f32_gate_catches_a_coarser_solve`` holds;
  * bf16 compute (the config's own): 3e-2, the repo's bf16 kernel gate; a
    different sum order can round an activation to the neighbouring bf16
    value (the logits land within 2e-2).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import get_smoke as ref_get_smoke
from repro.distributed.steps import make_serve_step as ref_make_serve_step
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import get_arch, get_smoke
from repro_torch.distributed.steps import make_serve_step
from repro_torch.kernels import ops
from repro_torch.launch.serve import serve_decode
from repro_torch.models import layers
from repro_torch.models import transformer as T
from torch_mesh_ranks import one_rank_group

B, STEPS = 2, 4
TOL32, TOL16 = 1e-4, 3e-2


def _configs(**kw):
    return (dataclasses.replace(ref_get_smoke("qwen3-8b"), **kw),
            dataclasses.replace(get_smoke("qwen3-8b"), **kw))


def _tokens():
    return np.random.default_rng(11).integers(0, 512, (B, STEPS))


def _decode_both(compute_dtype: str, mp_mode: bool):
    """Run 4 decode steps in both packages on the same params and tokens;
    returns per-step logits (f32 numpy) and the final caches as numpy."""
    rc, pc = _configs(mp_mode=mp_mode, compute_dtype=compute_dtype)
    params = RT.init(rc, jax.random.PRNGKey(0))
    port_params = bridge.arch_params_from_numpy(
        jax.tree.map(np.asarray, params), pc, device="cpu")
    r_cache = RT.init_cache(rc, B, STEPS)
    p_cache = T.init_cache(pc, B, STEPS, device="cpu")
    step = jax.jit(RT.decode_step, static_argnums=(1,))
    toks = _tokens()
    r_logits, p_logits = [], []
    for i in range(STEPS):
        pos = np.full((B,), i, np.int32)
        lr, r_cache = step(params, rc, jnp.asarray(toks[:, i:i + 1]),
                           r_cache, jnp.asarray(pos))
        lp, p_cache = T.decode_step(port_params, pc,
                                    torch.as_tensor(toks[:, i:i + 1]),
                                    p_cache, torch.as_tensor(pos))
        r_logits.append(np.asarray(lr, np.float32))
        p_logits.append(lp.float().numpy())
    return (r_logits, p_logits, jax.tree.map(np.asarray, r_cache),
            bridge.attn_cache_to_numpy(p_cache))


def _gap(got, want) -> float:
    """max |got - want| / max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _close(got, want, tol):
    assert _gap(got, want) <= tol


def test_arch_config_copies_the_reference():
    rc, pc = _configs()
    assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
    assert pc.padded_vocab == rc.padded_vocab
    assert dataclasses.asdict(ref_get_arch("qwen3-8b")) == \
        dataclasses.asdict(get_arch("qwen3-8b"))
    assert [f.name for f in dataclasses.fields(RT.ArchConfig)] == \
        [f.name for f in dataclasses.fields(T.ArchConfig)]
    with pytest.raises(KeyError, match="unknown architecture"):
        get_arch("qwen3-80b")


def test_decode_mp_f32_matches_reference():
    r_logits, p_logits, r_cache, p_cache = _decode_both("float32", True)
    for lr, lp in zip(r_logits, p_logits):
        assert lp.shape == lr.shape == (B, 1, 512)
        _close(lp, lr, TOL32)
    for key in ("k", "v"):
        _close(p_cache["scan"][key], r_cache["scan"][key], TOL32)
    np.testing.assert_array_equal(p_cache["scan"]["pos"],
                                  r_cache["scan"]["pos"])


def test_decode_mp_f32_gate_catches_a_coarser_solve():
    """The control of the f32 gate: the same decode with every MP product
    solved in 22 bisection steps instead of 26 must miss it."""
    def coarse(x, w, gamma):
        return ops.mp_linear(x, w, gamma, iters=22)

    with mock.patch.object(layers, "mp_linear", coarse):
        r_logits, p_logits, _, _ = _decode_both("float32", True)
    assert max(_gap(lp, lr) for lr, lp in zip(r_logits, p_logits)) > TOL32


def test_decode_mp_bf16_matches_reference():
    r_logits, p_logits, _, p_cache = _decode_both("bfloat16", True)
    assert p_cache["scan"]["k"].dtype.name == "bfloat16"
    for lr, lp in zip(r_logits, p_logits):
        assert np.isfinite(lp).all()
        _close(lp, lr, TOL16)


def test_decode_float_mode_f32_matches_reference():
    r_logits, p_logits, r_cache, p_cache = _decode_both("float32", False)
    for lr, lp in zip(r_logits, p_logits):
        _close(lp, lr, TOL32)
    for key in ("k", "v"):
        _close(p_cache["scan"][key], r_cache["scan"][key], TOL32)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_serve_step_greedy_tokens_match_reference(compute_dtype):
    """The logits agree within the tolerance, and the greedy tokens agree
    wherever the reference's top-2 margin exceeds twice the logits' largest
    gap (which the tolerance bounds): there no rounding can swap them."""
    tol = TOL16 if compute_dtype == "bfloat16" else TOL32
    rc, pc = _configs(mp_mode=True, compute_dtype=compute_dtype)
    params = RT.init(rc, jax.random.PRNGKey(1))
    port_params = bridge.arch_params_from_numpy(
        jax.tree.map(np.asarray, params), pc, device="cpu")
    r_step = jax.jit(ref_make_serve_step(rc))
    p_step = make_serve_step(pc)
    r_cache = RT.init_cache(rc, B, STEPS)
    p_cache = T.init_cache(pc, B, STEPS, device="cpu")
    toks = _tokens()
    decided = 0
    for i in range(STEPS):
        pos = np.full((B,), i, np.int32)
        r_tok, r_logits, r_cache = r_step(params, jnp.asarray(toks[:, i:i + 1]),
                                          r_cache, jnp.asarray(pos))
        p_tok, p_logits, p_cache = p_step(port_params,
                                          torch.as_tensor(toks[:, i:i + 1]),
                                          p_cache, torch.as_tensor(pos))
        r_logits = np.asarray(r_logits)
        assert p_tok.dtype == torch.int32 and tuple(p_tok.shape) == (B, 1)
        assert p_logits.dtype == torch.float32
        assert tuple(p_logits.shape) == (B, rc.vocab_size)
        _close(p_logits.numpy(), r_logits, tol)
        top2 = np.sort(r_logits, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        gap = float(np.abs(p_logits.numpy() - r_logits).max())
        clear = margin > 2 * gap
        np.testing.assert_array_equal(p_tok.numpy()[clear, 0],
                                      np.asarray(r_tok)[clear, 0])
        decided += int(clear.sum())
    assert decided > 0


def test_serve_step_samples_from_a_generator():
    _, pc = _configs(mp_mode=False, compute_dtype="float32")
    params = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
    step = make_serve_step(pc, temperature=1.0)
    draws = []
    for _ in range(2):
        cache = T.init_cache(pc, B, 1, device="cpu")
        tok, _, _ = step(params, torch.zeros(B, 1, dtype=torch.int32), cache,
                         torch.zeros(B, dtype=torch.int32),
                         torch.Generator().manual_seed(3))
        draws.append(tok)
    assert torch.equal(draws[0], draws[1])
    assert draws[0].dtype == torch.int32
    assert int(draws[0].max()) < pc.vocab_size


def test_sampling_serve_step_without_a_generator_raises():
    _, pc = _configs(mp_mode=False, compute_dtype="float32")
    params = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
    cache = T.init_cache(pc, B, 1, device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        make_serve_step(pc, temperature=0.7)(
            params, torch.zeros(B, 1, dtype=torch.int32), cache,
            torch.zeros(B, dtype=torch.int32))
    assert not bool(cache["scan"][0]["k"].any())        # nothing decoded


def test_serve_decode_matches_reference_greedy_loop():
    """The port's prefill + generate loop emits the reference loop's tokens
    (float32 compute, MP mode; the reference serve step driven as
    ``launch/serve.py`` drives it, on the same params and prompts)."""
    rc, pc = _configs(mp_mode=True, compute_dtype="float32")
    params = RT.init(rc, jax.random.PRNGKey(2))
    port_params = bridge.arch_params_from_numpy(
        jax.tree.map(np.asarray, params), pc, device="cpu")
    prompt_len, gen = 3, 3
    res = serve_decode(pc, port_params, B, prompt_len, gen, seed=5,
                       device="cpu")
    assert res.tokens.shape == (B, gen) and res.prompts.shape == (B, prompt_len)
    assert len(res.logits) == prompt_len + gen
    assert res.prefill_s > 0 and res.decode_s > 0
    prompts = np.random.default_rng(5).integers(0, rc.vocab_size,
                                                (B, prompt_len))
    np.testing.assert_array_equal(res.prompts, prompts)
    r_step = jax.jit(ref_make_serve_step(rc))
    cache = RT.init_cache(rc, B, prompt_len + gen)
    for i in range(prompt_len):
        nxt, logits, cache = r_step(params, jnp.asarray(prompts[:, i:i + 1],
                                                        jnp.int32),
                                    cache, jnp.full((B,), i, jnp.int32))
    tok, want = nxt, []
    for i in range(gen):
        tok, logits, cache = r_step(params, tok, cache,
                                    jnp.full((B,), prompt_len + i, jnp.int32))
        want.append(np.asarray(tok))
        _close(res.logits[prompt_len + i].numpy(), np.asarray(logits), TOL32)
    np.testing.assert_array_equal(res.tokens, np.concatenate(want, axis=1))


def test_bridge_round_trip_is_exact():
    rc, pc = _configs(mp_mode=True)
    params = jax.tree.map(np.asarray, RT.init(rc, jax.random.PRNGKey(3)))
    back = bridge.arch_params_to_numpy(
        bridge.arch_params_from_numpy(params, pc, device="cpu"))
    flat_a, tree_a = jax.tree.flatten(params)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    cache = RT.init_cache(rc, B, 5)            # bf16 k/v, int32 pos
    cache["scan"]["k"] = jax.random.normal(
        jax.random.PRNGKey(4), cache["scan"]["k"].shape).astype(jnp.bfloat16)
    cache = jax.tree.map(np.asarray, cache)
    back = bridge.attn_cache_to_numpy(
        bridge.attn_cache_from_numpy(cache, device="cpu"))
    for key in ("k", "v", "pos"):
        a, b = cache["scan"][key], back["scan"][key]
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert back["prefix"] == []
    ported = bridge.attn_cache_from_numpy(cache, device="cpu")
    fresh = T.init_cache(pc, B, 5, device="cpu")
    assert fresh["scan"][0]["pos"].dtype == ported["scan"][0]["pos"].dtype
    assert torch.equal(fresh["scan"][0]["pos"], ported["scan"][0]["pos"])


def test_param_count_matches_reference():
    rc, pc = _configs()
    ref_n = RT.param_count(RT.init(rc, jax.random.PRNGKey(0)))
    assert T.param_count(T.init(pc, torch.Generator().manual_seed(0),
                                device="cpu")) == ref_n


def test_unported_families_raise_naming_roadmap(tmp_path):
    """No family raises any more (the name is kept from when the train CLI
    refused all but dense, naming ROADMAP.md): the train CLI runs one step
    at smoke size for each of the five other families, each with its own
    batch (MoE, SSM and the hybrid on tokens, the VLM with patches, the
    audio encoder on frames and labels), with a finite loss. On a mesh it
    trains (one gloo rank here: ``--mesh-model 2`` clamps to (1, 1)), with
    the losses of the run without one."""
    from repro_torch.launch import train as train_launch
    for arch in ("deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
                 "internvl2-2b", "hubert-xlarge"):
        losses = train_launch.main(["--arch", arch, "--smoke", "--steps",
                                    "1", "--batch", "2", "--seq", "16",
                                    "--device", "cpu"])
        assert len(losses) == 1 and np.isfinite(losses[0]), arch
    args = ["--arch", "qwen3-8b", "--smoke", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    with one_rank_group(tmp_path):
        meshed = train_launch.main(args + ["--mesh-model", "2"])
    assert len(meshed) == 2 and meshed == train_launch.main(args)


def test_no_silent_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(pc, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(pc, B, 2)
    params = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_decode(pc, params, B, 2, 1)
