"""The port's model zoo against the reference's, on the CPU, at the
``SMOKE`` sizes.

The reference's params come from ``repro.models.transformer.init`` (drawn
under ``jax.threefry_partitionable(False)``) and cross into the port
through ``bridge`` as numpy; both packages then run the same seeded
inputs: ``forward`` for the nine configs beside qwen3-8b, 3 decode steps
after a 4-token prompt for the moe, ssm, hybrid, vlm and sliding-window
(mixtral) families, a one-layer MP-mode forward of the ssm and moe smokes,
the bf16 MP path (Mamba-2's decode whole; Jamba's Mamba sublayer and
DeepSeek's MoE layer on the same inputs), and the parts between (routing
ties, the bridge, parameter counts, SSD chunking, the encoder's refusal
to decode).

The router. The reference's router is a bf16 product whatever the compute
dtype (``L.linear`` without one), so it rounds its input to bf16; the two
packages' float32 paths upstream differ by ~1e-6 (sum orders), which moves
an input across a bf16 rounding boundary now and then and a router logit
by a bf16 step (~3e-3 at the smoke widths): a different gate, at times a
different expert. So the comparisons of whole models run both packages'
router in float32 (``linear``'s default compute dtype set to float32 in
both, which only the router reads); the bf16 router itself is held to the
reference's eager one on the same input, bit for bit, with the experts it
picks (the reference's bf16 product differs between eager and jit).

Tolerances:
  * float32 compute: logits within 1e-4 x (1 + max |reference|), the
    decode slice's gate (the sums' orders);
  * MP mode: 1e-4 x max |reference|, as tests/test_torch_transformer.py's
    f32 MP gate (the reference's Pallas ``mp_linear`` in interpret mode,
    the port's plain version of ``csrc/mp_linear.cu``);
  * bf16 compute: 3e-2 x max |reference|, that file's bf16 tolerance;
  * the chosen expert ids: identical, per layer and position;
  * the bridge: exact; counts: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.configs import get_smoke as ref_get_smoke
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.launch import serve as serve_launch
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as T

TOL = 1e-4
TOL16 = 3e-2            # tests/test_torch_transformer.py's bf16 tolerance
B, S = 2, 16
NEW = sorted(a for a in ARCH_IDS if a != "qwen3-8b")
DECODE = ["deepseek-moe-16b", "mamba2-2.7b", "jamba-v0.1-52b",
          "internvl2-2b", "mixtral-8x22b"]
PROMPT, GEN = 4, 3


def _f32(arch, **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(ref_get_smoke(arch), **kw),
            dataclasses.replace(get_smoke(arch), **kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, **kw):
    """The reference's params (numpy leaves) at the f32 smoke config."""
    rc, _ = _f32(arch, **kw)
    with jax.threefry_partitionable(False):
        params = jax.jit(functools.partial(RT.init, rc))(
            jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _both(arch, **kw):
    rc, pc = _f32(arch, **kw)
    r = _ref_params(arch, **kw)
    return rc, pc, jax.tree.map(jnp.asarray, r), \
        bridge.arch_params_from_numpy(r, pc, device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the smoke sizes' torch ops are tiny (the plain
    ``mp_linear``'s bisection is thousands of them), so it is as fast
    alone, and beside other test processes on the same cores the default
    thread pool slowed the MP tests 10-40x."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_router(monkeypatch):
    """Both packages' router in float32 (see the module's docstring)."""
    monkeypatch.setitem(RL.linear.__kwdefaults__, "compute_dtype",
                        jnp.float32)
    monkeypatch.setitem(PL.linear.__kwdefaults__, "compute_dtype",
                        torch.float32)


class _Routes:
    """The expert ids each package picks, per MoE call in call order: the
    reference's scores through ``jax.debug.callback`` (as
    tests/test_archs.py captures them), the port's at its
    ``_route_scores``."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        r_scores, p_scores = RM._route_scores, PM._route_scores

        def r_cap(logits):
            jax.debug.callback(lambda a: self.ref.append(np.asarray(a)),
                               logits, ordered=True)
            return r_scores(logits)

        def p_cap(logits):
            self.port.append(logits.detach().numpy().copy())
            return p_scores(logits)

        monkeypatch.setattr(RM, "_route_scores", r_cap)
        monkeypatch.setattr(PM, "_route_scores", p_cap)

    @staticmethod
    def ids(logits, k):
        """The top-k ids of the snapped scores in lax.top_k's order."""
        scores = np.floor(logits * 2.0 ** RM.ROUTE_SNAP_BITS)
        return np.argsort(-scores, axis=-1, kind="stable")[:, :k]

    def check(self, k):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        for i, (a, b) in enumerate(zip(self.ref, self.port)):
            np.testing.assert_array_equal(
                self.ids(b, k), self.ids(a, k),
                err_msg=f"expert ids differ at MoE call {i}")


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.audio_frontend:
        return {"frames": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.vlm_patches:
        b["patches"] = rng.standard_normal(
            (B, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    return b


def _close(got, want, tol=TOL, one=1.0):
    want = np.asarray(want, np.float32)
    gap = np.abs(np.asarray(got, np.float32) - want).max()
    assert gap <= tol * (one + np.abs(want).max()), gap


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(REF_ARCH_IDS))
def test_config_fields_equal_the_reference(arch):
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    for ref_get, get in ((ref_get_arch, get_arch), (ref_get_smoke, get_smoke)):
        rc, pc = ref_get(arch), get(arch)
        assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
        assert (pc.padded_vocab, pc.supports_decode, pc.subquadratic) == \
            (rc.padded_vocab, rc.supports_decode, rc.subquadratic)


# -- whole models ----------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_forward_f32_matches_reference(arch, f32_router, monkeypatch):
    routes = _Routes(monkeypatch)
    rc, pc, rp, pp = _both(arch)
    b = _batch(rc)
    want = jax.jit(lambda p, x: RT.forward(p, rc, x))(
        rp, {k: jnp.asarray(v) for k, v in b.items()})
    got = T.forward(pp, pc, {k: torch.as_tensor(v) for k, v in b.items()})
    assert tuple(got.shape) == want.shape == (
        B, S + rc.vlm_patches, rc.padded_vocab)
    _close(got.numpy(), want)
    if rc.num_experts:
        routes.check(rc.num_experts_per_tok)


def _decode_both(rc, pc, rp, pp):
    """A 4-token prompt through decode slots, then 3 steps, in both
    packages: the per-step logits (float32 numpy) and the final caches'
    leaves as (path, reference, port)."""
    n = PROMPT + GEN
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (B, n))
    r_cache, p_cache = RT.init_cache(rc, B, n), T.init_cache(pc, B, n,
                                                              device="cpu")
    step = jax.jit(RT.decode_step, static_argnums=(1,))
    logits = []
    for i in range(n):
        pos = np.full((B,), i, np.int32)
        lr, r_cache = step(rp, rc, jnp.asarray(toks[:, i:i + 1]), r_cache,
                           jnp.asarray(pos))
        lp, p_cache = T.decode_step(pp, pc, torch.as_tensor(toks[:, i:i + 1]),
                                    p_cache, torch.as_tensor(pos))
        assert tuple(lp.shape) == (B, 1, rc.padded_vocab)
        logits.append((np.asarray(lr, np.float32), lp.float().numpy()))
    ref_cache = jax.tree.map(np.asarray, r_cache)
    got_cache = bridge.attn_cache_to_numpy(p_cache)
    leaves = [(path, a, b) for (path, a), b in zip(
        jax.tree_util.tree_flatten_with_path(ref_cache)[0],
        jax.tree.leaves(got_cache))]
    return logits, leaves


@pytest.mark.parametrize("arch", DECODE)
def test_decode_matches_reference(arch, f32_router, monkeypatch):
    """A 4-token prompt through decode slots, then 3 steps; the caches
    hold 7 positions (mixtral's smoke window of 16 covers them: its decode
    masks by the positions stored per slot either way)."""
    routes = _Routes(monkeypatch)
    logits, leaves = _decode_both(*_both(arch))
    for lr, lp in logits:
        _close(lp, lr)
    for path, a, b in leaves:
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=str(path))
        else:
            _close(b, a)
    rc = ref_get_smoke(arch)
    if rc.num_experts:
        routes.check(rc.num_experts_per_tok)


def test_decode_mp_bf16_matches_reference():
    """Mamba-2 as the card serves it, MP mode at bf16 compute: the per-step
    casts of ``conv_w`` and ``norm``, ``mamba_decode``'s bf16 weights
    against its float32 state, the projections and the tied head through
    ``mp_linear``. Logits and float caches within TOL16 x max |reference|,
    the dense family's bf16 tolerance (tests/test_torch_transformer.py).
    The MoE and hybrid families are held at bf16 layer by layer below:
    through a whole model with attention and FFN blocks the two packages'
    bf16 roundings part (on the same input each layer agrees, the jitted
    reference's whole block does not round where its ops do), and MP mode
    carries those steps on undivided, so their whole-model gap is of the
    size of each package's own bf16 gap from its float32 run."""
    rc, pc, rp, pp = _both("mamba2-2.7b", mp_mode=True)
    rc, pc = (dataclasses.replace(c, compute_dtype="bfloat16")
              for c in (rc, pc))
    logits, leaves = _decode_both(rc, pc, rp, pp)
    for lr, lp in logits:
        assert np.isfinite(lp).all()
        _close(lp, lr, TOL16, one=0.0)
    for path, a, b in leaves:
        assert a.dtype == b.dtype, path
        _close(b, a, TOL16, one=0.0)


def _layer_bf16(arch, where, i, **kw):
    """Layer ``i`` of ``where`` (``layers`` or a ``period_layers`` entry)
    in both packages, cast as the bf16 decode step casts it (each
    package's ``_constrain``), with both bf16 MP configs."""
    rc, pc, rp, pp = _both(arch, mp_mode=True, **kw)
    rc, pc = (dataclasses.replace(c, compute_dtype="bfloat16")
              for c in (rc, pc))
    r_layer = rp[where] if where == "layers" else rp["period_layers"][where]
    p_layer = pp[where] if where == "layers" else pp["period_layers"][where]
    return (rc, pc, RT._constrain(jax.tree.map(lambda a: a[i], r_layer), rc),
            T._constrain(p_layer[i], pc))


def test_jamba_mamba_decode_bf16_matches_reference():
    """Jamba's Mamba sublayer at bf16 compute in MP mode, 7 steps of
    ``mamba_decode`` on the same inputs: bf16 ``in_proj`` / ``out_proj``
    (through ``mp_linear``), ``conv_w`` and ``norm`` against the float32
    state. Outputs and state within TOL16 x max |reference|."""
    rc, pc, rp, pp = _layer_bf16("jamba-v0.1-52b", 1, 0)
    assert pp["mamba"]["conv_w"].dtype == torch.bfloat16
    assert pp["mamba"]["norm"].dtype == torch.bfloat16
    r_cache = RS.init_ssm_cache(rc, B)
    p_cache = PS.init_ssm_cache(pc, B, device="cpu")
    step = jax.jit(lambda p, x, c: RS.mamba_decode(p, x, rc, c))
    rng = np.random.default_rng(5)
    for _ in range(PROMPT + GEN):
        x = jnp.asarray(rng.standard_normal((B, 1, rc.d_model)),
                        jnp.bfloat16)
        want, r_cache = step(rp["mamba"], x, r_cache)
        got, p_cache = PS.mamba_decode(
            pp["mamba"], torch.from_numpy(np.asarray(x, np.float32))
            .bfloat16(), pc, p_cache)
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), np.asarray(want, np.float32), TOL16,
               one=0.0)
        for k in ("h", "conv"):
            assert p_cache[k].dtype == torch.float32
            _close(p_cache[k].numpy(), r_cache[k], TOL16, one=0.0)


@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drop", "drops"])
def test_moe_block_bf16_matches_reference(cf, f32_router):
    """DeepSeek-MoE's layer at bf16 compute in MP mode on the same bf16
    input: the stacked experts cast by ``_constrain``, the routed experts'
    bf16 einsums and SiLU (``jax.nn.silu``'s op-by-op bf16 form), the
    gated combine, the shared experts through ``mp_linear``. The float32
    router (see the module's docstring) sees the same input in both, so
    the routes are the reference's; within TOL16 x max |reference|."""
    rc, pc, rp, pp = _layer_bf16("deepseek-moe-16b", "layers", 0,
                                 moe_capacity_factor=cf)
    assert pp["ffn"]["wi_gate"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(6).standard_normal(
        (B, S, rc.d_model)), jnp.bfloat16)
    want = jax.jit(lambda q, v: RM.moe_block(q, v, rc))(rp["ffn"], x)
    got = PM.moe_block(pp["ffn"], torch.from_numpy(
        np.asarray(x, np.float32)).bfloat16(), pc)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL16,
           one=0.0)


@pytest.mark.parametrize("arch,kw", [
    ("mamba2-2.7b", dict(num_layers=1)),
    ("deepseek-moe-16b", dict(num_layers=1, first_dense_layers=0))],
    ids=["ssm", "moe"])
def test_mp_forward_one_layer_matches_reference(arch, kw, f32_router):
    """MP mode: Mamba's in/out projections, the MoE layer's attention and
    shared experts, and the head through ``mp_linear``."""
    rc, pc, rp, pp = _both(arch, mp_mode=True, **kw)
    toks = np.random.default_rng(2).integers(0, rc.vocab_size, (B, 8))
    want = jax.jit(lambda p, t: RT.forward(p, rc, {"tokens": t}))(
        rp, jnp.asarray(toks))
    got = T.forward(pp, pc, {"tokens": torch.as_tensor(toks)})
    _close(got.numpy(), want, one=0.0)


# -- routing -----------------------------------------------------------------------


def test_bf16_router_matches_reference_on_the_same_input(f32_router):
    """The router in its own bf16 product (eager, as the reference's
    ``L.linear`` runs it outside a jit), bit for bit, and the experts it
    picks; then the MoE block, no-drop and with capacity drops, with both
    routers in float32."""
    rc, pc = _f32("deepseek-moe-16b")
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]), _ref_params(
        "deepseek-moe-16b")["layers"]["ffn"])
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = np.random.default_rng(3).standard_normal((B, S, rc.d_model)) \
        .astype(np.float32)
    xf = x.reshape(-1, rc.d_model)
    bf16 = dict(compute_dtype=jnp.bfloat16)
    want = np.asarray(RL.linear(jnp.asarray(xf), rp["router"], **bf16)
                      .astype(jnp.float32))
    got = PL.linear(torch.from_numpy(xf), pp["router"],
                    compute_dtype=torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _Routes.ids(got, rc.num_experts_per_tok),
        np.asarray(lax.top_k(RM._route_scores(jnp.asarray(want)),
                             rc.num_experts_per_tok)[1]))
    for cf in (None, 0.5):      # no-drop, and capacity with drops
        r = dataclasses.replace(rc, moe_capacity_factor=cf)
        p = dataclasses.replace(pc, moe_capacity_factor=cf)
        assert cf is None or PM.capacity(p, B * S) < B * S
        _close(PM.moe_block(pp, torch.from_numpy(x), p).numpy(),
               jax.jit(lambda q, v: RM.moe_block(q, v, r))(rp, x))


def test_routing_ties_pick_the_lowest_ids(f32_router):
    """Router columns repeated, so experts tie exactly: both packages
    pick the lowest ids of each tied score, and the blocks agree."""
    rc, pc = _f32("mixtral-8x22b", num_experts=6, num_experts_per_tok=3,
                  moe_capacity_factor=None)
    with jax.threefry_partitionable(False):
        rp = jax.jit(lambda k: RM.init_moe(k, rc))(jax.random.PRNGKey(5))
    router = np.array(rp["router"])
    router[:, 3:] = router[:, :3]             # expert 3 + j ties expert j
    rp = dict(rp, router=jnp.asarray(router))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(4).standard_normal((1, 8, rc.d_model)) \
        .astype(np.float32)
    xf = x.reshape(-1, rc.d_model)
    logits = np.asarray(RL.linear(jnp.asarray(xf), rp["router"])
                        .astype(jnp.float32))
    ref_ids = np.asarray(lax.top_k(RM._route_scores(jnp.asarray(logits)),
                                   3)[1])
    port_ids = PM.route(pp, torch.from_numpy(xf), pc)[0].numpy()
    np.testing.assert_array_equal(port_ids, ref_ids)
    np.testing.assert_array_equal(port_ids, _Routes.ids(logits, 3))
    # every row's best score is a tie (expert j and its twin j + 3), and
    # the lower id comes first
    np.testing.assert_array_equal(port_ids[:, 1], port_ids[:, 0] + 3)
    _close(PM.moe_block(pp, torch.from_numpy(x), pc).numpy(),
           jax.jit(lambda q, v: RM.moe_block(q, v, rc))(rp, x))


# -- bridge, counts, SSD, the encoder ------------------------------------------------


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b",
                                  "mamba2-2.7b"])
def test_bridge_round_trips_are_exact(arch):
    """Params (``prefix_layers``, ``period_layers``, ``layers``) and
    decode caches (SSM ``h``/``conv``, the hybrid's ``periodic``)."""
    rc, pc = _f32(arch)
    params = _ref_params(arch)
    back = bridge.arch_params_to_numpy(
        bridge.arch_params_from_numpy(params, pc, device="cpu"))
    for cache in (params, _filled_cache(rc)):
        if cache is not params:
            back = bridge.attn_cache_to_numpy(
                bridge.attn_cache_from_numpy(cache, device="cpu"))
        flat_a, tree_a = jax.tree.flatten(cache)
        flat_b, tree_b = jax.tree.flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    fresh = jax.tree.leaves(bridge.attn_cache_to_numpy(
        T.init_cache(pc, B, 5, device="cpu")))
    for a, b in zip(jax.tree.leaves(RT.init_cache(rc, B, 5)), fresh):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), b)


def _filled_cache(cfg):
    """A reference cache (numpy) with random values in every float leaf."""
    rng = np.random.default_rng(6)
    return jax.tree.map(
        lambda a: a if a.dtype == np.int32 else rng.standard_normal(
            a.shape).astype(a.dtype), jax.tree.map(
                np.asarray, RT.init_cache(cfg, B, 5)))


@pytest.mark.parametrize("arch", sorted(REF_ARCH_IDS))
def test_param_counts_match_reference(arch):
    rc, pc = _f32(arch)
    rp = _ref_params(arch)
    pp = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
    assert T.param_count(pp) == RT.param_count(rp)
    assert T.active_param_count(pc, pp) == RT.active_param_count(rc, rp)
    assert jax.tree.structure(bridge.arch_params_to_numpy(pp)) == \
        jax.tree.structure(rp)


def test_ssd_chunk_size_invariance():
    """The chunked SSD with chunks of 8 and of 32 (and the reference's at
    8), as tests/test_ssm.py checks the reference."""
    rc, pc = _f32("mamba2-2.7b")
    with jax.threefry_partitionable(False):
        rp = jax.jit(lambda k: RS.init_mamba(k, rc))(jax.random.PRNGKey(2))
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(3).standard_normal((2, 64, rc.d_model)) \
        .astype(np.float32)
    y8 = PS.mamba_block(pp, torch.from_numpy(x), pc, chunk=8).numpy()
    y32 = PS.mamba_block(pp, torch.from_numpy(x), pc, chunk=32).numpy()
    np.testing.assert_allclose(y8, y32, rtol=2e-3, atol=2e-3)
    _close(y8, jax.jit(lambda q, v: RS.mamba_block(q, v, rc, chunk=8))(rp, x))
    with pytest.raises(ValueError, match="must divide"):
        PS.mamba_block(pp, torch.from_numpy(x[:, :40]), pc, chunk=32)


def test_decode_is_refused_for_the_encoder():
    _, pc = _f32("hubert-xlarge")
    assert not pc.supports_decode
    params = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        T.decode_step(params, pc, torch.zeros(B, 1, dtype=torch.int32), {},
                      torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="encoder-only"):
        serve_launch.serve_decode(pc, params, B, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        serve_launch.main(["--arch", "hubert-xlarge", "--smoke",
                           "--device", "cpu"])
