"""The transformer zoo's config schema, its full-sequence forward and its
decode path, in PyTorch.

The counterpart of the reference's ``repro.models.transformer``:
``ArchConfig`` (a copy, field for field), ``init``, ``forward`` (training,
prefill, and the encoder's only path), ``init_cache``, ``decode_step``,
``param_count`` and ``active_param_count``, for every family the
reference has (dense, moe, ssm, hybrid, vlm, audio); and, from the same
layer plan, the MP kernel launches of a forward and of a train step
(``mp_launches_per_step``, ``mp_train_launches``):

    params = init(cfg, generator)               # nested dict, f32 masters
    logits = forward(params, cfg, {"tokens": tokens})
    logits, cache = decode_step(params, cfg, tokens, cache, cur_pos)

The layer plan is the reference's (``_layer_plan``): "uniform" (every
layer alike, attention or Mamba mixer, dense or MoE FFN, with a peeled
dense prefix, ``prefix_layers``, for DeepSeek's first layer) or "periodic"
(Jamba: groups of ``attn_every`` sublayers, attention first, MoE on every
``moe_every``-th FFN, ``period_layers``). Where the reference stacks
per-layer params on a leading axis for ``lax.scan``, the port keeps lists
of per-layer dicts (``layers``; ``period_layers[i]``, sublayer i of every
group) and loops; ``bridge`` converts between the two layouts.

In float or in the paper's MP mode (``mp_mode``): there every product the
reference sends through ``L.linear(..., mp_mode=...)`` (the projections,
Mamba's in/out projections, the shared experts, the LM head) runs the CUDA
``mp_linear`` kernel (and, training, its backward kernel); the router, the
routed experts and the audio frame projection stay torch products, as the
reference computes them. Under ``cfg.remat`` (and autograd) the forward
keeps only each block's input and recomputes the block in the backward
(``torch.utils.checkpoint``, non-reentrant), at the reference's
granularity: one checkpoint per scanned block on the uniform plan (the
peeled prefix is not checkpointed, as there), one per period group
around one per sublayer on the periodic plan. The per-step bf16 cast and
the mesh's gather of a layer's weights (``_constrain``) run inside the
checkpointed region, so the backward makes them again instead of keeping
them; an MP product there writes its levels twice, the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather_on_use
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

__all__ = ["ArchConfig", "init", "forward", "decode_step", "init_cache",
           "param_count", "active_param_count", "head"]


# ---------------------------------------------------------------------------
# config (a copy of the reference's schema)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention options
    use_rope: bool = True
    rope_theta: float = 1e6
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    is_encoder: bool = False
    norm: str = "rms"              # rms | ln
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # deepseek: leading dense FFN layers
    moe_every: int = 1             # jamba: MoE on every 2nd FFN
    moe_group_size: int = 512      # dispatch group (tokens)
    moe_group_chunk: int = 16      # groups per expert-FFN chunk (memory cap)
    moe_capacity_factor: Optional[float] = 1.25   # None -> no-drop (exact)
    moe_decode_capacity_factor: Optional[float] = None  # decode: no-drop
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    attn_every: int = 0            # hybrid: one attn per this many layers
    # modality stubs
    vlm_patches: int = 0           # [vlm]: number of patch embeddings
    audio_frontend: bool = False   # [audio]: frames (B, S, D) input
    # misc
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    mp_mode: bool = False          # paper technique on linear layers
    mp_gamma: float = 8.0
    compute_dtype: str = "bfloat16"   # activations/matmul dtype (f32 for
                                      # exactness tests; params stay f32)
    sequence_parallel: bool = False
    remat: bool = True
    # attention chunking (memory-efficient attention block sizes)
    q_chunk: int = 512
    kv_chunk: int = 1024
    ssm_chunk: int = 256

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 256) * 256

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """Can run long_500k: SSM/hybrid or sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _init_norm(cfg, device):
    p = {"scale": torch.ones(cfg.d_model, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros(cfg.d_model, device=device)
    return p


def _norm(p, x, cfg):
    if cfg.norm == "ln":
        return L.layer_norm(x, p["scale"], p["bias"], cfg.norm_eps)
    return L.rms_norm(x, p["scale"], cfg.norm_eps)


def _init_ffn(gen, cfg, layer_is_moe: bool):
    if layer_is_moe:
        return moe_mod.init_moe(gen, cfg)
    if cfg.norm == "ln":   # the encoder family's biased GELU MLP
        return L.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff)
    return L.init_swiglu(gen, cfg.d_model, cfg.d_ff)


def _ffn(p, x, cfg, layer_is_moe: bool):
    if layer_is_moe:
        return moe_mod.moe_block(p, x, cfg)
    if cfg.norm == "ln":
        return L.gelu_mlp(p, x, cfg)
    return L.swiglu(p, x, cfg)


def _has_ffn(cfg, layer_is_moe: bool) -> bool:
    return layer_is_moe or cfg.d_ff > 0


def _init_block(gen, cfg, *, mixer: str, layer_is_moe: bool) -> dict:
    """One residual block: norm -> mixer [-> norm -> FFN] (pre-norm). The
    pure SSM (Mamba-2) has no FFN: the mixer is the block."""
    p = {"norm1": _init_norm(cfg, gen.device)}
    if mixer == "attn":
        p["attn"] = L.init_attention(gen, cfg)
    else:
        p["mamba"] = ssm_mod.init_mamba(gen, cfg)
    if _has_ffn(cfg, layer_is_moe):
        p["norm2"] = _init_norm(cfg, gen.device)
        p["ffn"] = _init_ffn(gen, cfg, layer_is_moe)
    return p


def _block(p, x, cfg, positions, *, mixer: str, layer_is_moe: bool):
    h = _norm(p["norm1"], x, cfg)
    if mixer == "attn":
        h = L.attention_block(p["attn"], h, cfg, positions,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    else:
        h = ssm_mod.mamba_block(p["mamba"], h, cfg, chunk=cfg.ssm_chunk)
    x = x + h
    if _has_ffn(cfg, layer_is_moe):
        x = x + _ffn(p["ffn"], _norm(p["norm2"], x, cfg), cfg, layer_is_moe)
    return x


def _block_decode(p, x, cfg, cache, cur_pos, *, mixer: str,
                  layer_is_moe: bool):
    h = _norm(p["norm1"], x, cfg)
    if mixer == "attn":
        h, cache = L.attention_decode(p["attn"], h, cfg, cache, cur_pos)
    else:
        h, cache = ssm_mod.mamba_decode(p["mamba"], h, cfg, cache)
    x = x + h
    if _has_ffn(cfg, layer_is_moe):
        x = x + _ffn(p["ffn"], _norm(p["norm2"], x, cfg), cfg, layer_is_moe)
    return x, cache


def _layer_plan(cfg: ArchConfig) -> dict:
    """Which (mixer, is_moe) each layer uses: "periodic" for the hybrid
    (sublayer 0 attention, the rest Mamba, MoE where i % moe_every == 1),
    else "uniform" with ``n_prefix`` peeled dense layers first."""
    if cfg.family == "hybrid":
        period = cfg.attn_every
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole periods of {period}")
        subs = [("attn" if i == 0 else "mamba",
                 cfg.num_experts > 0 and i % cfg.moe_every == 1)
                for i in range(period)]
        return {"kind": "periodic", "period": period, "subs": subs,
                "n_groups": cfg.num_layers // period}
    if cfg.family == "ssm":
        return {"kind": "uniform", "mixer": "mamba", "is_moe": False,
                "n_scan": cfg.num_layers, "n_prefix": 0}
    return {"kind": "uniform", "mixer": "attn", "is_moe": cfg.num_experts > 0,
            "n_scan": cfg.num_layers - cfg.first_dense_layers,
            "n_prefix": cfg.first_dense_layers}


def _dense(cfg: ArchConfig) -> ArchConfig:
    """The peeled prefix layers' config: a full-d_ff dense FFN."""
    return dataclasses.replace(cfg, num_experts=0)


def mp_launches_per_step(cfg: ArchConfig) -> int:
    """The mp_linear calls of one decode step (or one forward) as the
    layer plan gives them: 4 per attention mixer, 2 per Mamba mixer, a
    dense FFN's projections (3 SwiGLU, 2 GELU), a MoE FFN's shared
    experts (one SwiGLU, 3; the router and the routed experts are torch
    products), and the head."""
    plan = _layer_plan(cfg)

    def layer(mixer, is_moe):
        n = 4 if mixer == "attn" else 2
        if is_moe:
            return n + (3 if cfg.num_shared_experts else 0)
        return n + ((2 if cfg.norm == "ln" else 3) if cfg.d_ff > 0 else 0)

    if plan["kind"] == "uniform":
        n = (plan["n_prefix"] * layer("attn", False)
             + plan["n_scan"] * layer(plan["mixer"], plan["is_moe"]))
    else:
        n = plan["n_groups"] * sum(layer(m, e) for m, e in plan["subs"])
    return n + 1


def mp_train_launches(cfg: ArchConfig, positions: int,
                      seq_chunk: int = 1024) -> tuple:
    """(forward, backward) mp_linear calls of one train step over
    ``positions`` (patches included), loss chunks of ``seq_chunk`` (the
    default of ``distributed.steps.make_loss_fn``), as the layer plan
    gives them: each product once forward and once backward; under
    ``cfg.remat`` every scanned block and every loss chunk's head again
    (its recompute), the peeled prefix not (it is not checkpointed). The
    periodic plan nests its checkpoints, and how far torch recomputes the
    outer one depends on what it saved: it is not counted under remat."""
    plan = _layer_plan(cfg)
    labelled = positions - cfg.vlm_patches - (0 if cfg.audio_frontend
                                              else 1)
    chunks = -(-labelled // seq_chunk)
    once = mp_launches_per_step(cfg) - 1 + chunks
    if not cfg.remat:
        return once, once
    if plan["kind"] != "uniform":
        raise ValueError(f"{cfg.name}: the periodic plan's launches under "
                         "remat are not counted")
    prefix = mp_launches_per_step(dataclasses.replace(
        _dense(cfg), num_layers=plan["n_prefix"], first_dense_layers=0)) - 1
    return 2 * once - prefix, once


# the reference casts every float32 leaf of a layer to the compute dtype
# before use (``_constrain``), except these; gradients flow back through
# the cast to the float32 masters
_KEEP_F32 = {"scale", "bias", "a_log", "dt_bias", "D", "conv_b",
             "bq", "bk", "bv", "bi", "bo"}


def _constrain(p_layer: dict, cfg: ArchConfig) -> dict:
    """A layer's params as the reference's scanned steps use them: with a
    compute dtype other than float32, every float32 leaf not named in
    ``_KEEP_F32`` cast to it (the projections, the experts and router,
    Mamba's conv and norm, ``q_norm``/``k_norm``). The masters stay
    float32: the cast is made on use, per step. The peeled prefix layers
    are not cast, as in the reference. Under a mesh (``DTensor`` leaves,
    sharded training) each leaf is then gathered whole (``gather_on_use``),
    after the cast, so the gather moves bf16; its gradient lands on the
    master's shards."""
    if cfg.compute_dtype == "float32":
        return _on_use(p_layer)
    dt = L.cdt(cfg)

    def cast(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cast(v)
            elif k in _KEEP_F32 or v.dtype != torch.float32:
                out[k] = gather_on_use(v)
            else:
                out[k] = gather_on_use(v.to(dt))
        return out

    return cast(p_layer)


def _on_use(tree):
    """``tree`` with its ``DTensor`` leaves gathered whole (see
    ``_constrain``); without a mesh, the same leaves."""
    if isinstance(tree, dict):
        return {k: _on_use(v) for k, v in tree.items()}
    return gather_on_use(tree)


def head(params: dict, cfg: ArchConfig) -> torch.Tensor:
    """The LM head (D, padded_vocab), float32: ``lm_head``, or for tied
    embeddings ``tok_embed`` transposed, made contiguous here once per
    step (the kernel reads w row-major; left to it, each call would copy
    it unseen)."""
    if cfg.tie_embeddings:
        return gather_on_use(params["tok_embed"]).T.contiguous()
    return gather_on_use(params["lm_head"])


# ---------------------------------------------------------------------------
# init / forward / decode
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Float32 master params drawn from ``generator``, which must live on
    ``device`` (``cuda`` unless given; raises without a card)."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"params go to {dev}: make the generator there")
    g = generator
    plan = _layer_plan(cfg)
    params: dict = {}
    if cfg.audio_frontend:   # stub frontend: a projection of given frames
        params["frame_proj"] = L.dense_init(g, cfg.d_model, cfg.d_model)
    else:
        params["tok_embed"] = torch.randn(
            cfg.padded_vocab, cfg.d_model, generator=g, device=dev).mul_(0.02)
    if plan["kind"] == "uniform":
        if plan["n_prefix"]:
            params["prefix_layers"] = [
                _init_block(g, _dense(cfg), mixer=plan["mixer"],
                            layer_is_moe=False)
                for _ in range(plan["n_prefix"])]
        params["layers"] = [
            _init_block(g, cfg, mixer=plan["mixer"],
                        layer_is_moe=plan["is_moe"])
            for _ in range(plan["n_scan"])]
    else:
        params["period_layers"] = [
            [_init_block(g, cfg, mixer=mixer, layer_is_moe=is_moe)
             for _ in range(plan["n_groups"])]
            for mixer, is_moe in plan["subs"]]
    params["final_norm"] = _init_norm(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(g, cfg.d_model, cfg.padded_vocab)
    return params


def _embed(params, cfg, batch):
    """(x (B, S, D) in the compute dtype, positions (S,)): audio frames
    through the frame projection (a torch product, as in the reference),
    else tokens, with a VLM's patch embeddings prepended."""
    if cfg.audio_frontend:
        x = L.linear(batch["frames"], gather_on_use(params["frame_proj"]),
                     compute_dtype=L.cdt(cfg))
    else:
        x = gather_on_use(params["tok_embed"])[
            batch["tokens"].long()].to(L.cdt(cfg))
        if cfg.vlm_patches:
            x = torch.cat([batch["patches"].to(L.cdt(cfg)), x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def forward(params: dict, cfg: ArchConfig, batch: dict,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S_total, padded_vocab) in the
    compute dtype, or with ``return_hidden`` the final-norm hidden states
    (B, S_total, D) (the chunked loss applies the head itself). ``batch``
    holds ``tokens`` (B, S) int, or ``frames`` (B, S, D) for the audio
    encoder, plus ``patches`` (B, P, D) for a VLM (prepended: S_total = P
    + S). Causal, except for the encoder."""
    plan = _layer_plan(cfg)
    x, positions = _embed(params, cfg, batch)
    if plan["kind"] == "uniform":
        for p in params.get("prefix_layers", []):
            x = _block(_on_use(p), x, _dense(cfg), positions,
                       mixer=plan["mixer"], layer_is_moe=False)
        def block(p, xx):
            return _block(_constrain(p, cfg), xx, cfg, positions,
                          mixer=plan["mixer"], layer_is_moe=plan["is_moe"])
        for p in params["layers"]:
            x = L.remat(block, cfg)(p, x)
    else:
        def sublayer(mixer, is_moe):
            return L.remat(lambda p, xx: _block(
                _constrain(p, cfg), xx, cfg, positions, mixer=mixer,
                layer_is_moe=is_moe), cfg)

        subs = [sublayer(m, e) for m, e in plan["subs"]]

        def group_fwd(group, xx):
            for p, sub in zip(group, subs):
                xx = sub(p, xx)
            return xx
        for group in zip(*params["period_layers"]):
            x = L.remat(group_fwd, cfg)(group, x)
    x = _norm(_on_use(params["final_norm"]), x, cfg)
    if return_hidden:
        return x
    return L.linear(x, head(params, cfg), mp_mode=cfg.mp_mode,
                    mp_gamma=cfg.mp_gamma, compute_dtype=L.cdt(cfg))


def _init_layer_cache(cfg, mixer, batch, cache_len, dtype, dev):
    if mixer == "attn":
        return L.init_attn_cache(cfg, batch, cache_len, dtype, dev)
    return ssm_mod.init_ssm_cache(cfg, batch, device=dev)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Per-layer decode caches on ``device`` (``cuda`` unless given):
    ``{"scan": [...], "prefix": [...]}`` for the uniform plan (attention
    ``{"k", "v", "pos"}`` or SSM ``{"h", "conv"}`` per layer), and
    ``{"periodic": [...]}`` for the hybrid, entry i sublayer i's caches,
    one per group."""
    dev = resolve_device(device)
    dtype = L.cdt(cfg) if dtype is None else dtype
    plan = _layer_plan(cfg)
    if plan["kind"] == "uniform":
        return {"scan": [_init_layer_cache(cfg, plan["mixer"], batch,
                                           cache_len, dtype, dev)
                         for _ in range(plan["n_scan"])],
                "prefix": [L.init_attn_cache(cfg, batch, cache_len, dtype,
                                             dev)
                           for _ in range(plan["n_prefix"])]}
    return {"periodic": [[_init_layer_cache(cfg, mixer, batch, cache_len,
                                            dtype, dev)
                          for _ in range(plan["n_groups"])]
                         for mixer, _ in plan["subs"]]}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, cur_pos: torch.Tensor):
    """One decode step. tokens (B, 1) int; cur_pos (B,) int32. Returns
    (logits (B, 1, padded_vocab) in the compute dtype, cache); the cache is
    updated in place. MoE layers use ``moe_decode_capacity_factor``
    (default no-drop), as the reference's decode does."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    cfg = dataclasses.replace(
        cfg, moe_capacity_factor=cfg.moe_decode_capacity_factor)
    plan = _layer_plan(cfg)
    x = gather_on_use(params["tok_embed"])[tokens.long()].to(L.cdt(cfg))
    if plan["kind"] == "uniform":
        for p, c in zip(params.get("prefix_layers", []), cache["prefix"]):
            x, _ = _block_decode(_on_use(p), x, _dense(cfg), c, cur_pos,
                                 mixer=plan["mixer"], layer_is_moe=False)
        for p, c in zip(params["layers"], cache["scan"]):
            x, _ = _block_decode(_constrain(p, cfg), x, cfg, c, cur_pos,
                                 mixer=plan["mixer"],
                                 layer_is_moe=plan["is_moe"])
    else:
        for group, caches in zip(zip(*params["period_layers"]),
                                 zip(*cache["periodic"])):
            for p, c, (mixer, is_moe) in zip(group, caches, plan["subs"]):
                x, _ = _block_decode(_constrain(p, cfg), x, cfg, c, cur_pos,
                                     mixer=mixer, layer_is_moe=is_moe)
    x = _norm(_on_use(params["final_norm"]), x, cfg)
    logits = L.linear(x, head(params, cfg), mp_mode=cfg.mp_mode,
                      mp_gamma=cfg.mp_gamma, compute_dtype=L.cdt(cfg))
    return logits, cache


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(t.numel() for t in _leaves(params))


def active_param_count(cfg: ArchConfig, params) -> int:
    """Parameters touched per token (MoE: the top K of the routed
    experts), as the reference counts them."""
    total = param_count(params)
    if not cfg.num_experts:
        return total
    plan = _layer_plan(cfg)
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    if plan["kind"] == "uniform":
        n_moe = plan["n_scan"] if plan["is_moe"] else 0
    else:
        n_moe = plan["n_groups"] * sum(1 for _, m in plan["subs"] if m)
    return total - n_moe * per_expert * (cfg.num_experts
                                         - cfg.num_experts_per_tok)
