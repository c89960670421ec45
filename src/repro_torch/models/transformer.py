"""The transformer zoo's config schema, its full-sequence forward and its
decode path, in PyTorch.

The counterpart of the reference's ``repro.models.transformer``:
``ArchConfig`` (a copy, field for field), ``init``, ``forward`` (training
and prefill), ``init_cache``, ``decode_step`` and ``param_count``.

    params = init(cfg, generator)               # nested dict, f32 masters
    logits = forward(params, cfg, {"tokens": tokens})
    logits, cache = decode_step(params, cfg, tokens, cache, cur_pos)

Where the reference stacks per-layer params on a leading axis for
``lax.scan``, the port keeps a list of per-layer dicts (``params["layers"]``
and ``cache["scan"]``) and loops over it; ``bridge`` converts between the
two layouts.

What runs here: the dense decoder family with RMSNorm and SwiGLU (the
reference's "uniform" layer plan, attention mixer, no MoE), in float or in
the paper's MP mode (``mp_mode``), where every projection and the LM head
go through the CUDA ``mp_linear`` kernel (and, training, its backward
kernel). The other families (moe, ssm, hybrid, vlm, audio) and
LayerNorm/GELU blocks raise ``NotImplementedError``: they are queued in
ROADMAP.md. ``cfg.remat`` is not taken: the forward keeps every block's
activations (the reference recomputes them in its backward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L

__all__ = ["ArchConfig", "init", "forward", "decode_step", "init_cache",
           "param_count"]


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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet; it is queued in ROADMAP.md "
        "(section 1, 'Modules still to port', item 7)")


def _check_ported(cfg: ArchConfig) -> None:
    """The port runs the dense RMSNorm/SwiGLU decoder; raise for the rest."""
    if cfg.family != "dense":
        raise _not_ported(f"the {cfg.family!r} family ({cfg.name})")
    if cfg.norm != "rms":
        raise _not_ported(f"{cfg.norm!r} norm blocks ({cfg.name})")
    if cfg.num_experts or cfg.first_dense_layers:
        raise _not_ported(f"MoE layers ({cfg.name})")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


# Blocks of the one ported plan: the reference's "uniform" layer plan with
# the attention mixer and no MoE (every layer alike, no peeled prefix).


def _init_norm(cfg, device):
    return {"scale": torch.ones(cfg.d_model, device=device)}


def _norm(p, x, cfg):
    return L.rms_norm(x, p["scale"], cfg.norm_eps)


def _init_block(gen, cfg) -> dict:
    """One residual block: norm -> attention [-> norm -> SwiGLU]."""
    p = {"norm1": _init_norm(cfg, gen.device),
         "attn": L.init_attention(gen, cfg)}
    if cfg.d_ff > 0:
        p["norm2"] = _init_norm(cfg, gen.device)
        p["ffn"] = L.init_swiglu(gen, cfg.d_model, cfg.d_ff)
    return p


def _block(p, x, cfg, positions):
    h = _norm(p["norm1"], x, cfg)
    x = x + L.attention_block(p["attn"], h, cfg, positions,
                              q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    if cfg.d_ff > 0:
        h = _norm(p["norm2"], x, cfg)
        x = x + L.swiglu(p["ffn"], h, cfg)
    return x


def _block_decode(p, x, cfg, cache, cur_pos):
    h = _norm(p["norm1"], x, cfg)
    h, cache = L.attention_decode(p["attn"], h, cfg, cache, cur_pos)
    x = x + h
    if cfg.d_ff > 0:
        h = _norm(p["norm2"], x, cfg)
        x = x + L.swiglu(p["ffn"], h, cfg)
    return x, cache


# the reference casts every float32 leaf of a layer to the compute dtype
# before use (``_constrain``), except these; gradients flow back through
# the cast to the float32 masters
_KEEP_F32 = {"scale", "bias", "a_log", "dt_bias", "D", "conv_b",
             "bq", "bk", "bv", "bi", "bo"}


def _constrain(p_layer: dict, cfg: ArchConfig) -> dict:
    """A layer's params as the reference's steps use them: with a
    compute dtype other than float32, every float32 leaf not named in
    ``_KEEP_F32`` (the projections, and ``q_norm``/``k_norm``) cast to it.
    The masters stay float32: the cast is made on use, per step."""
    if cfg.compute_dtype == "float32":
        return p_layer
    dt = L.cdt(cfg)

    def cast(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cast(v)
            elif k in _KEEP_F32 or v.dtype != torch.float32:
                out[k] = v
            else:
                out[k] = v.to(dt)
        return out

    return cast(p_layer)


# ---------------------------------------------------------------------------
# init / decode
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, generator: torch.Generator, device=None) -> dict:
    """Float32 master params drawn from ``generator``, which must live on
    ``device`` (``cuda`` unless given; raises without a card)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"the generator lives on {generator.device}, the "
                         f"params go to {dev}: make the generator there")
    g = generator
    params: dict = {"tok_embed": torch.randn(
        cfg.padded_vocab, cfg.d_model, generator=g, device=dev).mul_(0.02)}
    params["layers"] = [_init_block(g, cfg) for _ in range(cfg.num_layers)]
    params["final_norm"] = _init_norm(cfg, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(g, cfg.d_model, cfg.padded_vocab)
    return params


def forward(params: dict, cfg: ArchConfig, batch: dict,
            return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence forward: ``batch["tokens"]`` (B, S) int -> logits
    (B, S, padded_vocab) in the compute dtype, or with ``return_hidden``
    the final-norm hidden states (B, S, D) (the chunked loss applies the
    head itself). Each layer's weights are cast to the compute dtype on
    use, as the reference's ``_constrain`` casts them."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    x = params["tok_embed"][tokens.long()].to(L.cdt(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for p_layer in params["layers"]:
        x = _block(_constrain(p_layer, cfg), x, cfg, positions)
    x = _norm(params["final_norm"], x, cfg)
    if return_hidden:
        return x
    head = (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    return L.linear(x, head, mp_mode=cfg.mp_mode, mp_gamma=cfg.mp_gamma,
                    compute_dtype=L.cdt(cfg))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Per-layer attention caches ``{"scan": [...], "prefix": []}``, on
    ``device`` (``cuda`` unless given)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = L.cdt(cfg) if dtype is None else dtype
    return {"scan": [L.init_attn_cache(cfg, batch, cache_len, dtype, dev)
                     for _ in range(cfg.num_layers)],
            "prefix": []}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                cache: dict, cur_pos: torch.Tensor):
    """One decode step. tokens (B, 1) int; cur_pos (B,) int32. Returns
    (logits (B, 1, padded_vocab) in the compute dtype, cache); the cache is
    updated in place."""
    if not cfg.supports_decode:
        raise ValueError(f"{cfg.name} is encoder-only")
    _check_ported(cfg)
    x = params["tok_embed"][tokens.long()].to(L.cdt(cfg))
    for p_layer, c_layer in zip(params["layers"], cache["scan"]):
        x, _ = _block_decode(_constrain(p_layer, cfg), x, cfg, c_layer,
                             cur_pos)
    x = _norm(params["final_norm"], x, cfg)
    head = (params["tok_embed"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = L.linear(x, head, mp_mode=cfg.mp_mode, mp_gamma=cfg.mp_gamma,
                      compute_dtype=L.cdt(cfg))
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
