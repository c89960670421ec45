"""Decode-time layers of the transformer zoo in PyTorch: the decode half of
the reference's ``repro.models.layers``.

Conventions, as there:
  * params are plain nested dicts of tensors, float32 masters;
  * every ``init_*`` draws from an explicit ``torch.Generator`` that lives
    on the device the params go to;
  * activations flow (B, S, D); attention uses (B, S, H, hd);
  * activations in the compute dtype (bf16 by default), norms, RoPE and
    attention scores in float32, rounded back where the reference rounds;
  * ``linear`` is the universal projection: with ``mp_mode`` it runs the
    paper's multiplierless MP product (eq. 9) through the CUDA
    ``mp_linear`` kernel (``kernels.ops.mp_linear``), else ``torch.matmul``
    in the compute dtype.

Decode only: full-sequence attention (``chunked_attention``), LayerNorm and
the GELU MLP come with the prefill/training slice (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ops import mp_linear

__all__ = ["cdt", "dense_init", "linear", "rms_norm", "rope_freqs",
           "apply_rope", "init_attention", "attention_decode",
           "init_attn_cache", "init_swiglu", "swiglu"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def cdt(cfg) -> torch.dtype:
    """The arch's compute dtype (bf16 default; f32 for exactness tests)."""
    return _DTYPES[getattr(cfg, "compute_dtype", "bfloat16")]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32) -> torch.Tensor:
    """(d_in, d_out) normal / sqrt(d_in), on ``gen``'s device."""
    w = torch.randn(d_in, d_out, generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(d_in)).to(dtype)


def linear(x, w, b=None, *, mp_mode: bool = False, mp_gamma: float = 8.0,
           compute_dtype=torch.bfloat16):
    """y = x @ w (+ b). With ``mp_mode``, the multiplierless MP product in
    float32 through the kernel, rounded to the compute dtype; ``w`` goes
    to the kernel as it comes (``ops.mp_linear`` reads its dtype)."""
    if mp_mode:
        y = mp_linear(x.float(), w, mp_gamma).to(compute_dtype)
    else:
        y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def rms_norm(x, scale, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)   # (hd/2,)
    pos = positions.float()
    if pos.ndim == 1:
        pos = pos[None, :]
    ang = pos[..., None] * freqs[None, None, :]        # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg) -> dict:
    hd = cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(cfg.num_heads * hd, device=dev)
        p["bk"] = torch.zeros(cfg.num_kv_heads * hd, device=dev)
        p["bv"] = torch.zeros(cfg.num_kv_heads * hd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(hd, device=dev)
        p["k_norm"] = torch.ones(hd, device=dev)
    return p


def _lin(cfg, x, w, b=None):
    return linear(x, w, b, mp_mode=cfg.mp_mode, mp_gamma=cfg.mp_gamma,
                  compute_dtype=cdt(cfg))


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = _lin(cfg, x, p["wq"], p.get("bq")).reshape(B, S, cfg.num_heads, hd)
    k = _lin(cfg, x, p["wk"], p.get("bk")).reshape(B, S, cfg.num_kv_heads, hd)
    v = _lin(cfg, x, p["wv"], p.get("bv")).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_decode(p, x, cfg, cache, cur_pos):
    """x: (B, 1, D); cache: {"k", "v": (B, S, Hk, hd), "pos": (B, S)};
    cur_pos (B,) int32. Writes this token's k, v and position into slot
    ``cur_pos % S`` of the cache IN PLACE (the reference returns updated
    copies) and returns (out (B, 1, D), cache)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, cur_pos[:, None])
    S = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    slot = (cur_pos % S).long()
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = cur_pos.to(cache["pos"].dtype)
    # scores and softmax in f32 over the cache; sliding windows mask by the
    # positions stored per slot
    G = cfg.num_heads // cfg.num_kv_heads
    qh = q.reshape(B, cfg.num_kv_heads, G, cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(),
                     cache["k"].float()) * scale
    valid = cache["pos"] <= cur_pos[:, None]
    if cfg.sliding_window is not None:
        valid &= (cur_pos[:, None] - cache["pos"]) < cfg.sliding_window
    s = torch.where(valid[:, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", pr, cache["v"].float())
    out = out.reshape(B, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return _lin(cfg, out, p["wo"]), cache


def init_attn_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                    device=None) -> dict:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, cache_len), 2 ** 30, dtype=torch.int32,
                          device=device),
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"wi_gate": dense_init(gen, d_model, d_ff),
            "wi_up": dense_init(gen, d_model, d_ff),
            "wo": dense_init(gen, d_ff, d_model)}


def swiglu(p, x, cfg):
    g = _lin(cfg, x, p["wi_gate"])
    u = _lin(cfg, x, p["wi_up"])
    # silu(g) = g * sigmoid(g), each op rounded to the compute dtype
    return _lin(cfg, g * torch.sigmoid(g) * u, p["wo"])
