"""Layers of the transformer zoo in PyTorch: the reference's
``repro.models.layers``, decode and full sequence (training, prefill).

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

``chunked_attention`` is the reference's flash-style attention in torch
ops: online softmax over kv chunks, GQA, causal and sliding-window masks,
and as its backward the reference's rule (``_bwd_rule``: p recomputed per
block from the saved log-sum-exp), so memory stays O(S). LayerNorm and the
biased GELU MLP serve the ``norm="ln"`` archs (the encoder).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.ops import mp_linear

__all__ = ["cdt", "remat", "dense_init", "linear", "rms_norm", "layer_norm",
           "rope_freqs", "apply_rope", "chunked_attention", "init_attention",
           "attention_block", "attention_decode", "init_attn_cache",
           "init_swiglu", "swiglu", "init_gelu_mlp", "gelu_mlp"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def cdt(cfg) -> torch.dtype:
    """The arch's compute dtype (bf16 default; f32 for exactness tests)."""
    return _DTYPES[getattr(cfg, "compute_dtype", "bfloat16")]


def remat(fn, cfg):
    """``fn`` recomputed in the backward under ``cfg.remat`` (the
    reference's ``jax.checkpoint``): a non-reentrant checkpoint that keeps
    ``fn``'s inputs and none of its intermediates. ``fn`` as it is without
    remat or without autograd (serving)."""
    if not cfg.remat:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return run


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


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


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


class _Chunks:
    """The padded, chunked, grouped layouts of one chunked_attention call:
    q (B, Sq, H, hd) as nq chunks of (B, qc, Hk, G, hd), k and v
    (B, Skv, Hk, hd) as nk chunks of (B, kc, Hk, hd); padded query
    positions are -1, padded keys 2^30 (the reference's)."""

    def __init__(self, q, k, causal, window, q_chunk, kv_chunk):
        B, Sq, H, hd = q.shape
        Skv, Hk = k.shape[1], k.shape[2]
        self.B, self.Sq, self.Skv, self.H, self.Hk = B, Sq, Skv, H, Hk
        self.G, self.hd = H // Hk, hd
        self.scale = 1.0 / math.sqrt(hd)
        self.qc, self.kc = min(q_chunk, Sq), min(kv_chunk, Skv)
        self.nq = -(-Sq // self.qc)
        self.nk = -(-Skv // self.kc)
        dev = q.device
        qpos = torch.full((self.nq * self.qc,), -1, dtype=torch.int32,
                          device=dev)
        qpos[:Sq] = torch.arange(Sq, dtype=torch.int32, device=dev)
        kpos = torch.full((self.nk * self.kc,), 2 ** 30, dtype=torch.int32,
                          device=dev)
        kpos[:Skv] = torch.arange(Skv, dtype=torch.int32, device=dev)
        self.qpos = qpos.reshape(self.nq, self.qc)
        self.kpos = kpos.reshape(self.nk, self.kc)
        self.causal, self.window = causal, window

    def q(self, x):   # (B, Sq, H, hd) -> nq x (B, qc, Hk, G, hd)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, self.nq * self.qc
                                        - self.Sq))
        return x.reshape(self.B, self.nq, self.qc, self.Hk, self.G,
                         self.hd).unbind(1)

    def kv(self, x):  # (B, Skv, Hk, hd) -> nk x (B, kc, Hk, hd)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, self.nk * self.kc
                                        - self.Skv))
        return x.reshape(self.B, self.nk, self.kc, self.Hk,
                         self.hd).unbind(1)

    def unq(self, chunks):  # nq x (B, qc, Hk, G, hd) -> (B, Sq, H, hd)
        x = torch.stack(chunks, 1).reshape(self.B, self.nq * self.qc, self.H,
                                           self.hd)
        return x[:, :self.Sq]

    def unkv(self, chunks):
        x = torch.stack(chunks, 1).reshape(self.B, self.nk * self.kc,
                                           self.Hk, self.hd)
        return x[:, :self.Skv]

    def scores(self, qc, kc, i, j):
        """(B, Hk, G, qc, kc) float32 scores of q chunk i against kv chunk
        j, masked to -1e30."""
        s = torch.einsum("bqkgd,bckd->bkgqc", qc.float(),
                         kc.float()) * self.scale
        qp, kp = self.qpos[i][:, None], self.kpos[j][None, :]
        mask = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool,
                          device=s.device)
        if self.causal:
            mask &= qp >= kp
        if self.window is not None:
            mask &= (qp - kp) < self.window
        return torch.where(mask, s, -1e30)


def _rounded(t, dtype):
    """``t`` rounded to ``dtype`` and carried in float32: a product of two
    such operands summed in float32 is what the reference's einsums with
    ``preferred_element_type=float32`` compute."""
    return t.to(dtype).float()


class _FlashAttention(torch.autograd.Function):
    """Forward: online softmax over kv chunks for each q chunk; saves
    (q, k, v, out, lse). Backward: the reference's ``_bwd_rule``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        c = _Chunks(q, k, causal, window, q_chunk, kv_chunk)
        kg, vg = c.kv(k), c.kv(v)
        outs, lses = [], []
        for i, qc in enumerate(c.q(q)):
            shape = (c.B, c.Hk, c.G, c.qc)
            m = torch.full(shape, -math.inf, device=q.device)
            l = torch.zeros(shape, device=q.device)
            acc = torch.zeros(shape + (c.hd,), device=q.device)
            for j, (kc, vc) in enumerate(zip(kg, vg)):
                s = c.scores(qc, kc, i, j)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                pv = torch.einsum("bkgqc,bckd->bkgqd", _rounded(p, vc.dtype),
                                  vc.float())
                acc = acc * corr[..., None] + pv
                m = m_new
            l_safe = torch.clamp_min(l, 1e-30)
            outs.append((acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
                        .to(q.dtype))
            lses.append(m + torch.log(l_safe))
        out = c.unq(outs)
        ctx.save_for_backward(q, k, v, out, torch.stack(lses))
        ctx.args = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lses = ctx.saved_tensors
        c = _Chunks(q, k, *ctx.args)
        qg, kg, vg = c.q(q), c.kv(k), c.kv(v)
        dog, og = c.q(dout), c.q(out)
        # D_i = rowsum(dout * out), (B, Hk, G, qc) per q chunk
        Dg = [(do.float() * o.float()).sum(-1).permute(0, 2, 3, 1)
              for do, o in zip(dog, og)]
        dq = [torch.zeros(qc.shape, device=q.device) for qc in qg]
        dks, dvs = [], []
        for j, (kc, vc) in enumerate(zip(kg, vg)):
            dk = torch.zeros(kc.shape, device=q.device)
            dv = torch.zeros(vc.shape, device=q.device)
            for i, (qc, doc) in enumerate(zip(qg, dog)):
                s = c.scores(qc, kc, i, j)
                p = torch.exp(s - lses[i][..., None])
                dp = torch.einsum("bqkgd,bckd->bkgqc", doc.float(),
                                  vc.float())
                ds = p * (dp - Dg[i][..., None]) * c.scale
                pb = _rounded(p, vc.dtype)
                dsb = _rounded(ds, qc.dtype)
                dv = dv + torch.einsum("bkgqc,bqkgd->bckd", pb, doc.float())
                dk = dk + torch.einsum("bkgqc,bqkgd->bckd", dsb, qc.float())
                dq[i] = dq[i] + torch.einsum("bkgqc,bckd->bqkgd", dsb,
                                             kc.float())
            dks.append(dk)
            dvs.append(dv)
        return (c.unq(dq).to(q.dtype), c.unkv(dks).to(k.dtype),
                c.unkv(dvs).to(v.dtype), None, None, None, None)


def chunked_attention(q, k, v, *, causal: bool = True, window=None,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Flash attention in torch ops (GQA-aware), the reference's algorithm.

    q (B, Sq, H, hd); k, v (B, Skv, Hk, hd), H % Hk == 0; positions are
    0..S-1. Scores, the softmax statistics and the accumulators are
    float32; p is rounded to v's dtype before it meets v, as there. The
    backward recomputes p per block from the saved log-sum-exp and
    accumulates dq, dk, dv in float32 (the reference's custom VJP)."""
    return _FlashAttention.apply(q, k, v, causal, window, q_chunk, kv_chunk)




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


def attention_block(p, x, cfg, positions, *, q_chunk=512, kv_chunk=1024):
    """Full-sequence attention (training / prefill): x (B, S, D)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, causal=not cfg.is_encoder,
                            window=cfg.sliding_window, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    return _lin(cfg, out.reshape(B, S, cfg.num_heads * cfg.head_dim),
                p["wo"])


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
# MLPs
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    return {"wi_gate": dense_init(gen, d_model, d_ff),
            "wi_up": dense_init(gen, d_model, d_ff),
            "wo": dense_init(gen, d_ff, d_model)}


class _Sigmoid(torch.autograd.Function):
    """sigmoid(x) as the reference's ``jax.nn.sigmoid`` is evaluated
    (lowered to 1 / (1 + exp(-x)), each op rounded to x's dtype: at bf16
    torch.sigmoid's single rounding differs in about a third of the
    values), with its derivative s (1 - s), finite where exp(-x)
    overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


def silu(x):
    """x * sigmoid(x), as the reference's ``jax.nn.silu``."""
    return x * _Sigmoid.apply(x)


def swiglu(p, x, cfg):
    g = _lin(cfg, x, p["wi_gate"])
    u = _lin(cfg, x, p["wi_up"])
    return _lin(cfg, silu(g) * u, p["wo"])


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int) -> dict:
    dev = gen.device
    return {"wi": dense_init(gen, d_model, d_ff),
            "bi": torch.zeros(d_ff, device=dev),
            "wo": dense_init(gen, d_ff, d_model),
            "bo": torch.zeros(d_model, device=dev)}


def gelu_mlp(p, x, cfg):
    """The encoder's biased GELU MLP. ``jax.nn.gelu`` defaults to the tanh
    form, so this is torch's ``approximate="tanh"``, not its erf default."""
    h = torch.nn.functional.gelu(_lin(cfg, x, p["wi"], p["bi"]),
                                 approximate="tanh")
    return _lin(cfg, h, p["wo"], p["bo"])
