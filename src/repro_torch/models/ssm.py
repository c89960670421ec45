"""Mamba-2 blocks (SSD, state-space duality) in PyTorch: the reference's
``repro.models.ssm``.

Block layout as there: in_proj -> [z | x | B | C | dt], a short causal
depthwise conv on (x, B, C), the SSD mixer, a gated RMSNorm, out_proj. Both
projections go through ``layers.linear``, so in MP mode they are the CUDA
``mp_linear`` kernel; the conv, the scan and the norm are torch ops in
float32, as the reference computes them outside any kernel.

The full-sequence form (training, prefill) is the chunked SSD: chunks of Q
positions, within a chunk a masked quadratic form, across chunks the
(H, N, P) state carried by a loop (under ``cfg.remat`` each chunk's body
is recomputed in the backward, as the reference's scan body is). Decode
keeps that state exactly:

    h <- exp(dt A) h + dt (B outer x);   y = C . h + D x

``F.softplus`` takes its linear branch above 20, where JAX's softplus is
``logaddexp(x, 0)``; the two differ there by less than 1e-8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

__all__ = ["init_mamba", "mamba_block", "mamba_decode", "init_ssm_cache"]

CONV_W = 4  # depthwise conv width


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim


def init_mamba(gen: torch.Generator, cfg) -> dict:
    d_inner, nheads = _dims(cfg)
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    dev = gen.device
    in_dim = 2 * d_inner + 2 * N + nheads
    return {
        "in_proj": L.dense_init(gen, cfg.d_model, in_dim),
        "conv_w": torch.randn(CONV_W, conv_dim, generator=gen,
                              device=dev).mul_(0.1),
        "conv_b": torch.zeros(conv_dim, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nheads, device=dev)),
        "dt_bias": torch.zeros(nheads, device=dev),
        "D": torch.ones(nheads, device=dev),
        "norm": torch.ones(d_inner, device=dev),
        "out_proj": L.dense_init(gen, d_inner, cfg.d_model),
    }


def _split_proj(cfg, zxbcdt):
    d_inner, nheads = _dims(cfg)
    N = cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, nheads], dim=-1)


def _causal_dwconv(x, w, b):
    """x (B, S, C) float32, w (W, C): depthwise causal conv, then SiLU."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i]
    return L.silu(out + b)


def _gated_out(p, y, z, cfg, dtype):
    y = L.rms_norm(y * L.silu(z.float()), p["norm"], cfg.norm_eps)
    return L._lin(cfg, y.to(dtype), p["out_proj"])


def mamba_block(p, x, cfg, *, chunk: int = 256):
    """x (B, S, D) -> (B, S, D) by the chunked SSD; the chunk Q = min(chunk,
    S) must divide S."""
    B, S, D = x.shape
    d_inner, H = _dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state

    z, xin, Bc, Cc, dt = _split_proj(cfg, L._lin(cfg, x, p["in_proj"]))
    xbc = _causal_dwconv(torch.cat([xin, Bc, Cc], -1).float(), p["conv_w"],
                         p["conv_b"])
    xin, Bc, Cc = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, H)
    A = -torch.exp(p["a_log"])                                # (H,)
    xh = xin.reshape(B, S, H, P)

    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"the SSD chunk {Q} must divide the sequence {S}")
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))

    def chunk_step(h, xc, Bcc, Ccc, dtc):
        """One chunk: the intra-chunk quadratic form plus the carried
        state's part; returns (the next state, y of the chunk)."""
        dAcs = torch.cumsum(dtc * A, dim=1)                    # (B, Q, H)
        # Lmat[i, j] = exp(dAcs_i - dAcs_j) for i >= j; masked BEFORE the
        # exp (the upper triangle is positive and overflows; after it, the
        # gradient would be inf x 0)
        diff = dAcs[:, :, None, :] - dAcs[:, None, :, :]        # (B,Q,Q,H)
        diff = torch.where(causal[None, :, :, None], diff, -math.inf)
        CB = torch.einsum("bqn,bkn->bqk", Ccc, Bcc)
        W_ = CB[..., None] * torch.exp(diff)
        y_intra = torch.einsum("bqkh,bkh,bkhp->bqhp", W_, dtc, xc)
        y_inter = torch.einsum("bqn,bqh,bhnp->bqhp", Ccc, torch.exp(dAcs), h)
        seg = torch.exp(dAcs[:, -1:, :] - dAcs)
        st = torch.einsum("bkn,bkh,bkhp->bhnp", Bcc, dtc * seg, xc)
        return h * torch.exp(dAcs[:, -1])[..., None, None] + st, \
            y_intra + y_inter

    # under cfg.remat the chunk body is recomputed in the backward (the
    # reference's jax.checkpoint of its scan body): only each chunk's
    # inputs and the carried (H, N, P) state are kept, not the (B, Q, Q,
    # H) quadratic tensors
    step = L.remat(chunk_step, cfg)
    h = torch.zeros(B, H, N, P, device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        h, y = step(h, *(t[:, c0:c0 + Q] for t in (xh, Bc, Cc, dt)))
        ys.append(y)
    y = torch.cat(ys, dim=1) + p["D"][None, None, :, None] * xh
    return _gated_out(p, y.reshape(B, S, d_inner), z, cfg, x.dtype)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg, batch: int, dtype=torch.float32, device=None) -> dict:
    d_inner, H = _dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_headdim
    return {
        "h": torch.zeros(batch, H, N, P, dtype=dtype, device=device),
        "conv": torch.zeros(batch, CONV_W - 1, d_inner + 2 * N, dtype=dtype,
                            device=device),
    }


def mamba_decode(p, x, cfg, cache):
    """x (B, 1, D), one step. Writes the new state and conv window into
    ``cache``'s tensors IN PLACE (the reference returns new ones) and
    returns (y (B, 1, D), cache)."""
    B = x.shape[0]
    d_inner, H = _dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state

    z, xin, Bc, Cc, dt = _split_proj(cfg, L._lin(cfg, x[:, 0], p["in_proj"]))
    xbc_new = torch.cat([xin, Bc, Cc], -1).float()
    conv_win = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)
    xbc = L.silu((conv_win * p["conv_w"][None]).sum(1) + p["conv_b"])
    xin, Bc, Cc = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])                 # (B, H)
    dA = torch.exp(dt * -torch.exp(p["a_log"]))
    xh = xin.reshape(B, H, P)
    dBx = torch.einsum("bn,bh,bhp->bhnp", Bc, dt, xh)
    h = cache["h"] * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cc, h) + p["D"][None, :, None] * xh
    y = _gated_out(p, y.reshape(B, d_inner), z, cfg, x.dtype)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_win[:, 1:])
    return y[:, None], cache
