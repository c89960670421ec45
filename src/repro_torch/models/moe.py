"""Mixture-of-Experts layer with capacity-based gather dispatch, in
PyTorch: the reference's ``repro.models.moe``.

Tokens are grouped (``moe_group_size``); each (group, expert) pair gets a
static capacity C = ceil(g K / E x capacity_factor) (None: no-drop, C = g).
Per group a stable sort of the token -> expert assignments makes each
expert's tokens contiguous, and they are gathered into a (G, E, C, D)
expert batch; overflowing assignments are dropped (their token keeps its
residual path only); under ``cfg.remat`` each chunk of
``moe_group_chunk`` groups is recomputed in the backward, as the
reference's chunk body is. The routed experts' SwiGLU and the router are
torch products, as the reference computes them outside its MP kernel;
the shared experts (DeepSeek-MoE) are one SwiGLU through
``layers.linear``, so in MP mode they run the CUDA ``mp_linear`` kernel.

Determinism, as the reference's:
  * selection rounds the router logits onto a 2^-10 grid
    (:func:`_route_scores`) and takes the top K by a stable descending
    sort, so equal scores pick the lowest expert ids (``lax.top_k`` is
    stable; ``torch.topk`` makes no such promise);
  * the combine sums each token's K weighted expert outputs in ascending
    expert order, one add after another, gathered back by (token, choice):
    no atomics, so two runs give the same bits (the reference's scatter-add
    adds a token's slots in that order).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L

__all__ = ["init_moe", "moe_block", "ROUTE_SNAP_BITS"]

# the reference's selection grid (repro.models.moe.ROUTE_SNAP_BITS)
ROUTE_SNAP_BITS = 10


def _route_scores(logits):
    """Selection scores floor(logits x 2^bits): ties break by expert id."""
    return torch.floor(logits * (2.0 ** ROUTE_SNAP_BITS))


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def stacked(d_in, d_out):
        return torch.stack([L.dense_init(gen, d_in, d_out) for _ in range(e)])

    p = {"router": L.dense_init(gen, d, e),
         "wi_gate": stacked(d, f),
         "wi_up": stacked(d, f),
         "wo": stacked(f, d)}
    if cfg.num_shared_experts:
        p["shared"] = L.init_swiglu(gen, d, f * cfg.num_shared_experts)
    return p


def capacity(cfg, g: int):
    """Slots per (group, expert) for groups of g tokens: the reference's C."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    if cfg.moe_capacity_factor is None:
        return g   # no-drop: a token lands on an expert at most once
    C = max(int(g * K / E * cfg.moe_capacity_factor), 1)
    if C > 16:
        C = -(-C // 8) * 8
    return min(C, g)


def route(p, xf, cfg):
    """(top_idx (T, K) long, gates (T, K) float32) for the tokens xf (T, D):
    the router in the reference's default bf16 product (it passes no
    compute dtype), K experts by the snapped scores, gates the softmax of
    their full-precision logits."""
    logits = L.linear(xf, p["router"]).float()                  # (T, E)
    K = cfg.num_experts_per_tok
    top_idx = torch.sort(_route_scores(logits), dim=-1, descending=True,
                         stable=True).indices[:, :K]
    gates = torch.softmax(torch.gather(logits, -1, top_idx), dim=-1)
    return top_idx, gates


def _expert_ffn(xe, wg, wu, wo):
    """xe (Gc, E, C, D) through each expert's SwiGLU in xe's dtype."""
    dt = xe.dtype
    h = torch.einsum("gecd,edf->gecf", xe, wg.to(dt))
    h = L.silu(h)
    h = h * torch.einsum("gecd,edf->gecf", xe, wu.to(dt))
    return torch.einsum("gecf,efd->gecd", h, wo.to(dt))


def moe_block(p, x, cfg):
    """x (B, S, D) -> (B, S, D). The capacity comes from
    ``cfg.moe_capacity_factor``: a float drops what overflows C, None
    keeps every assignment (decode, parity tests)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, D)
    g = min(cfg.moe_group_size, T)
    if T % g:
        raise ValueError(f"{T} tokens do not split into groups of {g}")
    G = T // g
    C = capacity(cfg, g)

    top_idx, gates = route(p, xf, cfg)
    eid = top_idx.reshape(G, g * K)          # flattened (token, choice)
    # stable sort by expert id; an assignment's rank within its expert is
    # its sorted position less the expert's start
    order = torch.argsort(eid, dim=-1, stable=True)
    sorted_eid = torch.gather(eid, 1, order)
    counts = torch.zeros(G, E, dtype=torch.long, device=x.device)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    starts = torch.cumsum(counts, 1) - counts
    rank = (torch.arange(g * K, device=x.device)[None]
            - torch.gather(starts, 1, sorted_eid))
    # slot in the (E * C) expert buffer; dropped -> the sentinel E * C
    slot_sorted = torch.where(rank < C, sorted_eid * C + rank, E * C)
    slot = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    tok_of = torch.arange(g, device=x.device).repeat_interleave(K)
    # each slot's token (token 0 in empty slots, whose output nobody takes)
    buf_tok = torch.zeros(G, E * C + 1, dtype=torch.long, device=x.device)
    buf_tok.scatter_(1, slot, tok_of.expand(G, -1).contiguous())
    buf_tok = buf_tok[:, :E * C]

    gate_c = gates.reshape(G, g, K).to(x.dtype)
    slot_c = slot.reshape(G, g, K)
    # a token's choices in ascending expert order: the order of its adds
    asc = torch.argsort(top_idx.reshape(G, g, K), dim=-1)
    gate_c, slot_c = gate_c.gather(2, asc), slot_c.gather(2, asc)
    xg = xf.reshape(G, g, D)

    def run_groups(xg_c, tok_c, slot_cc, gate_cc):
        """A chunk of groups: gather each slot's token, the experts' FFNs,
        each token's K weighted outputs summed in ascending expert order."""
        xe = torch.gather(xg_c, 1, tok_c[..., None].expand(-1, -1, D))
        ye = _expert_ffn(xe.reshape(-1, E, C, D), p["wi_gate"], p["wi_up"],
                         p["wo"]).reshape(-1, E * C, D)
        ye = torch.cat([ye, ye.new_zeros(ye.shape[0], 1, D)], dim=1)
        picked = torch.gather(
            ye, 1, slot_cc.reshape(ye.shape[0], g * K, 1).expand(-1, -1, D)
        ).reshape(-1, g, K, D) * gate_cc[..., None]
        yg = picked[:, :, 0]
        for k in range(1, K):
            yg = yg + picked[:, :, k]
        return yg

    gchunk = max(min(cfg.moe_group_chunk, G), 1)
    if G % gchunk:
        gchunk = 1
    # more than one chunk: under cfg.remat each chunk's body is recomputed
    # in the backward (the reference's jax.checkpoint of its lax.map body),
    # so the gathered (Gc, E, C, D) tokens are not kept per chunk
    body = L.remat(run_groups, cfg) if gchunk < G else run_groups
    out = [body(xg[c0:c0 + gchunk], buf_tok[c0:c0 + gchunk],
                slot_c[c0:c0 + gchunk], gate_c[c0:c0 + gchunk])
           for c0 in range(0, G, gchunk)]
    y = torch.cat(out).reshape(B, S, D)
    if cfg.num_shared_experts:
        y = y + L.swiglu(p["shared"], x, cfg)
    return y.to(x.dtype)
