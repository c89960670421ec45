"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
on alternate FFNs. [arXiv:2403.19887; hf]

The port's copy of the reference's ``repro.configs.jamba_v0p1_52b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    use_rope=False,        # Jamba uses no positional encoding (Mamba carries order)
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    moe_every=2,           # MoE on every 2nd sublayer of the period
    attn_every=8,          # 1 attention + 7 mamba per period
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,        # 8192 inner / 64 = 128 SSD heads
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="jamba-smoke",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, num_experts=4, num_experts_per_tok=2, moe_d_ff=128,
    attn_every=4, ssm_state=8, ssm_headdim=16, remat=False,
    q_chunk=32, kv_chunk=32, ssm_chunk=32,
)
