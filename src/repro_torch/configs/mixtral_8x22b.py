"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]

The port's copy of the reference's ``repro.configs.mixtral_8x22b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    rope_theta=1e6,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=16384,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="mixtral-smoke",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, d_ff=128,
    vocab_size=512, sliding_window=16, num_experts=4, num_experts_per_tok=2,
    moe_d_ff=128, remat=False, q_chunk=32, kv_chunk=32,
)
