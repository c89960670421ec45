"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6,
first layer dense. [arXiv:2401.06066; hf]

The port's copy of the reference's ``repro.configs.deepseek_moe_16b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,            # the single leading dense-FFN layer
    vocab_size=102400,
    rope_theta=1e4,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="deepseek-moe-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
    vocab_size=512, num_experts=8, num_experts_per_tok=2,
    num_shared_experts=1, moe_d_ff=32, first_dense_layers=1, remat=False,
    q_chunk=32, kv_chunk=32,
)
