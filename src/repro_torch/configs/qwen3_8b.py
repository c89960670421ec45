"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

The port's copy of the reference's ``repro.configs.qwen3_8b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1e6,
    qk_norm=True,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="qwen3-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, remat=False, q_chunk=32, kv_chunk=32,
)
