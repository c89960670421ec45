"""qwen2-72b [dense] — GQA, QKV bias. [arXiv:2407.10671; hf]

The port's copy of the reference's ``repro.configs.qwen2_72b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1e6,
    qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="qwen2-smoke",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, d_ff=160,
    vocab_size=512, remat=False, q_chunk=32, kv_chunk=32,
)
