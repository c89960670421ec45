"""glm4-9b [dense] — RoPE, aggressive GQA (kv=2). [hf:THUDM/glm-4-9b; hf]

The port's copy of the reference's ``repro.configs.glm4_9b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e4,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="glm4-smoke",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, d_ff=128,
    vocab_size=512, remat=False, q_chunk=32, kv_chunk=32,
)
