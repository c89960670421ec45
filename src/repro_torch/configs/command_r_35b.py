"""command-r-35b [dense] — GQA, no biases, large vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]

The port's copy of the reference's ``repro.configs.command_r_35b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=1e4,
    tie_embeddings=True,   # command-r ties input/output embeddings
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="command-r-smoke",
    num_layers=3, d_model=64, num_heads=8, num_kv_heads=2, d_ff=128,
    vocab_size=512, remat=False, q_chunk=32, kv_chunk=32,
)
