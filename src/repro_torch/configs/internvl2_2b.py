"""internvl2-2b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-style backbone. [arXiv:2404.16821; hf]

The port's copy of the reference's ``repro.configs.internvl2_2b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1e6,
    vlm_patches=1024,      # stub InternViT: (B, 1024, d_model) patch embeds
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="internvl2-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, vlm_patches=8, remat=False, q_chunk=32, kv_chunk=32,
)
