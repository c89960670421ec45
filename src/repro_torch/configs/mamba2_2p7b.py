"""mamba2-2.7b [ssm] — attention-free, SSD (state-space duality).
[arXiv:2405.21060; unverified]

The port's copy of the reference's ``repro.configs.mamba2_2p7b``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,            # unused (attention-free)
    d_ff=0,                # no separate FFN: the mamba mixer is the block
    vocab_size=50280,
    use_rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,        # 5120 inner / 64 = 80 SSD heads
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke",
    num_layers=3, d_model=64, vocab_size=512, ssm_state=16, ssm_headdim=16,
    remat=False, ssm_chunk=32,
)
