"""hubert-xlarge [audio] — encoder-only; conv feature frontend is a STUB
(precomputed frame embeddings); masked-unit prediction head over 504
clusters. [arXiv:2106.07447; unverified]

The port's copy of the reference's ``repro.configs.hubert_xlarge``: the same
fields, on the port's ``ArchConfig``."""

import dataclasses

from repro_torch.models.transformer import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    use_rope=False,        # HuBERT uses conv positional embedding (in the stub)
    is_encoder=True,
    norm="ln",
    audio_frontend=True,
)

SMOKE = dataclasses.replace(
    CONFIG, head_dim=0, name="hubert-smoke",
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=64, remat=False, q_chunk=32, kv_chunk=32,
)
