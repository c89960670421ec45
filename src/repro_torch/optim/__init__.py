"""Optimizers of the port: AdamW as plain functions on tensors."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
