"""Shape stand-ins for every (arch x shape) cell: the counterpart of the
reference's ``repro.launch.specs``.

Nothing here allocates: every tensor is a fake tensor of a
``torch._subclasses.fake_tensor.FakeTensorMode`` (pass one ``mode`` to
every call whose tensors meet, as ``launch.dryrun`` does; a call without
one makes its own). The same specs drive the dry run (``launch.dryrun``:
one traced step per cell under a fake process group), its roofline and
the cell table.

    cell = SHAPES["train_4k"]
    ins = input_specs(cfg, cell, mode)     # {"batch": {...}} of fakes
    state = state_specs(cfg, mode)         # TrainState of fakes
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T

__all__ = ["SHAPES", "ShapeCell", "input_specs", "state_specs",
           "params_specs", "cache_len_for", "cell_table", "runnable_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def _mode(mode):
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode() if mode is None else mode


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="cpu")


def _fwd_batch_specs(cfg: T.ArchConfig, B: int, S: int, with_labels: bool):
    """Batch stand-ins for a full-sequence pass (train / prefill)."""
    if cfg.audio_frontend:
        b = {"frames": _empty((B, S, cfg.d_model), torch.bfloat16)}
        if with_labels:
            b["labels"] = _empty((B, S), torch.int32)
        return b
    if cfg.vlm_patches:
        return {"tokens": _empty((B, S - cfg.vlm_patches), torch.int32),
                "patches": _empty((B, cfg.vlm_patches, cfg.d_model),
                                  torch.bfloat16)}
    return {"tokens": _empty((B, S), torch.int32)}


def cache_len_for(cfg: T.ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def input_specs(cfg: T.ArchConfig, shape: ShapeCell, mode=None,
                batch: int | None = None) -> dict:
    """Fake inputs of the cell's step: ``{"batch": ...}`` for train and
    prefill, ``{"tokens", "cache", "cur_pos"}`` for decode (one new token
    against a cache of the cell's length). ``batch`` overrides the cell's
    global batch (a rank's share of it)."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len
    with _mode(mode):
        if shape.kind == "train":
            return {"batch": _fwd_batch_specs(cfg, B, S, with_labels=True)}
        if shape.kind == "prefill":
            return {"batch": _fwd_batch_specs(cfg, B, S, with_labels=False)}
        return {"tokens": _empty((B, 1), torch.int32),
                "cache": T.init_cache(cfg, B, cache_len_for(cfg, S),
                                      device="cpu"),
                "cur_pos": _empty((B,), torch.int32)}


def params_specs(cfg: T.ArchConfig, mode=None) -> dict:
    """The f32 master params as fakes (``T.init`` traced, not run)."""
    with _mode(mode):
        return T.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def state_specs(cfg: T.ArchConfig, mode=None):
    """A fake TrainState (params, AdamW moments, step)."""
    from repro_torch.distributed.steps import TrainState
    from repro_torch.optim.adamw import adamw_init
    mode = _mode(mode)
    params = params_specs(cfg, mode)
    with mode:
        return TrainState(params=params, opt=adamw_init(params),
                          step=torch.zeros((), dtype=torch.int32))


# ---------------------------------------------------------------------------
# cell enumeration with documented skips
# ---------------------------------------------------------------------------


def cell_table(cfg: T.ArchConfig):
    """[(shape_name, status, reason)] for one arch. status: run | skip."""
    rows = []
    for name, cell in SHAPES.items():
        if cell.kind == "decode" and not cfg.supports_decode:
            rows.append((name, "skip", "encoder-only: no decode step"))
        elif name == "long_500k" and not cfg.subquadratic:
            rows.append((name, "skip",
                         "pure full attention: 512k dense decode does not "
                         "fit HBM; arch defines no sparse variant"))
        else:
            rows.append((name, "run", ""))
    return rows


def runnable_cells(cfg: T.ArchConfig):
    return [name for name, status, _ in cell_table(cfg) if status == "run"]
