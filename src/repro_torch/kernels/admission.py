"""Wrapper of the serving tier's slot-admission kernel.

``slot_admit`` — ``csrc/slot_admit.cu``: a wave's admissions, one code
per slot, written into the slot-batched registers in one launch
(``serving.StreamServer`` stages the codes that its ``open`` / ``close``
left since the last wave and applies them before the step's replay).

Codes (uint8): 0 leaves the slot as it is; ``OFF`` (1) clears its
admission mask (a close); ``RESET`` (2) zeroes every register of its row
and sets the mask (an open of a fresh session); ``RESET | OFF`` (3) zeroes
the row and clears the mask (an open and a close since the last apply).

As for the other kernels: a CUDA tensor launches the kernel on the
current stream and counts the launch in ``kernels._wrap.LAUNCHES``; a CPU
tensor runs the plain version (``ref.slot_admit``); anything else raises.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._wrap import (_check, _expect, _on_cuda, _stream,
                                       count_launch)

__all__ = ["OFF", "RESET", "slot_admit"]

OFF, RESET = 1, 2
_WORDS = (torch.float32, torch.int32)   # registers the kernel zeroes


def slot_admit(regs, active: torch.Tensor, codes: torch.Tensor) -> None:
    """Apply ``codes`` (S,) uint8 to the registers ``regs`` (each (S, ...)
    float32 or int32, contiguous) and the mask ``active`` (S,) bool, IN
    PLACE (see the module docstring)."""
    if not _on_cuda(active, codes, *regs):
        ref.slot_admit(regs, active, codes)
        return
    from repro_torch.kernels._build import load
    S = active.shape[0]
    _expect("codes", codes, (S,))
    if codes.dtype != torch.uint8 or active.dtype != torch.bool \
            or not (codes.is_contiguous() and active.is_contiguous()):
        raise TypeError(f"codes must be contiguous uint8 and active "
                        f"contiguous bool, got {codes.dtype} and "
                        f"{active.dtype}")
    table = []
    for k, t in enumerate(regs):
        if t.dtype not in _WORDS or not t.is_contiguous() or t.ndim < 1 \
                or t.shape[0] != S:
            raise ValueError(f"regs[{k}] must be a contiguous (S={S}, ...) "
                             f"float32 or int32 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        table.append((t.data_ptr(), t.numel() // S))
    rows = np.asarray(table, np.int64).reshape(len(table), 2)
    code = load("slot_admit")(codes.data_ptr(), rows.ctypes.data,
                              len(table), active.data_ptr(), S, _stream())
    _check(code, "slot_admit", f"S={S} registers={len(table)}")
    count_launch("slot_admit")
