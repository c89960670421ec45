"""What every kernel wrapper of the port shares: the launch counters and
the checks made before a pointer reaches a kernel.

``LAUNCHES`` counts launches per kernel (one per wrapper call that launched
its kernel, none for a call that ran the plain version), so a run can show
that its path went through the kernels; the int kernels' float-carrier
instances count under ``<name>_f32``. A wrapper called while its stream
is being captured into a CUDA graph launches nothing yet: its launch is
held apart (:func:`take_captured`) and counted each time the graph is
replayed (:func:`add_launches`, called by whoever replays it).
"""

from __future__ import annotations

import torch

LAUNCHES = {"fir_mp_stream_cascade": 0, "fir_mp_stream_octave": 0,
            "fir_mp_oneshot_cascade": 0, "fir_mp_bank": 0, "fir_mp": 0,
            "fir_mp_stream_cascade_q": 0, "fir_mp_stream_octave_q": 0,
            "fir_mp_oneshot_cascade_q": 0, "fir_mp_bank_q": 0,
            "fir_mp_stream_cascade_q_f32": 0, "fir_mp_stream_octave_q_f32": 0,
            "fir_mp_oneshot_cascade_q_f32": 0, "fir_mp_bank_q_f32": 0,
            "mp_linear": 0, "mp_linear_bwd": 0, "mp_waterfill": 0,
            "slot_admit": 0}


_CAPTURED: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name`` by its wrapper: in ``LAUNCHES``,
    or, while the current stream is capturing a graph, among the graph's
    launches."""
    if torch.cuda.is_current_stream_capturing():
        _CAPTURED[name] = _CAPTURED.get(name, 0) + 1
    else:
        LAUNCHES[name] += 1


def take_captured() -> dict:
    """The launches counted during captures since the last call (kernel
    -> count), and forget them."""
    out = dict(_CAPTURED)
    _CAPTURED.clear()
    return out


def add_launches(counts: dict) -> None:
    """Count a replayed graph's launches (from :func:`take_captured`)."""
    for k, n in counts.items():
        LAUNCHES[k] += n


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors (all on one card), False for CPU ones; raises
    otherwise or on a mix."""
    devices = {t.device for t in tensors}
    if {d.type for d in devices} == {"cpu"}:
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    got = sorted(map(str, devices))
    raise ValueError(f"the port's kernels take all-CUDA (one card) or "
                     f"all-CPU tensors, got devices {got}")


def _expect(name: str, t: torch.Tensor, shape: tuple) -> None:
    """The kernels index by these shapes: refuse anything else before a
    pointer reaches them."""
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def _f32(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t.contiguous()


def _check(code: int, kernel: str, shapes: str) -> None:
    if code == -1:
        raise ValueError(f"{kernel}: shapes outside what the kernel takes "
                         f"({shapes})")
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError "
                           f"{code} ({shapes})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream
