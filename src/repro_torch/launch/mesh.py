"""Meshes over the ranks of a ``torch.distributed`` process group.

The counterpart of the reference's ``repro.launch.mesh``. One process per
rank (SPMD): under ``torchrun`` the group starts from the environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...); with no group and no such
environment, :func:`ensure_process_group` starts a one-rank group (``nccl``
on the card, ``gloo`` on the CPU) over a ``file://`` store in a temporary
directory, so nothing listens on a port.

    mesh = make_host_mesh(data=2, model=1)      # ("data", "model")
    mesh = make_production_mesh((2, 16, 16))    # ("pod", "data", "model")
"""

from __future__ import annotations

import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["ensure_process_group", "make_host_mesh", "make_production_mesh",
           "HW"]


def ensure_process_group(device=None) -> None:
    """Start the default process group if there is none: from the
    environment under ``torchrun``, else a one-rank group (``nccl`` for
    ``cuda``, ``gloo`` otherwise) on a ``file://`` store. On the card each
    rank takes the device of its ``LOCAL_RANK``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
        return
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                            world_size=1)


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import DeviceMesh
    ensure_process_group(device)
    dev = resolve_device(device)
    n = math.prod(shape)
    ranks = torch.arange(n, dtype=torch.int64).reshape(shape)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``("data", "model")`` mesh over the first ``data * model`` ranks,
    its sizes clamped to the world as the reference clamps them to the
    devices it sees: ``data`` to the world size, ``model`` to what is left.
    ``device``: ``cuda`` (default) or ``cpu``."""
    ensure_process_group(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh((data, model), ("data", "model"), device)


def make_production_mesh(shape: tuple = (2, 16, 16), device=None):
    """``("pod", "data", "model")`` over the whole world with ``shape``
    (``("data", "model")`` for a 2-tuple); its product must be the world
    size."""
    ensure_process_group(device)
    shape = tuple(int(s) for s in shape)
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(shape))
    if names is None:
        raise ValueError(f"mesh shape {shape}: want (data, model) or "
                         "(pod, data, model)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the world has {dist.get_world_size()}")
    return _mesh(shape, names, device)


class HW:
    """The card's constants for the dry run's roofline
    (``launch.dryrun.roofline``), from NVIDIA's H100 SXM5 80 GB data sheet
    (dense rates, no sparsity, at its 700 W power limit): data-sheet
    figures, not measurements. A card set below 700 W runs slower."""
    PEAK_FLOPS_BF16 = 989e12      # bf16 tensor cores, dense, per card
    HBM_BW = 3.35e12              # HBM3 bytes/s per card
    # the card's memory as torch reports it (total_memory of an NVIDIA
    # H100 80GB HBM3, 700 W, as chip_smoke.py prints it)
    HBM_BYTES = 85_017_493_504
    NVLINK_BW = 450e9             # NVLink 4, bytes/s per card per
                                  # direction (900 GB/s both ways), inside
                                  # an 8-card node
    NET_BW = 50e9                 # between nodes: one 400 Gb/s NIC per
                                  # card, bytes/s per direction
