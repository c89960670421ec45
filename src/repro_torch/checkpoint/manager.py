"""Checkpoints on disk, in the reference's format.

The counterpart of ``repro.checkpoint.manager``: a directory holds

* step-indexed checkpoints ``step_XXXXXXXX/`` (``save`` / ``restore`` /
  ``all_steps`` / ``latest_step``), written by a background thread after
  the leaves are copied to the host, published by renaming
  ``step_XXXXXXXX.tmp/``, with keep-last-k garbage collection;
* named objects ``named_<name>/`` (``save_named`` / ``restore_named`` /
  ``has_named`` / ``delete_named``): small synchronous snapshots, the
  serving tier's parked sessions (one slot's registers plus its decision
  history as ``meta``). A new version is published by moving the old one
  to ``.old`` first, so a crash at any point leaves the old or the new
  object under the name, never neither.

Each checkpoint is ``manifest.json`` plus ``leaf_00000.npy``, ... in the
order of a tree walk of the state, each leaf addressed by its path: the
fields of a NamedTuple by name, sequence items by index, dict entries by
key in sorted order (``delays/0`` ... ``active`` for a ``SessionState``),
as ``jax.tree_util`` names them. So either package restores what the
other saved. ``restore_named`` refuses a shape or dtype mismatch (a named
object promises a bit-exact resume).

Under a mesh (``save(..., mesh=, specs=)``, one process per rank) every
rank gathers the ``DTensor`` leaves whole and rank 0 alone writes; the
manifest records ``mesh_shape``, ``mesh_axes`` and each leaf's ``spec`` as
the reference's ``str(PartitionSpec(...))``. ``restore(..., mesh=,
specs=)`` places each leaf with ``distribute_tensor`` under the given
mesh's placements, whatever mesh wrote it (elastic resume). ``wait()``
after a save under a mesh holds every rank until rank 0's files are
published.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as sh

__all__ = ["CheckpointManager"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=()) -> list:
    """``[(path, leaf), ...]`` in the reference's leaf order; None is an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k],
                                                            path + (k,))]
    if _is_namedtuple(tree):
        return [kv for name in tree._fields
                for kv in _flatten(getattr(tree, name), path + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _to_host(x) -> np.ndarray:
    x = sh.full_tensor(x)
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint leaves must have a numpy dtype; "
                            "bfloat16 tensors are not stored")
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _np_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty((), dtype=like.dtype).numpy().dtype
    return np.asarray(like).dtype


def _place(arr: np.ndarray, like):
    """A loaded leaf in the kind of ``like``: a tensor on its device, or a
    numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    return arr


def _host_leaves(state) -> list:
    return [(_path_str(p), _to_host(x)) for p, x in _flatten(state)]


def _check_mesh(mesh, specs) -> None:
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch DeviceMesh, got "
                            f"{type(mesh).__name__}")
    if (mesh is None) != (specs is None):
        raise ValueError("pass mesh= and specs= together")


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """Step-indexed and named checkpoints under ``directory``."""

    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._barrier = False        # a save under a mesh not yet awaited
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any, mesh=None, specs=None) -> str:
        """Copy ``state``'s leaves to the host (the only blocking part),
        then write them, on a background thread unless ``async_save`` is
        off. One save is in flight at a time. Under ``mesh`` (with its
        ``specs``, a tree of ``sharding.PartitionSpec``) every rank calls
        it: ``DTensor`` leaves are gathered whole and rank 0 writes."""
        _check_mesh(mesh, specs)
        host_leaves = _host_leaves(state)
        spec_of = sh.tree_specs_by_path(specs) if specs is not None else {}
        manifest = {
            "step": int(step),
            "time": time.time(),
            "mesh_shape": list(mesh.shape) if mesh is not None else None,
            "mesh_axes": (list(mesh.mesh_dim_names) if mesh is not None
                          else None),
            "leaves": [{"path": p, "shape": list(a.shape),
                        "dtype": str(a.dtype),
                        "spec": (str(spec_of[p]) if p in spec_of
                                 else None)}
                       for p, a in host_leaves],
        }
        self.wait()
        self._barrier = mesh is not None and dist.is_initialized()
        if not _writer():
            return self._step_dir(step)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, manifest),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, manifest)
        return self._step_dir(step)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    @staticmethod
    def _write_dir(tmp: str, host_leaves, manifest) -> None:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (_, arr) in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    def _write(self, step: int, host_leaves, manifest) -> None:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        self._write_dir(tmp, host_leaves, manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic publish
        self._gc()

    def wait(self) -> None:
        """Block until the save in flight (if any) is on disk; after a
        save under a mesh, on every rank (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- named objects (parked serving sessions) ------------------------------

    @staticmethod
    def _check_name(name: str) -> str:
        if not name or not all(ch.isalnum() or ch in "-_." for ch in name):
            raise ValueError(f"checkpoint name {name!r}: use [A-Za-z0-9._-]")
        return name

    def _named_dir(self, name: str) -> str:
        return os.path.join(self.dir, f"named_{self._check_name(name)}")

    def _resolve_named(self, name: str) -> Optional[str]:
        """The directory holding ``name``: the published one, or ``.old``
        when a crash landed mid-publish."""
        d = self._named_dir(name)
        if os.path.isdir(d):
            return d
        if os.path.isdir(d + ".old"):
            return d + ".old"
        return None

    def has_named(self, name: str) -> bool:
        return self._resolve_named(name) is not None

    def save_named(self, name: str, state: Any,
                   meta: Optional[dict] = None) -> str:
        """Persist a small tree under ``name``, synchronously; ``meta`` is
        JSON-serializable side data (a session's decision history)."""
        host_leaves = _host_leaves(state)
        manifest = {
            "name": name,
            "time": time.time(),
            "meta": meta,
            "leaves": [{"path": p, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for p, a in host_leaves],
        }
        final = self._named_dir(name)
        self._write_dir(final + ".tmp", host_leaves, manifest)
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(final + ".tmp", final)     # atomic publish
        if os.path.exists(old):
            shutil.rmtree(old)
        return final

    def _load(self, d: str, state_like, what: str, check_dtype: bool,
              mesh=None, specs=None):
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {leaf["path"]: i
                   for i, leaf in enumerate(manifest["leaves"])}
        spec_of = sh.tree_specs_by_path(specs) if specs is not None else {}
        new_leaves = []
        for p, like in _flatten(state_like):
            key = _path_str(p)
            if key not in by_path:
                raise KeyError(f"{what} missing leaf {key}")
            arr = np.load(os.path.join(d, f"leaf_{by_path[key]:05d}.npy"))
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs expected "
                                 f"{tuple(like.shape)}")
            if check_dtype and arr.dtype != _np_dtype(like):
                # a silent cast would break the bit-exact resume
                raise ValueError(f"dtype mismatch for {key}: ckpt "
                                 f"{arr.dtype} vs expected "
                                 f"{_np_dtype(like)}")
            if mesh is None:
                new_leaves.append(_place(arr, like))
                continue
            dev = (like.device if isinstance(like, torch.Tensor)
                   else mesh.device_type)
            new_leaves.append(sh.distribute(torch.from_numpy(arr).to(dev),
                                            spec_of.get(key), mesh))
        return _unflatten(state_like, iter(new_leaves)), manifest

    def restore_named(self, name: str, state_like: Any):
        """Load ``name`` into the structure of ``state_like`` (tensor
        leaves land on their device). Returns ``(state, meta)``."""
        d = self._resolve_named(name)
        if d is None:
            raise FileNotFoundError(f"no named checkpoint {name!r} in "
                                    f"{self.dir}")
        state, manifest = self._load(d, state_like,
                                     f"named checkpoint {name!r}", True)
        return state, manifest.get("meta")

    def delete_named(self, name: str) -> None:
        shutil.rmtree(self._named_dir(name), ignore_errors=True)
        shutil.rmtree(self._named_dir(name) + ".old", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                mesh=None, specs=None) -> tuple:
        """Restore into the structure of ``state_like``: the latest step
        unless ``step`` is given. Leaves keep the checkpoint's dtype, as in
        the reference. With ``mesh`` and ``specs`` every tensor leaf but a
        0-d one becomes a ``DTensor`` placed by its spec on that mesh,
        whatever mesh wrote the checkpoint (every rank reads the files).
        Returns ``(state, step)``."""
        _check_mesh(mesh, specs)
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        state, _ = self._load(d, state_like, f"checkpoint {d}", False,
                              mesh, specs)
        return state, step
