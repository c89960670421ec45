"""Sharding rules: FSDP(data) x TP(model) x DP(pod), by leaf name.

The counterpart of the reference's ``repro.distributed.sharding``, on
``torch.distributed``: a mesh is a ``DeviceMesh`` whose dims are named
(``("data", "model")`` or ``("pod", "data", "model")``), a spec is a
:class:`PartitionSpec` (one entry per tensor dim: a mesh axis name, a
tuple of them, or None), and :func:`to_placements` turns a spec into the
``DTensor`` placements of that mesh.

Every parameter leaf gets its spec from its *name* (the last string key of
its path): 2-D projection weights shard d_in over 'data' (FSDP) and d_out
over 'model' (TP), or the transpose for output projections (``_TRAILING``,
the reference's table). A dim is only sharded where its size divides the
axis size (:func:`sanitize`), so one table holds for every config and mesh.

The port keeps per-layer dicts where the reference stacks its layers on a
leading axis for ``lax.scan`` (``bridge`` converts), so a port leaf's spec
is the reference's spec of the stacked leaf with the leading stack ``None``
removed; decode caches likewise.

The spec functions read only a mesh's axis names and sizes
(:func:`axis_sizes`): a ``DeviceMesh``, a :class:`MeshAxes`, or anything
with ``axis_names`` and a ``shape`` mapping (a JAX mesh). The rest
(:func:`shard_tree`, :func:`shard_session`, :func:`gather_on_use`,
:func:`gather_ranks`) places and moves tensors and needs a ``DeviceMesh``
in an initialized process group.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["PartitionSpec", "P", "MeshAxes", "axis_sizes", "data_axes",
           "sanitize", "param_specs", "batch_specs", "cache_specs",
           "session_specs", "to_placements", "distribute", "shard_tree",
           "shard_session", "map_specs", "gather_on_use", "full_tensor",
           "gather_ranks", "data_shard",
           "is_dtensor", "tree_specs_by_path"]


# trailing-dims spec by parameter name; leading (stack) dims are unsharded
_TRAILING: dict = {
    # embeddings / heads
    "tok_embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "frame_proj": ("data", "model"),
    # attention projections
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    # mlp
    "wi_gate": ("data", "model"),
    "wi_up": ("data", "model"),
    "wi": ("data", "model"),
    # mamba
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "conv_w": (None, "model"),
    # moe
    "router": ("data", None),
    # biases that follow a 'model'-sharded output
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "bi": ("model",),
}


def _canon(entry):
    """One spec entry as the reference's ``PartitionSpec`` keeps it: a
    one-name tuple becomes the name."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: the reference's ``PartitionSpec``,
    whose ``str()`` it reproduces letter for letter (the checkpoint
    manifest stores it): ``PartitionSpec('data', None)``,
    ``PartitionSpec(('pod', 'data'),)``, ``PartitionSpec()``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec({repr(tuple(self))[1:-1]})"

    __str__ = __repr__


P = PartitionSpec


class MeshAxes(NamedTuple):
    """A mesh's axis names and sizes, without devices or processes."""
    axis_names: tuple
    sizes: tuple


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, a :class:`MeshAxes`, or
    an object with ``axis_names`` and a ``shape`` mapping."""
    if isinstance(mesh, MeshAxes):
        return dict(zip(mesh.axis_names, mesh.sizes))
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def data_axes(mesh) -> tuple:
    """The pure-DP axes: ('pod', 'data') on the multi-pod mesh."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def sanitize(spec: tuple, shape: tuple, mesh) -> PartitionSpec:
    """Drop sharding on dims whose size does not divide the axis size."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, axis in zip(shape, tuple(spec)
                         + (None,) * (len(shape) - len(spec))):
        if axis is not None and dim > 0 \
                and dim % _axis_size(sizes, axis) == 0:
            out.append(axis)
        else:
            out.append(None)
    return PartitionSpec(*out)


# -- trees --------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and
    NamedTuples (their field names are path keys); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and the congruent spec tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_specs(fn, getattr(tree, f),
                                      getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(map_specs(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def _ndim(leaf) -> int:
    return len(tuple(getattr(leaf, "shape", ())))


def _spec_for_leaf(path, leaf, mesh) -> PartitionSpec:
    name = next((k for k in reversed(path) if isinstance(k, str)), None)
    trailing = _TRAILING.get(name)
    nd = _ndim(leaf)
    if trailing is None or nd < len(trailing):
        return PartitionSpec()     # replicate (norm scales, small biases)
    spec = (None,) * (nd - len(trailing)) + tuple(trailing)
    return sanitize(spec, tuple(leaf.shape), mesh)


def param_specs(params, mesh):
    """A tree of :class:`PartitionSpec` congruent with ``params`` (or a
    whole ``TrainState``: the moments take their params' specs, scalars
    replicate). Leaves need only ``shape``."""
    return _map_with_path(lambda p, x: _spec_for_leaf(p, x, mesh), params)


def batch_specs(batch, mesh):
    """Inputs shard their batch dim over the DP axes, the rest replicate."""
    dp = data_axes(mesh)
    return _map_with_path(
        lambda _, x: sanitize((dp,) + (None,) * (_ndim(x) - 1),
                              tuple(x.shape), mesh), batch)


def cache_specs(cache, mesh):
    """Decode caches: batch over the DP axes, the long axis (attention
    positions / SSM heads) over 'model'. The port's caches are per layer
    (the reference's stacked ``(L, B, ...)`` leaf with its stack dim
    removed), so every leaf is ``(B, S/H, ...)``."""
    dp = data_axes(mesh)

    def spec(_, leaf):
        base = (dp, "model")
        return sanitize(base + (None,) * (_ndim(leaf) - len(base)),
                        tuple(leaf.shape), mesh)

    return _map_with_path(spec, cache)


def session_specs(state, mesh):
    """Slot-batched streaming state (a ``SessionState``, or any tree whose
    leaves lead with the slot axis S): S over the pure-DP axes, the rest
    replicated. Each slot is an independent stream, so the step needs no
    collective. Scalars, and an S the axes do not divide, replicate."""
    dp = data_axes(mesh)

    def spec(_, leaf):
        nd = _ndim(leaf)
        if nd == 0:
            return PartitionSpec()
        return sanitize((dp,) + (None,) * (nd - 1), tuple(leaf.shape), mesh)

    return _map_with_path(spec, state)


# -- placements ---------------------------------------------------------------


def to_placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` where the spec names that axis at tensor dim ``d`` (a
    tuple such as ``('pod', 'data')`` shards d over both, the first name
    outermost, which must be the mesh's own order), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    where: dict = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are "
                             f"not in the mesh's order {tuple(names)}")
        for a in axes:
            if a in where:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute(x, spec, mesh):
    """``x`` as a ``DTensor`` placed by ``spec`` on ``mesh`` (every rank
    passes the same full value). A 0-d tensor (a step counter), a leaf
    without a spec and anything not a tensor stay as they are."""
    if not isinstance(x, torch.Tensor) or x.ndim == 0 or spec is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.detach(), mesh, to_placements(spec, mesh))


def shard_tree(tree, specs, mesh):
    """``tree``'s leaves placed by the congruent ``specs`` on ``mesh``
    (:func:`distribute` each)."""
    return map_specs(lambda x, spec: distribute(x, spec, mesh), tree, specs)


def shard_session(state, mesh):
    """The session state with the slot axis sharded over the mesh's DP
    axes (:func:`session_specs`), as ``DTensor``s."""
    return shard_tree(state, session_specs(state, mesh), mesh)


def data_shard(mesh) -> tuple:
    """``(index, count)`` of this rank's shard of a dim split over the DP
    axes: the DP coordinates flattened, the first axis outermost."""
    sizes = axis_sizes(mesh)
    coord = dict(zip(sizes, mesh.get_coordinate()))
    index, count = 0, 1
    for a in data_axes(mesh):
        index = index * sizes[a] + coord[a]
        count *= sizes[a]
    return index, count


# -- collectives --------------------------------------------------------------


def _grad_placements(mesh) -> list:
    """What the gradient of a gathered weight is on each mesh dim: a
    partial sum over the DP axes (each rank fed its own rows), the same
    value on the others."""
    from torch.distributed.tensor import Partial, Replicate
    dp = data_axes(mesh)
    return [Partial() if a in dp else Replicate()
            for a in axis_sizes(mesh)]


def gather_on_use(x):
    """A ``DTensor`` weight gathered whole onto every rank, as a plain
    tensor (the MP product and the kernels take local tensors); anything
    else as it is. Its gradient is summed over the DP axes and lands on
    the weight's own shards (a reduce-scatter, or an all-reduce for a
    replicated weight)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    return full.to_local(grad_placements=_grad_placements(mesh))


def full_tensor(x) -> torch.Tensor:
    """A ``DTensor`` gathered whole as a plain tensor (waited on: numpy
    can read it); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    t = x.full_tensor()
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def gather_ranks(local: torch.Tensor, mesh) -> torch.Tensor:
    """Every mesh rank's ``local`` (the same shape on each), stacked as
    ``mesh.shape + local.shape`` by mesh coordinate. A tensor on another
    device than the mesh's goes through it (gloo ranks on one card)."""
    from torch.distributed.tensor import DTensor, Shard
    dev = local.device
    src = local.to(mesh.device_type)[None]
    full = DTensor.from_local(src, mesh, [Shard(0)] * mesh.ndim,
                              run_check=False).full_tensor()
    return full.reshape(tuple(mesh.shape) + tuple(local.shape)).to(dev)


def tree_specs_by_path(specs) -> dict:
    """``{leaf path: spec}`` of a spec tree, paths joined with ``/`` as
    the checkpoint manifest writes them."""
    out: dict = {}

    def walk(tree, path):
        if tree is None:
            return
        if isinstance(tree, PartitionSpec):
            out["/".join(str(p) for p in path)] = tree
        elif isinstance(tree, dict):
            for k in tree:
                walk(tree[k], path + (k,))
        elif _is_namedtuple(tree):
            for f in tree._fields:
                walk(getattr(tree, f), path + (f,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, path + (i,))

    walk(specs, ())
    return out
