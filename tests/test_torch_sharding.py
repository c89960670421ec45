"""The port's sharding rules against the reference's, with no processes.

The reference's spec functions read only a mesh's ``axis_names`` and its
``shape`` mapping, so a stand-in with those two serves on meshes of any
shape; the port's take a ``sharding.MeshAxes``. For every leaf of
``init`` of each architecture's smoke config, of its decode cache and of
the esc10-mp ``SessionState``, the port's spec and the reference's print
the same (``str`` for ``str``, as the checkpoint manifest stores them) on
``(1, 1)``, ``(2, 2)`` and ``(3, 2)`` meshes over ("data", "model") and a
``(2, 2, 2)`` one over ("pod", "data", "model"); ``(3, 2)`` and capacity 6
on ``(2, 2, 2)`` make ``sanitize`` drop dims. The port keeps per-layer
lists where the reference stacks layers on a leading axis, so a per-layer
leaf is held against the stacked leaf's spec with its leading ``None``
removed. ``to_placements`` is held against the same specs.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCH_NAMES, get_smoke as ref_smoke
from repro.core import pipeline as pl_ref
from repro.distributed import sharding as rsh
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.configs import esc10_mp
from repro_torch.configs import get_smoke
from repro_torch.distributed import sharding as sh
from repro_torch.models import transformer as T

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 2)),
          (("data", "model"), (3, 2)), (("pod", "data", "model"), (2, 2, 2))]
_CACHE: dict = {}


class RefMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def meshes(names, sizes):
    return RefMesh(names, sizes), sh.MeshAxes(tuple(names), tuple(sizes))


def ref_by_path(specs) -> dict:
    """``{path: PartitionSpec}`` of a reference spec tree, paths as the
    port's ``tree_specs_by_path`` joins them."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        keys = []
        for e in path:
            for attr in ("key", "name", "idx"):
                if hasattr(e, attr):
                    keys.append(str(getattr(e, attr)))
                    break
        out["/".join(keys)] = spec
    return out


STACKED = {"layers": 1, "scan": 1, "period_layers": 2, "periodic": 2}


def ref_key(path: str) -> tuple:
    """The reference's path of a port leaf, and whether its spec lost a
    leading stack dim: ``layers/3/attn/wq`` -> ``layers/attn/wq``;
    ``period_layers/1/0/...`` -> ``period_layers/1/...``."""
    parts = path.split("/")
    keep = STACKED.get(parts[0])
    if keep is None:
        return path, False
    return "/".join(parts[:keep] + parts[keep + 1:]), True


def unstack(spec):
    """The reference's stacked-leaf spec with the stack dim removed."""
    assert spec[0] is None if len(spec) else True
    return jax.sharding.PartitionSpec(*tuple(spec)[1:])


def assert_same_specs(port_specs, ref_specs, what):
    want = ref_by_path(ref_specs)
    got = sh.tree_specs_by_path(port_specs)
    seen = set()
    for path, spec in got.items():
        key, stacked = ref_key(path)
        assert key in want, f"{what}: {path} has no reference leaf"
        ref = unstack(want[key]) if stacked else want[key]
        assert str(spec) == str(ref), f"{what}: {path}: {spec} vs {ref}"
        seen.add(key)
    assert seen == set(want), f"{what}: unmatched {set(want) - seen}"
    return got


def assert_placements(specs: dict, names, sizes):
    """``to_placements`` shards exactly the dims the spec names."""
    for path, spec in specs.items():
        pl = sh.to_placements(spec, sh.MeshAxes(tuple(names), tuple(sizes)))
        for axis, p in zip(names, pl):
            dims = [d for d, e in enumerate(spec)
                    if axis == e or (isinstance(e, tuple) and axis in e)]
            assert p == (Shard(dims[0]) if dims else Replicate()), \
                (path, spec, axis, p)


def arch(name):
    if name not in _CACHE:
        rc = ref_smoke(name)
        ref = jax.eval_shape(lambda: RT.init(rc, jax.random.PRNGKey(0)))
        pc = get_smoke(name)
        port = T.init(pc, torch.Generator().manual_seed(0), device="cpu")
        caches = None
        if pc.supports_decode:
            caches = (jax.eval_shape(lambda: RT.init_cache(rc, 2, 8)),
                      T.init_cache(pc, 2, 8, device="cpu"))
        _CACHE[name] = (ref, port, caches)
    return _CACHE[name]


@pytest.mark.parametrize("names,sizes", MESHES)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_and_cache_specs_match_reference(name, names, sizes):
    ref, port, caches = arch(name)
    rm, pm = meshes(names, sizes)
    got = assert_same_specs(sh.param_specs(port, pm),
                            rsh.param_specs(ref, rm), f"{name} params")
    assert_placements(got, names, sizes)
    if caches is not None:
        got = assert_same_specs(sh.cache_specs(caches[1], pm),
                                rsh.cache_specs(caches[0], rm),
                                f"{name} cache")
        assert_placements(got, names, sizes)


@pytest.mark.parametrize("capacity", [6, 12])
@pytest.mark.parametrize("names,sizes", MESHES)
def test_session_and_batch_specs_match_reference(names, sizes, capacity):
    if "session" not in _CACHE:
        _CACHE["session"] = esc10_mp.make_pipeline(device="cpu")
    state = _CACHE["session"].init_session(capacity)
    ref_state = pl_ref.SessionState(*bridge.session_to_numpy(state))
    rm, pm = meshes(names, sizes)
    got = sh.session_specs(state, pm)
    assert type(got) is type(state)
    got = assert_same_specs(got, rsh.session_specs(ref_state, rm), "session")
    assert_placements(got, names, sizes)
    dp = sh.data_axes(pm)
    shards = int(np.prod([dict(zip(names, sizes))[a] for a in dp]))
    assert (str(got["acc"]) == "PartitionSpec(None, None)") \
        == (capacity % shards != 0)
    batch = {"tokens": np.zeros((capacity, 16), np.int32),
             "patches": np.zeros((capacity, 4, 8), np.float32)}
    assert_same_specs(sh.batch_specs(batch, pm),
                      rsh.batch_specs(batch, rm), "batch")


def test_partition_spec_prints_as_the_reference():
    P = jax.sharding.PartitionSpec
    for entries in [(), (None,), ("data", None), (("data",), None),
                    (("pod", "data"),), (None, "data", "model"),
                    (("pod", "data"), "model", None)]:
        assert str(sh.PartitionSpec(*entries)) == str(P(*entries))
    assert sh.P(("data",), None) == ("data", None)
    with pytest.raises(ValueError, match="order"):
        sh.to_placements(sh.P(("data", "pod")),
                         sh.MeshAxes(("pod", "data", "model"), (2, 2, 2)))
    assert sh.to_placements(
        sh.P(("pod", "data"), "model"),
        sh.MeshAxes(("pod", "data", "model"), (2, 2, 2))) == \
        [Shard(0), Shard(0), Shard(1)]
