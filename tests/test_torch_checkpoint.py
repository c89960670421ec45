"""The port's CheckpointManager against the reference's, on the CPU.

Both write ``manifest.json`` plus ``leaf_00000.npy``... with the same leaf
paths for the same tree, so each package restores what the other saved:
named objects (a parked session's registers and history) and step-indexed
checkpoints alike. The refusals (shape, dtype, missing leaf, bad name)
raise what the reference raises. A step checkpoint saved under a mesh
(one gloo rank here) restores as without one and records the mesh.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.core import pipeline as pl_ref
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as pl
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_host_mesh
from torch_mesh_ranks import one_rank_group


def _session(numerics, seed=0, S=3, T1=15, octaves=3, P=9):
    """A SessionState of random registers as numpy leaves."""
    rng = np.random.default_rng(seed)
    reg = ((lambda *s: rng.integers(-500, 500, s).astype(np.int32))
           if numerics == "fixed" else
           (lambda *s: rng.standard_normal(s).astype(np.float32)))
    i32 = lambda *s: rng.integers(0, 10 ** 6, s).astype(np.int32)  # noqa
    return (tuple(reg(S, T1) for _ in range(octaves)),
            tuple(i32(S) for _ in range(octaves)), reg(S, P), reg(S),
            i32(S), rng.random(S) < 0.5)


def _port_row(leaves, slot=1):
    return pl.take_slot(bridge.session_from_numpy(leaves, device="cpu"), slot)


def _ref_row(leaves, slot=1):
    d, c, acc, amax, count, active = leaves
    state = pl_ref.SessionState(tuple(map(jnp.asarray, d)),
                                tuple(map(jnp.asarray, c)), jnp.asarray(acc),
                                jnp.asarray(amax), jnp.asarray(count),
                                jnp.asarray(active))
    return pl_ref.take_slot(state, slot)


def _leaves_equal(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("numerics", ["float", "fixed"])
@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_named_session_rows_cross_packages(numerics, saved_by, tmp_path):
    leaves = _session(numerics)
    port_row, ref_row = _port_row(leaves), _ref_row(leaves)
    meta = {"samples_seen": 160, "history": [[100, 2, 0.0625],
                                             [160, 2, 0.125]]}
    if saved_by == "reference":
        RefManager(str(tmp_path)).save_named("session-mic", ref_row, meta)
        row, got_meta = CheckpointManager(str(tmp_path)).restore_named(
            "session-mic", pl.take_slot(
                bridge.session_from_numpy(_session(numerics, 1),
                                          device="cpu"), 0))
        assert isinstance(row, pl.SessionState)
        assert all(isinstance(t, torch.Tensor) for t in row.tensors())
    else:
        CheckpointManager(str(tmp_path)).save_named("session-mic", port_row,
                                                    meta)
        row, got_meta = RefManager(str(tmp_path)).restore_named(
            "session-mic", _ref_row(_session(numerics, 1), 0))
    assert got_meta == meta
    _leaves_equal(row, ref_row)
    # one layout: the same paths, shapes and dtypes in the same order
    mine = str(tmp_path / "mine")
    theirs = str(tmp_path / "theirs")
    CheckpointManager(mine).save_named("x", port_row)
    RefManager(theirs).save_named("x", ref_row)
    assert _manifest(os.path.join(mine, "named_x"))["leaves"] == \
        _manifest(os.path.join(theirs, "named_x"))["leaves"]
    paths = [leaf["path"] for leaf in
             _manifest(os.path.join(mine, "named_x"))["leaves"]]
    assert paths == ["delays/0", "delays/1", "delays/2", "consumed/0",
                     "consumed/1", "consumed/2", "acc", "amax", "count",
                     "active"]


def test_named_publish_recovery_and_delete(tmp_path):
    m = CheckpointManager(str(tmp_path))
    row = _port_row(_session("float"))
    assert not m.has_named("a")
    m.save_named("a", row, {"v": 1})
    m.save_named("a", row, {"v": 2})                 # republish
    assert sorted(os.listdir(tmp_path)) == ["named_a"]
    assert m.restore_named("a", row)[1] == {"v": 2}
    # a crash between the two renames leaves only the .old version
    os.rename(tmp_path / "named_a", tmp_path / "named_a.old")
    assert m.has_named("a") and m.restore_named("a", row)[1] == {"v": 2}
    m.delete_named("a")
    assert not m.has_named("a") and os.listdir(tmp_path) == []
    with pytest.raises(FileNotFoundError, match="no named checkpoint 'a'"):
        m.restore_named("a", row)
    for bad in ("", "a/b", "x y"):
        with pytest.raises(ValueError, match=r"use \[A-Za-z0-9._-\]"):
            m.save_named(bad, row)


def _error(call):
    try:
        call()
    except Exception as e:      # noqa: BLE001 - compared below
        return type(e), str(e)
    return None


def test_restore_named_refusals_match_reference(tmp_path):
    """dtype, shape and missing-leaf mismatches: the reference's errors."""
    fl, fx = _session("float"), _session("fixed")
    short = _session("float", T1=7)
    for mgr, row in ((CheckpointManager(str(tmp_path / "p")), _port_row),
                     (RefManager(str(tmp_path / "r")), _ref_row)):
        mgr.save_named("s", row(fl))
    errs = {}
    for name, mgr, row in (
            ("port", CheckpointManager(str(tmp_path / "p")), _port_row),
            ("ref", RefManager(str(tmp_path / "r")), _ref_row)):
        errs[name] = [
            _error(lambda: mgr.restore_named("s", row(fx))),
            _error(lambda: mgr.restore_named("s", row(short))),
            _error(lambda: mgr.restore_named("s", {"other": row(fl).acc})),
        ]
    assert errs["port"] == errs["ref"]
    assert errs["port"][0] == (ValueError, "dtype mismatch for delays/0: "
                               "ckpt float32 vs expected int32")
    assert errs["port"][1][0] is ValueError
    assert errs["port"][2] == (KeyError,
                               "\"named checkpoint 's' missing leaf other\"")


def _train_state(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "layers": [rng.standard_normal(2).astype(np.float32)
                                  for _ in range(2)]},
            "step": np.int32(seed), "opt": (np.float32(0.5), None)}


def test_step_checkpoints_gc_async_and_cross_packages(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=2)   # async by default
    like = {k: v for k, v in _train_state(0).items()}
    for step in range(1, 6):
        st = _train_state(step)
        st["params"]["w"] = torch.from_numpy(st["params"]["w"])
        m.save(step, st)
    m.wait()
    assert m.all_steps() == [4, 5] and m.latest_step() == 5
    state, step = m.restore(like)
    assert step == 5 and isinstance(state["params"]["w"], np.ndarray)
    _leaves_equal(state, _train_state(5))
    got, step = m.restore({**like, "params": {
        **like["params"], "w": torch.zeros(4, 3)}}, step=4)
    assert isinstance(got["params"]["w"], torch.Tensor) and step == 4
    _leaves_equal(jax.tree.map(np.asarray, got), _train_state(4))
    # the reference reads the port's checkpoints and the other way round
    ref_state, step = RefManager(str(tmp_path)).restore(like)
    assert step == 5
    _leaves_equal(ref_state, _train_state(5))
    r = RefManager(str(tmp_path / "ref"), async_save=False)
    r.save(7, jax.tree.map(jnp.asarray, _train_state(7)))
    state, step = CheckpointManager(str(tmp_path / "ref")).restore(like)
    assert step == 7
    _leaves_equal(state, _train_state(7))
    assert _manifest(tmp_path / "ref" / "step_00000007")["leaves"] == \
        _manifest(tmp_path / "step_00000005")["leaves"]
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.save(9, like, mesh=object(), specs={})
    # under a (one-rank) mesh: the same leaves back, the mesh and each
    # leaf's spec in the manifest, the rest as without one
    with one_rank_group(tmp_path):
        mesh = make_host_mesh(device="cpu")
        st = _train_state(9)
        st["params"]["w"] = torch.from_numpy(st["params"]["w"])
        specs = sh.param_specs(st, mesh)
        m.save(9, sh.shard_tree(st, specs, mesh), mesh=mesh, specs=specs)
        m.wait()
        got, step = m.restore({**like, "params": {
            **like["params"], "w": torch.zeros(4, 3)}}, mesh=mesh,
            specs=specs)
        assert step == 9 and sh.is_dtensor(got["params"]["w"])
        _leaves_equal(jax.tree.map(lambda t: np.asarray(sh.full_tensor(t)),
                                   got), _train_state(9))
    meshed = _manifest(tmp_path / "step_00000009")
    assert meshed["mesh_shape"] == [1, 1]
    assert meshed["mesh_axes"] == ["data", "model"]
    assert {leaf.pop("spec") for leaf in meshed["leaves"]} == \
        {"PartitionSpec()"}
    assert meshed["leaves"] == [
        {k: v for k, v in leaf.items() if k != "spec"}
        for leaf in _manifest(tmp_path / "step_00000005")["leaves"]]
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore(like)
