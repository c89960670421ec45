"""The port's distributed tier on a one-rank mesh, against the reference's
on its ``(1, 1)`` mesh (CPU, one gloo rank made and destroyed by the
module's fixture over a ``file://`` store).

* ``StreamServer(mesh=)`` on a ``(1, 1)`` mesh decides as the reference's
  server on the same feeds, through an eviction and a resume (float
  within 1e-5, fixed exactly), and bit for bit as the port's server
  without a mesh. Its ``sharded_state`` is placed by ``session_specs``.
* A checkpoint saved by the port under a ``(1, 1)`` mesh and one saved by
  the reference under its ``(1, 1)`` mesh, of the same state, have
  manifests equal field for field but ``time``; each package restores the
  other's with ``mesh=`` and ``specs=`` (the port onto the mesh with its
  axes named the other way round, as ``tests/test_checkpoint.py`` does).
* ``launch.train`` with mesh flags on one process runs a clamped ``(1,
  1)`` mesh: its checkpoint records the mesh and the reference's spec
  strings, and a resume continues it.
* Compression, as ``tests/test_distributed.py`` holds the reference: the
  int8 codes and scale bit for bit the reference's, and error feedback
  converging within 2e-4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

import test_torch_serving_async as serving
import torch_mesh_ranks as ranks
from repro.checkpoint import CheckpointManager as RefManager
from repro.distributed import compression as ref_comp
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as sh
from repro_torch.launch import train as train_launch
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.serving import StreamServer


@pytest.fixture(scope="module", autouse=True)
def one_rank(tmp_path_factory):
    with ranks.one_rank_group(tmp_path_factory.mktemp("pg")):
        yield


def test_meshes_clamp_to_the_world():
    mesh = make_host_mesh(data=4, model=3, device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    mesh = make_production_mesh((1, 1, 1), device="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_production_mesh((2, 2, 2), device="cpu")


def assert_decisions(got, want, numerics):
    assert [g[:2] + g[3:] for g in got] == [w[:2] + w[3:] for w in want]
    for g, w in zip(got, want):
        if numerics == "fixed":
            assert g[2] == w[2]
        else:
            assert abs(g[2] - w[2]) <= serving.TOL


@pytest.mark.parametrize("numerics", ["float", "fixed"])
def test_mesh_server_matches_reference_server(numerics, tmp_path):
    """Held against the reference's server without a mesh: under the
    installed JAX its mesh server raises a ``ShardingTypeError`` in
    ``open()`` (the slot scatter on its sharded state) when run on its own,
    as ``tests/test_serving.py::test_server_with_mesh_matches_unsharded``
    does; that test holds its mesh server to the one without."""
    rng = np.random.default_rng(11)
    first = [("open", "a"), ("open", "b"),
             ("feed", serving.feeds(rng, ["a", "b"], 6)),
             ("feed", [("b", np.ones(20, np.float32))])]
    second = [("open", "c"),                                   # evicts a
              ("feed", serving.feeds(rng, ["b", "c"], 4)),
              ("close", "c", True), ("open", "a"),              # resumes a
              ("feed", serving.feeds(rng, ["a", "b"], 5))]
    kw = dict(capacity=2, max_chunk=64, min_chunk=16)
    port_pipe, step = serving.port(numerics)
    meshed = StreamServer(port_pipe, step_fn=step,
                          clock=ranks.counter_clock(),
                          checkpoint_dir=str(tmp_path / "mesh"),
                          mesh=make_host_mesh(device="cpu"), **kw)
    plain = StreamServer(port_pipe, step_fn=step,
                         clock=ranks.counter_clock(),
                         checkpoint_dir=str(tmp_path / "plain"), **kw)
    ref = serving.ref_server(numerics, clock=ranks.counter_clock(),
                             checkpoint_dir=str(tmp_path / "ref"), **kw)
    got = ranks.serve_script(meshed, first)
    assert got == ranks.serve_script(plain, first)
    assert_decisions(got, ranks.serve_script(ref, first), numerics)
    got = ranks.serve_script(meshed, second)
    assert got == ranks.serve_script(plain, second)
    assert_decisions(got, ranks.serve_script(ref, second), numerics)
    for a, b in zip(meshed.state.tensors(), plain.state.tensors()):
        assert torch.equal(a, b)
    assert meshed.local_slots == (0, 2)
    mesh = make_host_mesh(device="cpu")
    specs = sh.tree_specs_by_path(sh.session_specs(meshed.state, mesh))
    placed = sh.shard_session(plain.state, mesh)
    for t, u, spec in zip(meshed.sharded_state.tensors(), placed.tensors(),
                          specs.values()):
        assert t.placements == u.placements == tuple(sh.to_placements(
            spec, mesh))
        assert torch.equal(sh.full_tensor(t), sh.full_tensor(u))
    with pytest.raises(TypeError, match="DeviceMesh"):
        StreamServer(port_pipe, mesh=object(), **kw)
    with pytest.raises(ValueError, match="coalesce_watermark"):
        StreamServer(port_pipe, mesh=make_host_mesh(device="cpu"),
                     coalesce_deadline=0.1, **kw)


def _state():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "b": np.zeros(3, np.float32)},
            "opt": {"mu": rng.standard_normal((4, 3)).astype(np.float32),
                    "count": np.asarray(5, np.int32)}}


def _manifest(d):
    with open(d / "manifest.json") as f:
        m = json.load(f)
    m.pop("time")
    return m


def test_mesh_checkpoints_match_reference_and_cross_restore(tmp_path):
    state = _state()
    ref_specs = {"params": {"w": RefP("data", None), "b": RefP()},
                 "opt": {"mu": RefP(None, "model"), "count": RefP()}}
    specs = {"params": {"w": sh.P("data", None), "b": sh.P()},
             "opt": {"mu": sh.P(None, "model"), "count": sh.P()}}
    mesh = make_host_mesh(device="cpu")
    port_state = jax.tree.map(torch.from_numpy, state)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        3, sh.shard_tree(port_state, specs, mesh), mesh=mesh, specs=specs)
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    RefManager(str(tmp_path / "ref"), async_save=False).save(
        3, jax.tree.map(jnp.asarray, state), mesh=ref_mesh, specs=ref_specs)
    port_m = _manifest(tmp_path / "port" / "step_00000003")
    assert port_m == _manifest(tmp_path / "ref" / "step_00000003")
    assert port_m["mesh_shape"] == [1, 1]
    assert [leaf["spec"] for leaf in port_m["leaves"]] == [
        "PartitionSpec()", "PartitionSpec(None, 'model')",
        "PartitionSpec()", "PartitionSpec('data', None)"]
    # the port restores the reference's onto a mesh with the axes swapped
    from torch.distributed.device_mesh import DeviceMesh
    swapped = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                         mesh_dim_names=("model", "data"))
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(
        port_state, mesh=swapped, specs=specs)
    assert step == 3 and sh.is_dtensor(got["params"]["w"])
    assert got["params"]["w"].placements == tuple(
        sh.to_placements(specs["params"]["w"], swapped))
    for k in ("w", "b"):
        assert np.array_equal(sh.full_tensor(got["params"][k]).numpy(),
                              state["params"][k])
    assert int(got["opt"]["count"]) == 5
    # and the reference restores the port's under its mesh
    ref_got, step = RefManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, state),
        mesh=jax.make_mesh((1, 1), ("model", "data")), specs=ref_specs)
    for a, b in zip(jax.tree.leaves(ref_got), jax.tree.leaves(state)):
        assert np.array_equal(np.asarray(a), b)
    with pytest.raises(TypeError, match="DeviceMesh"):
        CheckpointManager(str(tmp_path / "x")).save(1, port_state,
                                                    mesh=object(),
                                                    specs=specs)


def test_launch_train_on_a_clamped_mesh_checkpoints_and_resumes(tmp_path,
                                                                 capsys):
    args = ["--arch", "qwen3-8b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--warmup", "1", "--device", "cpu",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    meshed = train_launch.main(args + ["--mesh-data", "2", "--mesh-model",
                                       "2"])
    m = _manifest(tmp_path / "step_00000003")
    assert m["mesh_shape"] == [1, 1] and m["mesh_axes"] == ["data", "model"]
    specs = {leaf["path"]: leaf["spec"] for leaf in m["leaves"]}
    assert specs["params/layers/0/attn/wq"] == "PartitionSpec('data', " \
        "'model')"
    assert specs["opt/mu/tok_embed"] == "PartitionSpec('model', 'data')"
    assert specs["step"] == "PartitionSpec()"
    import shutil
    shutil.rmtree(tmp_path / "step_00000003")
    again = train_launch.main(args + ["--mesh-data", "2"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert again == meshed[2:]


def test_quant_dequant_matches_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal(1000).astype(np.float32),
              (rng.standard_normal(64) * 1e-3).astype(np.float32),
              np.zeros(8, np.float32),
              np.array([0.5, -0.5, 1.5, 2.5, -127.0], np.float32)):
        q, scale = comp._quant_dequant_int8(torch.from_numpy(x))
        rq, rscale = ref_comp._quant_dequant_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert scale.numpy().tobytes() == np.asarray(rscale).tobytes()
        err = x - q.numpy().astype(np.float32) * scale.numpy()
        assert float(np.max(np.abs(err))) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_converges():
    """Repeated compressed estimates of a constant gradient converge on
    average (the QSGD guarantee), over the one-rank group."""
    g = torch.from_numpy((np.random.default_rng(1).standard_normal(64)
                          * 1e-3).astype(np.float32))
    err = comp.compress_state_init({"g": g})["g"]
    est = torch.zeros_like(g)
    for _ in range(50):
        ghat, err = comp.compressed_psum(g, err)
        est = est + ghat / 50
    assert float(torch.max(torch.abs(est - g))) < 2e-4
    mesh = make_production_mesh((1, 1, 1), device="cpu")
    grads = {"a": g, "b": [g * 2]}
    out, new_err = comp.compressed_grad_allreduce(
        grads, comp.compress_state_init(grads), mesh)
    want, want_err = comp.compressed_psum(g * 2, torch.zeros_like(g))
    assert torch.equal(out["b"][0], want) and torch.equal(new_err["b"][0],
                                                          want_err)
