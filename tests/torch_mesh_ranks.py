"""Ranks of the port's distributed tests, on the CPU with gloo (not
collected: no ``test_`` prefix).

A test writes its inputs (numpy, pickled) into a directory, and
:func:`spawn` starts ``world`` processes of this file, one per rank::

    python tests/torch_mesh_ranks.py <case> <rank> <world> <directory>

Each joins a gloo group over a ``file://`` store in that directory (no TCP
port, so tests side by side do not meet), runs ``CASES[case]`` and
pickles what it saw to ``<directory>/<case>_<rank>.pkl`` for the test to
hold against the reference. A spawned run has a hard timeout: a rank that
hangs (a rendezvous, a collective) is killed and fails its test. The ranks
import no JAX: the reference's values are computed in the test process.

:func:`one_rank_group` is the one-rank gloo group of the tests that run a
mesh in their own process, destroyed when it closes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 90.0


@contextlib.contextmanager
def one_rank_group(directory):
    """A one-rank gloo group over a ``file://`` store in ``directory``."""
    assert not dist.is_initialized(), "a process group is already up"
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class spawn:
    """Start ``case`` on ``world`` ranks; :meth:`results` waits for them
    (the test computes its own side meanwhile) and returns what each rank
    pickled, by rank."""

    def __init__(self, case: str, world: int, directory, inputs=None):
        self.case, self.world = case, world
        self.dir = Path(directory)
        if inputs is not None:
            with open(self.dir / f"{case}_inputs.pkl", "wb") as f:
                pickle.dump(inputs, f)
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
                   OMP_NUM_THREADS="2")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, case, str(r), str(world),
             str(self.dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        self.deadline = time.monotonic() + TIMEOUT_S

    def results(self) -> list:
        outs = []
        try:
            for p in self.procs:
                left = max(self.deadline - time.monotonic(), 0.1)
                outs.append(p.communicate(timeout=left)[0])
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            logs = [p.communicate()[0] for p in self.procs]
            raise AssertionError(f"{self.case}: a rank did not finish in "
                                 f"{TIMEOUT_S} s:\n" + "\n".join(logs))
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"{self.case} rank {r} failed:\n{out}"
        results = []
        for r in range(self.world):
            with open(self.dir / f"{self.case}_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


# -- serving: a (2, 1) mesh, capacity 4 ---------------------------------------


def serve_script(server, schedule) -> list:
    """Run ``schedule`` (("open", id) / ("close", id, checkpoint) /
    ("feed", [(id, chunk), ...])) on ``server``; the ``FeedResult``s as
    (id, label, confidence, samples_seen), in order."""
    out = []
    for op in schedule:
        if op[0] == "open":
            server.open(op[1])
        elif op[0] == "close":
            server.close(op[1], checkpoint=op[2])
        else:
            out += [(r.session_id, r.label, r.confidence, r.samples_seen)
                    for r in server.feed(op[1])]
    return out


def counter_clock():
    """A clock that ticks once per read: the same on every rank."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return clock


def case_serve(rank, world, directory, inputs):
    from repro_torch import bridge
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import StreamServer
    mesh = make_host_mesh(data=world, model=1, device="cpu")
    got = {}
    for numerics, (cfg, bp, lp, mu, sigma, clf) in inputs["pipes"].items():
        pipe = bridge.pipeline_from_numpy(cfg, bp, lp, mu, sigma, clf,
                                          device="cpu", stream_impl="pallas")
        srv = StreamServer(pipe, mesh=mesh, clock=counter_clock(),
                           checkpoint_dir=str(directory / f"sessions_"
                                              f"{numerics}"),
                           **inputs["server_kw"])
        results = serve_script(srv, inputs["schedule"])
        state = tuple(sh.full_tensor(t).numpy()
                      for t in srv.sharded_state.tensors())
        counts = srv.step_counts()
        # a step that raises on the last rank poisons every rank
        srv.open("late")
        if rank == world - 1:
            def boom(*a, **k):
                raise RuntimeError("injected")
            srv._step = boom
        try:
            srv.feed([("late", np.ones(16, np.float32))])
            poisoned = None
        except RuntimeError as e:
            poisoned = str(e)
        got[numerics] = dict(results=results, state=state, counts=counts,
                             slots=list(srv.local_slots),
                             poisoned=poisoned)
    return got


# -- training: the smoke qwen3-8b step on (2, 1) and (1, 2) -------------------


def train_cfg(mp_mode: bool):
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("qwen3-8b"), mp_mode=mp_mode,
                               compute_dtype="float32")


TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def train_batches(cfg, n: int, batch: int = 4, seq: int = 8) -> list:
    from repro_torch.data.tokens import TokenStream
    stream = TokenStream(cfg.vocab_size, seq, batch, seed=0)
    return [{"tokens": torch.as_tensor(stream.batch(s))} for s in range(n)]


def run_steps(cfg, mesh, batches, *, state=None, accum=1):
    """``batches`` through ``make_train_step`` from seed 0 (or ``state``):
    (losses, the final state)."""
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.optim import AdamWConfig
    init_state, step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                                       accum=accum, mesh=mesh)
    if state is None:
        state = init_state(torch.Generator().manual_seed(0), device="cpu")
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state


def summary(losses, state) -> dict:
    """What a test holds of a train run: its losses, every param and
    first moment whole (the moment is 0.1 x the clipped gradient after one
    step), and what kind the params are."""
    return dict(losses=losses, params=full_params(state.params),
                mu=full_params(state.opt.mu),
                kind=type(state.params["lm_head"]).__name__)


def full_params(params) -> dict:
    """Every param leaf whole, as numpy, by path."""
    from repro_torch.checkpoint.manager import _flatten, _path_str
    from repro_torch.distributed import sharding as sh
    return {_path_str(p): sh.full_tensor(t).detach().numpy()
            for p, t in _flatten(params)}


def case_train(rank, world, directory, inputs):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    got = {}
    meshes = {"2x1": make_host_mesh(data=2, model=1, device="cpu"),
              "1x2": make_host_mesh(data=1, model=2, device="cpu")}
    for mp_mode in (False, True):
        cfg = train_cfg(mp_mode)
        batches = train_batches(cfg, 1)
        for name, mesh in meshes.items():
            got[(mp_mode, name)] = summary(*run_steps(cfg, mesh, batches))
    cfg = train_cfg(False)
    batches = train_batches(cfg, 4)
    got["accum"] = summary(*run_steps(cfg, meshes["2x1"], batches[:1],
                                      accum=2))
    # the control: each rank's gradient kept as its own partial sum
    from torch.distributed.tensor import Replicate
    real = sh._grad_placements
    sh._grad_placements = lambda mesh: [Replicate()] * mesh.ndim
    try:
        got["unreduced"] = summary(*run_steps(cfg, meshes["2x1"],
                                              batches[:1]))
    finally:
        sh._grad_placements = real
    # elastic: two steps on (2, 1), saved; restored on (1, 2), two more
    ckpt = CheckpointManager(str(directory / "elastic"), async_save=True)
    l1, state = run_steps(cfg, meshes["2x1"], batches[:2])
    specs = sh.param_specs(state, meshes["2x1"])
    ckpt.save(2, state, mesh=meshes["2x1"], specs=specs)
    ckpt.wait()
    _, like = run_steps(cfg, meshes["1x2"], [])
    restored, step = ckpt.restore(like, mesh=meshes["1x2"],
                                  specs=sh.param_specs(like, meshes["1x2"]))
    l2, state = run_steps(cfg, meshes["1x2"], batches[2:], state=restored)
    got["elastic"] = dict(
        summary(l1 + l2, state), step=step,
        placements=[str(p) for p in
                    restored.params["layers"][0]["attn"]["wq"].placements])
    return got


# -- training a MoE: the smoke deepseek step on (2, 1) ------------------------


def moe_cfg():
    """The deepseek smoke (its dense layer, 2 MoE layers) in f32, groups
    of 8 tokens: the 16 tokens of each rank's 2 rows are whole groups of
    the global batch, so both ranks drop what one process drops."""
    from repro_torch.configs import get_smoke
    return dataclasses.replace(get_smoke("deepseek-moe-16b"),
                               compute_dtype="float32", moe_group_size=8)


@contextlib.contextmanager
def f32_router():
    """The router (``layers.linear``'s default compute dtype, a bf16
    product otherwise) in float32: ~1e-6 of sum order between a split
    and a whole batch must not move a route by a bf16 step."""
    from repro_torch.models import layers
    real = layers.linear.__kwdefaults__["compute_dtype"]
    layers.linear.__kwdefaults__["compute_dtype"] = torch.float32
    try:
        yield
    finally:
        layers.linear.__kwdefaults__["compute_dtype"] = real


def case_train_moe(rank, world, directory, inputs):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=1, device="cpu")
    cfg = moe_cfg()
    with f32_router():
        losses, state = run_steps(cfg, mesh, train_batches(cfg, 1))
    experts = state.params["layers"][0]["ffn"]
    return dict(summary(losses, state), placements={
        k: [str(p) for p in experts[k].placements]
        for k in ("wi_gate", "wi_up", "wo", "router")})


# -- compression: compressed_psum over the ranks ------------------------------


def case_psum(rank, world, directory, inputs):
    from repro_torch.distributed.compression import compressed_psum
    err = torch.from_numpy(inputs["err"][rank])
    outs = []
    for x in inputs["xs"]:
        out, err = compressed_psum(torch.from_numpy(x[rank]), err)
        outs.append((out.numpy(), err.numpy()))
    return outs


CASES = {"serve": case_serve, "train": case_train,
         "train_moe": case_train_moe, "psum": case_psum}


def main(case: str, rank: int, world: int, directory: str) -> None:
    directory = Path(directory)
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{directory}/pg",
                            rank=rank, world_size=world)
    try:
        path = directory / f"{case}_inputs.pkl"
        inputs = None
        if path.exists():
            with open(path, "rb") as f:
                inputs = pickle.load(f)
        got = CASES[case](rank, world, directory, inputs)
        with open(directory / f"{case}_{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
