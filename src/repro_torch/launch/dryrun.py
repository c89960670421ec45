"""Dry run of the production meshes: the counterpart of the reference's
``repro.launch.dryrun``. For every (architecture x input shape x mesh)
cell, one step is traced as rank 0 of a fake process group of the mesh's
size, on fake tensors, and its roofline terms are taken from what ran.

Usage (CPU only; no card, no allocation):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod | --both-meshes] [--out results/dryrun.json]

Where the reference lowers and compiles an XLA module per cell
(``lower_cell``), the port traces it (:func:`trace_cell`): a process group
with the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``)
of 256 or 512 ranks, ``launch.mesh.make_production_mesh`` over it, the
state as ``DTensor``s placed by ``sharding.param_specs`` on fake local
shards, and one train step (``make_train_step(mesh=)``), prefill
(``forward``) or decode step run under ``FakeTensorMode``, counted by
``launch.op_cost.OpCost`` and ``torch.utils.flop_counter.FlopCounterMode``,
its live bytes by ``torch.distributed._tools.mem_tracker.MemTracker``.

The port gathers every layer's weights on use and splits no compute over
'model' (ROADMAP.md, item 8), so its collective bytes (the gathers, the
gradients' reduce-scatters and all-reduces) describe the port, not the
reference's tensor-parallel schedule. Decode caches hold this rank's rows
of the batch at full length (no 'model' split). The roofline uses the
H100's data-sheet constants (``launch.mesh.HW``): its numbers are
estimates from those constants, not measurements.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import TrainState, make_train_step
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init, tree_leaves

__all__ = ["model_flops", "pick_accum", "trace_cell", "roofline",
           "run_cell", "fake_world", "main", "ACT_BUDGET_BYTES"]

# the reference budgets 10e9 of activation bytes per 16 GiB chip; the
# same share of the H100's memory
ACT_BUDGET_BYTES = 10e9 / (16 * 2 ** 30) * HW.HBM_BYTES
NODE_SIZE = 8     # cards per node, joined by NVLink; nodes by the network


def model_flops(cfg: T.ArchConfig, cell: S.ShapeCell) -> float:
    """6*N*D (dense) / 6*N_active*D; decode counts D = new tokens only.
    Train counts fwd+bwd (3x fwd); prefill/decode count fwd (2*N*D)."""
    n_active = T.active_param_count(cfg, S.params_specs(cfg))
    tokens = cell.global_batch * (1 if cell.kind == "decode" else cell.seq_len)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


def _dp_size(mesh) -> int:
    sizes = sh.axis_sizes(mesh)
    return math.prod(sizes[a] for a in sh.data_axes(mesh))


def pick_accum(cfg: T.ArchConfig, cell: S.ShapeCell, mesh,
               budget: float = ACT_BUDGET_BYTES) -> int:
    """Microbatch count for train cells: the smallest power of two such
    that the estimated per-device activation footprint stays within
    ``budget`` bytes (the reference's estimate: residual-stream bytes x
    layers x a family factor, dense ~2.5, MoE ~6, SSM ~3, hybrid ~5; its
    budget, 10e9 per 16 GiB, as the same share of the H100's memory)."""
    if cell.kind != "train":
        return 1
    b_loc = max(cell.global_batch // _dp_size(mesh), 1)
    stream = b_loc * cell.seq_len * cfg.d_model * 2
    k = {"dense": 2.5, "vlm": 2.5, "audio": 2.5,
         "moe": 6.0, "ssm": 3.0, "hybrid": 5.0}[cfg.family]
    est = stream * cfg.num_layers * k
    accum = 1
    while est / accum > budget and accum < min(16, b_loc):
        accum *= 2
    return accum


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks with the ``fake`` backend, this
    process rank 0: collectives return at once, nothing is sent."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _place(tree, mesh, mode):
    """``tree``'s fake leaves as ``DTensor``s placed by
    ``sharding.param_specs`` (the scatter runs on the fake group)."""
    with mode:
        return sh.shard_tree(tree, sh.param_specs(tree, mesh), mesh)


def _local_bytes(tree) -> int:
    """Bytes of ``tree``'s tensors on this rank (a ``DTensor``'s local
    shard)."""
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def trace_cell(cfg: T.ArchConfig, cell: S.ShapeCell, mesh,
               accum: int = 1) -> dict:
    """One step of ``cell`` traced as this rank of ``mesh`` (a mesh over a
    fake process group): {"cost": ``OpCost.as_dict()``, "by_group": bytes
    per (collective, group name), "torch_flops": FlopCounterMode's total,
    "memory": {argument_bytes, output_bytes, temp_bytes}}, all per rank.
    ``temp_bytes`` is the peak of the bytes live during the step, the
    outputs included (MemTracker)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    b_loc = max(cell.global_batch // _dp_size(mesh), 1)
    cost, flops, mem = OpCost(), FlopCounterMode(display=False), \
        MemTracker()
    if cell.kind == "train":
        _, train_step = make_train_step(cfg, AdamWConfig(), accum=accum,
                                        mesh=mesh)
        params = _place(S.params_specs(cfg, mode), mesh, mode)
        with mode:
            state = TrainState(params, adamw_init(params),
                               torch.zeros((), dtype=torch.int32))
        batch = S.input_specs(cfg, cell, mode)["batch"]
        # the step keeps this rank's rows of the global batch
        local_in = _local_bytes(state) + (_local_bytes(batch) * b_loc
                                          // cell.global_batch)

        def run():
            return train_step(state, batch)
    else:
        params = _place(S.params_specs(cfg, mode), mesh, mode)
        ins = S.input_specs(cfg, cell, mode, batch=b_loc)
        local_in = _local_bytes(params) + _local_bytes(ins)

        def run():
            with torch.no_grad():
                if cell.kind == "prefill":
                    return T.forward(params, cfg, ins["batch"])
                return T.decode_step(params, cfg, ins["tokens"],
                                     ins["cache"], ins["cur_pos"])
    with mode, mem, flops, cost:
        out = run()
    peak = mem.get_tracker_snapshot("peak")
    temp = max((d["Total"] for d in peak.values()), default=0)
    return {"cost": cost.as_dict(), "ops": cost.ops,
            "by_group": dict(cost.collectives_by_group),
            "torch_flops": float(flops.get_total_flops()),
            "memory": {"argument_bytes": int(local_in),
                       "output_bytes": int(_local_bytes(out)),
                       "temp_bytes": int(temp)}}


def _group_rate(mesh, group_name: str) -> float:
    """The link rate of one mesh group: NVLink if its ranks sit in one
    node of ``NODE_SIZE`` cards, else the network between nodes."""
    for d in range(mesh.ndim):
        g = mesh.get_group(d)
        if g.group_name == group_name:
            ranks = dist.get_process_group_ranks(g)
            same_node = len({r // NODE_SIZE for r in ranks}) == 1
            return HW.NVLINK_BW if same_node else HW.NET_BW
    return HW.NET_BW


def roofline(traced: dict, n_chips: int, cfg, cell, mesh) -> dict:
    """Three roofline terms from one traced step (:func:`trace_cell`),
    all per device, with the reference's keys. The memory term assumes
    producer-consumer fusion, as the reference's: every tensor written
    once and read once (2 x the bytes of every op's outputs) plus the
    step's arguments read once; the unfused sum of every op's operands
    and outputs beside it. Collectives: each group's bytes over its link
    (:func:`_group_rate`). ``xla_cost_analysis`` keeps the reference's key
    for the second opinion, here torch's own ``FlopCounterMode`` (it counts
    matrix products only; no bytes). Estimates from the H100's data-sheet
    constants (``HW``), not measurements."""
    per_dev = traced["cost"]
    flops = per_dev["flops"]
    coll = per_dev["collective_bytes"]
    membytes = 2.0 * per_dev["bytes_out"] + traced["memory"][
        "argument_bytes"]
    membytes_unfused = per_dev["bytes_accessed"]
    t_compute = flops / HW.PEAK_FLOPS_BF16
    t_memory = membytes / HW.HBM_BW
    t_coll = sum(b / _group_rate(mesh, g)
                 for (_, g), b in traced["by_group"].items())
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, cell)  # global
    global_flops = flops * n_chips
    return {
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": membytes,
        "hlo_bytes_per_device_unfused": membytes_unfused,
        "memory_s_unfused": membytes_unfused / HW.HBM_BW,
        "transcendentals_per_device": per_dev["transcendentals"],
        "collective_bytes": coll,
        **terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": (mf / global_flops) if global_flops else None,
        "bound_step_s": max(terms.values()),
        "roofline_fraction": (t_compute / max(terms.values())
                              if max(terms.values()) > 0 else None),
        "xla_cost_analysis": {"flops": traced["torch_flops"],
                              "bytes_accessed": None},
    }


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool,
             arch_overrides=None) -> dict:
    """One cell's record (the reference's keys; ``trace_s`` where it has
    ``lower_s`` and ``compile_s``, no ``gen_code_bytes``), inside its own
    fake process group of the mesh's size."""
    cfg = get_arch(arch_id)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    cell = S.SHAPES[shape_name]
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n_chips = math.prod(shape)
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": "x".join(map(str, shape)), "n_chips": n_chips}
    t0 = time.time()
    with fake_world(n_chips):
        mesh = make_production_mesh(shape, device="cpu")
        accum = pick_accum(cfg, cell, mesh)
        rec["grad_accum"] = accum
        try:
            traced = trace_cell(cfg, cell, mesh, accum=accum)
            rec.update(status="ok", trace_s=round(time.time() - t0, 1),
                       ops=traced["ops"], memory=traced["memory"],
                       roofline=roofline(traced, n_chips, cfg, cell, mesh))
        except Exception as e:  # noqa: BLE001 — record it, keep sweeping
            rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc(limit=20))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_IDS), default=None)
    ap.add_argument("--shape", choices=sorted(S.SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    jobs = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for arch_id in ARCH_IDS:
            cfg = get_arch(arch_id)
            for shape_name, status, reason in S.cell_table(cfg):
                for mp in meshes:
                    if status == "run":
                        jobs.append((arch_id, shape_name, mp))
                    else:
                        print(f"SKIP {arch_id} x {shape_name}: {reason}")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        jobs = [(args.arch, args.shape, mp) for mp in meshes]

    results = []
    for arch_id, shape_name, mp in jobs:
        rec = run_cell(arch_id, shape_name, multi_pod=mp)
        results.append(rec)
        tag = "OK " if rec["status"] == "ok" else "FAIL"
        if rec["status"] == "ok":
            r = rec["roofline"]
            extra = (f" dom={r['dominant']} comp={r['compute_s']:.4f}s "
                     f"mem={r['memory_s']:.4f}s coll={r['collective_s']:.4f}s "
                     f"frac={r['roofline_fraction']:.2f}")
        else:
            extra = " " + rec["error"][:160]
        print(f"{tag} {arch_id:18s} {shape_name:12s} "
              f"mesh={rec['mesh']}{extra}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    n_fail = sum(r["status"] != "ok" for r in results)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
