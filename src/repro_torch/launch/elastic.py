"""Elastic scaling: resume a run on a mesh of another shape.

The counterpart of the reference's ``repro.launch.elastic``:

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch qwen3-8b \\
        --ckpt-dir /tmp/el [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.elastic \\
        --arch qwen3-8b --ckpt-dir /tmp/el --device cpu

1. train N steps on mesh A (``(2, 1)`` on two ranks, ``(1, 1)`` on one),
   checkpoint under it;
2. rebuild the mesh as B (``(1, 2)``, or ``(1, 1)``);
3. restore the checkpoint with B's placements (``CheckpointManager.restore``
   reshards whatever mesh wrote it);
4. continue training; the loss continues and does not reset.

Any ``--arch`` whose batch is tokens (dense, MoE, SSM, the hybrid), at its
smoke size. The audio encoder and the VLM need frames or patches, which
this token stream does not give: they raise ``ValueError`` (the
reference's elastic feeds them tokens and fails at the embed).
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch.mesh import ensure_process_group, make_host_mesh
from repro_torch.optim import AdamWConfig

__all__ = ["run_phase", "main"]


def run_phase(cfg, mesh, ckpt, stream, start, steps, opt, device=None):
    """Train ``steps`` steps on ``mesh`` from the latest checkpoint (or a
    fresh seed-0 state), then checkpoint under ``mesh``. Returns (losses,
    the next step)."""
    dev = resolve_device(device)
    init_state, train_step = make_train_step(cfg, opt, mesh=mesh)
    state = init_state(torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    specs = sh.param_specs(state, mesh)
    if ckpt.latest_step() is not None:
        state, start = ckpt.restore(state, mesh=mesh, specs=specs)
    losses = []
    for step in range(start, start + steps):
        batch = {"tokens": torch.as_tensor(stream.batch(step)).to(dev)}
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
    ckpt.save(start + steps, state, mesh=mesh, specs=specs)
    ckpt.wait()
    return losses, start + steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_IDS), default="qwen3-8b")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--steps-per-phase", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    if cfg.audio_frontend or cfg.vlm_patches:
        raise ValueError(
            f"{cfg.name}: elastic trains on token batches only, and the "
            f"{cfg.family} family's embedding needs "
            f"{'frames' if cfg.audio_frontend else 'patches'} (as the "
            "reference's elastic, which fails at the embed there); train it "
            "with launch.train")
    dev = resolve_device(args.device)
    ensure_process_group(dev)
    ckpt = CheckpointManager(args.ckpt_dir, keep_last=2)
    stream = TokenStream(cfg.vocab_size, 64, 8, seed=0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=5,
                      total_steps=3 * args.steps_per_phase)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)

    n = dist.get_world_size()
    mesh_a = make_host_mesh(data=min(2, n), model=1, device=dev)
    mesh_b = make_host_mesh(data=1, model=min(2, n), device=dev)

    l1, step = run_phase(cfg, mesh_a, ckpt, stream, 0,
                         args.steps_per_phase, opt, dev)
    say(f"phase A (mesh {tuple(mesh_a.shape)}): "
        f"loss {l1[0]:.4f} -> {l1[-1]:.4f}")
    l2, step = run_phase(cfg, mesh_b, ckpt, stream, step,
                         args.steps_per_phase, opt, dev)
    say(f"phase B (mesh {tuple(mesh_b.shape)}, resharded): "
        f"loss {l2[0]:.4f} -> {l2[-1]:.4f}")
    assert l2[0] < l1[0] + 0.5, "loss should continue, not reset"
    say("elastic rescale OK")
    return l1, l2


if __name__ == "__main__":
    main()
