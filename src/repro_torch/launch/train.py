"""Training launcher for the transformer zoo: the counterpart of the
reference's ``repro.launch.train``, with its arguments.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --resume auto [--mp-mode] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch qwen3-8b --smoke --mesh-data 2 --device cpu

* deterministic token batches addressed by step (``data.tokens``), so a
  restart needs only the step counter;
* ``CheckpointManager``: atomic, async, keep-last-k; ``--resume auto``
  restores the latest checkpoint of ``--ckpt-dir``;
* ``StragglerMonitor`` EWMA on step times;
* gradient accumulation over ``--accum`` microbatches.

On the card unless ``--device cpu``. ``--mesh-data`` / ``--mesh-model``
above 1 train on a ``("data", "model")`` mesh (``launch.mesh.make_host_mesh``,
its sizes clamped to the ranks there are; one process per rank, under
``torchrun``): params and moments sharded by ``sharding.param_specs``, the
batch split over 'data', checkpoints saved and restored under the mesh
(a checkpoint written on one mesh resumes on another).

Every family trains. Its batch is the reference launcher's
(:func:`make_batch`): tokens, or for the audio encoder standard-normal
``frames`` (B, seq, d_model) from ``np.random.default_rng(seed)`` with
``labels = tokens % vocab_size``, or for a VLM ``p = min(vlm_patches, seq
// 2)`` patch embeddings before ``seq - p`` tokens, the step built for
``vlm_patches = p`` (:func:`step_config`; the reference rebuilds that
step without ``--accum``, the port keeps it).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.monitor import StragglerMonitor
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import AdamWConfig

__all__ = ["build_argparser", "step_config", "make_batch", "main"]


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_IDS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation microbatches")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", choices=["auto", "never"], default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mp-mode", action="store_true",
                    help="run linear layers through the multiplierless MP "
                         "path")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def step_config(cfg, seq: int):
    """The config a train step at sequence ``seq`` runs: a VLM's patches
    cut to at most half of it (``vlm_patches = min(vlm_patches, seq //
    2)``), as the reference launcher does; any other config as it is."""
    if not cfg.vlm_patches:
        return cfg
    return dataclasses.replace(cfg, vlm_patches=min(cfg.vlm_patches,
                                                    seq // 2))


def make_batch(cfg, toks: np.ndarray, rng: np.random.Generator) -> dict:
    """One train batch (numpy) for ``cfg`` (a :func:`step_config`) from
    the token rows ``toks`` (B, seq), as the reference launcher builds it:
    tokens; audio ``frames`` (B, seq, d_model) standard normal from
    ``rng`` and ``labels = toks % vocab_size``; a VLM ``vlm_patches``
    patch embeddings from ``rng`` and the first ``seq - vlm_patches``
    tokens."""
    B, seq = toks.shape
    if cfg.audio_frontend:
        frames = rng.standard_normal((B, seq, cfg.d_model))
        return {"frames": frames.astype(np.float32),
                "labels": toks % cfg.vocab_size}
    if cfg.vlm_patches:
        p = cfg.vlm_patches
        patches = rng.standard_normal((B, p, cfg.d_model))
        return {"tokens": toks[:, :seq - p],
                "patches": patches.astype(np.float32)}
    return {"tokens": toks}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    if args.mp_mode:
        cfg = dataclasses.replace(cfg, mp_mode=True)
    cfg = step_config(cfg, args.seq)
    dev = resolve_device(args.device)
    mesh = (make_host_mesh(args.mesh_data, args.mesh_model, device=dev)
            if args.mesh_data > 1 or args.mesh_model > 1 else None)
    say = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    opt = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                      total_steps=args.steps)
    init_state, train_step = make_train_step(cfg, opt, accum=args.accum,
                                             mesh=mesh)
    state = init_state(torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)
    specs = sh.param_specs(state, mesh) if mesh is not None else None

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume == "auto" and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state, mesh=mesh, specs=specs)
        say(f"resumed from step {start_step}")

    stream = TokenStream(cfg.vocab_size, args.seq, args.batch * args.accum,
                         seed=args.seed)
    monitor = StragglerMonitor()
    rng = np.random.default_rng(args.seed)
    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 make_batch(cfg, stream.batch(step), rng).items()}
        t0 = time.time()
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        monitor.record("host0", dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f} ms "
                  f"stragglers={monitor.stragglers()}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state, mesh=mesh, specs=specs)
    if ckpt:
        ckpt.save(args.steps, state, mesh=mesh, specs=specs)
        ckpt.wait()
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
