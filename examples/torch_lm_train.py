"""End-to-end LM training on the port: train a ~100M-parameter LM with the full
framework stack (the train step, AdamW + cosine, checkpointing,
deterministic data shards, straggler monitor) through the production
launcher, ``repro_torch.launch.train``. The counterpart of
examples/lm_train.py.

Default is a short run (a few hundred steps of a ~10M model); pass
--full-100m for the ~100M configuration. On the card unless --device cpu.

    PYTHONPATH=src python examples/torch_lm_train.py --steps 200
    PYTHONPATH=src python examples/torch_lm_train.py --full-100m --steps 300
"""

import argparse
import os
import tempfile

import torch

from repro_torch.models import transformer as T
from repro_torch.models.transformer import ArchConfig


def small_lm(full_100m: bool) -> ArchConfig:
    if full_100m:
        # ~100M params: 12L x 768 (GPT-2-small-ish) with a qwen3 flavour
        return ArchConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=3072, vocab_size=32768,
            qk_norm=True, remat=False, q_chunk=256, kv_chunk=256)
    return ArchConfig(
        name="lm-10m", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=8192,
        qk_norm=True, remat=False, q_chunk=128, kv_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "lm_train_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = small_lm(args.full_100m)
    n = T.param_count(T.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu"))
    print(f"model: {cfg.name}, {n / 1e6:.1f}M params")

    # reuse the production launcher end to end (its config source patched,
    # so that the exact code path of `python -m repro_torch.launch.train`
    # runs)
    import repro_torch.launch.train as tl
    orig = tl.get_smoke
    tl.get_smoke = lambda _: cfg
    try:
        losses = tl.main([
            "--arch", "qwen3-8b", "--smoke",
            "--steps", str(args.steps),
            "--batch", str(args.batch),
            "--seq", str(args.seq),
            "--lr", "3e-3", "--warmup", "50",
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        ] + (["--device", args.device] if args.device else []))
    finally:
        tl.get_smoke = orig
    if len(losses) > 1:
        assert losses[-1] < losses[0], "training must reduce loss"
        print(f"OK: loss decreased {losses[0]:.3f} -> {min(losses):.3f}")
    return losses


if __name__ == "__main__":
    main()
