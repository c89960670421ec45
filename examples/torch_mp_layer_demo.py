"""The paper's technique as a first-class LM layer mode on the port: run
the same tiny transformer with standard matmuls and with multiplierless MP
projections (eq. 9 through the ``mp_linear`` CUDA kernel), and train the
MP version a few steps (its backward through the ``mp_linear_bwd``
kernel), showing that backprop through the water-filling works at the
transformer scale too. The counterpart of examples/mp_layer_demo.py.

    PYTHONPATH=src python examples/torch_mp_layer_demo.py [--steps 10] \
        [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ArchConfig
from repro_torch.optim import AdamWConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    base = ArchConfig(
        name="mp-demo", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
        remat=False, q_chunk=32, kv_chunk=32)

    toks = np.random.default_rng(0).integers(0, 512, (4, 32))
    batch = {"tokens": torch.as_tensor(toks, device=dev)}

    params = T.init(base, torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        logits_std = T.forward(params, base, batch)
        mp_cfg = dataclasses.replace(base, mp_mode=True, mp_gamma=8.0)
        logits_mp = T.forward(params, mp_cfg, batch)
    print("standard logits std :", float(logits_std.float().std()))
    print("MP-mode logits std  :", float(logits_mp.float().std()))
    print("(different by design: MP approximates each inner product; "
          "training absorbs the error:)")

    init_state, train_step = make_train_step(
        mp_cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20))
    state = init_state(torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    losses = []
    for _ in range(args.steps):
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
    print("MP-mode training loss:",
          " -> ".join(f"{v:.3f}" for v in losses[::3]))
    assert losses[-1] < losses[0]
    print("OK: backprop through the MP water-filling trains the transformer")
    return losses


if __name__ == "__main__":
    main()
