"""Quickstart on the PyTorch/CUDA port: the paper's technique in 30 lines.

Builds a multiplierless MP kernel-machine classifier on synthetic acoustic
data: FIR filter bank (feature extractor == kernel) in the MP domain, run
through the one-shot bank's CUDA kernel, then MP classification with
gamma-annealed training. The counterpart of examples/quickstart.py.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

from repro_torch.core import trainer
from repro_torch.core.filterbank import FilterBank, FilterBankConfig
from repro_torch.data.acoustic import make_esc10_like


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    # 1. data: ESC-10-like synthetic environmental sounds
    ds = make_esc10_like(per_class_train=8, per_class_test=4,
                         fs=8000.0, seconds=0.5)

    # 2. in-filter feature extraction: the FIR bank IS the kernel (MP mode:
    #    every filter is computed with add/compare/shift only), one launch
    #    of the one-shot cascade kernel for the whole bank
    fb = FilterBank(FilterBankConfig(fs=8000.0, num_octaves=5,
                                     filters_per_octave=5, mode="mp",
                                     gamma_f=4.0, use_pallas=True),
                    device=args.device)
    s_tr = fb.accumulate(ds.x_train)
    mu, sd = s_tr.mean(0), s_tr.std(0, correction=1) + 1e-6
    K_tr = (s_tr - mu) / sd                       # Phi, eq. (13)
    K_te = (fb.accumulate(ds.x_test) - mu) / sd

    # 3. MP kernel machine (eq. 2-7) trained through the approximation
    params, losses = trainer.train(
        K_tr, ds.y_train, num_classes=10,
        cfg=trainer.TrainConfig(num_steps=300, lr=0.5), device=fb.device)

    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print("train acc:", trainer.evaluate(params, K_tr, ds.y_train))
    print("test  acc:", trainer.evaluate(params, K_te, ds.y_test))
    print("test  acc @8-bit:", trainer.evaluate(params, K_te, ds.y_test,
                                                quant_bits=8))
    return losses


if __name__ == "__main__":
    main()
