"""End-to-end reproduction of the paper's deployment flow on the port.

1. Train the MP in-filter classifier (float) with gamma annealing.
2. Quantize everything to 8-bit fixed point (taps + weights), Fig. 8 style.
3. Compare against the MAC 'Normal SVM' baseline (Table III columns).
4. Run the deployed model through the CUDA kernels: the one-shot bank
   kernel (FIR + HWR + accumulate, the whole multirate cascade in one
   launch), then its bit-true integer twin through the integer bank kernel
   on both carriers: int32 codes and the fake-quant twin's float32-carried
   codes, which must agree exactly.

The counterpart of examples/acoustic_classification.py.

    PYTHONPATH=src python examples/torch_acoustic_classification.py \
        [--fast] [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core import fixed
from repro_torch.core import kernel_machine as km
from repro_torch.core import trainer
from repro_torch.core.filterbank import FilterBank, FilterBankConfig
from repro_torch.core.pipeline import InFilterPipeline
from repro_torch.core.trainer import _maybe_quant
from repro_torch.data.acoustic import ESC10_CLASSES, make_esc10_like


def pipeline(mode, qbits, ds, fs, octaves, device, use_pallas=False):
    fb = FilterBank(FilterBankConfig(fs=fs, num_octaves=octaves,
                                     filters_per_octave=5, mode=mode,
                                     gamma_f=4.0, quant_bits=qbits,
                                     use_pallas=use_pallas), device=device)
    s_tr = fb.accumulate(ds.x_train)
    mu, sd = s_tr.mean(0), s_tr.std(0, correction=1) + 1e-6
    K_tr = (s_tr - mu) / sd
    K_te = (fb.accumulate(ds.x_test) - mu) / sd
    params, _ = trainer.train(
        K_tr, ds.y_train, 10,
        trainer.TrainConfig(num_steps=400, lr=0.5, quant_bits=qbits),
        device=fb.device)
    acc = trainer.evaluate(params, K_te, ds.y_test, qbits)
    return acc, params, (mu, sd), fb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    fs, octaves = (4000.0, 4) if args.fast else (8000.0, 5)
    per_tr, per_te = (6, 3) if args.fast else (16, 8)
    ds = make_esc10_like(per_class_train=per_tr, per_class_test=per_te,
                         fs=fs, seconds=0.5, seed=0)

    print("=== MAC baseline ('Normal SVM' column) ===")
    acc_mac, *_ = pipeline("mac", None, ds, fs, octaves, args.device)
    print(f"test acc: {acc_mac:.3f}")

    print("=== MP in-filter, float ===")
    acc_mp, *_ = pipeline("mp", None, ds, fs, octaves, args.device)
    print(f"test acc: {acc_mp:.3f}")

    print("=== MP in-filter, 8-bit fixed point (deployment) ===")
    acc_q8, params, (mu, sd), fb = pipeline("mp", 8, ds, fs, octaves,
                                            args.device)
    print(f"test acc: {acc_q8:.3f}")

    print("=== deployed inference through the CUDA kernels ===")
    fbk = FilterBank(fb.config._replace(use_pallas=True), device=fb.device)
    t0 = time.time()
    K = (fbk.accumulate(ds.x_test) - mu) / sd
    p = km.forward(_maybe_quant(params, 8), K, 1.0)
    pred = p.argmax(-1).cpu().numpy()
    dt = time.time() - t0
    acc_kernel = float((pred == ds.y_test).mean())
    print(f"kernel-path test acc: {acc_kernel:.3f} "
          f"({len(ds.y_test) / dt:.1f} clips/s on {fb.device.type})")
    print("\nper-class (one-vs-all) @8-bit:")
    pc = p.cpu().numpy()
    for c, name in enumerate(ESC10_CLASSES):
        ova = float(((pc[:, c] > 0) == (ds.y_test == c)).mean())
        print(f"  {name:16s} {ova:.3f}")

    print("\n=== the bit-true integer twin, int32 and the fake-quant twin ===")
    cfg = fb.config._replace(quant_bits=None, numerics="fixed",
                             use_pallas=True)
    twin = InFilterPipeline(cfg, fb.bp_by_octave, fb.lp_filters, mu, sd,
                            _maybe_quant(params, 8), device=fb.device)
    prog = twin.calibrate_fixed(ds.x_train)
    x = torch.as_tensor(ds.x_test, device=fb.device)
    p_int, phi_int = fixed.predict(prog, x, use_pallas=True)
    p_f32, phi_f32 = fixed.predict(prog, x, carrier="float",
                                   use_pallas=True)
    same = bool(torch.equal(p_int, p_f32) and torch.equal(phi_int, phi_f32))
    if not same:
        raise AssertionError("the fake-quant twin (f32-carried codes) "
                             "differs from the int32 twin")
    acc_fixed = float((p_int.argmax(-1).cpu().numpy() == ds.y_test).mean())
    print(f"fixed-point test acc: {acc_fixed:.3f}; f32-carried codes equal "
          f"the int32 codes: {same}")
    return dict(mac=acc_mac, mp=acc_mp, mp8=acc_q8, kernel=acc_kernel,
                fixed=acc_fixed)


if __name__ == "__main__":
    main()
