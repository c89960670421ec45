"""The system under test, built from a configuration file: the port's
``InFilterPipeline`` with the benchmark's own classifier and, for the
fixed twin, calibrated on the benchmark's own audio.

What the benchmark makes and hands to the port (and, as the same values,
to the reference): the audio, the classifier drawn from the seed, the
standardization and the calibration audio. The port derives the rest
itself (taps, the integer program).

The standardization is what a trained deployment holds: each band's mean
and spread of the accumulated features of seeded ESC-length clips, worked
out by the benchmark's own plain reference (``reference/filterbank.py``),
so that the standardized features span the readout's range (the twin's
8-bit phi format covers +-4).
"""

from __future__ import annotations

import numpy as np
import torch

# sub-seeds of --seed, one per thing the seed draws
CLASSIFIER, TRAFFIC, CALIBRATION, SAMPLE, STANDARDIZATION = range(5)


def subseed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose, from any whole-number --seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), purpose])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def standardization(cfg: dict, seed: int, device) -> tuple:
    """(mu, sigma), float32 (P,) on ``device``: the mean and the spread
    (population standard deviation) over the configuration's
    ``standardization`` clips, drawn from the seed, of each band's
    features (its renormalized half-wave-rectified sum over the whole
    clip), by the plain reference in float64, one clip at a time. The
    device's peak memory is reset afterwards: this is the benchmark's
    preparation, not the system's run."""
    from portbench import audio
    from portbench.reference import filterbank as fl
    st, bank = cfg["standardization"], cfg["bank"]
    fs = float(bank["fs"])
    n = int(round(float(st["clip_seconds"]) * fs))
    x = audio.clips(subseed(seed, STANDARDIZATION), int(st["clips"]), n, fs)
    bp, lp = fl.design(bank)
    feats = []
    for row in x:
        xt = torch.as_tensor(row[None], device=device).to(torch.float64)
        s, _ = fl.cascade(xt, bp, lp, float(bank["gamma_f"]), n)
        feats.append(s[0, 0])
    f = torch.stack(feats)
    mu, sigma = f.mean(0).float(), f.std(0, unbiased=False).float()
    if not bool((sigma > 0).all()):
        raise ValueError("a band's features do not vary over the "
                         "standardization clips")
    del feats, f, s
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return mu, sigma


def draw_classifier(cfg: dict, seed: int, device) -> dict:
    """The MP kernel machine's leaves and the standardization, on
    ``device``: templates uniform in [0, template_max), drawn in one call
    from a generator on the device; biases 0; log gamma1 as float32; mu
    and sigma from :func:`standardization`."""
    c = cfg["classifier"]
    bank = cfg["bank"]
    P = int(bank["num_octaves"]) * int(bank["filters_per_octave"])
    C = int(c["num_classes"])
    g = torch.Generator(device=device).manual_seed(subseed(seed, CLASSIFIER))
    w = torch.rand((2, P, C), generator=g, device=device) \
        * float(c["template_max"])
    mu, sigma = standardization(cfg, seed, device)
    return dict(
        w_pos=w[0], w_neg=w[1],
        b_pos=torch.zeros(C, device=device),
        b_neg=torch.zeros(C, device=device),
        log_gamma1=torch.tensor(np.log(np.float32(c["gamma1"])),
                                dtype=torch.float32, device=device),
        mu=mu, sigma=sigma)


def host(clf: dict) -> dict:
    """The classifier as numpy arrays (what the reference is given)."""
    return {k: v.detach().cpu().numpy() for k, v in clf.items()}


def calibration_audio(cfg: dict, seed: int) -> np.ndarray | None:
    """The fixed twin's calibration clips (not classified by the run)."""
    fx = cfg.get("fixed")
    if fx is None:
        return None
    from portbench import audio
    fs = float(cfg["bank"]["fs"])
    return audio.clips(subseed(seed, CALIBRATION),
                       int(fx["calibration_clips"]),
                       int(round(float(fx["calibration_seconds"]) * fs)), fs)


def build(cfg: dict, clf: dict, device, cal: np.ndarray | None = None):
    """The port's pipeline for ``cfg``, holding ``clf``; a fixed one is
    calibrated on ``cal`` (ADC full scale and octave gains)."""
    from repro_torch.core.filterbank import FilterBank, FilterBankConfig
    from repro_torch.core.kernel_machine import MPKernelMachineParams
    from repro_torch.core.pipeline import InFilterPipeline

    b = cfg["bank"]
    fbc = FilterBankConfig(
        fs=float(b["fs"]), num_octaves=int(b["num_octaves"]),
        filters_per_octave=int(b["filters_per_octave"]),
        bp_taps=int(b["bp_taps"]), lp_taps=int(b["lp_taps"]),
        mode=b["mode"], gamma_f=float(b["gamma_f"]), spacing=b["spacing"],
        solver=b["solver"], use_pallas=bool(cfg["use_pallas"]),
        stream_impl=cfg["stream_impl"], numerics=cfg["numerics"])
    fb = FilterBank(fbc, device=device)
    params = MPKernelMachineParams(clf["w_pos"], clf["w_neg"], clf["b_pos"],
                                   clf["b_neg"], clf["log_gamma1"])
    pipe = InFilterPipeline.from_filterbank(fb, params, clf["mu"],
                                            clf["sigma"])
    if cfg["numerics"] == "fixed":
        pipe.calibrate_fixed(cal)
    return pipe
