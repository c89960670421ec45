"""Synthetic acoustic datasets standing in for ESC-10 and FSDD (offline env).

ESC-10-like: ten structurally distinct environmental sound classes built
from the same ingredients as the real ones (band-limited noise, periodic
impulses, chirps, harmonic stacks, AM noise). Each sample is a 1-second clip
(paper trims ESC-10 clips to 1 s) at a configurable rate with per-sample
random variation (pitch, rate, SNR) so the task is non-trivial.

FSDD-like: two synthetic "speakers" saying digits — formant-synthesized
vowel-ish tones whose formant layout differs per speaker; the task is
speaker ID as in Table IV.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["AcousticDataset", "make_esc10_like", "make_fsdd_like", "chirp",
           "ESC10_CLASSES"]

ESC10_CLASSES = [
    "dog", "rain", "sea_waves", "crying_baby", "clock_tick",
    "person_sneeze", "helicopter", "chainsaw", "rooster", "fire_crackling",
]


class AcousticDataset(NamedTuple):
    x_train: np.ndarray  # (M, N) float32 in [-1, 1]
    y_train: np.ndarray  # (M,) int
    x_test: np.ndarray
    y_test: np.ndarray
    class_names: list


def chirp(n: int, fs: float, f0: float, f1: float, amp: float = 1.0) -> np.ndarray:
    """Linear chirp used for the filter-bank gain-response figures (Fig. 4/6)."""
    t = np.arange(n) / fs
    k = (f1 - f0) / (n / fs)
    return (amp * np.sin(2 * np.pi * (f0 * t + 0.5 * k * t * t))).astype(np.float32)


def _bandnoise(rng, n, fs, f_lo, f_hi):
    x = rng.standard_normal(n + 256)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1 / fs)
    X[(f < f_lo) | (f > f_hi)] = 0
    return np.fft.irfft(X)[:n]


def _impulse_train(rng, n, fs, rate_hz, decay, carrier=None):
    y = np.zeros(n)
    period = int(fs / rate_hz)
    phase = rng.integers(0, period)
    t = np.arange(n)
    for start in range(phase, n, period):
        m = n - start
        env = np.exp(-np.arange(m) / (decay * fs))
        y[start:] += env
    if carrier:
        y = y * np.sin(2 * np.pi * carrier * t / fs)
    return y


def _harmonic(rng, n, fs, f0, nharm, jitter=0.0):
    t = np.arange(n) / fs
    y = np.zeros(n)
    for h in range(1, nharm + 1):
        f = f0 * h * (1 + jitter * rng.standard_normal())
        if f < fs / 2:
            y += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) / h
    return y


def _synth_class(rng: np.random.Generator, cls: str, n: int, fs: float) -> np.ndarray:
    j = lambda lo, hi: rng.uniform(lo, hi)
    if cls == "dog":  # repeated barks: AM band noise bursts 400-900 Hz
        y = _bandnoise(rng, n, fs, j(300, 500), j(800, 1200))
        y *= _impulse_train(rng, n, fs, j(2, 4), 0.06)
    elif cls == "rain":  # broadband noise, mild high-freq tilt
        y = _bandnoise(rng, n, fs, j(800, 1500), fs / 2 * 0.95)
    elif cls == "sea_waves":  # low-freq AM broadband noise
        y = _bandnoise(rng, n, fs, 50, j(1200, 2500))
        t = np.arange(n) / fs
        y *= 0.6 + 0.4 * np.sin(2 * np.pi * j(0.2, 0.5) * t)
    elif cls == "crying_baby":  # harmonic sweep ~350-600 Hz fundamental
        y = _harmonic(rng, n, fs, j(350, 600), 8, 0.01)
        t = np.arange(n) / fs
        y *= 0.5 + 0.5 * np.sin(2 * np.pi * j(1.0, 2.0) * t) ** 2
    elif cls == "clock_tick":  # sharp periodic clicks ~2 Hz, bright
        y = _impulse_train(rng, n, fs, j(1.8, 2.2), 0.004, carrier=j(2500, 4500))
    elif cls == "person_sneeze":  # single broadband burst
        y = _bandnoise(rng, n, fs, j(200, 400), j(3000, 6000))
        c = rng.integers(n // 4, 3 * n // 4)
        env = np.exp(-((np.arange(n) - c) ** 2) / (2 * (0.05 * fs) ** 2))
        y *= env
    elif cls == "helicopter":  # low-rate rotor thump + low band noise
        y = _impulse_train(rng, n, fs, j(10, 14), 0.02, carrier=j(80, 160))
        y += 0.3 * _bandnoise(rng, n, fs, 40, 400)
    elif cls == "chainsaw":  # dense harmonic buzz ~100 Hz + noise
        y = _harmonic(rng, n, fs, j(90, 130), 20, 0.02)
        y += 0.4 * _bandnoise(rng, n, fs, 500, 4000)
    elif cls == "rooster":  # rising-falling harmonic whoop
        f0 = j(500, 800)
        sweep = chirp(n, fs, f0, f0 * j(1.5, 2.0))
        y = sweep + 0.5 * _harmonic(rng, n, fs, f0, 4, 0.02)
    elif cls == "fire_crackling":  # sparse random crackles
        y = np.zeros(n)
        for _ in range(rng.integers(10, 30)):
            c = rng.integers(0, n - 200)
            y[c:c + 200] += np.exp(-np.arange(200) / 30.0) * rng.standard_normal()
        y += 0.15 * _bandnoise(rng, n, fs, 100, 2000)
    else:
        raise ValueError(cls)
    y = y + 10 ** (-j(15, 25) / 20) * rng.standard_normal(n)  # noise floor
    y = y / (np.max(np.abs(y)) + 1e-9)
    return y.astype(np.float32)


def make_esc10_like(per_class_train: int = 24, per_class_test: int = 8,
                    fs: float = 16000.0, seconds: float = 1.0,
                    seed: int = 0) -> AcousticDataset:
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for ci, cls in enumerate(ESC10_CLASSES):
        for _ in range(per_class_train):
            xs_tr.append(_synth_class(rng, cls, n, fs)); ys_tr.append(ci)
        for _ in range(per_class_test):
            xs_te.append(_synth_class(rng, cls, n, fs)); ys_te.append(ci)
    perm = rng.permutation(len(xs_tr))
    x_tr = np.stack(xs_tr)[perm]; y_tr = np.asarray(ys_tr)[perm]
    return AcousticDataset(x_tr, y_tr, np.stack(xs_te), np.asarray(ys_te),
                           list(ESC10_CLASSES))


def make_fsdd_like(per_speaker_train: int = 40, per_speaker_test: int = 12,
                   fs: float = 8000.0, seconds: float = 0.5,
                   seed: int = 1) -> AcousticDataset:
    """Two synthetic speakers; task = speaker identification (Table IV)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    # speaker-specific formant layouts (Hz)
    speakers = {
        0: dict(f0=(110, 140), formants=[(600, 80), (1100, 120), (2400, 160)]),
        1: dict(f0=(190, 240), formants=[(750, 90), (1500, 130), (2900, 170)]),
    }

    def sample(spk):
        sp = speakers[spk]
        f0 = rng.uniform(*sp["f0"])
        t = np.arange(n) / fs
        src = np.zeros(n)
        for h in range(1, int(fs / 2 / f0)):
            src += np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi)) / h
        X = np.fft.rfft(src)
        f = np.fft.rfftfreq(n, 1 / fs)
        shape = np.zeros_like(f)
        for fc, bw in sp["formants"]:
            fc_j = fc * rng.uniform(0.93, 1.07)
            shape += np.exp(-0.5 * ((f - fc_j) / bw) ** 2)
        y = np.fft.irfft(X * (0.05 + shape), n)
        y += 10 ** (-20 / 20) * rng.standard_normal(n)
        return (y / (np.max(np.abs(y)) + 1e-9)).astype(np.float32)

    xs_tr, ys_tr, xs_te, ys_te = [], [], [], []
    for spk in speakers:
        for _ in range(per_speaker_train):
            xs_tr.append(sample(spk)); ys_tr.append(spk)
        for _ in range(per_speaker_test):
            xs_te.append(sample(spk)); ys_te.append(spk)
    perm = rng.permutation(len(xs_tr))
    return AcousticDataset(np.stack(xs_tr)[perm], np.asarray(ys_tr)[perm],
                           np.stack(xs_te), np.asarray(ys_te),
                           ["speaker_0", "speaker_1"])
