"""Seeded synthetic audio in the manner of ESC-10: ten environmental sound
classes built from band-limited noise, impulse trains, harmonic stacks,
chirps and crackles, each clip peak-normalized to 1 with a noise floor.

A frozen copy of the port's generator (``repro_torch.data.acoustic``'s
ESC-10-like classes), so that the benchmark's inputs do not change when
the program does. Numpy on the host: the traffic is host audio.
"""

from __future__ import annotations

import numpy as np

CLASSES = ("dog", "rain", "sea_waves", "crying_baby", "clock_tick",
           "person_sneeze", "helicopter", "chainsaw", "rooster",
           "fire_crackling")


def _bandnoise(rng, n, fs, f_lo, f_hi):
    x = rng.standard_normal(n + 256)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(len(x), 1 / fs)
    X[(f < f_lo) | (f > f_hi)] = 0
    return np.fft.irfft(X)[:n]


def _impulse_train(rng, n, fs, rate_hz, decay, carrier=None):
    y = np.zeros(n)
    period = int(fs / rate_hz)
    t = np.arange(n)
    env = np.exp(-t / (decay * fs))
    for start in range(int(rng.integers(0, period)), n, period):
        y[start:] += env[:n - start]
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


def _chirp(n, fs, f0, f1):
    t = np.arange(n) / fs
    k = (f1 - f0) / (n / fs)
    return np.sin(2 * np.pi * (f0 * t + 0.5 * k * t * t))


def clip(rng: np.random.Generator, cls: str, n: int, fs: float) -> np.ndarray:
    """One clip of class ``cls``: n samples at fs, float32 in [-1, 1]."""
    j = rng.uniform
    t = np.arange(n) / fs
    if cls == "dog":
        y = _bandnoise(rng, n, fs, j(300, 500), j(800, 1200))
        y *= _impulse_train(rng, n, fs, j(2, 4), 0.06)
    elif cls == "rain":
        y = _bandnoise(rng, n, fs, j(800, 1500), fs / 2 * 0.95)
    elif cls == "sea_waves":
        y = _bandnoise(rng, n, fs, 50, j(1200, 2500))
        y *= 0.6 + 0.4 * np.sin(2 * np.pi * j(0.2, 0.5) * t)
    elif cls == "crying_baby":
        y = _harmonic(rng, n, fs, j(350, 600), 8, 0.01)
        y *= 0.5 + 0.5 * np.sin(2 * np.pi * j(1.0, 2.0) * t) ** 2
    elif cls == "clock_tick":
        y = _impulse_train(rng, n, fs, j(1.8, 2.2), 0.004,
                           carrier=j(2500, 4500))
    elif cls == "person_sneeze":
        y = _bandnoise(rng, n, fs, j(200, 400), j(3000, 6000))
        c = rng.integers(n // 4, 3 * n // 4)
        y *= np.exp(-((np.arange(n) - c) ** 2) / (2 * (0.05 * fs) ** 2))
    elif cls == "helicopter":
        y = _impulse_train(rng, n, fs, j(10, 14), 0.02, carrier=j(80, 160))
        y += 0.3 * _bandnoise(rng, n, fs, 40, 400)
    elif cls == "chainsaw":
        y = _harmonic(rng, n, fs, j(90, 130), 20, 0.02)
        y += 0.4 * _bandnoise(rng, n, fs, 500, 4000)
    elif cls == "rooster":
        f0 = j(500, 800)
        y = _chirp(n, fs, f0, f0 * j(1.5, 2.0)) \
            + 0.5 * _harmonic(rng, n, fs, f0, 4, 0.02)
    elif cls == "fire_crackling":
        y = np.zeros(n)
        for _ in range(rng.integers(10, 30)):
            c = rng.integers(0, n - 200)
            y[c:c + 200] += np.exp(-np.arange(200) / 30.0) \
                * rng.standard_normal()
        y += 0.15 * _bandnoise(rng, n, fs, 100, 2000)
    else:
        raise ValueError(f"unknown class {cls!r}")
    y = y + 10 ** (-j(15, 25) / 20) * rng.standard_normal(n)
    return (y / (np.max(np.abs(y)) + 1e-9)).astype(np.float32)


def clips(seed: int, count: int, n: int, fs: float) -> np.ndarray:
    """(count, n) float32: clip i is of class i mod 10, drawn from a
    generator seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.empty((count, n), np.float32)
    for i in range(count):
        out[i] = clip(rng, CLASSES[i % len(CLASSES)], n, fs)
    return out
