"""Model configurations of the port.

``esc10_mp``: the paper's acoustic classifier. The transformer zoo's
configs ported so far are reached by name through :func:`get_arch` (full
size) and :func:`get_smoke` (the reduced same-family config of the CPU
tests); the reference's other architectures are queued in ROADMAP.md.
"""

from __future__ import annotations

import importlib

# canonical ids (dash form) -> module name, for the configs ported so far
ARCH_IDS = {"qwen3-8b": "qwen3_8b"}


def _module(name: str):
    mod = ARCH_IDS.get(name, name if name in ARCH_IDS.values() else None)
    if mod is None:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to PyTorch yet (ported: "
            f"{sorted(ARCH_IDS)}); the rest are queued in ROADMAP.md")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
