"""Model configurations of the port.

``esc10_mp``: the paper's acoustic classifier. The transformer zoo's ten
architectures (the reference's ``repro.configs.ARCH_NAMES``) are reached
by name through :func:`get_arch` (full size) and :func:`get_smoke` (the
reduced same-family config of the CPU tests).
"""

from __future__ import annotations

import importlib

# canonical ids (dash form) -> module name
ARCH_IDS = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-2.7b": "mamba2_2p7b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
    "internvl2-2b": "internvl2_2b",
    "hubert-xlarge": "hubert_xlarge",
    "glm4-9b": "glm4_9b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-72b": "qwen2_72b",
    "command-r-35b": "command_r_35b",
}


def _module(name: str):
    mod = ARCH_IDS.get(name, name if name in ARCH_IDS.values() else None)
    if mod is None:
        raise KeyError(f"unknown architecture {name!r}; known: "
                       f"{sorted(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
