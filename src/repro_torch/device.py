"""Device choice for the port's entry points: the card unless asked.

Entry points (``make_pipeline``, ``InFilterPipeline``, ``FilterBank``,
``StreamServer``) put their tensors on ``cuda`` by default. Without a CUDA
device they raise instead of carrying on on the CPU; a caller that wants
the CPU (the tests, a laptop) passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
