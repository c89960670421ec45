"""Carry the reference package's parameters and state into the port.

The reference draws its classifier weights and standardization statistics
from ``jax.random``, which torch cannot regenerate, so a port built from
the same seed has different weights. The bridge takes them as **numpy
arrays** (the caller does ``np.asarray`` on the JAX side) and builds the
port's objects from them; it imports no JAX.

* :func:`config_from_fields` — a ``FilterBankConfig`` from the reference's
  config (its ``_asdict()`` or any mapping of the same field names);
* :func:`pipeline_from_numpy` — an ``InFilterPipeline`` from the config
  fields, per-octave ``bp_taps``, per-stage ``lp_taps``, ``mu``, ``sigma``
  and the five ``MPKernelMachineParams`` leaves in field order;
* :func:`session_from_numpy` / :func:`session_to_numpy` — a
  ``SessionState`` in either direction, as a tuple of numpy leaves in the
  reference's field order (``delays`` and ``consumed`` as tuples).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.filterbank import FilterBankConfig
from repro_torch.core.kernel_machine import MPKernelMachineParams
from repro_torch.core.pipeline import InFilterPipeline, SessionState
from repro_torch.device import resolve_device

__all__ = ["config_from_fields", "pipeline_from_numpy", "session_from_numpy",
           "session_to_numpy"]


def config_from_fields(fields) -> FilterBankConfig:
    """``fields``: a mapping, or a NamedTuple with ``_asdict()``."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    return FilterBankConfig(**dict(fields))


def pipeline_from_numpy(config, bp_taps, lp_taps, mu, sigma, clf_leaves,
                        device=None, **overrides) -> InFilterPipeline:
    """Build the port's pipeline from the reference's numpy parameters.
    ``overrides`` replace config fields (e.g. ``stream_impl="pallas"``)."""
    cfg = config_from_fields(config)._replace(**overrides)
    as_np = lambda a: np.array(a, np.float32)   # a writable copy
    clf = MPKernelMachineParams(*(torch.from_numpy(as_np(a))
                                  for a in clf_leaves))
    return InFilterPipeline(
        cfg, [torch.from_numpy(as_np(t)) for t in bp_taps],
        [torch.from_numpy(as_np(t)) for t in lp_taps],
        torch.from_numpy(as_np(mu)), torch.from_numpy(as_np(sigma)), clf,
        device=device)


def session_from_numpy(leaves, device=None) -> SessionState:
    """``leaves``: (delays, consumed, acc, amax, count, active) with the
    first two tuples, as the reference's ``SessionState`` holds them."""
    dev = resolve_device(device)
    delays, consumed, acc, amax, count, active = leaves
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return SessionState(
        delays=tuple(f32(d) for d in delays),
        consumed=tuple(i32(c) for c in consumed),
        acc=f32(acc), amax=f32(amax), count=i32(count),
        active=torch.tensor(np.asarray(active, bool), device=dev))


def session_to_numpy(state: SessionState) -> tuple:
    """The inverse of :func:`session_from_numpy`."""
    np_ = lambda t: t.detach().cpu().numpy()
    return (tuple(np_(d) for d in state.delays),
            tuple(np_(c) for c in state.consumed),
            np_(state.acc), np_(state.amax), np_(state.count),
            np_(state.active))
