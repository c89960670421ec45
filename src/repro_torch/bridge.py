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
  reference's field order (``delays`` and ``consumed`` as tuples); integer
  registers (``numerics="fixed"``) stay int32, float ones float32;
* :func:`program_to_numpy` / :func:`program_from_numpy` — a compiled
  ``FixedPointProgram`` as nested dicts of numpy arrays and ints, field by
  field. ``program_to_numpy`` reads attributes, so it takes the
  reference's program as well as the port's;
* :func:`arch_params_from_numpy` / :func:`arch_params_to_numpy` — a
  transformer's params: the reference's nested dict, whose ``layers``
  leaves (and each entry of a hybrid's ``period_layers``) are stacked on a
  leading axis (``jax.vmap`` over layers), against the port's lists of
  per-layer dicts; ``prefix_layers`` is a list in both;
* :func:`attn_cache_from_numpy` / :func:`attn_cache_to_numpy` — the decode
  cache, stacked there, per layer here: ``{"scan": ..., "prefix": [...]}``
  (attention ``{"k", "v", "pos"}`` or SSM ``{"h", "conv"}`` per layer) or
  a hybrid's ``{"periodic": [...]}``.

bfloat16 arrays (``ml_dtypes.bfloat16``, as ``np.asarray`` gives them for
a bf16 JAX array) cross bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fixed
from repro_torch.core.filterbank import FilterBankConfig
from repro_torch.core.kernel_machine import MPKernelMachineParams
from repro_torch.core.pipeline import InFilterPipeline, SessionState
from repro_torch.core.quant import FixedPointSpec
from repro_torch.device import resolve_device

__all__ = ["config_from_fields", "pipeline_from_numpy", "session_from_numpy",
           "session_to_numpy", "program_to_numpy", "program_from_numpy",
           "arch_params_from_numpy", "arch_params_to_numpy",
           "attn_cache_from_numpy", "attn_cache_to_numpy"]


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
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)

    def reg(a):   # int32 codes stay integers; float registers are float32
        a = np.asarray(a)
        return i32(a) if np.issubdtype(a.dtype, np.integer) else \
            torch.tensor(np.asarray(a, np.float32), device=dev)

    return SessionState(
        delays=tuple(reg(d) for d in delays),
        consumed=tuple(i32(c) for c in consumed),
        acc=reg(acc), amax=reg(amax), count=i32(count),
        active=torch.tensor(np.asarray(active, bool), device=dev))


def session_to_numpy(state: SessionState) -> tuple:
    """The inverse of :func:`session_from_numpy`."""
    np_ = lambda t: t.detach().cpu().numpy()
    return (tuple(np_(d) for d in state.delays),
            tuple(np_(c) for c in state.consumed),
            np_(state.acc), np_(state.amax), np_(state.count),
            np_(state.active))


# program fields by kind: specs, arrays (None allowed), the octave tuple;
# everything else is an int (or the bank's mode string)
_SPECS = {"signal", "acc", "in_spec", "band_spec", "lp_spec", "spec", "phi"}
_ARRAYS = {"bp_q", "lp_q", "bp_rom", "lp_rom", "mu_q", "phi_shift_q",
           "phi_shift2_q", "phi_sign2_q", "wp_q", "wn_q", "bpos_q", "bneg_q"}
_NESTED = {"bank": fixed.FixedBankProgram, "clf": fixed.FixedClassifier}


def program_to_numpy(prog) -> dict:
    """A compiled ``FixedPointProgram`` (the port's or the reference's) as
    nested dicts: specs as ``(bits, exp)``, arrays as numpy, ``octaves`` as
    a list of dicts, scalars as ints."""
    def conv(obj, cls):
        out = {}
        for f in dataclasses.fields(cls):
            v = getattr(obj, f.name)
            if f.name in _NESTED:
                out[f.name] = conv(v, _NESTED[f.name])
            elif f.name == "octaves":
                out[f.name] = [conv(o, fixed.OctaveStage) for o in v]
            elif f.name in _SPECS:
                out[f.name] = None if v is None else (int(v.bits), int(v.exp))
            elif f.name in _ARRAYS:
                out[f.name] = None if v is None else np.asarray(v)
            else:
                out[f.name] = v if isinstance(v, str) else int(v)
        return out
    return conv(prog, fixed.FixedPointProgram)


def program_from_numpy(tree: dict) -> fixed.FixedPointProgram:
    """The inverse of :func:`program_to_numpy`: the port's program."""
    def build(d, cls):
        kw = {}
        for f in dataclasses.fields(cls):
            v = d[f.name]
            if f.name in _NESTED:
                kw[f.name] = build(v, _NESTED[f.name])
            elif f.name == "octaves":
                kw[f.name] = tuple(build(o, fixed.OctaveStage) for o in v)
            elif f.name in _SPECS:
                kw[f.name] = None if v is None else FixedPointSpec(*v)
            elif f.name in _ARRAYS:
                kw[f.name] = None if v is None else np.array(v)
            else:
                kw[f.name] = v
        return cls(**kw)
    return build(tree, fixed.FixedPointProgram)


# ---------------------------------------------------------------------------
# transformer params and decode caches
# ---------------------------------------------------------------------------


def _to_tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``; bfloat16 by its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16, as JAX's arrays carry it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree, n: int, dev) -> list:
    """A tree with leaves stacked on axis 0 -> n trees of tensors."""
    return [_tree_map(lambda a, i=i: _to_tensor(np.asarray(a)[i], dev), tree)
            for i in range(n)]


def _stack(trees: list):
    """n trees of tensors -> one tree of numpy leaves stacked on axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([_to_numpy(t) for t in trees])


def _stacked_len(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def arch_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The reference's transformer params (numpy leaves, ``layers`` and
    each ``period_layers`` entry stacked on axis 0) as the port's:
    ``layers`` a list of ``cfg``'s per-layer dicts, ``period_layers[i]`` a
    list over the hybrid's groups, everything else (``prefix_layers``
    included) as is, on ``device``."""
    from repro_torch.models.transformer import _layer_plan
    dev = resolve_device(device)
    plan = _layer_plan(cfg)
    out = {}
    for k, v in tree.items():
        if k in ("layers", "period_layers"):
            want = plan["n_scan"] if k == "layers" else plan.get("n_groups")
            stacks = [v] if k == "layers" else list(v)
            for st in stacks:
                n = _stacked_len(st)
                if n != want:
                    raise ValueError(f"{n} stacked {k}, {cfg.name} has "
                                     f"{want}")
            got = [_unstack(st, want, dev) for st in stacks]
            out[k] = got[0] if k == "layers" else got
        else:
            out[k] = _tree_map(lambda a: _to_tensor(a, dev), v)
    return out


def arch_params_to_numpy(params: dict) -> dict:
    """The inverse of :func:`arch_params_from_numpy`."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = _stack(v)
        elif k == "period_layers":
            out[k] = [_stack(sub) for sub in v]
        else:
            out[k] = _tree_map(_to_numpy, v)
    return out


def attn_cache_from_numpy(tree: dict, device=None) -> dict:
    """The reference's decode cache as the port's: ``{"scan": stacked on
    axis 0, "prefix": [...]}`` -> ``scan`` a list per layer (attention or
    SSM caches alike); ``{"periodic": [stacked per sublayer]}`` -> a list
    over the groups for each sublayer."""
    dev = resolve_device(device)
    if "periodic" in tree:
        return {"periodic": [_unstack(c, _stacked_len(c), dev)
                             for c in tree["periodic"]]}
    return {"scan": _unstack(tree["scan"], _stacked_len(tree["scan"]), dev),
            "prefix": [_tree_map(lambda a: _to_tensor(a, dev), c)
                       for c in tree.get("prefix", [])]}


def attn_cache_to_numpy(cache: dict) -> dict:
    """The inverse of :func:`attn_cache_from_numpy`."""
    if "periodic" in cache:
        return {"periodic": [_stack(c) for c in cache["periodic"]]}
    return {"scan": _stack(cache["scan"]),
            "prefix": [_tree_map(_to_numpy, c) for c in cache["prefix"]]}
