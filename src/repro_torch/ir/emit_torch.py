"""IR -> torch re-emitter: close the round trip back to the port's int path.

The port's counterpart of ``repro.ir.xla``. :func:`emit` turns an
executable :class:`~repro_torch.ir.isa.Program` into a function of torch
integer ops, one op per instruction, that runs on the device of its
inputs (its ROMs are copied there once per device). Integer arithmetic is
exact, so the function reproduces the traced ``fixed.infer_q`` /
``fixed.session_step_q`` bit for bit on the CPU and on the card: the proof
that graph -> IR -> torch loses nothing. It takes the opcodes
``repro_torch.ir.build`` emits (flat programs, point gathers) and raises
``NotImplementedError`` on any other.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.ir.isa import Program

__all__ = ["emit"]

_BINARY = {
    "add": torch.add, "sub": torch.sub, "min": torch.minimum,
    "max": torch.maximum, "lt": torch.lt, "le": torch.le, "gt": torch.gt,
    "ge": torch.ge, "eq": torch.eq, "ne": torch.ne,
    "and": torch.bitwise_and, "or": torch.bitwise_or,
    "xor": torch.bitwise_xor,
}
_UNARY = {"neg": torch.neg, "abs": torch.abs, "sign": torch.sign}


def _point_gather(operand: torch.Tensor, idx: torch.Tensor,
                  a: dict) -> torch.Tensor:
    rank = operand.dim()
    if (a["offset_dims"] or list(a["collapsed_slice_dims"]) != list(
            range(rank)) or list(a["start_index_map"]) != list(range(rank))
            or any(int(s) != 1 for s in a["slice_sizes"])):
        raise NotImplementedError("only point gathers re-emit to torch")
    idx = idx.long()
    return operand[tuple(idx[..., d] for d in range(rank))]


def emit(prog: Program):
    """Return ``fn(*inputs) -> tuple(outputs)`` reproducing ``prog`` with
    torch integer ops on the inputs' device."""
    if not prog.executable:
        raise NotImplementedError(
            f"program {prog.name!r} contains a grid region — only the "
            "sequential SSA stream re-emits to torch")
    roms_np = {reg: np.asarray(prog.roms[rom].data)
               for reg, rom in prog.rom_of_reg.items()}
    scalars = {reg: (bool(v) if v.dtype == np.bool_ else int(v))
               for reg, v in roms_np.items() if v.ndim == 0}
    on_device: dict = {}

    def roms_for(device) -> dict:
        key = str(device)
        if key not in on_device:
            on_device[key] = {reg: torch.from_numpy(v.copy()).to(device)
                              for reg, v in roms_np.items()}
        return on_device[key]

    def step(ins, env) -> None:
        op, a = ins.op, ins.attrs
        src = [env[s] for s in ins.srcs]
        d0 = ins.dests[0]
        if op in _BINARY:
            out = _BINARY[op](src[0], src[1])
        elif op in _UNARY:
            out = _UNARY[op](src[0])
        elif op == "select_n":
            if len(src) != 3:
                raise NotImplementedError("select_n with more than 2 cases")
            out = torch.where(src[0], src[2], src[1])
        elif op == "not":
            out = (torch.logical_not(src[0]) if src[0].dtype == torch.bool
                   else torch.bitwise_not(src[0]))
        elif op in ("shl", "shra"):
            k = int(a["imm"]) if "imm" in a else src[1]
            out = (torch.bitwise_left_shift(src[0], k) if op == "shl"
                   else torch.bitwise_right_shift(src[0], k))
        elif op in ("reduce_sum", "reduce_max", "reduce_min"):
            axes = tuple(a["axes"])
            x = src[0]
            if not axes:
                out = x
            elif op == "reduce_sum":
                out = x.sum(dim=axes).to(torch.int32)
            elif op == "reduce_max":
                out = x.amax(dim=axes)
            else:
                out = x.amin(dim=axes)
        elif op == "broadcast":
            shape = tuple(a["shape"])
            tmp = [1] * len(shape)
            for i, d in enumerate(a["broadcast_dimensions"]):
                tmp[d] = src[0].shape[i]
            out = src[0].reshape(tmp).expand(shape)
        elif op == "reshape":
            out = src[0].reshape(tuple(a["new_shape"]))
        elif op == "transpose":
            out = src[0].permute(tuple(a["permutation"]))
        elif op == "rev":
            out = src[0].flip(tuple(a["dimensions"]))
        elif op == "slice":
            out = src[0][tuple(slice(int(s), int(e), int(st)) for s, e, st in
                               zip(a["start_indices"], a["limit_indices"],
                                   a["strides"]))]
        elif op == "concat":
            out = torch.cat(src, dim=int(a["dimension"]))
        elif op == "pad":
            cfg = a["padding_config"]
            if any(int(c[2]) for c in cfg):
                raise NotImplementedError("interior padding")
            pad = []
            for lo, hi, _ in reversed(cfg):
                pad += [int(lo), int(hi)]
            value = scalars.get(ins.srcs[1])
            if value is None:
                value = int(src[1].reshape(()).item())
            out = F.pad(src[0], pad, value=value)
        elif op == "convert":
            out = (src[0] != 0) if a["to"] == "i1" \
                else src[0].to(torch.int32)
        elif op == "gather":
            out = _point_gather(src[0], src[1], a)
        else:
            raise NotImplementedError(f"IR op {op!r} in the torch emitter")
        env[d0] = out

    def fn(*inputs):
        if len(inputs) != len(prog.inputs):
            raise ValueError(
                f"program {prog.name!r} takes {len(prog.inputs)} inputs, "
                f"got {len(inputs)}")
        device = inputs[0].device if inputs else torch.device("cpu")
        env = dict(roms_for(device))
        for r, v in zip(prog.inputs, inputs):
            want = torch.bool if prog.regs[r].dtype == "i1" else torch.int32
            env[r] = v.to(device=device, dtype=want)
        for ins in prog.body:
            step(ins, env)
        return tuple(env[o] for o in prog.outputs)

    return fn
