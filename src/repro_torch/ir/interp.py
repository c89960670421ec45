"""Pure-Python ground-truth executor for the fixed-point IR.

Executes a :class:`~repro_torch.ir.isa.Program` on numpy int32/bool
arrays with the integer semantics the port's int32 torch programs have:
two's-complement wraparound (reductions forced to ``dtype=int32`` so
numpy's int64 accumulator cannot mask a hardware overflow), arithmetic
right shift on negatives, clamped dynamic-slice starts, XLA-style gather
dimension numbers. It is the reference the torch re-emitter, the
generated C and the simulated netlist are held against bit for bit, and
deliberately simple rather than fast.

A program with a ``grid`` region is a census surface, not a sequential
SSA stream, and raises.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ir.isa import Program


def _asr(x: np.ndarray, k) -> np.ndarray:
    # numpy >> on signed ints IS arithmetic — keep the helper as the single
    # named place the semantics live (cgen emits the portable equivalent)
    return np.right_shift(x, k).astype(np.int32)


def _shl(x: np.ndarray, k) -> np.ndarray:
    # int32 wraparound semantics: shift in the unsigned domain
    return (np.left_shift(x.astype(np.uint32), k)).astype(np.int32)


def _shrl(x: np.ndarray, k) -> np.ndarray:
    return np.right_shift(x.astype(np.uint32), k).astype(np.int32)


def _pad(x: np.ndarray, padval, config) -> np.ndarray:
    """XLA ``pad`` semantics: per-dim (lo, hi, interior), negative lo/hi
    trim."""
    out = x
    for d, (lo, hi, interior) in enumerate(config):
        lo, hi, interior = int(lo), int(hi), int(interior)
        if interior:
            n = out.shape[d]
            dil = max(n + (n - 1) * interior, 0)
            shape = list(out.shape)
            shape[d] = dil
            y = np.full(shape, padval, dtype=out.dtype)
            idx = [slice(None)] * out.ndim
            idx[d] = slice(0, dil, interior + 1)
            y[tuple(idx)] = out
            out = y
        if lo < 0:
            idx = [slice(None)] * out.ndim
            idx[d] = slice(-lo, None)
            out = out[tuple(idx)]
            lo = 0
        if hi < 0:
            idx = [slice(None)] * out.ndim
            idx[d] = slice(None, out.shape[d] + hi)
            out = out[tuple(idx)]
            hi = 0
        if lo or hi:
            width = [(0, 0)] * out.ndim
            width[d] = (lo, hi)
            out = np.pad(out, width, constant_values=padval)
    return out


def _gather(operand: np.ndarray, indices: np.ndarray, a: dict,
            out_shape: tuple) -> np.ndarray:
    """General XLA gather (index vector dim = last indices dim, starts
    clamped in-range — what PROMISE_IN_BOUNDS programs satisfy anyway)."""
    offset_dims = tuple(a["offset_dims"])
    collapsed = set(a["collapsed_slice_dims"])
    op_batch = list(a["operand_batching_dims"])
    idx_batch = list(a["start_indices_batching_dims"])
    start_map = list(a["start_index_map"])
    sizes = list(a["slice_sizes"])

    batch_shape = indices.shape[:-1]
    flat_idx = indices.reshape(-1, indices.shape[-1])
    out_batch_positions = [d for d in range(len(out_shape))
                           if d not in offset_dims]
    out = np.zeros(out_shape, dtype=operand.dtype)

    for b in range(max(flat_idx.shape[0], 1)):
        bcoord = np.unravel_index(b, batch_shape) if batch_shape else ()
        spec = []
        for d in range(operand.ndim):
            if d in op_batch:
                # a batching dim is indexed by the paired indices batch
                # coordinate (integer indexing consumes the dim)
                spec.append(int(bcoord[idx_batch[op_batch.index(d)]]))
            elif d in start_map:
                s = int(flat_idx[b, start_map.index(d)])
                s = max(0, min(s, operand.shape[d] - sizes[d]))
                spec.append(slice(s, s + sizes[d]))
            else:
                spec.append(slice(0, sizes[d]))
        piece = operand[tuple(spec)]
        # collapsed slice dims are size-1 by XLA contract: squeeze them
        # (positions renumbered after batching dims were consumed)
        dims_after_batch = [d for d in range(operand.ndim)
                            if d not in op_batch]
        sq = tuple(i for i, d in enumerate(dims_after_batch)
                   if d in collapsed)
        piece = np.squeeze(piece, axis=sq) if sq else piece
        sel = [slice(None)] * len(out_shape)
        for i, p in enumerate(out_batch_positions):
            sel[p] = int(bcoord[i]) if bcoord else 0
        out[tuple(sel)] = piece
    return out


def _clamped_starts(starts, shape, sizes):
    return [max(0, min(int(s), int(dim) - int(sz)))
            for s, dim, sz in zip(starts, shape, sizes)]


class _Machine:
    def __init__(self, prog: Program, trace=None):
        self.prog = prog
        self.trace = trace
        self.env: dict = {}
        for reg, rom in prog.rom_of_reg.items():
            self.env[reg] = prog.roms[rom].data

    def _np_dtype(self, reg: int):
        return np.bool_ if self.prog.regs[reg].dtype == "i1" else np.int32

    def set(self, reg: int, val: np.ndarray) -> None:
        self.env[reg] = np.asarray(val, dtype=self._np_dtype(reg))

    def run(self, instrs) -> None:
        for ins in instrs:
            self.step(ins)

    def step(self, ins) -> None:
        env = self.env
        op = ins.op
        a = ins.attrs
        src = [env[s] for s in ins.srcs]
        d0 = ins.dests[0] if ins.dests else None

        if op == "add":
            self.set(d0, (src[0].astype(np.uint32)
                          + src[1].astype(np.uint32)))
        elif op == "sub":
            self.set(d0, (src[0].astype(np.uint32)
                          - src[1].astype(np.uint32)))
        elif op == "neg":
            self.set(d0, (-src[0].astype(np.uint32)))
        elif op == "min":
            self.set(d0, np.minimum(src[0], src[1]))
        elif op == "max":
            self.set(d0, np.maximum(src[0], src[1]))
        elif op == "abs":
            self.set(d0, np.abs(src[0]))
        elif op == "sign":
            self.set(d0, np.sign(src[0]))
        elif op == "clamp":
            lo, x, hi = src
            self.set(d0, np.minimum(np.maximum(x, lo), hi))
        elif op in ("lt", "le", "gt", "ge", "eq", "ne"):
            fn = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
                  "ge": np.greater_equal, "eq": np.equal,
                  "ne": np.not_equal}[op]
            self.set(d0, fn(src[0], src[1]))
        elif op == "select_n":
            pred, cases = src[0], src[1:]
            if pred.dtype == np.bool_ and len(cases) == 2:
                self.set(d0, np.where(pred, cases[1], cases[0]))
            else:
                stacked = np.stack(np.broadcast_arrays(*cases))
                sel = np.asarray(pred, dtype=np.intp)
                self.set(d0, np.take_along_axis(
                    stacked, np.broadcast_to(
                        sel, stacked.shape[1:])[None], axis=0)[0])
        elif op in ("and", "or", "xor"):
            fn = {"and": np.bitwise_and, "or": np.bitwise_or,
                  "xor": np.bitwise_xor}[op]
            self.set(d0, fn(src[0], src[1]))
        elif op == "not":
            x = src[0]
            self.set(d0, ~x)
        elif op == "shl":
            k = a.get("imm") if "imm" in a else src[1]
            x = src[0]
            self.set(d0, _shl(x, k))
        elif op == "shra":
            k = a.get("imm") if "imm" in a else src[1]
            self.set(d0, _asr(src[0], k))
        elif op == "shrl":
            k = a.get("imm") if "imm" in a else src[1]
            self.set(d0, _shrl(src[0], k))
        elif op == "reduce_sum":
            self.set(d0, np.sum(src[0], axis=tuple(a["axes"]),
                                dtype=np.int32))
        elif op == "reduce_max":
            self.set(d0, np.max(src[0], axis=tuple(a["axes"])))
        elif op == "reduce_min":
            self.set(d0, np.min(src[0], axis=tuple(a["axes"])))
        elif op == "broadcast":
            shape = tuple(a["shape"])
            bdims = tuple(a["broadcast_dimensions"])
            tmp = [1] * len(shape)
            for i, d in enumerate(bdims):
                tmp[d] = src[0].shape[i]
            self.set(d0, np.broadcast_to(src[0].reshape(tmp), shape))
        elif op == "reshape":
            self.set(d0, src[0].reshape(tuple(a["new_shape"])))
        elif op == "transpose":
            self.set(d0, np.transpose(src[0], tuple(a["permutation"])))
        elif op == "rev":
            self.set(d0, np.flip(src[0], axis=tuple(a["dimensions"])))
        elif op == "slice":
            idx = tuple(slice(int(s), int(l), int(st)) for s, l, st in
                        zip(a["start_indices"], a["limit_indices"],
                            a["strides"]))
            self.set(d0, src[0][idx])
        elif op == "concat":
            self.set(d0, np.concatenate(src, axis=int(a["dimension"])))
        elif op == "pad":
            self.set(d0, _pad(src[0], src[1][()] if src[1].ndim == 0
                              else src[1], a["padding_config"]))
        elif op == "iota":
            shape = tuple(a["shape"])
            dim = int(a["dimension"])
            ar = np.arange(shape[dim], dtype=np.int32)
            tmp = [1] * len(shape)
            tmp[dim] = shape[dim]
            self.set(d0, np.broadcast_to(ar.reshape(tmp), shape))
        elif op == "convert":
            if a["to"] == "i1":
                self.set(d0, src[0] != 0)
            else:
                self.set(d0, src[0].astype(np.int32))
        elif op == "mov":
            self.set(d0, src[0])
        elif op == "gather":
            self.set(d0, _gather(src[0], src[1], a,
                                 self.prog.regs[d0].shape))
        elif op == "dynamic_slice":
            operand, starts = src[0], src[1:]
            sizes = a["slice_sizes"]
            st = _clamped_starts([s[()] for s in starts],
                                 operand.shape, sizes)
            idx = tuple(slice(s, s + int(sz)) for s, sz in zip(st, sizes))
            self.set(d0, operand[idx])
        elif op == "dynamic_update_slice":
            operand, update = src[0], src[1]
            starts = src[2:]
            st = _clamped_starts([s[()] for s in starts],
                                 operand.shape, update.shape)
            out = operand.copy()
            idx = tuple(slice(s, s + sz) for s, sz in zip(st, update.shape))
            out[idx] = update
            self.set(d0, out)
        elif op == "loop":
            self._loop(ins)
        elif op == "grid":
            raise NotImplementedError(
                "grid regions are a census/verification "
                "surface, not interpretable SSA")
        else:
            raise NotImplementedError(f"IR op {op!r}")

        if self.trace is not None:
            self.trace(ins, [self.env[d] for d in ins.dests])

    def _loop(self, ins) -> None:
        rg = ins.regions[0]
        nc = ins.attrs["num_consts"]
        nk = ins.attrs["num_carry"]
        length = ins.attrs["length"]
        reverse = rg.attrs.get("reverse", False)
        consts = [self.env[s] for s in ins.srcs[:nc]]
        carry = [self.env[s] for s in ins.srcs[nc:nc + nk]]
        xs = [self.env[s] for s in ins.srcs[nc + nk:]]
        n_ys = len(rg.outputs) - nk
        ys: list = [[None] * length for _ in range(n_ys)]

        for r, v in zip(rg.inputs[:nc], consts):
            self.set(r, v)
        order = range(length - 1, -1, -1) if reverse else range(length)
        for t in order:
            for r, v in zip(rg.inputs[nc:nc + nk], carry):
                self.set(r, v)
            for r, x in zip(rg.inputs[nc + nk:], xs):
                self.set(r, x[t])
            self.run(rg.body)
            carry = [self.env[o] for o in rg.outputs[:nk]]
            for j, o in enumerate(rg.outputs[nk:]):
                ys[j][t] = self.env[o]
        for d, v in zip(ins.dests[:nk], carry):
            self.set(d, v)
        for d, col in zip(ins.dests[nk:], ys):
            shape = self.prog.regs[d].shape
            if length == 0:
                self.set(d, np.zeros(shape, dtype=self._np_dtype(d)))
            else:
                self.set(d, np.stack(col, axis=0))


def run(prog: Program, inputs, trace=None) -> list:
    """Execute ``prog`` on numpy inputs; returns the output arrays in
    program order (int32 / bool, exactly what ``fixed.infer_q`` yields).

    ``trace``, when given, is called as ``trace(instr, dest_values)``
    after EVERY executed instruction — loop bodies fire once per trip,
    the ``loop`` instruction itself once after its last trip — in exactly
    the dynamic order the Verilog FSM commits instructions, which is what
    ``repro_torch.ir.debug.first_divergence`` aligns against."""
    if not prog.executable:
        raise NotImplementedError(
            f"program {prog.name!r} contains a grid region and is not "
            "sequentially executable (census/verification surface only)")
    m = _Machine(prog, trace=trace)
    if len(inputs) != len(prog.inputs):
        raise ValueError(f"program {prog.name!r} takes {len(prog.inputs)} "
                         f"inputs, got {len(inputs)}")
    for r, v in zip(prog.inputs, inputs):
        m.set(r, np.asarray(v))
    m.run(prog.body)
    return [m.env[o] for o in prog.outputs]
