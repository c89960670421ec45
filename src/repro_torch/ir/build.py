"""Lower a traced aten graph (``repro_torch.analysis.traverse.trace``) into
the typed op-stream IR.

The port's counterpart of ``repro.ir.build``. Every input-dependent node
becomes IR instructions on the existing opcodes, so the copied back ends
(interpreter, C, register allocation, Verilog, cycle simulator) run on the
result unchanged:

* elementwise aten ops map one to one (``where`` -> ``select_n`` with the
  false case first, ``clamp_min`` -> ``max``); ``clamp`` with two bounds
  is a ``max`` then a ``min``, as the reference's ``jnp.clip`` is;
* shifts by a Python count are immediate shifts; a multiply by a positive
  power-of-two literal is a ``shl`` immediate;
* ``view``/``unsqueeze``/``squeeze`` -> ``reshape``, ``permute`` ->
  ``transpose``, ``expand`` -> ``broadcast``, ``flip`` -> ``rev``,
  ``select`` -> ``slice`` + ``reshape``, ``stack`` -> ``reshape`` +
  ``concat``;
* ``unfold`` and ``index.Tensor`` -> a point ``gather`` (every operand dim
  indexed, one element per index): a constant index table is a ROM, an
  input-dependent one is assembled from its index registers;
* dtype casts between int32 and int64 alias the same i32 register:
  ``core.fixed._sum`` sums int32 in int64 and casts back, and counts and
  indices run in int64. An int64 value must end in an int32 cast, a
  compare or an index, and its proven interval must fit int32.

Input-free nodes are folded: their values are constants (ROMs), never
instructions. Loops stay unrolled. Anything outside the contract fails the
build loudly with the offending node's name (``op@file:line (function)``):
a float value, a multiply that is not a pow2-literal scaling, a divide,
int64 that escapes into the datapath or may not fit int32, an index that
may leave its range, or an op with no lowering. "Expressible in the IR"
is the legality proof, by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis import legality
from repro_torch.analysis import intervals as ivs
from repro_torch.analysis.traverse import Traced, op_name
from repro_torch.ir.isa import Instr, Program, Reg, Rom

__all__ = ["BuildError", "build_program"]


class BuildError(ValueError):
    """The traced program is outside the IR's multiplierless contract."""


_ELEMENTWISE = {
    "add": "add", "sub": "sub", "neg": "neg", "abs": "abs", "sign": "sign",
    "maximum": "max", "minimum": "min", "clamp_min": "max",
    "clamp_max": "min",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "logical_and": "and", "logical_or": "or",
    "bitwise_not": "not", "logical_not": "not",
    "bitwise_left_shift": "shl", "__lshift__": "shl",
    "bitwise_right_shift": "shra", "__rshift__": "shra",
}
_ALIAS = {"alias", "clone", "lift_fresh_copy", "detach", "contiguous"}
_RESHAPE = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze"}
_REDUCE = {"sum": "reduce_sum", "amax": "reduce_max", "amin": "reduce_min"}


def _dtype_code(dtype: torch.dtype, what: str) -> str:
    if dtype == torch.bool:
        return "i1"
    if dtype in (torch.int32, torch.int64):
        return "i32"
    raise BuildError(
        f"{what}: dtype {dtype} is outside the int32 datapath carrier "
        "(the IR admits i32 values and i1 predicates only)")


def _shape(node) -> tuple:
    return tuple(int(d) for d in node.meta["val"].shape)


def _norm_dim(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


class _Builder:
    def __init__(self, tr: Traced, iv: dict):
        self.tr = tr
        self.iv = iv                    # node -> proven Interval
        self.regs: list = []
        self.roms: list = []
        self.rom_of_reg: dict = {}
        self.env: dict = {}             # node -> reg idx
        self._const_cache: dict = {}
        self.stream: list = []

    # -- registers --------------------------------------------------------

    def new_reg(self, shape, code: str, interval=None) -> int:
        bits = 1 if code == "i1" else 32
        required = None
        if interval is not None and code != "i1":
            rb = ivs.carrier_bits(interval)
            if rb == ivs.INF:
                interval = None
            else:
                interval = (int(interval.lo), int(interval.hi))
                required = int(rb)
        else:
            interval = None
        self.regs.append(Reg(idx=len(self.regs), shape=tuple(shape),
                             dtype=code, bits=bits, interval=interval,
                             required_bits=required))
        return self.regs[-1].idx

    def const_reg(self, val, name: str) -> int:
        """A ROM register holding a constant tensor or Python number."""
        if isinstance(val, torch.Tensor):
            arr = val.detach().cpu().numpy()
        else:
            arr = np.asarray(val)
        if arr.dtype.kind == "b":
            data = arr.astype(np.bool_)
        elif arr.dtype.kind in ("i", "u") or (
                arr.dtype.kind == "f" and np.all(arr == np.trunc(arr))):
            data = arr.astype(np.int64)
            if data.size and (data.max() > np.iinfo(np.int32).max
                              or data.min() < np.iinfo(np.int32).min):
                raise BuildError(f"constant {name} exceeds int32")
            data = data.astype(np.int32)
        else:
            raise BuildError(f"constant {name} has non-integral float "
                             "values — outside the int32 datapath")
        data = np.ascontiguousarray(data)
        key = (data.dtype.str, data.shape, data.tobytes())
        hit = self._const_cache.get(key)
        if hit is not None:
            return hit
        ridx = len(self.roms)
        self.roms.append(Rom(idx=ridx, name=f"rom{ridx}_{name}", data=data))
        reg = self.new_reg(data.shape, "i1" if data.dtype == np.bool_
                           else "i32")
        self.rom_of_reg[reg] = ridx
        self._const_cache[key] = reg
        return reg

    def read(self, a) -> int:
        """The register of an operand: a lowered node, a constant node (a
        ROM) or a Python number (a scalar ROM)."""
        if isinstance(a, torch.fx.Node):
            r = self.env.get(a)
            if r is None:
                r = self.env[a] = self.const_reg(self.tr.value(a), "c")
            return r
        if isinstance(a, bool) or isinstance(a, (int, float)):
            return self.const_reg(np.asarray(a, np.bool_ if isinstance(
                a, bool) else np.int64), "lit")
        raise BuildError(f"operand {a!r} has no IR value")

    def interval(self, a):
        if isinstance(a, torch.fx.Node):
            got = self.iv.get(a)
            if got is None and not self.tr.is_dependent(a):
                got = ivs.of_value(self.tr.value(a))
            return got
        return ivs.of_value(a) if a is not None else None

    # -- emission ---------------------------------------------------------

    def emit(self, node, op, srcs, attrs=None, *, shape=None, code=None,
             interval=None, census: bool = True) -> int:
        """Append ``dest = op(srcs)`` for ``node``; returns the dest reg."""
        shape = _shape(node) if shape is None else shape
        code = code or _dtype_code(node.meta["val"].dtype,
                                   self.tr.name(node))
        dest = self.new_reg(shape, code, interval)
        out = in_ = 0
        if census:
            out = legality.numel(shape)
            in_ = legality.in_elems(node)
        self.stream.append(Instr(op=op, dests=(dest,), srcs=tuple(srcs),
                                 attrs=dict(attrs or {}),
                                 aten_op=str(node.target),
                                 census_out_elems=out,
                                 census_in_elems=in_))
        return dest

    def fail(self, node, why: str):
        raise BuildError(f"{self.tr.name(node)}: {why}")

    # -- lowering ---------------------------------------------------------

    def lower(self, node) -> None:
        tr = self.tr
        name = op_name(node)
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            self.fail(node, "produces no single tensor")
        if val.dtype.is_floating_point:
            self.fail(node, f"float value ({val.dtype}) on the integer "
                            "datapath")
        iv = self.iv.get(node)
        if val.dtype == torch.int64:
            if not self._int64_ok(node):
                self.fail(node, "int64 value that does not end in an int32 "
                                "cast, a compare or an index")
            if iv is None or iv.lo < ivs.INT32[0] or iv.hi > ivs.INT32[1]:
                self.fail(node, f"int64 value not proven to fit the int32 "
                                f"register it is held in (proven {iv})")
        args = node.args
        if name in _ALIAS:
            self.env[node] = self.read(args[0])
            return
        if name == "_to_copy":
            src = args[0]
            sdt = src.meta["val"].dtype
            if sdt.is_floating_point:
                self.fail(node, "cast from a float value")
            if val.dtype == torch.bool and sdt != torch.bool:
                self.env[node] = self.emit(node, "convert", [self.read(src)],
                                           {"to": "i1"}, interval=iv)
            elif val.dtype != torch.bool and sdt == torch.bool:
                self.env[node] = self.emit(node, "convert", [self.read(src)],
                                           {"to": "i32"}, interval=iv)
            else:
                self.env[node] = self.read(src)
            return
        if name in ("add", "sub"):
            alpha = node.kwargs.get("alpha", 1)
            if alpha != 1:
                self.fail(node, f"alpha={alpha} is a multiply")
        if name == "mul":
            pm = legality.pow2_multiply(tr, node)
            if pm is None:
                self.fail(node, "mul is not a positive-pow2-literal scaling "
                                "— a real multiplier cannot be lowered to "
                                "the multiplierless IR")
            x, k = pm
            self.env[node] = self.emit(node, "shl", [self.read(x)],
                                       {"imm": k}, interval=iv)
            return
        if name in ("bitwise_left_shift", "__lshift__",
                    "bitwise_right_shift", "__rshift__"):
            op = _ELEMENTWISE[name]
            k = args[1]
            imm = None
            if isinstance(k, int) and not isinstance(k, bool):
                imm = k
            elif isinstance(k, torch.fx.Node) and not tr.is_dependent(k):
                kv = tr.value(k)
                if kv.dim() == 0:
                    imm = int(kv)
            if imm is not None:
                if imm < 0:
                    self.fail(node, f"negative shift count {imm}")
                self.env[node] = self.emit(node, op, [self.read(args[0])],
                                           {"imm": imm}, interval=iv)
            else:
                self.env[node] = self.emit(
                    node, op, [self.read(args[0]), self.read(k)],
                    interval=iv)
            return
        if name == "clamp":
            lo = args[1] if len(args) > 1 else node.kwargs.get("min")
            hi = args[2] if len(args) > 2 else node.kwargs.get("max")
            r = self.read(args[0])
            x_iv = self.interval(args[0])
            if lo is not None:
                if hi is not None and x_iv is not None:
                    x_iv = ivs.max_iv(x_iv, self.interval(lo))
                r = self.emit(node, "max", [r, self.read(lo)],
                              interval=x_iv if hi is not None else iv)
            if hi is not None:
                r = self.emit(node, "min", [r, self.read(hi)], interval=iv)
            self.env[node] = r
            return
        if name == "relu":
            self.env[node] = self.emit(node, "max", [self.read(args[0]),
                                                     self.read(0)],
                                       interval=iv)
            return
        if name == "where":
            c, a, b = args
            self.env[node] = self.emit(node, "select_n", [
                self.read(c), self.read(b), self.read(a)], interval=iv)
            return
        if name in _ELEMENTWISE:
            self.env[node] = self.emit(
                node, _ELEMENTWISE[name],
                [self.read(a) for a in args[:2 if name not in (
                    "neg", "abs", "sign", "bitwise_not", "logical_not")
                    else 1]], interval=iv)
            return
        if name in _REDUCE:
            x = args[0]
            rank = len(_shape(x))
            dims = args[1] if len(args) > 1 else list(range(rank))
            dims = [dims] if isinstance(dims, int) else list(dims)
            dims = sorted(_norm_dim(d, rank) for d in dims)
            keep = args[2] if len(args) > 2 else node.kwargs.get("keepdim",
                                                                 False)
            if len(args) > 3 or node.kwargs.get("dtype") is not None:
                self.fail(node, "reduction with a dtype argument")
            kept = [s for d, s in enumerate(_shape(x)) if d not in dims]
            r = self.emit(node, _REDUCE[name], [self.read(x)],
                          {"axes": dims}, shape=tuple(kept), interval=iv)
            if keep:
                r = self.emit(node, "reshape", [r],
                              {"new_shape": list(_shape(node))},
                              interval=iv, census=False)
            self.env[node] = r
            return
        self.env[node] = self.movement(node, name, args, iv)

    def movement(self, node, name, args, iv) -> int:
        out_shape = _shape(node)
        if name in _RESHAPE:
            src = self.read(args[0])
            if self.regs[src].shape == out_shape:
                return src
            return self.emit(node, "reshape", [src],
                             {"new_shape": list(out_shape)}, interval=iv)
        if name == "permute":
            return self.emit(node, "transpose", [self.read(args[0])],
                             {"permutation": [
                                 _norm_dim(d, len(out_shape))
                                 for d in args[1]]}, interval=iv)
        if name == "expand":
            x = args[0]
            rank_in = len(_shape(x))
            return self.emit(node, "broadcast", [self.read(x)], {
                "shape": list(out_shape),
                "broadcast_dimensions": list(range(
                    len(out_shape) - rank_in, len(out_shape)))},
                interval=iv)
        if name == "flip":
            rank = len(out_shape)
            return self.emit(node, "rev", [self.read(args[0])], {
                "dimensions": sorted(_norm_dim(d, rank) for d in args[1])},
                interval=iv)
        if name == "slice":
            return self._slice(node, args, iv)
        if name == "select":
            x = args[0]
            shp = _shape(x)
            d = _norm_dim(args[1], len(shp))
            i = args[2] + shp[d] if args[2] < 0 else args[2]
            start = [0] * len(shp)
            limit = list(shp)
            start[d], limit[d] = i, i + 1
            r = self.emit(node, "slice", [self.read(x)], {
                "start_indices": start, "limit_indices": limit,
                "strides": [1] * len(shp)},
                shape=tuple(limit[:d] + [1] + limit[d + 1:]), interval=iv)
            return self.emit(node, "reshape", [r],
                             {"new_shape": list(out_shape)}, interval=iv)
        if name in ("cat", "stack"):
            d = _norm_dim(args[1] if len(args) > 1 else 0,
                          len(out_shape))
            srcs = []
            for t in args[0]:
                r = self.read(t)
                if name == "stack":
                    shp = list(self.regs[r].shape)
                    shp.insert(d, 1)
                    r = self.emit(node, "reshape", [r], {"new_shape": shp},
                                  shape=tuple(shp),
                                  interval=self.interval(t))
                srcs.append(r)
            return self.emit(node, "concat", srcs, {"dimension": d},
                             interval=iv)
        if name == "constant_pad_nd":
            x, pad = args[0], list(args[1])
            value = args[2] if len(args) > 2 else node.kwargs.get("value", 0)
            rank = len(out_shape)
            cfg = [[0, 0, 0] for _ in range(rank)]
            for j in range(len(pad) // 2):
                cfg[rank - 1 - j] = [int(pad[2 * j]), int(pad[2 * j + 1]), 0]
            return self.emit(node, "pad", [self.read(x), self.read(value)],
                             {"padding_config": cfg}, interval=iv)
        if name == "unfold":
            return self._unfold(node, args, iv)
        if name == "index":
            return self._index(node, args, iv)
        if name in ("t", "transpose"):
            rank = len(out_shape)
            perm = list(range(rank))
            if name == "transpose":
                a, b = (_norm_dim(d, rank) for d in args[1:3])
                perm[a], perm[b] = perm[b], perm[a]
            else:
                perm.reverse()
            return self.emit(node, "transpose", [self.read(args[0])],
                             {"permutation": perm}, interval=iv)
        if name in legality.DIV_OPS:
            self.fail(node, f"{name} has no IR lowering — the integer "
                            "datapath must not contain a divide")
        self.fail(node, f"{node.target} is outside the multiplierless IR "
                        "instruction set")

    def _slice(self, node, args, iv) -> int:
        x = args[0]
        shp = _shape(x)
        d = _norm_dim(args[1] if len(args) > 1 else 0, len(shp))
        n = shp[d]
        start = args[2] if len(args) > 2 and args[2] is not None else 0
        end = args[3] if len(args) > 3 and args[3] is not None else n
        step = args[4] if len(args) > 4 else 1
        start = max(0, min(n, start + n if start < 0 else start))
        end = max(start, min(n, end + n if end < 0 else end))
        src = self.read(x)
        if (start, end, step) == (0, n, 1):
            return src
        lo = [0] * len(shp)
        hi = list(shp)
        st = [1] * len(shp)
        lo[d], hi[d], st[d] = start, end, int(step)
        return self.emit(node, "slice", [src], {
            "start_indices": lo, "limit_indices": hi, "strides": st},
            interval=iv)

    def _point_gather(self, node, operand: int, indices: int, iv) -> int:
        rank = len(self.regs[operand].shape)
        return self.emit(node, "gather", [operand, indices], {
            "offset_dims": [], "collapsed_slice_dims": list(range(rank)),
            "start_index_map": list(range(rank)),
            "operand_batching_dims": [], "start_indices_batching_dims": [],
            "slice_sizes": [1] * rank}, interval=iv)

    def _unfold(self, node, args, iv) -> int:
        """``x.unfold(dim, size, step)``: a point gather through a ROM of
        operand coordinates."""
        x, dim, size, step = args
        shp = _shape(x)
        d = _norm_dim(dim, len(shp))
        out = _shape(node)
        grids = np.meshgrid(*[np.arange(s) for s in out], indexing="ij")
        coords = [grids[i] for i in range(len(shp))]
        coords[d] = grids[d] * int(step) + grids[-1]
        table = np.stack(coords, axis=-1).astype(np.int32)
        return self._point_gather(node, self.read(x),
                                  self.const_reg(table, "idx"), iv)

    def _index(self, node, args, iv) -> int:
        """``x[i0, i1, ...]`` with every dim indexed by a tensor: a point
        gather. Constant index tensors form a ROM table; input-dependent
        ones are stacked into one index register, each proven in range
        (the gather would clamp where torch wraps or faults)."""
        x, idx = args
        shp = _shape(x)
        if len(idx) != len(shp) or any(i is None for i in idx):
            self.fail(node, "index.Tensor must index every dim of its "
                            "operand with a tensor")
        bshape = tuple(torch.broadcast_shapes(
            *[i.meta["val"].shape for i in idx]))
        if all(not self.tr.is_dependent(i) for i in idx):
            vals = [self.tr.value(i) for i in idx]
            table = np.stack([
                np.broadcast_to((v % s).numpy(), bshape)
                for v, s in zip(vals, shp)], axis=-1).astype(np.int32)
            return self._point_gather(node, self.read(x),
                                      self.const_reg(table, "idx"), iv)
        cols = []
        ishape = bshape + (1,)
        for i, s in zip(idx, shp):
            r_iv = self.interval(i)
            if r_iv is None or r_iv.lo < 0 or r_iv.hi > s - 1:
                self.fail(node, f"an index may leave [0, {s - 1}] "
                                f"(proven {r_iv})")
            r = self.read(i)
            if self.regs[r].shape != bshape:
                r = self.emit(node, "broadcast", [r], {
                    "shape": list(bshape),
                    "broadcast_dimensions": list(range(
                        len(bshape) - len(self.regs[r].shape),
                        len(bshape)))}, shape=bshape, code="i32",
                    interval=r_iv, census=False)
            cols.append(self.emit(node, "reshape", [r],
                                  {"new_shape": list(ishape)},
                                  shape=ishape, code="i32", interval=r_iv,
                                  census=False))
        table = self.emit(node, "concat", cols, {"dimension": len(bshape)},
                          shape=bshape + (len(shp),), code="i32",
                          census=False)
        return self._point_gather(node, self.read(x), table, iv)

    def _int64_ok(self, node) -> bool:
        """An int64 node (torch's dtype for sums, counts and indices) is
        admitted when everything it feeds ends in an int32 cast, a compare
        or an index position, possibly through more int64 arithmetic."""
        seen: dict = {}

        def ok(n) -> bool:
            if n in seen:
                return seen[n]
            seen[n] = False
            res = bool(n.users)
            for u in n.users:
                un = op_name(u)
                uval = u.meta.get("val")
                udt = uval.dtype if isinstance(uval, torch.Tensor) else None
                if un == "index":
                    if n in list(u.args[1]):
                        continue
                elif udt in (torch.int32, torch.bool):
                    if un == "_to_copy" or udt == torch.bool:
                        continue
                elif udt == torch.int64 and ok(u):
                    continue
                res = False
                break
            seen[n] = res
            return res

        return ok(node)


def build_program(tr: Traced, *, name: str, in_intervals) -> Program:
    """Lower a traced program into a typed IR :class:`Program`.

    ``in_intervals`` holds one Interval per program input, as in
    ``repro_torch.analysis.targets``. The worst-case interval pass runs
    over the same graph first: every register is typed with its proven
    interval and minimal two's-complement width, and the proofs the
    lowering needs (an input-dependent index in range, an int64 value
    inside int32) come from it.
    """
    res = ivs.analyze_intervals(tr, in_intervals)
    iv = res.by_node
    meta = {"num_instrs": None, "rom_bytes": None}
    meta.update(
        interval_ok=bool(res.ok),
        min_headroom_bits=(None if isinstance(res.min_headroom_bits, float)
                           else int(res.min_headroom_bits)),
        max_required_bits=(None if isinstance(res.max_required_bits, float)
                           else int(res.max_required_bits)))
    b = _Builder(tr, iv)
    in_regs = []
    for i, n in enumerate(tr.inputs):
        code = _dtype_code(n.meta["val"].dtype, f"input {i}")
        in_regs.append(b.new_reg(_shape(n), code, iv.get(n)))
        b.env[n] = in_regs[-1]
    for node in tr.calls():
        if tr.is_dependent(node):
            b.lower(node)
    outs = []
    for o in tr.outputs:
        if not isinstance(o, torch.fx.Node):
            raise BuildError(f"program output {o!r} is not a tensor")
        outs.append(b.read(o))
    prog = Program(name=name, inputs=tuple(in_regs), outputs=tuple(outs),
                   regs=b.regs, roms=b.roms, rom_of_reg=b.rom_of_reg,
                   body=b.stream, meta=meta, executable=True)
    prog.meta["num_instrs"] = prog.num_instrs()
    prog.meta["rom_bytes"] = prog.rom_bytes()
    return prog

