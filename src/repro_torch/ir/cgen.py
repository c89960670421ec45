"""Synthesizable-artifact emitter: fixed-point C reference + ROM inits.

Turns an executable IR :class:`~repro_torch.ir.isa.Program` into the artifact a
hardware flow consumes:

* ``program.c`` — a freestanding, dependency-free C99 translation. Every
  register is a static int32 (or uint8 predicate) array, every ROM a
  ``static const`` table, every instruction an explicit loop nest with the
  EXACT integer semantics of the int32 torch path: two's-complement wraparound via
  unsigned arithmetic (signed overflow is UB in C — the generated code
  never relies on it), portable arithmetic right shift, clamped
  dynamic-slice starts, full gather dimension-number semantics. The
  ``main()`` harness reads raw little-endian inputs and writes raw
  outputs, which is how tests/test_torch_ir.py pins the compiled binary
  bit-for-bit against ``fixed.infer_q``.
* ``rom/<name>.mem`` — one init file per ROM: one 8-hex-digit
  two's-complement word per line (the ``$readmemh`` format Verilog ROM
  inference consumes on the paper's Spartan-7 target).

The emitted bytes are a pure function of the Program (no timestamps, no
environment), so tier-1 drift-gates them exactly like ANALYSIS.json.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ir.isa import Program

_PRELUDE = r"""/* Generated fixed-point reference — see repro_torch.ir.cgen. Do not edit. */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

static int32_t add32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
static int32_t sub32(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
static int32_t neg32(int32_t a) { return (int32_t)(0u - (uint32_t)a); }
static int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }
static int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }
static int32_t abs32(int32_t a) { return a < 0 ? neg32(a) : a; }
static int32_t sign32(int32_t a) { return a > 0 ? 1 : (a < 0 ? -1 : 0); }
static int32_t shl32(int32_t x, int32_t k) {
    if (k >= 32 || k < 0) return 0;
    return (int32_t)((uint32_t)x << k);
}
static int32_t asr32(int32_t x, int32_t k) {
    if (k < 0) k = 0;
    if (k >= 32) return x < 0 ? -1 : 0;
    if (k == 0) return x;
    {
        uint32_t s = (uint32_t)x >> k;
        if (x < 0) s |= ~(uint32_t)0 << (32 - k);
        return (int32_t)s;
    }
}
static int32_t shrl32(int32_t x, int32_t k) {
    if (k >= 32 || k < 0) return 0;
    return (int32_t)((uint32_t)x >> k);
}
static long clamp_start(long s, long dim, long size) {
    if (s < 0) s = 0;
    if (s > dim - size) s = dim - size;
    return s;
}
"""


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _strides(shape) -> list:
    st = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        st[d] = st[d + 1] * int(shape[d + 1])
    return st


def _fmt_words(vals) -> str:
    parts, line = [], []
    for v in vals:
        line.append(str(int(v)))
        if len(line) == 12:
            parts.append(", ".join(line))
            line = []
    if line:
        parts.append(", ".join(line))
    return ",\n    ".join(parts)


class _CGen:
    def __init__(self, prog: Program):
        self.prog = prog
        self.lines: list = []
        self._tmp = 0

    # -- naming -----------------------------------------------------------

    def reg_name(self, idx: int) -> str:
        return f"r{idx}"

    def ctype(self, idx: int) -> str:
        return "uint8_t" if self.prog.regs[idx].dtype == "i1" else "int32_t"

    def shape(self, idx: int) -> tuple:
        return self.prog.regs[idx].shape

    def emit(self, s: str = "") -> None:
        self.lines.append(s)

    def fresh(self, stem: str) -> str:
        self._tmp += 1
        return f"{stem}{self._tmp}"

    # -- declarations -----------------------------------------------------

    def declarations(self) -> None:
        p = self.prog
        for rom in p.roms:
            data = np.ravel(rom.data).astype(np.int64)
            ct = "uint8_t" if rom.data.dtype == np.bool_ else "int32_t"
            self.emit(f"static const {ct} {rom.name}[{max(data.size, 1)}]"
                      f" = {{\n    {_fmt_words(data)}\n}};")
        self.emit()
        for reg in p.regs:
            rom = p.rom_of_reg.get(reg.idx)
            if rom is not None:
                self.emit(f"static const {self.ctype(reg.idx)} *const "
                          f"{self.reg_name(reg.idx)} = {p.roms[rom].name};")
            else:
                self.emit(f"static {self.ctype(reg.idx)} "
                          f"{self.reg_name(reg.idx)}"
                          f"[{max(reg.size, 1)}];")
        self.emit()

    # -- loop helpers -----------------------------------------------------

    def _coords(self, body: list, ivar: str, shape, cvar: str) -> list:
        """Emit coord decomposition of flat ``ivar`` over ``shape`` into
        ``cvar0..``; returns coord var names."""
        st = _strides(shape)
        names = []
        t = self.fresh("t")
        body.append(f"long {t} = {ivar};")
        for d in range(len(shape)):
            c = f"{cvar}{d}"
            names.append(c)
            if d < len(shape) - 1:
                body.append(f"long {c} = {t} / {st[d]}; {t} %= {st[d]};")
            else:
                body.append(f"long {c} = {t};")
        return names

    def flat_loop(self, n: int, body_fn) -> None:
        i = self.fresh("i")
        body: list = []
        body_fn(i, body)
        self.emit(f"for (long {i} = 0; {i} < {n}; ++{i}) {{")
        for ln in body:
            self.emit(f"    {ln}")
        self.emit("}")

    def _needs_bcast(self, d0: int, srcs) -> bool:
        ds = self.shape(d0)
        return any(self.shape(s) != ds and len(self.shape(s)) > 0
                   for s in srcs)

    def _bcast_index(self, s: int, coords, dest_shape) -> str:
        """numpy-broadcast source index from dest coords: size-1 dims get
        stride 0, missing leading dims are dropped."""
        shape = self.shape(s)
        if len(shape) == 0:
            return "0"
        st = _strides(shape)
        off = len(dest_shape) - len(shape)
        terms = [f"{coords[off + i]} * {st[i]}"
                 for i in range(len(shape)) if int(shape[i]) != 1]
        return " + ".join(terms) if terms else "0"

    def _ew(self, ins, expr_fn) -> None:
        """Elementwise loop with full broadcast semantics; ``expr_fn``
        maps src element-ref strings to the rhs expression."""
        d0 = ins.dests[0]
        dn = self.reg_name(d0)
        N = max(self.prog.regs[d0].size, 1)
        dest_shape = self.shape(d0)
        if not self._needs_bcast(d0, ins.srcs):
            def body(i, b):
                refs = [f"{self.reg_name(s)}"
                        f"[{'0' if len(self.shape(s)) == 0 else i}]"
                        for s in ins.srcs]
                b.append(f"{dn}[{i}] = {expr_fn(refs)};")
            self.flat_loop(N, body)
            return

        def body(i, b):
            coords = self._coords(b, i, dest_shape, self.fresh("c"))
            refs = [f"{self.reg_name(s)}"
                    f"[{self._bcast_index(s, coords, dest_shape)}]"
                    for s in ins.srcs]
            b.append(f"{dn}[{i}] = {expr_fn(refs)};")
        self.flat_loop(N, body)

    # -- instruction lowering ---------------------------------------------

    def instr(self, ins) -> None:
        op, a = ins.op, ins.attrs
        d0 = ins.dests[0] if ins.dests else None
        dn = self.reg_name(d0) if d0 is not None else None
        srcs = ins.srcs
        N = max(self.prog.regs[d0].size, 1) if d0 is not None else 0
        self.emit(f"/* {op} {ins.aten_op and f'[{ins.aten_op}] ' or ''}"
                  f"-> r{d0} */")

        bin_fn = {"add": "add32", "sub": "sub32", "min": "min32",
                  "max": "max32"}
        cmp_c = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=",
                 "eq": "==", "ne": "!="}

        if op in bin_fn:
            f = bin_fn[op]
            self._ew(ins, lambda r: f"{f}({r[0]}, {r[1]})")
        elif op == "neg":
            self._ew(ins, lambda r: f"neg32({r[0]})")
        elif op == "abs":
            self._ew(ins, lambda r: f"abs32({r[0]})")
        elif op == "sign":
            self._ew(ins, lambda r: f"sign32({r[0]})")
        elif op == "clamp":
            self._ew(ins, lambda r: f"min32(max32({r[1]}, {r[0]}), {r[2]})")
        elif op in cmp_c:
            c = cmp_c[op]
            self._ew(ins, lambda r: f"{r[0]} {c} {r[1]} ? 1 : 0")
        elif op == "select_n":
            n_cases = len(srcs) - 1

            def sel(r):
                expr = r[-1]
                for k in range(n_cases - 2, -1, -1):
                    expr = f"{r[0]} == {k} ? {r[1 + k]} : ({expr})"
                return expr
            self._ew(ins, sel)
        elif op in ("and", "or", "xor"):
            c = {"and": "&", "or": "|", "xor": "^"}[op]
            self._ew(ins, lambda r: f"{r[0]} {c} {r[1]}")
        elif op == "not":
            if self.prog.regs[d0].dtype == "i1":
                self._ew(ins, lambda r: f"{r[0]} ? 0 : 1")
            else:
                self._ew(ins, lambda r: f"~{r[0]}")
        elif op in ("shl", "shra", "shrl"):
            f = {"shl": "shl32", "shra": "asr32", "shrl": "shrl32"}[op]
            if "imm" in a:
                k = int(a["imm"])
                self._ew(ins, lambda r: f"{f}({r[0]}, {k})")
            else:
                self._ew(ins, lambda r: f"{f}({r[0]}, {r[1]})")
        elif op in ("reduce_sum", "reduce_max", "reduce_min"):
            self._reduce(ins)
        elif op == "broadcast":
            self._broadcast(ins)
        elif op in ("reshape", "mov"):
            s = srcs[0]
            if self.ctype(d0) == self.ctype(s):
                self.emit(f"memcpy({dn}, {self.reg_name(s)}, "
                          f"sizeof({self.ctype(d0)}) * {N});")
            else:
                ct = self.ctype(d0)
                self._ew(ins, lambda r: f"({ct}){r[0]}")
        elif op == "convert":
            if a["to"] == "i1":
                self._ew(ins, lambda r: f"{r[0]} != 0 ? 1 : 0")
            else:
                self._ew(ins, lambda r: f"(int32_t){r[0]}")
        elif op == "transpose":
            self._transpose(ins)
        elif op == "rev":
            self._rev(ins)
        elif op == "slice":
            self._slice(ins)
        elif op == "concat":
            self._concat(ins)
        elif op == "pad":
            self._pad(ins)
        elif op == "iota":
            self._iota(ins)
        elif op == "gather":
            self._gather(ins)
        elif op == "dynamic_slice":
            self._dynamic_slice(ins)
        elif op == "dynamic_update_slice":
            self._dus(ins)
        elif op == "loop":
            self._loop(ins)
        else:
            raise NotImplementedError(f"IR op {op!r} in C emitter")

    def _reduce(self, ins) -> None:
        op = ins.op
        d0, src = ins.dests[0], ins.srcs[0]
        axes = set(ins.attrs["axes"])
        src_shape = self.shape(src)
        dn = self.reg_name(d0)
        N = max(self.prog.regs[d0].size, 1)
        init = {"reduce_sum": "0", "reduce_max": "(-2147483647 - 1)",
                "reduce_min": "2147483647"}[op]
        self.flat_loop(N, lambda i, b: b.append(f"{dn}[{i}] = {init};"))
        kept = [d for d in range(len(src_shape)) if d not in axes]
        out_st = _strides([int(src_shape[d]) for d in kept])

        def body(i, b):
            coords = self._coords(b, i, src_shape, self.fresh("c"))
            terms = [f"{coords[d]} * {out_st[j]}"
                     for j, d in enumerate(kept)]
            dst = " + ".join(terms) if terms else "0"
            acc = {"reduce_sum": "add32", "reduce_max": "max32",
                   "reduce_min": "min32"}[op]
            b.append(f"{dn}[{dst}] = {acc}({dn}[{dst}], "
                     f"{self.reg_name(src)}[{i}]);")
        self.flat_loop(max(_size(src_shape), 1), body)

    # -- movement codegen --------------------------------------------------

    def _map_loop(self, d0: int, src: int, coord_to_src) -> None:
        """dest flat loop; ``coord_to_src(coords) -> src index expr``."""
        shape = self.shape(d0)
        dn = self.reg_name(d0)

        def body(i, b):
            coords = self._coords(b, i, shape, self.fresh("c"))
            b.append(f"{dn}[{i}] = {self.reg_name(src)}"
                     f"[{coord_to_src(coords)}];")
        self.flat_loop(max(self.prog.regs[d0].size, 1), body)

    def _broadcast(self, ins) -> None:
        a = ins.attrs
        src_shape = self.shape(ins.srcs[0])
        bdims = list(a["broadcast_dimensions"])
        src_st = _strides(src_shape)

        def to_src(coords):
            terms = []
            for i, d in enumerate(bdims):
                if int(src_shape[i]) != 1:
                    terms.append(f"{coords[d]} * {src_st[i]}")
            return " + ".join(terms) if terms else "0"
        self._map_loop(ins.dests[0], ins.srcs[0], to_src)

    def _transpose(self, ins) -> None:
        perm = list(ins.attrs["permutation"])
        src_st = _strides(self.shape(ins.srcs[0]))

        def to_src(coords):
            terms = [f"{coords[d]} * {src_st[perm[d]]}"
                     for d in range(len(perm))]
            return " + ".join(terms) if terms else "0"
        self._map_loop(ins.dests[0], ins.srcs[0], to_src)

    def _rev(self, ins) -> None:
        dims = set(ins.attrs["dimensions"])
        src_shape = self.shape(ins.srcs[0])
        src_st = _strides(src_shape)

        def to_src(coords):
            terms = []
            for d in range(len(src_shape)):
                c = (f"({src_shape[d]} - 1 - {coords[d]})"
                     if d in dims else coords[d])
                terms.append(f"{c} * {src_st[d]}")
            return " + ".join(terms) if terms else "0"
        self._map_loop(ins.dests[0], ins.srcs[0], to_src)

    def _slice(self, ins) -> None:
        a = ins.attrs
        src_st = _strides(self.shape(ins.srcs[0]))
        starts, strides = a["start_indices"], a["strides"]

        def to_src(coords):
            terms = [f"({starts[d]} + {coords[d]} * {strides[d]}) "
                     f"* {src_st[d]}" for d in range(len(src_st))]
            return " + ".join(terms) if terms else "0"
        self._map_loop(ins.dests[0], ins.srcs[0], to_src)

    def _concat(self, ins) -> None:
        axis = int(ins.attrs["dimension"])
        d0 = ins.dests[0]
        out_st = _strides(self.shape(d0))
        dn = self.reg_name(d0)
        off = 0
        for s in ins.srcs:
            sshape = self.shape(s)
            sst = _strides(sshape)

            def body(i, b, s=s, sshape=sshape, sst=sst, off=off):
                coords = self._coords(b, i, sshape, self.fresh("c"))
                terms = []
                for d in range(len(sshape)):
                    c = (f"({coords[d]} + {off})" if d == axis
                         else coords[d])
                    terms.append(f"{c} * {out_st[d]}")
                dst = " + ".join(terms) if terms else "0"
                b.append(f"{dn}[{dst}] = {self.reg_name(s)}[{i}];")
            self.flat_loop(max(_size(sshape), 1), body)
            off += int(sshape[axis])

    def _pad(self, ins) -> None:
        a = ins.attrs["padding_config"]
        d0, src, pv = ins.dests[0], ins.srcs[0], ins.srcs[1]
        dn = self.reg_name(d0)
        out_shape = self.shape(d0)
        out_st = _strides(out_shape)
        N = max(self.prog.regs[d0].size, 1)
        self.flat_loop(N, lambda i, b: b.append(
            f"{dn}[{i}] = {self.reg_name(pv)}[0];"))
        src_shape = self.shape(src)

        def body(i, b):
            coords = self._coords(b, i, src_shape, self.fresh("c"))
            terms, guards = [], []
            for d in range(len(src_shape)):
                lo, _hi, inter = (int(x) for x in a[d])
                dc = self.fresh("d")
                b.append(f"long {dc} = {lo} + {coords[d]} "
                         f"* {inter + 1};")
                guards.append(f"{dc} >= 0 && {dc} < {out_shape[d]}")
                terms.append(f"{dc} * {out_st[d]}")
            dst = " + ".join(terms) if terms else "0"
            cond = " && ".join(guards) if guards else "1"
            b.append(f"if ({cond}) {dn}[{dst}] = "
                     f"{self.reg_name(src)}[{i}];")
        self.flat_loop(max(_size(src_shape), 1), body)

    def _iota(self, ins) -> None:
        dim = int(ins.attrs["dimension"])
        d0 = ins.dests[0]
        shape = self.shape(d0)
        dn = self.reg_name(d0)

        def body(i, b):
            coords = self._coords(b, i, shape, self.fresh("c"))
            b.append(f"{dn}[{i}] = (int32_t){coords[dim]};")
        self.flat_loop(max(self.prog.regs[d0].size, 1), body)

    def _gather(self, ins) -> None:
        a = ins.attrs
        d0, operand, indices = ins.dests[0], ins.srcs[0], ins.srcs[1]
        out_shape = self.shape(d0)
        op_shape = self.shape(operand)
        idx_shape = self.shape(indices)
        op_st = _strides(op_shape)
        offset_dims = list(a["offset_dims"])
        collapsed = set(a["collapsed_slice_dims"])
        op_batch = list(a["operand_batching_dims"])
        idx_batch = list(a["start_indices_batching_dims"])
        start_map = list(a["start_index_map"])
        sizes = list(a["slice_sizes"])
        batch_shape = list(idx_shape[:-1])
        k = int(idx_shape[-1]) if idx_shape else 1
        batch_positions = [d for d in range(len(out_shape))
                           if d not in offset_dims]
        # operand dims carrying offset coords, in order
        offset_src = [d for d in range(len(op_shape))
                      if d not in collapsed and d not in op_batch]
        dn = self.reg_name(d0)

        def body(i, b):
            coords = self._coords(b, i, out_shape, self.fresh("c"))
            bcoords = [coords[p] for p in batch_positions]
            # flat index row for this batch coordinate
            ist = _strides(batch_shape + [k]) if idx_shape else [1]
            row = " + ".join(f"{c} * {ist[j]}"
                             for j, c in enumerate(bcoords)) or "0"
            rv = self.fresh("row")
            b.append(f"long {rv} = {row};")
            terms = []
            for d in range(len(op_shape)):
                if d in op_batch:
                    terms.append(
                        f"{bcoords[idx_batch[op_batch.index(d)]]}"
                        f" * {op_st[d]}")
                elif d in start_map:
                    sv = self.fresh("s")
                    b.append(
                        f"long {sv} = clamp_start((long)"
                        f"{self.reg_name(indices)}"
                        f"[{rv} + {start_map.index(d)}], "
                        f"{op_shape[d]}, {sizes[d]});")
                    if d in collapsed:
                        terms.append(f"{sv} * {op_st[d]}")
                    else:
                        oc = coords[offset_dims[offset_src.index(d)]]
                        terms.append(f"({sv} + {oc}) * {op_st[d]}")
                else:
                    oc = (coords[offset_dims[offset_src.index(d)]]
                          if d not in collapsed else "0")
                    terms.append(f"{oc} * {op_st[d]}")
            src = " + ".join(terms) if terms else "0"
            b.append(f"{dn}[{i}] = {self.reg_name(operand)}[{src}];")
        self.flat_loop(max(self.prog.regs[d0].size, 1), body)

    def _dynamic_slice(self, ins) -> None:
        a = ins.attrs
        d0, operand = ins.dests[0], ins.srcs[0]
        starts = ins.srcs[1:]
        src_shape = self.shape(operand)
        src_st = _strides(src_shape)
        sizes = a["slice_sizes"]
        svars = []
        for d, s in enumerate(starts):
            sv = self.fresh("s")
            self.emit(f"long {sv} = clamp_start((long)"
                      f"{self.reg_name(s)}[0], {src_shape[d]}, "
                      f"{sizes[d]});")
            svars.append(sv)

        def to_src(coords):
            terms = [f"({svars[d]} + {coords[d]}) * {src_st[d]}"
                     for d in range(len(src_shape))]
            return " + ".join(terms) if terms else "0"
        self.emit("{")
        self._map_loop(d0, operand, to_src)
        self.emit("}")

    def _dus(self, ins) -> None:
        d0, operand, update = ins.dests[0], ins.srcs[0], ins.srcs[1]
        starts = ins.srcs[2:]
        out_shape = self.shape(d0)
        out_st = _strides(out_shape)
        up_shape = self.shape(update)
        dn = self.reg_name(d0)
        N = max(self.prog.regs[d0].size, 1)
        self.emit(f"memcpy({dn}, {self.reg_name(operand)}, "
                  f"sizeof({self.ctype(d0)}) * {N});")
        svars = []
        self.emit("{")
        for d, s in enumerate(starts):
            sv = self.fresh("s")
            self.emit(f"long {sv} = clamp_start((long)"
                      f"{self.reg_name(s)}[0], {out_shape[d]}, "
                      f"{up_shape[d]});")
            svars.append(sv)

        def body(i, b):
            coords = self._coords(b, i, up_shape, self.fresh("c"))
            terms = [f"({svars[d]} + {coords[d]}) * {out_st[d]}"
                     for d in range(len(up_shape))]
            dst = " + ".join(terms) if terms else "0"
            b.append(f"{dn}[{dst}] = {self.reg_name(update)}[{i}];")
        self.flat_loop(max(_size(up_shape), 1), body)
        self.emit("}")

    # -- loop regions ------------------------------------------------------

    def _copy(self, dst: int, src: int) -> None:
        n = max(self.prog.regs[dst].size, 1)
        self.emit(f"memcpy({self.reg_name(dst)}, {self.reg_name(src)}, "
                  f"sizeof({self.ctype(dst)}) * {n});")

    def _loop(self, ins) -> None:
        rg = ins.regions[0]
        a = ins.attrs
        nc, nk, length = a["num_consts"], a["num_carry"], a["length"]
        reverse = rg.attrs.get("reverse", False)
        consts = ins.srcs[:nc]
        init = ins.srcs[nc:nc + nk]
        xs = ins.srcs[nc + nk:]
        cin = rg.inputs[nc:nc + nk]
        xin = rg.inputs[nc + nk:]
        for r, s in zip(rg.inputs[:nc], consts):
            self._copy(r, s)
        for r, s in zip(cin, init):
            self._copy(r, s)
        t = self.fresh("t")
        self.emit(f"for (long {t} = 0; {t} < {length}; ++{t}) {{")
        tt = f"({length} - 1 - {t})" if reverse else t
        for r, s in zip(xin, xs):
            n = max(self.prog.regs[r].size, 1)
            self.emit(f"    memcpy({self.reg_name(r)}, "
                      f"{self.reg_name(s)} + {tt} * {n}, "
                      f"sizeof({self.ctype(r)}) * {n});")
        inner = _CGen(self.prog)
        inner._tmp = self._tmp + 1000
        for bins in rg.body:
            inner.instr(bins)
        for ln in inner.lines:
            self.emit(f"    {ln}")
        self._tmp = inner._tmp
        for j, o in enumerate(rg.outputs[nk:]):
            d = ins.dests[nk + j]
            n = max(self.prog.regs[o].size, 1)
            self.emit(f"    memcpy({self.reg_name(d)} + {tt} * {n}, "
                      f"{self.reg_name(o)}, "
                      f"sizeof({self.ctype(o)}) * {n});")
        for r, o in zip(cin, rg.outputs[:nk]):
            self.emit(f"    memcpy({self.reg_name(r)}, "
                      f"{self.reg_name(o)}, "
                      f"sizeof({self.ctype(r)}) * "
                      f"{max(self.prog.regs[r].size, 1)});")
        self.emit("}")
        for d, r in zip(ins.dests[:nk], cin):
            self._copy(d, r)

    # -- program ----------------------------------------------------------

    def generate(self) -> str:
        p = self.prog
        out = [_PRELUDE]
        self.lines = []
        self.declarations()
        out.extend(self.lines)
        self.lines = []
        self.emit("static void program_run(void) {")
        body = _CGen(p)
        body._tmp = 0
        for ins in p.body:
            body.instr(ins)
        for ln in body.lines:
            self.emit(f"    {ln}")
        self.emit("}")
        self.emit()
        # harness: argv[1] raw input bytes in program order, argv[2] output
        self.emit("int main(int argc, char **argv) {")
        self.emit("    if (argc != 3) { fprintf(stderr, \"usage: %s "
                  "in.bin out.bin\\n\", argv[0]); return 2; }")
        self.emit("    FILE *fi = fopen(argv[1], \"rb\");")
        self.emit("    if (!fi) { perror(\"in\"); return 2; }")
        for r in p.inputs:
            n = max(p.regs[r].size, 1)
            self.emit(f"    if (fread({self.reg_name(r)}, "
                      f"sizeof({self.ctype(r)}), {n}, fi) != {n}) "
                      "{ fprintf(stderr, \"short read\\n\"); return 2; }")
        self.emit("    fclose(fi);")
        self.emit("    program_run();")
        self.emit("    FILE *fo = fopen(argv[2], \"wb\");")
        self.emit("    if (!fo) { perror(\"out\"); return 2; }")
        for r in p.outputs:
            n = max(p.regs[r].size, 1)
            self.emit(f"    fwrite({self.reg_name(r)}, "
                      f"sizeof({self.ctype(r)}), {n}, fo);")
        self.emit("    fclose(fo);")
        self.emit("    return 0;")
        self.emit("}")
        out.extend(self.lines)
        return "\n".join(out) + "\n"


def emit_c(prog: Program) -> str:
    """The C99 reference translation of an executable program."""
    if not prog.executable:
        raise NotImplementedError(
            f"program {prog.name!r} contains a grid region — emit C only "
            "for the sequential SSA targets")
    return _CGen(prog).generate()


def emit_rom_mem(prog: Program) -> dict:
    """``{filename: text}`` of per-ROM ``$readmemh`` init files: one
    8-hex-digit two's-complement word per line."""
    out = {}
    for rom in prog.roms:
        words = np.ravel(rom.data).astype(np.int64)
        lines = [f"{int(w) & 0xFFFFFFFF:08x}" for w in words]
        out[f"{rom.name}.mem"] = "\n".join(lines) + "\n"
    return out
