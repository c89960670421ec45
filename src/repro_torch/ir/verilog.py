"""Verilog netlist backend for the typed fixed-point IR.

:func:`emit_verilog` lowers an executable :class:`~repro_torch.ir.isa.Program`
to one synthesizable Verilog-2001 module pair: a ``<name>_top`` wrapper
instantiating the ``<name>`` core, which holds

* one memory per (non-ROM) register, declared at the width the register
  allocator proves sufficient (``repro_torch.ir.alloc`` — ``required_bits``
  two's-complement, not the int32 carrier; predicates are 1-bit),
* one 32-bit ROM memory per constant table, initialized with
  ``$readmemh`` from the SAME ``rom/<name>.mem`` images the C reference
  uses (written under ``<out-dir>/<target>/rom/`` by ``repro_torch.ir.emit``),
* a single ``always @(posedge clk)`` FSM: one state per IR instruction,
  element loops expressed as behavioral ``for`` loops inside the state.
  ``scan`` regions become trip-counted state subgraphs — the datapath
  instructions inside the MP-bisection loop exist ONCE and are revisited
  every window solve, which is exactly the paper's time-multiplexed MP
  module sharing (Table I folds the whole bank onto 3 MP units).

The emitted subset is deliberately restricted so that
``repro_torch.ir.vsim`` can simulate it bit-for-bit without an external tool:

* every datapath statement reads memories into 32-bit signed scratch
  registers (``$signed(...)`` on every i32 load), computes in 32-bit
  signed context, and stores through a constant part-select truncation
  (``r[addr] = t[W-1:0]``), which pins Verilog's expression-width rules
  to the one trivial case;
* all addressing is multiplierless: loop nests keep incremental address
  registers stepped by constant adds (the per-dimension correction trick
  recovers arbitrary strides), and dynamic-index * constant-stride
  products (gather / dynamic_slice) are emitted as shift-add chains;
* control flow is one ``case (state)`` with constant labels, constant
  ``for`` bounds, ``if``/ternary — no functions, tasks, generate, or
  delays.

Machine-readable ``// @io`` / ``// @trace`` / ``// @rom`` header comments
tell the simulator (and the iverilog testbench that
:func:`emit_testbench` generates) where program inputs/outputs live and
which FSM state commits which IR instruction — that mapping is what
``repro_torch.ir.debug.first_divergence`` uses to name the first mismatching
register instead of failing with a bare assert.
"""

from __future__ import annotations

from repro_torch.ir.alloc import Allocation, allocate
from repro_torch.ir.isa import Program

__all__ = ["EmitError", "emit_verilog", "emit_testbench"]


class EmitError(Exception):
    """The program contains a construct outside the netlist subset."""


def _strides(shape) -> list:
    """Row-major element strides (suffix products)."""
    st = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        st[d] = st[d + 1] * int(shape[d + 1])
    return st


def _size(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _shape_txt(shape) -> str:
    return "x".join(str(int(d)) for d in shape) if shape else "-"


def _pow2_terms(c: int) -> list:
    """Bit positions of a positive constant: the shift-add decomposition
    of ``x * c`` (multiplierless index arithmetic)."""
    return [b for b in range(max(c.bit_length(), 1)) if (c >> b) & 1]


class _Addr:
    """One incremental address register of a loop nest: value at loop
    coordinates (c_0..c_{D-1}) is ``init + sum(c_d * stride_d)``,
    maintained with constant-add updates only."""

    def __init__(self, init, strides):
        self.init = init            # int, or str (runtime expression)
        self.strides = list(strides)
        self.name = None            # assigned by the state builder


class _St:
    """One FSM state: raw statement lines plus a symbolic successor that
    is resolved to a literal state number at render time."""

    def __init__(self, tag=""):
        self.tag = tag
        self.lines: list = []
        # ("seq",) | ("goto", st) | ("branch", cond, st_true, st_false)
        self.next = ("seq",)
        self.trace = None           # (instr_id, op, [dest mem names])


class _VGen:
    def __init__(self, prog: Program, alloc: Allocation):
        self.prog = prog
        self.alloc = alloc
        self.states: list = []
        self.max_t = 0
        self.max_a = 0
        self.max_c = 0
        self.loop_uid = 0
        self.counter_decls: list = []   # persistent loop counters/offsets
        self.shadow_decls: list = []    # (name, width, size) carry shadows
        self.instr_count = 0

    # -- naming -----------------------------------------------------------

    def mem(self, reg_idx: int) -> str:
        rom = self.prog.rom_of_reg.get(reg_idx)
        if rom is not None:
            return self.prog.roms[rom].name
        return f"r{reg_idx}"

    def _is_rom(self, reg_idx: int) -> bool:
        return reg_idx in self.prog.rom_of_reg

    def _dtype(self, reg_idx: int) -> str:
        return self.prog.regs[reg_idx].dtype

    def _width(self, reg_idx: int) -> int:
        return self.alloc.width(reg_idx)

    # -- canonical load/store forms ---------------------------------------

    def load(self, t: str, reg_idx: int, addr: str) -> str:
        m = self.mem(reg_idx)
        if self._is_rom(reg_idx):
            if self._dtype(reg_idx) == "i1":
                return f"{t} = ({m}[{addr}] != 0);"
            return f"{t} = $signed({m}[{addr}]);"
        if self._dtype(reg_idx) == "i1":
            return f"{t} = {m}[{addr}];"
        return f"{t} = $signed({m}[{addr}]);"

    def store(self, reg_idx: int, addr: str, val: str) -> str:
        m = self.mem(reg_idx)
        if self._dtype(reg_idx) == "i1":
            return f"{m}[{addr}] = ({val} != 0);"
        w = self._width(reg_idx)
        if w >= 32:
            return f"{m}[{addr}] = {val};"
        return f"{m}[{addr}] = {val}[{w - 1}:0];"

    # -- state plumbing ---------------------------------------------------

    def new_state(self, tag="") -> _St:
        st = _St(tag)
        self.states.append(st)
        return st

    def map_state(self, dims, addrs, body_fn, pre=(), post=(),
                  tag="") -> _St:
        """Emit one FSM state running a loop nest over ``dims``.

        ``addrs`` are :class:`_Addr` instances; ``body_fn(names)`` returns
        the innermost statement lines given their register names. Address
        updates are constant adds only: stride s_d per c_d iteration is
        maintained by an innermost ``+= s_{D-1}`` plus a per-level
        correction ``s_d - D_{d+1} * s_{d+1}`` after each inner sweep.
        """
        st = self.new_state(tag)
        st.lines.extend(pre)
        dims = [int(d) for d in dims]
        self.max_a = max(self.max_a, len(addrs))
        self.max_c = max(self.max_c, len(dims))
        for i, ad in enumerate(addrs):
            ad.name = f"a{i}"
            if len(ad.strides) != len(dims):
                raise EmitError("address/stride rank mismatch")
            st.lines.append(f"{ad.name} = {ad.init};")
        names = [ad.name for ad in addrs]
        body = body_fn(names)

        def inc_lines(level):
            out = []
            for ad in addrs:
                if level == len(dims) - 1:
                    delta = ad.strides[level]
                else:
                    delta = (ad.strides[level]
                             - dims[level + 1] * ad.strides[level + 1])
                if delta > 0:
                    out.append(f"{ad.name} = {ad.name} + {delta};")
                elif delta < 0:
                    out.append(f"{ad.name} = {ad.name} - {-delta};")
            return out

        if not dims or _size(dims) == 1 and not dims:
            st.lines.extend(body)
        else:
            ind = ""
            for d, n in enumerate(dims):
                st.lines.append(
                    f"{ind}for (c{d} = 0; c{d} < {n}; c{d} = c{d} + 1) "
                    "begin")
                ind += "  "
            st.lines.extend(ind + ln for ln in body)
            st.lines.extend(ind + ln for ln in inc_lines(len(dims) - 1))
            for d in range(len(dims) - 1, -1, -1):
                ind = ind[:-2]
                st.lines.append(f"{ind}end")
                if d > 0:
                    st.lines.extend(ind + ln for ln in inc_lines(d - 1))
        st.lines.extend(post)
        return st

    # -- broadcast-aware source addressing --------------------------------

    def _bcast_addr(self, src_idx: int, dshape) -> _Addr:
        """Numpy-style trailing-aligned broadcast of a source register
        into the destination iteration space (rank padding + size-1
        dims), as ``interp``/``cgen`` implement elementwise ops."""
        s = self.prog.regs[src_idx]
        sst = _strides(s.shape)
        off = len(dshape) - len(s.shape)
        if off < 0:
            raise EmitError(
                f"source r{src_idx} outranks destination in elementwise op")
        strides = []
        for d in range(len(dshape)):
            if d < off or int(s.shape[d - off]) == 1:
                strides.append(0)
            else:
                strides.append(sst[d - off])
        return _Addr(0, strides)

    # -- instruction dispatch ---------------------------------------------

    def emit_body(self, instrs) -> None:
        for ins in instrs:
            self.emit_instr(ins)

    def emit_instr(self, ins) -> None:
        iid = self.instr_count
        self.instr_count += 1
        first = len(self.states)
        op = ins.op
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            fn = self._op_elementwise
        fn(ins)
        if len(self.states) == first:
            raise EmitError(f"op {op!r} emitted no states")
        last = self.states[-1]
        last.trace = (iid, op, [self.mem(d) for d in ins.dests])
        self.states[first].tag = f"instr {iid} {op}"

    # elementwise family ---------------------------------------------------

    _EW_BODY = {
        "add": ("{0} + {1}", 2),
        "sub": ("{0} - {1}", 2),
        "neg": ("0 - {0}", 1),
        "min": ("({1} < {0}) ? {1} : {0}", 2),
        "max": ("({0} < {1}) ? {1} : {0}", 2),
        "abs": ("({0} < 0) ? (0 - {0}) : {0}", 1),
        "sign": ("({0} > 0) ? 1 : (({0} < 0) ? -1 : 0)", 1),
        "lt": ("({0} < {1}) ? 1 : 0", 2),
        "le": ("({0} <= {1}) ? 1 : 0", 2),
        "gt": ("({0} > {1}) ? 1 : 0", 2),
        "ge": ("({0} >= {1}) ? 1 : 0", 2),
        "eq": ("({0} == {1}) ? 1 : 0", 2),
        "ne": ("({0} != {1}) ? 1 : 0", 2),
        "and": ("{0} & {1}", 2),
        "or": ("{0} | {1}", 2),
        "xor": ("{0} ^ {1}", 2),
        "mov": ("{0}", 1),
        "convert": ("{0}", 1),
    }

    def _op_elementwise(self, ins) -> None:
        op = ins.op
        if op not in self._EW_BODY and op not in (
                "not", "clamp", "select_n", "shl", "shra", "shrl"):
            raise EmitError(
                f"op {op!r} is outside the netlist subset "
                f"(aten op {ins.aten_op!r})")
        d0 = ins.dests[0]
        dshape = self.prog.regs[d0].shape
        srcs = list(ins.srcs)

        def body(names):
            lines = []
            ts = []
            for i, s in enumerate(srcs):
                lines.append(self.load(f"t{i}", s, names[1 + i]))
                ts.append(f"t{i}")
            self.max_t = max(self.max_t, len(srcs) + 3)
            tr = f"t{len(srcs)}"
            if op in self._EW_BODY:
                tpl, nargs = self._EW_BODY[op]
                if len(ts) != nargs:
                    raise EmitError(f"{op}: bad arity {len(ts)}")
                lines.append(f"{tr} = {tpl.format(*ts)};")
            elif op == "not":
                if self._dtype(ins.srcs[0]) == "i1":
                    lines.append(f"{tr} = ({ts[0]} == 0) ? 1 : 0;")
                else:
                    lines.append(f"{tr} = ~{ts[0]};")
            elif op == "clamp":
                lo, x, hi = ts
                t3 = f"t{len(srcs)}"
                t4 = f"t{len(srcs) + 1}"
                lines.append(f"{t3} = ({x} < {lo}) ? {lo} : {x};")
                lines.append(f"{t4} = ({hi} < {t3}) ? {hi} : {t3};")
                tr = t4
            elif op == "select_n":
                if len(ts) != 3 or self._dtype(ins.srcs[0]) != "i1":
                    raise EmitError(
                        "select_n outside the bool-predicate 2-case form")
                lines.append(
                    f"{tr} = ({ts[0]} != 0) ? {ts[2]} : {ts[1]};")
            elif op in ("shl", "shra", "shrl"):
                vop = {"shl": "<<", "shra": ">>>", "shrl": ">>"}[op]
                if "imm" in ins.attrs:
                    k = int(ins.attrs["imm"])
                    lines.append(f"{tr} = {ts[0]} {vop} {k};")
                else:
                    lines.append(f"{tr} = {ts[0]} {vop} {ts[1]};")
            lines.append(self.store(d0, names[0], tr))
            return lines

        addrs = [_Addr(0, _strides(dshape))]
        addrs += [self._bcast_addr(s, dshape) for s in srcs]
        self.map_state(list(dshape), addrs, body, tag=ins.op)

    # shifts with immediate drop the amount operand at build time, so the
    # generic elementwise path covers them; register explicit aliases for
    # readability of dispatch
    _op_shl = _op_shra = _op_shrl = _op_elementwise
    _op_not = _op_clamp = _op_select_n = _op_elementwise

    # pure data movement ---------------------------------------------------

    def _copy_state(self, dst, src, dst_addr=None, src_addr=None,
                    dims=None, tag="copy") -> _St:
        """dst[...] = src[...] over ``dims`` (defaults: dense flat)."""
        n = self.prog.regs[src].size
        dims = [n] if dims is None else dims
        da = dst_addr or _Addr(0, [1] * len(dims))
        sa = src_addr or _Addr(0, [1] * len(dims))

        def body(names):
            self.max_t = max(self.max_t, 1)
            return [self.load("t0", src, names[1]),
                    self.store(dst, names[0], "t0")]
        return self.map_state(dims, [da, sa], body, tag=tag)

    def _op_reshape(self, ins) -> None:
        self._copy_state(ins.dests[0], ins.srcs[0], tag="reshape")

    def _op_broadcast(self, ins) -> None:
        d0 = ins.dests[0]
        dshape = self.prog.regs[d0].shape
        s = self.prog.regs[ins.srcs[0]]
        sst = _strides(s.shape)
        strides = [0] * len(dshape)
        for i, d in enumerate(ins.attrs["broadcast_dimensions"]):
            if int(s.shape[i]) != 1:
                strides[int(d)] = sst[i]
        self._copy_state(d0, ins.srcs[0],
                         dst_addr=_Addr(0, _strides(dshape)),
                         src_addr=_Addr(0, strides),
                         dims=list(dshape), tag="broadcast")

    def _op_transpose(self, ins) -> None:
        d0 = ins.dests[0]
        dshape = self.prog.regs[d0].shape
        sst = _strides(self.prog.regs[ins.srcs[0]].shape)
        perm = [int(p) for p in ins.attrs["permutation"]]
        self._copy_state(d0, ins.srcs[0],
                         dst_addr=_Addr(0, _strides(dshape)),
                         src_addr=_Addr(0, [sst[p] for p in perm]),
                         dims=list(dshape), tag="transpose")

    def _op_rev(self, ins) -> None:
        d0 = ins.dests[0]
        s = self.prog.regs[ins.srcs[0]]
        sst = _strides(s.shape)
        dims = set(int(d) for d in ins.attrs["dimensions"])
        init = sum((int(s.shape[d]) - 1) * sst[d] for d in dims)
        strides = [-sst[d] if d in dims else sst[d]
                   for d in range(len(s.shape))]
        self._copy_state(d0, ins.srcs[0],
                         dst_addr=_Addr(0, _strides(s.shape)),
                         src_addr=_Addr(init, strides),
                         dims=list(s.shape), tag="rev")

    def _op_slice(self, ins) -> None:
        d0 = ins.dests[0]
        dshape = self.prog.regs[d0].shape
        sst = _strides(self.prog.regs[ins.srcs[0]].shape)
        starts = [int(v) for v in ins.attrs["start_indices"]]
        steps = [int(v) for v in ins.attrs["strides"]]
        init = sum(st * s for st, s in zip(starts, sst))
        self._copy_state(d0, ins.srcs[0],
                         dst_addr=_Addr(0, _strides(dshape)),
                         src_addr=_Addr(init, [k * s for k, s
                                               in zip(steps, sst)]),
                         dims=list(dshape), tag="slice")

    def _op_concat(self, ins) -> None:
        d0 = ins.dests[0]
        dst = _strides(self.prog.regs[d0].shape)
        axis = int(ins.attrs["dimension"])
        off = 0
        for s in ins.srcs:
            sshape = self.prog.regs[s].shape
            self._copy_state(d0, s,
                             dst_addr=_Addr(off * dst[axis], dst),
                             src_addr=_Addr(0, _strides(sshape)),
                             dims=list(sshape), tag="concat")
            off += int(sshape[axis])

    def _op_iota(self, ins) -> None:
        d0 = ins.dests[0]
        dshape = [int(d) for d in ins.attrs["shape"]]
        dim = int(ins.attrs["dimension"])
        val = _Addr(0, [1 if d == dim else 0 for d in range(len(dshape))])

        def body(names):
            self.max_t = max(self.max_t, 1)
            return [f"t0 = {names[1]};",
                    self.store(d0, names[0], "t0")]
        self.map_state(dshape, [_Addr(0, _strides(dshape)), val], body,
                       tag="iota")

    def _op_pad(self, ins) -> None:
        d0 = ins.dests[0]
        out_shape = self.prog.regs[d0].shape
        dst = _strides(out_shape)
        s = self.prog.regs[ins.srcs[0]]
        cfg = [(int(lo), int(hi), int(it))
               for lo, hi, it in ins.attrs["padding_config"]]
        # state A: fill with the pad value (scalar register)
        pv_load = self.load("t0", ins.srcs[1], "0")
        self.max_t = max(self.max_t, 1)
        self.map_state([self.prog.regs[d0].size],
                       [_Addr(0, [1])],
                       lambda names: [self.store(d0, names[0], "t0")],
                       pre=[pv_load], tag="pad.fill")
        if s.size == 0:
            return
        # state B: scatter the operand at (lo + i*(interior+1)) per dim;
        # negative lo/hi trim via affine guard counters
        init = sum(lo * st for (lo, _h, _i), st in zip(cfg, dst))
        strides = [(it + 1) * st for (_l, _h, it), st in zip(cfg, dst)]
        addrs = [_Addr(init, strides), _Addr(0, _strides(s.shape))]
        guards = []
        for d, (lo, hi, it) in enumerate(cfg):
            if lo < 0 or hi < 0:
                g = _Addr(lo, [(it + 1) if e == d else 0
                               for e in range(len(cfg))])
                guards.append((g, int(out_shape[d])))
                addrs.append(g)

        def body(names):
            self.max_t = max(self.max_t, 2)
            lines = [self.load("t1", ins.srcs[0], names[1])]
            store = self.store(d0, names[0], "t1")
            if guards:
                conds = []
                for i, (_g, bound) in enumerate(guards):
                    gn = names[2 + i]
                    conds.append(f"({gn} >= 0) && ({gn} < {bound})")
                lines.append(f"if ({' && '.join(conds)}) begin")
                lines.append(f"  {store}")
                lines.append("end")
            else:
                lines.append(store)
            return lines
        self.map_state(list(s.shape), addrs, body, tag="pad.scatter")

    # reductions -----------------------------------------------------------

    def _op_reduce(self, ins, kind) -> None:
        d0 = ins.dests[0]
        dreg = self.prog.regs[d0]
        s = self.prog.regs[ins.srcs[0]]
        axes = set(int(a) for a in ins.attrs["axes"])
        # init = the combine-neutral element WITHIN the destination's
        # proven interval, so every narrow-width partial store is exact
        if dreg.dtype == "i1":
            init = {"sum": "0", "max": "0", "min": "1"}[kind]
        elif kind == "sum":
            init = "0"
        elif dreg.interval is not None:
            init = str(int(dreg.interval[0] if kind == "max"
                           else dreg.interval[1]))
        else:
            init = "(1 << 31)" if kind == "max" else "2147483647"
        self.max_t = max(self.max_t, 1)
        self.map_state([dreg.size], [_Addr(0, [1])],
                       lambda names: [self.store(d0, names[0], "t0")],
                       pre=[f"t0 = {init};"], tag=f"reduce.{kind}.init")

        dst_full = _strides(dreg.shape)
        kept = [d for d in range(len(s.shape)) if d not in axes]
        dstrides = [0] * len(s.shape)
        for i, d in enumerate(kept):
            dstrides[d] = dst_full[i]
        if kind == "sum":
            combine = "t2 = t0 + t1;"
        elif kind == "max":
            combine = ("t2 = t0 | t1;" if dreg.dtype == "i1"
                       else "t2 = (t0 < t1) ? t1 : t0;")
        else:
            combine = ("t2 = t0 & t1;" if dreg.dtype == "i1"
                       else "t2 = (t1 < t0) ? t1 : t0;")

        def body(names):
            self.max_t = max(self.max_t, 3)
            return [self.load("t0", d0, names[0]),
                    self.load("t1", ins.srcs[0], names[1]),
                    combine,
                    self.store(d0, names[0], "t2")]
        self.map_state(list(s.shape),
                       [_Addr(0, dstrides), _Addr(0, _strides(s.shape))],
                       body, tag=f"reduce.{kind}.acc")

    def _op_reduce_sum(self, ins):
        self._op_reduce(ins, "sum")

    def _op_reduce_max(self, ins):
        self._op_reduce(ins, "max")

    def _op_reduce_min(self, ins):
        self._op_reduce(ins, "min")

    # dynamic indexing -----------------------------------------------------

    def _shift_add(self, dst_t: str, src_t: str, c: int) -> list:
        """``dst_t = src_t * c`` for constant c >= 0 as a shift-add chain."""
        if c == 0:
            return [f"{dst_t} = 0;"]
        terms = _pow2_terms(c)
        lines = []
        first = terms[0]
        lines.append(f"{dst_t} = {src_t} << {first};" if first
                     else f"{dst_t} = {src_t};")
        for b in terms[1:]:
            lines.append(f"{dst_t} = {dst_t} + ({src_t} << {b});")
        return lines

    def _clamped_start(self, lines, t_in, t_out, max_start: int) -> None:
        lines.append(f"{t_out} = ({t_in} < 0) ? 0 : {t_in};")
        lines.append(f"{t_out} = ({t_out} > {max_start}) ? {max_start} "
                     f": {t_out};")

    def _op_dynamic_slice(self, ins) -> None:
        d0 = ins.dests[0]
        dshape = self.prog.regs[d0].shape
        opnd = self.prog.regs[ins.srcs[0]]
        sst = _strides(opnd.shape)
        sizes = [int(v) for v in ins.attrs["slice_sizes"]]
        pre = ["t9 = 0;"]
        self.max_t = max(self.max_t, 10)
        for d, start_reg in enumerate(ins.srcs[1:]):
            pre.append(self.load("t0", start_reg, "0"))
            self._clamped_start(pre, "t0", "t1",
                                int(opnd.shape[d]) - sizes[d])
            pre.extend(self._shift_add("t2", "t1", sst[d]))
            pre.append("t9 = t9 + t2;")
        self._copy_state(d0, ins.srcs[0],
                         dst_addr=_Addr(0, _strides(dshape)),
                         src_addr=_Addr("t9", sst),
                         dims=list(dshape), tag="dynamic_slice")
        # the pre block must run in the SAME state before the loop
        st = self.states[-1]
        st.lines = pre + st.lines

    def _op_dynamic_update_slice(self, ins) -> None:
        d0 = ins.dests[0]
        opnd = self.prog.regs[ins.srcs[0]]
        upd = self.prog.regs[ins.srcs[1]]
        sst = _strides(opnd.shape)
        self._copy_state(d0, ins.srcs[0], tag="dus.copy")
        pre = ["t9 = 0;"]
        self.max_t = max(self.max_t, 10)
        for d, start_reg in enumerate(ins.srcs[2:]):
            pre.append(self.load("t0", start_reg, "0"))
            self._clamped_start(pre, "t0", "t1",
                                int(opnd.shape[d]) - int(upd.shape[d]))
            pre.extend(self._shift_add("t2", "t1", sst[d]))
            pre.append("t9 = t9 + t2;")
        self._copy_state(d0, ins.srcs[1],
                         dst_addr=_Addr("t9", sst),
                         src_addr=_Addr(0, _strides(upd.shape)),
                         dims=list(upd.shape), tag="dus.update")
        st = self.states[-1]
        st.lines = pre + st.lines

    def _op_gather(self, ins) -> None:
        a = ins.attrs
        d0 = ins.dests[0]
        out_shape = self.prog.regs[d0].shape
        opnd = self.prog.regs[ins.srcs[0]]
        idx = self.prog.regs[ins.srcs[1]]
        op_st = _strides(opnd.shape)
        offset_dims = [int(v) for v in a["offset_dims"]]
        collapsed = set(int(v) for v in a["collapsed_slice_dims"])
        op_batch = [int(v) for v in a["operand_batching_dims"]]
        idx_batch = [int(v) for v in a["start_indices_batching_dims"]]
        start_map = [int(v) for v in a["start_index_map"]]
        sizes = [int(v) for v in a["slice_sizes"]]

        batch_shape = idx.shape[:-1]
        bst = _strides(batch_shape)
        k = int(idx.shape[-1]) if idx.shape else 1
        out_batch_positions = [d for d in range(len(out_shape))
                               if d not in offset_dims]
        D = len(out_shape)

        # indices-row pointer: flat batch index * k
        row_strides = [0] * D
        for i, p in enumerate(out_batch_positions):
            row_strides[p] = bst[i] * k

        # static operand offset: batching dims follow the paired indices
        # batch coordinate; free + non-collapsed slice dims follow the
        # offset_dims coordinates in operand order
        static_strides = [0] * D
        dims_no_batch = [d for d in range(len(opnd.shape))
                         if d not in op_batch]
        offset_iter = iter(offset_dims)
        for d in range(len(opnd.shape)):
            if d in op_batch:
                j = idx_batch[op_batch.index(d)]
                static_strides[out_batch_positions[j]] += op_st[d]
            elif d in collapsed:
                if d not in dims_no_batch:
                    raise EmitError("gather: collapsed batching dim")
            else:
                out_dim = next(offset_iter)
                static_strides[out_dim] += op_st[d]

        def body(names):
            self.max_t = max(self.max_t, 10)
            lines = ["t9 = 0;"]
            for j, d in enumerate(start_map):
                lines.append(self.load(
                    "t0", ins.srcs[1],
                    f"{names[2]} + {j}" if j else names[2]))
                self._clamped_start(lines, "t0", "t1",
                                    int(opnd.shape[d]) - sizes[d])
                lines.extend(self._shift_add("t2", "t1", op_st[d]))
                lines.append("t9 = t9 + t2;")
            lines.append(self.load("t3", ins.srcs[0],
                                   f"{names[1]} + t9"))
            lines.append(self.store(d0, names[0], "t3"))
            return lines

        self.map_state(list(out_shape),
                       [_Addr(0, _strides(out_shape)),
                        _Addr(0, static_strides),
                        _Addr(0, row_strides)],
                       body, tag="gather")

    # scan loops -----------------------------------------------------------

    def _op_loop(self, ins) -> None:
        rg = ins.regions[0]
        nc = int(ins.attrs["num_consts"])
        nk = int(ins.attrs["num_carry"])
        length = int(ins.attrs["length"])
        reverse = bool(rg.attrs.get("reverse", False))
        consts = list(ins.srcs[:nc])
        carries = list(ins.srcs[nc:nc + nk])
        xs = list(ins.srcs[nc + nk:])
        cin = list(rg.inputs[nc:nc + nk])
        xin = list(rg.inputs[nc + nk:])
        couts = list(rg.outputs[:nk])
        ys = list(rg.outputs[nk:])
        y_dests = list(ins.dests[nk:])
        k_dests = list(ins.dests[:nk])

        if length == 0:
            # scan of length 0: carries pass through, ys are zero-filled
            for d, s in zip(k_dests, carries):
                self._copy_state(d, s, tag="loop0.carry")
            for d in y_dests:
                self.max_t = max(self.max_t, 1)
                self.map_state(
                    [self.prog.regs[d].size], [_Addr(0, [1])],
                    lambda names, d=d: [self.store(d, names[0], "t0")],
                    pre=["t0 = 0;"], tag="loop0.ys")
            if not k_dests and not y_dests:
                self.new_state("loop0.empty").lines.append("t0 = 0;")
            return

        uid = self.loop_uid
        self.loop_uid += 1
        kv = f"k{uid}"
        self.counter_decls.append(kv)
        x_offs, y_offs = [], []
        for j, x in enumerate(xs):
            name = f"o{uid}x{j}"
            self.counter_decls.append(name)
            x_offs.append(name)
        for j in range(len(ys)):
            name = f"o{uid}y{j}"
            self.counter_decls.append(name)
            y_offs.append(name)

        # S_init: counters + per-entry const/carry binding
        init_st = self.new_state(f"loop{uid}.init")
        init_st.lines.append(f"{kv} = 0;")
        for j, (name, x) in enumerate(zip(x_offs, xs)):
            n = _size(self.prog.regs[xin[j]].shape)
            init_st.lines.append(
                f"{name} = {(length - 1) * n if reverse else 0};")
        for j, name in enumerate(y_offs):
            n = _size(self.prog.regs[ys[j]].shape)
            init_st.lines.append(
                f"{name} = {(length - 1) * n if reverse else 0};")
        for dst, src in zip(rg.inputs[:nc], consts):
            if dst != src:
                self._copy_state(dst, src, tag=f"loop{uid}.const")
        for dst, src in zip(cin, carries):
            if dst != src:
                self._copy_state(dst, src, tag=f"loop{uid}.carry0")

        head = self.new_state(f"loop{uid}.head")
        first_body = len(self.states)   # next state emitted = loop entry

        # per-trip x binding
        for j, (x, dst) in enumerate(zip(xs, xin)):
            n = _size(self.prog.regs[dst].shape)
            self._copy_state(dst, x,
                             dst_addr=_Addr(0, [1]),
                             src_addr=_Addr(x_offs[j], [1]),
                             dims=[n], tag=f"loop{uid}.x{j}")
        if not xs and first_body == len(self.states) and not rg.body:
            # degenerate: loop with an empty body still needs an entry
            self.new_state(f"loop{uid}.body").lines.append("t0 = 0;")

        self.emit_body(rg.body)

        # per-trip tail: ys stores, carry copy (through shadows if the
        # output registers alias other carry input slots), trip advance
        for j, (y, d) in enumerate(zip(ys, y_dests)):
            n = _size(self.prog.regs[y].shape)
            self._copy_state(d, y,
                             dst_addr=_Addr(y_offs[j], [1]),
                             src_addr=_Addr(0, [1]),
                             dims=[n], tag=f"loop{uid}.y{j}")
        hazard = any(c in cin and cin.index(c) != j
                     for j, c in enumerate(couts))
        if hazard:
            shadows = []
            for j, c in enumerate(couts):
                r = self.prog.regs[c]
                name = f"s{uid}c{j}"
                self.shadow_decls.append(
                    (name, self._width(c) if r.dtype != "i1" else 1,
                     max(r.size, 1), r.dtype))
                shadows.append(name)
                self._copy_raw(name, c, tag=f"loop{uid}.shadow{j}")
            for j, (dst, name) in enumerate(zip(cin, shadows)):
                self._copy_raw_back(dst, name, couts[j],
                                    tag=f"loop{uid}.unshadow{j}")
        else:
            for dst, src in zip(cin, couts):
                if dst != src:
                    self._copy_state(dst, src, tag=f"loop{uid}.knext")

        adv = self.new_state(f"loop{uid}.adv")
        adv.lines.append(f"{kv} = {kv} + 1;")
        for j, name in enumerate(x_offs):
            n = _size(self.prog.regs[xin[j]].shape)
            adv.lines.append(f"{name} = {name} - {n};" if reverse
                             else f"{name} = {name} + {n};")
        for j, name in enumerate(y_offs):
            n = _size(self.prog.regs[ys[j]].shape)
            adv.lines.append(f"{name} = {name} - {n};" if reverse
                             else f"{name} = {name} + {n};")
        adv.next = ("goto", head)

        # exit: move carries into the loop destinations
        first_exit = len(self.states)
        for d, src in zip(k_dests, cin):
            if d != src:
                self._copy_state(d, src, tag=f"loop{uid}.out")
        if first_exit == len(self.states):
            self.new_state(f"loop{uid}.exit").lines.append("t0 = 0;")
        head.next = ("branch", f"{kv} == {length}",
                     self.states[first_exit], self.states[first_body])

    def _copy_raw(self, dst_name, src_reg, tag) -> None:
        """Copy a register memory into a raw named shadow memory."""
        n = max(self.prog.regs[src_reg].size, 1)

        def body(names):
            self.max_t = max(self.max_t, 1)
            w = self._width(src_reg)
            trunc = ("" if self._dtype(src_reg) == "i1" or w >= 32
                     else f"[{w - 1}:0]")
            val = f"t0{trunc}" if trunc else "t0"
            if self._dtype(src_reg) == "i1":
                val = "(t0 != 0)"
            return [self.load("t0", src_reg, names[1]),
                    f"{dst_name}[{names[0]}] = {val};"]
        self.map_state([n], [_Addr(0, [1]), _Addr(0, [1])], body, tag=tag)

    def _copy_raw_back(self, dst_reg, src_name, like_reg, tag) -> None:
        n = max(self.prog.regs[dst_reg].size, 1)

        def body(names):
            self.max_t = max(self.max_t, 1)
            if self._dtype(like_reg) == "i1":
                load = f"t0 = {src_name}[{names[1]}];"
            else:
                load = f"t0 = $signed({src_name}[{names[1]}]);"
            return [load, self.store(dst_reg, names[0], "t0")]
        self.map_state([n], [_Addr(0, [1]), _Addr(0, [1])], body, tag=tag)

    def _op_grid(self, ins) -> None:
        raise EmitError("grid regions have no netlist lowering")

    def _op_cond(self, ins) -> None:
        raise EmitError("cond outside a grid region has no netlist "
                        "lowering")


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _render_header(prog, alloc, gen, state_of) -> list:
    out = [f"// @meta name {prog.name}",
           f"// @meta states {len(gen.states) + 2}",
           f"// @meta instrs {gen.instr_count}"]
    for pos, reg in enumerate(prog.inputs):
        r = prog.regs[reg]
        out.append(f"// @io input {pos} mem {gen.mem(reg)} dtype {r.dtype}"
                   f" width {alloc.width(reg)} shape {_shape_txt(r.shape)}")
    for pos, reg in enumerate(prog.outputs):
        r = prog.regs[reg]
        w = 32 if gen._is_rom(reg) else alloc.width(reg)
        out.append(f"// @io output {pos} mem {gen.mem(reg)} dtype "
                   f"{r.dtype} width {w} shape {_shape_txt(r.shape)}")
    for rom in prog.roms:
        out.append(f"// @rom {rom.name} file rom/{rom.name}.mem "
                   f"words {max(rom.data.size, 1)}")
    for st in gen.states:
        if st.trace is not None:
            iid, op, mems = st.trace
            out.append(f"// @trace state {state_of[id(st)]} instr {iid} "
                       f"op {op} dests {' '.join(mems) or '-'}")
    return out


def emit_verilog(prog: Program, alloc: Allocation = None) -> str:
    """Emit the synthesizable netlist (core + top wrapper) for an
    executable program. Raises :class:`EmitError` /
    ``NotImplementedError`` outside the supported subset."""
    if not prog.executable:
        raise NotImplementedError(
            f"program {prog.name!r} contains a grid region and has no "
            "sequential netlist (census/verification surface only)")
    if alloc is None:
        alloc = allocate(prog)
    gen = _VGen(prog, alloc)
    gen.emit_body(prog.body)

    # state numbering: 0 = wait-for-start, then the generated states,
    # then the final done state
    num = {}
    for i, st in enumerate(gen.states):
        num[id(st)] = i + 1
    done_state = len(gen.states) + 1

    def succ(i, st):
        if st.next == ("seq",):
            return i + 2 if i + 1 < len(gen.states) else done_state
        if st.next[0] == "goto":
            return num[id(st.next[1])]
        return None

    body = []
    body.append("    0: begin if (start) state <= 1; end")
    for i, st in enumerate(gen.states):
        lbl = num[id(st)]
        body.append(f"    {lbl}: begin  // {st.tag}")
        for ln in st.lines:
            body.append(f"      {ln}")
        if st.next[0] == "branch":
            cond, st_t, st_f = st.next[1], st.next[2], st.next[3]
            body.append(f"      if ({cond}) state <= {num[id(st_t)]};")
            body.append(f"      else state <= {num[id(st_f)]};")
        else:
            body.append(f"      state <= {succ(i, st)};")
        body.append("    end")
    body.append(f"    {done_state}: begin done <= 1; end")
    body.append("    default: state <= 0;")

    decls = []
    rom_regs = set(prog.rom_of_reg)
    for r in prog.regs:
        if r.idx in rom_regs:
            continue
        n = max(r.size, 1)
        if r.dtype == "i1":
            decls.append(f"  reg r{r.idx} [0:{n - 1}];")
        else:
            w = alloc.width(r.idx)
            decls.append(f"  reg signed [{w - 1}:0] r{r.idx} "
                         f"[0:{n - 1}];")
    for rom in prog.roms:
        n = max(rom.data.size, 1)
        decls.append(f"  reg signed [31:0] {rom.name} [0:{n - 1}];")

    scratch = []
    for i in range(max(gen.max_t, 10)):
        scratch.append(f"  reg signed [31:0] t{i};")
    for i in range(gen.max_a):
        scratch.append(f"  integer a{i};")
    for i in range(gen.max_c):
        scratch.append(f"  integer c{i};")
    for name in gen.counter_decls:
        scratch.append(f"  integer {name};")
    for name, w, n, dt in gen.shadow_decls:
        if dt == "i1":
            scratch.append(f"  reg {name} [0:{n - 1}];")
        else:
            scratch.append(f"  reg signed [{w - 1}:0] {name} "
                           f"[0:{n - 1}];")
    scratch.append("  integer state;")

    inits = []
    for rom in prog.roms:
        inits.append(f"  initial $readmemh(\"rom/{rom.name}.mem\", "
                     f"{rom.name});")

    header = _render_header(prog, alloc, gen, num)
    lines = []
    lines.extend(header)
    lines.append("")
    lines.append(f"module {prog.name}(input wire clk, input wire rst, "
                 "input wire start, output reg done);")
    lines.extend(decls)
    lines.extend(scratch)
    lines.extend(inits)
    lines.append("  always @(posedge clk) begin")
    lines.append("    if (rst) begin")
    lines.append("      state <= 0;")
    lines.append("      done <= 0;")
    lines.append("    end else begin")
    lines.append("      case (state)")
    lines.extend("  " + ln for ln in body)
    lines.append("      endcase")
    lines.append("    end")
    lines.append("  end")
    lines.append("endmodule")
    lines.append("")
    lines.append(f"module {prog.name}_top(input wire clk, input wire "
                 "rst, input wire start, output wire done);")
    lines.append(f"  {prog.name} u_core(.clk(clk), .rst(rst), "
                 ".start(start), .done(done));")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def emit_testbench(prog: Program, alloc: Allocation = None,
                   max_cycles: int = 200_000_000) -> str:
    """Self-checking iverilog testbench: loads width-matched input
    ``in_<mem>.mem`` images, runs to ``done``, writes ``out_<mem>.mem``
    via hierarchical references. Generated at test time, not committed
    (``repro_torch.ir.vsim.write_input_mems`` / ``read_output_mems`` produce
    and consume the images)."""
    if alloc is None:
        alloc = allocate(prog)
    gen = _VGen(prog, alloc)   # only for mem naming
    lines = ["`timescale 1ns/1ps", "module tb;",
             "  reg clk = 0; reg rst = 1; reg start = 0; wire done;",
             f"  {prog.name}_top dut(.clk(clk), .rst(rst), "
             ".start(start), .done(done));",
             "  always #5 clk = ~clk;",
             "  initial begin"]
    for reg in prog.inputs:
        m = gen.mem(reg)
        lines.append(f"    $readmemh(\"in_{m}.mem\", dut.u_core.{m});")
    lines.append("    #20 rst = 0; start = 1;")
    lines.append("    wait (done);")
    lines.append("    @(posedge clk);")
    for reg in prog.outputs:
        m = gen.mem(reg)
        lines.append(f"    $writememh(\"out_{m}.mem\", dut.u_core.{m});")
    lines.append("    $finish;")
    lines.append("  end")
    lines.append(f"  initial begin #{10 * max_cycles} "
                 "$display(\"TB TIMEOUT\"); $finish; end")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"
