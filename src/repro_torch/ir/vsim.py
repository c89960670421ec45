"""Cycle simulator for the emitted Verilog netlist subset.

This container has no iverilog, so the simulation half of the netlist
parity gate is in-repo: :func:`run_netlist` parses EXACTLY the subset
``repro_torch.ir.verilog`` emits (module + instantiation, register/memory
declarations, ``$readmemh`` ROM initialization, one clocked ``always``
FSM with ``case``/``if``/``for``, blocking and nonblocking assigns) and
replays it cycle by cycle with Verilog's 32-bit-signed expression
semantics:

* every declared object stores its value CANONICALLY sign-extended (what
  a ``$signed`` read of the W-bit cell yields), so loads are identity
  and stores truncate-and-sign-extend to the declared width;
* operators evaluate in 32-bit two's-complement context (the emitter pins
  every expression to that context); shift amounts are unsigned with
  >=32 saturating to 0 / sign-fill, per the LRM;
* nonblocking assigns (``state``/``done``) apply at cycle end.

Executing one element per FSM visit would be hopeless in Python (the
full one-shot program retires ~3.4e8 element-ops), so each behavioral
``for`` nest is vectorized: the emitter maintains addresses as
constant-add induction registers, which makes every address an affine
function of the loop coordinates — the simulator recovers the stride
vectors from the increment statements, materializes the whole iteration
space as numpy arrays, and recognizes the emitter's canonical
read-modify-write reduction body as ``np.add.at`` /
``np.maximum.at`` / ``np.minimum.at`` (sound: adds compose mod 2**W,
order-free; max/min partials stay inside the destination's proven
interval so the W-bit store is exact). Any state the vectorizer does not
recognize falls back to a faithful statement-by-statement interpretation
— ``vectorize=False`` forces that slow path everywhere, and the test
suite pins fast == slow.

``// @io`` / ``// @rom`` / ``// @trace`` header comments (machine
metadata the emitter writes) map program inputs/outputs onto memories,
ROM memories onto their committed ``rom/*.mem`` images, and FSM states
onto IR instructions for register-granular trace comparison
(``repro_torch.ir.debug``).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

__all__ = [
    "VsimError", "IoPort", "Netlist", "parse_netlist", "run_netlist",
    "rom_loader_from_dir", "rom_loader_from_mems", "parse_mem_words",
    "write_input_mems", "read_output_mems", "have_iverilog",
    "run_iverilog",
]

_M32 = 0xFFFFFFFF
_KEYWORDS = {
    "module", "endmodule", "input", "output", "inout", "wire", "reg",
    "integer", "signed", "initial", "always", "begin", "end", "if",
    "else", "case", "endcase", "default", "for", "posedge", "negedge",
}


class VsimError(Exception):
    """The netlist is outside the simulated subset (or misbehaves)."""


# ---------------------------------------------------------------------------
# 32-bit-signed-context arithmetic (scalar ints and numpy arrays)
# ---------------------------------------------------------------------------


def _w32(v):
    """Wrap to canonical 32-bit two's-complement (int or int64 array)."""
    if isinstance(v, np.ndarray):
        return ((v & _M32) ^ 0x80000000) - 0x80000000
    v &= _M32
    return v - 0x100000000 if v & 0x80000000 else v


def _canon(v, width: int, signed: bool = True):
    """Truncate to ``width`` bits and store canonically: what a read of
    the W-bit cell yields in a 32-bit context — sign-extended for
    ``reg signed`` declarations, zero-extended otherwise."""
    if width >= 32:
        return _w32(v)
    mask = (1 << width) - 1
    if not signed:
        return v & mask
    sign = 1 << (width - 1)
    if isinstance(v, np.ndarray):
        return ((v & mask) ^ sign) - sign
    v &= mask
    return v - (1 << width) if v & sign else v


def _shl(a, k):
    if isinstance(a, np.ndarray) or isinstance(k, np.ndarray):
        ku = np.minimum(np.asarray(k, np.int64) & _M32, 32)
        return _w32(np.left_shift(np.asarray(a, np.int64), ku))
    ku = k & _M32
    return 0 if ku >= 32 else _w32(a << ku)


def _shra(a, k):
    if isinstance(a, np.ndarray) or isinstance(k, np.ndarray):
        ku = np.minimum(np.asarray(k, np.int64) & _M32, 31)
        return np.right_shift(np.asarray(a, np.int64), ku)
    ku = min(k & _M32, 31)
    return a >> ku


def _shrl(a, k):
    if isinstance(a, np.ndarray) or isinstance(k, np.ndarray):
        ku = np.minimum(np.asarray(k, np.int64) & _M32, 32)
        return _w32(np.right_shift(np.asarray(a, np.int64) & _M32, ku))
    ku = k & _M32
    return 0 if ku >= 32 else _w32((a & _M32) >> ku)


def _as_flag(v):
    if isinstance(v, np.ndarray):
        return (v != 0)
    return v != 0


def _flag_int(b):
    if isinstance(b, np.ndarray):
        return b.astype(np.int64)
    return 1 if b else 0


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
      (?P<ws>\s+)
    | (?P<str>"[^"]*")
    | (?P<num>\d+)
    | (?P<id>\$?[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op><<|>>>|>>|<=|>=|==|!=|&&|\|\||[-+&|^~!<>?:;,.=()\[\]{}@#*/])
""", re.VERBOSE)


def _tokenize(text: str) -> list:
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"`[^\n]*", "", text)        # `timescale etc.
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise VsimError(f"lex error near {text[pos:pos + 30]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        toks.append((m.lastgroup, m.group()))
    toks.append(("eof", ""))
    return toks


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Decl:
    kind: str        # "mem" | "reg" | "integer"
    width: int
    signed: bool
    size: int        # memory words (1 for scalars)


@dataclasses.dataclass
class _Module:
    name: str
    ports: list
    decls: dict
    readmems: list               # (file, mem_name)
    always: object               # stmt or None
    instances: list              # (module_name, inst_name)


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise VsimError(f"expected {val!r}, got {t[1]!r}")
        return t

    def accept(self, val) -> bool:
        if self.peek()[1] == val:
            self.i += 1
            return True
        return False

    # -- modules ----------------------------------------------------------

    def parse_file(self) -> list:
        mods = []
        while self.peek()[0] != "eof":
            if self.peek()[1] == "module":
                mods.append(self.parse_module())
            else:
                self.next()
        return mods

    def parse_module(self) -> _Module:
        self.expect("module")
        name = self.next()[1]
        ports = []
        if self.accept("("):
            while not self.accept(")"):
                t = self.next()
                if t[0] == "id" and t[1] not in _KEYWORDS:
                    ports.append(t[1])
        self.expect(";")
        mod = _Module(name, ports, {}, [], None, [])
        for p in ports:
            mod.decls.setdefault(p, _Decl("reg", 1, False, 1))
        while not self.accept("endmodule"):
            self.parse_item(mod)
        return mod

    def parse_item(self, mod: _Module) -> None:
        t = self.peek()
        if t[1] in ("input", "output", "inout"):
            self.next()
            while self.peek()[1] in ("wire", "reg", "signed"):
                self.next()
            nm = self.next()[1]
            mod.decls[nm] = _Decl("reg", 1, False, 1)
            self.expect(";")
        elif t[1] == "reg":
            self.next()
            signed = self.accept("signed")
            width = 1
            if self.accept("["):
                hi = int(self.next()[1])
                self.expect(":")
                lo = int(self.next()[1])
                self.expect("]")
                width = hi - lo + 1
            nm = self.next()[1]
            if self.accept("["):
                lo = int(self.next()[1])
                self.expect(":")
                hi = int(self.next()[1])
                self.expect("]")
                mod.decls[nm] = _Decl("mem", width, signed, hi - lo + 1)
            else:
                mod.decls[nm] = _Decl("reg", width, signed, 1)
            self.expect(";")
        elif t[1] == "integer":
            self.next()
            nm = self.next()[1]
            mod.decls[nm] = _Decl("integer", 32, True, 1)
            self.expect(";")
        elif t[1] == "initial":
            self.next()
            st = self.parse_stmt()
            for call in self._calls(st):
                if call[1] == "$readmemh":
                    args = call[2]
                    if (len(args) != 2 or args[0][0] != "str"
                            or args[1][0] != "var"):
                        raise VsimError("unsupported $readmemh form")
                    mod.readmems.append((args[0][1], args[1][1]))
        elif t[1] == "always":
            self.next()
            self.expect("@")
            self.expect("(")
            self.expect("posedge")
            self.next()                     # clock name
            self.expect(")")
            if mod.always is not None:
                raise VsimError("multiple always blocks")
            mod.always = self.parse_stmt()
        elif t[0] == "id":
            # module instantiation: NAME inst ( .port(expr), ... ) ;
            mname = self.next()[1]
            iname = self.next()[1]
            self.expect("(")
            depth = 1
            while depth:
                tv = self.next()
                if tv[1] == "(":
                    depth += 1
                elif tv[1] == ")":
                    depth -= 1
                elif tv[0] == "eof":
                    raise VsimError("unterminated instantiation")
            self.expect(";")
            mod.instances.append((mname, iname))
        else:
            raise VsimError(f"unexpected token {t[1]!r} in module body")

    def _calls(self, st):
        if st[0] == "call":
            yield st
        elif st[0] == "block":
            for s in st[1]:
                yield from self._calls(s)

    # -- statements -------------------------------------------------------

    def parse_stmt(self):
        t = self.peek()
        if t[1] == "begin":
            self.next()
            body = []
            while not self.accept("end"):
                body.append(self.parse_stmt())
            return ("block", body)
        if t[1] == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            other = None
            if self.accept("else"):
                other = self.parse_stmt()
            return ("if", cond, then, other)
        if t[1] == "case":
            self.next()
            self.expect("(")
            sel = self.parse_expr()
            self.expect(")")
            items = {}
            default = None
            while not self.accept("endcase"):
                if self.accept("default"):
                    self.expect(":")
                    default = self.parse_stmt()
                else:
                    lbl = int(self.next()[1])
                    self.expect(":")
                    items[lbl] = self.parse_stmt()
            return ("case", sel, items, default)
        if t[1] == "for":
            self.next()
            self.expect("(")
            init = self.parse_assign(stop=";")
            cond = self.parse_expr()
            self.expect(";")
            step = self.parse_assign(stop=")")
            body = self.parse_stmt()
            return ("for", init, cond, step, body)
        if t[1].startswith("$"):
            name = self.next()[1]
            args = []
            if self.accept("("):
                while not self.accept(")"):
                    if self.peek()[0] == "str":
                        args.append(("str", self.next()[1].strip('"')))
                    else:
                        args.append(self.parse_expr())
                    self.accept(",")
            self.expect(";")
            return ("call", name, args)
        return self.parse_assign(stop=";")

    def parse_assign(self, stop):
        nm = self.next()
        if nm[0] != "id":
            raise VsimError(f"bad lvalue {nm[1]!r}")
        lhs = ("var", nm[1])
        if self.accept("["):
            idx = self.parse_expr()
            self.expect("]")
            lhs = ("idx", nm[1], idx)
        if self.accept("="):
            blocking = True
        elif self.accept("<="):
            blocking = False
        else:
            raise VsimError(f"expected assignment after {nm[1]!r}")
        rhs = self.parse_expr()
        self.expect(stop)
        return ("assign", lhs, rhs, blocking)

    # -- expressions ------------------------------------------------------

    _BINPREC = [
        ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
        ("<", "<=", ">", ">="), ("<<", ">>", ">>>"), ("+", "-"),
    ]

    def parse_expr(self):
        return self._ternary()

    def _ternary(self):
        c = self._binary(0)
        if self.accept("?"):
            a = self._ternary()
            self.expect(":")
            b = self._ternary()
            return ("tern", c, a, b)
        return c

    def _binary(self, lvl):
        if lvl >= len(self._BINPREC):
            return self._unary()
        ops = self._BINPREC[lvl]
        e = self._binary(lvl + 1)
        while self.peek()[1] in ops:
            op = self.next()[1]
            rhs = self._binary(lvl + 1)
            e = ("bin", op, e, rhs)
        return e

    def _unary(self):
        t = self.peek()
        if t[1] in ("-", "~", "!", "+"):
            self.next()
            return ("unary", t[1], self._unary())
        return self._primary()

    def _primary(self):
        t = self.next()
        if t[0] == "num":
            return ("num", int(t[1]))
        if t[1] == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t[1] in ("$signed", "$unsigned"):
            self.expect("(")
            e = self.parse_expr()
            self.expect(")")
            return ("signed", e) if t[1] == "$signed" else e
        if t[0] == "id":
            name = t[1]
            if self.accept("["):
                first = self.parse_expr()
                if self.accept(":"):
                    lo = self.parse_expr()
                    self.expect("]")
                    if first[0] != "num" or lo[0] != "num":
                        raise VsimError("part-select bounds must be "
                                        "constant")
                    return ("psel", name, first[1], lo[1])
                self.expect("]")
                return ("idx", name, first)
            return ("var", name)
        raise VsimError(f"unexpected token {t[1]!r} in expression")


# ---------------------------------------------------------------------------
# netlist metadata (// @... header comments)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IoPort:
    pos: int
    mem: str
    dtype: str
    width: int
    shape: tuple


@dataclasses.dataclass
class Netlist:
    text: str
    name: str
    modules: list
    core: _Module
    inputs: list                  # [IoPort]
    outputs: list                 # [IoPort]
    roms: list                    # (mem_name, file, words)
    trace_map: dict               # state -> (instr_id, op, [mems])
    meta: dict


def _parse_shape(txt: str) -> tuple:
    if txt == "-":
        return ()
    return tuple(int(d) for d in txt.split("x"))


def parse_netlist(text: str) -> Netlist:
    meta = {}
    ins, outs, roms = [], [], []
    trace_map = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("// @"):
            continue
        f = line[3:].split()
        if f[0] == "@meta":
            meta[f[1]] = f[2]
        elif f[0] == "@io":
            port = IoPort(pos=int(f[2]), mem=f[4], dtype=f[6],
                          width=int(f[8]), shape=_parse_shape(f[10]))
            (ins if f[1] == "input" else outs).append(port)
        elif f[0] == "@rom":
            roms.append((f[1], f[3], int(f[5])))
        elif f[0] == "@trace":
            dests = [] if f[8] == "-" else f[8:]
            trace_map[int(f[2])] = (int(f[4]), f[6], dests)
    mods = _Parser(_tokenize(text)).parse_file()
    cores = [m for m in mods if m.always is not None]
    if len(cores) != 1:
        raise VsimError(f"expected exactly one clocked module, "
                        f"found {len(cores)}")
    core = cores[0]
    ins.sort(key=lambda p: p.pos)
    outs.sort(key=lambda p: p.pos)
    return Netlist(text=text, name=meta.get("name", core.name),
                   modules=mods, core=core, inputs=ins, outputs=outs,
                   roms=roms, trace_map=trace_map, meta=meta)


# ---------------------------------------------------------------------------
# .mem image helpers (shared with the iverilog testbench path)
# ---------------------------------------------------------------------------


def parse_mem_words(text: str, width: int = 32) -> np.ndarray:
    vals = []
    for tok in text.split():
        if tok.startswith("//") or tok.startswith("@"):
            continue
        v = int(tok, 16)
        vals.append(_canon(v, width))
    return np.asarray(vals, dtype=np.int64)


def rom_loader_from_dir(base_dir: str):
    """ROM loader resolving the netlist's ``rom/<name>.mem`` paths
    against a directory (e.g. ``<out-dir>/<target>``)."""
    def load(path: str) -> np.ndarray:
        with open(os.path.join(base_dir, path)) as f:
            return parse_mem_words(f.read(), 32)
    return load


def rom_loader_from_mems(mems: dict):
    """ROM loader over in-memory ``{filename: text}`` images — exactly
    what ``repro_torch.ir.cgen.emit_rom_mem`` returns."""
    def load(path: str) -> np.ndarray:
        return parse_mem_words(mems[os.path.basename(path)], 32)
    return load


def write_input_mems(net: Netlist, inputs, out_dir: str) -> list:
    """Write width-matched ``in_<mem>.mem`` images for the testbench."""
    if len(inputs) != len(net.inputs):
        raise VsimError(f"netlist takes {len(net.inputs)} inputs, "
                        f"got {len(inputs)}")
    paths = []
    for port, val in zip(net.inputs, inputs):
        arr = np.asarray(val).astype(np.int64).ravel()
        digits = max(1, (port.width + 3) // 4)
        mask = (1 << port.width) - 1
        lines = [format(int(v) & mask, f"0{digits}x") for v in arr]
        if not lines:
            lines = ["0"]
        p = os.path.join(out_dir, f"in_{port.mem}.mem")
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(p)
    return paths


def read_output_mems(net: Netlist, out_dir: str) -> list:
    """Parse the testbench's ``out_<mem>.mem`` images back into shaped
    arrays (sign-extending from the allocated width)."""
    outs = []
    for port in net.outputs:
        with open(os.path.join(out_dir, f"out_{port.mem}.mem")) as f:
            vals = parse_mem_words(f.read(), port.width)
        outs.append(_shape_out(port, vals))
    return outs


def _shape_out(port: IoPort, flat: np.ndarray):
    n = 1
    for d in port.shape:
        n *= d
    flat = flat[:n].reshape(port.shape)
    if port.dtype == "i1":
        return flat != 0
    return flat.astype(np.int32)


# ---------------------------------------------------------------------------
# real-simulator path (taken automatically when iverilog is installed)
# ---------------------------------------------------------------------------


def have_iverilog() -> bool:
    import shutil
    return shutil.which("iverilog") is not None


def run_iverilog(netlist_text: str, tb_text: str, inputs,
                 rom_dir: str | None = None, rom_mems: dict | None = None):
    """Compile the emitted netlist + testbench with iverilog, run it
    under vvp, and return the program outputs (same shapes/dtypes as
    :func:`run_netlist`). ROM images come from ``rom_dir`` (a committed
    ``<out-dir>/<target>`` tree) or in-memory ``rom_mems``."""
    import shutil
    import subprocess
    import tempfile

    net = parse_netlist(netlist_text)
    with tempfile.TemporaryDirectory(prefix="vsim_iv_") as work:
        with open(os.path.join(work, "design.v"), "w") as f:
            f.write(netlist_text)
        with open(os.path.join(work, "tb.v"), "w") as f:
            f.write(tb_text)
        if net.roms:
            os.makedirs(os.path.join(work, "rom"), exist_ok=True)
            for _mem, fname, _words in net.roms:
                base = os.path.basename(fname)
                dst = os.path.join(work, "rom", base)
                if rom_mems is not None:
                    with open(dst, "w") as f:
                        f.write(rom_mems[base])
                elif rom_dir is not None:
                    shutil.copyfile(os.path.join(rom_dir, "rom", base),
                                    dst)
                else:
                    raise VsimError("netlist has ROMs but neither "
                                    "rom_dir nor rom_mems was given")
        write_input_mems(net, inputs, work)
        subprocess.run(["iverilog", "-g2005", "-o", "sim.vvp",
                        "design.v", "tb.v"],
                       cwd=work, check=True, capture_output=True)
        subprocess.run(["vvp", "sim.vvp"], cwd=work, check=True,
                       capture_output=True)
        return read_output_mems(net, work)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------


class _VecPlan:
    """Compiled form of one behavioral ``for`` nest: affine induction
    values over the full iteration space + a vectorizable body."""

    def __init__(self, dims, loop_vars, advances, ops):
        self.dims = dims                  # [int]
        self.loop_vars = loop_vars        # [name] per level
        self.advances = advances          # {var: [adv per level]}
        self.ops = ops                    # compiled body ops


class _Sim:
    def __init__(self, net: Netlist, rom_loader=None, vectorize=True,
                 trace=None, max_cycles: int = 200_000_000):
        self.net = net
        self.mod = net.core
        self.vectorize = vectorize
        self.trace = trace
        self.max_cycles = max_cycles
        self.env: dict = {}
        self.nb: list = []
        self._plans: dict = {}            # id(for-node) -> _VecPlan|None
        for name, d in self.mod.decls.items():
            if d.kind == "mem":
                self.env[name] = np.zeros(d.size, dtype=np.int64)
            else:
                self.env[name] = 0
        for path, mem in self.mod.readmems:
            if rom_loader is None:
                raise VsimError(
                    f"netlist reads {path!r} but no rom_loader given")
            data = np.asarray(rom_loader(path), dtype=np.int64)
            d = self.mod.decls.get(mem)
            if d is None or d.kind != "mem":
                raise VsimError(f"$readmemh into unknown memory {mem!r}")
            n = min(len(data), d.size)
            self.env[mem][:n] = _canon(data[:n], d.width, d.signed)

    # -- register-file access --------------------------------------------

    def poke(self, port: IoPort, value) -> None:
        arr = np.asarray(value).astype(np.int64).ravel()
        mem = self.env[port.mem]
        d = self.mod.decls[port.mem]
        mem[:len(arr)] = _canon(arr, port.width, d.signed)

    def peek(self, port: IoPort):
        return _shape_out(port, self.env[port.mem].copy())

    # -- evaluation (scalar) ---------------------------------------------

    def eval(self, e):
        k = e[0]
        if k == "num":
            return e[1]
        if k == "var":
            v = self.env[e[1]]
            if isinstance(v, np.ndarray):
                raise VsimError(f"memory {e[1]!r} used as scalar")
            return v
        if k == "idx":
            arr = self.env[e[1]]
            if not isinstance(arr, np.ndarray):
                raise VsimError(f"indexing non-memory {e[1]!r}")
            return int(arr[self.eval(e[2])])
        if k == "psel":
            v = self.eval_name_scalar(e[1])
            width = e[2] - e[3] + 1
            return (v >> e[3]) & ((1 << width) - 1)
        if k == "signed":
            return self.eval(e[1])
        if k == "unary":
            v = self.eval(e[2])
            if e[1] == "-":
                return _w32(-v)
            if e[1] == "~":
                return _w32(~v)
            if e[1] == "!":
                return 0 if v else 1
            return v
        if k == "bin":
            op = e[1]
            a = self.eval(e[2])
            if op == "&&":
                return 1 if (a != 0 and self.eval(e[3]) != 0) else 0
            if op == "||":
                return 1 if (a != 0 or self.eval(e[3]) != 0) else 0
            b = self.eval(e[3])
            if op == "+":
                return _w32(a + b)
            if op == "-":
                return _w32(a - b)
            if op == "&":
                return _w32(a & b)
            if op == "|":
                return _w32(a | b)
            if op == "^":
                return _w32(a ^ b)
            if op == "<<":
                return _shl(a, b)
            if op == ">>":
                return _shrl(a, b)
            if op == ">>>":
                return _shra(a, b)
            if op == "<":
                return 1 if a < b else 0
            if op == "<=":
                return 1 if a <= b else 0
            if op == ">":
                return 1 if a > b else 0
            if op == ">=":
                return 1 if a >= b else 0
            if op == "==":
                return 1 if a == b else 0
            if op == "!=":
                return 1 if a != b else 0
        if k == "tern":
            return (self.eval(e[2]) if self.eval(e[1]) != 0
                    else self.eval(e[3]))
        raise VsimError(f"cannot evaluate {e!r}")

    def eval_name_scalar(self, name):
        v = self.env[name]
        if isinstance(v, np.ndarray):
            raise VsimError(f"memory {name!r} used as scalar")
        return v

    # -- statement execution ---------------------------------------------

    def exec_stmt(self, st) -> None:
        k = st[0]
        if k == "block":
            for s in st[1]:
                self.exec_stmt(s)
        elif k == "assign":
            self._do_assign(st)
        elif k == "if":
            if self.eval(st[1]) != 0:
                self.exec_stmt(st[2])
            elif st[3] is not None:
                self.exec_stmt(st[3])
        elif k == "case":
            sel = self.eval(st[1])
            item = st[2].get(sel, st[3])
            if item is not None:
                self.exec_stmt(item)
        elif k == "for":
            if self.vectorize:
                plan = self._plan_for(st)
                if plan is not None:
                    self._run_plan(plan)
                    return
            self._slow_for(st)
        elif k == "call":
            pass                          # $display etc.: ignored
        else:
            raise VsimError(f"cannot execute {k!r}")

    def _do_assign(self, st) -> None:
        _, lhs, rhs, blocking = st
        val = self.eval(rhs)
        if blocking:
            self._write(lhs, val)
        else:
            if lhs[0] == "idx":
                self.nb.append((lhs[1], self.eval(lhs[2]), val))
            else:
                self.nb.append((lhs[1], None, val))

    def _write(self, lhs, val) -> None:
        d = self.mod.decls.get(lhs[1])
        if d is None:
            raise VsimError(f"assignment to undeclared {lhs[1]!r}")
        if lhs[0] == "idx":
            idx = self.eval(lhs[2])
            self.env[lhs[1]][idx] = _canon(val, d.width, d.signed)
        else:
            self.env[lhs[1]] = (_w32(val) if d.kind == "integer"
                                else _canon(val, d.width, d.signed)
                                if d.kind == "reg" and d.width < 32
                                else _w32(val))

    def _slow_for(self, st) -> None:
        _, init, cond, step, body = st
        self.exec_stmt(init)
        guard = 0
        while self.eval(cond) != 0:
            self.exec_stmt(body)
            self.exec_stmt(step)
            guard += 1
            if guard > 10_000_000:
                raise VsimError("runaway for loop")

    # -- cycle loop -------------------------------------------------------

    def cycle(self) -> None:
        self.exec_stmt(self.mod.always)
        for name, idx, val in self.nb:
            if idx is None:
                self._write(("var", name), val)
            else:
                d = self.mod.decls[name]
                self.env[name][idx] = _canon(val, d.width, d.signed)
        self.nb = []

    def run(self) -> int:
        self.env["rst"] = 1
        self.env["start"] = 0
        self.cycle()
        self.env["rst"] = 0
        self.env["start"] = 1
        cycles = 0
        trace_map = self.net.trace_map if self.trace else {}
        while self.env.get("done", 0) == 0:
            state = self.env.get("state", 0)
            self.cycle()
            cycles += 1
            if self.trace and state in trace_map:
                iid, op, mems = trace_map[state]
                vals = [self.env[m].copy() for m in mems]
                self.trace(cycles, state, iid, op, mems, vals)
            if cycles > self.max_cycles:
                raise VsimError(
                    f"no done after {cycles} cycles (state "
                    f"{self.env.get('state')})")
        return cycles

    # -- vectorizer -------------------------------------------------------

    def _plan_for(self, node):
        key = id(node)
        if key in self._plans:
            return self._plans[key]
        plan = None
        try:
            plan = self._build_plan(node)
        except _NoVec:
            plan = None
        self._plans[key] = plan
        return plan

    def _build_plan(self, node):
        dims, loop_vars = [], []
        inductions = []               # per level: [(var, delta)]
        core = None
        cur = node
        while True:
            _, init, cond, step, body = cur
            var = self._loop_var(init, cond, step)
            n = cond[3][1]
            dims.append(n)
            loop_vars.append(var)
            stmts = body[1] if body[0] == "block" else [body]
            trail = []
            while stmts and self._induction(stmts[-1]) is not None:
                trail.insert(0, self._induction(stmts[-1]))
                stmts = stmts[:-1]
            inductions.append(trail)
            if len(stmts) == 1 and stmts[0][0] == "for":
                cur = stmts[0]
                continue
            core = stmts
            break
        if any(n <= 0 for n in dims):
            raise _NoVec          # nothing to do; slow path handles
        # net advance per level-d iteration (inner sweeps included)
        advances: dict = {}
        for d in range(len(dims) - 1, -1, -1):
            seen = set(advances)
            for var, delta in inductions[d]:
                inner = advances.get(var, [0] * len(dims))
                advances[var] = inner
            for var in set(v for v, _ in inductions[d]) | seen:
                adv = advances.setdefault(var, [0] * len(dims))
                delta = sum(dl for v, dl in inductions[d] if v == var)
                inner_adv = (adv[d + 1] * dims[d + 1]
                             if d + 1 < len(dims) else 0)
                adv[d] = delta + inner_adv
        ops = self._compile_core(core, set(advances) | set(loop_vars))
        return _VecPlan(dims, loop_vars, advances, ops)

    def _loop_var(self, init, cond, step):
        if (init[0] != "assign" or init[1][0] != "var"
                or init[2] != ("num", 0) or not init[3]):
            raise _NoVec
        var = init[1][1]
        if (cond[0] != "bin" or cond[1] != "<" or cond[2] != ("var", var)
                or cond[3][0] != "num"):
            raise _NoVec
        if (step[0] != "assign" or step[1] != ("var", var)
                or step[2] != ("bin", "+", ("var", var), ("num", 1))):
            raise _NoVec
        return var

    def _induction(self, st):
        """``a = a + C`` / ``a = a - C`` on a declared integer."""
        if st[0] != "assign" or not st[3] or st[1][0] != "var":
            return None
        var = st[1][1]
        d = self.mod.decls.get(var)
        if d is None or d.kind != "integer":
            return None
        rhs = st[2]
        if (rhs[0] == "bin" and rhs[1] in "+-"
                and rhs[2] == ("var", var) and rhs[3][0] == "num"):
            return (var, rhs[3][1] if rhs[1] == "+" else -rhs[3][1])
        return None

    def _compile_core(self, core, vec_vars):
        # read-modify-write reduction: the emitter's canonical 4-stmt body
        rmw = self._match_rmw(core)
        if rmw is not None:
            return [rmw]
        ops = []
        written_mems = set()
        for st in core:
            if st[0] == "assign" and st[3]:
                if st[1][0] == "var":
                    d = self.mod.decls.get(st[1][1])
                    if d is None or d.kind == "mem":
                        raise _NoVec
                    self._check_no_mem_rmw(st[2], written_mems)
                    ops.append(("set", st[1][1], st[2], d))
                else:
                    self._check_no_mem_rmw(st[2], {st[1][1]})
                    written_mems.add(st[1][1])
                    ops.append(("store", st[1][1], st[1][2], st[2], None))
            elif st[0] == "if" and st[3] is None:
                inner = st[2][1] if st[2][0] == "block" else [st[2]]
                stores = []
                for s in inner:
                    if (s[0] != "assign" or not s[3]
                            or s[1][0] != "idx"):
                        raise _NoVec
                    written_mems.add(s[1][1])
                    stores.append((s[1][1], s[1][2], s[2]))
                ops.append(("guard", st[1], stores))
            else:
                raise _NoVec
        return ops

    def _check_no_mem_rmw(self, e, written_mems):
        """A later statement must not read a memory the nest already
        wrote (vectorized stores have no intra-nest ordering)."""
        k = e[0]
        if k == "idx" and e[1] in written_mems:
            raise _NoVec
        for sub in e[1:]:
            if isinstance(sub, tuple):
                self._check_no_mem_rmw(sub, written_mems)

    _RMW_UFUNC = {"+": "add", "|": "bitwise_or", "&": "bitwise_and"}

    def _match_rmw(self, core):
        if len(core) != 4:
            return None
        s_acc, s_src, s_comb, s_store = core
        for s in core[:3]:
            if s[0] != "assign" or not s[3] or s[1][0] != "var":
                return None
        if s_store[0] != "assign" or not s_store[3] \
                or s_store[1][0] != "idx":
            return None
        mem = s_store[1][1]
        if s_store[1][2][0] != "var":
            return None
        avar = s_store[1][2][1]
        t_acc = s_acc[1][1]
        t_src = s_src[1][1]
        t_comb = s_comb[1][1]
        acc_read = self._unwrap_signed(s_acc[2])
        if acc_read != ("idx", mem, ("var", avar)):
            return None
        store_val = self._unwrap_store(s_store[2])
        if store_val != ("var", t_comb):
            return None
        comb = s_comb[2]
        ufunc = None
        A, B = ("var", t_acc), ("var", t_src)
        if comb[0] == "bin" and comb[1] in self._RMW_UFUNC \
                and {comb[2], comb[3]} == {A, B}:
            ufunc = self._RMW_UFUNC[comb[1]]
        elif comb == ("tern", ("bin", "<", A, B), B, A):
            ufunc = "maximum"
        elif comb == ("tern", ("bin", "<", B, A), B, A):
            ufunc = "minimum"
        if ufunc is None:
            return None
        d = self.mod.decls.get(mem)
        if d is None or d.kind != "mem":
            return None
        return ("rmw", ufunc, mem, avar, s_src[2], d)

    def _unwrap_signed(self, e):
        return e[1] if e[0] == "signed" else e

    def _unwrap_store(self, e):
        if e[0] == "psel":
            return ("var", e[1])
        if (e[0] == "bin" and e[1] == "!=" and e[3] == ("num", 0)):
            return self._unwrap_signed(e[2])
        return self._unwrap_signed(e)

    # -- vectorized execution --------------------------------------------

    def _run_plan(self, plan: _VecPlan) -> None:
        dims = plan.dims
        shape = tuple(dims)
        vec: dict = {}
        for d, var in enumerate(plan.loop_vars):
            rs = [1] * len(dims)
            rs[d] = dims[d]
            vec[var] = np.arange(dims[d], dtype=np.int64).reshape(rs)
        for var, adv in plan.advances.items():
            base = self.env[var]
            total = None
            for d, a in enumerate(adv):
                if a == 0:
                    continue
                rs = [1] * len(dims)
                rs[d] = dims[d]
                term = (np.arange(dims[d], dtype=np.int64) * a).reshape(rs)
                total = term if total is None else total + term
            vec[var] = base if total is None else base + total

        for op in plan.ops:
            if op[0] == "set":
                _, name, rhs, d = op
                v = self._veval(rhs, vec, shape)
                vec[name] = (_canon(v, d.width, d.signed)
                             if d.kind == "reg" and d.width < 32
                             else _w32(v))
            elif op[0] == "store":
                _, mem, iexpr, rhs, _w = op
                d = self.mod.decls[mem]
                idx = self._veval(iexpr, vec, shape)
                val = _canon(self._veval(rhs, vec, shape), d.width,
                             d.signed)
                arr = self.env[mem]
                if isinstance(idx, np.ndarray):
                    idx_b = np.broadcast_to(idx, shape).ravel()
                    val_b = np.broadcast_to(
                        np.asarray(val, np.int64), shape).ravel()
                    arr[idx_b] = val_b
                else:
                    arr[int(idx)] = int(np.asarray(val).ravel()[-1]) \
                        if isinstance(val, np.ndarray) else val
            elif op[0] == "guard":
                _, cond, stores = op
                m = self._veval(cond, vec, shape)
                mask = np.broadcast_to(_as_flag(m), shape).ravel()
                for mem, iexpr, rhs in stores:
                    d = self.mod.decls[mem]
                    idx = np.broadcast_to(
                        np.asarray(self._veval(iexpr, vec, shape),
                                   np.int64), shape).ravel()
                    val = np.broadcast_to(
                        np.asarray(_canon(self._veval(rhs, vec, shape),
                                          d.width, d.signed), np.int64),
                        shape).ravel()
                    arr = self.env[mem]
                    arr[idx[mask]] = val[mask]
            elif op[0] == "rmw":
                _, ufunc, mem, avar, src_rhs, d = op
                arr = self.env[mem]
                idx = np.broadcast_to(
                    np.asarray(vec[avar], np.int64), shape).ravel()
                val = np.broadcast_to(
                    np.asarray(self._veval(src_rhs, vec, shape),
                               np.int64), shape).ravel()
                getattr(np, ufunc).at(arr, idx, val)
                arr[:] = _canon(arr, d.width, d.signed)

        # finalize scalars: the value after the last iteration
        for op in plan.ops:
            if op[0] == "set":
                v = vec[op[1]]
                self.env[op[1]] = (int(np.broadcast_to(v, shape)
                                       .ravel()[-1])
                                   if isinstance(v, np.ndarray)
                                   else int(v))
        for var, adv in plan.advances.items():
            self.env[var] = int(self.env[var]
                                + (adv[0] * dims[0] if dims else 0))
        for d, var in enumerate(plan.loop_vars):
            self.env[var] = dims[d]

    def _veval(self, e, vec, shape):
        k = e[0]
        if k == "num":
            return e[1]
        if k == "var":
            if e[1] in vec:
                return vec[e[1]]
            v = self.env[e[1]]
            if isinstance(v, np.ndarray):
                raise VsimError(f"memory {e[1]!r} used as scalar")
            return v
        if k == "idx":
            arr = self.env[e[1]]
            idx = self._veval(e[2], vec, shape)
            if isinstance(idx, np.ndarray):
                return arr[idx]
            return int(arr[int(idx)])
        if k == "psel":
            v = self._veval(("var", e[1]), vec, shape)
            width = e[2] - e[3] + 1
            return (v >> e[3]) & ((1 << width) - 1)
        if k == "signed":
            return self._veval(e[1], vec, shape)
        if k == "unary":
            v = self._veval(e[2], vec, shape)
            if e[1] == "-":
                return _w32(np.negative(v) if isinstance(v, np.ndarray)
                            else -v)
            if e[1] == "~":
                return _w32(np.invert(v) if isinstance(v, np.ndarray)
                            else ~v)
            if e[1] == "!":
                return _flag_int(~_as_flag(v)
                                 if isinstance(v, np.ndarray)
                                 else not _as_flag(v))
            return v
        if k == "bin":
            op = e[1]
            a = self._veval(e[2], vec, shape)
            b = self._veval(e[3], vec, shape)
            if op == "+":
                return _w32(np.add(a, b) if _anyarr(a, b) else a + b)
            if op == "-":
                return _w32(np.subtract(a, b) if _anyarr(a, b)
                            else a - b)
            if op == "&":
                return _w32(a & b)
            if op == "|":
                return _w32(a | b)
            if op == "^":
                return _w32(a ^ b)
            if op == "<<":
                return _shl(a, b)
            if op == ">>":
                return _shrl(a, b)
            if op == ">>>":
                return _shra(a, b)
            if op == "&&":
                return _flag_int(_as_flag(a) & _as_flag(b)
                                 if _anyarr(a, b)
                                 else (_as_flag(a) and _as_flag(b)))
            if op == "||":
                return _flag_int(_as_flag(a) | _as_flag(b)
                                 if _anyarr(a, b)
                                 else (_as_flag(a) or _as_flag(b)))
            cmp = {"<": np.less, "<=": np.less_equal, ">": np.greater,
                   ">=": np.greater_equal, "==": np.equal,
                   "!=": np.not_equal}[op]
            if _anyarr(a, b):
                return cmp(a, b).astype(np.int64)
            return 1 if cmp(a, b) else 0
        if k == "tern":
            c = self._veval(e[1], vec, shape)
            a = self._veval(e[2], vec, shape)
            b = self._veval(e[3], vec, shape)
            if _anyarr(a, b, c):
                return np.where(_as_flag(c), a, b)
            return a if c != 0 else b
        raise VsimError(f"cannot vector-evaluate {e!r}")


def _anyarr(*vals) -> bool:
    return any(isinstance(v, np.ndarray) for v in vals)


class _NoVec(Exception):
    pass


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def run_netlist(net, inputs, rom_loader=None, *, vectorize=True,
                trace=None, max_cycles: int = 200_000_000):
    """Simulate a netlist (text or parsed :class:`Netlist`) to ``done``
    and return the program outputs (shaped int32 / bool arrays).

    ``trace(cycle, state, instr_id, op, mems, values)`` fires after each
    FSM state that commits an IR instruction; ``vectorize=False`` forces
    the statement-by-statement slow path everywhere.
    """
    if isinstance(net, str):
        net = parse_netlist(net)
    sim = _Sim(net, rom_loader=rom_loader, vectorize=vectorize,
               trace=trace, max_cycles=max_cycles)
    if len(inputs) != len(net.inputs):
        raise VsimError(f"netlist takes {len(net.inputs)} inputs, "
                        f"got {len(inputs)}")
    for port, val in zip(net.inputs, inputs):
        sim.poke(port, val)
    sim.run()
    return [sim.peek(port) for port in net.outputs]
