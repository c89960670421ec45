"""First-divergence localization between the IR interpreter and the
Verilog netlist simulator.

A failed end-to-end parity check on a multi-thousand-instruction program
says almost nothing; what you want is the FIRST instruction whose
committed destination registers differ, because everything after it is
noise. Both backends expose the same commit-ordered trace (the
interpreter fires per executed instruction — loop bodies per trip, the
loop itself once after its last trip — and the netlist's ``// @trace``
states fire in exactly that order), so the two streams are compared
positionally, register by register.

Memory stays O(1) in trace length: the interpreter pass stores only a
digest per (instruction, destination) pair, the simulator compares
digests on the fly and stops at the first mismatch, and a second
interpreter pass recovers the expected values for just that event.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.ir import interp as ir_interp
from repro_torch.ir import vsim

__all__ = ["Divergence", "first_divergence"]


@dataclasses.dataclass(frozen=True)
class Divergence:
    """The first trace event where the netlist differs from the IR."""
    event_index: int          # position in the commit-ordered trace
    cycle: int                # netlist cycle that committed the event
    state: int                # FSM state label
    instr_id: int             # emitter instruction id (see // @trace)
    op: str                   # IR opcode
    reg: str                  # first mismatching destination memory
    flat_index: int           # first differing flat element
    got: int                  # netlist value
    want: int                 # interpreter value

    def __str__(self) -> str:
        return (f"first divergence at trace event {self.event_index} "
                f"(cycle {self.cycle}, state {self.state}, instr "
                f"{self.instr_id} op={self.op}): {self.reg}"
                f"[{self.flat_index}] = {self.got}, interpreter says "
                f"{self.want}")


def _norm(v) -> np.ndarray:
    return np.asarray(v).astype(np.int64).ravel()


def _digest(arr: np.ndarray) -> bytes:
    return hashlib.blake2b(arr.tobytes(), digest_size=16).digest()


class _Stop(Exception):
    pass


def first_divergence(prog, netlist, inputs, rom_loader=None, *,
                     vectorize: bool = True):
    """Run ``prog`` through the interpreter and ``netlist`` through the
    simulator on the same ``inputs`` and return the first trace event
    whose destination registers differ, or ``None`` if the two replay
    identically (full outputs included)."""
    if isinstance(netlist, str):
        netlist = vsim.parse_netlist(netlist)

    # pass 1: interpreter digests, commit order
    ref: list = []

    def rec(ins, vals):
        ref.append((ins.op, tuple(_digest(_norm(v)) for v in vals)))

    want_outs = ir_interp.run(prog, inputs, trace=rec)

    hit: dict = {}

    def chk(cycle, state, iid, op, mems, vals):
        k = len(hit.setdefault("seen", []))
        hit["seen"].append(None)
        if k >= len(ref):
            hit["ev"] = (k, cycle, state, iid, op, mems, vals, -1)
            raise _Stop
        rop, rdigs = ref[k]
        if rop != op or len(rdigs) != len(vals):
            hit["ev"] = (k, cycle, state, iid, op, mems, vals, -2)
            raise _Stop
        for j, v in enumerate(vals):
            if _digest(v.astype(np.int64)) != rdigs[j]:
                hit["ev"] = (k, cycle, state, iid, op, mems, vals, j)
                raise _Stop

    try:
        got_outs = vsim.run_netlist(netlist, inputs, rom_loader,
                                    vectorize=vectorize, trace=chk)
    except _Stop:
        got_outs = None

    if "ev" not in hit:
        # traces identical; confirm the program outputs agree too
        for o, w in zip(got_outs, want_outs):
            if not np.array_equal(_norm(o), _norm(w)):
                raise AssertionError(
                    "trace replayed identically but outputs differ — "
                    "output wiring bug, not a datapath divergence")
        return None

    k, cycle, state, iid, op, mems, vals, j = hit["ev"]
    if j < 0:
        return Divergence(event_index=k, cycle=cycle, state=state,
                          instr_id=iid, op=op,
                          reg=mems[0] if mems else "?", flat_index=-1,
                          got=0, want=0)

    # pass 2: recover the expected values for event k only
    box: dict = {"i": 0}

    def cap(ins, vs):
        if box["i"] == k:
            box["want"] = [_norm(v) for v in vs]
        box["i"] += 1

    ir_interp.run(prog, inputs, trace=cap)
    want = box["want"][j]
    got = vals[j].astype(np.int64)
    n = min(len(got), len(want))
    bad = np.nonzero(got[:n] != want[:n])[0]
    fi = int(bad[0]) if len(bad) else n
    return Divergence(event_index=k, cycle=cycle, state=state,
                      instr_id=iid, op=op, reg=mems[j],
                      flat_index=fi,
                      got=int(got[fi]) if fi < len(got) else 0,
                      want=int(want[fi]) if fi < len(want) else 0)
