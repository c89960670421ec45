"""What decides ``correct``: the port's outputs against the plain
reference, worked out again from the benchmark's own inputs.

A float configuration is held against the reference in float64; its
numbers are gaps with limits. The fixed twin is held bit for bit: its
number is a count of codes that differ, with the limit 0. The control
(``control.py``) puts the reference computed a precision lower in the
port's place and must fail.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import filterbank as fl
from portbench.reference import fixed as fx


class Reference:
    """The reference for one configuration and classifier: float taps
    designed anew, and for the fixed twin its integer program compiled
    from the calibration audio. ``dtype`` is the float reference's
    precision (float64; the control's bfloat16); ``signal_bits``
    overrides the twin's register width (the control's 4)."""

    def __init__(self, cfg: dict, clf: dict, cal, device, *,
                 dtype=torch.float64, signal_bits: int | None = None):
        self.cfg, self.clf, self.cal, self.device = cfg, clf, cal, device
        self.fixed = cfg["numerics"] == "fixed"
        self.dtype = dtype
        self.bp, self.lp = fl.design(cfg["bank"])
        self.gamma = float(cfg["bank"]["gamma_f"])
        self.prog = (fx.compile_program(cfg, self.bp, self.lp, clf, cal,
                                        device, signal_bits)
                     if self.fixed else None)
        self.clf_f = dict(w_pos=clf["w_pos"], w_neg=clf["w_neg"],
                          b_pos=clf["b_pos"], b_neg=clf["b_neg"],
                          gamma1=float(np.exp(np.float64(
                              clf["log_gamma1"]))))

    def cascade(self, x: np.ndarray, segment: int):
        """(sums (B, N / segment, P), per-octave signals) of audio x."""
        xt = torch.as_tensor(x, device=self.device)
        if self.fixed:
            return fx.cascade(self.prog, fx.adc(self.prog, xt), segment)
        return fl.cascade(xt.to(self.dtype), self.bp, self.lp, self.gamma,
                          segment)

    def running(self, sums: torch.Tensor) -> torch.Tensor:
        """The accumulators after each segment."""
        if self.fixed:
            return fx.running(sums)
        return torch.cumsum(sums, 1)

    def readout(self, acc: torch.Tensor) -> tuple:
        """(p (R, C), phi (R, P)) as float64 numbers: the twin's codes
        times their scales (exact), or the float reference's values."""
        if self.fixed:
            p, phi = fx.readout(self.prog, acc)
            return (p.double() * 2.0 ** self.prog["operand"][1],
                    phi.double() * 2.0 ** self.prog["phi"][1])
        t = lambda k: torch.as_tensor(self.clf[k], device=acc.device).to(
            acc.dtype)
        phi = (acc - t("mu")) / t("sigma")
        return fl.classify(phi, self.clf_f).double(), phi.double()

    def values(self, acc: torch.Tensor) -> torch.Tensor:
        """Accumulators as float64 values: the twin's codes times their
        scale (exact), or the float reference's own."""
        if self.fixed:
            return acc.double() * 2.0 ** self.prog["acc_exp"]
        return acc.double()

    def registers(self, signals: list) -> list:
        """The last T - 1 samples of each octave's input (the delay lines
        a session holds; the twin's as register codes), zero-filled
        before the start, as float64."""
        b = self.cfg["bank"]
        T1 = max(int(b["bp_taps"]), int(b["lp_taps"])) - 1
        return [torch.nn.functional.pad(s, (T1, 0))[:, -T1:].double()
                for s in signals]


def gap(a, b) -> float:
    """max |a - b| as a float (0 for empty inputs)."""
    d = (torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs()
    return float(d.max()) if d.numel() else 0.0


def rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    b = torch.as_tensor(b).double()
    scale = float(b.abs().max()) if b.numel() else 0.0
    return gap(a, b) / scale if scale > 0 else gap(a, b)


def differ(a, b) -> int:
    """How many entries differ (float64 comparison of exact values)."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return int((a != b).sum())


def decision_gaps(labels, confs, p_ref) -> tuple:
    """For served decisions (a label and its confidence per request) held
    against the reference's p rows: (the widest |confidence - the
    reference's p at that label|, the widest gap by which the reference's
    p at the served label lies below its best)."""
    p_ref = torch.as_tensor(p_ref).double().cpu()
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.long)
    at = p_ref.gather(1, lab[:, None])[:, 0]
    conf = torch.as_tensor(np.asarray(confs), dtype=torch.float64)
    return (float((conf - at).abs().max()),
            float((p_ref.max(1).values - at).max()))


def result(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): each number at most its limit;
    a number with no limit, or a NaN, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = lim is not None and value == value and value <= lim
        ok = ok and good
        checks[name] = {"value": value, "limit": lim}
    return ok, checks


def control_reference(ref: Reference) -> Reference:
    """The control: the reference a precision below the configuration's,
    as its ``control`` block states (a float dtype, or the twin's register
    width)."""
    c = ref.cfg["control"]
    if "dtype" in c:
        return Reference(ref.cfg, ref.clf, ref.cal, ref.device,
                         dtype=getattr(torch, c["dtype"]))
    return Reference(ref.cfg, ref.clf, ref.cal, ref.device,
                     signal_bits=int(c["signal_bits"]))
