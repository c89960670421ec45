"""Straggler / health monitoring for the training loop.

At thousand-node scale the common failure modes are (a) a host that dies
(handled by checkpoint/restart in the launcher) and (b) a host that slows
down — thermal throttling, a flaky NIC — which silently drags every
synchronous step. This monitor keeps a per-source EWMA of step times and
flags sources whose recent step time exceeds `threshold` x the fleet median.

The launcher polls `verdict()` each step: 'ok' / 'straggler' (log + alert;
on TPU pods the remediation is re-scheduling the reserved core — simulated
here) / 'stall' (no heartbeat within timeout -> trigger restart-from-ckpt).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Optional

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class _Stat:
    ewma: float = 0.0
    n: int = 0
    last_beat: float = 0.0


class StragglerMonitor:
    def __init__(self, alpha: float = 0.2, threshold: float = 1.5,
                 stall_timeout_s: float = 300.0):
        self.alpha = alpha
        self.threshold = threshold
        self.stall_timeout_s = stall_timeout_s
        self.stats: dict[str, _Stat] = defaultdict(_Stat)

    def record(self, source: str, step_time_s: float,
               now: Optional[float] = None):
        st = self.stats[source]
        st.ewma = (step_time_s if st.n == 0
                   else self.alpha * step_time_s + (1 - self.alpha) * st.ewma)
        st.n += 1
        st.last_beat = now if now is not None else time.time()

    def fleet_median(self) -> float:
        vals = sorted(s.ewma for s in self.stats.values() if s.n > 0)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def verdict(self, source: str, now: Optional[float] = None) -> str:
        st = self.stats.get(source)
        now = now if now is not None else time.time()
        if st is None or st.n == 0:
            return "ok"
        if now - st.last_beat > self.stall_timeout_s:
            return "stall"
        med = self.fleet_median()
        if med > 0 and st.ewma > self.threshold * med and st.n >= 3:
            return "straggler"
        return "ok"

    def stragglers(self, now: Optional[float] = None) -> list:
        return [s for s in self.stats if self.verdict(s, now) != "ok"]
