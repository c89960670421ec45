"""decision_ms.p95's statistic (the 95th percentile over every packet of
the window of the time from its wave's submit to its decision resolved,
ms) as a per-layer metric, for a stream cell whose device is idle most of
its traced window: there the host's path sets it."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return float(np.percentile(np.repeat(np.asarray(lat), ctx["rows"]), 95)
                 * 1e3)
