"""What the metric readers share: the traced kernel times and the peaks.

Each reader in ``metrics/`` takes the run's context and returns a number,
or None where it finds nothing to read (the metric is then left out).
"""

from __future__ import annotations

from portbench.trace import is_copy

# the cascade kernels, by the names the profiler gives them
STREAM_CASCADE = "fir_mp_stream"
ONESHOT_CASCADE = "fir_mp_oneshot"


def per_unit(ctx: dict, pick) -> float | None:
    """Device seconds per traced unit (wave or batch) of the kernels
    whose names ``pick`` accepts; None without a trace."""
    tr = ctx.get("trace")
    if not tr or not tr["units"]:
        return None
    return sum(s for n, s in tr["by_name"].items() if pick(n)) / tr["units"]


def kernels(ctx: dict) -> float | None:
    """Device seconds per unit of every kernel (copies left out)."""
    return per_unit(ctx, lambda n: not is_copy(n))


def peak(ctx: dict, what: str) -> float | None:
    """The card's published peak ``what`` (ops or bytes per second), None
    for a card the table does not hold."""
    row = ctx["peaks"].get(ctx.get("kind"))
    return None if row is None else float(row[what])


def ops_peak(ctx: dict) -> float | None:
    return peak(ctx, f"{ctx['ops_kind']}_ops_per_s")


def roofline_pct(ctx: dict, name: str) -> float | None:
    """The cascade's least time on this card over its traced device time
    per unit, in percent; None if the kernel did not show."""
    t = per_unit(ctx, lambda n: name in n)
    ops_s, bytes_s = ops_peak(ctx), peak(ctx, "hbm_bytes_per_s")
    if not t or ops_s is None:
        return None
    least = max(ctx["cascade_ops"] / ops_s, ctx["cascade_bytes"] / bytes_s)
    return 100.0 * least / t


def mfu_pct(ctx: dict) -> float | None:
    """The window's counted operations (the whole step's: the cascade and
    the readout) over the window times the card's peak, in percent."""
    ops_s = ops_peak(ctx)
    if ops_s is None or not ctx["window_s"]:
        return None
    return 100.0 * ctx["step_ops"] * ctx["units"] / (ctx["window_s"] * ops_s)
