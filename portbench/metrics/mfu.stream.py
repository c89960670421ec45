"""The whole step's share of the card's peak over the window: the counted
operations of every wave (cascade and readout, counts.py) over the
window times the published peak of the arithmetic counted (f32 for the
float configuration, int32 for the twin)."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "stream":
        return None
    return readings.mfu_pct(ctx)
