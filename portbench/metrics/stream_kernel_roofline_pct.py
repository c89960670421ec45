"""The stream cascade kernel's share of its roofline: the least time of a
wave's cascade work on this card (counts.bank_ops and stream_bytes over
the published peaks) over the kernel's traced device time per wave."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "stream":
        return None
    return readings.roofline_pct(ctx, readings.STREAM_CASCADE)
