"""The one-shot cascade kernel's share of its roofline: the least time of
a batch's cascade work on this card (counts.bank_ops and oneshot_bytes
over the published peaks) over the kernel's traced device time per
batch."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "clips":
        return None
    return readings.roofline_pct(ctx, readings.ONESHOT_CASCADE)
