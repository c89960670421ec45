"""Device ms per served wave of the step's kernels (the captured session
step: mask, cascade, standardization, readout), from the profiler's trace
of the traced waves; copies left out."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "stream":
        return None
    t = readings.kernels(ctx)
    return None if t is None else t * 1e3
