"""Device ms per served wave of the step's kernels other than the stream
cascade kernel: the readout (kernel_machine.forward, or the twin's
readout_q) and the step's glue."""

from portbench import readings


def read(ctx):
    if ctx["kind_of_mix"] != "stream":
        return None
    t = readings.per_unit(ctx, lambda n: not readings.is_copy(n)
                          and readings.STREAM_CASCADE not in n)
    return None if t is None else t * 1e3
