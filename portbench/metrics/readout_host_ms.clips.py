"""Host ms per batch issuing the readout (InFilterPipeline.apply's
classifier call, or infer_q's standardize and classifier for the twin),
from the port's own spans over the traced batches."""

from portbench import program


def read(ctx):
    rec = program.record(ctx)
    units = ("pipeline.apply", "fixed.infer_q")
    n = len(program.outermost(rec, units)) if rec else 0
    if not n:
        return None
    return program.host_ms(rec, ("pipeline.readout", "fixed.readout")) / n
