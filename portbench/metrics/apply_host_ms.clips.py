"""Host ms per batch inside the clips cells' entry, until the call
returns (its launches; the card may still be running them):
InFilterPipeline.apply, or for the twin the ADC and core.fixed.infer_q."""


def read(ctx):
    h = ctx["host_s"]
    if "apply" not in h or not ctx["units"]:
        return None
    return h["apply"] / ctx["units"] * 1e3
