"""Card ms per served wave from before its first copy to after its
decisions were copied out, from the server's own timed CUDA events over
the traced rounds. Less step_device_ms.stream, it is the card's idle time
inside the wave."""

from portbench import program


def read(ctx):
    spans = [w["span_ms"] for w in program.timed_waves(ctx)]
    return sum(spans) / len(spans) if spans else None
