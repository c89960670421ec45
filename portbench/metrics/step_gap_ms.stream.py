"""Card ms per served wave between the end of the wave before it (its
decisions copied out) and its start (before its first copy), from the
server's own timed CUDA events over the traced rounds: the card's idle
time between waves, with the slot writes it ran there."""

from portbench import program


def read(ctx):
    gaps = [w["gap_ms"] for w in program.timed_waves(ctx)
            if w["gap_ms"] is not None]
    return sum(gaps) / len(gaps) if gaps else None
