"""Host ms per served wave inside StreamServer.open and .close, children
included (the queue's flush, the slot writes, a checkpoint's restore or
park), from the port's own spans over the traced rounds."""

from portbench import program


def read(ctx):
    return program.stream_per_wave(ctx, program.ADMISSION)
