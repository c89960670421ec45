"""Host ms per served wave inside StreamServer's resolve (the decisions'
argmax, the FeedResults, the sessions' histories), less its wait for the
card, from the port's own spans over the traced rounds."""

from portbench import program


def read(ctx):
    return program.stream_per_wave(ctx, ("server.resolve",),
                                   less=("server.wait",),
                                   outside=program.ADMISSION)
