"""Host ms per served wave inside StreamServer.submit and its dispatch
(the checks and queueing; per wave the staging, the copies and the replay
launched, the decisions' copy out), less the waits for the card inside
them, from the port's own spans over the traced rounds."""

from portbench import program


def read(ctx):
    return program.stream_per_wave(
        ctx, ("server.submit", "server.dispatch"), less=("server.wait",),
        outside=program.ADMISSION)
