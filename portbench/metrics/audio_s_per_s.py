"""Seconds of audio classified per second of the window: every packet
resolved (stream mixes) or clip decided (clip mixes) in it, over all of
its time."""


def read(ctx):
    return ctx["audio_s"] / ctx["window_s"]
