"""Seconds from the process's start to the window's: imports, the CUDA
context, building or loading the kernels, the inputs, the pipeline (the
fixed twin's calibration too) and the warm-up of the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
