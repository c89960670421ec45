"""Core of the port: MP solvers, quantization, filter bank, kernel machine
and the in-filter pipeline (float numerics)."""
