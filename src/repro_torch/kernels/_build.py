"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries live in ``kernels/build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a checkout builds everything on its
first call and an edited source rebuilds.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` so the compiler cannot
contract adds into FMAs and reshape the float add DAG, and no fast math
and no ``-ftz=true`` (the Newton solver divides, and the float contract
needs IEEE division; the int kernels' float carrier needs denormals: a
right shift of a negative code is floor(ldexp(q, -k)), -1 where the
scaled value is denormal, -0 once flushed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "lib_path", "nvcc_path",
           "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fir_mp_stream", "fir_mp_bank", "fir_mp_stream_q",
           "fir_mp_bank_q", "mp_linear", "mp_linear_bwd", "mp_waterfill",
           "slot_admit")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "fir_mp_stream": ("fir_mp_stream_launch",
                      [_P] * 9 + [_I] * 8 + [_F] + [_I] * 5 + [_P]),
    "fir_mp_bank": ("fir_mp_oneshot_launch",
                    [_P, _P] + [_P, _I] * 2 + [_I] * 5 + [_F, _I, _P]),
    "fir_mp_stream_q": ("fir_mp_stream_q_launch",
                        [_P] * 9 + [_I] * 14 + [_P]),
    "fir_mp_bank_q": ("fir_mp_oneshot_q_launch",
                      [_P] * 3 + [_P, _I] * 2 + [_I] * 6 + [_P] * 3),
    "mp_linear": ("mp_linear_launch", [_P] * 4 + [_I] * 5 + [_F, _I, _P]),
    "mp_linear_bwd": ("mp_linear_bwd_launch", [_P] * 7 + [_I] * 6 + [_P]),
    "mp_waterfill": ("mp_waterfill_launch",
                     [_P] * 2 + [_I] * 2 + [_F] + [_I] * 3 + [_P]),
    "slot_admit": ("slot_admit_launch", [_P, _P, _I, _P, _I, _P]),
}
# further entry points: symbol -> (source, argument types)
EXTRA_SYMBOLS = {"mp_linear_plan": ("mp_linear", [_I] * 5 + [_P]),
                 "fir_mp_oneshot_ctas": ("fir_mp_bank", [_I]),
                 "fir_mp_oneshot_q_ctas": ("fir_mp_bank_q", [_I])}

_LIBS: dict = {}
_LOGS: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME)")


def _build_dir(name: str) -> Path:
    root = Path(__file__).resolve().parent / "build"
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    return root / digest


def lib_path(name: str) -> Path:
    return _build_dir(name) / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    process and the temporary output path, or None."""
    out = lib_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, started) -> None:
    proc, tmp = started
    log, _ = proc.communicate()
    _LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib_path(name))   # atomic: readers never see a half


def build_all(names=SOURCES) -> float:
    """Build every missing library, one nvcc per source started together.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    started = {nm: _start(nm) for nm in names}
    for nm, st in started.items():
        if st is not None:
            _finish(nm, st)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill report) from this process's
    build of ``name``; empty if the library was already built."""
    return _LOGS.get(name, "")


def load(name: str):
    """The C entry point of ``csrc/<name>.cu``, or the entry point ``name``
    of ``EXTRA_SYMBOLS``, building its source if needed."""
    if name not in _LIBS:
        if name in SIGNATURES:
            src, (sym, argtypes) = name, SIGNATURES[name]
        else:
            (src, argtypes), sym = EXTRA_SYMBOLS[name], name
        if not lib_path(src).exists():
            build_all([src])
        fn = getattr(ctypes.CDLL(str(lib_path(src))), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return _LIBS[name]
