"""Shared by the benchmark's CPU tests: the cells at a size a test run
holds (a few streams of short packets, a few short clips), run on the CPU
through the port's plain versions."""

from __future__ import annotations

import contextlib
import time

import torch

from portbench import run

STREAM = dict(streams=4, packet=256, max_chunk=256, min_chunk=256,
              session_packets=4, pool_clips=2, warm_rounds=1,
              check_streams=2)
CLIPS = dict(batch=4, pool_clips=8, clip_seconds=0.25, warm_batches=1,
             check_clips=64)
# the standardization's clips, as long as a tiny stream's window
STANDARDIZATION = dict(clips=10, clip_seconds=0.064)
CELLS = ("esc10-mp-float.stream-2048", "esc10-mp-fixed.stream-2048",
         "esc10-mp-float.clips-5s", "esc10-mp-fixed.clips-5s")


def config(workload: str) -> dict:
    """The cell's configuration with its standardization clips cut."""
    cfg = run.resolve(run.benchmark(), workload)["config"]
    cfg["standardization"] = dict(STANDARDIZATION)
    return cfg


def spec(workload: str) -> dict:
    """The cell's files with its mix (and standardization) cut to the
    tiny size."""
    s = run.resolve(run.benchmark(), workload)
    s["mix"].update(STREAM if s["mix"]["driver"] == "waves" else CLIPS)
    s["config"]["standardization"] = dict(STANDARDIZATION)
    return s


def run_tiny(workload: str, seed: int = 2**31 + 7, seconds: float = 0.3,
             check: bool = True) -> tuple:
    """(context, result line) of one tiny run on the CPU."""
    s = spec(workload)
    ctx = run.run_cell(workload, seed, seconds, False, torch.device("cpu"),
                       spec=s, check=check, t_start=time.perf_counter())
    line = run.result_line(run.benchmark(), workload, False, ctx,
                           s["limits"], "cpu", 1, "none")
    return ctx, line


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
