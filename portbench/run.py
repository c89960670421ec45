"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``,
its ``file``) and a traffic mix (``mixes/<traffic>.json``); the mix names
the driver that runs it (``drivers/<driver>.py``). Each metric is read by
``metrics/<metric name>.py``. So a new configuration, mix or metric is a
new file and a new entry, and no file here changes. The limits that
decide ``correct`` are the cell's own file, ``limits/<cell>.json``.

One process, one cell, one run: set up (everything up to the window,
counted in ``setup_s``), measure for ``--seconds``, with ``--trace 1``
profile a few more units of work, check the outputs against the plain
reference, and print one JSON line last on standard output (and the
compared numbers with their limits as the last lines on standard error).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, this folder heads sys.path: take it off, so that its
# modules (trace, audio, ...) shadow nothing and load as ``portbench.*``
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
# whole top-level module names the run must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Failure(Exception):
    """A run that prints no result: the message goes to standard error."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and limits, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Failure(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return dict(workload=w, config=load_json(ROOT / conf["file"]),
                mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"))


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``; each where its
    ``workloads`` list names the cell, or has none."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def forbidden_loaded() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def host_counters() -> dict:
    """What the host gave this process: wall seconds, its CPU seconds (all
    threads, and the main thread's alone) and the garbage collector's
    passes. A host-bound run that reads slow at the same CPU share ran on
    a slower CPU, not a busier one."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(),
            "cpu_s": ru.ru_utime + ru.ru_stime,
            "main_thread_cpu_s": time.thread_time(),
            "gc_passes": sum(g["collections"] for g in gc.get_stats())}


class Env:
    """What a driver is given, and the hooks it calls around the window."""

    def __init__(self, spec, seed, seconds, trace, device, check=True):
        self.cfg, self.mix = spec["config"], spec["mix"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.check = device, check
        from portbench.trace import Spans
        self.spans = Spans()
        self.t_window = None
        self.marks = []
        self.host = {}

    def mark(self, name: str) -> None:
        """Note the end of a set-up step (printed with the timings)."""
        self.marks.append((name, time.perf_counter()))

    def settle(self) -> None:
        """The last step of set-up: collect, then move everything set-up
        made out of the collector's reach (as a long-running server does
        after start-up), so the window's passes walk only its own
        objects."""
        gc.collect()
        gc.freeze()

    def window_started(self, t: float) -> None:
        self.t_window = t
        self.host = host_counters()

    def window_ended(self) -> None:
        """The host's counters over the window (``host_counters``)."""
        end = host_counters()
        self.host = {k: end[k] - v for k, v in self.host.items()}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, *, spec: dict | None = None, check: bool = True,
             t_start: float | None = None) -> dict:
    """Run the cell once on ``device``; returns the driver's context with
    ``setup_s`` added. ``spec`` overrides what ``resolve`` reads (the tests
    shrink a mix)."""
    bench = benchmark()
    spec = spec or resolve(bench, workload)
    env = Env(spec, seed, seconds, trace, device, check)
    env.mark("start")
    driver = importlib.import_module(
        f"portbench.drivers.{spec['mix']['driver']}")
    ctx = driver.run(env)
    t0 = T_START if t_start is None else t_start
    ctx["setup_s"] = env.t_window - t0
    ctx["setup_steps"] = [(n, t - t0) for n, t in env.marks]
    ctx["peaks"] = load_json(HERE / "peaks.json")
    ctx["workload"] = workload
    ctx["host"] = env.host
    return ctx


def result_line(bench: dict, workload: str, trace: bool, ctx: dict,
                limits: dict, kind: str, count: int, card_line: str
                ) -> dict:
    from portbench import checks
    from portbench.trace import breakdown
    correct, compared = checks.result(ctx.get("numbers", {}), limits)
    correct = correct and bool(compared) and ctx["failed"] == 0 \
        and ctx["attempted"] > 0
    ctx["kind"] = kind
    metrics = {}
    for m in metrics_for(bench, workload, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(ctx["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": int(ctx["attempted"]),
            "failed": int(ctx["failed"]), "metrics": metrics,
            "device": device, "card": card_line, "host": ctx.get("host")}
    tr = ctx.get("trace")
    if trace and tr is not None:
        device["busy_s"] = tr["busy_s"]
        device["window_s"] = tr["window_s"]
        line["breakdown"] = breakdown(tr)
    line["checks"] = compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        src = ROOT / "src"
        if not (src / "repro_torch").is_dir():
            raise Failure(f"the system under test is missing: no "
                          f"{src / 'repro_torch'}")
        sys.path.insert(0, str(ROOT))
        sys.path.insert(0, str(src))
        bench = benchmark()
        spec = resolve(bench, args.workload)
        chips = int(spec["workload"]["chips"])
        import torch
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise Failure("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < chips:
            raise Failure(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        ctx = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), device, spec=spec)
        line = result_line(bench, args.workload, bool(args.trace), ctx,
                           spec["limits"], torch.cuda.get_device_name(0),
                           chips, card())
        # last, after every reader ran: whatever loaded them counts
        seen = forbidden_loaded()
        if seen:
            raise Failure(f"modules of the JAX package or of JAX were "
                          f"loaded: {seen}")
    except Failure as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    sys.stdout.flush()
    print(f"card: {line['card']}", file=sys.stderr)
    print(f"timing: set-up {ctx['setup_s']:.3f} s, window "
          f"{ctx['window_s']:.3f} s ({ctx['units']} units), check "
          f"{ctx.get('check_s', 0.0):.3f} s; set-up steps end at "
          + ", ".join(f"{n} {t:.2f}" for n, t in ctx["setup_steps"]),
          file=sys.stderr)
    print(f"host over the window: {ctx['host']}", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
