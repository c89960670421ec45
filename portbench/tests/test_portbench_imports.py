"""Nothing the benchmark runs loads JAX or the JAX package: after every
harness module is imported, no module's whole top-level name is jax,
jaxlib, flax or repro (repro_torch is another name)."""

import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(run.__file__).resolve().parent.parent

PROBE = r"""
import importlib, pathlib, sys
sys.path[:0] = ["src", "."]
import portbench.run as run
for p in sorted(pathlib.Path("portbench").rglob("*.py")):
    if "tests" in p.parts or "metrics" in p.parts:
        continue
    importlib.import_module(".".join(p.with_suffix("").parts))
for m in run.benchmark()["end_to_end"] + run.benchmark()["per_layer"]:
    run.reader(m["name"])
import portbench.system, repro_torch.serving, repro_torch.core.fixed
bad = run.forbidden_loaded()
assert "repro_torch" in sys.modules
print("FORBIDDEN", bad)
"""


def test_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert "repro_torch_probe" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert "jaxlib.probe" in run.forbidden_loaded()


def test_harness_reads_nothing_of_the_jax_benchmarks():
    for p in (ROOT / "portbench").rglob("*.py"):
        if "tests" in p.parts:
            continue
        text = p.read_text()
        assert "benchmarks/" not in text and "import jax" not in text
        assert "from repro " not in text and "import repro\n" not in text


def test_a_reader_that_loads_jax_gets_no_result(monkeypatch, capsys):
    """The look at ``sys.modules`` comes after the metric readers ran:
    a reader that loads JAX leaves the run with no result line."""
    import types

    import torch

    def reading_loads_jax(*args, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "checks": {}}

    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(run, "run_cell", lambda *a, **kw: {})
    monkeypatch.setattr(run, "result_line", reading_loads_jax)
    monkeypatch.setattr(run, "card", lambda: "card")
    assert run.main(["--workload", "esc10-mp-fixed.clips-5s", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
