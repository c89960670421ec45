"""The result line: its keys, the metrics a run reports, the compared
numbers last; and a run without a card prints no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench_tiny import CELLS, one_thread, run_tiny

ROOT = Path(run.__file__).resolve().parent.parent


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_shape(workload):
    with one_thread():
        _, line = run_tiny(workload)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"] for m in run.metrics_for(run.benchmark(), workload,
                                               False)}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_per_layer_readers_read_nothing_without_a_trace():
    with one_thread():
        ctx, _ = run_tiny("esc10-mp-float.stream-2048")
    ctx["kind"] = "cpu"
    got = {m["name"]: run.reader(m["name"])(ctx)
           for m in run.metrics_for(run.benchmark(),
                                    "esc10-mp-float.stream-2048", True)}
    assert got["step_device_ms.stream"] is None
    assert got["device_idle_pct"] is None
    assert got["stream_kernel_roofline_pct"] is None
    assert got["server_host_ms.stream"] > 0
    assert got["decision_ms.p95.host"] > 0


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "esc10-mp-fixed.clips-5s", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "portbench:" in out.stderr


def test_unknown_cell_no_result(capsys):
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
