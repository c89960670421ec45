"""The port's examples (examples/torch_*.py) run end to end on the CPU.

Each example's ``main`` runs with ``--device cpu`` at its smallest size:
``--fast`` where it has one, and here fewer and shorter clips and fewer
SGD steps (the examples' data and trainer are cut down through their own
module namespaces), one LM step at the tiny config. On the card the same
scripts run as they come (README.md). The examples import ``repro_torch``
only: the last test holds them to that.
"""

import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import trainer
from repro_torch.data.acoustic import make_esc10_like

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_streaming_monitor",
         "torch_acoustic_classification", "torch_lm_train",
         "torch_mp_layer_demo")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run loops of small torch ops (SGD steps, per-octave
    solves). Under a parallel test run every worker holds a full intra-op
    thread pool, and such loops then slow by two orders of magnitude;
    with one thread they keep their one-process time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut(monkeypatch, mod, steps=10):
    """The example's data: 2 clips per class for training, 1 held out,
    0.25 s each; its training: ``steps`` SGD steps."""
    def data(**kw):
        kw.update(per_class_train=2, per_class_test=1, seconds=0.25)
        return make_esc10_like(**kw)

    def train(K, y, num_classes, cfg=None, **kw):
        cfg = dataclasses.replace(cfg or trainer.TrainConfig(),
                                  num_steps=steps)
        return real_train(K, y, num_classes, cfg, **kw)

    real_train = trainer.train
    monkeypatch.setattr(mod, "make_esc10_like", data)
    monkeypatch.setattr(trainer, "train", train)


def test_quickstart(monkeypatch, capsys):
    mod = _load("torch_quickstart")
    _cut(monkeypatch, mod)
    losses = mod.main(["--device", "cpu"])
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert "test  acc @8-bit" in capsys.readouterr().out


def test_streaming_monitor(monkeypatch, capsys):
    mod = _load("torch_streaming_monitor")
    _cut(monkeypatch, mod)
    acc = mod.main(["--fast", "--device", "cpu"])
    assert 0.0 <= acc <= 1.0
    out = capsys.readouterr().out
    assert "streamed  test acc" in out and "served    4 sessions" in out


def test_acoustic_classification(monkeypatch, capsys):
    """The deployment flow's last step holds the fake-quant twin (float32
    codes through the integer bank kernel's route) to the int32 twin."""
    mod = _load("torch_acoustic_classification")
    _cut(monkeypatch, mod)
    accs = mod.main(["--fast", "--device", "cpu"])
    assert set(accs) == {"mac", "mp", "mp8", "kernel", "fixed"}
    assert all(0.0 <= v <= 1.0 for v in accs.values())
    assert "f32-carried codes equal the int32 codes: True" in \
        capsys.readouterr().out


def test_lm_train(tmp_path):
    mod = _load("torch_lm_train")
    losses = mod.main(["--steps", "1", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert len(losses) == 1 and losses[0] > 0
    assert (tmp_path / "step_00000001").exists() or any(tmp_path.iterdir())


def test_mp_layer_demo(monkeypatch):
    """At a tiny width (one layer of 32; the MP product's plain version on
    the CPU is slow at the demo's), two steps."""
    mod = _load("torch_mp_layer_demo")
    real = mod.ArchConfig
    monkeypatch.setattr(mod, "ArchConfig", lambda **kw: real(**dict(
        kw, num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
        d_ff=64)))
    losses = mod.main(["--steps", "2", "--device", "cpu"])
    assert len(losses) == 2 and losses[-1] < losses[0]


@pytest.mark.parametrize("name", NAMES)
def test_examples_import_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"argparse", "dataclasses", "os", "tempfile", "time",
                     "numpy", "torch", "repro_torch"}, roots
    assert "repro" not in roots and "jax" not in roots
    assert name not in sys.modules
