"""The port's dry-run tier against the reference's, on the CPU.

* ``launch.specs.cell_table``: string for string the reference's, every
  arch;
* ``launch.dryrun.model_flops``: equal to the reference's for every arch
  x shape at the smoke sizes, and for qwen3-8b and deepseek-moe-16b at
  full size (the params as fake tensors, as the reference's are abstract);
* ``pick_accum``: equal to the reference's on both production meshes when
  given the reference's 10e9 budget;
* ``launch.op_cost`` (the port's replacement for the reference's HLO
  walk), as tests/test_hlo_cost.py holds that walk: one matrix product
  counts 2mnk, a loop of N products N times (nested loops compound),
  transcendentals apart from flops, an elementwise op's bytes about its
  input plus its output, a glm4 smoke train step at 8 layers within [0.5,
  2.5] x 6ND;
* a mini dry run, as tests/test_distributed.py's in miniature: the
  qwen3-8b smoke train cell (seq 128 x batch 8, remat) on a fake
  (2, 2, 2) process group: flops > 0, collective bytes > 0, temp bytes
  > 0 and a dominant term.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when imported; the tests import it with the variable put back at
once, before JAX can read it.
"""

import dataclasses
import os

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.configs import get_smoke as ref_get_smoke
from repro.launch import specs as RS
from repro_torch.configs import get_arch, get_smoke
from repro_torch.distributed.steps import make_train_step
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig

ARCHS = sorted(REF_ARCH_IDS)


def _ref_dryrun():
    """The reference's dryrun module, ``XLA_FLAGS`` left as it was."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


class _Mesh:
    """Axis names and sizes, all either package's ``pick_accum`` reads."""

    def __init__(self, shape):
        self.axis_names = {2: ("data", "model"),
                           3: ("pod", "data", "model")}[len(shape)]
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_table_is_the_reference_s(arch):
    assert set(S.SHAPES) == set(RS.SHAPES)
    for name in S.SHAPES:
        assert dataclasses.asdict(S.SHAPES[name]) == \
            dataclasses.asdict(RS.SHAPES[name])
    for get, ref_get in ((get_arch, ref_get_arch),
                         (get_smoke, ref_get_smoke)):
        assert S.cell_table(get(arch)) == RS.cell_table(ref_get(arch))
        assert S.runnable_cells(get(arch)) == \
            RS.runnable_cells(ref_get(arch))
        assert [S.cache_len_for(get(arch), c.seq_len)
                for c in S.SHAPES.values()] == \
            [RS.cache_len_for(ref_get(arch), c.seq_len)
             for c in RS.SHAPES.values()]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_pick_accum_are_the_reference_s(arch):
    RD = _ref_dryrun()
    for cell in S.SHAPES.values():
        assert D.model_flops(get_smoke(arch), cell) == \
            RD.model_flops(ref_get_smoke(arch), RS.SHAPES[cell.name])
        for shape in ((16, 16), (2, 16, 16)):
            assert D.pick_accum(get_arch(arch), cell, _Mesh(shape),
                                budget=10e9) == \
                RD.pick_accum(ref_get_arch(arch), RS.SHAPES[cell.name],
                              _Mesh(shape))
    if arch in ("qwen3-8b", "deepseek-moe-16b"):
        for cell in S.SHAPES.values():
            assert D.model_flops(get_arch(arch), cell) == \
                RD.model_flops(ref_get_arch(arch), RS.SHAPES[cell.name])


def test_specs_allocate_nothing_and_match_the_reference_shapes():
    """At full size (qwen3-8b: 8.2 G params) every spec is a fake tensor,
    of the reference's shapes."""
    cfg, rc = get_arch("qwen3-8b"), ref_get_arch("qwen3-8b")
    mode = FakeTensorMode()
    state = S.state_specs(cfg, mode)
    assert T.param_count(state.params) == RT_param_count(rc)
    for cell in S.SHAPES.values():
        if cell.name == "long_500k":
            continue
        got = S.input_specs(cfg, cell, mode)
        want = RS.input_specs(rc, RS.SHAPES[cell.name])
        if cell.kind != "decode":
            got, want = got["batch"], want["batch"]
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
        else:
            assert tuple(got["tokens"].shape) == want["tokens"].shape
            assert tuple(got["cache"]["scan"][0]["k"].shape) == \
                want["cache"]["scan"]["k"].shape[1:]
        for t in jax.tree.leaves(got):
            assert type(t).__name__ == "FakeTensor"


def RT_param_count(rc) -> int:
    from repro.models import transformer as RT
    return RT.param_count(RS.params_specs(rc))


# -- op_cost, as tests/test_hlo_cost.py holds the reference's walk ------------


def _fake(*shape):
    return torch.empty(*shape, dtype=torch.float32)


def op_cost(fn, *args) -> dict:
    """``fn(*args)``'s counts (run inside the caller's FakeTensorMode)."""
    with OpCost() as cost:
        fn(*args)
    return cost.as_dict()


def test_single_matmul_flops():
    with FakeTensorMode():
        a, b = _fake(128, 256), _fake(256, 64)
        r = op_cost(lambda: a @ b)
    assert r["flops"] == 2 * 128 * 256 * 64


def test_loop_counts_each_trip():
    """The port's loops run unrolled: N products count N times."""
    with FakeTensorMode():
        w, x = _fake(64, 64), _fake(8, 64)

        def fn(x):
            for _ in range(20):
                x = torch.tanh(x @ w)
            return x
        r = op_cost(fn, x)
    expect = 20 * 2 * 8 * 64 * 64
    assert 0.9 * expect < r["flops"] < 1.6 * expect, (r["flops"], expect)


def test_nested_loops_compound():
    with FakeTensorMode():
        w, x = _fake(32, 32), _fake(4, 32)

        def fn(x):
            for _ in range(6):
                for _ in range(5):
                    x = x @ w
            return x
        r = op_cost(fn, x)
    expect = 30 * 2 * 4 * 32 * 32
    assert 0.9 * expect < r["flops"] < 1.5 * expect


def test_transcendentals_separate():
    with FakeTensorMode():
        x = _fake(1000)
        r = op_cost(torch.exp, x)
    assert r["transcendentals"] >= 1000
    assert r["flops"] < 100


def test_bytes_reasonable_for_elementwise():
    with FakeTensorMode():
        x = _fake(1024, 1024)
        r = op_cost(lambda: x * 2.0 + 1.0)
    # read + write of 4 MiB per op, unfused: between 8 MB and ~24 MB
    assert 0.5 * 8e6 < r["bytes_accessed"] < 3 * 8e6


def test_model_level_flops_against_analytic():
    """A glm4 smoke train step at 8 layers within [0.5, 2.5] x 6ND."""
    cfg = dataclasses.replace(get_smoke("glm4-9b"), num_layers=8)
    cell = S.ShapeCell("t", 128, 8, "train")
    mode = FakeTensorMode()
    state = S.state_specs(cfg, mode)
    batch = S.input_specs(cfg, cell, mode)["batch"]
    _, train_step = make_train_step(cfg, AdamWConfig())
    with mode, OpCost() as cost:
        train_step(state, batch)
    six_nd = 6 * T.param_count(state.params) * 8 * 128
    flops = cost.as_dict()["flops"]
    assert 0.5 * six_nd < flops < 2.5 * six_nd, (flops, six_nd)


# -- the dry run on a fake process group --------------------------------------


def test_mini_dryrun_on_a_fake_process_group():
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), remat=True)
    cell = S.ShapeCell("t", 128, 8, "train")
    with D.fake_world(8):
        mesh = make_production_mesh((2, 2, 2), device="cpu")
        traced = D.trace_cell(cfg, cell, mesh)
        r = D.roofline(traced, 8, cfg, cell, mesh)
    assert r["hlo_flops_per_device"] > 0
    assert r["collective_bytes"]["total"] > 0   # multi-pod communicates
    assert traced["memory"]["temp_bytes"] > 0
    assert traced["memory"]["argument_bytes"] > 0
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    # each rank computes its 2 of the 8 rows, and remat recomputes the
    # forward: torch's own counter of the products agrees within 10%
    assert 0.9 < r["xla_cost_analysis"]["flops"] / r[
        "hlo_flops_per_device"] <= 1.0
