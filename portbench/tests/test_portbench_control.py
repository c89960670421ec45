"""The comparison that decides ``correct`` fails its control: the
reference a precision below the configuration's (bfloat16 for float32,
4-bit registers for the 8-bit twin) in the port's place, at a size a test
run holds. The port itself passes."""

import importlib

import pytest

from portbench import checks
from portbench_tiny import CELLS, one_thread, run_tiny, spec


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_port_passes(workload):
    with one_thread():
        ctx, line = run_tiny(workload, check=False)
        drv = importlib.import_module(
            f"portbench.drivers.{spec(workload)['mix']['driver']}")
        ref = ctx["reference"]
        mine = drv.compare(ref, **ctx["inputs"])
        ctrl = drv.compare(ref, **drv.control(
            checks.control_reference(ref), **ctx["inputs"]))
    limits = spec(workload)["limits"]
    assert checks.result(mine, limits)[0]
    assert not checks.result(ctrl, limits)[0]
    assert set(mine) == set(ctrl) == set(limits)
