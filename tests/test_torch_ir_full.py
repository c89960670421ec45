"""Port vs reference: the census of the deployed programs at the full
``esc10-mp`` config, on the CPU.

The port's ``oneshot_q`` and ``session_step_q`` are traced at the full
config (``analysis.targets.build_targets``; ~34 k aten nodes together);
the reference's jaxprs stay small because they keep their ``scan`` loops.
The reference's census splits into its input-dependent part, which must be
the port's census plus the work ``ir_reference`` names, exactly, and its
input-free part, which the port folds. That input-free part, together with
the drift between the committed ``artifacts/ir/*/ir.json`` census and the
live reference's, is what ``ir_reference.COMMITTED_INPUT_FREE`` pins and
``chip_smoke.py`` gates the committed census against.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest

from ir_reference import (COMMITTED_INPUT_FREE, census_diff,
                          reference_block_padding, reference_index_overhead)
from repro.analysis import targets as ref_targets
from repro.core import fixed as fx_ref
from repro_torch.analysis import census
from repro_torch.analysis import targets as tg
from test_torch_ir import ref_census, ref_census_split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16000                    # 1 s of audio at the full config
NAMES = ("oneshot_q", "session_step_q")


@pytest.fixture(scope="module")
def full():
    targets, _ = tg.build_targets(smoke=False, device="cpu", names=NAMES)
    port = {t.name: t for t in targets}
    pipe = ref_targets._fixed_pipeline(False)
    prog = pipe.fixed_program()
    one = lambda q: fx_ref.infer_q(prog, q)                      # noqa: E731
    step = lambda st, q, v: fx_ref.session_step_q(prog, st, q, v)  # noqa
    jaxprs = {
        "oneshot_q": jax.make_jaxpr(one)(jnp.zeros((1, N), jnp.int32)),
        "session_step_q": jax.make_jaxpr(step)(
            pipe.init_session(1),
            jnp.zeros((1, ref_targets.CHUNK_LEN), jnp.int32),
            jnp.zeros((1,), jnp.int32)),
    }
    committed = {}
    for name in NAMES:
        with open(os.path.join(ROOT, "artifacts", "ir", name,
                               "ir.json")) as f:
            committed[name] = json.load(f)["census"]
    return SimpleNamespace(port=port, jaxprs=jaxprs, committed=committed)


def _named(t):
    if t.name == "oneshot_q":
        return reference_block_padding(t.program, t.n_samples)
    S, L = t.example[-2].shape
    return reference_index_overhead(t.program, S, L, t.example[0].shape[1])


def _nonzero(d) -> dict:
    return {k: int(v) for k, v in d.items() if v}


@pytest.mark.parametrize("name", NAMES)
def test_full_census_decomposes_into_the_reference(full, name, monkeypatch):
    t = full.port[name]
    ours = census(t.traced)
    named = _named(t)
    dep, free = ref_census_split(full.jaxprs[name])
    # the reference's input-dependent census is the port's plus the named
    # work, op by op
    assert _nonzero(census_diff(dep, ours)) == _nonzero(named)
    # its input-free census is what the port folds; the two parts are the
    # reference's whole census
    whole = ref_census(full.jaxprs[name], monkeypatch)
    assert dict(dep + free) == dict(whole)
    assert ours["multiply"] == ours["transcendental_or_div"] == 0
    assert free["multiply"] == free["transcendental_or_div"] == 0
    # the committed census less the port's and the named work is that
    # input-free census plus the committed artifact's drift from the live
    # reference: the pin chip_smoke.py gates the committed census against
    rest = census_diff(census_diff(full.committed[name], ours), named)
    drift = census_diff(full.committed[name], whole)
    assert _nonzero(census_diff(rest, free)) == _nonzero(drift)
    assert _nonzero(rest) == COMMITTED_INPUT_FREE[name], (
        _nonzero(rest), _nonzero(free), _nonzero(drift))
