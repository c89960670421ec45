"""Port vs reference: the float pipeline end to end, through the bridge.

Golden float entries: the reference's parameters for every case of
tests/golden_cases.py cross the bridge as numpy, the port computes the
one-shot and streamed outputs on the CPU, and they must match the
committed fixtures at ATOL = 1e-5 (tests/test_golden.py). The fixtures'
classifier weights were drawn with ``jax_threefry_partitionable`` off,
so the reference pipeline is built under that setting here.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_cases import CASES, GOLDEN_DIR, build_pipeline, make_audio
from repro_torch import bridge
from repro_torch.configs.esc10_mp import make_pipeline
from repro_torch.core import pipeline as pl

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _port(ref, **overrides):
    return bridge.pipeline_from_numpy(
        ref.config, [np.asarray(t) for t in ref.bp_taps],
        [np.asarray(t) for t in ref.lp_taps], np.asarray(ref.mu),
        np.asarray(ref.sigma), [np.asarray(a) for a in ref.clf],
        device="cpu", **overrides)


def _reference(case):
    with jax.threefry_partitionable(False):
        return build_pipeline(case)


def _stream(pipe, x, chunk, amax):
    state = pipe.init_session(x.shape[0], amax=amax)
    for i in range(0, x.shape[1], chunk):
        p, state = pipe.apply(x[:, i:i + chunk], state)
    return p, state


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_float_entries(name):
    case = CASES[name]
    want = dict(np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")))
    ref = _reference(case)
    x = make_audio(case)
    amax = np.abs(x).max(-1)          # seeded as golden_cases.py does
    got = {}
    for impl in ("xla", "pallas"):
        pipe = _port(ref, stream_impl=impl)
        if impl == "xla":
            p, phi = pipe.apply(x, return_features=True)
            got["p_oneshot"], got["phi_oneshot"] = p, phi
        p, state = _stream(pipe, x, case["chunk"], amax)
        got[f"p_stream_{impl}"], got[f"acc_stream_{impl}"] = p, state.acc
    for key, val in got.items():
        np.testing.assert_allclose(val.numpy(), want[key], atol=ATOL, rtol=0,
                                   err_msg=f"{name}: {key}")
    # the two cascades add in one order: bit for bit
    assert torch.equal(got["p_stream_xla"], got["p_stream_pallas"])
    assert torch.equal(got["acc_stream_xla"], got["acc_stream_pallas"])


def test_oneshot_kernel_path_matches_reference_pallas(monkeypatch):
    from repro_torch.kernels import ref as plain
    cascade, calls = plain.fir_mp_oneshot_cascade, []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return cascade(*args, **kw)

    # the kernel route runs the whole bank as one cascade call (its plain
    # version on CPU tensors)
    monkeypatch.setattr(plain, "fir_mp_oneshot_cascade", spy)
    case = dict(CASES["esc_mp_bisect"])
    case["cfg"] = dict(case["cfg"], use_pallas=True)
    ref = _reference(case)
    x = make_audio(case)[:, :200]
    p, phi = _port(ref).apply(x, return_features=True)
    assert calls == [(x.shape[0], 200)]
    p_r, phi_r = ref.apply(jnp.asarray(x), return_features=True)
    np.testing.assert_allclose(phi.numpy(), np.asarray(phi_r), atol=2e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_r), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_single_chunk_stream_is_oneshot_bitwise(impl):
    pipe = make_pipeline(smoke=True, device="cpu", stream_impl=impl,
                         use_pallas=False)
    x = np.random.default_rng(0).standard_normal((2, 300)).astype(np.float32)
    state = pipe.init_session(2)
    _, phi_s, state = pipe.apply(x, state, return_features=True)
    assert torch.equal(phi_s, pipe.features(x))
    assert state.count.tolist() == [300, 300]


@pytest.mark.parametrize("seed", [0, 1])
def test_chunking_invariance_and_cascades_agree(seed):
    """Any chunking lands on the one-shot accumulators to f32 round-off
    (the per-chunk sums add in another order), and the kernel cascade
    equals the torch-op cascade bit for bit under every chunking."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 400)).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, 400), 6, replace=False))
    bounds = [0, *cuts.tolist(), 400]
    accs = {}
    for impl in ("xla", "pallas"):
        pipe = make_pipeline(smoke=True, device="cpu", stream_impl=impl,
                             use_pallas=False)
        state = pipe.init_session(3)
        for a, b in zip(bounds[:-1], bounds[1:]):
            _, state = pipe.apply(x[:, a:b], state)
        accs[impl] = state.acc
        assert state.count.tolist() == [400] * 3
    assert torch.equal(accs["xla"], accs["pallas"])
    whole = pipe.apply(x, pipe.init_session(3))[1].acc
    torch.testing.assert_close(accs["pallas"], whole, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_inactive_and_zero_valid_slots_are_inert(impl):
    pipe = make_pipeline(smoke=True, device="cpu", stream_impl=impl)
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    state = pipe.init_session(3)
    _, state = pipe.apply(x, state)
    before = bridge.session_to_numpy(state)
    pl.set_active(state, [1], False)
    _, state = pipe.apply(x * 3, state, valid=torch.tensor([64, 64, 0]))
    after = bridge.session_to_numpy(state)
    for b, a in zip(before[:2], after[:2]):        # per-octave tuples
        for slot in (1, 2):
            for rb, ra in zip(b, a):
                np.testing.assert_array_equal(rb[slot], ra[slot])
    for b, a in zip(before[2:5], after[2:5]):
        np.testing.assert_array_equal(b[1:], a[1:])
    assert not np.array_equal(before[2][0], after[2][0])


def test_zero_length_chunk_is_a_pure_readout():
    pipe = make_pipeline(smoke=True, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 50)).astype(np.float32)
    p1, state = pipe.apply(x, pipe.init_session(2))
    p2, state2 = pipe.apply(np.zeros((2, 0), np.float32), state)
    assert state2 is state and torch.equal(p1, p2)


def test_session_bridge_round_trip_and_slot_surgery():
    pipe = make_pipeline(smoke=True, device="cpu")
    x = np.random.default_rng(3).standard_normal((3, 40)).astype(np.float32)
    _, state = pipe.apply(x, pipe.init_session(3))
    leaves = bridge.session_to_numpy(state)
    back = bridge.session_from_numpy(leaves, device="cpu")
    for a, b in zip(bridge.session_to_numpy(back), leaves):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)
    row = pl.take_slot(state, 0)
    pl.clear_slots(state, [0])                     # in place
    assert float(state.acc[0].abs().sum()) == 0 and state.count[0] == 0
    pl.put_slot(state, 2, row)                     # in place
    assert torch.equal(state.acc[2], row.acc) and state.count[2] == 40


def test_bridge_takes_reference_session_state():
    ref = _reference(CASES["esc_mp_f32"])
    st = ref.init_session(2, amax=jnp.asarray([1.0, 2.0]))
    leaves = (tuple(np.asarray(d) for d in st.delays),
              tuple(np.asarray(c) for c in st.consumed),
              np.asarray(st.acc), np.asarray(st.amax), np.asarray(st.count),
              np.asarray(st.active))
    port = bridge.session_from_numpy(leaves, device="cpu")
    want = _port(ref).init_session(2, amax=torch.tensor([1.0, 2.0]))
    for a, b in zip(bridge.session_to_numpy(port),
                    bridge.session_to_numpy(want)):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(u, v)
            assert u.dtype == v.dtype


def test_make_pipeline_defaults_to_the_kernels():
    pipe = make_pipeline(device="cpu")
    c = pipe.config
    assert (c.stream_impl, c.use_pallas, c.num_filters) == ("pallas", True, 30)
    assert all(t.device.type == "cpu" for t in pipe.buffers())
    assert all(t.device.type == "cpu" for t in pipe.parameters())
    assert {n for n, _ in pipe.named_buffers()} >= {"mu", "sigma", "bp_0",
                                                    "lp_4"}
    # the classifier's weights: frozen parameters of the deployed pipeline
    assert {n for n, p in pipe.named_parameters()
            if not p.requires_grad} >= {"clf.w_pos", "clf.log_gamma1"}


def test_no_silent_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pipeline(numerics="fixed")
    from repro_torch.configs.esc10_mp import FILTERBANK
    from repro_torch.core.filterbank import FilterBank
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FilterBank(FILTERBANK)


def test_fixed_numerics_builds_and_runs_on_cpu():
    pipe = make_pipeline(smoke=True, device="cpu", numerics="fixed",
                         fixed_amax=2.0)
    c = pipe.config
    assert (c.numerics, c.fixed_amax, c.stream_impl, c.use_pallas) == \
        ("fixed", 2.0, "pallas", True)
    x = np.random.default_rng(4).standard_normal((2, 120)).astype(np.float32)
    p, phi = pipe.apply(x, return_features=True)
    prog = pipe.fixed_program()
    assert p.shape == (2, 10) and phi.shape == (2, c.num_filters)
    # outputs land on the program's grids
    assert torch.equal(p, torch.round(p / prog.out_spec.scale)
                       * prog.out_spec.scale)
    p_s, state = pipe.apply(x, pipe.init_session(2))
    assert torch.equal(p_s, p) and state.acc.dtype == torch.int32


def test_unknown_numerics_raises():
    with pytest.raises(ValueError, match="unknown numerics"):
        make_pipeline(smoke=True, device="cpu", numerics="int8")
    pipe = make_pipeline(smoke=True, device="cpu")
    with pytest.raises(ValueError, match="unknown numerics"):
        pl.InFilterPipeline(pipe.config._replace(numerics="int8"),
                            pipe.bp_taps, pipe.lp_taps, pipe.mu, pipe.sigma,
                            pipe.clf.params, device="cpu")


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15
