"""The benchmark's plain reference against the port's CPU path (the
torch-op session step, ``stream_impl="xla"``, and the torch-op one-shot
bank, ``use_pallas=False``) at the paper's full widths, on short packets
and one clip: the float reference within float32's reach, the integer
reference bit for bit."""

import functools

import numpy as np
import pytest
import torch

from portbench import audio, checks, system
from portbench_tiny import config, one_thread

L, WAVES, STREAMS = 256, 3, 2


def _port(cfg, clf, cal):
    cfg = dict(cfg, stream_impl="xla", use_pallas=False)
    return system.build(cfg, clf, torch.device("cpu"), cal)


@functools.lru_cache(maxsize=None)
def _case(numerics: str):
    with one_thread():
        cfg = config(f"esc10-mp-{numerics}.clips-5s")
        clf = system.draw_classifier(cfg, 5, torch.device("cpu"))
        cal = system.calibration_audio(cfg, 5)
        return cfg, clf, cal, _port(cfg, clf, cal), checks.Reference(
            cfg, system.host(clf), cal, torch.device("cpu"))


@pytest.fixture(params=["float", "fixed"])
def case(request):
    return _case(request.param)


def test_taps_equal_the_ports(case):
    _, _, _, pipe, ref = case
    for o, taps in enumerate(ref.bp):
        assert np.array_equal(taps, pipe.bp_taps[o].numpy())
    for o, taps in enumerate(ref.lp):
        assert np.array_equal(taps, pipe.lp_taps[o].numpy())


def test_fixed_program_equals_the_ports():
    _, _, _, pipe, ref = _case("fixed")
    prog = pipe.fixed_program()
    assert ref.prog["signal"][1] == prog.signal.exp
    assert ref.prog["gains"] == tuple(
        prog.signal.exp - st.in_spec.exp for st in prog.bank.octaves)
    for mine, st in zip(ref.prog["stages"], prog.bank.octaves):
        assert np.array_equal(mine["taps"], st.bp_q)
        assert mine["band"][1] == st.band_spec.exp
        assert mine["acc_shift"] == st.acc_shift
    assert np.array_equal(ref.prog["wp"], prog.clf.wp_q)
    assert ref.prog["gamma1"] == prog.clf.gamma1_q


def test_one_clip(case):
    cfg, _, _, pipe, ref = case
    with one_thread():
        x = audio.clips(123, 1, 4000, 16000.0)
        p, phi = pipe.apply(torch.from_numpy(x), return_features=True)
        sums, _ = ref.cascade(x, x.shape[1])
        p_ref, phi_ref = ref.readout(ref.running(sums)[:, -1])
    if ref.fixed:
        assert checks.differ(p, p_ref) == 0
        assert checks.differ(phi, phi_ref) == 0
    else:
        # the bank's features, phi undone (phi = (s - mu) / sigma divides
        # a band's float32 rounding by its own spread)
        s = phi.double() * pipe.sigma.double() + pipe.mu.double()
        assert checks.rel_gap(s, ref.values(ref.running(sums)[:, -1])) \
            < 1e-5
        assert checks.gap(p, p_ref) < 1e-4


def test_short_packets(case):
    cfg, _, _, pipe, ref = case
    with one_thread():
        x = audio.clips(321, STREAMS, L * WAVES, 16000.0)
        state = pipe.init_session(STREAMS)
        ps = []
        for k in range(WAVES):
            p, state = pipe.apply(torch.from_numpy(x[:, k * L:(k + 1) * L]),
                                  state)
            ps.append(p)
        sums, signals = ref.cascade(x, L)
        acc = ref.running(sums)
        p_ref, _ = ref.readout(acc.reshape(-1, acc.shape[-1]))
    p_ref = p_ref.reshape(STREAMS, WAVES, -1)
    got = torch.stack(ps, 1)
    delays = ref.registers(signals)
    if ref.fixed:
        assert checks.differ(got, p_ref) == 0
        assert checks.differ(state.acc, acc[:, -1]) == 0
        assert all(checks.differ(a, b) == 0
                   for a, b in zip(state.delays, delays))
    else:
        assert checks.gap(got, p_ref) < 1e-4
        assert checks.rel_gap(state.acc, acc[:, -1]) < 1e-5
        assert max(checks.gap(a, b)
                   for a, b in zip(state.delays, delays)) < 1e-5
    assert [int(c[0]) for c in state.consumed] == \
        [s.shape[1] for s in signals]


def test_reference_imports_nothing_of_the_port():
    import portbench.reference.filterbank as fl
    import portbench.reference.fixed as fx
    for mod in (fl, fx):
        text = open(mod.__file__).read()
        assert "repro_torch" not in text and "import repro" not in text
