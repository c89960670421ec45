"""The inputs are a function of the seed: the same seed gives the same
traffic, calibration audio, standardization and classifier; another seed
gives others. No two streams play the same audio in step."""

import numpy as np
import pytest
import torch

from portbench import audio, run, system
from portbench.drivers import waves
from portbench_tiny import config

SEEDS = (0, 2**31 + 5, 3 * 2**40 + 1)


def _schedule(seed, **cut):
    spec = run.resolve(run.benchmark(), "esc10-mp-float.stream-2048")
    mix = dict(spec["mix"], packet=64, **cut)
    return mix, waves.schedule(mix, spec["config"], seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_schedule_is_the_seeds(seed):
    mix, a = _schedule(seed)
    _, b = _schedule(seed)
    _, c = _schedule(seed + 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert a["pool"].shape == (mix["pool_clips"], mix["session_packets"],
                               mix["packet"])
    assert not np.array_equal(a["pool"], c["pool"])
    assert not np.array_equal(a["clip"], c["clip"])


def test_no_two_streams_play_the_same_packet_in_step():
    mix, sched = _schedule(7)
    Ls, S = mix["session_packets"], mix["streams"]
    restarts = 0
    for w in range(0, 3 * Ls):
        k, j = waves.position(sched, w)
        rows = sched["clip"][np.arange(S), k % waves.DRAWN_WINDOWS] * Ls + j
        assert len(set(rows.tolist())) == S
        got = np.stack([waves.packets(sched, i, [w])[0] for i in range(S)])
        assert np.array_equal(got, sched["pool"].reshape(-1, mix["packet"])
                              [rows])
        if w % mix["inflight"] == 0:
            restarts += int((j == 0).sum())
        else:
            assert not (j == 0).any(), "windows restart between rounds"
    # every stream restarts once per window, a group per round
    assert restarts == 3 * S


def test_windows_start_at_a_clip_and_change_clip():
    mix, sched = _schedule(11)
    Ls = mix["session_packets"]
    x = waves._windows(sched, [0, 5], 3 * Ls)
    for w in x:
        assert sum(len(pk) for _, pk in w) == 3 * Ls
        for s, pk in w[1:]:
            assert any(np.array_equal(pk, c[:len(pk)])
                       for c in sched["pool"])
        assert len({pk.tobytes() for _, pk in w[1:]}) == len(w) - 1


@pytest.mark.parametrize("seed", SEEDS)
def test_clips_and_calibration_are_the_seeds(seed):
    x = audio.clips(system.subseed(seed, system.TRAFFIC), 3, 4000, 16000.0)
    y = audio.clips(system.subseed(seed, system.TRAFFIC), 3, 4000, 16000.0)
    assert np.array_equal(x, y) and np.abs(x).max() <= 1.0
    cfg = run.resolve(run.benchmark(), "esc10-mp-fixed.clips-5s")["config"]
    cal = system.calibration_audio(cfg, seed)
    assert np.array_equal(cal, system.calibration_audio(cfg, seed))
    assert not np.array_equal(cal, system.calibration_audio(cfg, seed + 1))


def test_classifier_is_the_seeds():
    cfg = config("esc10-mp-float.clips-5s")
    a = system.draw_classifier(cfg, 11, torch.device("cpu"))
    b = system.draw_classifier(cfg, 11, torch.device("cpu"))
    c = system.draw_classifier(cfg, 12, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["w_pos"], c["w_pos"])
    assert a["w_pos"].shape == (30, 10)
    assert 0 <= float(a["w_pos"].min()) and float(a["w_pos"].max()) < 0.5
    assert not torch.equal(a["mu"], c["mu"])
    assert bool((a["sigma"] > 0).all()) and a["mu"].shape == (30,)


def test_subseeds_differ_by_purpose_and_take_any_whole_number():
    seeds = {system.subseed(s, p) for s in (-1, 0, 2**33 + 1)
             for p in range(5)}
    assert len(seeds) == 15 and all(0 <= s < 2**63 for s in seeds)
