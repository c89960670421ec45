"""A run with its timed path broken underneath reads ``correct`` false:
for each fault the cell can have, planted in the port on the CPU. The
clips cells' timed entry is ``InFilterPipeline.apply`` (float) and
``core.fixed.infer_q`` (the twin)."""

import pytest
import torch

from repro_torch.core import fixed
from repro_torch.core.pipeline import InFilterPipeline
from portbench_tiny import one_thread, run_tiny

STREAMS = ("esc10-mp-float.stream-2048", "esc10-mp-fixed.stream-2048")
CLIPS = ("esc10-mp-float.clips-5s", "esc10-mp-fixed.clips-5s")
STEP = InFilterPipeline._session_step
APPLY = InFilterPipeline.apply
INFER_Q = fixed.infer_q
BANK_Q = fixed.bank_accumulate_q
BAND = 7                          # the band a cascade fault moves


def state_unchanged(self, state, chunk, valid):
    """The step computes, then hands back the registers it was given."""
    _, p, phi = STEP(self, state, chunk, valid)
    return state, p, phi


def half_the_streams(self, state, chunk, valid):
    """The wave's second half of slots is left out."""
    valid = torch.as_tensor(valid).clone()
    valid[valid.shape[0] // 2:] = 0
    return STEP(self, state, chunk, valid)


def step_answer_altered(self, state, chunk, valid):
    """One stream's decision row shifted round by one class."""
    state, p, phi = STEP(self, state, chunk, valid)
    p = p.clone()
    p[0] = p[0].roll(1)
    return state, p, phi


def step_lsb_altered(self, state, chunk, valid):
    """One stream's decisions moved by one LSB of the twin's grid."""
    state, p, phi = STEP(self, state, chunk, valid)
    p = p.clone()
    p[0] += 2.0 ** self.fixed_program().out_spec.exp
    return state, p, phi


def step_sums_off_by_one(self, state, chunk, valid):
    """The cascade's sums in one band one LSB off (the twin's registers
    are int32 codes)."""
    state, p, phi = STEP(self, state, chunk, valid)
    state.acc[:, BAND] += 1
    return state, p, phi


def _half(f, x):
    """f on the first half of the batch; the rest get its outputs' mean."""
    h = x.shape[0] // 2
    out = f(x[:h])
    return tuple(torch.cat([t, t.float().mean(0, keepdim=True).to(
        t.dtype).expand(x.shape[0] - h, *t.shape[1:])]) for t in out)


def _roll_last(out):
    """The last clip's decision row (the first output) shifted round by
    one class."""
    p = out[0].clone()
    p[-1] = p[-1].roll(1)
    return (p, *out[1:])


def half_the_batch(self, x, state=None, **kw):
    return _half(lambda h: APPLY(self, h, return_features=True), x)


def half_the_batch_q(prog, xq, **kw):
    return _half(lambda h: INFER_Q(prog, h, **kw), xq)


def clip_answer_altered(self, x, state=None, **kw):
    return _roll_last(APPLY(self, x, state, **kw))


def clip_answer_altered_q(prog, xq, **kw):
    return _roll_last(INFER_Q(prog, xq, **kw))


def clip_lsb_altered_q(prog, xq, **kw):
    """The last clip's decision moved by one LSB of the twin's grid."""
    p, phi, s = INFER_Q(prog, xq, **kw)
    p = p.clone()
    p[-1] += 1
    return p, phi, s


def oneshot_sums_off_by_one(bank, xq, **kw):
    """The one-shot cascade's sums in one band one LSB off."""
    s = BANK_Q(bank, xq, **kw).clone()
    s[:, BAND] += 1
    return s


@pytest.mark.parametrize("workload", STREAMS)
@pytest.mark.parametrize("fault", [state_unchanged, half_the_streams,
                                   step_answer_altered],
                         ids=lambda f: f.__name__)
def test_stream_fault_is_caught(monkeypatch, workload, fault):
    monkeypatch.setattr(InFilterPipeline, "_session_step", fault)
    with one_thread():
        _, line = run_tiny(workload)
    assert line["correct"] is False


@pytest.mark.parametrize("workload, owner, attr, fault", [
    (CLIPS[0], InFilterPipeline, "apply", half_the_batch),
    (CLIPS[0], InFilterPipeline, "apply", clip_answer_altered),
    (CLIPS[1], fixed, "infer_q", half_the_batch_q),
    (CLIPS[1], fixed, "infer_q", clip_answer_altered_q)],
    ids=["float-half_the_batch", "float-clip_answer_altered",
         "fixed-half_the_batch", "fixed-clip_answer_altered"])
def test_clip_fault_is_caught(monkeypatch, workload, owner, attr, fault):
    monkeypatch.setattr(owner, attr, fault)
    with one_thread():
        _, line = run_tiny(workload)
    assert line["correct"] is False


@pytest.mark.parametrize("workload, owner, attr, fault", [
    (STREAMS[1], InFilterPipeline, "_session_step", step_lsb_altered),
    (CLIPS[1], fixed, "infer_q", clip_lsb_altered_q)],
    ids=["stream", "clips"])
def test_twin_lsb_fault_is_caught(monkeypatch, workload, owner, attr,
                                  fault):
    monkeypatch.setattr(owner, attr, fault)
    with one_thread():
        _, line = run_tiny(workload)
    assert line["correct"] is False


@pytest.mark.parametrize("workload, owner, attr, fault", [
    (STREAMS[1], InFilterPipeline, "_session_step", step_sums_off_by_one),
    (CLIPS[1], fixed, "bank_accumulate_q", oneshot_sums_off_by_one)],
    ids=["stream", "clips"])
def test_twin_cascade_fault_is_caught(monkeypatch, workload, owner, attr,
                                      fault):
    """One band's sums one LSB off, where the cascade makes them: the
    decisions may not move, the compared sums do."""
    monkeypatch.setattr(owner, attr, fault)
    with one_thread():
        ctx, line = run_tiny(workload)
    assert line["correct"] is False
    assert line["checks"]["codes_differing"]["value"] > 0
