"""The port's distributed tier on two real ranks (gloo, CPU), against the
reference and the port without a mesh.

Each test spawns two processes of ``tests/torch_mesh_ranks.py`` (a
``file://`` rendezvous in ``tmp_path``, a hard timeout) and holds what
they saw against values computed here:

* serving on a ``(2, 1)`` mesh, capacity 4 (two slots per rank), float and
  fixed, with evictions of slots on both ranks, resumes and a poisoned
  rank: every rank's ``FeedResult``s bit for bit the unsharded port
  server's and, as ``tests/test_torch_serving_async.py`` holds the port,
  the reference's (float within 1e-5, fixed exactly); the sharded
  registers gathered whole bit for bit the unsharded server's;
* the smoke qwen3-8b train step (f32 compute, float and MP mode) on
  ``(2, 1)`` and ``(1, 2)``: loss and every updated param within 1e-5
  relative of the one-process step on the global batch; ``accum=2`` too;
  (one step: the MP product is piecewise in its operands, so a second
  step on params that differ in the last bits may take another branch);
  the control that keeps each rank's gradient unreduced misses; elastic:
  two steps on ``(2, 1)``, saved, restored on ``(1, 2)``, two more, equal
  to four uninterrupted steps;
* the smoke deepseek-moe-16b step (f32, groups of 8 tokens, so each
  rank's rows are whole groups of the global batch) on ``(2, 1)``: within
  1e-5 of the one-process step, the expert weights sharded by the rule
  table;
* ``compressed_psum`` over the two ranks bit for bit the reference's under
  ``jax.vmap(..., axis_name="i")`` over the same two rows, op by op (under
  ``jax.jit`` XLA fuses the products into the sums and the last bit
  differs).

The train step computes in f32 here: under bf16 each rank's partial
gradient of a gathered bf16 weight is rounded before the sum, which the
one-process step rounds once.
"""

import jax
import jax.numpy as jnp
import numpy as np

import test_torch_serving_async as serving
import torch_mesh_ranks as ranks
from repro.distributed.compression import compressed_psum as ref_psum

REL = 1e-5


def close_rel(got, want) -> float:
    """max |got - want| over max |want| (0 for two zero arrays)."""
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))) / scale


def schedule(rng):
    def chunk():
        return rng.standard_normal(int(rng.choice(serving.LENS))).astype(
            np.float32)

    def feed(*ids):
        return ("feed", [(i, chunk()) for i in ids])

    ops = [("open", s) for s in "abcd"]
    ops += [feed("a", "b", "c", "d") for _ in range(3)]
    # each feed alone, so the least recently fed is unambiguous
    ops += [feed("a"), feed("b"), feed("d"), ("open", "e")]   # evicts c
    ops += [feed("d"), feed("e"), feed("b"), feed("a"),
            ("open", "c")]                                      # evicts d
    ops += [feed("c", "a", "e", "b"), ("close", "a", False),
            ("close", "b", True), ("open", "d"), ("open", "b")]
    ops += [feed("d", "b", "c", "e"), feed("b", "d")]
    return ops


def test_two_rank_server_matches_unsharded_and_reference(tmp_path):
    sched = schedule(np.random.default_rng(7))
    kw = dict(capacity=4, max_chunk=64, min_chunk=16)
    pipes = {}
    for numerics in ("float", "fixed"):
        ref, _ = serving.reference(numerics)
        pipes[numerics] = (ref.config._asdict(),
                           [np.asarray(t) for t in ref.bp_taps],
                           [np.asarray(t) for t in ref.lp_taps],
                           np.asarray(ref.mu), np.asarray(ref.sigma),
                           [np.asarray(a) for a in ref.clf])
    run = ranks.spawn("serve", 2, tmp_path, dict(pipes=pipes,
                                                 schedule=sched,
                                                 server_kw=kw))
    mine = {}
    for numerics in ("float", "fixed"):
        plain = serving.port_server(numerics, clock=ranks.counter_clock(),
                                    checkpoint_dir=str(tmp_path / numerics),
                                    **kw)
        want = ranks.serve_script(plain, sched)
        refsrv = serving.ref_server(numerics, clock=ranks.counter_clock(),
                                    checkpoint_dir=str(tmp_path /
                                                       f"ref_{numerics}"),
                                    **kw)
        mine[numerics] = (plain, want, ranks.serve_script(refsrv, sched))
    got = run.results()
    for numerics, (plain, want, ref) in mine.items():
        assert [r[:2] + r[3:] for r in ref] == \
            [w[:2] + w[3:] for w in want]
        for r, w in zip(ref, want):
            if numerics == "fixed":
                assert r[2] == w[2]
            else:
                assert abs(r[2] - w[2]) <= serving.TOL
        for rank, g in enumerate(got):
            g = g[numerics]
            assert g["results"] == want, (numerics, rank)
            assert g["slots"] == [2 * rank, 2 * rank + 2]
            assert g["counts"]["eager_runs"] == plain.steps_run
            for a, b in zip(g["state"], plain.state.tensors()):
                assert np.array_equal(a, b.numpy()), (numerics, rank)
            assert g["poisoned"] and "poisoned" in g["poisoned"]
        assert "injected" not in got[0][numerics]["poisoned"]
        assert "another rank" in got[0][numerics]["poisoned"]


def assert_same_run(got, want, what):
    """Losses and first moments (the clipped gradient) within ``REL`` of
    the largest entry, leaf by leaf; params within ``REL`` in each leaf's
    L2 norm: an entry whose gradient is within Adam's eps of zero moves by
    lr x g / (|g| + eps), so the last bits of g, which the order of the
    sum over rows sets, move it by up to ~1e-5 of the leaf's largest."""
    assert got["kind"] == "DTensor", what
    assert close_rel(got["losses"], want["losses"]) <= REL, what
    assert got["params"].keys() == want["params"].keys(), what
    for k in want["params"]:
        assert close_rel(got["mu"][k], want["mu"][k]) <= REL, (what, k)
        assert l2_rel(got["params"][k], want["params"][k]) <= REL, (what, k)


def l2_rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_two_rank_train_steps_match_one_process(tmp_path):
    run = ranks.spawn("train", 2, tmp_path)
    cfg = ranks.train_cfg(False)
    batches = ranks.train_batches(cfg, 4)
    want = {mp_mode: ranks.summary(*ranks.run_steps(
        ranks.train_cfg(mp_mode), None, batches[:1]))
        for mp_mode in (False, True)}
    want_accum = ranks.summary(*ranks.run_steps(cfg, None, batches[:1],
                                                accum=2))
    want_four = ranks.summary(*ranks.run_steps(cfg, None, batches))
    got = run.results()
    assert got[0].keys() == got[1].keys()
    for key in got[0]:
        assert got[0][key]["losses"] == got[1][key]["losses"], key
    for mp_mode in (False, True):
        for name in ("2x1", "1x2"):
            assert_same_run(got[0][(mp_mode, name)], want[mp_mode],
                            (mp_mode, name))
    assert_same_run(got[0]["accum"], want_accum, "accum")
    miss = max(close_rel(got[0]["unreduced"]["mu"][k], want[False]["mu"][k])
               for k in want[False]["mu"])
    assert miss > 0.1, miss
    e = got[0]["elastic"]
    assert e["step"] == 2 and e["placements"] == ["S(0)", "S(1)"]
    want = want_four
    assert close_rel(e["losses"], want["losses"]) <= REL
    for k in want["params"]:
        assert l2_rel(e["params"][k], want["params"][k]) <= REL, k


def test_two_rank_moe_train_step_matches_one_process(tmp_path):
    """The smoke deepseek step (its dense layer, shared and routed experts,
    the capacity path) on a (2, 1) mesh: losses, first moments and params
    within ``REL`` of the one-process step on the global batch, and the
    expert weights stored as the rule table shards them, (E, d_in, d_out)
    as (None, 'data', 'model') for wi_gate and wi_up, (None, 'model',
    'data') for wo (the 'model' axis has one rank), the router ('data',
    None)."""
    run = ranks.spawn("train_moe", 2, tmp_path)
    cfg = ranks.moe_cfg()
    with ranks.f32_router():
        want = ranks.summary(*ranks.run_steps(cfg, None,
                                              ranks.train_batches(cfg, 1)))
    got = run.results()
    assert got[0]["losses"] == got[1]["losses"]
    assert_same_run(got[0], want, "moe")
    assert got[0]["placements"] == {
        "wi_gate": ["S(1)", "S(2)"], "wi_up": ["S(1)", "S(2)"],
        "wo": ["S(2)", "S(1)"], "router": ["S(0)", "R"]}


def test_two_rank_compressed_psum_matches_reference_bit_for_bit(tmp_path):
    rng = np.random.default_rng(5)
    xs = [(rng.standard_normal((2, 257)) * 1e-3).astype(np.float32)
          for _ in range(3)]
    xs[1][1, :] = 0.0                      # a rank with amax 0: scale 1
    err = (rng.standard_normal((2, 257)) * 1e-6).astype(np.float32)
    f = jax.vmap(lambda g, e: ref_psum(g, e, "i"), axis_name="i")
    want, e = [], jnp.asarray(err)
    for x in xs:
        out, e = f(jnp.asarray(x), e)
        want.append((np.asarray(out), np.asarray(e)))
    got = ranks.spawn("psum", 2, tmp_path, dict(xs=xs, err=err)).results()
    for rank, outs in enumerate(got):
        for (out, new_err), (w_out, w_err) in zip(outs, want):
            assert out.dtype == np.float32
            assert np.array_equal(out.view(np.int32),
                                  w_out[rank].view(np.int32))
            assert np.array_equal(new_err.view(np.int32),
                                  w_err[rank].view(np.int32))
