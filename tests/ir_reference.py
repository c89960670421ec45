"""The reference's census, explained: the work its jaxprs count that the
port's traced graphs do not hold.

Shared by the port's IR tests and ``chip_smoke.py``, the two places that
reconcile the port's census with the reference's (live, or committed under
``artifacts/ir/``). It imports torch and ``repro_torch`` only, never JAX.

For ``oneshot_q`` and ``session_step_q`` at the full ``esc10-mp`` config,
the committed census minus the port's census splits into:

* what is named here (:func:`reference_block_padding`,
  :func:`reference_index_overhead`), which the reference counts on
  input-dependent values;
* :data:`COMMITTED_INPUT_FREE`, the reference's input-free census (loop
  counters and constant index arithmetic, which the port folds), pinned by
  ``tests/test_torch_ir_full.py`` against the live reference, plus the
  drift between the committed census and the live reference's.
"""

from __future__ import annotations

from collections import Counter

import torch

# committed census - port census - named work, at the full config
COMMITTED_INPUT_FREE = {
    "oneshot_q": {"add": 843174, "compare": 1412100, "shift": 15560},
    "session_step_q": {"add": 11364, "compare": 10320, "shift": 155},
}


def census_diff(a: dict, b: dict) -> dict:
    """``a - b`` key by key, zeros kept (negative where ``b`` is larger)."""
    return {k: int(a.get(k, 0)) - int(b.get(k, 0))
            for k in sorted(set(a) | set(b))}


def reference_block_padding(prog, n: int, chunk_n: int = 1024) -> Counter:
    """Census of the positions the reference's one-shot bank solves past
    the signal's end: its ``fxp_fir_bank`` pads an octave longer than
    ``chunk_n`` to whole ``chunk_n`` blocks and solves them all, where the
    port's last block is short. Counted with the port's own
    ``fxp_fir_bank`` on that many positions (band-pass and low-pass)."""
    from repro_torch.analysis.legality import census
    from repro_torch.analysis.traverse import trace
    from repro_torch.core import fixed

    total: Counter = Counter()
    n_o = n
    for st in prog.bank.octaves:
        pad = -(-n_o // chunk_n) * chunk_n - n_o if n_o > chunk_n else 0
        stages = [(st.bp_q, st.gamma_bp, st.iters_bp, st.band_spec)]
        if st.lp_q is not None:
            stages.append((st.lp_q, st.gamma_lp, st.iters_lp, st.lp_spec))
        for H, gamma, iters, spec in stages if pad else ():
            x = torch.zeros((1, pad + H.shape[-1] - 1), dtype=torch.int32)
            total += census(trace(
                lambda q, H=H, g=gamma, i=iters, s=spec: fixed.fxp_fir_bank(
                    q, H, g, i, s, pad=False), x))
        n_o = (n_o + 1) // 2
    return total


def reference_index_overhead(prog, slots: int, chunk_len: int,
                             delay_len: int) -> Counter:
    """Census difference of the input-dependent index work between the
    reference's ``session_step_q`` jaxpr and the port's graph, per step of
    ``slots`` x ``chunk_len`` with delay lines of ``delay_len``: the
    reference compares the valid mask once per band (the port once per
    position) and normalizes the data-dependent low-pass window indices
    (``idx < 0``, ``idx + n``, select) and each slot's delay-line start;
    the port adds ``n + arange(delay_len)`` to index the delay line.
    Returns a Counter (negative where the port counts more)."""
    d: Counter = Counter()
    S, l = slots, chunk_len
    for st in prog.bank.octaves:
        d["compare"] += S * l * (int(st.bp_q.shape[0]) - 1) + 2 * S
        d["add"] += S - S * delay_len
        if st.lp_q is not None:
            w = S * ((l + 1) // 2) * int(st.lp_q.shape[-1])
            d["add"] += w
            d["compare"] += 2 * w
        l = (l + 1) // 2
    return d
