"""Hand-written CUDA kernels for the MP hot spots, and their wrappers.

Layers, as in the reference's ``repro.kernels``:
  csrc/*.cu     - the CUDA C++ sources for Hopper (sm_90a), plain C
                  interface
  _build.py     - nvcc at first use into a gitignored directory, ctypes load
  _wrap.py      - what every wrapper shares: the launch counters
                  (``LAUNCHES``) and the checks before a launch
  fir_mp.py     - one wrapper per FIR kernel: launch for CUDA tensors, the
                  plain version for CPU tensors
  mp_kernels.py - the same for the MP solve kernels
  admission.py  - the same for the serving tier's slot admissions
  ops.py        - public wrappers: leading dims, the session step's octave
                  cascade, ``mp_linear`` as an autograd Function
  ref.py        - the plain PyTorch versions

Kernels:
  fir_mp_stream_cascade - the float session step's whole octave cascade in
                 one launch (delay lines, per-band partials and running
                 amax per slot; LP + ÷2 at each octave's phase; the kept
                 signal carried from octave to octave on the card);
                 ``fir_mp_stream_octave`` runs it on one octave
  fir_mp_oneshot_cascade - the float one-shot bank's whole multirate
                 cascade in one launch (kept-only low-pass stages feeding
                 the next octave on the card, every octave's band-pass
                 items pooled, HWR sums in a fixed order, x 2^o)
  fir_mp_bank  - the same kernel on one stage: one-shot MP FIR bank,
                 optional fused HWR + accumulate
  fir_mp       - the one-stage bank with one filter
  fir_mp_stream_cascade_q, fir_mp_stream_octave_q /
  fir_mp_oneshot_cascade_q, fir_mp_bank_q - the integer twins of the
                 stream and one-shot kernels: the fixed-point datapath
                 (integer MP bisection, shift/add/compare only), bit for
                 bit ``core.fixed``'s torch ops
  mp_linear    - the fused multiplierless matrix product of eq. 9, every
                 MP-mode projection of the transformer (``models.layers``)
  mp_linear_bwd - its gradients (masks of the exact water levels) in one
                 pass for dx and dw, from the levels that mp_linear's
                 kernel writes in a training forward
  mp_waterfill - row-wise reverse water-filling z = MP(L, gamma)
  slot_admit   - a served wave's slot admissions (registers zeroed, the
                 admission mask written) in one launch before its step
"""

from repro_torch.kernels._wrap import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    fir_mp,
    fir_mp_accumulate,
    fir_mp_bank,
    fir_mp_bank_accumulate,
    fir_mp_bank_q,
    fir_mp_bank_q_accumulate,
    fir_mp_oneshot_cascade,
    fir_mp_oneshot_cascade_q,
    fir_mp_stream,
    fir_mp_stream_q,
    mp_linear,
    mp_waterfill,
)
