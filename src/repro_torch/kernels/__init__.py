"""Hand-written CUDA kernels for the MP FIR hot spots, and their wrappers.

Layers, as in the reference's ``repro.kernels``:
  csrc/*.cu  - the CUDA C++ sources for Hopper (sm_90a), plain C interface
  _build.py  - nvcc at first use into a gitignored directory, ctypes load
  fir_mp.py  - one wrapper per kernel: launch for CUDA tensors, the plain
               version for CPU tensors, launch counters (``LAUNCHES``)
  ops.py     - public wrappers: leading dims, the per-octave stream cascade
  ref.py     - the plain PyTorch versions

Kernels:
  fir_mp_stream_octave - one octave of the float session step (delay line,
                 per-band partials and running amax held per slot; LP + ÷2
                 at the slot's phase)
  fir_mp_bank  - one-shot MP FIR bank, optional fused HWR + accumulate
  fir_mp       - the bank kernel with one filter
  fir_mp_stream_octave_q / fir_mp_bank_q - the integer twins of the two:
                 the fixed-point datapath (integer MP bisection, shift/add/
                 compare only), bit for bit ``core.fixed``'s torch ops
"""

from repro_torch.kernels.fir_mp import LAUNCHES, reset_launches  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    fir_mp,
    fir_mp_accumulate,
    fir_mp_bank,
    fir_mp_bank_accumulate,
    fir_mp_bank_q,
    fir_mp_bank_q_accumulate,
    fir_mp_stream,
    fir_mp_stream_q,
)
