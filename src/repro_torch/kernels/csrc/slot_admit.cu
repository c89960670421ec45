// A wave's slot admissions in one launch: zero the registers of the slots
// that a fresh session opened on and write the admission mask of every
// slot that `StreamServer.open` / `close` touched since the last wave.
//
// Replaces no TPU kernel: the reference's server writes a slot's
// registers with one jnp `.at[].set` per register at each `open` and
// `close`. The port did the same in eager torch ops (15 `index_put`s, two
// mask writes and three pageable index copies per close + open pair);
// this kernel takes a wave's admissions, staged beside its chunk, in one
// launch before the step's replay. Plain PyTorch version:
// repro_torch/kernels/ref.py, slot_admit.
//
// What it computes, per slot s with code c = codes[s] (uint8):
//   c & 2 (reset):  every word of slot s's row in every register is 0;
//   c != 0:         active[s] = !(c & 1) (1: close, 2: open, 3: an open
//                   and a close since the last wave);
//   c == 0:         the slot is left as it is.
// Every register is a row-major (S, words) array of 4-byte words (float32
// or int32: float 0.0 is the zero word), so one kernel serves both
// numerics.
//
// What bounds it on an H100: nothing but the launch. A wave zeroes ~13
// slots' rows of ~130 words (~7 KB), so one CTA per slot walks its rows
// with its threads and CTAs of slots with code 0 leave at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRegs = 32;       // registers per state (2 x octaves + 3)
constexpr int kThreads = 128;

// The registers, passed by value: base pointers and words per slot row.
struct Regs {
  uint32_t* ptr[kMaxRegs];
  int words[kMaxRegs];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    slot_admit_kernel(const uint8_t* __restrict__ codes, Regs regs,
                      bool* __restrict__ active) {
  const int s = blockIdx.x;
  const int c = codes[s];
  if (c == 0) return;
  if (c & 2) {
    for (int r = 0; r < regs.n; ++r) {
      const int w = regs.words[r];
      uint32_t* row = regs.ptr[r] + (long)s * w;
      for (int k = threadIdx.x; k < w; k += kThreads) row[k] = 0u;
    }
  }
  if (threadIdx.x == 0) active[s] = !(c & 1);
}

}  // namespace

// codes (S,) uint8 on the card; regs: `num_regs` host rows of two int64
// (a register's device address, its words per slot); active (S,) bool.
// Returns 0, a cudaError_t code, or -1 for arguments it does not take.
extern "C" int slot_admit_launch(const void* codes, const int64_t* regs,
                                 int num_regs, void* active, int S,
                                 void* stream) {
  if (S < 1 || num_regs < 0 || num_regs > kMaxRegs || !codes || !active)
    return -1;
  Regs r = {};
  r.n = num_regs;
  for (int i = 0; i < num_regs; ++i) {
    r.ptr[i] = reinterpret_cast<uint32_t*>(regs[2 * i]);
    r.words[i] = static_cast<int>(regs[2 * i + 1]);
    if (!r.ptr[i] || r.words[i] < 1) return -1;
  }
  slot_admit_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), r, static_cast<bool*>(active));
  return static_cast<int>(cudaGetLastError());
}
