// Stand-alone non-normalized Knuth-Yao sampler kernel for Hopper (sm_90a):
// one lane (row of a (B, n) int32 weight tile) per thread.
//
// Replaces: src/repro/kernels/ky_sampler.py::_ky_kernel, the TPU Pallas
// kernel launched by ky_sampler_pallas (pallas_call at ky_sampler.py:111)
// and wrapped by kernels/ops.py::ky_sample_kernel.
//
// What it computes, per lane: the deterministic-row bypass (max(w) ==
// total -> first argmax, 0 bits); else the DDG walk with the GLOBAL bit
// cursor: at iteration it the lane reads bit (it % 32) of its word it / 32.
// Level c reads the bit-plane column (w >> (klvl - 1 - c)) & 1 of the row
// plus the rejection pad's bit of rej; the first outcome whose running
// column sum exceeds d2 = 2d + (1 - bit) is the leaf.  A leaf on the pad,
// or running out of levels, restarts the walk (d = c = 0).  bits counts the
// iterations the lane was active; at the budget the lane falls back to the
// first argmax with ok = false.  Integer only: bitwise equal to the plain
// version (kernels/ref.py::ky_ref) on every input.
//
// Bound on an H100: bytes.  The function reads each lane's n weights, its
// klvl and rej, and the bit words its cursor reaches (ceil(bits / 32)),
// and writes sample and bits (int32) and ok (1 byte): b * (4n + 8 + 9) +
// 4 * words bytes, at 3.35 TB/s; about 5 us at b = 65536, n = 64.  The
// walk's integer work (~4 ops per outcome per level walked) is a few
// hundred million ops, well under the card's rates.
//
// The simple design leaves on the table: rows are read straight from
// global memory at every level (uncoalesced, one row per thread, served
// by L1), and each level loops over all n outcomes on one thread.  Later
// work: a warp per lane with __ballot_sync/__popc column sums over
// bit-planes, and generating the threefry words in the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ky_sampler_kernel(
    const int* __restrict__ w, const uint32_t* __restrict__ words,
    const int* __restrict__ klvl, const int* __restrict__ rej,
    int* __restrict__ sample_out, int* __restrict__ bits_out,
    bool* __restrict__ ok_out, int b, int n, int W, int budget) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const int* row = w + (size_t)lane * n;

  // deterministic-row bypass: p = 1.0 has no fractional DDG expansion
  long long total = 0;
  int wmax = row[0], amax = 0;
  for (int l = 0; l < n; ++l) {
    const int x = __ldg(row + l);
    total += x;
    if (x > wmax) {
      wmax = x;
      amax = l;
    }
  }
  bool done = ((long long)wmax == total);
  int res = amax, bits = 0;
  if (!done) {
    const int K = klvl[lane];
    const int R = rej[lane];
    const uint32_t* lw = words + (size_t)lane * W;
    int d = 0, c = 0;
    for (int it = 0; it < budget; ++it) {
      const int bit = (int)((__ldg(lw + (it >> 5)) >> (it & 31)) & 1u);
      const int d2 = 2 * d + (1 - bit);
      const int shift = K - 1 - c;
      int cum = 0, sel = -1;
      if (shift >= 0) {
        for (int l = 0; l < n; ++l) {
          cum += (__ldg(row + l) >> shift) & 1;
          if (sel < 0 && cum >= d2 + 1) sel = l;
        }
      }
      const int colsum = cum + ((shift >= 0) ? ((R >> shift) & 1) : 0);
      const bool hit = d2 < colsum;
      ++bits;
      if (hit && sel >= 0) {  // leaf on a real outcome
        res = sel;
        done = true;
        break;
      }
      if (hit || c + 1 >= K) {  // rejection pad, or out of levels: restart
        d = 0;
        c = 0;
      } else {
        d = d2 - colsum;
        ++c;
      }
    }
  }
  sample_out[lane] = done ? res : amax;
  bits_out[lane] = bits;
  ok_out[lane] = done;
}

}  // namespace

extern "C" int ky_sampler_launch(const void* w, const void* words,
                                 const void* klvl, const void* rej,
                                 void* sample, void* bits, void* ok, int b,
                                 int n, int W, int budget, int block,
                                 void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || budget < 0 || budget > W * 32 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const int grid = (b + block - 1) / block;
  ky_sampler_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(w), static_cast<const uint32_t*>(words),
      static_cast<const int*>(klvl), static_cast<const int*>(rej),
      static_cast<int*>(sample), static_cast<int*>(bits),
      static_cast<bool*>(ok), b, n, W, budget);
  return (int)cudaGetLastError();
}
