// Stand-alone non-normalized Knuth-Yao sampler kernel for Hopper (sm_90a):
// a group of threads walks each row of a (B, n) int32 weight tile.
//
// Replaces: src/repro/kernels/ky_sampler.py::_ky_kernel, the TPU Pallas
// kernel launched by ky_sampler_pallas (pallas_call at ky_sampler.py:111)
// and wrapped by kernels/ops.py::ky_sample_kernel.
//
// What it computes, per row: the deterministic-row bypass (max(w) ==
// total -> first argmax, 0 bits); else the DDG walk with the GLOBAL bit
// cursor: at iteration it the row reads bit (it % 32) of its word it / 32.
// Level c reads the bit-plane column (w >> (klvl - 1 - c)) & 1 of the row
// plus the rejection pad's bit of rej; the first outcome whose running
// column sum exceeds d2 = 2d + (1 - bit) is the leaf.  A leaf on the pad,
// or running out of levels, restarts the walk (d = c = 0).  bits counts the
// iterations the row was active; at the budget the row falls back to the
// first argmax with ok = false.  Integer only: bitwise equal to the plain
// version (kernels/ref.py::ky_walk_global) on every input.
//
// Bound on an H100: bytes.  The function reads each row's n weights, its
// klvl and rej, and the bit words its cursor reaches (ceil(bits / 32)),
// and writes sample and bits (int32) and ok (1 byte): b * (4n + 8 + 9) +
// 4 * words bytes, at 3.35 TB/s; about 5 us at b = 65536, n = 64.  The
// walk's integer work is a few operations per outcome per level walked.
//
// The design spreads each row over the threads of a warp:
// - A group of G = min(next_pow2(n), 32) threads walks one row; label l
//   sits on thread l % G, in round l / G.  The group's threads read the
//   row's consecutive weights, and consecutive groups consecutive rows,
//   so the weights are read coalesced, once, into registers: every round
//   up to 8 (RR, a template argument with G), and a row of more than 8
//   rounds reads its later rounds again from global memory, through L1,
//   in the same loops.  klvl, rej and the first bit word are read with
//   the weights, and all of them for the group's next row while it walks
//   this one.
// - Bypass: total, max and first argmax by shuffles within the group, in
//   the same integer arithmetic, ties to the lowest label.
// - Each level: the column sum is the sum over rounds of
//   __popc(__ballot_sync(group, bit)), every round at every level, with no
//   branch between rounds.  At a hit on a real outcome the walk stops, and
//   the leaf is the first round whose running count passes d2 + 1 and in
//   it the thread whose masked __popc prefix is the count still needed.
//   The walk state (d, c, the cursor) is the same on every thread of the
//   group, so the group branches together.
// - The word at the cursor is one address for the whole group, read once
//   every 32 iterations: the walk runs word by word, then bit by bit, so
//   no step tests whether it needs a new word.
// - The grid holds as many blocks as fit on the card at once; each group
//   then takes rows gridDim * rows apart, so a row that walks long holds
//   up only its own group, not a block's worth of finished ones.  block_b
//   rows make a block, capped at 256 threads (256 / G rows).
// What limits it: each iteration of a group's walk is some 30 warp
// instructions for one row (the ballots, and the walk's scalar state held
// by every thread of the group), and at small n the longest walk of the
// batch (PERF.md).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

// What a group reads of one row before walking it: its weights (the
// rounds held in registers), klvl, rej and the first bit word.  Issued
// together, and for the group's next row while it walks this one.
template <int RR>
struct RowIn {
  int x[RR];
  int K, R;
  uint32_t w0;
};

template <int G, int RR>
__device__ __forceinline__ void load_row(RowIn<RR>& in, int row, int b,
                                         const int* __restrict__ w,
                                         const uint32_t* __restrict__ words,
                                         const int* __restrict__ klvl,
                                         const int* __restrict__ rej, int n,
                                         int W, int budget, int l) {
  if (row >= b) return;
  const int* rowp = w + (size_t)row * n;
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    const int lab = r * G + l;
    in.x[r] = lab < n ? __ldg(rowp + lab) : 0;
  }
  in.K = __ldg(klvl + row);
  in.R = __ldg(rej + row);
  in.w0 = budget > 0 ? __ldg(words + (size_t)row * W) : 0u;
}

template <int G, int RR>
__global__ void __launch_bounds__(256) ky_sampler_group_kernel(
    const int* __restrict__ w, const uint32_t* __restrict__ words,
    const int* __restrict__ klvl, const int* __restrict__ rej,
    int* __restrict__ sample_out, int* __restrict__ bits_out,
    bool* __restrict__ ok_out, int b, int n, int W, int budget, int rounds,
    int rows_per_block) {
  // RR: the rounds held in registers, all of them unless RR == 8 and the
  // row is wider (rounds > 8: the rest are read from global memory)
  const int gid = (int)threadIdx.x / G;  // the group's row in the block
  const int wl = threadIdx.x & 31;       // position in the warp
  const int l = wl & (G - 1);            // this thread's label in round 0
  constexpr unsigned GBITS = G == 32 ? 0xffffffffu : (1u << G) - 1;
  const unsigned gmask = G == 32 ? GBITS : GBITS << (wl & ~(G - 1));
  const unsigned le = (2u << wl) - 1;    // lanes up to this one
  // the lanes of this warp that exist (a block may end inside a warp)
  const int in_warp = min(32, (int)blockDim.x - (int)(threadIdx.x & ~31u));
  const unsigned wmask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1;
  const int stride = gridDim.x * rows_per_block;
  const bool wide = RR == 8 && rounds > 8;

  RowIn<RR> cur, nxt;
  int row = blockIdx.x * rows_per_block + gid;
  load_row<G, RR>(cur, row, b, w, words, klvl, rej, n, W, budget, l);
  // every thread of a block runs the same number of row slots
  for (int base = blockIdx.x * rows_per_block; base < b; base += stride) {
    load_row<G, RR>(nxt, row + stride, b, w, words, klvl, rej, n, W, budget,
                    l);
    if (row < b) {
      const int* rowp = w + (size_t)row * n;
      // ---- bypass statistics: total, max, first argmax ----------------
      long long total = 0;
      int wmax = INT_MIN, amax = INT_MAX;  // no real label: never wins
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const int lab = r * G + l;
        if (lab < n) {
          total += cur.x[r];
          if (cur.x[r] > wmax || amax == INT_MAX) {
            wmax = cur.x[r];
            amax = lab;
          }
        }
      }
      if (wide) {
        for (int r = RR; r < rounds; ++r) {
          const int lab = r * G + l;
          if (lab < n) {
            const int xv = __ldg(rowp + lab);
            total += xv;
            if (xv > wmax || amax == INT_MAX) {
              wmax = xv;
              amax = lab;
            }
          }
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        total += __shfl_xor_sync(gmask, total, off, G);
        const int ow = __shfl_xor_sync(gmask, wmax, off, G);
        const int ol = __shfl_xor_sync(gmask, amax, off, G);
        if (ol != INT_MAX &&
            (amax == INT_MAX || ow > wmax || (ow == wmax && ol < amax))) {
          wmax = ow;
          amax = ol;
        }
      }

      // ---- Knuth-Yao DDG walk with the global bit cursor ---------------
      const int K = cur.K, R = cur.R;
      int res = amax, bits = 0;
      bool done = ((long long)wmax == total);  // deterministic-row bypass
      if (!done && K <= 0) {
        bits = budget;  // no level: every bit restarts the walk
      } else if (!done) {
        const uint32_t* lw = words + (size_t)row * W;
        uint32_t word = cur.w0;
        int d = 0, c = 0, sh = 0, d2 = 0;
        bool hit = false;
        // word by word, then bit by bit: the cursor's word is read once
        for (int wi = 0; wi * 32 < budget && !hit; ++wi) {
          if (wi) word = __ldg(lw + wi);
          const int lim = min(32, budget - wi * 32);
          for (int t = 0; t < lim; ++t) {
            d2 = 2 * d + 1 - (int)(word & 1u);
            word >>= 1;
            // bit K - 1 - c (>= 0) of the int64 weight: an int32's bits
            // from 31 up all equal its sign bit
            sh = min(K - 1 - c, 31);
            // the column sum: every round's ballot, counted
            int cum = 0;
#pragma unroll
            for (int r = 0; r < RR; ++r)
              cum +=
                  __popc(__ballot_sync(gmask, (cur.x[r] >> sh) & 1) & gmask);
            if (wide)
              for (int r = RR; r < rounds; ++r) {
                const int lab = r * G + l;
                const bool mine = lab < n && ((__ldg(rowp + lab) >> sh) & 1);
                cum += __popc(__ballot_sync(gmask, mine) & gmask);
              }
            ++bits;
            if (cum > d2) {  // leaf on a real outcome
              hit = true;
              break;
            }
            const int colsum = cum + ((R >> sh) & 1);
            const bool restart = d2 < colsum || c + 1 >= K;  // pad, no level
            d = restart ? 0 : d2 - colsum;
            c = restart ? 0 : c + 1;
          }
        }
        if (hit) {
          // the leaf: the first round whose running count passes d2 + 1,
          // and in it the thread whose masked popc prefix is what is left
          int cum = 0, leaf = -1;
          auto leaf_round = [&](int xv, int r) {
            const bool mine = (xv >> sh) & 1;
            const unsigned col = __ballot_sync(gmask, mine) & gmask;
            const int cnt = __popc(col);
            if (cum + cnt > d2) {
              const bool at = mine && __popc(col & le) == d2 - cum + 1;
              leaf = r * G +
                     ((__ffs(__ballot_sync(gmask, at) & gmask) - 1) & (G - 1));
            }
            cum += cnt;
          };
#pragma unroll
          for (int r = 0; r < RR; ++r)
            if (leaf < 0) leaf_round(cur.x[r], r);
          if (wide)
            for (int r = RR; r < rounds && leaf < 0; ++r) {
              const int lab = r * G + l;
              leaf_round(lab < n ? __ldg(rowp + lab) : 0, r);
            }
          res = leaf;
          done = true;
        }
      }
      if (l == 0) {
        sample_out[row] = done ? res : amax;
        bits_out[row] = bits;
        ok_out[row] = done;
      }
    }
    __syncwarp(wmask);  // the warp's groups start their next rows together
    row += stride;
    cur = nxt;
  }
}

template <int G, int RR>
int launch(const void* w, const void* words, const void* klvl,
           const void* rej, void* sample, void* bits, void* ok, int b, int n,
           int W, int budget, int rounds, int rows, cudaStream_t stream) {
  auto kernel = ky_sampler_group_kernel<G, RR>;
  const int threads = rows * G;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit on the card at once (at least one); each group
  // then takes rows gridDim * rows apart
  const long long need = (b + rows - 1) / rows;
  const int grid = (int)min(need, (long long)sms * max(per_sm, 1));
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const int*>(w), static_cast<const uint32_t*>(words),
      static_cast<const int*>(klvl), static_cast<const int*>(rej),
      static_cast<int*>(sample), static_cast<int*>(bits),
      static_cast<bool*>(ok), b, n, W, budget, rounds, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// group: threads a row, min(next_pow2(n), 32); rows: rows a block, with
// rows * group <= 1024 (kernels/ky_sampler.py::group_geometry).
extern "C" int ky_sampler_launch(const void* w, const void* words,
                                 const void* klvl, const void* rej,
                                 void* sample, void* bits, void* ok, int b,
                                 int n, int W, int budget, int group,
                                 int rows, void* stream) {
  if (b <= 0) return 0;
  int want = 1;
  while (want < n && want < 32) want <<= 1;
  if (n < 1 || budget < 0 || budget > W * 32 || group != want || rows < 1 ||
      rows * group > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int rounds = (n + group - 1) / group;
  auto s = static_cast<cudaStream_t>(stream);
#define KY_LAUNCH(G, RR)                                                     \
  launch<G, RR>(w, words, klvl, rej, sample, bits, ok, b, n, W, budget,      \
                rounds, rows, s)
  switch (group) {
    case 1: return KY_LAUNCH(1, 1);
    case 2: return KY_LAUNCH(2, 1);
    case 4: return KY_LAUNCH(4, 1);
    case 8: return KY_LAUNCH(8, 1);
    case 16: return KY_LAUNCH(16, 1);
    default:
      switch (rounds) {  // every round in registers, up to 8
        case 1: return KY_LAUNCH(32, 1);
        case 2: return KY_LAUNCH(32, 2);
        case 3: return KY_LAUNCH(32, 3);
        case 4: return KY_LAUNCH(32, 4);
        case 5: return KY_LAUNCH(32, 5);
        case 6: return KY_LAUNCH(32, 6);
        case 7: return KY_LAUNCH(32, 7);
        default: return KY_LAUNCH(32, 8);
      }
  }
#undef KY_LAUNCH
}
