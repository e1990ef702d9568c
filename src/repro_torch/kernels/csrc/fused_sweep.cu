// Fused Gibbs sweep kernel for Hopper (sm_90a): label mask -> max-subtract
// -> IU-exp LUT -> k-bit floor -> non-normalized Knuth-Yao DDG walk, on the
// (b, L) log-weight tile of one colour, with the random bit words made
// inside the kernel.
//
// Replaces: src/repro/kernels/fused_sweep.py::_fused_kernel, the TPU Pallas
// kernel launched by fused_gibbs_sample (pallas_call at fused_sweep.py:165).
//
// Random bits.  Word j of lane i is JAX's threefry2x32 (20 rounds) of the
// 64-bit counter i * W + j under the colour's key, x0 ^ x1 -- word (i, j) of
// jax.random.bits(key, (b, W)) in the partitionable layout, at the true
// lane count b, which is what the plain version reads
// (core/rng.py::random_bit_words; core/rng.py::lane_word is its scalar
// twin).  A lane computes word j only when its cursor first reaches it, so
// no word is written to or read from memory.
//
// Bound on an H100: bytes.  Per lane the function reads the L float32
// log-weights and the int32 card and writes sample, bits and attempts
// (int32) and ok (1 byte); the 4.1 kB LUT is read once: b * (4L + 4 + 13)
// + 4100 bytes per launch, at 3.35 TB/s.  The arithmetic (a few dozen
// flops a label, ~10 DDG levels of L-wide integer work and one 20-round
// threefry per 32 bits walked) is far under the card's rates.  At serving
// sizes (b of a few thousand lanes) that is well under a MB and under
// 0.1 us, so a launch is bound by launch latency and the serial walk.
//
// Design: a group of G = next_pow2(L) threads per lane (2 <= G <= 32,
// 32 / G lanes a warp).  Thread l holds label l; the row max, the integer
// total and the argmax (ties to the lowest label) are shuffles within the
// group, exact and so independent of order; at each DDG level the column
// sum is __popc(__ballot_sync(group, bit)) and the leaf the label whose
// prefix popc under lanemask_le equals d + 1; d, c, the cursor and the
// current word are replicated in the group.  (One thread per lane, the row
// in registers, measured slower at the serve path's shapes: PERF.md.)
// Later work: a CUDA graph over a round, and the gather fused in.
//
// Bit identity with the reference: every float stage is one separately
// rounded float32 op (__fsub_rn/__fmul_rn/__fadd_rn, built with
// --fmad=false besides), and the walk is the reference's per-lane-cursor
// walk.  Each lane walks on its own until done or until its cursor reaches
// budget - 1; that is exactly the lock-step loop's per-lane behaviour,
// since every active lane there has t == iteration.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// JAX's threefry2x32 (core/rng.py::_threefry2x32) of the 64-bit counter
// idx, split (idx >> 32, idx & 0xffffffff); the word is x0 ^ x1
__device__ __forceinline__ uint32_t lane_word(uint32_t k0, uint32_t k1,
                                              unsigned long long idx) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = (uint32_t)(idx >> 32) + ks[0];
  uint32_t x1 = (uint32_t)idx + ks[1];
  constexpr int R[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, R[i % 2][r]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

struct Params {
  const float* logw;
  const int* card;
  const float* table;
  int* sample;
  int* bits;
  int* att;
  bool* ok;
  uint32_t k0, k1;  // the colour's key
  int b, L, W;      // lanes, labels, words of budget per lane
  float wscale;     // 2^k - 1
  int use_iu, n_seg;
  float lo, scale, mask_value;
};

// one label's k-bit weight from its masked log-weight and the row max
__device__ __forceinline__ int label_weight(const Params& p, float lw,
                                            float mx) {
  const float z = __fsub_rn(lw, mx);
  float y;
  if (p.use_iu) {
    float t = __fmul_rn(__fsub_rn(z, p.lo), p.scale);
    t = fminf(fmaxf(t, 0.0f), (float)p.n_seg);
    int idx = (int)t;
    if (idx > p.n_seg - 1) idx = p.n_seg - 1;
    const float frac = __fsub_rn(t, (float)idx);
    const float y0 = p.table[idx];
    const float y1 = p.table[idx + 1];
    y = __fadd_rn(y0, __fmul_rn(frac, __fsub_rn(y1, y0)));
  } else {
    y = expf(z);
  }
  return (int)floorf(__fmul_rn(y, p.wscale));
}

// K = max(ceil_log2(total), 1): the bit length of total - 1
__device__ __forceinline__ int levels(int total) {
  const int K = 32 - __clz(total - 1);
  return K < 1 ? 1 : K;
}

template <int G>
__global__ void fused_gibbs_group_kernel(const Params p) {
  const int lane = (int)((blockIdx.x * blockDim.x + threadIdx.x) / G);
  if (lane >= p.b) return;  // the whole group leaves together
  const int wl = threadIdx.x & 31;          // position in the warp
  const int l = wl & (G - 1);               // this thread's label
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (wl & ~(G - 1));
  const bool real = l < p.L;

  // ---- distribution generation: mask -> max-subtract -> exp -> floor ----
  float lw = __int_as_float((int)0xff800000);  // -inf
  if (real)
    lw = l < p.card[lane] ? p.logw[(size_t)lane * p.L + l] : p.mask_value;
  float mx = lw;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, off, G));
  int w = real ? label_weight(p, lw, mx) : 0;
  int total = w;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    total += __shfl_xor_sync(gmask, total, off, G);
  if (total == 0) {  // all-zero row: force outcome 0
    if (l == 0) w = 1;
    total = 1;
  }
  int wmax = w, amax = l;  // ties to the lowest label
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const int ow = __shfl_xor_sync(gmask, wmax, off, G);
    const int ol = __shfl_xor_sync(gmask, amax, off, G);
    if (ow > wmax || (ow == wmax && ol < amax)) {
      wmax = ow;
      amax = ol;
    }
  }

  // ---- Knuth-Yao DDG walk with the per-lane bit cursor -----------------
  const int budget = p.W * 32;
  int res = amax, t = 0, att = 1;
  bool done = (wmax == total);  // deterministic-row bypass
  if (!done) {
    const int K = levels(total);
    const long long rej = (1LL << K) - total;
    const unsigned long long base = (unsigned long long)lane * p.W;
    const unsigned le = (2u << wl) - 1;  // lanemask_le (all ones at 31)
    long long d = 0;
    int c = 0, wj = -1;
    uint32_t word = 0;
    while (t < budget - 1) {
      if ((t >> 5) != wj) {  // the cursor reached a new word
        wj = t >> 5;
        word = lane_word(p.k0, p.k1, base + wj);
      }
      const int bit = (word >> (t & 31)) & 1;
      const long long d2 = 2 * d + (1 - bit);
      const int shift = K - 1 - c;
      const bool mine = shift >= 0 && real && ((w >> shift) & 1);
      const unsigned col = __ballot_sync(gmask, mine) & gmask;
      const int cum = __popc(col);
      const long long colsum = cum + ((shift >= 0) ? ((rej >> shift) & 1) : 0);
      const bool hit = d2 < colsum;
      ++t;
      if (hit && d2 < cum) {  // leaf: the label whose prefix count is d2 + 1
        const bool leaf = mine && __popc(col & le) == d2 + 1;
        res = (__ffs(__ballot_sync(gmask, leaf) & gmask) - 1) & (G - 1);
        done = true;
        break;
      }
      if (hit || c + 1 >= K) {  // rejection pad (or level overflow)
        d = 0;
        c = 0;
        ++att;
      } else {
        d = d2 - colsum;
        ++c;
      }
    }
  }
  if (l == 0) {
    p.sample[lane] = res;
    p.bits[lane] = t;
    p.att[lane] = att;
    p.ok[lane] = done;
  }
}

template <int G>
void launch_group(const Params& p, int block, cudaStream_t stream) {
  const long long threads = (long long)p.b * G;
  const int grid = (int)((threads + block - 1) / block);
  fused_gibbs_group_kernel<G><<<grid, block, 0, stream>>>(p);
}

int next_pow2(int x) {
  int g = 1;
  while (g < x) g <<= 1;
  return g;
}

}  // namespace

// block: threads per block, a multiple of 32.  k0, k1: the colour's key
// words; W: words of bit budget per lane.
extern "C" int fused_gibbs_sample_launch(
    const void* logw, const void* card, uint32_t k0, uint32_t k1,
    const void* table, void* sample, void* bits, void* att, void* ok, int b,
    int L, int W, float wscale, int use_iu, int n_seg, float lo, float scale,
    float mask_value, int block, void* stream) {
  if (b <= 0) return 0;
  if (L < 1 || L > 32 || W < 1 || block < 32 || block > 1024 || block % 32)
    return (int)cudaErrorInvalidValue;
  const int g = L < 2 ? 2 : next_pow2(L);  // threads per lane
  const Params p{static_cast<const float*>(logw), static_cast<const int*>(card),
                 static_cast<const float*>(table), static_cast<int*>(sample),
                 static_cast<int*>(bits), static_cast<int*>(att),
                 static_cast<bool*>(ok), k0, k1, b, L, W, wscale, use_iu,
                 n_seg, lo, scale, mask_value};
  auto s = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 2: launch_group<2>(p, block, s); break;
    case 4: launch_group<4>(p, block, s); break;
    case 8: launch_group<8>(p, block, s); break;
    case 16: launch_group<16>(p, block, s); break;
    default: launch_group<32>(p, block, s); break;
  }
  return (int)cudaGetLastError();
}
