// Fused Gibbs sweep kernel for Hopper (sm_90a): label mask -> max-subtract
// -> IU-exp LUT -> k-bit floor -> non-normalized Knuth-Yao DDG walk, one
// lane (row of the (b, L) log-weight tile) per thread.
//
// Replaces: src/repro/kernels/fused_sweep.py::_fused_kernel, the TPU Pallas
// kernel launched by fused_gibbs_sample (pallas_call at fused_sweep.py:165).
//
// Bound on an H100: bytes.  Per lane the function needs the L float32
// log-weights and the int32 card, and the uint32 bit words its cursor
// reaches (ceil(bits_used / 32), about one word at k = 14), and writes
// sample, bits and attempts (int32) and ok (1 byte); the 4.1 kB LUT is
// read once: b * (4L + 4 + 13) + 4 * sum(ceil(bits_used / 32)) + 4100
// bytes per launch, at 3.35 TB/s.  The arithmetic (a few dozen flops and
// ~10 DDG levels of L-wide integer work per lane) is far under the card's
// rates.  At serving sizes (b of a few thousand lanes) that is well under
// a MB and under 0.1 us, so a launch is bound by launch latency and the
// serial walk, not by bandwidth.  The design does the simple right thing for that regime: one
// thread per lane, the row in registers (MAXL is a compile-time cap picked
// per launch), the weights never written to memory, the bit words read
// straight from global memory as the cursor advances.  Later work: generate
// the threefry words in-kernel (word j of lane i is counter i*31+j), a warp
// per lane for wide L, and CUDA graphs over the round loop.
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

template <int MAXL>
__global__ void fused_gibbs_kernel(
    const float* __restrict__ logw, const int* __restrict__ card,
    const uint32_t* __restrict__ words, const float* __restrict__ table,
    int* __restrict__ sample_out, int* __restrict__ bits_out,
    int* __restrict__ att_out, bool* __restrict__ ok_out,
    int b, int L, int W, float wscale, int use_iu, int n_seg, float lo,
    float scale, float mask_value) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;
  const float* row = logw + (size_t)lane * L;
  const int cd = card[lane];

  // ---- distribution generation: mask -> max-subtract -> exp -> floor ----
  float lw[MAXL];
  float mx = __int_as_float((int)0xff800000);  // -inf
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < L) {
      lw[l] = (l < cd) ? row[l] : mask_value;
      mx = fmaxf(mx, lw[l]);
    }
  }
  int w[MAXL];
  long long total = 0;
  int wmax = -1, amax = 0;
  const float fn = (float)n_seg;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < L) {
      const float z = __fsub_rn(lw[l], mx);
      float y;
      if (use_iu) {
        float t = __fmul_rn(__fsub_rn(z, lo), scale);
        t = fminf(fmaxf(t, 0.0f), fn);
        int idx = (int)t;
        if (idx > n_seg - 1) idx = n_seg - 1;
        const float frac = __fsub_rn(t, (float)idx);
        const float y0 = table[idx];
        const float y1 = table[idx + 1];
        y = __fadd_rn(y0, __fmul_rn(frac, __fsub_rn(y1, y0)));
      } else {
        y = expf(z);
      }
      w[l] = (int)floorf(__fmul_rn(y, wscale));
      total += w[l];
    }
  }
  if (total == 0) {  // all-zero row: force outcome 0
    w[0] = 1;
    total = 1;
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l < L && w[l] > wmax) {
      wmax = w[l];
      amax = l;
    }
  }

  // ---- Knuth-Yao DDG walk with the per-lane bit cursor -----------------
  const int budget = W * 32;
  const uint32_t* lw_words = words + (size_t)lane * W;
  int res = amax, t = 0, att = 1;
  bool done = (wmax == total);  // deterministic-row bypass
  if (!done) {
    // K = max(ceil_log2(total), 1): bit length of total - 1
    int K = 32 - __clz((int)(total - 1));
    if (K < 1) K = 1;
    const long long rej = (1LL << K) - total;
    long long d = 0;
    int c = 0;
    while (t < budget - 1) {
      const int bit = (lw_words[t >> 5] >> (t & 31)) & 1;
      const long long d2 = 2 * d + (1 - bit);
      const int shift = K - 1 - c;
      long long cum = 0;
      int sel = -1;
      if (shift >= 0) {
#pragma unroll
        for (int l = 0; l < MAXL; ++l) {
          if (l < L) {
            cum += (w[l] >> shift) & 1;
            if (sel < 0 && cum > d2) sel = l;
          }
        }
      }
      const long long colsum =
          cum + ((shift >= 0) ? ((rej >> shift) & 1) : 0);
      const bool hit = d2 < colsum;
      ++t;
      if (hit && sel >= 0) {
        res = sel;
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
  sample_out[lane] = res;
  bits_out[lane] = t;
  att_out[lane] = att;
  ok_out[lane] = done;
}

template <int MAXL>
void launch(const float* logw, const int* card, const uint32_t* words,
            const float* table, int* sample, int* bits, int* att, bool* ok,
            int b, int L, int W, float wscale, int use_iu, int n_seg,
            float lo, float scale, float mask_value, int block,
            cudaStream_t stream) {
  const int grid = (b + block - 1) / block;
  fused_gibbs_kernel<MAXL><<<grid, block, 0, stream>>>(
      logw, card, words, table, sample, bits, att, ok, b, L, W, wscale,
      use_iu, n_seg, lo, scale, mask_value);
}

}  // namespace

extern "C" int fused_gibbs_sample_launch(
    const void* logw, const void* card, const void* words, const void* table,
    void* sample, void* bits, void* att, void* ok, int b, int L, int W,
    float wscale, int use_iu, int n_seg, float lo, float scale,
    float mask_value, int block, void* stream) {
  if (b <= 0) return 0;
  if (L < 1 || L > 32) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = static_cast<const float*>(logw);
  auto cd = static_cast<const int*>(card);
  auto wd = static_cast<const uint32_t*>(words);
  auto tb = static_cast<const float*>(table);
  auto so = static_cast<int*>(sample);
  auto bo = static_cast<int*>(bits);
  auto ao = static_cast<int*>(att);
  auto oo = static_cast<bool*>(ok);
  if (L <= 4)
    launch<4>(f, cd, wd, tb, so, bo, ao, oo, b, L, W, wscale, use_iu, n_seg,
              lo, scale, mask_value, block, s);
  else if (L <= 8)
    launch<8>(f, cd, wd, tb, so, bo, ao, oo, b, L, W, wscale, use_iu, n_seg,
              lo, scale, mask_value, block, s);
  else if (L <= 16)
    launch<16>(f, cd, wd, tb, so, bo, ao, oo, b, L, W, wscale, use_iu,
               n_seg, lo, scale, mask_value, block, s);
  else
    launch<32>(f, cd, wd, tb, so, bo, ao, oo, b, L, W, wscale, use_iu,
               n_seg, lo, scale, mask_value, block, s);
  return (int)cudaGetLastError();
}
