// Flash attention kernel for Hopper (sm_90a): causal or full online-softmax
// attention, float32 running max, sum and accumulator, on CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the TPU
// Pallas kernel launched by flash_attention (pallas_call at
// flash_attention.py:86) and, through it, flash_mha (GQA).
//
// What it computes, per (batch, head) and query row, as the TPU kernel:
// scores q.k * dh^-0.5 accumulated in float32; keys after the row masked to
// -1e30 from absolute positions (causal); over key tiles the running max m,
// sum l and accumulator acc in float32, with p = exp(s - m) cast to v's
// type before the PV product; out = acc / max(l, 1e-30) in q's type.  Held
// to the plain version (kernels/ref.py::mha_ref) within a tolerance: sums
// are taken in another order.
//
// Bound on an H100: operations.  4 * B * H * S^2 * dh flops (halved for
// causal): 103 GFLOP at phi4-mini's attention (B = 1, S = 4096, H = 24,
// dh = 128), 0.104 ms at the 989 TFLOP/s of bf16 tensor cores, against
// 0.02 ms for reading q, k, v and writing o once.
//
// The simple design: one block of 256 threads per (64-row query tile,
// batch x head), the longest causal tiles launched first.  The query tile
// and each 64-key K tile, then V tile, are staged through shared memory
// as float32; each thread owns a 4 x 4 block of scores (its 4 rows' max and
// sum reduced over the 16 threads of the row by shuffles) and a 4 x (dh/16)
// block of the output.  Products are float32 FMAs on the CUDA cores; K/V
// heads are read in place (GQA head h reads kv head h / (H / KV)).  Left on
// the table, for a Hopper redesign: bf16/fp16 tiles through wgmma on the
// tensor cores (some 15x the float32 rate), TMA loads into a ring of
// shared-memory stages overlapping the math, and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads: 4 rows x 4 keys each
constexpr int LDP = BK + 4;   // P row stride: the two row groups of a warp
                              // land 16 banks apart
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

struct Layout {  // element strides of one operand: batch, sequence, head
  long long b, s, h;
};

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BK) * (DMAX + 1) + (size_t)BQ * LDP);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int dh, int H,
    int group, Layout lq, Layout lk, Layout lv, Layout lo, float scale,
    int causal) {
  constexpr int LD = DMAX + 1;     // odd float stride: conflict-free columns
  constexpr int NC = DMAX / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // BQ x LD
  float* KVs = Qs + BQ * LD;       // BK x LD: the K tile, then the V tile
  float* Ps = KVs + BK * LD;       // BQ x LDP

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  const T* qp = q + b * lq.b + h * lq.h;
  const T* kp = k + b * lk.b + hk * lk.h;
  const T* vp = v + b * lv.b + hk * lv.h;
  T* op = o + b * lo.b + h * lo.h;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < BQ * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh, qr = q0 + r;
    Qs[r * LD + d] = qr < S ? to_f(qp[qr * lq.s + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int last = causal ? min(q0 + BQ, S) - 1 : S - 1;
  const int n_tiles = last / BK + 1;  // tiles wholly above the diagonal skip
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's PV is done with KVs and Ps
    for (int e = tid; e < BK * dh; e += THREADS) {
      const int r = e / dh, d = e - r * dh, kr = k0 + r;
      KVs[r * LD + d] = kr < S ? to_f(kp[kr * lk.s + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < dh; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = KVs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && kc > qr) x = NEG;
        if (kc >= S) x = -INFINITY;  // past the sequence: p = 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done with the K tile
    for (int e = tid; e < BK * dh; e += THREADS) {
      const int r = e / dh, d = e - r * dh, kr = k0 + r;
      KVs[r * LD + d] = kr < S ? to_f(vp[kr * lv.s + d]) : 0.0f;
    }
    __syncthreads();

    const int n_keys = min(BK, S - k0);
    for (int j = 0; j < n_keys; ++j) {
      float p[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = KVs[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[i][c] = __fmaf_rn(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < dh) op[qr * lo.s + d] = from_f<T>(__fdiv_rn(acc[i][c], den));
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int dh, const Layout* ls, float scale,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  static bool configured = false;  // once per template instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, dh, H, H / KV, ls[0],
      ls[1], ls[2], ls[3], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int dh, const Layout* ls, float scale,
             int causal, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, dh, ls, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, B, H, KV, S, dh, ls, scale, causal,
                        stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  strides: 12 element strides,
// (batch, sequence, head) for q, k, v and o in turn; the head dim is
// contiguous.  scale: the caller's dh^-0.5, rounded to float32 as the
// reference rounds it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int S, int dh,
                                      const long long* strides, float scale,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh < 1 || dh > 128 || H < 1 || KV < 1 || H % KV != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Layout ls[4];
  for (int i = 0; i < 4; ++i)
    ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<float>(q, k, v, o, B, H, KV, S, dh, ls, scale, causal,
                             s);
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, dh, ls, scale,
                                     causal, s);
    case 2:
      return dispatch<__half>(q, k, v, o, B, H, KV, S, dh, ls, scale, causal,
                              s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
