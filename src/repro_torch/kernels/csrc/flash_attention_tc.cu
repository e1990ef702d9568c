// Flash attention kernel for Hopper (sm_90a), bfloat16 and float16 route:
// causal or full online-softmax attention on the tensor cores (wgmma), with
// float32 running max, sum and accumulator.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the TPU
// Pallas kernel launched by flash_attention (pallas_call at
// flash_attention.py:86) and, through it, flash_mha (GQA), for bf16 and fp16
// inputs.  float32 inputs take the CUDA-core kernel (flash_attention.cu):
// wgmma would run them in TF32, which keeps about three decimal digits, and
// the float32 checks hold 2e-5.
//
// What it computes, per (batch, head) and query row, as the TPU kernel:
// scores q.k * dh^-0.5 accumulated in float32; keys after the row masked to
// -1e30 from absolute positions (causal); over key tiles the running max m,
// sum l and accumulator acc in float32, with p = exp(s - m) rounded to v's
// type before the PV product; out = acc / max(l, 1e-30) in q's type.  Held
// to the plain version (kernels/ref.py::mha_ref) within a tolerance: sums
// are taken in another order, and exp(s - m) is exp2 of log2-scaled scores.
//
// Bound on an H100: operations.  4 * B * H * S^2 * dh flops (halved for
// causal): 103 GFLOP at phi4-mini's attention (B = 1, S = 4096, H = 24,
// dh = 128), 0.104 ms at the 989 TFLOP/s of bf16 tensor cores, against
// 0.02 ms for reading q, k, v and writing o once.
//
// Design.  A block is two warpgroups (128 threads each), each owning a
// 64-row query tile of one (batch, head); the two share every K/V tile (one
// warpgroup a block measured slower at phi4-mini's attention, PERF.md).  The longest causal tiles launch first (the query tile index is the
// grid's slowest dimension, counted down).
//   - Loads: TMA (cp.async.bulk.tensor, 4-d maps over (dh, heads, S, B) with
//     the caller's strides, so GQA kv head h / (H / KV) is read in place).
//     The head dim is cut into 64-column chunks of 128 bytes, 128-byte
//     swizzled; columns past dh (and rows past S) arrive as zeros from the
//     TMA's out-of-bounds fill, so any dh that is a multiple of 8 is taken
//     (the wrapper zero-pads other dh to one).  The Q tile is loaded once;
//     K and V tiles come through a ring of 2 stages, each signalled on its
//     own mbarrier, the next tile's load issued before this tile's math.
//   - S = Q K^T: wgmma m64n64k16, A (Q) and B (K) from shared memory, both
//     K-major.
//   - Online softmax on the accumulator fragments: a thread holds 2 rows x
//     16 keys of the 64 x 64 S tile; row max and row sum are reduced over
//     the 4 threads that share a row by shuffles; m and l in float32; tiles
//     wholly above the diagonal are skipped and the diagonal tile masked.
//   - O += P V: wgmma m64nDk16 with A (P, rounded to v's type) from
//     registers -- the S accumulator layout is the A fragment layout -- and
//     B (V, (keys, dh) with dh contiguous) from shared memory through the
//     transpose bit.
//   - Epilogue: out = acc / max(l, 1e-30) stored from registers.
//   - A K/V stage is released by a __syncthreads at the end of each tile;
//     the two stages and two blocks an SM (96 KB of shared memory each at
//     dh 128) overlap loads with math.
// Left for later: a producer warp and deeper ring (warp specialisation),
// overlapping one tile's softmax with the next tile's S, a persistent grid.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per warpgroup (one wgmma M)
constexpr int NWG = 2;          // warpgroups a block, sharing each K/V tile
constexpr int BK = 64;          // keys per tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int CHUNK_BYTES = 64 * 128;  // 64 rows x 64 columns of 2 bytes
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// DP: the head dim padded to a multiple of 64
template <int DP>
struct Smem {
  alignas(1024) uint8_t q[NWG][DP / 64][CHUNK_BYTES];
  alignas(1024) uint8_t k[STAGES][DP / 64][CHUNK_BYTES];
  alignas(1024) uint8_t v[STAGES][DP / 64][CHUNK_BYTES];
  uint64_t bar_q, bar_k[STAGES], bar_v[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count));
}

// arrive once and expect `bytes` of TMA transactions on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 64 x 64 chunk: columns c0.., head, rows s0.., batch
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int head,
                                         int s0, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(head), "r"(s0), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows of 128 bytes along the reduction dim): 8-row groups
// 1024 bytes apart; the leading offset is unused
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}
// MN-major operand (V: rows are keys, 64 head-dim columns per 128-byte
// row): 64-column chunks CHUNK_BYTES apart, 8-key groups 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return smem_desc(addr, CHUNK_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from touching accumulator registers across the
// asynchronous wgmma (reads after the wait see its result)
__device__ __forceinline__ void reg_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

#define ACC8(d, i)                                                        \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d, i) ACC8(d, i), ACC8(d, i + 8), ACC8(d, i + 16), ACC8(d, i + 24)
#define REGS32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 64, float32) += A (64 x 16, smem, K-major) * B (16 x 64, smem,
// K-major); scale_d 0 overwrites d
#define WGMMA_SS_N64(NAME, TY)                                               \
  __device__ __forceinline__ void NAME(float (&d)[32], uint64_t da,          \
                                       uint64_t db, int scale_d) {           \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32  \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
        : ACC32(d, 0)                                                        \
        : "l"(da), "l"(db), "r"(scale_d));                                   \
  }
WGMMA_SS_N64(wgmma_ss_bf16, "bf16")
WGMMA_SS_N64(wgmma_ss_f16, "f16")

// d (64 x N, float32) += A (64 x 16, registers) * B (16 x N, smem,
// MN-major: transpose bit set)
#define WGMMA_RS_N64(NAME, TY)                                               \
  __device__ __forceinline__ void NAME(float (&d)[32], const uint32_t* a,    \
                                       uint64_t db) {                        \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " REGS32  \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
        : ACC32(d, 0)                                                        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }
WGMMA_RS_N64(wgmma_rs64_bf16, "bf16")
WGMMA_RS_N64(wgmma_rs64_f16, "f16")

#define WGMMA_RS_N128(NAME, TY)                                              \
  __device__ __forceinline__ void NAME(float (&d)[64], const uint32_t* a,    \
                                       uint64_t db) {                        \
    asm volatile(                                                            \
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                       \
        " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " REGS64 \
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
        : ACC32(d, 0), ACC32(d, 32)                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }
WGMMA_RS_N128(wgmma_rs128_bf16, "bf16")
WGMMA_RS_N128(wgmma_rs128_f16, "f16")

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same_v<T, __half>)
    wgmma_ss_f16(d, da, db, scale_d);
  else
    wgmma_ss_bf16(d, da, db, scale_d);
}

template <typename T, int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (DP == 64) {
    if constexpr (std::is_same_v<T, __half>)
      wgmma_rs64_f16(d, a, db);
    else
      wgmma_rs64_bf16(d, a, db);
  } else {
    if constexpr (std::is_same_v<T, __half>)
      wgmma_rs128_f16(d, a, db);
    else
      wgmma_rs128_bf16(d, a, db);
  }
}

// two floats rounded to T, packed low-first as an A-fragment register
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  } else {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <int DP>
__device__ __forceinline__ void load_kv(Smem<DP>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int stage,
                                        int k0, int hk, int b) {
  mbar_expect_tx(&sm.bar_k[stage], DP / 64 * CHUNK_BYTES);
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_load(sm.k[stage][c], tk, &sm.bar_k[stage], 64 * c, hk, k0, b);
  mbar_expect_tx(&sm.bar_v[stage], DP / 64 * CHUNK_BYTES);
#pragma unroll
  for (int c = 0; c < DP / 64; ++c)
    tma_load(sm.v[stage][c], tv, &sm.bar_v[stage], 64 * c, hk, k0, b);
}

template <typename T, int DP>
__global__ void __launch_bounds__(128 * NWG) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, T* __restrict__ o, int S, int dh,
    int H, int group, long long o_b, long long o_s, long long o_h,
    float scale_log2, int causal) {
  constexpr int NJ = DP / 8;  // n8 column blocks of the output accumulator
  extern __shared__ uint8_t smem_raw[];
  Smem<DP>& sm = *reinterpret_cast<Smem<DP>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int bh = blockIdx.x, b = bh / H, h = bh % H, hk = h / group;
  const int nq = (S + NWG * BQ - 1) / (NWG * BQ);
  const int q0 = (nq - 1 - (int)blockIdx.y) * NWG * BQ;  // longest first
  const int n_tiles =  // tiles wholly above the diagonal are skipped
      causal ? (min(q0 + NWG * BQ, S) - 1) / BK + 1 : (S + BK - 1) / BK;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int qw = q0 + wg * BQ;                 // this warpgroup's rows
  const int r0 = ((tid >> 5) & 3) * 16 + (lane >> 2);  // its rows r0, r0 + 8
  const int qc = 2 * (lane & 3);               // its columns in each n8 block

  if (tid == 0) {
    mbar_init(&sm.bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.bar_k[s], 1);
      mbar_init(&sm.bar_v[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&sm.bar_q, NWG * DP / 64 * CHUNK_BYTES);
    for (int w = 0; w < NWG; ++w)
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        tma_load(sm.q[w][c], &tq, &sm.bar_q, 64 * c, h, q0 + w * BQ, b);
    load_kv(sm, &tk, &tv, 0, 0, hk, b);
  }

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  const uint32_t q_base = smem_u32(sm.q[wg][0]);
  mbar_wait(&sm.bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1, k0 = t * BK;
    const uint32_t parity = (t >> 1) & 1;
    // the other stage was released by the __syncthreads ending tile t - 1
    if (tid == 0 && t + 1 < n_tiles)
      load_kv(sm, &tk, &tv, stage ^ 1, k0 + BK, hk, b);
    // a tile wholly above this warpgroup's diagonal adds nothing to it
    if (causal && k0 > qw + BQ - 1) {
      __syncthreads();
      continue;
    }

    // ---- S = Q K^T ------------------------------------------------------
    float s[32];
    mbar_wait(&sm.bar_k[stage], parity);
    const uint32_t k_base = smem_u32(sm.k[stage][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk >> 2) * CHUNK_BYTES + (kk & 3) * 32;
      wgmma_ss<T>(s, kmajor_desc(q_base + off), kmajor_desc(k_base + off),
                  kk > 0);
    }
    wgmma_commit_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    // ---- online softmax on the fragments (log2 domain) ------------------
    const bool edge = (causal && k0 + BK - 1 > qw) || k0 + BK > S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int col = k0 + (i >> 2) * 8 + qc + (i & 1);
        const int row = qw + r0 + ((i & 2) ? 8 : 0);
        if (causal && col > row) x = NEG;
        if (col >= S) x = -INFINITY;  // past the sequence: p = 0
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    uint32_t pa[16];  // P rounded to v's type, as the A fragments of PV
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = (i >> 1) & 1;
      const float p0 = exp2f(s[i] - m[r]), p1 = exp2f(s[i + 1] - m[r]);
      rs[r] += p0 + p1;
      pa[i >> 1] = pack2<T>(p0, p1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    // ---- O += P V --------------------------------------------------------
    mbar_wait(&sm.bar_v[stage], parity);
    const uint32_t v_base = smem_u32(sm.v[stage][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<T, DP>(acc, pa + 4 * kk, mnmajor_desc(v_base + kk * 16 * 128));
    wgmma_commit_wait();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) reg_fence(acc[i]);
    __syncthreads();  // every thread is done with this stage
  }

  // ---- epilogue: out = acc / max(l, 1e-30) --------------------------------
  T* op = o + b * o_b + h * o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + r0 + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * j + qc;
      if (col < dh)
        store2<T>(op + row * o_s + col, __fdiv_rn(acc[4 * j + 2 * r], den),
                  __fdiv_rn(acc[4 * j + 2 * r + 1], den));
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (so the
// library links no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over (dh, heads, S, B) of 2-byte elements with the given element
// strides (batch, sequence, head); box 64 columns x 1 head x 64 rows
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
              int dh, int heads, int S, int B, const long long* st) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int dh, const long long* st, float scale,
           int causal, CUtensorMapDataType type, cudaStream_t stream) {
  constexpr size_t smem = sizeof(Smem<DP>) + 1024;  // + alignment slack
  static bool configured = false;  // once per template instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, type, dh, H, S, B, st) ||
      !make_map(&tk, k, type, dh, KV, S, B, st + 3) ||
      !make_map(&tv, v, type, dh, KV, S, B, st + 6))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B * H, (S + NWG * BQ - 1) / (NWG * BQ));
  flash_tc_kernel<T, DP><<<grid, 128 * NWG, smem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), S, dh, H, H / KV, st[9], st[10], st[11],
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int dh, const long long* st, float scale,
             int causal, CUtensorMapDataType type, cudaStream_t stream) {
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, S, dh, st, scale, causal, type,
                         stream);
  return launch<T, 128>(q, k, v, o, B, H, KV, S, dh, st, scale, causal, type,
                        stream);
}

}  // namespace

// dtype: 1 bfloat16, 2 float16.  strides: 12 element strides, (batch,
// sequence, head) for q, k, v and o in turn; the head dim is contiguous, dh
// a multiple of 8, the pointers 16-byte aligned (the TMA's terms).  scale:
// the caller's dh^-0.5, rounded to float32 as the reference rounds it.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B, int H,
                                         int KV, int S, int dh,
                                         const long long* strides, float scale,
                                         int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh < 8 || dh > 128 || dh % 8 || H < 1 || KV < 1 || H % KV != 0 ||
      S > 65535 * NWG * BQ)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, dh, strides,
                                     scale, causal,
                                     CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s);
    case 2:
      return dispatch<__half>(q, k, v, o, B, H, KV, S, dh, strides, scale,
                              causal, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
