// Flash attention kernel for Hopper (sm_90a), float32 route: causal or full
// online-softmax attention, float32 running max, sum and accumulator, on
// CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the TPU
// Pallas kernel launched by flash_attention (pallas_call at
// flash_attention.py:86) and, through it, flash_mha (GQA), for float32
// inputs.  bfloat16 and float16 inputs take the tensor-core kernel
// (flash_attention_tc.cu).  The route is chosen by dtype, not on failure:
// the tensor cores would run float32 as TF32, which keeps about three
// decimal digits, and the float32 checks hold 2e-5.
//
// What it computes, per (batch, head) and query row, as the TPU kernel:
// scores q.k * dh^-0.5 accumulated in float32; keys after the row masked to
// -1e30 from absolute positions (causal); over key tiles the running max m,
// sum l and accumulator acc in float32; out = acc / max(l, 1e-30).  Held to
// the plain version (kernels/ref.py::mha_ref) within a tolerance: sums are
// taken in another order, and the exponentials are taken base 2 on scores
// scaled by dh^-0.5 * log2(e).
//
// Bound on an H100: operations.  4 * B * H * S^2 * dh flops (halved for
// causal) at the 67 TFLOP/s of float32 outside the tensor cores: 1.5 ms at
// phi4-mini's attention (B = 1, S = 4096, H = 24, dh = 128, 103 GFLOP).
// Every product is an explicit __fmaf_rn: the build passes --fmad=false,
// under which a plain a * b + c is two instructions.
//
// The design keeps the FMA pipes fed from registers:
// - One block of 256 threads per (128-row query tile, batch x head), the
//   longest causal tiles launched first.  Thread (rg, cg), rg in 0..31 and
//   cg in 0..7, owns query rows rg + 32 i (i < 4); in S = QK^T the keys
//   cg + 8 j (j < 8), a 4 x 8 register tile; in O += PV the output columns
//   4 cg + 32 t (4 floats each, t < dh / 32), a 4 x dh/8 register tile.
//   A warp holds 4 row groups x 8 column groups, so the 8 threads of a row
//   group (the row's max and sum, reduced by 3 shuffles) share a quarter
//   warp and every shared-memory read is a float4.
// - Shared reads are conflict-free and broadcast: rows are DMAX + 4 floats
//   apart, so the 8 rows a quarter warp reads fall in 8 distinct 4-bank
//   groups; threads of one row group read the same Q rows, threads of one
//   column group the same K and V rows.  Per d step of 4 a warp reads 64
//   words of Q and 256 of K for 4096 FMAs (12.8 FMAs a word); per key in
//   PV, 16 words of P and 128 of V for 2048 FMAs (14.2).
// - P goes through shared memory transposed (key-major, a thread's 4 rows
//   adjacent), one float4 per key in PV.
// - K and V tiles arrive by 16-byte cp.async.cg into a ring of 3 slots
//   holding K0, V0, K1, V1, ... in turn: while one item is computed on, the
//   next two are in flight.  Copy loops run over the compile-time head dim
//   (64 or 128) with zero fill past dh and past S, so no division; rows must
//   be 16-byte aligned (dh a multiple of 4, 16-byte aligned data and
//   strides), which the wrapper ensures by padding or copying, and the
//   launch refuses anything else.
// - The causal mask (and the mask past S) is applied on the tiles that
//   cross the diagonal or the end only; exp2f on base-2 scaled scores.
// What limits it: at 250 registers a thread, 8 warps share an SM and meet
// at the same two barriers a tile, so their shared-load stalls line up;
// the compiled inner loops are almost all FFMA (PERF.md).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;       // query rows a block
constexpr int BK = 64;        // keys a tile
constexpr int THREADS = 256;  // 32 row groups x 8 column groups
constexpr int TM = 4;         // query rows a thread: rg + 32 i
constexpr int TN = 8;         // keys a thread in S: cg + 8 j
constexpr int STAGES = 3;     // ring slots
constexpr int LDP = BQ + 4;   // P^T row stride (floats)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TM == 4, "P^T rows are written as one float4 a key");

struct Layout {  // element strides of one operand: batch, sequence, head
  long long b, s, h;
};

template <int DMAX>
struct Tile {
  static constexpr int LD = DMAX + 4;      // row stride of Q, K, V tiles
  static constexpr int CHUNKS = DMAX / 4;  // 16-byte chunks a row
  static constexpr int NC = DMAX / 32;     // float4 output chunks a thread
  static constexpr size_t smem =
      sizeof(float) * ((size_t)BQ * LD + (size_t)STAGES * BK * LD +
                       (size_t)BK * LDP);
};

// 16 bytes global -> shared, or 16 zero bytes when !full (src not read)
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ROWS rows of a (S, dh) operand from row r0 into a ROWS x LD tile
template <int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ls, int r0, int S,
                                          int dh, int tid) {
  using T = Tile<DMAX>;
#pragma unroll
  for (int it = 0; it < ROWS * T::CHUNKS / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int r = e / T::CHUNKS, c = e % T::CHUNKS;  // powers of two
    const int gr = r0 + r;
    const bool full = gr < S && 4 * c < dh;
    cp16(dst + r * T::LD + 4 * c, full ? src + gr * ls + 4 * c : src, full);
  }
}

template <int DMAX>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int S, int dh, int H,
    int group, Layout lq, Layout lk, Layout lv, Layout lo, float scale2,
    int causal) {
  using T = Tile<DMAX>;
  constexpr int LD = T::LD, NC = T::NC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                     // BQ x LD
  float* ring = Qs + BQ * LD;           // STAGES x (BK x LD)
  float* Pt = ring + STAGES * BK * LD;  // BK x LDP: p, key-major

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;  // longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / group;
  const float* qp = q + b * lq.b + h * lq.h;
  const float* kp = k + b * lk.b + hk * lk.h;
  const float* vp = v + b * lv.b + hk * lv.h;
  float* op = o + b * lo.b + h * lo.h;
  const int tid = threadIdx.x, lane = tid & 31;
  const int cg = lane & 7;                       // column group
  const int rg = (tid >> 5) * 4 + (lane >> 3);   // row group

  const int last = causal ? min(q0 + BQ, S) - 1 : S - 1;
  const int n_tiles = last / BK + 1;  // tiles wholly above the diagonal skip
  const int n_items = 2 * n_tiles;    // ring items: K0, V0, K1, V1, ...

  // ring item t into slot t % STAGES; every call commits one group (empty
  // past the last item), so "all but one in flight" always means item t
  auto issue = [&](int t) {
    if (t < n_items) {
      float* dst = ring + (t % STAGES) * BK * LD;
      const int k0 = (t >> 1) * BK;
      if (t & 1)
        load_tile<DMAX, BK>(dst, vp, lv.s, k0, S, dh, tid);
      else
        load_tile<DMAX, BK>(dst, kp, lk.s, k0, S, dh, tid);
    }
    cp_commit();
  };

  load_tile<DMAX, BQ>(Qs, qp, lq.s, q0, S, dh, tid);
  cp_commit();
  issue(0);
  issue(1);

  float m[TM], l[TM], acc[TM][NC][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }
  const int n_d4 = dh >> 2;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;

    // ---- S = Q K^T on item 2 kt --------------------------------------
    cp_wait_all_but_one();
    __syncthreads();  // item 2 kt landed; item 2 kt - 1 and P are free
    issue(2 * kt + 2);
    const float* Ks = ring + ((2 * kt) % STAGES) * BK * LD;
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d4 = 0; d4 < n_d4; ++d4) {
      float4 a[TM], bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (rg + 32 * i) * LD +
                                                4 * d4);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * LD +
                                                 4 * d4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float x = s[i][j];
          x = __fmaf_rn(a[i].x, bk[j].x, x);
          x = __fmaf_rn(a[i].y, bk[j].y, x);
          x = __fmaf_rn(a[i].z, bk[j].z, x);
          x = __fmaf_rn(a[i].w, bk[j].w, x);
          s[i][j] = x;
        }
    }

    // ---- online softmax (base 2), P^T to shared memory -----------------
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qr = q0 + rg + 32 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = __fmul_rn(s[i][j], scale2);
        if (edge) {
          const int kc = k0 + cg + 8 * j;
          if (causal && kc > qr) x = NEG;
          if (kc >= S) x = -INFINITY;  // past the sequence: p = 0
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(__fsub_rn(m[i], m_new));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = exp2f(__fsub_rn(s[i][j], m_new));
        rs = __fadd_rn(rs, p);
        s[i][j] = p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fmaf_rn(l[i], corr, rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = __fmul_rn(acc[i][c][e], corr);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      *reinterpret_cast<float4*>(Pt + (cg + 8 * j) * LDP + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    // ---- O += P V on item 2 kt + 1 -------------------------------------
    cp_wait_all_but_one();
    __syncthreads();  // item 2 kt + 1 landed, P written, K tile free
    issue(2 * kt + 3);
    const float* Vs = ring + ((2 * kt + 1) % STAGES) * BK * LD;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {  // keys past S: V zero, p zero
      const float4 p4 = *reinterpret_cast<const float4*>(Pt + j * LDP + 4 * rg);
      const float p[TM] = {p4.x, p4.y, p4.z, p4.w};
      float4 vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        vv[c] = *reinterpret_cast<const float4*>(Vs + j * LD + 4 * cg +
                                                 32 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c][0] = __fmaf_rn(p[i], vv[c].x, acc[i][c][0]);
          acc[i][c][1] = __fmaf_rn(p[i], vv[c].y, acc[i][c][1]);
          acc[i][c][2] = __fmaf_rn(p[i], vv[c].z, acc[i][c][2]);
          acc[i][c][3] = __fmaf_rn(p[i], vv[c].w, acc[i][c][3]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qr = q0 + rg + 32 * i;
    if (qr >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * cg + 32 * c;
      if (d < dh)
        *reinterpret_cast<float4*>(op + qr * lo.s + d) = make_float4(
            __fdiv_rn(acc[i][c][0], den), __fdiv_rn(acc[i][c][1], den),
            __fdiv_rn(acc[i][c][2], den), __fdiv_rn(acc[i][c][3], den));
    }
  }
}

template <int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int S, int dh, const Layout* ls, float scale2,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = Tile<DMAX>::smem;
  static bool configured = false;  // once per template instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_attention_kernel<DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, dh, H, H / KV,
      ls[0], ls[1], ls[2], ls[3], scale2, causal);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// strides: 12 element strides, (batch, sequence, head) for q, k, v and o in
// turn; the head dim is contiguous.  scale: the caller's dh^-0.5, rounded to
// float32 as the reference rounds it.  Takes 16-byte rows only: dh a
// multiple of 4, pointers 16-byte aligned, every stride a multiple of 4.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KV, int S, int dh,
                                      const long long* strides, float scale,
                                      int causal, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dh < 4 || dh > 128 || dh % 4 != 0 || H < 1 || KV < 1 || H % KV != 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  Layout ls[4];
  for (int i = 0; i < 4; ++i) {
    ls[i] = Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    if (ls[i].b % 4 || ls[i].s % 4 || ls[i].h % 4)
      return (int)cudaErrorMisalignedAddress;
  }
  const float scale2 = scale * LOG2E;  // folded once, on the host
  auto s = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch<64>(q, k, v, o, B, H, KV, S, dh, ls, scale2, causal, s);
  return launch<128>(q, k, v, o, B, H, KV, S, dh, ls, scale2, causal, s);
}
