// Fused Gibbs sweep kernel for Hopper (sm_90a): label mask -> max-subtract
// -> IU-exp LUT -> k-bit floor -> non-normalized Knuth-Yao DDG walk, on the
// (b, L) log-weight tile of one colour, on the energies of one colour of
// an MRF grid made in the kernel, or on the log-CPT rows of one colour of
// a Bayes net gathered in the kernel, with the random bit words made
// inside the kernel.
//
// Replaces: src/repro/kernels/fused_sweep.py::_fused_kernel, the TPU Pallas
// kernel launched by fused_gibbs_sample (pallas_call at fused_sweep.py:165).
//
// Random bits.  Word j of lane i is JAX's threefry2x32 (20 rounds) of the
// 64-bit counter (lane0 + i) * W + j under the colour's key, x0 ^ x1 --
// word (lane0 + i, j) of jax.random.bits(key, (B, W)) in the partitionable
// layout over the global lane axis, which is what the plain version reads
// (core/rng.py::random_bit_words; core/rng.py::lane_word is its scalar
// twin).  lane0 is 0 for an unsharded launch; a lane shard whose first row
// is global row lane0 passes it, so the shards together draw the unsharded
// launch's bits.  A lane computes word j only when its cursor first reaches
// it, so no word is written to or read from memory.
//
// Row map.  A site block of a colour holds the colour's nodes at positions
// colpos (n_loc of the colour's N nodes, in the colour's order), which are
// not contiguous.  With a map, launch row r is global row
// (lane0 + r / n_loc) * N + colpos[r % n_loc], and its counters are that
// row's: the blocks of a colour together draw the unsharded colour
// update's bits.  Without one (colpos null) row r is lane0 + r, as before.
// The map costs one int64 load a row, made only by rows that walk.
//
// Three sources of log-weights, chosen at compile time (the kernel's second
// template parameter); all feed the same distribution generation and walk
// (distribution(), walk()).
//
// Gathered source: lane i's L log-weights are row i of a (b, L) tile that
// the caller gathered (the Bayes-net, factor-graph and Ising colour
// updates, the served queue).  Bound on an H100: bytes.  Per lane the
// function reads the L float32 log-weights and the int32 card and writes
// sample, bits and attempts (int32) and ok (1 byte); the 4.1 kB LUT is
// read once: b * (4L + 4 + 13) + 4100 bytes per launch, at 3.35 TB/s, and
// with a row map its n_loc int64 columns besides.  The arithmetic (a few
// dozen flops a label, ~10 DDG levels of L-wide integer work and one
// 20-round threefry per 32 bits walked) is far under the card's rates.
// At serving sizes (b of a few thousand lanes) that is well under a MB and
// under 0.1 us, so a launch is bound by launch latency and the serial walk.
//
// Grid source: one checkerboard colour update of a pairwise MRF grid
// (pgm/gibbs.py::checkerboard_halfstep) in one launch.  Lane i is the
// i-th site of the kept parity: (b, h, m) over (B, H, ceil(width / 2)),
// at column w = 2m + ((h + parity) & 1); a lane past the grid's edge or on
// a clamped site walks nothing, keeps its label and is not counted.  The
// group makes its site's energies itself: thread l adds pairwise[l, m] of
// the in-grid neighbours' labels m to +0.0 in the order up, down, left,
// right, then the unary term, then multiplies by beta[b] where one is
// given, and negates -- the plain path's float association, one rounded
// op a stage.  The (L, L) table sits in shared memory (at most 4 kB,
// transposed so a group reads consecutive words).  The new label is
// written in place: a kept site reads only neighbours of the other
// parity, which no lane of the launch writes.  The walk reads the words
// of global row lane0 + (b * H + h) * width + w, the row the all-sites draw
// gave the site, so labels, bits and attempts equal the plain path's.
// Bits and attempts of the kept sites are summed in the block (warp
// reductions, then one atomicAdd a block into a two-entry int64
// accumulator: integer sums, exact in any order).  Bytes a half-step: the
// int32 labels read once (4 B H width; a sector holds both parities),
// the unary once (4 H width L), the table (4 L^2) and LUT per block from
// L2, the kept labels written (4 B ceil(H width / 2)), and the clamp mask
// (H width or B H width bytes) and beta (4 B) where given: penguin
// (16 x 500 x 333, L 2) 17.3 MB, 5.2 us at 3.35 TB/s; Art (16 x 288 x
// 384, L 16) 17.7 MB, 5.3 us.
// The walk's latency bounds it, as in the gathered source; the energies
// cost a few loads and 5 adds a label.
//
// Plan source: one colour update of a Bayes net (pgm/compile.py::
// _color_update's gather, fold and sample) in one launch.  Lane (b, i) is
// node nodes[i] of the colour's N nodes in chain b; it reads the words of
// global row (lane0 + b) * N + i, the row the gathered tile gives it.
// Thread l < card of the group makes label l's log-weight from the node's
// packed record (struct Plan): its own CPT row, bank[clip(offset + sum_j
// stride_j x[pa_j] + l)], plus the fold over its child slots c of
// bank[clip(offset_c + sum_j stride_cj x[pa_cj] + stride x[child_c] +
// vstride_c l)], indices in 64 bits and clipped to the bank as the plain
// path's, one rounded add a slot in the plain path's order; where beta is
// given, minus the valid labels' max, times beta.  The new state is
// written in place: a colour is independent in the moral graph, so no lane
// of the launch reads a state another writes.  Bits and attempts are
// summed a block and added atomically, as in the grid source; the groups
// loop over the lanes, at most kPlanBlocks blocks, so the atomics stay few
// at a million lanes.  Lanes run node-major (the lanes of a block share
// one node's record and tables; 1.5 % faster than chain-major on the
// Munin-scale cell).  Bytes an update: the class's Markov blankets'
// states read and its states written, the records and the tables they
// name (L2-resident: Munin-scale states 4.3 MB, bank 0.32 MB).  Latency
// bounds it: at G 32 a warp walks one lane, and the gather adds two
// dependent L2 reads (a state, then its row) to the walk's; two child
// slots' loads in flight at once gained 3 %, a register bound 4 %, a
// thread a child slot under 1 % (PERF.md).
//
// Design: a group of G = next_pow2(L) threads per lane (2 <= G <= 32,
// 32 / G lanes a warp).  Thread l holds label l; the row max, the integer
// total and the argmax (ties to the lowest label) are shuffles within the
// group, exact and so independent of order; at each DDG level the column
// sum is __popc(__ballot_sync(group, bit)) and the leaf the label whose
// prefix popc under lanemask_le equals d + 1; d, the level, the cursor
// and the current word are replicated in the group.  (One thread per
// lane, the row in registers, measured slower at the serve path's shapes:
// PERF.md.)
// Later work: a CUDA graph over a served round, the factor graph's
// gather fused in as a source, and a Bayes net's plan lanes bucketed by
// cardinality so a group holds only its node's labels.
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

constexpr int MAX_L = 32;  // widest label axis a group holds

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

// What the distribution generation and the walk read, whichever source
// gives the log-weights
struct Walk {
  const float* table;
  uint32_t k0, k1;  // the colour's key
  int L, W;         // labels, words of budget per lane
  float wscale;     // 2^k - 1
  int use_iu, n_seg;
  float lo, scale;
};

// one label's k-bit weight from its masked log-weight and the row max
__device__ __forceinline__ int label_weight(const Walk& c, float lw,
                                            float mx) {
  const float z = __fsub_rn(lw, mx);
  float y;
  if (c.use_iu) {
    float t = __fmul_rn(__fsub_rn(z, c.lo), c.scale);
    t = fminf(fmaxf(t, 0.0f), (float)c.n_seg);
    int idx = (int)t;
    if (idx > c.n_seg - 1) idx = c.n_seg - 1;
    const float frac = __fsub_rn(t, (float)idx);
    const float y0 = c.table[idx];
    const float y1 = c.table[idx + 1];
    y = __fadd_rn(y0, __fmul_rn(frac, __fsub_rn(y1, y0)));
  } else {
    y = expf(z);
  }
  return (int)floorf(__fmul_rn(y, c.wscale));
}

// K = max(ceil_log2(total), 1): the bit length of total - 1
__device__ __forceinline__ int levels(int total) {
  const int K = 32 - __clz(total - 1);
  return K < 1 ? 1 : K;
}

// the threads of this thread's group in its warp
template <int G>
__device__ __forceinline__ unsigned group_mask(int wl) {
  return G == 32 ? 0xffffffffu : ((1u << G) - 1) << (wl & ~(G - 1));
}

// A lane's distribution: this thread's k-bit weight, the row total and
// the first argmax; det when the argmax holds the whole mass
struct Dist {
  int w, total, amax;
  bool det;
};

// ---- distribution generation: max-subtract -> exp -> floor ------------
// lw: this thread's masked log-weight (-inf for l >= L)
template <int G>
__device__ __forceinline__ Dist distribution(const Walk& c, float lw,
                                             bool real, unsigned gmask,
                                             int l) {
  float mx = lw;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, off, G));
  int w = real ? label_weight(c, lw, mx) : 0;
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
  return {w, total, amax, wmax == total};
}

// A lane's draw: label, bits read, attempts, and whether it ended on a
// leaf (or bypassed the walk)
struct Draw {
  int res, t, att;
  bool done;
};

// the draw of a deterministic row: its argmax, no bits
__device__ __forceinline__ Draw bypass(const Dist& d) {
  return {d.amax, 0, 1, true};
}

// ---- Knuth-Yao DDG walk with the per-lane bit cursor -------------------
// on the words of global row `row`
template <int G>
__device__ __forceinline__ Draw walk(const Walk& c, const Dist& dist,
                                     bool real, unsigned gmask, int wl,
                                     unsigned long long row) {
  const int budget = c.W * 32;
  Draw out{dist.amax, 0, 1, false};
  const int K = levels(dist.total);
  const long long rej = (1LL << K) - dist.total;
  const unsigned long long base = row * (unsigned long long)c.W;
  const unsigned le = (2u << wl) - 1;  // lanemask_le (all ones at 31)
  long long d = 0;
  int lev = 0, wj = -1;
  uint32_t word = 0;
  while (out.t < budget - 1) {
    if ((out.t >> 5) != wj) {  // the cursor reached a new word
      wj = out.t >> 5;
      word = lane_word(c.k0, c.k1, base + wj);
    }
    const int bit = (word >> (out.t & 31)) & 1;
    const long long d2 = 2 * d + (1 - bit);
    const int shift = K - 1 - lev;
    const bool mine = shift >= 0 && real && ((dist.w >> shift) & 1);
    const unsigned col = __ballot_sync(gmask, mine) & gmask;
    const int cum = __popc(col);
    const long long colsum = cum + ((shift >= 0) ? ((rej >> shift) & 1) : 0);
    const bool hit = d2 < colsum;
    ++out.t;
    if (hit && d2 < cum) {  // leaf: the label whose prefix count is d2 + 1
      const bool leaf = mine && __popc(col & le) == d2 + 1;
      out.res = (__ffs(__ballot_sync(gmask, leaf) & gmask) - 1) & (G - 1);
      out.done = true;
      break;
    }
    if (hit || lev + 1 >= K) {  // rejection pad (or level overflow)
      d = 0;
      lev = 0;
      ++out.att;
    } else {
      d = d2 - colsum;
      ++lev;
    }
  }
  return out;
}

// ---- gathered source: a (b, L) tile of log-weights ----------------------
struct Gathered {
  Walk c;
  const float* logw;
  const int* card;
  int* sample;
  int* bits;
  int* att;
  bool* ok;
  unsigned long long lane0;  // global row of this launch's first lane
  const long long* colpos;   // row map columns (null: no map)
  long long n_loc;           // columns of the map
  unsigned long long stride; // the colour's node count N
  long long lanes;           // b
  float mask_value;
};

template <int G>
__device__ __forceinline__ void gibbs_group(const Gathered& p) {
  // 64-bit: b * G threads pass 2^31 from b = 2^26 lanes at G = 32
  const long long lane =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (lane >= p.lanes) return;  // the whole group leaves together
  const int wl = threadIdx.x & 31;          // position in the warp
  const int l = wl & (G - 1);               // this thread's label
  const unsigned gmask = group_mask<G>(wl);
  const bool real = l < p.c.L;

  float lw = __int_as_float((int)0xff800000);  // -inf
  if (real)  // the label mask
    lw = l < p.card[lane] ? p.logw[(size_t)lane * p.c.L + l] : p.mask_value;
  const Dist dist = distribution<G>(p.c, lw, real, gmask, l);
  Draw d = bypass(dist);
  if (!dist.det) {
    unsigned long long row = p.lane0 + (unsigned long long)lane;
    if (p.colpos != nullptr)
      row = (p.lane0 + (unsigned long long)(lane / p.n_loc)) * p.stride +
            (unsigned long long)p.colpos[lane % p.n_loc];
    d = walk<G>(p.c, dist, real, gmask, wl, row);
  }
  if (l == 0) {
    p.sample[lane] = d.res;
    p.bits[lane] = d.t;
    p.att[lane] = d.att;
    p.ok[lane] = d.done;
  }
}

// ---- grid source: one colour of a (B, H, W) MRF grid --------------------
struct Grid {
  Walk c;
  int* labels;              // (B, H, W); the kept parity written in place
  const float* unary;       // (H, W, L)
  const float* pairwise;    // (L, L)
  const bool* clamp;        // frozen sites, null: none
  long long clamp_chain;    // clamp's stride between chains (0: shared)
  const float* beta;        // inverse temperature, null: none
  long long beta_chain;     // beta's stride between chains (0: shared)
  unsigned long long* acc;  // [bits, attempts] of the kept sites, added to
  unsigned long long lane0; // global row of site (0, 0, 0)
  long long lanes;          // B * H * half
  int H, width, half, parity;
};

template <int G>
__device__ __forceinline__ void gibbs_group(const Grid& p) {
  __shared__ float pwt[MAX_L * MAX_L];  // pwt[m * L + l] = pairwise[l, m]
  __shared__ unsigned sums[2][32];      // a warp's bits and attempts
  const int L = p.c.L;
  for (int i = threadIdx.x; i < L * L; i += blockDim.x)
    pwt[(i % L) * L + i / L] = p.pairwise[i];
  __syncthreads();

  // no thread returns early: every one reaches the block's sums
  const long long lane =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const int wl = threadIdx.x & 31;
  const int l = wl & (G - 1);
  const unsigned gmask = group_mask<G>(wl);
  const bool real = l < L;
  bool keep = lane < p.lanes;  // the group's site is kept and free
  int b = 0, h = 0, w = 0;
  long long site = 0;
  if (keep) {  // lanes < 2^31, so 32-bit division
    const unsigned bh = (unsigned)lane / (unsigned)p.half;  // b * H + h
    h = (int)(bh % (unsigned)p.H);
    b = (int)(bh / (unsigned)p.H);
    w = 2 * (int)((unsigned)lane - bh * (unsigned)p.half) +
        ((h + p.parity) & 1);
    site = (long long)bh * p.width + w;
    keep = w < p.width &&
           !(p.clamp != nullptr &&
             p.clamp[b * p.clamp_chain + (long long)h * p.width + w]);
  }
  unsigned bits = 0, att = 0;
  if (keep) {
    float lw = __int_as_float((int)0xff800000);  // -inf
    if (real) {
      float s = 0.0f;  // up, down, left, right; off-grid adds nothing
      if (h > 0) s = __fadd_rn(s, pwt[p.labels[site - p.width] * L + l]);
      if (h < p.H - 1)
        s = __fadd_rn(s, pwt[p.labels[site + p.width] * L + l]);
      if (w > 0) s = __fadd_rn(s, pwt[p.labels[site - 1] * L + l]);
      if (w < p.width - 1) s = __fadd_rn(s, pwt[p.labels[site + 1] * L + l]);
      float e = __fadd_rn(p.unary[((long long)h * p.width + w) * L + l], s);
      if (p.beta != nullptr) e = __fmul_rn(e, p.beta[b * p.beta_chain]);
      lw = -e;
    }
    const Dist dist = distribution<G>(p.c, lw, real, gmask, l);
    Draw d = bypass(dist);
    if (!dist.det)
      d = walk<G>(p.c, dist, real, gmask, wl,
                  p.lane0 + (unsigned long long)site);
    if (l == 0) {
      p.labels[site] = d.res;
      bits = d.t;
      att = d.att;
    }
  }
  // a block sums at most 512 lanes of at most 31 * 32 bits each
  bits = __reduce_add_sync(0xffffffffu, bits);
  att = __reduce_add_sync(0xffffffffu, att);
  if (wl == 0) {
    sums[0][threadIdx.x >> 5] = bits;
    sums[1][threadIdx.x >> 5] = att;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool w_in = threadIdx.x < (blockDim.x >> 5);
    bits = __reduce_add_sync(0xffffffffu, w_in ? sums[0][threadIdx.x] : 0u);
    att = __reduce_add_sync(0xffffffffu, w_in ? sums[1][threadIdx.x] : 0u);
    if (threadIdx.x == 0 && att) {  // att > 0 iff a lane was kept
      atomicAdd(p.acc, (unsigned long long)bits);
      atomicAdd(p.acc + 1, (unsigned long long)att);
    }
  }
}

// ---- plan source: one colour of a Bayes net, gathered from the states ---
// A node's record is 1 + C blocks of S = 4 + 2P int32 words: its own
// block [node, card, CPT offset, real children, P parent ids, P strides],
// then a block a child slot [CPT offset, stride of the node in the child's
// table, child id, stride of the child's own axis, P other-parent ids, P
// strides] (kernels/fused_sweep.py::pack_bn_plan).  A parent slot of
// stride 0 is padding; the child slots past the real ones are padding
// that reads the bank's sentinel, +0.0.
struct Plan {
  Walk c;
  int* x;                    // (B, n) int32 states; the colour's written
  long long n;               // states a chain
  const float* bank;         // the flat log-CPT bank
  long long bank_last;       // its last index: every gather is clipped to it
  const int* rec;            // (N, S * (1 + C)) records of the colour's nodes
  const float* beta;         // inverse temperature, null: none
  long long beta_chain;      // beta's stride between chains (0: shared)
  unsigned long long* acc;   // [bits, attempts] of the colour, added to
  unsigned long long lane0;  // global chain index of x's first chain
  long long lanes;           // B * N
  int B, N, P, C;
  float mask_value;
};

// blocks a plan launch takes at most: its groups walk lanes in a
// grid-stride loop, so a colour of any size adds at most 2 * kPlanBlocks
// atomics, and a block's sums stay under 2^32 (lanes < 2^31, 992 bits a
// lane); threads a block at most, and blocks an SM is to hold (the
// register bound this sets, 48 a thread, measured 4 % faster than the
// compiler's own 54, and than 40 or 32, which spill: PERF.md)
constexpr long long kPlanBlocks = 4096;
constexpr int kPlanThreads = 256;
constexpr int kPlanBlocksPerSM = 5;

__device__ __forceinline__ long long clip(long long i, long long last) {
  return i < 0 ? 0 : (i > last ? last : i);
}

// parent slots and child slots a group gathers at once: unrolled and
// guarded, so their loads go out together (2 children at once measured
// 3 % faster than one at a time or 4 or 8 at L 21: PERF.md)
constexpr int kUnrollP = 4;
constexpr int kChunkC = 2;

// sum of stride_j * x[id_j] over a record block's P parent slots, in 64
// bits as the plain path's int64 index tiles (a padded slot, id 0 and
// stride 0, adds 0, as there)
__device__ __forceinline__ long long parent_sum(const int* ids, int P,
                                                const int* xs) {
  long long s = 0;
#pragma unroll
  for (int j = 0; j < kUnrollP; ++j)
    if (j < P) s += (long long)ids[P + j] * xs[ids[j]];
  for (int j = kUnrollP; j < P; ++j) s += (long long)ids[P + j] * xs[ids[j]];
  return s;
}

template <int G>
__device__ __forceinline__ void gibbs_group(const Plan& p) {
  __shared__ unsigned sums[2][32];  // a warp's bits and attempts
  const int wl = threadIdx.x & 31;
  const int l = wl & (G - 1);
  const unsigned gmask = group_mask<G>(wl);
  const bool real = l < p.c.L;
  const int S = 4 + 2 * p.P;
  const long long R = (long long)S * (1 + p.C);
  const float ninf = __int_as_float((int)0xff800000);
  // lanes < 2^31 and at most 2^19 groups: 32-bit lane indices
  const unsigned groups = gridDim.x * (blockDim.x / G);
  unsigned bits = 0, att = 0;
  // the whole group takes each lane together: q is the group's
  for (unsigned q = (blockIdx.x * blockDim.x + threadIdx.x) / G;
       q < (unsigned)p.lanes; q += groups) {
    // lane q is node i of chain b, node-major
    const unsigned i = q / (unsigned)p.B;
    const unsigned b = q - i * (unsigned)p.B;
    const int* r = p.rec + i * R;
    int* xs = p.x + b * p.n;
    const int card = r[1], n_ch = r[3];
    // the own row's start, made by every thread so its loads go out with
    // the record's
    const long long own_row = r[2] + parent_sum(r + 4, p.P, xs);
    const bool valid = real && l < card;
    float lw = real ? p.mask_value : ninf;  // the label mask
    if (valid) {
      // own row, then the children's rows folded left to right as the
      // plain path's sum over C: t_0, + t_1, ..., one rounded add a slot
      const float own = p.bank[clip(own_row + l, p.bank_last)];
      float s = 0.0f;
      for (int c0 = 0; c0 < n_ch; c0 += kChunkC) {
        float t[kChunkC];
#pragma unroll
        for (int u = 0; u < kChunkC; ++u) {
          const int* cr = r + S * (1 + c0 + u);
          if (c0 + u < n_ch)
            t[u] = p.bank[clip(cr[0] + parent_sum(cr + 4, p.P, xs) +
                                   (long long)cr[3] * xs[cr[2]] +
                                   (long long)cr[1] * l,
                               p.bank_last)];
        }
#pragma unroll
        for (int u = 0; u < kChunkC; ++u)
          if (c0 + u < n_ch) s = c0 + u == 0 ? t[u] : __fadd_rn(s, t[u]);
      }
      // the padded slots each add +0.0: once is all of them (x + 0.0 is
      // x but for -0.0, which it makes +0.0); with none real s is +0.0
      if (n_ch > 0 && n_ch < p.C) s = __fadd_rn(s, 0.0f);
      lw = __fadd_rn(own, s);
    }
    if (p.beta != nullptr) {  // minus the max of the valid labels, times beta
      float m = valid ? lw : ninf;
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(gmask, m, off, G));
      if (valid) lw = __fmul_rn(__fsub_rn(lw, m), p.beta[b * p.beta_chain]);
    }
    const Dist dist = distribution<G>(p.c, lw, real, gmask, l);
    Draw d = bypass(dist);
    if (!dist.det)
      d = walk<G>(p.c, dist, real, gmask, wl,
                  (p.lane0 + b) * (unsigned long long)p.N + i);
    if (l == 0) {  // in place: no lane of an independent colour reads it
      xs[r[0]] = d.res;
      bits += d.t;
      att += d.att;
    }
  }
  bits = __reduce_add_sync(0xffffffffu, bits);
  att = __reduce_add_sync(0xffffffffu, att);
  if (wl == 0) {
    sums[0][threadIdx.x >> 5] = bits;
    sums[1][threadIdx.x >> 5] = att;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const bool w_in = threadIdx.x < (blockDim.x >> 5);
    bits = __reduce_add_sync(0xffffffffu, w_in ? sums[0][threadIdx.x] : 0u);
    att = __reduce_add_sync(0xffffffffu, w_in ? sums[1][threadIdx.x] : 0u);
    if (threadIdx.x == 0 && att) {  // att > 0 iff the block walked a lane
      atomicAdd(p.acc, (unsigned long long)bits);
      atomicAdd(p.acc + 1, (unsigned long long)att);
    }
  }
}

template <int G, class Source>
__global__ void fused_gibbs_group_kernel(const Source p) {
  gibbs_group<G>(p);
}

// the plan source's instantiations, with their register bound
#define PLAN_KERNEL(G)                                                   \
  template <>                                                            \
  __global__ void __launch_bounds__(kPlanThreads, kPlanBlocksPerSM)      \
      fused_gibbs_group_kernel<G, Plan>(const Plan p) {                  \
    gibbs_group<G>(p);                                                   \
  }
PLAN_KERNEL(2)
PLAN_KERNEL(4)
PLAN_KERNEL(8)
PLAN_KERNEL(16)
PLAN_KERNEL(32)
#undef PLAN_KERNEL

// blocks of a launch: one group a lane, or for the plan source at most
// kPlanBlocks, its groups looping over the lanes
template <class Source>
long long blocks_of(const Source& p, int G, int block) {
  return (p.lanes * G + block - 1) / block;
}

long long blocks_of(const Plan& p, int G, int block) {
  const long long need = (p.lanes * G + block - 1) / block;
  return need < kPlanBlocks ? need : kPlanBlocks;
}

template <int G, class Source>
int launch_group(const Source& p, int block, cudaStream_t stream) {
  const long long grid = blocks_of(p, G, block);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fused_gibbs_group_kernel<G, Source><<<(unsigned)grid, block, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int next_pow2(int x) {
  int g = 1;
  while (g < x) g <<= 1;
  return g;
}

// the launch at G = next_pow2(L) threads a lane (at least 2)
template <class Source>
int launch(const Source& p, int block, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (p.c.L < 2 ? 2 : next_pow2(p.c.L)) {
    case 2: return launch_group<2>(p, block, s);
    case 4: return launch_group<4>(p, block, s);
    case 8: return launch_group<8>(p, block, s);
    case 16: return launch_group<16>(p, block, s);
    default: return launch_group<32>(p, block, s);
  }
}

bool bad_shape(int L, int W, int block) {
  return L < 1 || L > MAX_L || W < 1 || block < 32 || block > 1024 ||
         block % 32;
}

}  // namespace

// block: threads per block, a multiple of 32.  k0, k1: the colour's key
// words; lane0: the global row of lane 0 (0 unless the launch is a lane
// shard), or with a row map its first chain; colpos, n_loc, row_stride: the
// row map (colpos null for none; b a multiple of n_loc); W: words of bit
// budget per lane.  The grid is b * next_pow2(L) threads (at least 2 a
// lane), sized and indexed in 64 bits (kernels/fused_sweep.py::
// launch_geometry is its Python twin).
extern "C" int fused_gibbs_sample_launch(
    const void* logw, const void* card, uint32_t k0, uint32_t k1,
    unsigned long long lane0, const void* colpos, long long n_loc,
    unsigned long long row_stride, const void* table, void* sample,
    void* bits, void* att, void* ok, int b,
    int L, int W, float wscale, int use_iu, int n_seg, float lo, float scale,
    float mask_value, int block, void* stream) {
  if (b <= 0) return 0;
  if (bad_shape(L, W, block)) return (int)cudaErrorInvalidValue;
  if (colpos != nullptr && (n_loc < 1 || b % n_loc))
    return (int)cudaErrorInvalidValue;
  const Walk c{static_cast<const float*>(table), k0, k1, L, W, wscale,
               use_iu, n_seg, lo, scale};
  const Gathered p{c, static_cast<const float*>(logw),
                   static_cast<const int*>(card), static_cast<int*>(sample),
                   static_cast<int*>(bits), static_cast<int*>(att),
                   static_cast<bool*>(ok), lane0,
                   static_cast<const long long*>(colpos), n_loc, row_stride,
                   b, mask_value};
  return launch(p, block, stream);
}

// One checkerboard colour update of the (B, H, width) int32 labels in
// place: unary (H, width, L) and pairwise (L, L) float32; clamp (bool,
// null for none) with clamp_chain 0 for an (H, width) mask or H * width
// for a (B, H, width) one; beta (float32, null for none) with beta_chain 0
// for one value or 1 for one a chain; acc two int64 sums (bits, attempts)
// the kept sites are added to; lane0 the global row of site (0, 0, 0).
// B * H * ceil(width / 2) lanes of next_pow2(L) threads (at least 2),
// launched on `stream` of card `device` (made current for the launch and
// restored after).  The arguments that change from one colour update of
// a field to the next come last.  kernels/fused_sweep.py::
// fused_mrf_launcher checks what this refuses.
extern "C" int fused_mrf_halfstep_launch(
    void* labels, const void* unary, const void* pairwise, const void* clamp,
    long long clamp_chain, const void* beta, long long beta_chain, void* acc,
    unsigned long long lane0, const void* table, int B, int H, int width,
    int L, int W, float wscale, int use_iu, int n_seg, float lo, float scale,
    int block, int device, void* stream, uint32_t k0, uint32_t k1,
    int parity) {
  if (B <= 0 || H <= 0 || width <= 0) return 0;
  if (bad_shape(L, W, block) || (parity & ~1))
    return (int)cudaErrorInvalidValue;
  const int half = (width + 1) / 2;
  const long long lanes = (long long)B * H * half;
  if (lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Walk c{static_cast<const float*>(table), k0, k1, L, W, wscale,
               use_iu, n_seg, lo, scale};
  const Grid p{c, static_cast<int*>(labels),
               static_cast<const float*>(unary),
               static_cast<const float*>(pairwise),
               static_cast<const bool*>(clamp), clamp_chain,
               static_cast<const float*>(beta), beta_chain,
               static_cast<unsigned long long*>(acc), lane0, lanes, H, width,
               half, parity};
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch(p, block, stream);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}

// One colour update of a Bayes net's (B, n) int32 states in place: the
// colour's N nodes in every chain, each lane's log-weights gathered from
// the flat float32 bank of bank_n entries by its record (rec, (N, (4 +
// 2P)(1 + C)) int32), the new states written, the lanes' bits and attempts
// added to acc (two int64).  beta (float32, null for none) with
// beta_chain 0 for one value or 1 for one a chain; lane0 the global index
// of the first chain: lane (b, i) reads the words of global row (lane0 +
// b) * N + i.  B * N lanes of next_pow2(L) threads (at least 2), launched
// on `stream` of card `device` (made current for the launch and restored
// after).  The arguments that change from one colour to the next come
// last.  kernels/fused_sweep.py::fused_bn_launcher checks what this
// refuses.
extern "C" int fused_bn_update_launch(
    void* x, long long n, const void* bank, long long bank_n,
    const void* beta, long long beta_chain, void* acc,
    unsigned long long lane0, const void* table, int B, int P, int C, int L,
    int W, float wscale, int use_iu, int n_seg, float lo, float scale,
    float mask_value, int block, int device, void* stream,
    const void* rec, int N, uint32_t k0, uint32_t k1) {
  if (B <= 0 || N <= 0) return 0;
  if (bad_shape(L, W, block) || block > kPlanThreads || P < 1 || C < 1 ||
      n < 1 || bank_n < 1)
    return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * N;
  if (lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Walk c{static_cast<const float*>(table), k0, k1, L, W, wscale,
               use_iu, n_seg, lo, scale};
  const Plan p{c, static_cast<int*>(x), n, static_cast<const float*>(bank),
               bank_n - 1, static_cast<const int*>(rec),
               static_cast<const float*>(beta), beta_chain,
               static_cast<unsigned long long*>(acc), lane0, lanes, B, N, P,
               C, mask_value};
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch(p, block, stream);
  if (prev != device) cudaSetDevice(prev);
  return rc;
}
