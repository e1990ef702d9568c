// Stand-alone LUT interpolation unit (IU) kernel for Hopper (sm_90a):
// element-wise piecewise-linear interpolation over a float32 tensor.
//
// Replaces: src/repro/kernels/interp_lut.py::_interp_kernel, the TPU
// Pallas kernel launched by interp_pallas (pallas_call at interp_lut.py:61)
// and wrapped by kernels/ops.py::interp_kernel.
//
// Per element, every stage one separately rounded float32 op (the
// intrinsics below, and the library is built with --fmad=false besides):
//   t    = clip((x - lo) * scale, 0, n_seg)      scale = n_seg / (hi - lo)
//   idx  = min(trunc(t), n_seg - 1)
//   frac = t - idx
//   y    = y0 + frac * (y1 - y0)                 y0, y1 = LUT[idx], LUT[idx+1]
// That is bitwise the plain version (kernels/ref.py::interp_ref) and JAX's
// eager interp_ref.  JAX's jitted kernel differs by 1 ulp on some inputs:
// XLA contracts the last line into an FMA under jit.
//
// Bound on an H100: bytes.  8 bytes per element (read x, write y) plus
// the table once, at 3.35 TB/s: 10 us for a 4096 x 1024 tile.  ~8 flops
// per element is far under the card's rates.
//
// Design: the table (n_seg + 1 <= 1025 nodes, 4.1 kB) is copied into each
// block's shared memory, as the TPU kernel pins it in VMEM; the blocks
// stride over the elements (a few blocks per SM, so the table is read a
// few hundred times, not once per 256 elements).  Left on the table:
// 16-byte vector loads and stores, and deeper loads in flight per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void interp_lut_kernel(const float* __restrict__ x,
                                  const float* __restrict__ table,
                                  float* __restrict__ y, long long numel,
                                  int n_seg, float lo, float scale) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i <= n_seg; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const float fn = (float)n_seg;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < numel; i += stride) {
    float t = __fmul_rn(__fsub_rn(x[i], lo), scale);
    t = fminf(fmaxf(t, 0.0f), fn);
    int idx = __float2int_rz(t);
    if (idx > n_seg - 1) idx = n_seg - 1;
    const float frac = __fsub_rn(t, (float)idx);
    const float y0 = tab[idx];
    const float y1 = tab[idx + 1];
    y[i] = __fadd_rn(y0, __fmul_rn(frac, __fsub_rn(y1, y0)));
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

}  // namespace

extern "C" int interp_lut_launch(const void* x, const void* table, void* y,
                                 long long numel, int n_seg, float lo,
                                 float scale, int block, void* stream) {
  if (numel <= 0) return 0;
  if (n_seg < 1 || n_seg > 8192 || block < 32 || block > 1024)
    return (int)cudaErrorInvalidValue;
  long long grid = (numel + block - 1) / block;
  const long long cap = (long long)sm_count() * (2048 / block);
  if (grid > cap) grid = cap;
  const size_t smem = sizeof(float) * (size_t)(n_seg + 1);
  interp_lut_kernel<<<(int)grid, block, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(table),
      static_cast<float*>(y), numel, n_seg, lo, scale);
  return (int)cudaGetLastError();
}
