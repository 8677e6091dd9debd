// K5: fused RMSNorm for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces src/repro/kernels/rmsnorm.py `_rmsnorm_kernel`: per row of a
// (rows, d) tensor, y = x * rsqrt(mean(x^2) + eps) * scale, all in f32, cast
// to the input's type last.
//
// Design: one warp per row, eight rows per block.  Lane l adds the squares
// of x[l], x[l + 32], ... in turn, then five xor shuffles (16, 8, 4, 2, 1)
// add the lanes; the order is fixed, so the plain twin
// (`ref.rmsnorm_plain`, through `warp_sum_plain`) adds the same numbers in
// the same order (the loops are unrolled for loads in flight, not
// reordered).  The mean is a true division by d, then rsqrtf; the second
// pass reads the row again (from L1/L2) to scale it.
//
// Bound: it reads the row and writes it once, 4 bytes a value of work per
// element at most: memory-bound at the card's 3.35 TB/s (about 5 us for the
// LM's 4096 x 1024 bf16 hidden states).  Lanes read 2- or 4-byte values 32
// apart, so each warp load is one 64- or 128-byte transaction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, long long rows, int d,
                               float eps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;            // whole warps leave together
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float a = 0.0f;
#pragma unroll 8
  for (int e = lane; e < d; e += 32) {
    const float xv = to_f32(xr[e]);
    a += xv * xv;
  }
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  const float r = rsqrtf(a / (float)d + eps);
#pragma unroll 8
  for (int e = lane; e < d; e += 32) {
    const float y = to_f32(xr[e]) * r;
    orow[e] = from_f32<T>(y * scale[e]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out share it); scale is f32 (d,).
int rmsnorm(const void* x, const float* scale, void* out, int dtype,
            long long rows, int d, float eps, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, scale, out, rows, d, eps, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
