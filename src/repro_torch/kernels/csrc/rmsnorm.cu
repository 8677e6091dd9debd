// K5: fused RMSNorm for Hopper (sm_90a), with a plain C interface for
// ctypes.
//
// Replaces src/repro/kernels/rmsnorm.py `_rmsnorm_kernel`: per row of a
// (rows, d) tensor, y = x * rsqrt(mean(x^2) + eps) * scale, all in f32, cast
// to the input's type last.
//
// Bound: it reads each row and writes it once, a few flop an element, so it
// is memory-bound at the card's 3.35 TB/s (about 5 us for the LM's
// 4096 x 1024 bf16 hidden states).
//
// Design: one warp per row, eight rows per block.  When d is a multiple of
// the 16-byte vector (8 bf16 or 4 f32 values), the row splits into 16-byte
// chunks and lane l loads chunks l, l + 32, ... with one 16-byte load each,
// so a warp load is 512 contiguous bytes.  With at most kMaxChunks chunks
// a lane (bf16 d <= 8192, f32 d <= 4096) the row stays in registers between
// the sum of squares and the scale, so x is read from memory once; above
// that the lane loops over its chunks and reads them again for the scale.
// The scale is read as f32 vectors.  The sum adds, in each lane, its
// chunks in turn and the elements of a chunk in order, then five xor
// shuffles (16, 8, 4, 2, 1) add the lanes.  A d that is not a multiple of
// the vector takes the scalar path: lane l adds x[l], x[l + 32], ... (the
// order of a one-element chunk).  The plain twin (`ref.rmsnorm_plain`,
// through `ref.chunk_sum_plain`) adds the same numbers in the same order.
// The mean is a true division by d, then rsqrtf.  The wrapper hands over
// 16-byte-aligned x, scale and out on the vector path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxChunks = 32;    // 16-byte chunks a lane keeps in registers
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

// One 16-byte chunk as f32 values, and back.
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Chunk c of the scale, as f32 (V values from 16-byte-aligned float4s).
template <int V>
__device__ __forceinline__ void load_scale(const float4* s, int c,
                                           float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 f = s[c * (V / 4) + i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(kFull, a, off);
  return a;
}

template <int V>
__device__ __forceinline__ void add_squares(float& a, const uint4& u) {
  float v[V];
  unpack(u, v);
#pragma unroll
  for (int e = 0; e < V; ++e) a += v[e] * v[e];
}

template <int V>
__device__ __forceinline__ uint4 scaled(const uint4& u, const float4* s,
                                        int c, float r) {
  float v[V], w[V];
  unpack(u, v);
  load_scale<V>(s, c, w);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = (v[e] * r) * w[e];
  return pack(v);
}

// The vector path.  NC > 0: up to NC chunks a lane, kept in registers
// (one read of x); NC == 0: any number, read twice.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) rmsnorm_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;            // whole warps leave together
  const int C = d / V;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
  const float4* sv = reinterpret_cast<const float4*>(scale);
  float a = 0.0f;
  if constexpr (NC > 0) {
    uint4 buf[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane + 32 * i < C) buf[i] = xr[lane + 32 * i];
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane + 32 * i < C) add_squares<V>(a, buf[i]);
    const float r = rsqrtf(warp_sum(a) / (float)d + eps);
#pragma unroll
    for (int i = 0; i < NC; ++i)
      if (lane + 32 * i < C)
        orow[lane + 32 * i] = scaled<V>(buf[i], sv, lane + 32 * i, r);
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += 32) add_squares<V>(a, xr[c]);
    const float r = rsqrtf(warp_sum(a) / (float)d + eps);
#pragma unroll 4
    for (int c = lane; c < C; c += 32) orow[c] = scaled<V>(xr[c], sv, c, r);
  }
}

// The scalar path, for a d that is not a multiple of the vector.
template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_scalar_kernel(
    const T* __restrict__ x, const float* __restrict__ scale,
    T* __restrict__ out, long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float a = 0.0f;
#pragma unroll 8
  for (int e = lane; e < d; e += 32) {
    const float xv = to_f32(xr[e]);
    a += xv * xv;
  }
  const float r = rsqrtf(warp_sum(a) / (float)d + eps);
#pragma unroll 8
  for (int e = lane; e < d; e += 32) {
    const float y = to_f32(xr[e]) * r;
    orow[e] = from_f32<T>(y * scale[e]);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, long long rows,
           int d, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const unsigned grid = (unsigned)blocks;
  if (d % V != 0) {
    rmsnorm_scalar_kernel<T><<<grid, kThreads, 0, stream>>>(xt, scale, ot,
                                                             rows, d, eps);
    return (int)cudaGetLastError();
  }
  if (((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int per_lane = (d / V + 31) / 32;
#define RMSNORM_VEC(NC)                                                   \
  rmsnorm_vec_kernel<T, NC><<<grid, kThreads, 0, stream>>>(xt, scale, ot, \
                                                           rows, d, eps)
  if (per_lane <= 1) RMSNORM_VEC(1);
  else if (per_lane <= 2) RMSNORM_VEC(2);
  else if (per_lane <= 4) RMSNORM_VEC(4);
  else if (per_lane <= 8) RMSNORM_VEC(8);
  else if (per_lane <= 16) RMSNORM_VEC(16);
  else if (per_lane <= kMaxChunks) RMSNORM_VEC(kMaxChunks);
  else RMSNORM_VEC(0);
#undef RMSNORM_VEC
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
