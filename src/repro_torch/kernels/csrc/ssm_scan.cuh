// What csrc/ssm_scan.cu (S1-S3, the recurrences) and csrc/ssm_scan_bwd.cu
// (S1b-S3b, their backward) share: the step lengths of the chunks, the
// checkpoint intervals of the forward kernels' saving variants (equal to
// kernels/ssm_scan.py's S1B_CKPT and S2B_CKPT), the twin's scalar
// formulas and JAX's gradient shares, and the warp sums.  csrc/
// mlstm_chunked.cu reads S2's checkpoints and takes the same formulas.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kS1Chunk = 32;    // S1's time steps a staged chunk
constexpr int kS1Ckpt = 8;      // S1's saved state interval (S1B_CKPT)
constexpr int kS2Chunk = 16;    // S2's, and its saved state interval
constexpr int kS2Cols = 32;     // S2's columns of C a block (or all of hd)
constexpr int kS3Cluster = 8;   // S3's blocks a (b, h)

__device__ __forceinline__ float quad_sum(float a) {
  a = __fadd_rn(a, __shfl_xor_sync(kFull, a, 1));
  return __fadd_rn(a, __shfl_xor_sync(kFull, a, 2));
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(kFull, a, off));
  return a;
}

// The twin's formulas (models/ssm.py, jax.nn): softplus(x) = max(x, 0) +
// log1p(exp(-|x|)), log_sigmoid(x) = -softplus(-x), sigmoid(x) = 1 / (1 +
// exp(-x)).
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return -softplus(-x);
}
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// JAX's gradient shares: d max(a, b) / da (all to the larger, half at a
// tie), and sign(x) with sign(0) = 0.
__device__ __forceinline__ float max_share(float a, float b) {
  return a > b ? 1.0f : (a == b ? 0.5f : 0.0f);
}
__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

}  // namespace
