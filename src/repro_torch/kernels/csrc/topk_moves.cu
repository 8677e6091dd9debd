// K3: top-k move nomination for the assignment engine, for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces src/repro/kernels/topk_moves.py `_topk_kernel`.  For each cell
// it scores every single-user move n: s -> m by the airtime it adds at the
// equal-split reference bandwidth b_ref = B / n_act,
//
//   score(n, m) = a(n, m) (1 + (c_m + 1)/n_act) - a(n, s) (1 + c_s/n_act),
//   a(n, m)     = H_n / log2(1 + g(n, m) p_max_n / (N0 b_ref)),
//
// with 1e30 for the own edge and for masked users, then keeps the k
// smallest scores in k rounds of argmin-and-knock-out (ties to the lowest
// flat index n*M + m).
//
// Design: one block per cell.  The (N, M) score tile lives in shared
// memory; the per-edge loads c_m and the active count come from one pass of
// shared-memory atomics (exact: integer counts in float); each round is a
// block-wide lexicographic (score, index) argmin — warp shuffles, then one
// warp over the per-warp winners — so the result does not depend on the
// order threads run in.  Bound: it reads N*M + 4N floats per cell and does
// k passes over the tile; at the engine's shapes (N*M ~ 280, k = 8) it is
// a few microseconds of launch and block-barrier latency, far from either
// the memory or the arithmetic roof.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;

// Lexicographic (value, index) minimum: the smaller score, ties to the
// smaller flat index.
__device__ __forceinline__ void lex_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void topk_moves_kernel(const float* __restrict__ gain,
                                  const float* __restrict__ H,
                                  const float* __restrict__ p_max,
                                  const int* __restrict__ assign,
                                  const bool* __restrict__ mask,
                                  const float* __restrict__ N0,
                                  const float* __restrict__ B,
                                  int* __restrict__ user_out,
                                  int* __restrict__ dst_out,
                                  float* __restrict__ score_out,
                                  int N, int M, int k) {
  extern __shared__ float smem[];
  float* score = smem;         // (N * M) move scores
  float* load = smem + N * M;  // (M) active users per edge
  __shared__ float n_active;
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];

  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t urow = (size_t)q * N;
  const size_t grow = urow * M;
  const int NM = N * M;

  for (int m = tid; m < M; m += blockDim.x) load[m] = 0.0f;
  if (tid == 0) n_active = 0.0f;
  __syncthreads();
  for (int n = tid; n < N; n += blockDim.x) {
    if (mask[urow + n]) {
      atomicAdd(&n_active, 1.0f);
      const int s = assign[urow + n];
      if (s >= 0 && s < M) atomicAdd(&load[s], 1.0f);
    }
  }
  __syncthreads();

  const float n_act = fmaxf(n_active, 1.0f);
  const float b_ref = B[q] / n_act;
  const float noise = fmaxf(N0[q] * b_ref, 1e-30f);
  for (int e = tid; e < NM; e += blockDim.x) {
    const int n = e / M;
    const int m = e - n * M;
    const int s = assign[urow + n];
    float sc = kBig;
    if (mask[urow + n] && m != s) {
      const float Hn = H[urow + n];
      const float pm = p_max[urow + n];
      const float se = log1pf(gain[grow + e] * pm / noise) / kLn2;
      const float a = Hn / fmaxf(se, 1e-9f);
      float a_src = 0.0f, c_src = 0.0f;
      if (s >= 0 && s < M) {
        const float se_s = log1pf(gain[grow + (size_t)n * M + s] * pm / noise)
                           / kLn2;
        a_src = Hn / fmaxf(se_s, 1e-9f);
        c_src = load[s];
      }
      sc = a * (1.0f + (load[m] + 1.0f) / n_act)
           - a_src * (1.0f + c_src / n_act);
    }
    score[e] = sc;
  }
  __syncthreads();

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = blockDim.x / 32;
  for (int r = 0; r < k; ++r) {
    float v = INFINITY;
    int i = 0x7fffffff;
    for (int e = tid; e < NM; e += blockDim.x) lex_min(v, i, score[e], e);
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, off);
      const int oi = __shfl_down_sync(kFull, i, off);
      lex_min(v, i, ov, oi);
    }
    if (lane == 0) {
      wv[warp] = v;
      wi[warp] = i;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < nwarps; ++w) lex_min(v, i, wv[w], wi[w]);
      user_out[(size_t)q * k + r] = i / M;
      dst_out[(size_t)q * k + r] = i % M;
      score_out[(size_t)q * k + r] = v;
      score[i] = kBig;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int topk_moves(const float* gain, const float* H, const float* p_max,
               const int* assign, const bool* mask, const float* N0,
               const float* B, int* user_out, int* dst_out,
               float* score_out, int P, int N, int M, int k,
               cudaStream_t stream) {
  if (P <= 0 || k <= 0) return 0;
  if (N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)N * M + M) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_moves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  topk_moves_kernel<<<P, kThreads, smem, stream>>>(
      gain, H, p_max, assign, mask, N0, B, user_out, dst_out, score_out, N,
      M, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
