// K4: blockwise (flash) attention forward for Hopper (sm_90a), with a plain
// C interface for ctypes.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel`: for every
// (batch, head) and query row, softmax(q k^T / sqrt(hd)) v with causal
// masking shifted by `q_offset` (decode), an optional sliding `window`,
// keys past Tk masked, f32 statistics and accumulation, and the output in
// the input's type.  Masked scores are the TPU kernel's finite -1e30, not
// -inf: under a window a query's first key block can be fully masked, which
// folds exp(0) terms into the running sums; the next real block's
// alpha = exp(-1e30 - m) multiplies them by exactly 0.  With -inf that
// step would be NaN.
//
// Design: one block of 128 threads per (b*h, 64-row query block).  The
// query tile (scaled by 1/sqrt(hd) in f32, as the TPU kernel scales q), a
// 64-key K tile and a 64-key V tile are staged in shared memory as f32;
// each thread owns 4 query rows x 8 key columns of the score tile and the
// same 4 rows x hd/8 output columns, so the running (m, denom) of a row
// live in the 8 threads of one warp that share it and reduce with three
// xor shuffles.  Key blocks past a query block's causal limit are skipped,
// as the TPU kernel's `last` skips them.  q, k, v and o are read and
// written in the model layout (B, T, H, hd) through their strides, so the
// caller transposes nothing.  hd may be any size up to 256; the template
// takes the next of 64, 128, 256 as the register tile.
//
// Bound: causal attention at the LM's prefill shape (64 heads x 1024
// positions, hd 64) does 4 hd T(T+1)/2 flop per head over ~33 MB of
// bf16 in and out, so the card's bf16 tensor rate and its memory rate
// bound it near 0.01 ms.  This kernel runs on the f32 CUDA cores from
// shared memory (two loads per FMA pair in the score loop) and is far
// above that bound.  It is K4's route for f32 (whose 2e-5 tolerance the
// bf16 tensor cores cannot meet), for hd in (128, 256] and for layouts
// TMA does not take; bf16 with hd <= 128 runs flash_attention_sm90.cu.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;     // 16 row groups x 8 column groups
constexpr int kRows = 4;          // query rows per thread: ty + 16 i
constexpr int kCols = 8;          // key columns per thread: tx + 8 j
constexpr float kNegInf = -1e30f;
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

struct Strides {
  long long b, t, h;   // elements; the head-dim stride is 1
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBlockQ * (HD + 1) + kBlockK * (HD + 1) +
                          kBlockK * HD + kBlockQ * (kBlockK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int Tq, int Tk,
    int hd, Strides qs, Strides ks, Strides vs, Strides os, bool causal,
    int q_offset, bool has_window, int window, float scale) {
  constexpr int LD = HD + 1;          // padded rows: no bank conflicts
  constexpr int LP = kBlockK + 1;
  constexpr int DC = HD / 8;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                   // (kBlockQ, LD), scaled q
  float* Ks = Qs + kBlockQ * LD;      // (kBlockK, LD)
  float* Vs = Ks + kBlockK * LD;      // (kBlockK, HD), zero past hd
  float* Ps = Vs + kBlockK * HD;      // (kBlockQ, LP) probabilities

  const int qi = blockIdx.x;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kbase = k + b * ks.b + h * ks.h;
  const T* vbase = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int q0 = qi * kBlockQ;

  for (int e = tid; e < kBlockQ * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    const int t = q0 + r;
    Qs[r * LD + d] = t < Tq ? to_f32(qb[t * qs.t + d]) * scale : 0.0f;
  }

  float m[kRows], den[kRows], acc[kRows][DC];
  int q_pos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    den[i] = 0.0f;
    q_pos[i] = q_offset + q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  const int n_kb = (Tk + kBlockK - 1) / kBlockK;
  int last = n_kb;
  if (causal) {
    const long long lim =
        ((long long)q_offset + (long long)(qi + 1) * kBlockQ + kBlockK - 1) /
        kBlockK;
    last = lim < n_kb ? (int)lim : n_kb;
  }

  for (int kb = 0; kb < last; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();                  // the last tile's readers are done
    for (int e = tid; e < kBlockK * HD; e += kThreads) {
      const int r = e / HD;
      const int d = e - r * HD;
      const int t = k0 + r;
      const bool in = t < Tk && d < hd;
      if (d < hd) Ks[r * LD + d] = in ? to_f32(kbase[t * ks.t + d]) : 0.0f;
      Vs[r * HD + d] = in ? to_f32(vbase[t * vs.t + d]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = k0 + tx + 8 * j;
        bool ok = k_pos < Tk;
        if (causal) ok = ok && k_pos <= q_pos[i];
        if (has_window) ok = ok && k_pos > q_pos[i] - window;
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * LP + tx + 8 * j] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      den[i] = den[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float vv[DC];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) vv[cc] = Vs[c * HD + tx + 8 * cc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int cc = 0; cc < DC; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
    const float dn = fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int d = tx + 8 * cc;
      if (d < hd) ob[t * os.t + d] = from_f32<T>(acc[i][cc] / dn);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Tq, int Tk, int hd, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int q_offset, int has_window, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_kernel<T, HD>;
  // Raise the kernel's shared-memory cap once per device, not per launch.
  static unsigned set_on = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32 || !(set_on & (1u << dev))) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 32) set_on |= 1u << dev;
  }
  const dim3 grid((Tq + kBlockQ - 1) / kBlockQ, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Tq, Tk, hd, qs, ks,
      vs, os, causal != 0, q_offset, has_window != 0, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Tq, int Tk, int hd, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int q_offset,
                int has_window, int window, float scale,
                cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Tq, Tk, hd, qs, ks, vs, os,
                         causal, q_offset, has_window, window, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Tq, Tk, hd, qs, ks, vs, os,
                          causal, q_offset, has_window, window, scale, stream);
  return launch<T, 256>(q, k, v, o, B, H, Tq, Tk, hd, qs, ks, vs, os, causal,
                        q_offset, has_window, window, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements for the batch, time and head axes of (B, T, H, hd) tensors.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int B, int H, int Tq, int Tk, int hd,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    long long o_sb, long long o_st, long long o_sh,
                    int causal, int q_offset, int has_window, int window,
                    float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || hd <= 0 || hd > 256 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, os{o_sb, o_st, o_sh};
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, B, H, Tq, Tk, hd, qs, ks, vs, os,
                              causal, q_offset, has_window, window, scale,
                              stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, B, H, Tq, Tk, hd, qs, ks,
                                      vs, os, causal, q_offset, has_window,
                                      window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
