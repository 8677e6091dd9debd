// S1-S3: the recurrences of the hybrid and xlstm families for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// No Pallas kernel is replaced: each replaces a `lax.scan` of the JAX
// package's src/repro/models/ssm.py, which XLA keeps on the device as one
// loop.  Each kernel runs the plain twin's sequential recurrence (kernels/
// ref.py: mamba2_, mlstm_ and slstm_recurrence_plain) for the whole
// sequence in one launch, with the state on the chip: one block (S1, S2)
// or one cluster (S3) a (batch row, head) walks the T steps in order.
// Every state update takes the twin's roundings in the twin's order (the
// file is built with --fmad=false: no multiply-add is contracted), so a
// state whose update reads no sum (S1's) is bitwise the twin's; the
// read-outs and S3's recurrence product are sums in another order than
// cuBLAS's or the CPU's.  expf, log1pf and tanhf are the toolkit's
// full-precision functions, in the twin's formulas.
//
// Bound.  Each kernel reads its operands and writes y once: S1 at zamba2's
// (B, T, H, ds, hd) = (4, 1024, 112, 64, 64) moves ~250 MB (0.075 ms at
// 3.35 TB/s) and does ~9.4 GFLOP of float32 arithmetic on the state
// (0.14 ms at 67 TFLOP/s): operations bound it.  What bounds these designs
// is the chain of T dependent steps: each step waits on the last, so a
// block's time is T times one step's latency, and only (batch x heads)
// blocks run at once.
//
// * S1 `mamba2_scan_kernel<ROWS>` (ds = 4 ROWS): one block a (b, h), 4 hd
//   threads.  Lane quad c of warp w owns column j = 8 w + c of the
//   (ds, hd) state, each lane rows i = 4 m + r (r its place in the quad,
//   m < ROWS) in registers: 16 a thread at zamba2's width.  A chunk of
//   kS1Chunk steps of B_t, C_t, (dt x)_t of this head and the decay is
//   staged in shared memory; a step is s = s * decay + B_t * u_t (three
//   roundings, as the twin) and y_t[j] = sum_i C_t[i] s[i][j], each lane's
//   rows in order, then the quad's two xor shuffles.
// * S2 `mlstm_scan_kernel<ROWS>` (hd = 4 ROWS): C's columns are
//   independent (num[v] reads column v alone), so the grid splits them:
//   one block a (b, h, slice of kS2Cols columns), 4 threads a column
//   (C in registers, 48 a thread at hd 192) and one more warp that keeps
//   n (hd / 32 rows a lane) and the denominator max(|q . n|, 1) of each
//   step.  Every thread carries the stabiliser m and the step's f and i
//   itself (the same arithmetic everywhere, so the same bits), so no
//   barrier falls inside a chunk; the numerators and denominators of a
//   chunk meet in shared memory and y = num / den is written at its end.
//   96 blocks at xlstm-125m's (B, H, hd) = (4, 4, 192) rather than 16
//   blocks of one (b, h) each: n and the gates are recomputed six times,
//   a few percent of the work.
// * S3 `slstm_scan_kernel<ROWS>` (hd = 4 ROWS): the step's h_{t-1} . R
//   reads (hd, 4 hd) of f32 a head (590 KB at hd 192), more than one SM
//   holds.  A cluster of 8 blocks a (b, h) splits it: block q owns state
//   elements E q .. E q + E - 1 (E = hd / 8) and the 4 E columns of R that
//   produce their four gates, held in registers (hd / 4 a thread, 48 at
//   hd 192; 4 threads a column).  A step: each quad sums its column, E
//   threads update c, n, m, h of their element and store h into every
//   block's next h buffer (distributed shared memory), and one cluster
//   barrier (release / acquire) publishes them.  The h buffers alternate,
//   so a store for step t + 1 never meets a read of step t.  A cluster
//   barrier comes before the first remote store (the other blocks may not
//   have started), and none follows the last.  Each element's next inputs
//   are loaded a step ahead.
//
// Saving variants (template flag SAVE), for the backward kernels of
// csrc/ssm_scan_bwd.cu: the same kernel, the same arithmetic, but instead
// of y and the final state it writes what the reverse pass reads.  S1 the
// state before every kS1Ckpt-th step, S2 C, n and m before every chunk of
// kS2Chunk steps, S3 every step's c, n, m and the four pre-activations;
// each in the layout its reader takes (S1's and S2's: a thread's own
// registers, contiguous across the block, so both sides coalesce).
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"
#include "ssm_scan.cuh"

namespace {

// ------------------------------------------------------------ S1 Mamba2
template <int ROWS, bool SAVE>
__global__ void __launch_bounds__(1024) mamba2_scan_kernel(
    const float* __restrict__ decay, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dtx,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ sT, float* __restrict__ ckpt, int T, int H,
    int hd) {
  constexpr int DS = 4 * ROWS;
  extern __shared__ float smem[];
  float* sB = smem;                            // [kS1Chunk][DS]
  float* sC = sB + kS1Chunk * DS;              // [kS1Chunk][DS]
  float* sU = sC + kS1Chunk * DS;              // [kS1Chunk][hd]
  float* sDec = sU + kS1Chunk * hd;            // [kS1Chunk]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int j = tid >> 2, r = tid & 3;
  const long long st = ((long long)b * H + h) * DS * hd;
  float s[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    s[m] = s0[st + (long long)(4 * m + r) * hd + j];
  for (int t0 = 0; t0 < T; t0 += kS1Chunk) {
    const int n = min(kS1Chunk, T - t0);
    __syncthreads();                 // the last chunk's reads are done
    for (int e = tid; e < n * DS; e += nthr) {
      const long long row = (long long)b * T + t0 + e / DS;
      sB[e] = Bm[row * DS + e % DS];
      sC[e] = Cm[row * DS + e % DS];
    }
    for (int e = tid; e < n * hd; e += nthr)
      sU[e] = dtx[(((long long)b * T + t0 + e / hd) * H + h) * hd + e % hd];
    for (int e = tid; e < n; e += nthr)
      sDec[e] = decay[((long long)b * T + t0 + e) * H + h];
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      if (SAVE && (t0 + tt) % kS1Ckpt == 0) {   // the state before step t
        float* cp = ckpt + ((long long)blockIdx.x * ((T + kS1Ckpt - 1) /
                                                     kS1Ckpt) +
                            (t0 + tt) / kS1Ckpt) * ROWS * nthr;
#pragma unroll
        for (int m = 0; m < ROWS; ++m) cp[m * nthr + tid] = s[m];
      }
      const float dec = sDec[tt], u = sU[tt * hd + j];
      const float* Bt = sB + tt * DS;
      const float* Ct = sC + tt * DS;
      float acc = 0.0f;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int i = 4 * m + r;
        s[m] = __fadd_rn(__fmul_rn(s[m], dec), __fmul_rn(Bt[i], u));
        if (!SAVE) acc = __fadd_rn(acc, __fmul_rn(Ct[i], s[m]));
      }
      if (!SAVE) {
        acc = quad_sum(acc);
        if (r == 0)
          y[(((long long)b * T + t0 + tt) * H + h) * hd + j] = acc;
      }
    }
  }
  if (SAVE) return;
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    sT[st + (long long)(4 * m + r) * hd + j] = s[m];
}

template <int ROWS, bool SAVE>
int launch_mamba2(const float* decay, const float* Bm, const float* Cm,
                  const float* dtx, const float* s0, float* y, float* sT,
                  float* ckpt, int B, int T, int H, int hd,
                  cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kS1Chunk * (2 * 4 * ROWS + hd) + kS1Chunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_kernel<ROWS, SAVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mamba2_scan_kernel<ROWS, SAVE><<<B * H, 4 * hd, smem, stream>>>(
      decay, Bm, Cm, dtx, s0, y, sT, ckpt, T, H, hd);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- S2 mLSTM
template <int ROWS, bool SAVE>
__global__ void __launch_bounds__(4 * kS2Cols + 32) mlstm_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, const float* __restrict__ C0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    float* __restrict__ y, float* __restrict__ Cout,
    float* __restrict__ nout, float* __restrict__ mout,
    float* __restrict__ Cck, float* __restrict__ nck,
    float* __restrict__ mck, int T, int H, int cols) {
  constexpr int HD = 4 * ROWS;
  constexpr int NP = (HD + 31) / 32;           // n's rows a lane
  __shared__ float sQ[kS2Chunk][HD], sK[kS2Chunk][HD];
  __shared__ float sV[kS2Chunk][kS2Cols], sNum[kS2Chunk][kS2Cols];
  __shared__ float sLi[kS2Chunk], sLf[kS2Chunk], sDen[kS2Chunk];
  const int slices = HD / cols;
  const int bh = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int workers = 4 * cols;                // threads holding C
  const bool holds_c = tid < workers;
  const int c = tid >> 2, r = tid & 3;         // local column, row phase
  const int col = slice * cols + c;
  const int lane = tid - workers;              // n's warp
  const long long sbase = (long long)bh * HD;  // (b, h) in (B, H, hd)
  float Cr[ROWS], nr[NP];
  if (holds_c) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      Cr[m] = C0[(sbase + 4 * m + r) * HD + col];
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      nr[p] = (lane + 32 * p < HD) ? n0[sbase + lane + 32 * p] : 0.0f;
  }
  float mst = m0[bh];
  const int nC = (T + kS2Chunk - 1) / kS2Chunk;
  for (int t0 = 0; t0 < T; t0 += kS2Chunk) {
    const int n = min(kS2Chunk, T - t0);
    if (SAVE) {                      // C, n, m before the chunk
      const long long ck = (long long)bh * nC + t0 / kS2Chunk;
      if (holds_c) {
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
          Cck[((ck * slices + slice) * ROWS + m) * workers + tid] = Cr[m];
      } else if (slice == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          if (lane + 32 * p < HD) nck[ck * HD + lane + 32 * p] = nr[p];
        if (lane == 0) mck[ck] = mst;
      }
    }
    __syncthreads();                 // the last chunk's y is written
    for (int e = tid; e < n * HD; e += nthr) {
      const long long g = (((long long)b * T + t0 + e / HD) * H + h) * HD +
                          e % HD;
      sQ[e / HD][e % HD] = q[g];
      sK[e / HD][e % HD] = k[g];
    }
    for (int e = tid; e < n * cols; e += nthr)
      sV[e / cols][e % cols] =
          v[(((long long)b * T + t0 + e / cols) * H + h) * HD +
            slice * cols + e % cols];
    for (int e = tid; e < n; e += nthr) {
      const long long g = ((long long)b * T + t0 + e) * H + h;
      sLi[e] = log_i[g];
      sLf[e] = log_f[g];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float li = sLi[tt], lfm = __fadd_rn(sLf[tt], mst);
      const float mnew = fmaxf(lfm, li);
      const float f = expf(__fsub_rn(lfm, mnew));
      const float i = expf(__fsub_rn(li, mnew));
      mst = mnew;
      if (holds_c) {
        const float vv = sV[tt][c];
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int kk = 4 * m + r;
          Cr[m] = __fadd_rn(__fmul_rn(Cr[m], f),
                            __fmul_rn(i, __fmul_rn(sK[tt][kk], vv)));
          acc = __fadd_rn(acc, __fmul_rn(sQ[tt][kk], Cr[m]));
        }
        acc = quad_sum(acc);
        if (r == 0) sNum[tt][c] = acc;
      } else {
        float acc = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int kk = lane + 32 * p;
          if (kk < HD) {
            nr[p] = __fadd_rn(__fmul_rn(nr[p], f), __fmul_rn(i, sK[tt][kk]));
            acc = __fadd_rn(acc, __fmul_rn(sQ[tt][kk], nr[p]));
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
        if (lane == 0) sDen[tt] = fmaxf(fabsf(acc), 1.0f);
      }
    }
    __syncthreads();
    if (!SAVE)
      for (int e = tid; e < n * cols; e += nthr)
        y[(((long long)b * T + t0 + e / cols) * H + h) * HD + slice * cols +
          e % cols] = __fdiv_rn(sNum[e / cols][e % cols], sDen[e / cols]);
  }
  if (SAVE) return;
  if (holds_c) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      Cout[(sbase + 4 * m + r) * HD + col] = Cr[m];
  } else if (slice == 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (lane + 32 * p < HD) nout[sbase + lane + 32 * p] = nr[p];
    if (lane == 0) mout[bh] = mst;
  }
}

template <int ROWS, bool SAVE>
int launch_mlstm(const float* q, const float* k, const float* v,
                 const float* li, const float* lf, const float* C0,
                 const float* n0, const float* m0, float* y, float* C,
                 float* n, float* m, float* Cck, float* nck, float* mck,
                 int B, int T, int H, cudaStream_t stream) {
  constexpr int HD = 4 * ROWS;
  const int cols = HD % kS2Cols == 0 ? kS2Cols : HD;
  if (cols > kS2Cols || cols % 8 != 0) return (int)cudaErrorInvalidValue;
  mlstm_scan_kernel<ROWS, SAVE><<<B * H * (HD / cols), 4 * cols + 32, 0,
                                  stream>>>(q, k, v, li, lf, C0, n0, m0, y,
                                            C, n, m, Cck, nck, mck, T, H,
                                            cols);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- S3 sLSTM
template <int ROWS, bool SAVE>
__global__ void __cluster_dims__(kS3Cluster, 1, 1) __launch_bounds__(512)
    slstm_scan_kernel(const float* __restrict__ zx,
                      const float* __restrict__ ix,
                      const float* __restrict__ fx,
                      const float* __restrict__ ox,
                      const float* __restrict__ R,
                      const float* __restrict__ c0,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ cout, float* __restrict__ nout,
                      float* __restrict__ mout, float* __restrict__ hout,
                      float* __restrict__ saved, int T, int H) {
  constexpr int HD = 4 * ROWS;
  constexpr int E = HD / kS3Cluster;           // state elements a block
  __shared__ float sH[2][HD];                  // h_{t-1}, h_t
  __shared__ float sG[4 * E];                  // the step's h . R columns
  const unsigned q = cluster_rank();
  const int bh = blockIdx.x / kS3Cluster;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lc = tid >> 2, r = tid & 3;        // local column, row phase
  const int gate = lc / E, e = lc % E;
  const int rcol = gate * HD + (int)q * E + e;  // R's column
  float Rr[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    Rr[m] = R[((long long)h * HD + 4 * m + r) * (4 * HD) + rcol];
  const long long sbase = (long long)bh * HD;
  for (int x = tid; x < HD; x += blockDim.x) sH[0][x] = h0[sbase + x];
  const bool owner = tid < E;                  // updates element me
  const int me = (int)q * E + tid;
  float cs = 0.0f, ns = 0.0f, ms = 0.0f, hs = 0.0f;
  float nz = 0.0f, ni = 0.0f, nf = 0.0f, no = 0.0f;
  if (owner) {
    cs = c0[sbase + me];
    ns = n0[sbase + me];
    ms = m0[sbase + me];
    hs = h0[sbase + me];
    if (T > 0) {
      const long long g = ((long long)b * T * H + h) * HD + me;
      nz = zx[g];
      ni = ix[g];
      nf = fx[g];
      no = ox[g];
    }
  }
  cluster_sync();                    // every block started, sH[0] written
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    float acc = 0.0f;
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      acc = __fadd_rn(acc, __fmul_rn(Rr[m], sH[cur][4 * m + r]));
    acc = quad_sum(acc);
    if (r == 0) sG[lc] = acc;
    __syncthreads();
    if (owner) {
      const float zt = nz, it = ni, ft = nf, ot = no;
      if (t + 1 < T) {               // the next step's inputs, a step ahead
        const long long g = (((long long)b * T + t + 1) * H + h) * HD + me;
        nz = zx[g];
        ni = ix[g];
        nf = fx[g];
        no = ox[g];
      }
      const float zp = __fadd_rn(zt, sG[tid]);
      const float li = __fadd_rn(it, sG[E + tid]);
      const float fp = __fadd_rn(ft, sG[2 * E + tid]);
      const float op = __fadd_rn(ot, sG[3 * E + tid]);
      const float z = tanhf(zp);
      const float lf = log_sigmoid(fp);
      const float o = sigmoid(op);
      const float lfm = __fadd_rn(lf, ms);
      const float mnew = fmaxf(lfm, li);
      const float f = expf(__fsub_rn(lfm, mnew));
      const float i = expf(__fsub_rn(li, mnew));
      cs = __fadd_rn(__fmul_rn(cs, f), __fmul_rn(i, z));
      ns = __fadd_rn(__fmul_rn(ns, f), i);
      hs = __fdiv_rn(__fmul_rn(o, cs), fmaxf(fabsf(ns), 1.0f));
      ms = mnew;
      const long long g = (((long long)b * T + t) * H + h) * HD + me;
      if (SAVE) {                    // planes c, n, m, z, i, f, o of (B,T,H,hd)
        const long long plane = (long long)(gridDim.x / kS3Cluster) * T * HD;
        saved[g] = cs;
        saved[plane + g] = ns;
        saved[2 * plane + g] = ms;
        saved[3 * plane + g] = zp;
        saved[4 * plane + g] = li;
        saved[5 * plane + g] = fp;
        saved[6 * plane + g] = op;
      } else {
        y[g] = hs;
      }
      for (unsigned rank = 0; rank < kS3Cluster; ++rank)
        st_cluster(&sH[cur ^ 1][me], rank, hs);
    }
    cluster_sync();                  // h_t in every block; sG free again
  }
  if (owner && !SAVE) {
    cout[sbase + me] = cs;
    nout[sbase + me] = ns;
    mout[sbase + me] = ms;
    hout[sbase + me] = hs;
  }
}

template <int ROWS, bool SAVE>
int launch_slstm(const float* zx, const float* ix, const float* fx,
                 const float* ox, const float* R, const float* c0,
                 const float* n0, const float* m0, const float* h0, float* y,
                 float* c, float* n, float* m, float* h, float* saved, int B,
                 int T, int H, cudaStream_t stream) {
  constexpr int E = 4 * ROWS / kS3Cluster;
  slstm_scan_kernel<ROWS, SAVE><<<B * H * kS3Cluster, 16 * E, 0, stream>>>(
      zx, ix, fx, ox, R, c0, n0, m0, h0, y, c, n, m, h, saved, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1 on contiguous float32 tensors: decay (B, T, H), Bm and Cm (B, T, ds),
// dtx (B, T, H, hd), s0 (B, H, ds, hd) -> y (B, T, H, hd), sT (B, H, ds,
// hd).  ds / 4 in {1, 2, 4, 8, 16, 32}; hd a multiple of 8, at most 256.
int mamba2_scan(const float* decay, const float* Bm, const float* Cm,
                const float* dtx, const float* s0, float* y, float* sT, int B,
                int T, int H, int ds, int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd <= 0 || hd > 256 || hd % 8 != 0 || ds % 4 != 0)
    return (int)cudaErrorInvalidValue;
#define S1(R)                                                             \
  case R:                                                                 \
    return launch_mamba2<R, false>(decay, Bm, Cm, dtx, s0, y, sT, nullptr, \
                                   B, T, H, hd, stream)
  switch (ds / 4) {
    S1(1); S1(2); S1(4); S1(8); S1(16); S1(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S1
}

// S2: q, k, v (B, T, H, hd), log_i, log_f (B, T, H), C0 (B, H, hd, hd), n0
// (B, H, hd), m0 (B, H) -> y (B, T, H, hd), C, n, m.  hd / 4 in {2, 4, 8,
// 16, 24, 32, 48}.
int mlstm_scan(const float* q, const float* k, const float* v,
               const float* li, const float* lf, const float* C0,
               const float* n0, const float* m0, float* y, float* C,
               float* n, float* m, int B, int T, int H, int hd,
               cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd % 4 != 0) return (int)cudaErrorInvalidValue;
#define S2(R)                                                             \
  case R:                                                                 \
    return launch_mlstm<R, false>(q, k, v, li, lf, C0, n0, m0, y, C, n, m, \
                                  nullptr, nullptr, nullptr, B, T, H, stream)
  switch (hd / 4) {
    S2(2); S2(4); S2(8); S2(16); S2(24); S2(32); S2(48);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2
}

// S3: zx, ix, fx, ox (B, T, H, hd), R (H, hd, 4 hd), c0, n0, m0, h0 (B, H,
// hd) -> y (B, T, H, hd), c, n, m, h.  hd a multiple of 16 with hd / 4 in
// {4, 8, 12, 16, 24, 32, 48, 64}.
int slstm_scan(const float* zx, const float* ix, const float* fx,
               const float* ox, const float* R, const float* c0,
               const float* n0, const float* m0, const float* h0, float* y,
               float* c, float* n, float* m, float* h, int B, int T, int H,
               int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
#define S3(R_)                                                             \
  case R_:                                                                 \
    return launch_slstm<R_, false>(zx, ix, fx, ox, R, c0, n0, m0, h0, y, c, \
                                   n, m, h, nullptr, B, T, H, stream)
  switch (hd / 4) {
    S3(4); S3(8); S3(12); S3(16); S3(24); S3(32); S3(48); S3(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S3
}

// The saving variants (csrc/ssm_scan_bwd.cu's inputs), on the forward's
// operands and widths.  S1: ckpt (B, H, ceil(T / kS1Ckpt), ds, hd), the
// state before steps 0, kS1Ckpt, ...
int mamba2_scan_ckpt(const float* decay, const float* Bm, const float* Cm,
                     const float* dtx, const float* s0, float* ckpt, int B,
                     int T, int H, int ds, int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T == 0) return 0;
  if (T < 0 || hd <= 0 || hd > 256 || hd % 8 != 0 || ds % 4 != 0)
    return (int)cudaErrorInvalidValue;
#define S1(R)                                                             \
  case R:                                                                 \
    return launch_mamba2<R, true>(decay, Bm, Cm, dtx, s0, nullptr, nullptr, \
                                  ckpt, B, T, H, hd, stream)
  switch (ds / 4) {
    S1(1); S1(2); S1(4); S1(8); S1(16); S1(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S1
}

// S2: Cck (B, H, ceil(T / kS2Chunk), hd, hd), nck (..., hd), mck (...):
// C, n and m before steps 0, kS2Chunk, ...
int mlstm_scan_ckpt(const float* q, const float* k, const float* v,
                    const float* li, const float* lf, const float* C0,
                    const float* n0, const float* m0, float* Cck, float* nck,
                    float* mck, int B, int T, int H, int hd,
                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T == 0) return 0;
  if (T < 0 || hd % 4 != 0) return (int)cudaErrorInvalidValue;
#define S2(R)                                                             \
  case R:                                                                 \
    return launch_mlstm<R, true>(q, k, v, li, lf, C0, n0, m0, nullptr,     \
                                 nullptr, nullptr, nullptr, Cck, nck, mck, \
                                 B, T, H, stream)
  switch (hd / 4) {
    S2(2); S2(4); S2(8); S2(16); S2(24); S2(32); S2(48);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2
}

// S3: saved (7, B, T, H, hd), every step's c, n, m (after it) and its
// pre-activations z, i, f, o (input terms plus h_{t-1} . R).
int slstm_scan_save(const float* zx, const float* ix, const float* fx,
                    const float* ox, const float* R, const float* c0,
                    const float* n0, const float* m0, const float* h0,
                    float* saved, int B, int T, int H, int hd,
                    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T == 0) return 0;
  if (T < 0 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
#define S3(R_)                                                             \
  case R_:                                                                 \
    return launch_slstm<R_, true>(zx, ix, fx, ox, R, c0, n0, m0, h0,       \
                                  nullptr, nullptr, nullptr, nullptr,      \
                                  nullptr, saved, B, T, H, stream)
  switch (hd / 4) {
    S3(4); S3(8); S3(12); S3(16); S3(24); S3(32); S3(48); S3(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S3
}

}  // extern "C"
