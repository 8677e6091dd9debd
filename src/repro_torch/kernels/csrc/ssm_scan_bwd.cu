// S1b-S3b: the backward passes of the recurrences S1-S3 (csrc/ssm_scan.cu)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// No Pallas kernel is replaced: each replaces the reverse-mode autodiff of
// a `lax.scan` of the JAX package's src/repro/models/ssm.py (:103 Mamba2,
// :159 mLSTM, :205 sLSTM).  Each kernel runs the backward twin's reverse
// time loop (kernels/ref.py: mamba2_, mlstm_ and
// slstm_recurrence_bwd_plain) with the adjoint state on the chip, in the
// forward kernel's thread layout, after the forward kernel's saving
// variant has written what it reads (csrc/ssm_scan.cu, SAVE).  Ties of
// max and abs follow JAX's rules: half the gradient to each side of a
// tie, sign(0) = 0.  Sums across blocks are per-block partials that the
// wrapper (kernels/ssm_scan.py) adds in a fixed order: no atomics, the
// same bits run to run.  The file is built with --fmad=false.
//
// Bound.  The reverse step does about twice the forward's arithmetic on
// each state element (S1: the adjoint's update and four contractions, 11
// flops, against the forward's 3 and its read-out's 2), plus the
// recompute of the states from the saved ones; like the forward, what
// bounds these designs is the chain of T dependent steps.
//
// * S1b `mamba2_scan_bwd_kernel<ROWS>`: one block a (b, h), 4 hd threads,
//   the forward's layout (lane quad c of warp w owns column j = 8 w + c,
//   rows i = 4 m + r in registers).  Chunks of kS1Ckpt steps, last first:
//   the chunk's states are recomputed from the saved one into a scratch of
//   the block's own (each thread its own elements, so no barrier), then a
//   reverse step is G += C_t (x) dy_t (bitwise the twin's: two roundings,
//   no sum), d(dt x)_t[j] = sum_i G[i][j] B_t[i] (the quad, as y), dC_t
//   and dB_t (sums over the block's hd columns: a reduce-scatter over the
//   warp's 8 quads, `scatter_rows`, then the warps' partials in shared
//   memory added in warp order), d decay_t = <G, s_{t-1}> and G *= decay_t.
//   dC and dB are per-head partials, summed over H by the wrapper.
// * S2b `mlstm_scan_bwd_kernel<ROWS>`: the forward's blocks, one a (b, h,
//   slice of kS2Cols columns of C), 4 threads a column with G_C's column
//   in registers, plus n's warp.  Each chunk of kS2Chunk steps is
//   recomputed from the saved C, n and m (the gates by every thread, in
//   the forward's arithmetic); a reverse step gives dv (complete: column v
//   reads G_C's column v alone), and this slice's parts of dq and dk
//   (reduce-scatter, as S1b's dC) and of d f and d i.  Slice 0's n warp
//   carries G_n through den = max(|q . n|, 1) (d den = -<dy, y> / den)
//   and adds n's parts.  `mlstm_gates_bwd_kernel` then walks the
//   stabiliser chain m_t = max(log_f + m_{t-1}, log_i) in reverse, a
//   thread a (b, h), adding the slices' d f and d i in slice order: d
//   log_i, d log_f, d m0.  kernels/ssm_scan.py runs them below
//   MLSTM_CHUNKED_MIN_T steps or at widths csrc/mlstm_chunked.cu (the
//   chunked form, from the same checkpoints) does not take.
// * S3b `slstm_scan_bwd_kernel<ROWS>` (the barrier kernel;
//   kernels/ssm_scan.py runs it only when forced): one cluster of 8 blocks
//   a (b, h), as the forward; block q's E = hd / 8 owner threads take its
//   elements' adjoints of c, n, m and h through the saved step to the four
//   pre-activations' adjoints dpre_t (its 4 E columns of R).  Every thread
//   holds half a row of those columns of R (2 threads a row): dR += h_{t-1}
//   (x) dpre_t in registers over all T (per-b partials, summed over B by
//   the wrapper), and dh_{t-1} = R . dpre_t, a reduce-scatter over the
//   cluster: block q stores its partial of block p's E elements into slot
//   q of p's shared memory, one cluster barrier follows, and p adds its 8
//   slots in order.  The slots alternate, so a store for step t - 1 never
//   meets a read of step t; a cluster barrier comes before the first
//   remote store.
// * S3b on the short step, `slstm_bwd_short_kernel<ROWS>` then
//   `slstm_dR_kernel` (every call's): the same walk with only the adjoint
//   on its chain.  A window of steps' constants is computed by all threads
//   from loads issued a window ahead; dh's partials reach the owning block
//   by st.async on its mbarrier, so a block waits for its own data, not at
//   a cluster barrier; dR is a product of its own after the walk.  The
//   handshake alone (`slstm_handshake_kernel`, both kinds) is S3b's
//   latency floor.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"
#include "sm90.cuh"
#include "ssm_scan.cuh"

namespace {

// Reduce-scatter over the 8 lane quads of a warp (lane bits 2-4): each
// lane's v[0..N) are values of one row phase (lane & 3), summed over the
// warp's 8 quads.  While more than one value is left a stage keeps half of
// them (the partner lane keeps the other half) and adds the partner's
// copy of its half; then a stage adds whole.  `base` is the index of the
// lane's first kept value.
template <int N, int OFF>
struct QuadScatter {
  static __device__ __forceinline__ void run(float* v, int lane, int& base) {
    if constexpr (N >= 2) {
      constexpr int H = N / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[H + k];
        const float keep = up ? v[H + k] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, OFF));
      }
      if (up) base += H;
      if constexpr (OFF > 4) QuadScatter<H, OFF / 2>::run(v, lane, base);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], OFF));
      if constexpr (OFF > 4) QuadScatter<1, OFF / 2>::run(v, lane, base);
    }
  }
};

// The warp's sums of v[m] over its 8 quads, row 4 m + (lane & 3), into
// dst[row] (one lane writes each row).  Every lane of the warp takes it.
template <int N>
__device__ __forceinline__ void scatter_rows(float* v, int lane,
                                             float* dst) {
  int base = 0;
  QuadScatter<N, 16>::run(v, lane, base);
  constexpr int kKept = N >= 8 ? N / 8 : 1;
  constexpr int kCopies = N >= 8 ? 0 : N == 4 ? 4 : N == 2 ? 12 : 28;
  if ((lane & kCopies) == 0) {
#pragma unroll
    for (int k = 0; k < kKept; ++k) dst[4 * (base + k) + (lane & 3)] = v[k];
  }
}

// ----------------------------------------------------------- S1b Mamba2
template <int ROWS>
__global__ void __launch_bounds__(1024) mamba2_scan_bwd_kernel(
    const float* __restrict__ decay, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dtx,
    const float* __restrict__ dy, const float* __restrict__ dsT,
    const float* __restrict__ ckpt, float* __restrict__ scratch,
    float* __restrict__ ddecay, float* __restrict__ dBh,
    float* __restrict__ dCh, float* __restrict__ ddtx,
    float* __restrict__ ds0, int T, int H, int hd) {
  constexpr int DS = 4 * ROWS;
  constexpr int K = kS1Ckpt;
  extern __shared__ float smem[];
  const int nthr = blockDim.x, nw = nthr >> 5;
  float* sB = smem;                            // [K][DS]
  float* sC = sB + K * DS;                     // [K][DS]
  float* sU = sC + K * DS;                     // [K][hd]
  float* sDY = sU + K * hd;                    // [K][hd]
  float* sDec = sDY + K * hd;                  // [K]
  float* sW = sDec + K;                        // [2][nw][2][DS]: dC, dB
  float* sWd = sW + 2 * nw * 2 * DS;           // [2][nw]: d decay
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, j = tid >> 2, r = tid & 3;
  const int lane = tid & 31, warp = tid >> 5;
  const long long st = (long long)bh * DS * hd;
  const int nC = (T + K - 1) / K;
  const float* ck = ckpt + (long long)bh * nC * ROWS * nthr;
  float* scr = scratch + (long long)bh * K * ROWS * nthr;
  float G[ROWS], s[ROWS], v[ROWS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    G[m] = dsT[st + (long long)(4 * m + r) * hd + j];
  int buf = 0;
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * K, n = min(K, T - t0);
    __syncthreads();                 // the last chunk's reads are done
    for (int e = tid; e < n * DS; e += nthr) {
      const long long row = (long long)b * T + t0 + e / DS;
      sB[e] = Bm[row * DS + e % DS];
      sC[e] = Cm[row * DS + e % DS];
    }
    for (int e = tid; e < n * hd; e += nthr) {
      const long long g =
          (((long long)b * T + t0 + e / hd) * H + h) * hd + e % hd;
      sU[e] = dtx[g];
      sDY[e] = dy[g];
    }
    for (int e = tid; e < n; e += nthr)
      sDec[e] = decay[((long long)b * T + t0 + e) * H + h];
    __syncthreads();
    // s_{t0 + 1} .. s_{t0 + n} from the saved s_{t0}, as the forward.
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      s[m] = ck[((long long)c * ROWS + m) * nthr + tid];
    for (int tt = 0; tt < n; ++tt) {
      const float dec = sDec[tt], u = sU[tt * hd + j];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        s[m] = __fadd_rn(__fmul_rn(s[m], dec),
                         __fmul_rn(sB[tt * DS + 4 * m + r], u));
        scr[(tt * ROWS + m) * nthr + tid] = s[m];
      }
    }
    for (int tt = n - 1; tt >= 0; --tt) {   // s holds s_t
      const long long o = ((long long)b * T + t0 + tt) * H + h;
      const float dyj = sDY[tt * hd + j], uj = sU[tt * hd + j];
      const float dec = sDec[tt];
      const float* Bt = sB + tt * DS;
      const float* Ct = sC + tt * DS;
      float du = 0.0f;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int i = 4 * m + r;
        G[m] = __fadd_rn(G[m], __fmul_rn(Ct[i], dyj));
        du = __fadd_rn(du, __fmul_rn(Bt[i], G[m]));
        v[m] = __fmul_rn(s[m], dyj);
      }
      float* w = sW + (buf * nw + warp) * 2 * DS;
      scatter_rows<ROWS>(v, lane, w);              // dC_t: s_t . dy_t
#pragma unroll
      for (int m = 0; m < ROWS; ++m) v[m] = __fmul_rn(G[m], uj);
      scatter_rows<ROWS>(v, lane, w + DS);         // dB_t: G . u_t
      du = quad_sum(du);
      if (r == 0) ddtx[o * hd + j] = du;
      if (tt > 0) {                  // s_{t-1}
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
          s[m] = scr[((tt - 1) * ROWS + m) * nthr + tid];
      } else {
#pragma unroll
        for (int m = 0; m < ROWS; ++m)
          s[m] = ck[((long long)c * ROWS + m) * nthr + tid];
      }
      float dd = 0.0f;
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        dd = __fadd_rn(dd, __fmul_rn(G[m], s[m]));
        G[m] = __fmul_rn(G[m], dec);
      }
      dd = warp_sum(dd);
      if (lane == 0) sWd[buf * nw + warp] = dd;
      __syncthreads();               // this step's partials are in sW, sWd
      for (int e = tid; e < 2 * DS; e += nthr) {
        const int which = e / DS, row = e % DS;
        float acc = 0.0f;
        for (int x = 0; x < nw; ++x)
          acc = __fadd_rn(acc, sW[((buf * nw + x) * 2 + which) * DS + row]);
        (which ? dBh : dCh)[o * DS + row] = acc;
      }
      if (tid == nthr - 1) {
        float acc = 0.0f;
        for (int x = 0; x < nw; ++x) acc = __fadd_rn(acc, sWd[buf * nw + x]);
        ddecay[o] = acc;
      }
      buf ^= 1;                      // the next step writes the other half
    }
  }
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    ds0[st + (long long)(4 * m + r) * hd + j] = G[m];
}

template <int ROWS>
int launch_mamba2_bwd(const float* decay, const float* Bm, const float* Cm,
                      const float* dtx, const float* dy, const float* dsT,
                      const float* ckpt, float* scratch, float* ddecay,
                      float* dBh, float* dCh, float* ddtx, float* ds0, int B,
                      int T, int H, int hd, cudaStream_t stream) {
  constexpr int DS = 4 * ROWS;
  const int nw = 4 * hd / 32;
  const size_t smem = sizeof(float) * ((size_t)kS1Ckpt * (2 * DS + 2 * hd) +
                                       kS1Ckpt + 2 * nw * 2 * DS + 2 * nw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_bwd_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mamba2_scan_bwd_kernel<ROWS><<<B * H, 4 * hd, smem, stream>>>(
      decay, Bm, Cm, dtx, dy, dsT, ckpt, scratch, ddecay, dBh, dCh, ddtx,
      ds0, T, H, hd);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ S2b mLSTM
template <int ROWS>
__global__ void __launch_bounds__(4 * kS2Cols + 32) mlstm_scan_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, const float* __restrict__ y,
    const float* __restrict__ dy, const float* __restrict__ dC,
    const float* __restrict__ dn, const float* __restrict__ Cck,
    const float* __restrict__ nck, const float* __restrict__ mck,
    float* __restrict__ scrC, float* __restrict__ scrN,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dfi, float* __restrict__ dC0,
    float* __restrict__ dn0, int T, int H, int cols) {
  constexpr int HD = 4 * ROWS;
  constexpr int NP = (HD + 31) / 32;           // n's rows a lane
  constexpr int K = kS2Chunk;
  constexpr int NWC = kS2Cols / 8;             // warps holding C, at most
  __shared__ float sQ[K][HD], sK[K][HD];
  __shared__ float sV[K][kS2Cols], sDY[K][kS2Cols];
  __shared__ float sLi[K], sLf[K], sF[K], sI[K], sDen[K], sQN[K];
  __shared__ float sW[2][NWC][2][HD];          // C warps' dq, dk / i parts
  __shared__ float sN[2][2][HD];               // n warp's: n_t d(q.n), G_n
  __shared__ float sWs[2][NWC + 1][2];         // each warp's d f, d i
  const int slices = HD / cols;
  const int bh = blockIdx.x / slices, slice = blockIdx.x % slices;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int workers = 4 * cols;                // threads holding C
  const bool holds_c = tid < workers;
  const bool carries_n = !holds_c && slice == 0;
  const int c = tid >> 2, r = tid & 3;         // local column, row phase
  const int col = slice * cols + c;
  const int lane = tid & 31, warp = tid >> 5, nwc = cols / 8;
  const int nl = tid - workers;                // n's warp's lane
  const long long sbase = (long long)bh * HD;  // (b, h) in (B, H, hd)
  const long long BTH = (long long)(gridDim.x / slices) * T;
  const int nC = (T + K - 1) / K;
  float* sc = scrC + (long long)blockIdx.x * K * ROWS * workers;
  float* sn = scrN + (long long)blockIdx.x * K * HD;
  float G[ROWS], Cr[ROWS], w[ROWS], Gn[NP], nr[NP];
  if (holds_c) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      G[m] = dC[(sbase + 4 * m + r) * HD + col];
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      Gn[p] = (nl + 32 * p < HD) ? dn[sbase + nl + 32 * p] : 0.0f;
  }
  int buf = 0;
  for (int ci = nC - 1; ci >= 0; --ci) {
    const int t0 = ci * K, n = min(K, T - t0);
    const long long ckb = (long long)bh * nC + ci;
    __syncthreads();                 // the last chunk's reads are done
    for (int e = tid; e < n * HD; e += nthr) {
      const long long g = (((long long)b * T + t0 + e / HD) * H + h) * HD +
                          e % HD;
      sQ[e / HD][e % HD] = q[g];
      sK[e / HD][e % HD] = k[g];
    }
    for (int e = tid; e < n * cols; e += nthr) {
      const long long g = (((long long)b * T + t0 + e / cols) * H + h) * HD +
                          slice * cols + e % cols;
      sV[e / cols][e % cols] = v[g];
      sDY[e / cols][e % cols] = dy[g];
    }
    for (int e = tid; e < n; e += nthr) {
      const long long g = ((long long)b * T + t0 + e) * H + h;
      sLi[e] = log_i[g];
      sLf[e] = log_f[g];
    }
    __syncthreads();
    // The chunk's gates, C columns and n from the saved C, n, m, as the
    // forward computes them.
    float mst = mck[ckb];
    if (holds_c) {
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        Cr[m] = Cck[((ckb * slices + slice) * ROWS + m) * workers + tid];
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p)
        nr[p] = (nl + 32 * p < HD) ? nck[ckb * HD + nl + 32 * p] : 0.0f;
    }
    for (int tt = 0; tt < n; ++tt) {
      const float li = sLi[tt], lfm = __fadd_rn(sLf[tt], mst);
      const float mnew = fmaxf(lfm, li);
      const float f = expf(__fsub_rn(lfm, mnew));
      const float i = expf(__fsub_rn(li, mnew));
      mst = mnew;
      if (tid == 0) {
        sF[tt] = f;
        sI[tt] = i;
      }
      if (holds_c) {
        const float vv = sV[tt][c];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int kk = 4 * m + r;
          Cr[m] = __fadd_rn(__fmul_rn(Cr[m], f),
                            __fmul_rn(i, __fmul_rn(sK[tt][kk], vv)));
          sc[(tt * ROWS + m) * workers + tid] = Cr[m];
        }
      } else {
        float acc = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int kk = nl + 32 * p;
          if (kk < HD) {
            nr[p] = __fadd_rn(__fmul_rn(nr[p], f), __fmul_rn(i, sK[tt][kk]));
            acc = __fadd_rn(acc, __fmul_rn(sQ[tt][kk], nr[p]));
            sn[tt * HD + kk] = nr[p];
          }
        }
        acc = warp_sum(acc);
        if (nl == 0) {
          sQN[tt] = acc;
          sDen[tt] = fmaxf(fabsf(acc), 1.0f);
        }
      }
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {   // Cr holds C_t
      const long long o = ((long long)b * T + t0 + tt) * H + h;
      const float f = sF[tt], i = sI[tt], den = sDen[tt];
      float pf = 0.0f, pi = 0.0f;   // this thread's parts of d f and d i
      if (holds_c) {
        const float dnum = __fdiv_rn(sDY[tt][c], den), vv = sV[tt][c];
        float gv = 0.0f;
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const int kk = 4 * m + r;
          G[m] = __fadd_rn(G[m], __fmul_rn(sQ[tt][kk], dnum));
          gv = __fadd_rn(gv, __fmul_rn(sK[tt][kk], G[m]));
          w[m] = __fmul_rn(Cr[m], dnum);
        }
        scatter_rows<ROWS>(w, lane, &sW[buf][warp][0][0]);   // C_t d num
#pragma unroll
        for (int m = 0; m < ROWS; ++m) w[m] = __fmul_rn(G[m], vv);
        scatter_rows<ROWS>(w, lane, &sW[buf][warp][1][0]);   // G_C v
        gv = quad_sum(gv);                                   // k . G_C
        if (r == 0) {
          dv[o * HD + col] = __fmul_rn(i, gv);
          pi = __fmul_rn(gv, vv);
        }
        if (tt > 0) {                // C_{t-1}
#pragma unroll
          for (int m = 0; m < ROWS; ++m)
            Cr[m] = sc[((tt - 1) * ROWS + m) * workers + tid];
        } else {
#pragma unroll
          for (int m = 0; m < ROWS; ++m)
            Cr[m] = Cck[((ckb * slices + slice) * ROWS + m) * workers + tid];
        }
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          pf = __fadd_rn(pf, __fmul_rn(G[m], Cr[m]));
          G[m] = __fmul_rn(G[m], f);
        }
      } else if (carries_n) {
        // d den = -<dy, y> / den, through max(|q . n|, 1) to q . n.
        float dyy = 0.0f;
        for (int kk = nl; kk < HD; kk += 32)
          dyy = __fadd_rn(dyy, __fmul_rn(dy[o * HD + kk], y[o * HD + kk]));
        dyy = warp_sum(dyy);
        const float qn = sQN[tt];
        const float dqn =
            __fmul_rn(__fdiv_rn(-dyy, den),
                      __fmul_rn(max_share(fabsf(qn), 1.0f), sign0(qn)));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int kk = nl + 32 * p;
          if (kk < HD) {
            Gn[p] = __fadd_rn(Gn[p], __fmul_rn(sQ[tt][kk], dqn));
            sN[buf][0][kk] = __fmul_rn(sn[tt * HD + kk], dqn);
            sN[buf][1][kk] = Gn[p];
            pi = __fadd_rn(pi, __fmul_rn(Gn[p], sK[tt][kk]));
            const float np = tt > 0 ? sn[(tt - 1) * HD + kk]
                                    : nck[ckb * HD + kk];
            pf = __fadd_rn(pf, __fmul_rn(Gn[p], np));
            Gn[p] = __fmul_rn(Gn[p], f);
          }
        }
      }
      pf = warp_sum(pf);
      pi = warp_sum(pi);
      if (lane == 0) {
        sWs[buf][warp][0] = pf;
        sWs[buf][warp][1] = pi;
      }
      __syncthreads();               // this step's parts are in shared memory
      for (int e = tid; e < 2 * HD; e += nthr) {
        const int which = e / HD, kk = e % HD;
        float acc = 0.0f;
        for (int x = 0; x < nwc; ++x) acc = __fadd_rn(acc, sW[buf][x][which][kk]);
        if (slice == 0) acc = __fadd_rn(acc, sN[buf][which][kk]);
        const long long g = ((long long)slice * BTH + o) * HD + kk;
        if (which == 0) dq[g] = acc;
        else dk[g] = __fmul_rn(i, acc);
      }
      if (tid == nthr - 1) {
        float a = 0.0f, bb = 0.0f;
        for (int x = 0; x <= nwc; ++x) {
          a = __fadd_rn(a, sWs[buf][x][0]);
          bb = __fadd_rn(bb, sWs[buf][x][1]);
        }
        dfi[(long long)slice * BTH + o] = a;
        dfi[((long long)slices + slice) * BTH + o] = bb;
      }
      buf ^= 1;
    }
  }
  if (holds_c) {
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      dC0[(sbase + 4 * m + r) * HD + col] = G[m];
  } else if (slice == 0) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
      if (nl + 32 * p < HD) dn0[sbase + nl + 32 * p] = Gn[p];
  }
}

// The stabiliser chain in reverse, one thread a (b, h): m_t recomputed
// into mt (B, T, H), then d log_f, d log_i and d m0 from the slices' d f
// and d i (dfi (2, slices, B, T, H)), added in slice order.
__global__ void mlstm_gates_bwd_kernel(
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ m0, const float* __restrict__ dm,
    const float* __restrict__ dfi, float* __restrict__ mt,
    float* __restrict__ dli, float* __restrict__ dlf,
    float* __restrict__ dm0, int BH, int T, int H, int slices) {
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= BH) return;
  const int b = bh / H, h = bh % H;
  const long long BTH = (long long)BH * T;
  float m = m0[bh];
  for (int t = 0; t < T; ++t) {
    const long long o = ((long long)b * T + t) * H + h;
    m = fmaxf(__fadd_rn(log_f[o], m), log_i[o]);
    mt[o] = m;
  }
  float Gm = dm[bh];
  for (int t = T - 1; t >= 0; --t) {
    const long long o = ((long long)b * T + t) * H + h;
    const float li = log_i[o], mn = mt[o];
    const float lfm = __fadd_rn(log_f[o], t > 0 ? mt[o - H] : m0[bh]);
    const float f = expf(__fsub_rn(lfm, mn));
    const float i = expf(__fsub_rn(li, mn));
    float df = 0.0f, di = 0.0f;
    for (int s = 0; s < slices; ++s) {
      df = __fadd_rn(df, dfi[s * BTH + o]);
      di = __fadd_rn(di, dfi[(slices + s) * BTH + o]);
    }
    const float a = __fmul_rn(df, f), cc = __fmul_rn(di, i);
    const float dmn = __fsub_rn(__fsub_rn(Gm, a), cc);
    Gm = __fadd_rn(a, __fmul_rn(dmn, max_share(lfm, li)));
    dlf[o] = Gm;
    dli[o] = __fadd_rn(cc, __fmul_rn(dmn, max_share(li, lfm)));
  }
  dm0[bh] = Gm;
}

template <int ROWS>
int launch_mlstm_bwd(const float* q, const float* k, const float* v,
                     const float* li, const float* lf, const float* m0,
                     const float* y, const float* dy, const float* dC,
                     const float* dn, const float* dm, const float* Cck,
                     const float* nck, const float* mck, float* scrC,
                     float* scrN, float* mt, float* dq, float* dk, float* dv,
                     float* dfi, float* dli, float* dlf, float* dC0,
                     float* dn0, float* dm0, int B, int T, int H,
                     cudaStream_t stream) {
  constexpr int HD = 4 * ROWS;
  const int cols = HD % kS2Cols == 0 ? kS2Cols : HD;
  if (cols > kS2Cols || cols % 8 != 0) return (int)cudaErrorInvalidValue;
  const int slices = HD / cols;
  mlstm_scan_bwd_kernel<ROWS><<<B * H * slices, 4 * cols + 32, 0, stream>>>(
      q, k, v, li, lf, y, dy, dC, dn, Cck, nck, mck, scrC, scrN, dq, dk, dv,
      dfi, dC0, dn0, T, H, cols);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlstm_gates_bwd_kernel<<<(B * H + 31) / 32, 32, 0, stream>>>(
      li, lf, m0, dm, dfi, mt, dli, dlf, dm0, B * H, T, H, slices);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ S3b sLSTM
template <int ROWS>
__global__ void __cluster_dims__(kS3Cluster, 1, 1)
    __launch_bounds__(8 * ROWS) slstm_scan_bwd_kernel(
        const float* __restrict__ R, const float* __restrict__ c0,
        const float* __restrict__ n0, const float* __restrict__ m0,
        const float* __restrict__ h0, const float* __restrict__ y,
        const float* __restrict__ dy, const float* __restrict__ dc,
        const float* __restrict__ dn, const float* __restrict__ dm,
        const float* __restrict__ dh, const float* __restrict__ saved,
        float* __restrict__ dzx, float* __restrict__ dix,
        float* __restrict__ dfx, float* __restrict__ dox,
        float* __restrict__ dRb, float* __restrict__ dc0,
        float* __restrict__ dn0, float* __restrict__ dm0,
        float* __restrict__ dh0, int T, int H) {
  constexpr int HD = 4 * ROWS;
  constexpr int E = HD / kS3Cluster;           // state elements a block
  __shared__ float sD[4 * E];                  // the step's dpre columns
  __shared__ float sSlot[2][kS3Cluster][E];    // dh partials, by source
  const unsigned q = cluster_rank();
  const int bh = blockIdx.x / kS3Cluster;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int row = tid >> 1, half = tid & 1;    // R's row, half its columns
  float Rr[ROWS], dR[ROWS];
#pragma unroll
  for (int kq = 0; kq < ROWS; ++kq) {
    const int lc = half * ROWS + kq;
    Rr[kq] = R[((long long)h * HD + row) * (4 * HD) + (lc / E) * HD +
               (int)q * E + lc % E];
    dR[kq] = 0.0f;
  }
  const long long sbase = (long long)bh * HD;
  const bool owner = tid < E;                  // carries element me
  const int me = (int)q * E + tid;
  const long long plane = (long long)(gridDim.x / kS3Cluster) * T * HD;
  const long long step = (long long)H * HD;    // one time step in (B,T,H,hd)
  float Gc = 0.0f, Gn = 0.0f, Gm = 0.0f, Gh = 0.0f;
  if (owner) {
    Gc = dc[sbase + me];
    Gn = dn[sbase + me];
    Gm = dm[sbase + me];
    Gh = dh[sbase + me];
  }
  cluster_sync();                    // every block started
  int buf = 0;
  for (int t = T - 1; t >= 0; --t) {
    const long long g = (((long long)b * T + t) * H + h) * HD;
    if (owner) {
      const long long x = g + me;
      const float c = saved[x], n = saved[plane + x];
      const float mt = saved[2 * plane + x], zp = saved[3 * plane + x];
      const float li = saved[4 * plane + x], fp = saved[5 * plane + x];
      const float op = saved[6 * plane + x];
      float cp, np, mp;
      if (t > 0) {
        cp = saved[x - step];
        np = saved[plane + x - step];
        mp = saved[2 * plane + x - step];
      } else {
        cp = c0[sbase + me];
        np = n0[sbase + me];
        mp = m0[sbase + me];
      }
      const float z = tanhf(zp), o = sigmoid(op);
      const float lfm = __fadd_rn(log_sigmoid(fp), mp);
      const float f = expf(__fsub_rn(lfm, mt));
      const float i = expf(__fsub_rn(li, mt));
      const float gh = __fadd_rn(dy[x], Gh);
      const float den = fmaxf(fabsf(n), 1.0f);
      const float xo = __fmul_rn(o, c);
      const float dx = __fdiv_rn(gh, den);      // h = (o c) / den
      Gc = __fadd_rn(Gc, __fmul_rn(dx, o));
      Gn = __fadd_rn(Gn, __fmul_rn(__fdiv_rn(__fmul_rn(-gh, xo),
                                             __fmul_rn(den, den)),
                                   __fmul_rn(max_share(fabsf(n), 1.0f),
                                             sign0(n))));
      const float df = __fadd_rn(__fmul_rn(Gc, cp), __fmul_rn(Gn, np));
      const float di = __fadd_rn(__fmul_rn(Gc, z), Gn);
      const float dz = __fmul_rn(Gc, i);
      Gc = __fmul_rn(Gc, f);
      Gn = __fmul_rn(Gn, f);
      const float a = __fmul_rn(df, f), cc = __fmul_rn(di, i);
      const float dmn = __fsub_rn(__fsub_rn(Gm, a), cc);
      Gm = __fadd_rn(a, __fmul_rn(dmn, max_share(lfm, li)));
      const float dzp = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(z, z)));
      const float dip = __fadd_rn(cc, __fmul_rn(dmn, max_share(li, lfm)));
      const float dfp = __fmul_rn(Gm, sigmoid(-fp));
      const float dop = __fmul_rn(__fmul_rn(__fmul_rn(dx, c), o),
                                  __fsub_rn(1.0f, o));
      dzx[x] = dzp;
      dix[x] = dip;
      dfx[x] = dfp;
      dox[x] = dop;
      sD[tid] = dzp;
      sD[E + tid] = dip;
      sD[2 * E + tid] = dfp;
      sD[3 * E + tid] = dop;
    }
    __syncthreads();                 // dpre_t of this block's columns
    const float hp = t > 0 ? y[g - step + row] : h0[sbase + row];
    float part = 0.0f;
#pragma unroll
    for (int kq = 0; kq < ROWS; ++kq) {
      const float d = sD[half * ROWS + kq];
      dR[kq] = __fadd_rn(dR[kq], __fmul_rn(hp, d));
      part = __fadd_rn(part, __fmul_rn(Rr[kq], d));
    }
    part = __fadd_rn(part, __shfl_xor_sync(kFull, part, 1));
    if (half == 0) st_cluster(&sSlot[buf][q][row % E], row / E, part);
    cluster_sync();                  // every block's partials have landed
    if (owner) {
      float acc = 0.0f;
#pragma unroll
      for (int p = 0; p < kS3Cluster; ++p) acc = __fadd_rn(acc, sSlot[buf][p][tid]);
      Gh = acc;                      // the adjoint of h_{t-1}
    }
    buf ^= 1;
  }
  if (owner) {
    dc0[sbase + me] = Gc;
    dn0[sbase + me] = Gn;
    dm0[sbase + me] = Gm;
    dh0[sbase + me] = Gh;
  }
#pragma unroll
  for (int kq = 0; kq < ROWS; ++kq) {
    const int lc = half * ROWS + kq;
    dRb[((long long)bh * HD + row) * (4 * HD) + (lc / E) * HD + (int)q * E +
        lc % E] = dR[kq];
  }
}

template <int ROWS>
int launch_slstm_bwd(const float* R, const float* c0, const float* n0,
                     const float* m0, const float* h0, const float* y,
                     const float* dy, const float* dc, const float* dn,
                     const float* dm, const float* dh, const float* saved,
                     float* dzx, float* dix, float* dfx, float* dox,
                     float* dRb, float* dc0, float* dn0, float* dm0,
                     float* dh0, int B, int T, int H, cudaStream_t stream) {
  constexpr int HD = 4 * ROWS;
  slstm_scan_bwd_kernel<ROWS><<<B * H * kS3Cluster, 2 * HD, 0, stream>>>(
      R, c0, n0, m0, h0, y, dy, dc, dn, dm, dh, saved, dzx, dix, dfx, dox,
      dRb, dc0, dn0, dm0, dh0, T, H);
  return (int)cudaGetLastError();
}

// --------------------------------------------------- S3b, the short step
// Steps of a staged window: the reverse walk's per-step constants of a
// window for the block's E elements, one (step, element) a thread.
constexpr int kS3bWindow = 16;
constexpr int kS3bCoef = 13;         // constants a (step, element)

// A (step, element)'s saved values (csrc/ssm_scan.cu's planes c, n, m, z,
// i, f, o at t, c, n, m at t - 1 or the carried state, and dy at t), read
// a window ahead of their use.
struct S3bRaw {
  float c, n, m, zp, li, fp, op, cp, np, mp, dy;
};

__device__ __forceinline__ S3bRaw s3b_load(
    const float* __restrict__ saved, const float* __restrict__ dy,
    const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, long long plane, long long x,
    long long step, long long s0, int t) {
  S3bRaw r;
  r.c = saved[x];
  r.n = saved[plane + x];
  r.m = saved[2 * plane + x];
  r.zp = saved[3 * plane + x];
  r.li = saved[4 * plane + x];
  r.fp = saved[5 * plane + x];
  r.op = saved[6 * plane + x];
  r.dy = dy[x];
  if (t > 0) {
    r.cp = saved[x - step];
    r.np = saved[plane + x - step];
    r.mp = saved[2 * plane + x - step];
  } else {
    r.cp = c0[s0];
    r.np = n0[s0];
    r.mp = m0[s0];
  }
  return r;
}

// The reverse step's constants of one (step, element), off the adjoint's
// chain: with h = o c / den, den = max(|n|, 1), the step is linear in
// (G_h + dy, G_c, G_n, G_m); its coefficients in the twin's formulas
// (JAX's tie shares), 1 / den taken once.
__device__ __forceinline__ void s3b_coef(const S3bRaw& r, float* co,
                                         int stride) {
  const float z = tanhf(r.zp), o = sigmoid(r.op);
  const float lfm = __fadd_rn(log_sigmoid(r.fp), r.mp);
  const float f = expf(__fsub_rn(lfm, r.m));
  const float i = expf(__fsub_rn(r.li, r.m));
  const float den = fmaxf(fabsf(r.n), 1.0f), rden = __frcp_rn(den);
  const float xo = __fmul_rn(o, r.c);
  co[0 * stride] = __fmul_rn(o, rden);                        // d G_c / d gh
  co[1 * stride] = __fmul_rn(-__fdiv_rn(xo, __fmul_rn(den, den)),
                             __fmul_rn(max_share(fabsf(r.n), 1.0f),
                                       sign0(r.n)));          // d G_n / d gh
  co[2 * stride] = r.cp;
  co[3 * stride] = r.np;
  co[4 * stride] = z;
  co[5 * stride] = i;
  co[6 * stride] = f;
  co[7 * stride] = max_share(lfm, r.li);
  co[8 * stride] = max_share(r.li, lfm);
  co[9 * stride] = __fsub_rn(1.0f, __fmul_rn(z, z));
  co[10 * stride] = sigmoid(-r.fp);
  co[11 * stride] = __fmul_rn(__fmul_rn(__fmul_rn(r.c, o), __fsub_rn(1.0f, o)),
                              rden);                          // d o_pre / d gh
  co[12 * stride] = r.dy;
}

// S3b's reverse walk, one cluster of 8 blocks a (b, h) as the forward:
// block q's E = hd / 8 owner threads carry their elements' adjoints of c,
// n, m and h.  Of the block's 4 E columns of R (E of each gate), a thread
// holds two rows' E columns of one gate: a lane quad is a row pair's four
// gates.  A step: each owner waits on its block's mbarrier for the 8
// partials of dh_t (st.async from the cluster's blocks), adds them in
// block order, and takes the step's constants (staged a window at a time
// by all threads) through a dozen dependent multiply-adds to the four
// pre-activations' adjoints dpre_t, which it writes to dzx..dox and to
// shared memory; one block barrier; every thread sums its two rows' E
// terms (each value read from shared memory serves two rows: the reads,
// not the multiply-adds, bound this phase), the quad adds its four gates
// by two shuffles, and each row's owner block receives its sum by
// st.async.  No cluster barrier within the walk: each block waits only
// for its own data.  The slots and mbarriers
// alternate by step; an mbarrier is re-armed (arrive + expect_tx) as soon
// as its phase is consumed, before this block sends the partials that let
// any block store into it again.  dR = sum h_{t-1} (x) dpre_t is not on the
// walk: `slstm_dR_kernel` takes it from dzx..dox and y afterwards.
template <int ROWS>
__global__ void __cluster_dims__(kS3Cluster, 1, 1)
    __launch_bounds__(8 * ROWS) slstm_bwd_short_kernel(
        const float* __restrict__ R, const float* __restrict__ c0,
        const float* __restrict__ n0, const float* __restrict__ m0,
        const float* __restrict__ dy, const float* __restrict__ dc,
        const float* __restrict__ dn, const float* __restrict__ dm,
        const float* __restrict__ dh, const float* __restrict__ saved,
        float* __restrict__ dzx, float* __restrict__ dix,
        float* __restrict__ dfx, float* __restrict__ dox,
        float* __restrict__ dc0, float* __restrict__ dn0,
        float* __restrict__ dm0, float* __restrict__ dh0, int T, int H) {
  constexpr int HD = 4 * ROWS;
  constexpr int E = HD / kS3Cluster;           // state elements a block
  constexpr int NTHR = 8 * ROWS;               // 2 a row of R, = 16 E
  constexpr int W = kS3bWindow;
  static_assert(NTHR == W * E, "one (step, element) a thread a window");
  __shared__ float sCo[kS3bCoef][W][E];        // the window's constants
  __shared__ __align__(16) float sD[2][4 * E]; // dpre_t of the block's columns
  __shared__ float sSlot[2][kS3Cluster][E];    // dh partials, by source
  __shared__ __align__(8) unsigned long long sBar[2];
  const unsigned q = cluster_rank();
  const int bh = blockIdx.x / kS3Cluster;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int gate = tid & 3, rp = tid >> 2;     // R's rows 2 rp, 2 rp + 1
  float Rr[2][E];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < E; ++c)
      Rr[i][c] = R[((long long)h * HD + 2 * rp + i) * (4 * HD) + gate * HD +
                   (int)q * E + c];
  const long long sbase = (long long)bh * HD;
  const bool owner = tid < E;                  // carries element me
  const int me = (int)q * E + tid;
  const long long plane = (long long)(gridDim.x / kS3Cluster) * T * HD;
  const long long step = (long long)H * HD;    // one time step in (B,T,H,hd)
  constexpr unsigned kBytes = kS3Cluster * E * sizeof(float);
  if (tid == 0) {
    mbar_init(smem_addr(&sBar[0]), 1);
    mbar_init(smem_addr(&sBar[1]), 1);
    mbar_init_fence_cluster();
    mbar_expect_tx(smem_addr(&sBar[0]), kBytes);  // their first phases
    mbar_expect_tx(smem_addr(&sBar[1]), kBytes);
  }
  // dh's 8 partials of this block's element tid, in block order.
  auto gather = [&](int sb) {
    float acc = 0.0f;
#pragma unroll
    for (int p = 0; p < kS3Cluster; ++p)
      acc = __fadd_rn(acc, sSlot[sb][p][tid]);
    return acc;
  };
  float Gc = 0.0f, Gn = 0.0f, Gm = 0.0f, Gh = 0.0f;
  if (owner) {
    Gc = dc[sbase + me];
    Gn = dn[sbase + me];
    Gm = dm[sbase + me];
    Gh = dh[sbase + me];
  }
  // This thread's (step, element) of each window, a window ahead.
  const int wt = tid / E, we = tid % E;
  const int nW = (T + W - 1) / W;
  S3bRaw raw{};
  auto fetch = [&](int w) {
    const int t = w * W + wt;
    if (w >= 0 && t < T)
      raw = s3b_load(saved, dy, c0, n0, m0, plane,
                     (((long long)b * T + t) * H + h) * HD + (int)q * E + we,
                     step, sbase + (int)q * E + we, t);
  };
  fetch(nW - 1);
  cluster_sync();                    // every block started, its mbarriers set
  int k = 0;                         // reverse steps taken
  for (int w = nW - 1; w >= 0; --w) {
    const int t0 = w * W, n = min(W, T - t0);
    __syncthreads();                 // the last window's constants are read
    if (wt < n) s3b_coef(raw, &sCo[0][wt][we], W * E);
    fetch(w - 1);                    // the next window's loads, in flight
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt, ++k) {
      const int db = k & 1;
      if (owner) {
        float co[kS3bCoef];
#pragma unroll
        for (int j = 0; j < kS3bCoef; ++j) co[j] = sCo[j][tt][tid];
        if (k > 0) {                 // the partials of step k - 1
          const int sb = (k - 1) & 1;
          mbar_wait_cluster(smem_addr(&sBar[sb]), ((k - 1) >> 1) & 1);
          Gh = gather(sb);           // the adjoint of h_t
          if (tid == 0) mbar_expect_tx(smem_addr(&sBar[sb]), kBytes);
        }
        const float gh = __fadd_rn(co[12], Gh);
        Gc = __fmaf_rn(gh, co[0], Gc);
        Gn = __fmaf_rn(gh, co[1], Gn);
        const float df = __fmaf_rn(Gc, co[2], __fmul_rn(Gn, co[3]));
        const float di = __fmaf_rn(Gc, co[4], Gn);
        const float dz = __fmul_rn(Gc, co[5]);
        Gc = __fmul_rn(Gc, co[6]);
        Gn = __fmul_rn(Gn, co[6]);
        const float a = __fmul_rn(df, co[6]), cc = __fmul_rn(di, co[5]);
        const float dmn = __fsub_rn(__fsub_rn(Gm, a), cc);
        Gm = __fmaf_rn(dmn, co[7], a);
        const float dzp = __fmul_rn(dz, co[9]);
        const float dip = __fmaf_rn(dmn, co[8], cc);
        const float dfp = __fmul_rn(Gm, co[10]);
        const float dop = __fmul_rn(gh, co[11]);
        sD[db][tid] = dzp;
        sD[db][E + tid] = dip;
        sD[db][2 * E + tid] = dfp;
        sD[db][3 * E + tid] = dop;
        const long long x =
            (((long long)b * T + t0 + tt) * H + h) * HD + me;
        dzx[x] = dzp;
        dix[x] = dip;
        dfx[x] = dfp;
        dox[x] = dop;
      }
      __syncthreads();               // dpre_t of this block's columns
      // Two rows' E terms of this gate, two chains a row.
      const float2* d2 = reinterpret_cast<const float2*>(&sD[db][gate * E]);
      float a0 = 0.0f, a1 = 0.0f, b0 = 0.0f, b1 = 0.0f;
#pragma unroll
      for (int c = 0; c < E / 2; ++c) {
        const float2 d = d2[c];
        a0 = __fmaf_rn(Rr[0][2 * c], d.x, a0);
        a1 = __fmaf_rn(Rr[0][2 * c + 1], d.y, a1);
        b0 = __fmaf_rn(Rr[1][2 * c], d.x, b0);
        b1 = __fmaf_rn(Rr[1][2 * c + 1], d.y, b1);
      }
      // The quad's four gates (the same sum in every lane: IEEE addition
      // commutes), then row 2 rp from lane 0 and row 2 rp + 1 from lane 1.
      float s0 = __fadd_rn(a0, a1), s1 = __fadd_rn(b0, b1);
      s0 = __fadd_rn(s0, __shfl_xor_sync(kFull, s0, 1));
      s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, 1));
      s0 = __fadd_rn(s0, __shfl_xor_sync(kFull, s0, 2));
      s1 = __fadd_rn(s1, __shfl_xor_sync(kFull, s1, 2));
      if (gate < 2) {
        const int row = 2 * rp + gate;
        st_async(&sSlot[db][q][row % E], row / E, gate ? s1 : s0,
                 &sBar[db]);
      }
    }
  }
  if (owner) {
    if (k > 0) {                     // dh_{-1}: the adjoint of h0
      const int sb = (k - 1) & 1;
      mbar_wait_cluster(smem_addr(&sBar[sb]), ((k - 1) >> 1) & 1);
      Gh = gather(sb);
    }
    dc0[sbase + me] = Gc;
    dn0[sbase + me] = Gn;
    dm0[sbase + me] = Gm;
    dh0[sbase + me] = Gh;
  }
  cluster_sync();                    // no block leaves while stores may land
}

// dR's per-batch-row partials: dRb[b, h] = sum_t h_{t-1} (x) dpre_t (h_{-1}
// = h0), a (hd, T) x (T, 4 hd) product a (b, h).  A block a 64 x 64 tile
// of one gate's columns, 4 x 4 a thread, over T in stages of 32 steps
// through shared memory (double-buffered: the next stage's loads are in
// flight while this one's multiply-adds run), each output's sum in time
// order.
constexpr int kDRTile = 64;
constexpr int kDRStep = 32;
constexpr int kDRThreads = 256;
constexpr int kDRLoads = kDRStep * kDRTile / kDRThreads;   // a thread a stage

// Two blocks an SM (at most 128 registers a thread): one alone left each
// stage's loads exposed.
__global__ void __launch_bounds__(kDRThreads, 2) slstm_dR_kernel(
    const float* __restrict__ y, const float* __restrict__ h0,
    const float* __restrict__ dzx, const float* __restrict__ dix,
    const float* __restrict__ dfx, const float* __restrict__ dox,
    float* __restrict__ dRb, int T, int H, int hd) {
  __shared__ __align__(16) float sA[2][kDRStep][kDRTile];  // h_{t-1}[k]
  __shared__ __align__(16) float sB[2][kDRStep][kDRTile];  // dpre_t[e]
  const int tiles = (hd + kDRTile - 1) / kDRTile;
  const int gate = blockIdx.x / tiles, e0 = (blockIdx.x % tiles) * kDRTile;
  const int k0 = blockIdx.y * kDRTile;
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const float* __restrict__ dp =
      gate == 0 ? dzx : gate == 1 ? dix : gate == 2 ? dfx : dox;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long step = (long long)H * hd;     // one time step
  const long long base = ((long long)b * T * H + h) * hd;
  float ra[kDRLoads], rb[kDRLoads];
  auto fetch = [&](int s0) {
#pragma unroll
    for (int j = 0; j < kDRLoads; ++j) {
      const int e = tid + j * kDRThreads;
      const int t = s0 + e / kDRTile, c = e % kDRTile;
      const int kk = k0 + c, ee = e0 + c;
      ra[j] = (t < T && kk < hd)
                  ? (t > 0 ? y[base + (t - 1) * step + kk]
                           : h0[(long long)bh * hd + kk])
                  : 0.0f;
      rb[j] = (t < T && ee < hd) ? dp[base + t * step + ee] : 0.0f;
    }
  };
  float acc[4][4] = {};
  fetch(0);
  int buf = 0;
  for (int s0 = 0; s0 < T; s0 += kDRStep, buf ^= 1) {
#pragma unroll
    for (int j = 0; j < kDRLoads; ++j) {
      const int e = tid + j * kDRThreads;
      sA[buf][e / kDRTile][e % kDRTile] = ra[j];
      sB[buf][e / kDRTile][e % kDRTile] = rb[j];
    }
    __syncthreads();                 // the stage is in; buf ^ 1 is free
    if (s0 + kDRStep < T) fetch(s0 + kDRStep);
#pragma unroll 8
    for (int tt = 0; tt < kDRStep; ++tt) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[buf][tt][4 * ty]);
      const float4 d = *reinterpret_cast<const float4*>(&sB[buf][tt][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(av[i], dv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + 4 * ty + i;
    if (kk >= hd) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ee = e0 + 4 * tx + j;
      if (ee < hd)
        dRb[((long long)bh * hd + kk) * (4 * hd) + gate * hd + ee] =
            acc[i][j];
    }
  }
}

template <int ROWS>
int launch_slstm_bwd_short(const float* R, const float* c0, const float* n0,
                           const float* m0, const float* dy, const float* dc,
                           const float* dn, const float* dm, const float* dh,
                           const float* saved, float* dzx, float* dix,
                           float* dfx, float* dox, float* dc0, float* dn0,
                           float* dm0, float* dh0, int B, int T, int H,
                           cudaStream_t stream) {
  constexpr int HD = 4 * ROWS;
  slstm_bwd_short_kernel<ROWS><<<B * H * kS3Cluster, 2 * HD, 0, stream>>>(
      R, c0, n0, m0, dy, dc, dn, dm, dh, saved, dzx, dix, dfx, dox, dc0, dn0,
      dm0, dh0, T, H);
  return (int)cudaGetLastError();
}

// S3b's latency floor: the reverse walk's handshake alone, on its cluster
// shape (8 blocks of 2 hd threads a (b, h)), T steps of it with no gate
// arithmetic, no loads and no products: owners publish, one block barrier,
// one thread of two sends a row's partial to its owner block.  MBAR: the
// short step's handshake (st.async, each owner waiting on its block's
// mbarrier); else the barrier kernel's (plain remote stores, a cluster
// barrier).
template <int ROWS, bool MBAR>
__global__ void __cluster_dims__(kS3Cluster, 1, 1)
    __launch_bounds__(8 * ROWS) slstm_handshake_kernel(float* __restrict__ out,
                                                       int T) {
  constexpr int HD = 4 * ROWS;
  constexpr int E = HD / kS3Cluster;
  constexpr unsigned kBytes = kS3Cluster * E * sizeof(float);
  __shared__ float sD[2][E];
  __shared__ float sSlot[2][kS3Cluster][E];
  __shared__ __align__(8) unsigned long long sBar[2];
  const unsigned q = cluster_rank();
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const bool owner = tid < E;
  if (MBAR && tid == 0) {
    mbar_init(smem_addr(&sBar[0]), 1);
    mbar_init(smem_addr(&sBar[1]), 1);
    mbar_init_fence_cluster();
    mbar_expect_tx(smem_addr(&sBar[0]), kBytes);
    mbar_expect_tx(smem_addr(&sBar[1]), kBytes);
  }
  float g = (float)tid;
  cluster_sync();
  for (int k = 0; k < T; ++k) {
    const int db = k & 1;
    if (owner) {
      if (k > 0) {
        const int sb = (k - 1) & 1;
        if (MBAR) {
          mbar_wait_cluster(smem_addr(&sBar[sb]), ((k - 1) >> 1) & 1);
          if (tid == 0) mbar_expect_tx(smem_addr(&sBar[sb]), kBytes);
        }
        float acc = 0.0f;
#pragma unroll
        for (int p = 0; p < kS3Cluster; ++p)
          acc = __fadd_rn(acc, sSlot[sb][p][tid]);
        g = acc;
      }
      sD[db][tid] = g;
    }
    __syncthreads();
    const float part = sD[db][row % E];
    if (half == 0) {
      if (MBAR) st_async(&sSlot[db][q][row % E], row / E, part, &sBar[db]);
      else st_cluster(&sSlot[db][q][row % E], row / E, part);
    }
    if (!MBAR) cluster_sync();
  }
  if (owner && MBAR && T > 0) {
    const int sb = (T - 1) & 1;
    mbar_wait_cluster(smem_addr(&sBar[sb]), ((T - 1) >> 1) & 1);
  }
  cluster_sync();
  if (owner) out[blockIdx.x * E + tid] = g;
}

}  // namespace

extern "C" {

// S1b on contiguous float32 tensors: S1's operands (s0 is read through
// ckpt), dy (B, T, H, hd), dsT (B, H, ds, hd), ckpt from mamba2_scan_ckpt,
// scratch (B H, kS1Ckpt, ds hd) -> d decay (B, T, H), the per-head dB and
// dC (B, T, H, ds), d dtx (B, T, H, hd), d s0 (B, H, ds, hd).  S1's widths.
int mamba2_scan_bwd(const float* decay, const float* Bm, const float* Cm,
                    const float* dtx, const float* s0, const float* dy,
                    const float* dsT, const float* ckpt, float* scratch,
                    float* ddecay, float* dBh, float* dCh, float* ddtx,
                    float* ds0, int B, int T, int H, int ds, int hd,
                    cudaStream_t stream) {
  (void)s0;
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd <= 0 || hd > 256 || hd % 8 != 0 || ds % 4 != 0)
    return (int)cudaErrorInvalidValue;
#define S1(R)                                                              \
  case R:                                                                  \
    return launch_mamba2_bwd<R>(decay, Bm, Cm, dtx, dy, dsT, ckpt, scratch, \
                                ddecay, dBh, dCh, ddtx, ds0, B, T, H, hd,  \
                                stream)
  switch (ds / 4) {
    S1(1); S1(2); S1(4); S1(8); S1(16); S1(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S1
}

// S2b: S2's operands, y, dy (B, T, H, hd), dC, dn, dm (S2's final state's
// shapes), the checkpoints of mlstm_scan_ckpt, scratch (B H slices,
// kS2Chunk, hd cols), (B H slices, kS2Chunk, hd) and mt (B, T, H) -> the
// per-slice dq and dk (slices, B, T, H, hd), dv (B, T, H, hd), the
// per-slice d f and d i (2, slices, B, T, H), d log_i, d log_f (B, T, H),
// dC0, dn0, dm0.  Two launches: the slices, then the stabiliser chain.
int mlstm_scan_bwd(const float* q, const float* k, const float* v,
                   const float* li, const float* lf, const float* C0,
                   const float* n0, const float* m0, const float* y,
                   const float* dy, const float* dC, const float* dn,
                   const float* dm, const float* Cck, const float* nck,
                   const float* mck, float* scrC, float* scrN, float* mt,
                   float* dq, float* dk, float* dv, float* dfi, float* dli,
                   float* dlf, float* dC0, float* dn0, float* dm0, int B,
                   int T, int H, int hd, cudaStream_t stream) {
  (void)C0;
  (void)n0;
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd % 4 != 0) return (int)cudaErrorInvalidValue;
#define S2(R)                                                              \
  case R:                                                                  \
    return launch_mlstm_bwd<R>(q, k, v, li, lf, m0, y, dy, dC, dn, dm, Cck, \
                               nck, mck, scrC, scrN, mt, dq, dk, dv, dfi,  \
                               dli, dlf, dC0, dn0, dm0, B, T, H, stream)
  switch (hd / 4) {
    S2(2); S2(4); S2(8); S2(16); S2(24); S2(32); S2(48);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S2
}

// S3b: S3's operands (zx, ix, fx, ox are read through saved), y, dy (B,
// T, H, hd), dc, dn, dm, dh (B, H, hd), saved from slstm_scan_save -> dzx,
// dix, dfx, dox (B, T, H, hd), the per-row dR (B, H, hd, 4 hd), dc0, dn0,
// dm0, dh0.  S3's widths.
int slstm_scan_bwd(const float* zx, const float* ix, const float* fx,
                   const float* ox, const float* R, const float* c0,
                   const float* n0, const float* m0, const float* h0,
                   const float* y, const float* dy, const float* dc,
                   const float* dn, const float* dm, const float* dh,
                   const float* saved, float* dzx, float* dix, float* dfx,
                   float* dox, float* dRb, float* dc0, float* dn0,
                   float* dm0, float* dh0, int B, int T, int H, int hd,
                   cudaStream_t stream) {
  (void)zx;
  (void)ix;
  (void)fx;
  (void)ox;
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
#define S3(R_)                                                             \
  case R_:                                                                 \
    return launch_slstm_bwd<R_>(R, c0, n0, m0, h0, y, dy, dc, dn, dm, dh,   \
                                saved, dzx, dix, dfx, dox, dRb, dc0, dn0,  \
                                dm0, dh0, B, T, H, stream)
  switch (hd / 4) {
    S3(4); S3(8); S3(12); S3(16); S3(24); S3(32); S3(48); S3(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S3
}

// S3b's reverse walk on the short step (slstm_bwd_short_kernel): S3's R,
// c0, n0, m0, dy (B, T, H, hd), dc, dn, dm, dh (B, H, hd), saved from
// slstm_scan_save -> dzx, dix, dfx, dox (B, T, H, hd), dc0, dn0, dm0, dh0.
// S3's widths.  slstm_dR then takes dR from its outputs.
int slstm_scan_bwd_short(const float* R, const float* c0, const float* n0,
                         const float* m0, const float* dy, const float* dc,
                         const float* dn, const float* dm, const float* dh,
                         const float* saved, float* dzx, float* dix,
                         float* dfx, float* dox, float* dc0, float* dn0,
                         float* dm0, float* dh0, int B, int T, int H, int hd,
                         cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd % 16 != 0) return (int)cudaErrorInvalidValue;
#define S3S(R_)                                                            \
  case R_:                                                                 \
    return launch_slstm_bwd_short<R_>(R, c0, n0, m0, dy, dc, dn, dm, dh,    \
                                      saved, dzx, dix, dfx, dox, dc0, dn0, \
                                      dm0, dh0, B, T, H, stream)
  switch (hd / 4) {
    S3S(4); S3S(8); S3S(12); S3S(16); S3S(24); S3S(32); S3S(48); S3S(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S3S
}

// S3b's dR per batch row (slstm_dR_kernel): y (B, T, H, hd), h0 (B, H,
// hd) and the pre-activations' adjoints dzx..dox (B, T, H, hd) -> dRb (B,
// H, hd, 4 hd), summed over B by the wrapper.
int slstm_dR(const float* y, const float* h0, const float* dzx,
             const float* dix, const float* dfx, const float* dox,
             float* dRb, int B, int T, int H, int hd, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (hd + kDRTile - 1) / kDRTile;
  const dim3 grid(4 * tiles, tiles, B * H);
  slstm_dR_kernel<<<grid, kDRThreads, 0, stream>>>(y, h0, dzx, dix, dfx, dox,
                                                    dRb, T, H, hd);
  return (int)cudaGetLastError();
}

// S3b's handshake floor at hd (S3's widths): B H clusters, T steps; mbar
// non-zero for the short step's handshake, zero for the cluster barrier.  out
// (B H 8 hd / 8) receives a value a thread so that nothing is elided.
int slstm_handshake_floor(float* out, int mbar, int B, int T, int H, int hd,
                          cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const int grid = B * H * kS3Cluster;
#define S3F(R_)                                                              \
  case R_:                                                                   \
    if (mbar)                                                                \
      slstm_handshake_kernel<R_, true><<<grid, 8 * R_, 0, stream>>>(out, T); \
    else                                                                     \
      slstm_handshake_kernel<R_, false><<<grid, 8 * R_, 0, stream>>>(out, T);\
    return (int)cudaGetLastError()
  switch (hd / 4) {
    S3F(4); S3F(8); S3F(12); S3F(16); S3F(24); S3F(32); S3F(48); S3F(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef S3F
}

// The stabiliser's backward kernel of mlstm_scan_bwd alone (its second
// launch), for timing: the same operands; mt is its scratch.
int mlstm_gates_bwd_seq(const float* li, const float* lf, const float* m0,
                        const float* dm, const float* dfi, float* mt,
                        float* dli, float* dlf, float* dm0, int B, int T,
                        int H, int slices, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  mlstm_gates_bwd_kernel<<<(B * H + 31) / 32, 32, 0, stream>>>(
      li, lf, m0, dm, dfi, mt, dli, dlf, dm0, B * H, T, H, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
