// S2b in the chunked form, for Hopper (sm_90a): the mLSTM recurrence's
// backward with the products of a chunk on the TF32 tensor cores.  Plain C
// interface for ctypes.
//
// No Pallas kernel is replaced: this replaces, for long sequences, the
// reverse-mode autodiff of the `lax.scan` of the JAX package's
// src/repro/models/ssm.py:159 (the mLSTM recurrence), which
// csrc/ssm_scan_bwd.cu's `mlstm_scan_bwd_kernel` runs one step at a time.
// kernels/ref.py: mlstm_chunked_bwd_plain is this file's arithmetic in
// plain PyTorch.
//
// The form.  The stabiliser m_t = max(log_f_t + m_{t-1}, log_i_t) depends
// on the gates alone, so given m the gates f_t = exp(log_f_t + m_{t-1} -
// m_t) and i_t = exp(log_i_t - m_t) lie in [0, 1] and C_t = f_t C_{t-1} +
// k_t (i_t v_t)^T, n_t = f_t n_{t-1} + i_t k_t are one Mamba2 recurrence
// (csrc/ssd_chunked.cu) with decay f, B = k, C = q (a head's own), u = [i
// v | i] and state [C | n]: n is an extra value column.  Its read-out [num
// | q . n] has the adjoint [dy / den | d(q . n)], den = max(|q . n|, 1),
// d(q . n) = -<dy, y> / den through max(|.|, 1) (JAX's ties).  Each chunk
// of L steps then takes S1b's chunked backward (ssd_chunked.cu's header):
// dq = dC, dk = dB, d f = d decay, dv = i du, d i = <du, [v | 1]>.
//
// * `mlstm_chunked_bwd_kernel<L, HD>`: one block of 8 warps a (b, h, tile
//   of kVT = 32 value columns of [v | n]): hd / 32 tiles of v and one more
//   for the n column (the rest of that tile is zeros), 112 blocks at
//   xlstm-125m's (B, H, hd) = (4, 4, 192), one wave on 132 SMs.  A block
//   walks the chunks last first with its tile of the adjoint A (hd x 32,
//   the end state's; dC and dn first) in shared memory.  Every column of
//   the state evolves alone, so only the products that sum over the value
//   columns cross tiles: D = dY U^T, dq, dk, d f and d i, which each tile
//   leaves as partials (dq, dk: (tiles, B, T, H, hd); d f, d i: (2,
//   tiles, B, T, H)) that the wrapper and the gates kernel add in tile
//   order: no atomics, the same bits run to run.  G = q k^T, the chunk's
//   gates and q . n (so den) are computed by every tile of a (b, h).  A
//   chunk's start state is read from the forward's saving variant (csrc/
//   ssm_scan.cu: C, n and m before every kS2Chunk-th step, C in its
//   thread-register layout, 16-byte groups of 4 rows of one column).  Tile
//   0 writes m_t.
// * `mlstm_gates_chunked_bwd_kernel`: the stabiliser's backward, one block
//   a (b, h): all threads compute a window's a = d f f, c = d i i and the
//   tie shares from m_t (the tiles' partials added in order), then one
//   thread walks the window's chain G_m <- a + (G_m - a - c) w_l in reverse
//   from shared memory: d log_f, d log_i, d m0.  The arithmetic of
//   ssm_scan_bwd.cu's `mlstm_gates_bwd_kernel`, its loads off the chain.
//
// Precision: the products are ssd_chunked.cu's 3xTF32 mma.sync
// (csrc/chunked.cuh); the rest f32 in the model's order.
//
// Bound.  At (B, T, H, hd) = (4, 1024, 4, 192) the op reads its operands
// and writes its gradients once: 108 MB, 0.032 ms at 3.35 TB/s; its chunk
// products counted once (the chunk states' among them) are 7.1 GFLOP,
// 0.014 ms at 495 TFLOP/s TF32 (chip_smoke.py's _mlstm_chunked_flops):
// bytes bound it.  What bounds this design: a tile's block walks the T / L
// chunks in order, each a dozen barriers and ~540 mma.sync a warp, issue-
// bound like S1b's (every fragment element gathered and split at each use).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssm_scan.cuh"
#include "chunked.cuh"

namespace {

constexpr int kL = 32;           // steps a chunk (ssm_scan.S2_CHUNK);
                                 // the entry refuses other L
constexpr int kVT = 32;          // value columns of [v | n] a tile
constexpr int kThreads = 256;    // 8 warps
constexpr int kNW = kThreads / 32;

template <int L, int HD>
struct MlstmTiles {
  static constexpr int NT = HD / kVT + 1;             // tiles of [v | n]
  static constexpr int ROWS = HD / 4;                 // S2's checkpoint rows
  static constexpr int PV = WarpTile<L, kVT, kNW>::WN;  // dU's column warps
  static constexpr int PQ = WarpTile<L, HD, kNW>::WN;   // dq's
  static constexpr int PD = WarpTile<L, L, kNW>::WM;    // F's row warps
  // Q, K; v, U, dY; S^T, A^T; seg, G, D; n; 11 vectors of L and m before
  // the chunk; v, d i, q and d f partials; <A, S>'s warps.
  static constexpr int FLOATS = 2 * L * HD + 3 * L * kVT + 2 * kVT * HD +
                                3 * L * L + HD + 11 * L + 1 +
                                (2 * PV + PQ + PD) * L + kNW;
};

template <int L, int HD>
__global__ void __launch_bounds__(kThreads) mlstm_chunked_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, const float* __restrict__ y,
    const float* __restrict__ dy, const float* __restrict__ dC,
    const float* __restrict__ dn, const float* __restrict__ Cck,
    const float* __restrict__ nck, const float* __restrict__ mck,
    float* __restrict__ mt, float* __restrict__ dqp, float* __restrict__ dkp,
    float* __restrict__ dv, float* __restrict__ dfi, float* __restrict__ dC0,
    float* __restrict__ dn0, int T, int H) {
  using P = MlstmTiles<L, HD>;
  using RowTile = WarpTile<L, L, kNW>;
  constexpr int NT = P::NT, ROWS = P::ROWS;
  constexpr int TPR = kThreads / L;        // threads a row of a chunk
  static_assert(L % kS2Chunk == 0 && TPR <= 32 && L < kThreads,
                "chunks of whole checkpoint intervals");
  extern __shared__ float smem[];
  float* sQ = smem;                        // [L][HD]
  float* sK = sQ + L * HD;                 // [L][HD]
  float* sVx = sK + L * HD;                // [L][kVT]: v's tile, or [1 | 0]
  float* sU = sVx + L * kVT;               // [L][kVT]: i v
  float* sDY = sU + L * kVT;               // [L][kVT]: dy / den, or d(q . n)
  float* sST = sDY + L * kVT;              // [kVT][HD]: start state^T
  float* sAT = sST + kVT * HD;             // [kVT][HD]: end state's adjoint^T
  float* sSeg = sAT + kVT * HD;            // [L][L]
  float* sG = sSeg + L * L;                // [L][L]
  float* sD = sG + L * L;                  // [L][L]
  float* sN = sD + L * L;                  // [HD]: n at the chunk's start
  float* sDec = sN + HD;                   // [L]: f
  float* sI = sDec + L;                    // [L]
  float* sP = sI + L;                      // [L]
  float* sW = sP + L;                      // [L]
  float* sV = sW + L;                      // [L]: v_s
  float* sQv = sV + L;                     // [L]: q_t
  float* sLi = sQv + L;                    // [L]
  float* sLf = sLi + L;                    // [L]
  float* sMt = sLf + L;                    // [L]: m_t
  float* sDen = sMt + L;                   // [L]
  float* sDyy = sDen + L;                  // [L]: <dy_t, y_t>
  float* sM0 = sDyy + L;                   // [1]: m before the chunk
  float* sVp = sM0 + 1;                    // [PV][L]
  float* sIp = sVp + P::PV * L;            // [PV][L]
  float* sQp = sIp + P::PV * L;            // [PQ][L]
  float* sDp = sQp + P::PQ * L;            // [PD][L]
  float* sAS = sDp + P::PD * L;            // [kNW]
  const int bh = blockIdx.x / NT, J = blockIdx.x % NT;
  const int b = bh / H, h = bh % H;
  const bool has_n = J == NT - 1;          // the n column's tile
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nC = (T + L - 1) / L, nCk = (T + kS2Chunk - 1) / kS2Chunk;
  const long long sbase = (long long)bh * HD;
  const long long BTH = (long long)(gridDim.x / NT) * T;   // B H T
  // The adjoint's tile, transposed: column c of [C | n] is row c of sAT.
  for (int e = tid; e < kVT * HD; e += kThreads) {
    const int c = e / HD, kk = e % HD;
    float a = 0.0f;
    if (!has_n) a = dC[(sbase + kk) * HD + J * kVT + c];
    else if (c == 0) a = dn[sbase + kk];
    sAT[at<HD>(c, kk)] = a;
    if (has_n) sST[at<HD>(c, kk)] = 0.0f;  // the n tile's zero columns
  }
  if (has_n)
    for (int e = tid; e < L * kVT; e += kThreads) {
      sVx[at<kVT>(e / kVT, e % kVT)] = (e % kVT) == 0 ? 1.0f : 0.0f;
      sDY[at<kVT>(e / kVT, e % kVT)] = 0.0f;
    }
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * L, n = min(L, T - t0);
    const long long ck = (long long)bh * nCk + c * (L / kS2Chunk);
    __syncthreads();                 // the last chunk is done with smem
    constexpr int HQ = HD / 4;       // 16-byte groups of a row
    for (int e = tid; e < L * HQ; e += kThreads) {
      const int t = e / HQ, c4 = 4 * (e % HQ);
      const long long o =
          (((long long)b * T + t0 + min(t, n - 1)) * H + h) * HD + c4;
      cp_async16(sQ + at<HD>(t, c4), q + o, t < n);
      cp_async16(sK + at<HD>(t, c4), k + o, t < n);
    }
    for (int e = tid; e < HQ; e += kThreads)
      cp_async16(sN + 4 * e, nck + ck * HD + 4 * e, true);
    if (!has_n) {
      for (int e = tid; e < L * (kVT / 4); e += kThreads) {
        const int t = e / (kVT / 4), c4 = 4 * (e % (kVT / 4));
        const long long o = (((long long)b * T + t0 + min(t, n - 1)) * H +
                             h) * HD + J * kVT + c4;
        cp_async16(sVx + at<kVT>(t, c4), v + o, t < n);
        cp_async16(sDY + at<kVT>(t, c4), dy + o, t < n);
      }
      // C's tile J: rows 4 m .. 4 m + 3 of column cc are 16 bytes.
      const float* src = Cck + ((ck * (HD / kVT) + J) * ROWS) * (4 * kVT);
      for (int e = tid; e < ROWS * kVT; e += kThreads) {
        const int m = e / kVT, cc = e % kVT;
        cp_async16(sST + at<HD>(cc, 4 * m), src + (long long)m * 4 * kVT +
                   4 * cc, true);
      }
    } else {
      for (int e = tid; e < HQ; e += kThreads)
        cp_async16(sST + at<HD>(0, 4 * e), nck + ck * HD + 4 * e, true);
    }
    for (int e = tid; e < L; e += kThreads) {
      const long long g = ((long long)b * T + t0 + e) * H + h;
      sLi[e] = e < n ? log_i[g] : 0.0f;
      sLf[e] = e < n ? log_f[g] : 0.0f;
    }
    if (tid == 0) sM0[0] = mck[ck];
    cp_async_wait_all();
    __syncthreads();
    // The stabiliser's chain over the chunk (the forward's arithmetic);
    // G = q k^T meanwhile.
    if (tid == kThreads - 1) {
      float m = sM0[0];
      for (int t = 0; t < n; ++t) {
        m = fmaxf(__fadd_rn(sLf[t], m), sLi[t]);
        sMt[t] = m;
      }
    }
    {
      RowTile Gt(tid);
      Gt.template mma<HD>([&](int m, int kk) { return sQ[at<HD>(m, kk)]; },
                          [&](int kk, int n_) { return sK[at<HD>(n_, kk)]; });
      Gt.each([&](int r, int col, float& x) { sG[at<L>(r, col)] = x; });
    }
    __syncthreads();
    if (tid < L) {
      float f = 1.0f, i = 0.0f;        // a padded step: unit decay, no input
      if (tid < n) {
        const float mn = sMt[tid];
        const float lfm =
            __fadd_rn(sLf[tid], tid > 0 ? sMt[tid - 1] : sM0[0]);
        f = expf(__fsub_rn(lfm, mn));
        i = expf(__fsub_rn(sLi[tid], mn));
        if (J == 0) mt[((long long)b * T + t0 + tid) * H + h] = mn;
      }
      sDec[tid] = f;
      sI[tid] = i;
    }
    if (has_n) {                       // <dy_t, y_t>, TPR threads a row
      const int row = tid / TPR, sub = tid % TPR;
      float s = 0.0f;
      if (row < n) {
        const long long o = (((long long)b * T + t0 + row) * H + h) * HD;
        for (int kk = sub; kk < HD; kk += TPR)
          s = __fadd_rn(s, __fmul_rn(dy[o + kk], y[o + kk]));
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, off));
      if (sub == 0) sDyy[row] = s;
    }
    __syncthreads();
    segments<L>(sDec, sSeg, sW, sP, tid);
    for (int e = tid; e < L * kVT; e += kThreads) {
      const int o = at<kVT>(e / kVT, e % kVT);
      sU[o] = __fmul_rn(sI[e / kVT], sVx[o]);
    }
    __syncthreads();
    {  // q . n_t = sum_s (G * seg)[t, s] i_s + p_t q_t . n_start; den
      const int row = tid / TPR, sub = tid % TPR;
      float a = 0.0f, qn0 = 0.0f;
      for (int s = sub; s < L; s += TPR) {
        const int o = at<L>(row, s);
        a = __fadd_rn(a, __fmul_rn(__fmul_rn(sG[o], sSeg[o]), sI[s]));
      }
      for (int kk = sub; kk < HD; kk += TPR)
        qn0 = __fadd_rn(qn0, __fmul_rn(sQ[at<HD>(row, kk)], sN[kk]));
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(kAll, a, off));
        qn0 = __fadd_rn(qn0, __shfl_xor_sync(kAll, qn0, off));
      }
      if (sub == 0) {
        const float qn = __fadd_rn(a, __fmul_rn(sP[row], qn0));
        const float den = fmaxf(fabsf(qn), 1.0f);
        sDen[row] = den;
        if (has_n)
          sDY[at<kVT>(row, 0)] =
              row < n ? __fmul_rn(__fdiv_rn(-sDyy[row], den),
                                  __fmul_rn(max_share(fabsf(qn), 1.0f),
                                            sign0(qn)))
                      : 0.0f;
      }
    }
    __syncthreads();
    if (!has_n)
      for (int e = tid; e < L * kVT; e += kThreads) {
        const int o = at<kVT>(e / kVT, e % kVT);
        sDY[o] = __fdiv_rn(sDY[o], sDen[e / kVT]);
      }
    __syncthreads();
    {  // D = dY U^T (this tile's columns)
      RowTile Dt(tid);
      Dt.template mma<kVT>([&](int m, int kk) { return sDY[at<kVT>(m, kk)]; },
                           [&](int kk, int n_) { return sU[at<kVT>(n_, kk)]; });
      Dt.each([&](int r, int col, float& x) { sD[at<L>(r, col)] = x; });
    }
    __syncthreads();
    {  // dU = (G * seg)^T dY + diag(w) K A: dv, v_s, d i's part
      WarpTile<L, kVT, kNW> U1(tid), U2(tid);
      U1.template mma<L>(
          [&](int m, int kk) {
            const int o = at<L>(kk, m);
            return __fmul_rn(sG[o], sSeg[o]);
          },
          [&](int kk, int n_) { return sDY[at<kVT>(kk, n_)]; });
      U2.template mma<HD>([&](int m, int kk) { return sK[at<HD>(m, kk)]; },
                          [&](int kk, int n_) { return sAT[at<HD>(n_, kk)]; });
      U2.row_sums(sVp, [&](int r, int col, float x) {
        return __fmul_rn(sU[at<kVT>(r, col)], x);
      });
      if (U1.active)                   // dU = U1 + diag(w) U2, in place
#pragma unroll
        for (int a = 0; a < U1.MT; ++a)
#pragma unroll
          for (int j = 0; j < U1.NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              U1.acc[a][j][e] = __fadd_rn(
                  U1.acc[a][j][e],
                  __fmul_rn(sW[U1.r0 + a * 16 + U1.g + (e >> 1) * 8],
                            U2.acc[a][j][e]));
      U1.row_sums(sIp, [&](int r, int col, float x) {
        return __fmul_rn(x, sVx[at<kVT>(r, col)]);
      });
      if (!has_n)
        U1.pairs([&](int a, int j, int e, int r, int col) {
          if (r < n) {
            const float ir = sI[r];
            *reinterpret_cast<float2*>(
                dv + (((long long)b * T + t0 + r) * H + h) * HD + J * kVT +
                col) = make_float2(__fmul_rn(ir, U1.acc[a][j][e]),
                                   __fmul_rn(ir, U1.acc[a][j][e + 1]));
          }
        });
    }
    {  // dk's part = (D * seg)^T Q + diag(w) U A^T
      WarpTile<L, HD, kNW> dB(tid);
      dB.template mma<L>(
          [&](int m, int kk) {
            const int o = at<L>(kk, m);
            return __fmul_rn(sD[o], sSeg[o]);
          },
          [&](int kk, int n_) { return sQ[at<HD>(kk, n_)]; });
      dB.template mma<kVT>(
          [&](int m, int kk) { return __fmul_rn(sW[m], sU[at<kVT>(m, kk)]); },
          [&](int kk, int n_) { return sAT[at<HD>(kk, n_)]; });
      dB.pairs([&](int a, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              dkp + ((long long)J * BTH +
                     ((long long)b * T + t0 + r) * H + h) * HD + col) =
              make_float2(dB.acc[a][j][e], dB.acc[a][j][e + 1]);
      });
    }
    {  // dq's part = (D * seg) K + diag(p) dY S^T; q_t = <Q_t, (dY S^T)_t>
      WarpTile<L, HD, kNW> C1(tid), C2(tid);
      C1.template mma<L>(
          [&](int m, int kk) {
            const int o = at<L>(m, kk);
            return __fmul_rn(sD[o], sSeg[o]);
          },
          [&](int kk, int n_) { return sK[at<HD>(kk, n_)]; });
      C2.template mma<kVT>([&](int m, int kk) { return sDY[at<kVT>(m, kk)]; },
                           [&](int kk, int n_) { return sST[at<HD>(kk, n_)]; });
      C2.row_sums(sQp, [&](int r, int col, float x) {
        return __fmul_rn(sQ[at<HD>(r, col)], x);
      });
      C1.pairs([&](int a, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              dqp + ((long long)J * BTH +
                     ((long long)b * T + t0 + r) * H + h) * HD + col) =
              make_float2(
                  __fadd_rn(C1.acc[a][j][e], __fmul_rn(sP[r], C2.acc[a][j][e])),
                  __fadd_rn(C1.acc[a][j][e + 1],
                            __fmul_rn(sP[r], C2.acc[a][j][e + 1])));
      });
    }
    {  // <A, S>: both tiles share one layout, so element by element
      float a = 0.0f;
      for (int e = tid; e < kVT * HD; e += kThreads)
        a = __fadd_rn(a, __fmul_rn(sAT[e], sST[e]));
      a = warp_sum(a);
      if (lane == 0) sAS[warp] = a;
    }
    {  // A_prev = p_{L-1} A + Q^T diag(p) dY
      WarpTile<HD, kVT, kNW> An(tid);
      const float pL = sP[L - 1];
      An.each([&](int r, int col, float& x) {
        x = __fmul_rn(pL, sAT[at<HD>(col, r)]);
      });
      An.template mma<L>(
          [&](int m, int kk) { return sQ[at<HD>(kk, m)]; },
          [&](int kk, int n_) {
            return __fmul_rn(sP[kk], sDY[at<kVT>(kk, n_)]);
          });
      __syncthreads();               // every read of this chunk's A is done
      An.each([&](int r, int col, float& x) { sAT[at<HD>(col, r)] = x; });
    }
    if (tid < L) {
      float vs = sVp[tid], qs = sQp[tid], di = sIp[tid];
      for (int x = 1; x < P::PV; ++x) {
        vs = __fadd_rn(vs, sVp[x * L + tid]);
        di = __fadd_rn(di, sIp[x * L + tid]);
      }
      for (int x = 1; x < P::PQ; ++x) qs = __fadd_rn(qs, sQp[x * L + tid]);
      sV[tid] = vs;
      if (tid == L - 1) {
        float as = 0.0f;
        for (int x = 0; x < kNW; ++x) as = __fadd_rn(as, sAS[x]);
        qs = __fadd_rn(qs, as);
      }
      sQv[tid] = qs;
      if (tid < n)
        dfi[((long long)NT + J) * BTH + ((long long)b * T + t0 + tid) * H +
            h] = di;
    }
    __syncthreads();
    {  // F = E Sg^T + q pm^T; d f_r = sum_t seg[t, r] F[t, r]
      RowTile Fm(tid);
      Fm.template mma<L>(
          [&](int m, int kk) {
            const int o = at<L>(m, kk);
            const float e = __fmul_rn(sG[o], sD[o]);
            return m == L - 1 ? __fadd_rn(e, sV[kk]) : e;
          },
          [&](int kk, int n_) {
            return n_ > 0 ? sSeg[at<L>(n_ - 1, kk)] : 0.0f;
          });
      Fm.col_sums(sDp, [&](int r, int col, float x) {
        const float pm = col > 0 ? sP[col - 1] : 1.0f;
        return __fmul_rn(sSeg[at<L>(r, col)],
                         __fadd_rn(x, __fmul_rn(sQv[r], pm)));
      });
    }
    __syncthreads();
    if (tid < n) {
      float d = sDp[tid];
      for (int x = 1; x < P::PD; ++x) d = __fadd_rn(d, sDp[x * L + tid]);
      dfi[(long long)J * BTH + ((long long)b * T + t0 + tid) * H + h] = d;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < kVT * HD; e += kThreads) {
    const int c = e / HD, kk = e % HD;
    const float a = sAT[at<HD>(c, kk)];
    if (!has_n) dC0[(sbase + kk) * HD + J * kVT + c] = a;
    else if (c == 0) dn0[sbase + kk] = a;
  }
}

template <int L, int HD>
int launch_mlstm_chunked_bwd(const float* q, const float* k, const float* v,
                             const float* li, const float* lf, const float* y,
                             const float* dy, const float* dC, const float* dn,
                             const float* Cck, const float* nck,
                             const float* mck, float* mt, float* dqp,
                             float* dkp, float* dv, float* dfi, float* dC0,
                             float* dn0, int B, int T, int H,
                             cudaStream_t stream) {
  static unsigned set_on = 0;
  constexpr int bytes = (int)sizeof(float) * MlstmTiles<L, HD>::FLOATS;
  cudaError_t err =
      raise_smem_cap(mlstm_chunked_bwd_kernel<L, HD>, bytes, set_on);
  if (err != cudaSuccess) return (int)err;
  mlstm_chunked_bwd_kernel<L, HD>
      <<<B * H * MlstmTiles<L, HD>::NT, kThreads, bytes, stream>>>(
          q, k, v, li, lf, y, dy, dC, dn, Cck, nck, mck, mt, dqp, dkp, dv,
          dfi, dC0, dn0, T, H);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- the stabiliser's chain
constexpr int kGatesThreads = 128;
constexpr int kGatesWindow = 1024;   // steps staged at a time

__global__ void __launch_bounds__(kGatesThreads) mlstm_gates_chunked_bwd_kernel(
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ m0, const float* __restrict__ dm,
    const float* __restrict__ mt, const float* __restrict__ dfi,
    float* __restrict__ dli, float* __restrict__ dlf,
    float* __restrict__ dm0, int T, int H, int tiles) {
  __shared__ float sA[kGatesWindow], sC[kGatesWindow];
  __shared__ float sWl[kGatesWindow], sWi[kGatesWindow];
  __shared__ float sOf[kGatesWindow], sOi[kGatesWindow];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, tid = threadIdx.x;
  const long long BTH = (long long)gridDim.x * T;
  float Gm = dm[bh];
  for (int w1 = T; w1 > 0; w1 -= kGatesWindow) {
    const int w0 = max(0, w1 - kGatesWindow), n = w1 - w0;
    __syncthreads();                 // the last window's outputs are stored
    for (int e = tid; e < n; e += kGatesThreads) {
      const int t = w0 + e;
      const long long o = ((long long)b * T + t) * H + h;
      const float li = log_i[o], mn = mt[o];
      const float lfm = __fadd_rn(log_f[o], t > 0 ? mt[o - H] : m0[bh]);
      const float f = expf(__fsub_rn(lfm, mn));
      const float i = expf(__fsub_rn(li, mn));
      float df = 0.0f, di = 0.0f;
      for (int s = 0; s < tiles; ++s) {
        df = __fadd_rn(df, dfi[s * BTH + o]);
        di = __fadd_rn(di, dfi[(tiles + s) * BTH + o]);
      }
      sA[e] = __fmul_rn(df, f);
      sC[e] = __fmul_rn(di, i);
      sWl[e] = max_share(lfm, li);
      sWi[e] = max_share(li, lfm);
    }
    __syncthreads();
    if (tid == 0) {
      for (int e = n - 1; e >= 0; --e) {
        const float a = sA[e], cc = sC[e];
        const float dmn = __fsub_rn(__fsub_rn(Gm, a), cc);
        Gm = __fadd_rn(a, __fmul_rn(dmn, sWl[e]));
        sOf[e] = Gm;
        sOi[e] = __fadd_rn(cc, __fmul_rn(dmn, sWi[e]));
      }
    }
    __syncthreads();
    for (int e = tid; e < n; e += kGatesThreads) {
      const long long o = ((long long)b * T + w0 + e) * H + h;
      dlf[o] = sOf[e];
      dli[o] = sOi[e];
    }
  }
  if (tid == 0) dm0[bh] = Gm;
}

}  // namespace

extern "C" {

// S2b, chunked: S2's operands (C0, n0, m0 are read through the
// checkpoints), y, dy (B, T, H, hd), dC (B, H, hd, hd), dn (B, H, hd), the
// checkpoints of mlstm_scan_ckpt (csrc/ssm_scan.cu) -> m_t (B, T, H), the
// per-tile dq and dk partials (tiles, B, T, H, hd), dv (B, T, H, hd), the
// per-tile d f and d i partials (2, tiles, B, T, H), dC0, dn0; tiles = hd /
// 32 + 1.  L, the caller's chunk length, must be kL, and hd in {32, 64,
// 192}; cudaErrorInvalidValue otherwise.
int mlstm_chunked_bwd(const float* q, const float* k, const float* v,
                      const float* li, const float* lf, const float* y,
                      const float* dy, const float* dC, const float* dn,
                      const float* Cck, const float* nck, const float* mck,
                      float* mt, float* dqp, float* dkp, float* dv,
                      float* dfi, float* dC0, float* dn0, int B, int T,
                      int H, int hd, int L, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0) return 0;
  if (L != kL) return (int)cudaErrorInvalidValue;
#define S2BC(HD_)                                                           \
  if (hd == HD_)                                                            \
    return launch_mlstm_chunked_bwd<kL, HD_>(q, k, v, li, lf, y, dy, dC, dn, \
                                             Cck, nck, mck, mt, dqp, dkp,   \
                                             dv, dfi, dC0, dn0, B, T, H,    \
                                             stream);
  S2BC(192)
  S2BC(64)
  S2BC(32)
#undef S2BC
  return (int)cudaErrorInvalidValue;
}

// The stabiliser's backward after mlstm_chunked_bwd: log_i, log_f (B, T,
// H), m0, dm (B, H), its m_t and d f, d i partials (2, tiles, B, T, H) ->
// d log_i, d log_f (B, T, H), dm0 (B, H).
int mlstm_gates_bwd(const float* li, const float* lf, const float* m0,
                    const float* dm, const float* mt, const float* dfi,
                    float* dli, float* dlf, float* dm0, int B, int T, int H,
                    int tiles, cudaStream_t stream) {
  if (B <= 0 || H <= 0) return 0;
  if (T < 0 || tiles <= 0) return (int)cudaErrorInvalidValue;
  mlstm_gates_chunked_bwd_kernel<<<B * H, kGatesThreads, 0, stream>>>(
      li, lf, m0, dm, mt, dfi, dli, dlf, dm0, T, H, tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
