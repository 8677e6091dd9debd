// S1 and S1b in the chunked SSD form, for Hopper (sm_90a): the Mamba2
// recurrence and its backward with the products of a chunk on the TF32
// tensor cores.  Plain C interface for ctypes.
//
// No Pallas kernel is replaced: these replace, for long sequences, the
// `lax.scan` of the JAX package's src/repro/models/ssm.py:103 (the Mamba2
// recurrence) and its reverse-mode autodiff, which csrc/ssm_scan.cu and
// csrc/ssm_scan_bwd.cu run one time step at a time.  The twin's convention
// (kernels/ref.py: mamba2_recurrence_plain): s_t = s_{t-1} decay_t + B_t
// (x) u_t, y_t = C_t . s_t, with B and C shared by the heads.
// kernels/ref.py: mamba2_chunked_plain and mamba2_chunked_bwd_plain are
// this file's arithmetic in plain PyTorch.
//
// Within a chunk of L = kL = 32 steps with start state S, seg[t, s] =
// decay_{s+1} ... decay_t (s <= t), p_t = decay_0 ... decay_t, w_s =
// seg[L - 1, s]:
//   G = C B^T,  Y = (G * seg) U + diag(p) C S,  S_next = p_{L-1} S + B^T
//   diag(w) U.
// Only S passes from chunk to chunk: T / L dependent steps, not T.  seg, p
// and w are running products in linear space (a decay may be exactly 0: no
// log-space sums, no division).  A tail chunk is padded with zero B, C, U
// and unit decays.
//
// Precision.  Every product is three TF32 mma.sync m16n8k8 over operands
// split as x = hi + lo (hi = rna_tf32(x), lo = rna_tf32(x - hi), rounded
// by integer arithmetic, `tf32_rna`): lo.hi +
// hi.lo + hi.hi into one f32 accumulator, about 2^-21 relative a term (one
// pass misses the 1e-4 held against the sequential twins by ~5x; see
// tests/test_torch_ssd_chunked.py).  The operands are split as the
// fragments are loaded from shared memory, so each tile is stored once, in
// f32.  mma.sync rather than wgmma: tf32 wgmma reads both shared operands
// K-major only, and the backward takes most tiles in both orientations
// (G and D as A and as A^T, C and B as A and B operands); mma.sync's
// fragments are gathered by the threads from any layout.  Every tile is
// row-major with its 4-column groups XOR-swizzled by the row (`at`), so a
// fragment gathered along rows or along columns hits 32 banks.
//
// * S1 `mamba2_chunked_kernel<L, DS, HD, SAVE>`: one block of 4 warps a (b, h)
//   walks the chunks in order with S in shared memory.  A chunk: its B, C,
//   U and decays staged; threads 0..L-1 build seg's columns (and w), thread
//   L builds p; G on the tensor cores, times seg into M; Y = M U + (p C) S as
//   one accumulation; S_next = p_{L-1} S + B^T (w U) in registers, stored
//   after a barrier.  SAVE writes every chunk's start state (B, H, nC, ds,
//   hd) for S1b instead of y and s_T.
// * S1b `mamba2_chunked_bwd_kernel<L, DS, HD>`: one block of 8 warps a (b, h)
//   walks the chunks last first, A the adjoint of the chunk's end state
//   (dsT first), S the chunk's start state from the saving variant; with
//   G = C B^T and D = dY U^T:
//     dU = (G * seg)^T dY + diag(w) B A;
//     dB = (D * seg)^T C + diag(w) U A^T;  dC = (D * seg) B + diag(p) dY S^T;
//     d decay_r = <A_r, s_{r-1}> = sum_t seg[t, r] F[t, r], F = E Sg^T +
//       q pm^T, E = G * D with v_s = <u_s, (B A)_s> added to its last row,
//       q_t = <C_t, (dY S^T)_t> with <A, S> added to its last entry,
//       Sg[r, s] = seg[r - 1, s] (the product that skips decay_r),
//       pm_r = p_{r-1};
//     A_prev = p_{L-1} A + C^T diag(p) dY.
//   Ten products of a chunk's size.  dB and dC are per-head partials the
//   wrapper sums over H in order; the row and column sums of v, q and
//   d decay are lane shuffles, then the warps' partials in warp order: no
//   atomics, the same bits run to run.
//
// Bound.  At zamba2-7b's (B, T, H, ds, hd) = (4, 1024, 112, 64, 64) S1
// reads and writes 253.5 MB (0.0757 ms at 3.35 TB/s); its chunk products,
// C B^T counted once a (b, chunk), are 9.41 GFLOP, 28.2 with the split
// (0.0570 ms at 495 TFLOP/s TF32): bytes bound it.  S1b moves 382 MB
// (0.114 ms) and does 27.3 GFLOP of products with its saving forward's,
// 81.8 with the split (0.165 ms): operations bound it.  What bounds these
// designs: each block computes C B^T for its head alone, and every
// fragment element is gathered from shared memory and split at each use,
// about ten instructions for three mma.sync, so the products are
// issue-bound.
//
// The chunk length.  L = 32 rather than 64: the products whose size goes
// with L^2 a chunk (C B^T, the masked read-out, S1b's dY U^T, its
// (G * seg)^T dY and the d decay product) shrink with L per step, while
// those of the state's size (ds x hd x L) stay; shared memory per block
// halves (S1 44 KB, S1b 78 KB at ds = hd = 64), so more blocks share an
// SM; T / L dependent steps double.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "chunked.cuh"

namespace {

constexpr int kL = 32;             // steps a chunk; entries refuse other L
constexpr int kFwdThreads = 128;   // S1: 4 warps
constexpr int kBwdThreads = 256;   // S1b: 8 warps

// A chunk's operands into shared memory by 16-byte asynchronous copies,
// padded past its n real steps (zero B, C, U, V; unit decay); V (dy for
// S1b) may be null.  The caller waits (cp_async_wait_all) and syncs.
template <int L, int DS, int HD, int NTHR>
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ decay, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ U,
    const float* __restrict__ V, float* sC, float* sB, float* sU, float* sV,
    float* sDec, int b, int h, int T, int H, int t0, int n, int tid) {
  constexpr int CQ = DS / 4, UQ = HD / 4;    // 16-byte groups a row
  for (int e = tid; e < L * CQ; e += NTHR) {
    const int t = e / CQ, q = 4 * (e % CQ);
    const long long row = (long long)b * T + t0 + min(t, n - 1);
    cp_async16(sC + at<DS>(t, q), Cm + row * DS + q, t < n);
    cp_async16(sB + at<DS>(t, q), Bm + row * DS + q, t < n);
  }
  for (int e = tid; e < L * UQ; e += NTHR) {
    const int t = e / UQ, q = 4 * (e % UQ);
    const long long o =
        (((long long)b * T + t0 + min(t, n - 1)) * H + h) * HD + q;
    cp_async16(sU + at<HD>(t, q), U + o, t < n);
    if (V != nullptr) cp_async16(sV + at<HD>(t, q), V + o, t < n);
  }
  for (int e = tid; e < L; e += NTHR)
    sDec[e] = e < n ? decay[((long long)b * T + t0 + e) * H + h] : 1.0f;
}

// A (DS, HD) state from device memory (row-major) into a swizzled tile.
template <int DS, int HD, int NTHR>
__device__ __forceinline__ void stage_state(const float* __restrict__ src,
                                            float* dst, int tid) {
  constexpr int Q = HD / 4;
  for (int e = tid; e < DS * Q; e += NTHR) {
    const int i = e / Q, q = 4 * (e % Q);
    cp_async16(dst + at<HD>(i, q), src + i * HD + q, true);
  }
}

// ------------------------------------------------------------------ S1
template <int L, int DS, int HD>
constexpr int fwd_smem_floats() {
  return 2 * L * DS + L * HD + DS * HD + L * L + 3 * L;
}

template <int L, int DS, int HD, bool SAVE>
__global__ void __launch_bounds__(kFwdThreads) mamba2_chunked_kernel(
    const float* __restrict__ decay, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dtx,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ sT, float* __restrict__ starts, int T, int H) {
  constexpr int NW = kFwdThreads / 32;
  extern __shared__ float smem[];
  float* sC = smem;                  // [L][DS]
  float* sB = sC + L * DS;          // [L][DS]
  float* sU = sB + L * DS;          // [L][HD]
  float* sS = sU + L * HD;          // [DS][HD]
  float* sM = sS + DS * HD;          // [L][L]: seg, then G * seg
  float* sDec = sM + L * L;        // [L]
  float* sP = sDec + L;             // [L]
  float* sW = sP + L;               // [L]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int nC = (T + L - 1) / L;
  const long long st = (long long)bh * DS * HD;
  stage_state<DS, HD, kFwdThreads>(s0 + st, sS, tid);
  for (int c = 0; c < nC; ++c) {
    const int t0 = c * L, n = min(L, T - t0);
    __syncthreads();                 // the last chunk is done with smem
    stage_chunk<L, DS, HD, kFwdThreads>(decay, Bm, Cm, dtx, nullptr, sC, sB, sU,
                                     nullptr, sDec, b, h, T, H, t0, n, tid);
    cp_async_wait_all();
    __syncthreads();                 // every thread's copies have landed
    if (SAVE) {
      float* out = starts + ((long long)bh * nC + c) * DS * HD;
      for (int e = tid; e < DS * HD; e += kFwdThreads)
        out[e] = sS[at<HD>(e / HD, e % HD)];
    }
    segments<L>(sDec, sM, sW, sP, tid);
    __syncthreads();
    if (!SAVE) {
      WarpTile<L, L, NW> G(tid);
      G.template mma<DS>([&](int m, int k) { return sC[at<DS>(m, k)]; },
                         [&](int k, int n_) { return sB[at<DS>(n_, k)]; });
      G.each([&](int r, int col, float& v) {
        const int o = at<L>(r, col);
        sM[o] = __fmul_rn(v, sM[o]);
      });
      __syncthreads();
      WarpTile<L, HD, NW> Y(tid);
      Y.template mma<L>([&](int m, int k) { return sM[at<L>(m, k)]; },
                         [&](int k, int n_) { return sU[at<HD>(k, n_)]; });
      Y.template mma<DS>(
          [&](int m, int k) { return __fmul_rn(sP[m], sC[at<DS>(m, k)]); },
          [&](int k, int n_) { return sS[at<HD>(k, n_)]; });
      Y.pairs([&](int i, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              y + (((long long)b * T + t0 + r) * H + h) * HD + col) =
              make_float2(Y.acc[i][j][e], Y.acc[i][j][e + 1]);
      });
    }
    WarpTile<DS, HD, NW> S(tid);
    const float pL = sP[L - 1];
    S.each([&](int r, int col, float& v) {
      v = __fmul_rn(pL, sS[at<HD>(r, col)]);
    });
    S.template mma<L>(
        [&](int m, int k) { return sB[at<DS>(k, m)]; },
        [&](int k, int n_) { return __fmul_rn(sW[k], sU[at<HD>(k, n_)]); });
    __syncthreads();                 // every read of this chunk's S is done
    S.each([&](int r, int col, float& v) { sS[at<HD>(r, col)] = v; });
  }
  if (SAVE) return;
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < DS * HD; e += kFwdThreads)
    sT[st + e] = sS[at<HD>(e / HD, e % HD)];
}

template <int L, int DS, int HD, bool SAVE>
int launch_chunked(const float* decay, const float* Bm, const float* Cm,
                   const float* dtx, const float* s0, float* y, float* sT,
                   float* starts, int B, int T, int H, cudaStream_t stream) {
  static unsigned set_on = 0;
  constexpr int bytes = (int)sizeof(float) * fwd_smem_floats<L, DS, HD>();
  cudaError_t err = raise_smem_cap(mamba2_chunked_kernel<L, DS, HD, SAVE>,
                                   bytes, set_on);
  if (err != cudaSuccess) return (int)err;
  mamba2_chunked_kernel<L, DS, HD, SAVE><<<B * H, kFwdThreads, bytes, stream>>>(
      decay, Bm, Cm, dtx, s0, y, sT, starts, T, H);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- S1b
// S1b's warp groups that leave partial sums: v's and q's column groups,
// d decay's row groups.
template <int L, int DS, int HD>
struct BwdParts {
  static constexpr int NW = kBwdThreads / 32;
  static constexpr int V = WarpTile<L, HD, NW>::WN;
  static constexpr int Q = WarpTile<L, DS, NW>::WN;
  static constexpr int D = WarpTile<L, L, NW>::WM;
};

template <int L, int DS, int HD>
constexpr int bwd_smem_floats() {
  // C, B; U, dY; S, A; seg, G, D; decay, p, w, v, q; the v, q and d decay
  // partials, <A, S>'s warps.
  using P = BwdParts<L, DS, HD>;
  return 2 * L * DS + 2 * L * HD + 2 * DS * HD + 3 * L * L + 5 * L +
         (P::V + P::Q + P::D) * L + P::NW;
}

template <int L, int DS, int HD>
__global__ void __launch_bounds__(kBwdThreads) mamba2_chunked_bwd_kernel(
    const float* __restrict__ decay, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dtx,
    const float* __restrict__ dy, const float* __restrict__ dsT,
    const float* __restrict__ starts, float* __restrict__ ddecay,
    float* __restrict__ dBh, float* __restrict__ dCh,
    float* __restrict__ ddtx, float* __restrict__ ds0, int T, int H) {
  constexpr int NW = kBwdThreads / 32;
  using RowTile = WarpTile<L, L, NW>;
  using P = BwdParts<L, DS, HD>;
  extern __shared__ float smem[];
  float* sC = smem;                  // [L][DS]
  float* sB = sC + L * DS;          // [L][DS]
  float* sU = sB + L * DS;          // [L][HD]
  float* sDY = sU + L * HD;         // [L][HD]
  float* sS = sDY + L * HD;         // [DS][HD]: the chunk's start state
  float* sA = sS + DS * HD;          // [DS][HD]: the end state's adjoint
  float* sSeg = sA + DS * HD;        // [L][L]
  float* sG = sSeg + L * L;        // [L][L]
  float* sD = sG + L * L;          // [L][L]
  float* sDec = sD + L * L;        // [L]
  float* sP = sDec + L;             // [L]
  float* sW = sP + L;               // [L]
  float* sV = sW + L;               // [L]
  float* sQ = sV + L;               // [L]
  float* sVp = sQ + L;              // [P::V][L]
  float* sQp = sVp + P::V * L;      // [P::Q][L]
  float* sDp = sQp + P::Q * L;      // [P::D][L]
  float* sAS = sDp + P::D * L;      // [NW]
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nC = (T + L - 1) / L;
  const long long st = (long long)bh * DS * HD;
  stage_state<DS, HD, kBwdThreads>(dsT + st, sA, tid);
  for (int c = nC - 1; c >= 0; --c) {
    const int t0 = c * L, n = min(L, T - t0);
    __syncthreads();                 // the last chunk is done with smem
    stage_chunk<L, DS, HD, kBwdThreads>(decay, Bm, Cm, dtx, dy, sC, sB, sU, sDY,
                                     sDec, b, h, T, H, t0, n, tid);
    stage_state<DS, HD, kBwdThreads>(
        starts + ((long long)bh * nC + c) * DS * HD, sS, tid);
    cp_async_wait_all();
    __syncthreads();
    segments<L>(sDec, sSeg, sW, sP, tid);
    {  // G = C B^T and D = dY U^T (no barrier inside: each warp its share)
      RowTile G(tid), D(tid);
      G.template mma<DS>([&](int m, int k) { return sC[at<DS>(m, k)]; },
                         [&](int k, int n_) { return sB[at<DS>(n_, k)]; });
      D.template mma<HD>([&](int m, int k) { return sDY[at<HD>(m, k)]; },
                         [&](int k, int n_) { return sU[at<HD>(n_, k)]; });
      G.each([&](int r, int col, float& v) { sG[at<L>(r, col)] = v; });
      D.each([&](int r, int col, float& v) { sD[at<L>(r, col)] = v; });
    }
    __syncthreads();
    {  // dU = (G * seg)^T dY + diag(w) B A; v_s = <u_s, (B A)_s>
      WarpTile<L, HD, NW> U1(tid), U2(tid);
      U1.template mma<L>(
          [&](int m, int k) {
            const int o = at<L>(k, m);
            return __fmul_rn(sG[o], sSeg[o]);
          },
          [&](int k, int n_) { return sDY[at<HD>(k, n_)]; });
      U2.template mma<DS>([&](int m, int k) { return sB[at<DS>(m, k)]; },
                          [&](int k, int n_) { return sA[at<HD>(k, n_)]; });
      U2.row_sums(sVp, [&](int r, int col, float v) {
        return __fmul_rn(sU[at<HD>(r, col)], v);
      });
      U1.pairs([&](int i, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              ddtx + (((long long)b * T + t0 + r) * H + h) * HD + col) =
              make_float2(
                  __fadd_rn(U1.acc[i][j][e], __fmul_rn(sW[r], U2.acc[i][j][e])),
                  __fadd_rn(U1.acc[i][j][e + 1],
                            __fmul_rn(sW[r], U2.acc[i][j][e + 1])));
      });
    }
    {  // dB = (D * seg)^T C + diag(w) U A^T (this head's part)
      WarpTile<L, DS, NW> dB(tid);
      dB.template mma<L>(
          [&](int m, int k) {
            const int o = at<L>(k, m);
            return __fmul_rn(sD[o], sSeg[o]);
          },
          [&](int k, int n_) { return sC[at<DS>(k, n_)]; });
      dB.template mma<HD>(
          [&](int m, int k) { return __fmul_rn(sW[m], sU[at<HD>(m, k)]); },
          [&](int k, int n_) { return sA[at<HD>(n_, k)]; });
      dB.pairs([&](int i, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              dBh + (((long long)b * T + t0 + r) * H + h) * DS + col) =
              make_float2(dB.acc[i][j][e], dB.acc[i][j][e + 1]);
      });
    }
    {  // dC = (D * seg) B + diag(p) dY S^T; q_t = <C_t, (dY S^T)_t>
      WarpTile<L, DS, NW> C1(tid), C2(tid);
      C1.template mma<L>(
          [&](int m, int k) {
            const int o = at<L>(m, k);
            return __fmul_rn(sD[o], sSeg[o]);
          },
          [&](int k, int n_) { return sB[at<DS>(k, n_)]; });
      C2.template mma<HD>([&](int m, int k) { return sDY[at<HD>(m, k)]; },
                          [&](int k, int n_) { return sS[at<HD>(n_, k)]; });
      C2.row_sums(sQp, [&](int r, int col, float v) {
        return __fmul_rn(sC[at<DS>(r, col)], v);
      });
      C1.pairs([&](int i, int j, int e, int r, int col) {
        if (r < n)
          *reinterpret_cast<float2*>(
              dCh + (((long long)b * T + t0 + r) * H + h) * DS + col) =
              make_float2(
                  __fadd_rn(C1.acc[i][j][e], __fmul_rn(sP[r], C2.acc[i][j][e])),
                  __fadd_rn(C1.acc[i][j][e + 1],
                            __fmul_rn(sP[r], C2.acc[i][j][e + 1])));
      });
    }
    {  // <A, S>: both tiles share one layout, so element by element
      float a = 0.0f;
      for (int e = tid; e < DS * HD; e += kBwdThreads)
        a = __fadd_rn(a, __fmul_rn(sA[e], sS[e]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = __fadd_rn(a, __shfl_xor_sync(kAll, a, off));
      if (lane == 0) sAS[warp] = a;
    }
    {  // A_prev = p_{L-1} A + C^T diag(p) dY
      WarpTile<DS, HD, NW> An(tid);
      const float pL = sP[L - 1];
      An.each([&](int r, int col, float& v) {
        v = __fmul_rn(pL, sA[at<HD>(r, col)]);
      });
      An.template mma<L>(
          [&](int m, int k) { return sC[at<DS>(k, m)]; },
          [&](int k, int n_) { return __fmul_rn(sP[k], sDY[at<HD>(k, n_)]); });
      __syncthreads();               // every read of this chunk's A is done
      An.each([&](int r, int col, float& v) { sA[at<HD>(r, col)] = v; });
    }
    if (tid < L) {
      float v = sVp[tid], q = sQp[tid];
      for (int x = 1; x < P::V; ++x) v = __fadd_rn(v, sVp[x * L + tid]);
      for (int x = 1; x < P::Q; ++x) q = __fadd_rn(q, sQp[x * L + tid]);
      sV[tid] = v;
      if (tid == L - 1) {
        float as = 0.0f;
        for (int x = 0; x < NW; ++x) as = __fadd_rn(as, sAS[x]);
        q = __fadd_rn(q, as);
      }
      sQ[tid] = q;
    }
    __syncthreads();
    {  // F = E Sg^T + q pm^T; d decay_r = sum_t seg[t, r] F[t, r]
      RowTile Fm(tid);
      Fm.template mma<L>(
          [&](int m, int k) {
            const int o = at<L>(m, k);
            const float e = __fmul_rn(sG[o], sD[o]);
            return m == L - 1 ? __fadd_rn(e, sV[k]) : e;
          },
          [&](int k, int n_) {
            return n_ > 0 ? sSeg[at<L>(n_ - 1, k)] : 0.0f;
          });
      Fm.col_sums(sDp, [&](int r, int col, float v) {
        const float pm = col > 0 ? sP[col - 1] : 1.0f;
        return __fmul_rn(sSeg[at<L>(r, col)],
                         __fadd_rn(v, __fmul_rn(sQ[r], pm)));
      });
    }
    __syncthreads();
    if (tid < n) {
      float d = sDp[tid];
      for (int x = 1; x < P::D; ++x) d = __fadd_rn(d, sDp[x * L + tid]);
      ddecay[((long long)b * T + t0 + tid) * H + h] = d;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < DS * HD; e += kBwdThreads)
    ds0[st + e] = sA[at<HD>(e / HD, e % HD)];
}

template <int L, int DS, int HD>
int launch_chunked_bwd(const float* decay, const float* Bm, const float* Cm,
                       const float* dtx, const float* dy, const float* dsT,
                       const float* starts, float* ddecay, float* dBh,
                       float* dCh, float* ddtx, float* ds0, int B, int T,
                       int H, cudaStream_t stream) {
  static unsigned set_on = 0;
  constexpr int bytes = (int)sizeof(float) * bwd_smem_floats<L, DS, HD>();
  cudaError_t err = raise_smem_cap(mamba2_chunked_bwd_kernel<L, DS, HD>, bytes,
                                   set_on);
  if (err != cudaSuccess) return (int)err;
  mamba2_chunked_bwd_kernel<L, DS, HD><<<B * H, kBwdThreads, bytes, stream>>>(
      decay, Bm, Cm, dtx, dy, dsT, starts, ddecay, dBh, dCh, ddtx, ds0, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S1, chunked: decay (B, T, H), Bm and Cm (B, T, ds), dtx (B, T, H, hd), s0
// (B, H, ds, hd), all f32 and contiguous.  With starts null: y (B, T, H,
// hd) and sT (B, H, ds, hd); else only every chunk's start state into
// starts (B, H, ceil(T / L), ds, hd), the saving variant.  L, the caller's
// chunk length (the size of starts), must be kL, and ds and hd in {32, 64};
// cudaErrorInvalidValue otherwise.
int mamba2_chunked(const float* decay, const float* Bm, const float* Cm,
                   const float* dtx, const float* s0, float* y, float* sT,
                   float* starts, int B, int T, int H, int ds, int hd, int L,
                   cudaStream_t stream) {
  if (L != kL) return (int)cudaErrorInvalidValue;
#define S1C(DS, HD)                                                          \
  if (ds == DS && hd == HD)                                                  \
    return starts != nullptr                                                 \
               ? launch_chunked<kL, DS, HD, true>(decay, Bm, Cm, dtx, s0, y, \
                                                  sT, starts, B, T, H,       \
                                                  stream)                    \
               : launch_chunked<kL, DS, HD, false>(decay, Bm, Cm, dtx, s0,  \
                                                   y, sT, starts, B, T, H,   \
                                                   stream);
  S1C(64, 64)
  S1C(64, 32)
  S1C(32, 64)
  S1C(32, 32)
#undef S1C
  return (int)cudaErrorInvalidValue;
}

// S1b, chunked: S1's operands, dy (B, T, H, hd), dsT (B, H, ds, hd), starts
// from the saving variant -> d decay (B, T, H), the per-head dB and dC
// partials (B, T, H, ds), d dtx (B, T, H, hd), d s0 (B, H, ds, hd); L as
// for S1.
int mamba2_chunked_bwd(const float* decay, const float* Bm, const float* Cm,
                       const float* dtx, const float* dy, const float* dsT,
                       const float* starts, float* ddecay, float* dBh,
                       float* dCh, float* ddtx, float* ds0, int B, int T,
                       int H, int ds, int hd, int L, cudaStream_t stream) {
  if (L != kL) return (int)cudaErrorInvalidValue;
#define S1BC(DS, HD)                                                         \
  if (ds == DS && hd == HD)                                                  \
    return launch_chunked_bwd<kL, DS, HD>(decay, Bm, Cm, dtx, dy, dsT,       \
                                          starts, ddecay, dBh, dCh, ddtx,    \
                                          ds0, B, T, H, stream);
  S1BC(64, 64)
  S1BC(64, 32)
  S1BC(32, 64)
  S1BC(32, 32)
#undef S1BC
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
