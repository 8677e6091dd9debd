// K3: top-k move nomination for the assignment engine, for Hopper (sm_90a),
// with a plain C interface for ctypes.
//
// Replaces src/repro/kernels/topk_moves.py `_topk_kernel` (:41, called at
// :140).  For each cell it scores every single-user move n: s -> m by the
// airtime it adds at the equal-split reference bandwidth b_ref = B / n_act,
//
//   score(n, m) = a(n, m) (1 + (c_m + 1)/n_act) - a(n, s) (1 + c_s/n_act),
//   a(n, m)     = H_n / log2(1 + g(n, m) p_max_n / (N0 b_ref)),
//
// with 1e30 for the own edge and for masked users, then keeps the k
// smallest scores in k rounds of argmin-and-knock-out (ties to the lowest
// flat index n*M + m; a knocked-out entry becomes 1e30, so rounds past the
// legal moves pick the lowest-index 1e30 entry, possibly again).
//
// Bound: a cell reads N*M + 4N floats and writes 3k words, and does a
// log1pf and a few divisions per entry: at the engine's shape (128 cells of
// 56 x 5, k = 8) that is ~0.07 us of bytes on the whole card, far below one
// kernel launch, and ~0.09 us at the large-cell path's (2, 2048, 16).  What
// bounds K3 is the launch and one cell's dependent chain of latencies
// (loads, counts, scores, k selection rounds), so the designs attack the
// chain, not bytes or operations.
//
// Three kernels compute it, bit for bit (built with --fmad=false, as the
// plain twin `ref.topk_moves_plain` computes):
//
// * `topk_moves_warp_kernel<S>` (N*M <= 32 * 16): one warp per cell, one
//   cell a block, no block barrier anywhere.  Lane l owns
//   the flat entries e = l + 32j, j < S, as registers with implicit
//   indices; slots past N*M hold +inf, so they never win a round, not even
//   the all-1e30 rounds.  With one warp on an SM sub-partition every
//   latency is exposed, so the design is about the length of the chain:
//   - all loads (the tile coalesced, the users' operands) are issued before
//     any use; edge counts are integer shared atomics and n_act a ballot
//     (exact in any order);
//   - a(n, s) comes out of the score pass itself (the lane holding (n, s)
//     writes the user's source term), so there is one log1pf an entry and
//     no per-user pass;
//   - every slot's work is straight-line code (unconditional loads, then
//     selects), and the divisions and log1pf are the branch-free versions
//     of fast_math.cuh, so the S slots' chains interleave; a slot whose
//     operands leave their ranges takes the toolkit's functions after;
//   - a round is two redux.sync minima over the lanes' cached (key,
//     entry) minima (scores as order-preserving unsigned keys), a
//     branch-free knock-out by the owner lane and a log2(S)-deep tree
//     rescan; lane r % 32 keeps round r's result and the warp stores 32
//     results at a time, coalesced.
// * `topk_moves_cluster_kernel` (larger cells, up to 227 KB of shared
//   memory a block: 196,608 entries at k >= 512, ~1.8 million at k = 16):
//   one cell a thread block cluster of up to 8 blocks of 8 warps.  Each
//   warp scores slices of 512 entries into registers (16 a lane, the warp
//   kernel's arithmetic, each entry's own source term computed in place)
//   and keeps each slice's legal moves in order by the warp kernel's
//   rounds; one warp merges the lists (their heads through distributed
//   shared memory) and writes the padding rounds by their rule, so k
//   rounds cost no barrier; a cell takes up to 8 SMs where the block
//   kernel took one.  See the kernel's note.
// * `topk_moves_kernel` (the first port's design): one block of 128
//   threads per
//   cell, the tile in shared memory (N*M + M floats and 36 static bytes in
//   227 KB), per-edge loads by shared atomics and k block-wide argmins with
//   two barriers each.  No route takes it; it is the yardstick.
#include <cuda_runtime.h>
#include <math.h>

#include "cluster.cuh"
#include "fast_math.cuh"

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


// ---------------------------------------------------------------------------
// What the warp and cluster kernels share.

__device__ __forceinline__ bool fast_num(float a) {
  return (__float_as_uint(a) == 0u) | ((a >= kFastA0) & (a <= kFastA1));
}

// The noise term of a cell and its 2^t scaling into div_rn_fast's range.
struct Noise {
  float noise, scale, scaled;
  bool fast;
};

__device__ __forceinline__ Noise cell_noise(float Bq, float N0q,
                                            float n_act) {
  Noise c;
  const float b_ref = fast_num(Bq) ? div_rn_fast(Bq, n_act) : Bq / n_act;
  c.noise = fmaxf(N0q * b_ref, 1e-30f);
  c.scale = 1.0f;
  if (c.noise < kFastB0)
    c.scale = __int_as_float(
        (254 - ((__float_as_int(c.noise) >> 23) & 0xff)) << 23);
  c.scaled = c.noise * c.scale;
  c.fast = (c.scaled >= kFastB0) & (c.scaled <= kFastB1);
  return c;
}

// The airtime H / max(log1pf(g pm / noise) / ln 2, 1e-9) on the
// branch-free division and log1pf (fast_math.cuh), g pm / noise taken as
// (g pm 2^t) / (noise 2^t), the same quotient; `fast` is false where the
// operands leave those functions' ranges (the caller then takes
// `airtime_slow`, the toolkit's functions: the same bits).
__device__ __forceinline__ float airtime_fast(float g, float H, float pm,
                                              const Noise& c, bool& fast) {
  const float a1 = g * pm * c.scale;
  const float x = div_rn_fast(a1, c.scaled);
  const float L = log1pf_pos(x);
  const float se = div_rn_fast(L, kLn2);
  fast = c.fast & fast_num(a1) & fast_num(L) & fast_num(H) &
         (__float_as_uint(x) < 0x7f800000u);
  return div_rn_fast(H, fmaxf(se, 1e-9f));
}

__device__ __forceinline__ float airtime_slow(float g, float H, float pm,
                                              float noise) {
  return H / fmaxf(log1pf(g * pm / noise) / kLn2, 1e-9f);
}

// ---------------------------------------------------------------------------
// The warp kernel: one cell a warp.

// A user's operands in the warp kernel's shared array.  `s` is
// the current edge of an active user, M for an active user whose edge lies
// outside [0, M) (every edge is then a move and the source term is 0, as
// in the block kernel) and -1 for a masked user (no move).  `src` is the
// source term a(n, s) (1 + c_s/n_act).
struct __align__(16) WarpUser {
  float H, pm, src;
  int s;
};

// Shared words a block: N users of 4 words, then the M edge weights
// 1 + (c_m + 1)/n_act and the M source weights 1 + c_m/n_act, padded to
// 16 bytes, then a word a lane that takes the stores a lane makes only
// sometimes (so that every store is unconditional).
__host__ __device__ inline int warp_smem_words(int N, int M) {
  return 4 * N + ((2 * M + 3) & ~3) + 32;
}

// An unsigned key with the float's order: key(a) < key(b) iff a < b, for
// floats that are not NaN and not -0 (a score is neither: a(n, m) w_m > 0
// for H > 0, and 1e30 and +inf are constants); `key_value` restores the
// bits.  One unsigned compare then orders scores.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The lane's smallest (key, entry) over its S slots, ties to the lower
// entry; slot j of lane l holds entry l + 32j.  A tree of compare-selects,
// ceil(log2 S) deep, unrolled: no register is indexed at run time.  The
// left operand of every pair holds the lower entries, so a tie keeps it.
template <int S>
__device__ __forceinline__ void lane_min(const unsigned (&key)[S], int lane,
                                         unsigned& lk, unsigned& le) {
  unsigned k2[S], e2[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    k2[j] = key[j];
    e2[j] = lane + 32 * j;
  }
#pragma unroll
  for (int w = 1; w < S; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < S; j += 2 * w) {
      if (k2[j + w] < k2[j]) {
        k2[j] = k2[j + w];
        e2[j] = e2[j + w];
      }
    }
  }
  lk = k2[0];
  le = e2[0];
}

// One warp a block.  The explicit minimum of one block an SM lets ptxas
// give every instance the registers it needs: without it nvcc 12.9 held an
// instance of S = 6 to 64 registers, and it spilled.
template <int S>
__global__ void __launch_bounds__(32, 1)
topk_moves_warp_kernel(const float* __restrict__ gain,
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
  extern __shared__ float4 warp_smem[];
  const int lane = threadIdx.x;
  const int q = blockIdx.x;
  float* wsm = reinterpret_cast<float*>(warp_smem);
  WarpUser* users = reinterpret_cast<WarpUser*>(wsm);
  float* wgt = wsm + 4 * N;
  float* wsrc = wgt + M;
  float* sink = wsm + warp_smem_words(N, M) - 32 + lane;

  const int NM = N * M;
  const size_t urow = (size_t)q * N;
  const float* g_cell = gain + urow * M;

  // Every load is issued before the first use of any: the tile (coalesced,
  // lane l reads entries l + 32j; 0 past N*M), the cell's scalars and each
  // lane's users l + 32c (c < S, since N <= N*M <= 32S; a lane past N
  // reads user N - 1 again).  Each slot's work below is straight-line code
  // (loads, then selects): a branch around it would make the compiler run
  // the slots one after another.
  int* cnt = reinterpret_cast<int*>(wsrc);
  for (int m = lane; m < M; m += 32) cnt[m] = 0;
  __syncwarp();
  float v[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < NM ? __ldg(g_cell + e) : 0.0f;
  }
  const float Bq = __ldg(B + q);
  const float N0q = __ldg(N0 + q);
  int as_[S];
  bool mk_[S];
  float H_[S], pm_[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (32 * c < N) {                 // uniform over the warp
      const size_t n = urow + min(lane + 32 * c, N - 1);
      as_[c] = __ldg(assign + n);
      mk_[c] = mask[n];
      H_[c] = __ldg(H + n);
      pm_[c] = __ldg(p_max + n);
    }
  }
  // Edge counts by integer shared atomics (exact, in any order) and the
  // active count by ballots: the block kernel adds 1.0f per user, the same
  // floats.
  int n_active = 0;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    if (32 * c < N) {
      const int n = lane + 32 * c;
      const bool in = n < N;
      const int a = as_[c];
      const int s = (in && mk_[c]) ? ((a >= 0 && a < M) ? a : M) : -1;
      if (in) users[n] = WarpUser{H_[c], pm_[c], 0.0f, s};
      if (s >= 0 && s < M) atomicAdd(&cnt[s], 1);
      n_active += __popc(__ballot_sync(kFull, s >= 0));
    }
  }
  __syncwarp();

  // Each edge's two weights, lanes over edges (in place of its count).
  // Counts and n_act are integers in [0, 512] and [1, 512], inside
  // div_rn_fast's range (fast_math.cuh); B is checked.
  const float n_act = fmaxf((float)n_active, 1.0f);
  const Noise nz = cell_noise(Bq, N0q, n_act);
  for (int m = lane; m < M; m += 32) {
    const float c = (float)cnt[m];
    wgt[m] = 1.0f + div_rn_fast(c + 1.0f, n_act);
    wsrc[m] = 1.0f + div_rn_fast(c, n_act);
  }
  __syncwarp();

  // (n, m) of entry l + 32j advance by 32 = dn M + dm entries a slot: one
  // division a warp, none an entry.
  const int n0 = lane / M, m0 = lane - n0 * M;
  const int dn = 32 / M, dm = 32 - dn * M;
  auto next = [&](int& n, int& m) {
    m += dm;
    n += dn;
    if (m >= M) {
      m -= M;
      ++n;
    }
  };

  // The airtime a(n, m) of every entry on the branch-free path
  // (`airtime_fast`), so that the slots' chains interleave; a slot whose
  // operands leave its ranges takes the toolkit's functions after: the
  // same bits either way.
  int s_[S];
  unsigned slow = 0u;
  {
    int n = n0, m = m0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = lane + 32 * j < NM;
      const WarpUser u = users[in ? n : 0];
      bool fast;
      v[j] = airtime_fast(v[j], u.H, u.pm, nz, fast);
      s_[j] = u.s;
      slow |= (unsigned)(in & !fast) << j;
      next(n, m);
    }
  }
  if (slow) {
    int n = n0, m = m0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if (slow & (1u << j)) {
        const WarpUser u = users[n];
        v[j] = airtime_slow(__ldg(g_cell + lane + 32 * j), u.H, u.pm,
                            nz.noise);
      }
      next(n, m);
    }
  }
  // The lane that holds a user's own edge (n, s) writes its source term.
  {
    int n = n0, m = m0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool own = (lane + 32 * j < NM) & (m == s_[j]);
      *(own ? &users[n].src : sink) = v[j] * wsrc[m];
      next(n, m);
    }
  }
  __syncwarp();

  // Scores as order keys: 1e30 for a masked user's entries and the own
  // edge, +inf past N*M, so a padding slot never wins, not even a round of
  // 1e30 entries.
  unsigned key[S];
  {
    int n = n0, m = m0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const bool in = lane + 32 * j < NM;
      const float sc = v[j] * wgt[m] - users[in ? n : 0].src;
      const bool move = (s_[j] >= 0) & (m != s_[j]);
      key[j] = order_key(in ? (move ? sc : kBig) : INFINITY);
      next(n, m);
    }
  }

  // k rounds: the warp's smallest (key, entry) by two redux.sync minima
  // (the key, then the entry among the lanes holding it); the owner lane
  // knocks the winner out to 1e30 and every lane takes its minimum anew
  // (only the owner's changes), without a branch.  Lane r % 32 keeps round
  // r's result; the warp stores 32 results at a time, coalesced.
  const unsigned big_key = order_key(kBig);
  unsigned lk, le, rk = 0, re = 0;
  lane_min<S>(key, lane, lk, le);
  for (int r = 0; r < k; ++r) {
    const unsigned wk = __reduce_min_sync(kFull, lk);
    const unsigned we = __reduce_min_sync(kFull, lk == wk ? le : ~0u);
    if (lane == (r & 31)) {
      rk = wk;
      re = we;
    }
    const unsigned hit = lane == (int)(we & 31u) ? (we >> 5) : 0xffu;
#pragma unroll
    for (int j = 0; j < S; ++j) key[j] = (unsigned)j == hit ? big_key : key[j];
    lane_min<S>(key, lane, lk, le);
    if ((r & 31) == 31 || r == k - 1) {   // 32 results, or the last few
      if (lane <= (r & 31)) {
        const size_t o = (size_t)q * k + (r & ~31) + lane;
        const int u = (int)re / M;
        user_out[o] = u;
        dst_out[o] = (int)re - u * M;
        score_out[o] = key_value(rk);
      }
    }
  }
}

// A block's shared memory: at most 4 N + 2 M + 35 words, ~8 KB for
// N*M <= 512, inside the default 48 KB.
inline size_t warp_smem_bytes(int N, int M) {
  return (size_t)warp_smem_words(N, M) * sizeof(float);
}

template <int S>
int launch_warp(const float* gain, const float* H, const float* p_max,
                const int* assign, const bool* mask, const float* N0,
                const float* B, int* user_out, int* dst_out,
                float* score_out, int P, int N, int M, int k,
                cudaStream_t stream) {
  topk_moves_warp_kernel<S><<<P, 32, warp_smem_bytes(N, M), stream>>>(
      gain, H, p_max, assign, mask, N0, B, user_out, dst_out, score_out, N,
      M, k);
  return (int)cudaGetLastError();
}

template <int S>
int warp_occupancy(int N, int M, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, topk_moves_warp_kernel<S>, 32, warp_smem_bytes(N, M));
}

// ---------------------------------------------------------------------------
// The cluster kernel: one cell a thread block cluster.

constexpr int kSliceSlots = 16;                    // entries a lane
constexpr int kSliceEntries = 32 * kSliceSlots;    // 512 entries a slice
constexpr int kClusterWarps = 8;                   // warps a block
constexpr int kClusterBlocks = 8;                  // the portable size
constexpr int kHeadCache = 4;       // entries of each list the merger holds
constexpr int kClusterStatic = 16;  // static shared bytes a block
constexpr unsigned kGone = 0xffffffffu;  // above every score's key

// A cell of N*M entries: NS slices of 512, C blocks of 8 warps, slice s on
// warp s % (8C) of the cluster in pass s / (8C); each slice's list holds
// at most L = min(k, 512) moves.
struct TopkCluster {
  int NS, C, passes, L;
};

__host__ __device__ inline TopkCluster topk_cluster(int N, int M, int k) {
  TopkCluster t;
  t.NS = (int)(((long long)N * M + kSliceEntries - 1) / kSliceEntries);
  t.C = (t.NS + kClusterWarps - 1) / kClusterWarps;
  if (t.C > kClusterBlocks) t.C = kClusterBlocks;
  const int G = t.C * kClusterWarps;
  t.passes = (t.NS + G - 1) / G;
  t.L = k < kSliceEntries ? k : kSliceEntries;
  return t;
}

// A block's shared bytes: first 8-byte words, the lists of its warps'
// slices (passes x 8 lists of L (key, entry) pairs), then, used in the
// cluster's first block only, the first kHeadCache entries of every list
// and the merge's current head of each; then 4-byte words, the M edge
// counts, the block's list lengths, and every list's length and position
// for the merge; then the static words.
__host__ __device__ inline size_t topk_cluster_smem(const TopkCluster& t,
                                                    int M) {
  return (size_t)8 * ((size_t)t.passes * kClusterWarps * t.L +
                      (size_t)t.NS * (kHeadCache + 1)) +
         (size_t)4 * ((size_t)M + t.passes * kClusterWarps + 2 * t.NS) +
         kClusterStatic;
}

// A slot's operands: its user's source edge s (M for an active user whose
// edge lies outside [0, M), -1 for a masked user) and the entries' gains.
struct Slot {
  float g, gs, H, pm;
  int s;
};

__device__ __forceinline__ Slot load_slot(const float* g_cell,
                                          const float* H, const float* p_max,
                                          const int* assign, const bool* mask,
                                          size_t urow, int e, int n, int M,
                                          bool in) {
  Slot o;
  const int nc = in ? n : 0;
  const size_t u = urow + nc;
  const int a = __ldg(assign + u);
  o.s = mask[u] ? ((a >= 0 && a < M) ? a : M) : -1;
  o.g = in ? __ldg(g_cell + e) : 0.0f;
  o.gs = __ldg(g_cell + (size_t)nc * M + (o.s >= 0 && o.s < M ? o.s : 0));
  o.H = __ldg(H + u);
  o.pm = __ldg(p_max + u);
  return o;
}

// A move's score from its two airtimes, the edge weights of the warp
// kernel (1 + (c_m + 1)/n_act at m, 1 + c_s/n_act at s) computed from the
// counts.
__device__ __forceinline__ float slot_score(float at, float as, int m, int s,
                                            int M, const int* cnt,
                                            float n_act) {
  const bool own = s >= 0 && s < M;
  const float wgt = 1.0f + div_rn_fast((float)cnt[m] + 1.0f, n_act);
  const float wsrc = 1.0f + div_rn_fast((float)cnt[own ? s : 0], n_act);
  return at * wgt - (own ? as * wsrc : 0.0f);
}

// Cell q on one cluster of C blocks of 8 warps (the launch's cluster size
// is topk_cluster's C):
// 1. every block counts the cell's active users and edge loads itself
//    (shared integer atomics: exact in any order);
// 2. each warp scores its slices, 16 entries a lane in registers (the warp
//    kernel's arithmetic: the same bits), and keeps each slice's legal
//    moves (score < 1e30) in (score, entry) order, at most L of them, by
//    the warp kernel's rounds (two redux.sync minima, an owner knock-out);
//    it also takes the slice's smallest (key, entry) and its lowest entry
//    of score <= 1e30, into the block's two words;
// 3. each list's first kHeadCache moves and its length go to the first
//    block (stores into its shared memory), and a cluster barrier;
// 4. one warp of the first block merges the lists, a head a list, by the
//    same rounds, reading past a list's first kHeadCache moves from the
//    block that holds it; then writes the padding rounds;
// 5. a last cluster barrier, so that no block leaves while the merge reads.
// The sequential argmin-and-knock-out takes the legal moves in (score,
// entry) order; once they run out, every later round takes the lowest
// entry of score <= 1e30 (the knocked-out picks included) with score
// 1e30, again and again; where no score is <= 1e30 the first round takes
// the smallest (score, entry) and the later ones that entry with 1e30.
__global__ void __launch_bounds__(32 * kClusterWarps, 1)
topk_moves_cluster_kernel(const float* __restrict__ gain,
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
  extern __shared__ uint2 csm[];
  __shared__ unsigned long long s_min;   // the block's smallest (key, entry)
  __shared__ unsigned s_i0;    // the block's lowest entry of score <= 1e30
  __shared__ int s_active;
  const TopkCluster t = topk_cluster(N, M, k);
  const unsigned rank = cluster_rank();
  const int q = blockIdx.x / t.C;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int NM = N * M;
  uint2* lists = csm;
  uint2* heads = lists + t.passes * kClusterWarps * t.L;
  uint2* cur = heads + t.NS * kHeadCache;
  int* cnt = reinterpret_cast<int*>(cur + t.NS);
  int* lens = cnt + M;
  int* hlen = lens + t.passes * kClusterWarps;
  int* hpos = hlen + t.NS;

  for (int m = tid; m < M; m += blockDim.x) cnt[m] = 0;
  if (tid == 0) {
    s_min = ~0ull;
    s_i0 = kGone;
    s_active = 0;
  }
  __syncthreads();
  cluster_arrive_relaxed();   // waited for before the first remote access

  // 1. Counts, eight users a thread a trip, every load issued before the
  // first use (a load behind the mask's branch would wait for the mask).
  const size_t urow = (size_t)q * N;
  int act = 0;
  for (int n0 = tid; n0 < N; n0 += 8 * blockDim.x) {
    bool mk[8];
    int a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + i * blockDim.x;
      const size_t u = urow + (n < N ? n : 0);
      mk[i] = (n < N) & mask[u];
      a[i] = __ldg(assign + u);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      act += mk[i];
      if (mk[i] && a[i] >= 0 && a[i] < M) atomicAdd(&cnt[a[i]], 1);
    }
  }
  act = __reduce_add_sync(kFull, act);
  if (lane == 0) atomicAdd(&s_active, act);
  __syncthreads();
  const float n_act = fmaxf((float)s_active, 1.0f);
  const Noise nz = cell_noise(__ldg(B + q), __ldg(N0 + q), n_act);

  // 2. Slices.
  const float* g_cell = gain + urow * M;
  const unsigned big_key = order_key(kBig);
  const int G = t.C * kClusterWarps;
  const int dn = 32 / M, dm = 32 - dn * M;
  auto next = [&](int& n, int& m) {
    m += dm;
    n += dn;
    if (m >= M) {
      m -= M;
      ++n;
    }
  };
  for (int p = 0; p < t.passes; ++p) {
    const int sl = p * G + (int)rank * kClusterWarps + w;
    if (sl >= t.NS) break;                 // uniform over the warp
    const int e0 = sl * kSliceEntries;
    const int n0 = (e0 + lane) / M, m0 = e0 + lane - n0 * M;
    unsigned key[kSliceSlots];
    unsigned slow = 0u;
    {
      int n = n0, m = m0;
#pragma unroll
      for (int j = 0; j < kSliceSlots; ++j) {
        const int e = e0 + lane + 32 * j;
        const bool in = e < NM;
        const Slot o = load_slot(g_cell, H, p_max, assign, mask, urow, e, n,
                                 M, in);
        bool f1, f2;
        const float at = airtime_fast(o.g, o.H, o.pm, nz, f1);
        const float as = airtime_fast(o.gs, o.H, o.pm, nz, f2);
        const bool own = o.s >= 0 && o.s < M;
        const bool move = (o.s >= 0) & (m != o.s);
        const float sc = slot_score(at, as, m, o.s, M, cnt, n_act);
        key[j] = in ? (move ? order_key(sc) : big_key) : kGone;
        slow |= (unsigned)(in & move & !(f1 & (f2 | !own))) << j;
        next(n, m);
      }
    }
    if (slow) {
      int n = n0, m = m0;
#pragma unroll
      for (int j = 0; j < kSliceSlots; ++j) {
        if (slow & (1u << j)) {
          const Slot o = load_slot(g_cell, H, p_max, assign, mask, urow,
                                   e0 + lane + 32 * j, n, M, true);
          const float at = airtime_slow(o.g, o.H, o.pm, nz.noise);
          const float as = o.s >= 0 && o.s < M
                               ? airtime_slow(o.gs, o.H, o.pm, nz.noise)
                               : 0.0f;
          key[j] = order_key(slot_score(at, as, m, o.s, M, cnt, n_act));
        }
        next(n, m);
      }
    }
    unsigned i0 = kGone;
#pragma unroll
    for (int j = kSliceSlots - 1; j >= 0; --j)
      if (key[j] <= big_key) i0 = e0 + lane + 32 * j;
    i0 = __reduce_min_sync(kFull, i0);

    uint2* list = lists + (p * kClusterWarps + w) * t.L;
    unsigned lk, le;
    unsigned long long first = 0ull;
    int len = 0;
    lane_min<kSliceSlots>(key, lane, lk, le);
    for (int r = 0; r < t.L; ++r) {
      const unsigned wk = __reduce_min_sync(kFull, lk);
      const unsigned we = __reduce_min_sync(kFull, lk == wk ? le : ~0u);
      if (r == 0) first = (unsigned long long)wk << 32 | (unsigned)(e0 + we);
      if (wk >= big_key) break;
      if (lane == 0) list[r] = make_uint2(wk, e0 + we);
      const unsigned hit = lane == (int)(we & 31u) ? (we >> 5) : 0xffu;
#pragma unroll
      for (int j = 0; j < kSliceSlots; ++j)
        key[j] = (unsigned)j == hit ? kGone : key[j];
      lane_min<kSliceSlots>(key, lane, lk, le);
      len = r + 1;
    }
    if (lane == 0) {
      lens[p * kClusterWarps + w] = len;
      atomicMin(&s_min, first);
      atomicMin(&s_i0, i0);
    }
  }
  __syncwarp();

  // 3. Each list's head and length to the first block.
  cluster_wait();
  for (int p = 0; p < t.passes; ++p) {
    const int sl = p * G + (int)rank * kClusterWarps + w;
    if (sl >= t.NS) break;
    const int li = p * kClusterWarps + w;
    const int len = lens[li];
    if (lane < kHeadCache && lane < len)
      st_cluster(&heads[sl * kHeadCache + lane], 0u, lists[li * t.L + lane]);
    if (lane == 0) st_cluster(&hlen[sl], 0u, len);
  }
  cluster_sync();

  // 4. The merge.
  if (rank == 0 && w == 0) {
    const size_t o = (size_t)q * k;
    unsigned lk = kGone, le = kGone;
    int ls = 0;
    auto rescan = [&]() {
      lk = kGone;
      le = kGone;
      for (int sl = lane; sl < t.NS; sl += 32) {
        const uint2 v = cur[sl];
        if (v.x < lk || (v.x == lk && v.y < le)) {
          lk = v.x;
          le = v.y;
          ls = sl;
        }
      }
    };
    for (int sl = lane; sl < t.NS; sl += 32) {
      hpos[sl] = 0;
      cur[sl] = hlen[sl] > 0 ? heads[sl * kHeadCache]
                             : make_uint2(kGone, kGone);
    }
    rescan();
    int r = 0;
    for (; r < k; ++r) {
      const unsigned wk = __reduce_min_sync(kFull, lk);
      const unsigned we = __reduce_min_sync(kFull, lk == wk ? le : ~0u);
      if (wk >= big_key) break;           // every list is spent
      if (lane == 0) {
        const int u = (int)(we / (unsigned)M);
        user_out[o + r] = u;
        dst_out[o + r] = (int)we - u * M;
        score_out[o + r] = key_value(wk);
      }
      if (lk == wk && le == we) {         // the owner lane advances list ls
        const int pos = ++hpos[ls];
        uint2 v = make_uint2(kGone, kGone);
        if (pos < hlen[ls]) {
          if (pos < kHeadCache) {
            v = heads[ls * kHeadCache + pos];
          } else {
            const int gw = ls % G;
            const int li = (ls / G) * kClusterWarps + gw % kClusterWarps;
            v = ld_cluster(&lists[li * t.L + pos],
                           (unsigned)(gw / kClusterWarps));
          }
        }
        cur[ls] = v;
        rescan();
      }
    }
    if (r < k) {
      // The padding rounds: the lowest entry of score <= 1e30 with 1e30;
      // where there is none, the smallest (score, entry), then its entry
      // with 1e30.
      unsigned i0 = kGone;
      unsigned long long mn = ~0ull;
      if (lane < t.C) {
        i0 = ld_cluster(&s_i0, (unsigned)lane);
        mn = ld_cluster(&s_min, (unsigned)lane);
      }
      i0 = __reduce_min_sync(kFull, i0);
      const unsigned mk = __reduce_min_sync(kFull, (unsigned)(mn >> 32));
      const unsigned me = __reduce_min_sync(
          kFull, (unsigned)(mn >> 32) == mk ? (unsigned)mn : ~0u);
      const unsigned pe = i0 != kGone ? i0 : me;
      const int u = (int)(pe / (unsigned)M);
      for (int rr = r + lane; rr < k; rr += 32) {
        user_out[o + rr] = u;
        dst_out[o + rr] = (int)pe - u * M;
        score_out[o + rr] = (i0 == kGone && rr == 0) ? key_value(mk) : kBig;
      }
    }
  }
  cluster_sync();   // 5. no block leaves while the merge may read it
}

// The launch floor: the same library's launch of a kernel that does
// nothing, timed beside K3.
__global__ void topk_empty_kernel() {}

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

// The warp kernel at S slots a lane (9 or 16; N*M <= 32S; the same set as
// topk_moves.WARP_SLOTS).
#define K3_SLOTS(X) X(9) X(16)

int topk_moves_warp(const float* gain, const float* H, const float* p_max,
                    const int* assign, const bool* mask, const float* N0,
                    const float* B, int* user_out, int* dst_out,
                    float* score_out, int P, int N, int M, int k, int S,
                    cudaStream_t stream) {
  if (P <= 0 || k <= 0) return 0;
  if (N <= 0 || M <= 0 || (long long)N * M > 32LL * S)
    return (int)cudaErrorInvalidValue;
  switch (S) {
#define K3_CASE(s)                                                        \
    case s:                                                               \
      return launch_warp<s>(gain, H, p_max, assign, mask, N0, B, user_out, \
                            dst_out, score_out, P, N, M, k, stream);
    K3_SLOTS(K3_CASE)
#undef K3_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int topk_moves_warp_occupancy(int S, int N, int M, int* blocks) {
  if (N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  switch (S) {
#define K3_CASE(s) \
    case s:        \
      return warp_occupancy<s>(N, M, blocks);
    K3_SLOTS(K3_CASE)
#undef K3_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K3 on the cluster kernel: one cell a cluster of up to 8 blocks of 8
// warps, any N*M whose shared memory (topk_moves_cluster_smem) fits 227 KB.
int topk_moves_cluster(const float* gain, const float* H, const float* p_max,
                       const int* assign, const bool* mask, const float* N0,
                       const float* B, int* user_out, int* dst_out,
                       float* score_out, int P, int N, int M, int k,
                       cudaStream_t stream) {
  if (P <= 0 || k <= 0) return 0;
  if (N <= 0 || M <= 0 || (long long)N * M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const TopkCluster t = topk_cluster(N, M, k);
  const size_t total = topk_cluster_smem(t, M);
  if (total > 232448) return (int)cudaErrorInvalidValue;
  const size_t smem = total - kClusterStatic;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_moves_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * t.C));
  cfg.blockDim = dim3(32 * kClusterWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)t.C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, topk_moves_cluster_kernel, gain, H, p_max, assign, mask, N0, B,
      user_out, dst_out, score_out, N, M, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster kernel's shared bytes a block (dynamic and static) for cells
// of N x M and k moves: what topk_moves.cluster_smem_bytes computes.
long long topk_moves_cluster_smem(int N, int M, int k) {
  return (long long)topk_cluster_smem(topk_cluster(N, M, k), M);
}

int topk_empty(cudaStream_t stream) {
  topk_empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
