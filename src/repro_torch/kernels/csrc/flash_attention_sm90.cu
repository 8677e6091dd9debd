// K4, bf16 tensor-core route: flash attention forward for Hopper (sm_90a)
// with wgmma and TMA, for bf16 operands with head dims up to 256.  Plain C
// interface for ctypes.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel` (the same
// function as csrc/flash_attention_sm90_f32.cu, the f32 route, and
// csrc/flash_attention.cu, the route of layouts TMA does not address): for
// every (batch, head) and query row,
// softmax(q k^T / sqrt(hd)) v with causal masking shifted by `q_offset`, an
// optional sliding `window`, keys past Tk masked with the finite -1e30, f32
// running (max, sum) and accumulator, acc / max(sum, 1e-30) last, and key
// blocks [0, last) with the TPU kernel's causal `last`.
//
// Bound: at the LM prefill's (B, H, T, hd) = (4, 16, 1024, 64), causal
// attention needs 4 hd T(T+1)/2 flop per head (8.6 GFLOP, 0.0087 ms at the
// card's 989 TFLOP/s bf16 tensor rate) and moves 33.6 MB (0.0100 ms at
// 3.35 TB/s): both bounds are near 0.01 ms, so the products have to run on
// the tensor cores and the copies have to overlap them.
//
// Design.  One CTA of one warpgroup (128 threads) per (b*h, 64 query rows),
// launched with the last query blocks first (they hold the most key blocks
// under causal masking, so no long block finishes alone at the end).
//   * TMA: one 4-D tensor map per operand over the (B, T, H, hd) tensor,
//     dims {hd, H, T, B}, boxes of 64 rows x 64 columns (128 bytes, the
//     widest box the 128-byte swizzle takes; hd 128, 192 and 256 are two,
//     three and four boxes).  TMA fills rows past T and columns past hd
//     with zeros, so the Tq / Tk tails and an hd padded to 64, 128, 192 or
//     256 need no code.  Q is loaded once;
//     K and V go through a ring of kStages stages, each with its own
//     mbarrier, and the next tiles' copies run while this tile is computed.
//   * S = Q K^T: wgmma m64n64k16, Q and K from shared memory (K-major,
//     128-byte swizzle), f32 accumulator in registers.
//   * The online softmax runs in the accumulator's registers: each thread
//     holds two query rows, whose max and sum reduce over the 4 threads of
//     a quad.  Scores are scaled by scale * log2(e) in f32 and exponentiated
//     with ex2.approx; the mask is evaluated only on key blocks that hold a
//     masked entry (the causal diagonal, the window's edge, the Tk tail).
//   * O += P V: P, rounded to bf16, is wgmma's register A operand (the
//     accumulator's layout is the A fragment's); V is read from shared
//     memory as an MN-major B operand, a pair of 64-column boxes an n128
//     product and an odd last box an n64 one, each into its slice of O's
//     accumulator.  O is rescaled only by alpha.
//   * Registers: O takes HD / 2 floats a thread (128 at HD 256) beside
//     S's 32 and P's 16; one warpgroup holds them without a spill (ptxas:
//     194 registers at HD 256, 158 at 192), so O is not split between
//     warpgroups.  Shared memory: HD 256 takes 160 KB (Q 32, two stages of
//     K and V 2 x 64), one CTA an SM; the cap is checked before launch.
//   * The output is normalised, staged as bf16 in Q's buffer in the
//     128-byte swizzle, and written with a TMA store, which clips at Tq and
//     hd.
// Against the plain twin (ref.attention_plain), which scales q and keeps P
// in f32: the scale is applied to S in f32 and P is rounded to bf16 before
// P V, as the models' chunked route rounds it; both stay within bf16's
// 2e-2.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;       // query rows per CTA (wgmma's M)
constexpr int kBlockK = 64;       // keys per K/V tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 128;     // one warpgroup
constexpr int kBox = 64;          // columns per TMA box (128 bytes of bf16)
constexpr int kBoxBytes = 64 * 128;   // one 64-row box
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBlockQ == kBlockK, "one TMA box shape serves Q, K, V and O");

// D (64 x 64, f32) += A (64 x 16, shared, K-major) . B (16 x 64, shared,
// K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32; the accumulator's floats OFF .. OFF + 31) += A (64 x
// 16, bf16 registers) . B (16 x 64, shared, MN-major).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[N],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  static_assert(OFF + 32 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32; the accumulator's floats OFF .. OFF + 63) += A (64 x
// 16, bf16 registers) . B (16 x 128, shared, MN-major).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[N],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator slice out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
constexpr int smem_bytes() {
  // Q, kStages K and V tiles, 1 + 2 kStages mbarriers, and the slack that
  // aligns the base to 1024 bytes.
  return kBlockQ * HD * 2 + 2 * kStages * kBlockK * HD * 2 +
         8 * (1 + 2 * kStages) + 1024;
}
// A block's shared memory on the card (227 KB): HD 256 takes 164,904 bytes.
constexpr int kSmemCap = 232448;
static_assert(smem_bytes<256>() <= kSmemCap, "HD 256 exceeds 227 KB");

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_sm90_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, int H, int Tk, int n_qb,
    bool causal, int q_offset, bool has_window, int window,
    float scale_log2) {
  constexpr int kBoxes = HD / kBox;          // 64-column boxes per row
  constexpr int kTile = kBlockK * HD * 2;    // bytes of one Q, K or V tile
  constexpr int kAcc = HD / 2;               // O accumulator floats
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kTile;
  const uint32_t sV = sK + kStages * kTile;
  const uint32_t bar_q = sV + kStages * kTile;
  const uint32_t bar_k = bar_q + 8;                // + 8 s
  const uint32_t bar_v = bar_k + 8 * kStages;      // + 8 s

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int qi = n_qb - 1 - static_cast<int>(blockIdx.y);
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = qi * kBlockQ;

  const int n_kb = (Tk + kBlockK - 1) / kBlockK;
  int last = n_kb;
  if (causal) {
    const long long lim =
        ((long long)q_offset + (long long)(qi + 1) * kBlockQ + kBlockK - 1) /
        kBlockK;
    last = lim < n_kb ? (int)lim : n_kb;
  }

  const CUtensorMap* const mk = &tk;
  const CUtensorMap* const mv = &tv;
  auto load_kv = [=](int tile, int stage) {
    const uint32_t bk = bar_k + 8 * stage, bv = bar_v + 8 * stage;
    mbar_expect_tx(bk, kTile);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_load(sK + stage * kTile + j * kBoxBytes, mk, bk, j * kBox, h,
               tile * kBlockK, b);
    mbar_expect_tx(bv, kTile);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_load(sV + stage * kTile + j * kBoxBytes, mv, bv, j * kBox, h,
               tile * kBlockK, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_load(sQ + j * kBoxBytes, &tq, bar_q, j * kBox, h, q0, b);
    for (int s = 0; s < kStages && s < last; ++s) load_kv(s, s);
  }

  // This thread's accumulator rows: r0 = 16 warp + lane / 4 and r0 + 8;
  // its columns 8 j + 2 (lane % 4) + {0, 1}.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r0 = warp * 16 + g;
  const int qp0 = q_offset + q0 + r0;
  const int qp1 = qp0 + 8;

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(bar_q, 0);
  for (int kb = 0; kb < last; ++kb) {
    const int st = kb % kStages;
    const uint32_t parity = (kb / kStages) & 1;
    const int k0 = kb * kBlockK;

    // ---- S = Q K^T on the tensor cores -------------------------------
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    mbar_wait(bar_k + 8 * st, parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_m64n64k16(s, smem_desc(sQ + off, 16, 1024),
                         smem_desc(sK + st * kTile + off, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // ---- online softmax in the accumulator's registers ---------------
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    const bool need_mask =
        k0 + kBlockK > Tk || (causal && k0 + kBlockK - 1 > q_offset + q0) ||
        (has_window && k0 <= q_offset + q0 + kBlockQ - 1 - window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qp = (e & 2) ? qp1 : qp0;
          bool ok = key < Tk;
          if (causal) ok = ok && key <= qp;
          if (has_window) ok = ok && key > qp - window;
          if (!ok) s[4 * j + e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - m0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - m0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - m1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - m1);
      rs0 += s[4 * j] + s[4 * j + 1];
      rs1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + rs0;      // per-thread partial sums; the quad adds them
    l1 = l1 * a1 + rs1;      // at the end
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }
    // P in bf16 as wgmma's A fragments: k-step kk covers keys 16 kk ..
    // 16 kk + 15, the accumulator's column blocks 2 kk and 2 kk + 1.
    uint32_t p[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // ---- O += P V on the tensor cores --------------------------------
    mbar_wait(bar_v + 8 * st, parity);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // Pairs of 64-column boxes as one n128 product each, an odd last
      // box as an n64 one; each writes its slice of O's accumulator.
      const uint32_t v0 = sV + st * kTile + kk * 16 * 128;
      if constexpr (kBoxes >= 2)
        wgmma_rs_m64n128k16<0>(o, p[kk], smem_desc(v0, kBoxBytes, 1024));
      if constexpr (kBoxes >= 4)
        wgmma_rs_m64n128k16<64>(
            o, p[kk], smem_desc(v0 + 2 * kBoxBytes, kBoxBytes, 1024));
      if constexpr (kBoxes % 2 == 1)
        wgmma_rs_m64n64k16<(kBoxes / 2) * 64>(
            o, p[kk],
            smem_desc(v0 + (kBoxes - 1) * kBoxBytes, kBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);

    // Every warp is done with this stage: refill it with tile kb + kStages.
    __syncthreads();
    if (tid == 0 && kb + kStages < last) load_kv(kb + kStages, st);
  }

  // ---- epilogue: normalise, stage in Q's buffer, TMA store -----------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int col = 8 * j + 2 * t4;
    const int box = col / kBox;
    const int chunk = (col % kBox) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const float dn = half ? d1 : d0;
      const uint32_t off = box * kBoxBytes + r * 128 +
                           ((chunk ^ (r & 7)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(gbase + off) = pack_bf16(
          o[4 * j + 2 * half] / dn, o[4 * j + 2 * half + 1] / dn);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_store(&to, sQ + j * kBoxBytes, j * kBox, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------- host side
// Raise the kernel's shared-memory cap once per device and instance.
template <int HD>
cudaError_t prepare() {
  static unsigned set_on = 0;
  return raise_smem_cap(flash_attention_sm90_kernel<HD>, smem_bytes<HD>(),
                        set_on);
}

template <int HD>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& to, int B, int H,
           int Tq, int Tk, int causal, int q_offset, int has_window,
           int window, float scale_log2, cudaStream_t stream) {
  const cudaError_t err = prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  const int n_qb = (Tq + kBlockQ - 1) / kBlockQ;
  const dim3 grid(B * H, n_qb);
  flash_attention_sm90_kernel<HD><<<grid, kThreads, smem_bytes<HD>(),
                                    stream>>>(
      tq, tk, tv, to, H, Tk, n_qb, causal != 0, q_offset, has_window != 0,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int occupancy(int* smem, int* ctas_per_sm) {
  const cudaError_t err = prepare<HD>();
  if (err != cudaSuccess) return (int)err;
  *smem = smem_bytes<HD>();
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, flash_attention_sm90_kernel<HD>, kThreads, *smem);
}

}  // namespace

extern "C" {

// q, k, v and o are bf16 (B, T, H, hd) tensors with a unit head-dim
// stride; strides are in elements for the batch, time and head axes, each
// a multiple of 8 (16 bytes), and every base address is 16-byte aligned
// (the Python wrapper routes here only then).  `scale` is 1/sqrt(hd).
int flash_attention_sm90(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Tq, int Tk, int hd,
                         long long q_sb, long long q_st, long long q_sh,
                         long long k_sb, long long k_st, long long k_sh,
                         long long v_sb, long long v_st, long long v_sh,
                         long long o_sb, long long o_st, long long o_sh,
                         int causal, int q_offset, int has_window, int window,
                         float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || hd <= 0 || hd > 256 || (Tq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // kBlockQ == kBlockK: one box shape serves Q, K, V and O.
  if (!encode(fn, &tq, bf16, 2, kBox, kBlockQ, q, B, Tq, H, hd, q_sb, q_st,
              q_sh) ||
      !encode(fn, &tk, bf16, 2, kBox, kBlockQ, k, B, Tk, H, hd, k_sb, k_st,
              k_sh) ||
      !encode(fn, &tv, bf16, 2, kBox, kBlockQ, v, B, Tk, H, hd, v_sb, v_st,
              v_sh) ||
      !encode(fn, &to, bf16, 2, kBox, kBlockQ, o, B, Tq, H, hd, o_sb, o_st,
              o_sh))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
#define FA_LAUNCH(HD)                                                   \
  launch<HD>(tq, tk, tv, to, B, H, Tq, Tk, causal, q_offset, has_window, \
             window, scale_log2, stream)
  if (hd <= 64) return FA_LAUNCH(64);
  if (hd <= 128) return FA_LAUNCH(128);
  if (hd <= 192) return FA_LAUNCH(192);
  return FA_LAUNCH(256);
#undef FA_LAUNCH
}

// The dynamic shared memory a CTA of the hd template takes, and how many
// CTAs fit on one SM (for the build report).
int flash_attention_sm90_occupancy(int hd, int* smem, int* ctas_per_sm) {
  if (hd <= 64) return occupancy<64>(smem, ctas_per_sm);
  if (hd <= 128) return occupancy<128>(smem, ctas_per_sm);
  if (hd <= 192) return occupancy<192>(smem, ctas_per_sm);
  return occupancy<256>(smem, ctas_per_sm);
}

}  // extern "C"
