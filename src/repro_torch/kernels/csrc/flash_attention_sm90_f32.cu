// K4, f32 route: flash attention forward for Hopper (sm_90a) on the TF32
// tensor cores with a 3xTF32 split, for f32 operands with head dims up to
// 128.  Plain C interface for ctypes.
//
// Replaces src/repro/kernels/flash_attention.py `_flash_kernel` for f32
// (the function of csrc/flash_attention_sm90.cu, whose conventions it
// keeps): softmax(q k^T / sqrt(hd)) v per (batch, head) and query row,
// causal masking shifted by `q_offset`, an optional sliding `window`, keys
// past Tk masked with the finite -1e30, f32 running (max, sum) and
// accumulator, acc / max(sum, 1e-30) last, and key blocks [0, last) with the
// TPU kernel's causal `last`.
//
// Bound: at qwen1.5-0.5b's prefill in f32, (B, H, T, hd) = (4, 16, 1024,
// 64) causal, the kernel moves 67.1 MB (0.0200 ms at 3.35 TB/s) and does
// 8.60 GFLOP (0.0174 ms at the card's 495 TFLOP/s TF32 rate; 0.128 ms at the
// 67 TFLOP/s of the f32 CUDA cores), so bytes bound it once the products run
// on the tensor cores.
//
// Precision.  One TF32 product keeps 11 bits of each operand, far from the
// f32 tolerance of 2e-5 against the plain twin.  Each operand is split as
// x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi) (the subtraction is
// exact; the build's --fmad=false keeps it a plain one), and each product
// is hi.hi + hi.lo + lo.hi, three wgmma m64nNk8 tf32 into one f32
// accumulator: about 2^-21 relative a term (ref.attention_tf32x3_plain is
// the model; tests/test_torch_tf32x3.py holds it to the reference).  Both
// halves are rounded explicitly and kept in shared memory, so nothing rests
// on how the tensor cores read the low bits of an f32.
//
// Design.  One CTA of one warpgroup (128 threads) per (b*h, 64 query rows),
// the last query blocks first.
//   * TMA: one 4-D f32 map per operand, boxes of 64 rows x 32 columns (128
//     bytes, the 128-byte swizzle's width); the zero fill covers the Tq / Tk
//     tails and an hd padded to 64 or 128.  Q is loaded once; K and V
//     have one buffer each, each with its own mbarrier (two CTAs an SM at
//     HD 64; at HD 128 the seven tiles fill 227 KB).
//   * Q and K arrive as f32 and one pass of the warpgroup writes hi in
//     place and lo beside it (the swizzle permutes 16-byte chunks, so the
//     pass is element-wise).  Both are K-major for S = Q K^T, which tf32
//     wgmma needs (it transposes neither shared operand).
//   * V is MN-major for O = P V, so the same kind of pass transposes it
//     into a keys-contiguous V^T tile (hi and lo) in the 128-byte swizzle.
//     The pass also permutes the keys inside each group of 8: position t
//     holds key 2t for t < 4 and key 2(t - 4) + 1 above.  With that order
//     the tf32 A fragment of P (rows g, g + 8; k positions t4, t4 + 4) is
//     exactly the S accumulator's registers (columns 2 t4, 2 t4 + 1), so P
//     goes to wgmma from registers with no shuffle and no staging.
//   * The loads overlap the compute: the next K tile is loaded as soon as
//     S = Q K^T is done, the next raw V tile as soon as this one is
//     transposed, and V^T is read by P V within its tile.
//   * The softmax runs in the accumulator's registers as in the bf16
//     kernel (ex2.approx of scores scaled by scale * log2(e) in f32; the
//     mask only on key blocks that hold a masked entry).
//   * The output is normalised, staged in Q's hi buffer and written with a
//     TMA store, which clips at Tq and hd.
// hd in (128, 256] in f32 stays on csrc/flash_attention.cu: Q's two halves
// alone would take 128 KB of the 227 KB a block has.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;       // query rows per CTA (wgmma's M)
constexpr int kBlockK = 64;       // keys per K/V tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kBox = 32;          // f32 columns per TMA box (128 bytes)
constexpr int kBoxBytes = 64 * 128;   // one 64-row box
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBlockQ == kBlockK, "one TMA box shape serves Q, K, V and O");

// One K/V stage: at HD 64 a CTA then takes 112 KB and two fit an SM (two
// stages, 160 KB and one CTA an SM, ran 2.6% slower on an H100); at HD 128
// a second stage would not fit 227 KB.
template <int HD>
constexpr int smem_bytes() {
  // Q hi and lo, K hi and lo, raw V, V^T hi and lo (seven f32 tiles), three
  // mbarriers and the slack that aligns the base to 1024 bytes.
  return kBlockQ * HD * 4 * 7 + 8 * 3 + 1024;
}
// HD 128 takes 230,424 bytes of the 232,448 a block may have.
static_assert(smem_bytes<128>() <= 232448, "HD 128 exceeds 227 KB");

// rna-rounding to TF32 (a 10-bit mantissa), the low 13 bits cleared.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The f32 tile at `hi` (BYTES, any layout) becomes its hi half in place
// and its lo half at `lo`, 16 bytes a thread at a time.
template <int BYTES>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo,
                                           int tid) {
#pragma unroll
  for (int i = tid; i < BYTES / 16; i += kThreads) {
    const float4 x = reinterpret_cast<const float4*>(hi)[i];
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(hi)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

// D (64 x 64, f32) += A (64 x 8, shared, K-major) . B (8 x 64, shared,
// K-major), tf32.
__device__ __forceinline__ void wgmma_ss_m64n64k8(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 8, tf32 registers) . B (8 x 64, shared,
// K-major).
__device__ __forceinline__ void wgmma_rs_m64n64k8(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 8, tf32 registers) . B (8 x 128, shared,
// K-major).
__device__ __forceinline__ void wgmma_rs_m64n128k8(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (HD == 64)
    wgmma_rs_m64n64k8(o, a, db);
  else
    wgmma_rs_m64n128k8(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_tf32x3_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, int H, int Tk, int n_qb,
    bool causal, int q_offset, bool has_window, int window,
    float scale_log2) {
  constexpr int kBoxes = HD / kBox;          // 32-column boxes per row
  constexpr int kTile = kBlockK * HD * 4;    // bytes of one f32 tile
  constexpr int kKBox = HD * 128;            // one 32-key box of V^T
  constexpr int kAcc = HD / 2;               // O accumulator floats
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  // Byte offsets from base: Q hi, Q lo, K hi, K lo, raw V, V^T hi and lo,
  // then the mbarriers.
  constexpr int oQl = kTile, oKh = 2 * kTile, oKl = 3 * kTile;
  constexpr int oV = 4 * kTile, oVth = 5 * kTile, oVtl = 6 * kTile;
  const uint32_t bar_q = base + 7 * kTile;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_q + 16;

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

  // One tile of `map` (tile `tile` of K or V) into `dst`, counted on `bar`.
  auto load = [=](const CUtensorMap* map, uint32_t dst, uint32_t bar,
                  int tile) {
    mbar_expect_tx(bar, kTile);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_load(dst + j * kBoxBytes, map, bar, j * kBox, h, tile * kBlockK,
               b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_load(base + j * kBoxBytes, &tq, bar_q, j * kBox, h, q0, b);
    load(&tk, base + oKh, bar_k, 0);
    load(&tv, base + oV, bar_v, 0);
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
  // The V^T pass: this thread's key position p (its lane, in the warp
  // pair's half of the tile), the key that position holds, and its half of
  // the head dim's 4-column chunks.
  const int vp = lane + 32 * (warp & 1);
  const int vkey = (vp & ~7) | ((vp & 3) << 1) | ((vp >> 2) & 1);
  const int vc0 = (warp >> 1) * (HD / 8);

  float o[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(bar_q, 0);
  split_tile<kTile>(gbase, gbase + oQl, tid);
  for (int kb = 0; kb < last; ++kb) {
    const uint32_t parity = kb & 1;
    const int k0 = kb * kBlockK;

    // ---- K into hi and lo, then S = Q K^T on the tensor cores ----------
    mbar_wait(bar_k, parity);
    split_tile<kTile>(gbase + oKh, gbase + oKl, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      const uint64_t qh = smem_desc(base + off, 16, 1024);
      const uint64_t ql = smem_desc(base + oQl + off, 16, 1024);
      const uint64_t dkh = smem_desc(base + oKh + off, 16, 1024);
      const uint64_t dkl = smem_desc(base + oKl + off, 16, 1024);
      wgmma_ss_m64n64k8(s, ql, dkh);
      wgmma_ss_m64n64k8(s, qh, dkl);
      wgmma_ss_m64n64k8(s, qh, dkh);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    // Every warp is done with this K tile: load the next one.
    __syncthreads();
    if (tid == 0 && kb + 1 < last) load(&tk, base + oKh, bar_k, kb + 1);

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
    // P's hi and lo as wgmma's A fragments: k-step kk covers keys 8 kk ..
    // 8 kk + 7 in V^T's order (positions t4 and t4 + 4 hold keys 2 t4 and
    // 2 t4 + 1), the accumulator's column block kk.
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split(s[4 * kk], ph[kk][0], pl[kk][0]);
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // ---- V into V^T's hi and lo, then O += P V on the tensor cores ---
    mbar_wait(bar_v, parity);
    {
      const uint8_t* const v = gbase + oV;
      const int kbox = vp / 32, pc = (vp % 32) / 4, pe = vp % 4;
#pragma unroll
      for (int c = vc0; c < vc0 + HD / 8; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(
            v + (c / 8) * kBoxBytes + vkey * 128 +
            (((c % 8) ^ (vkey & 7)) * 16));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 4 * c + e;
          const int off = kbox * kKBox + d * 128 + ((pc ^ (d & 7)) * 16) +
                          pe * 4;
          uint32_t hi, lo;
          split(xs[e], hi, lo);
          *reinterpret_cast<uint32_t*>(gbase + oVth + off) = hi;
          *reinterpret_cast<uint32_t*>(gbase + oVtl + off) = lo;
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // Every warp has read this raw V tile: load the next one.
    if (tid == 0 && kb + 1 < last) load(&tv, base + oV, bar_v, kb + 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk / 4) * kKBox + (kk % 4) * 32;
      const uint64_t vh = smem_desc(base + oVth + off, 16, 1024);
      const uint64_t vl = smem_desc(base + oVtl + off, 16, 1024);
      wgmma_pv<HD>(o, pl[kk], vh);
      wgmma_pv<HD>(o, ph[kk], vl);
      wgmma_pv<HD>(o, ph[kk], vh);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // ---- epilogue: normalise, stage in Q's hi buffer, TMA store --------
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    const int col = 8 * j + 2 * t4;
    const int box = col / kBox;
    const int chunk = (col % kBox) / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const float dn = half ? d1 : d0;
      const uint32_t off = box * kBoxBytes + r * 128 +
                           ((chunk ^ (r & 7)) * 16) + (col % 4) * 4;
      *reinterpret_cast<float2*>(gbase + off) = make_float2(
          o[4 * j + 2 * half] / dn, o[4 * j + 2 * half + 1] / dn);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < kBoxes; ++j)
      tma_store(&to, base + j * kBoxBytes, j * kBox, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------- host side
// Raise the kernel's shared-memory cap once per device and instance.
template <int HD>
cudaError_t prepare() {
  static unsigned set_on = 0;
  return raise_smem_cap(flash_attention_tf32x3_kernel<HD>, smem_bytes<HD>(),
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
  flash_attention_tf32x3_kernel<HD><<<grid, kThreads, smem_bytes<HD>(),
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
      ctas_per_sm, flash_attention_tf32x3_kernel<HD>, kThreads, *smem);
}

}  // namespace

extern "C" {

// q, k, v and o are f32 (B, T, H, hd) tensors with a unit head-dim stride;
// strides are in elements for the batch, time and head axes, each a
// multiple of 4 (16 bytes), and every base address is 16-byte aligned (the
// Python wrapper routes here only then).  `scale` is 1/sqrt(hd).
int flash_attention_sm90_f32(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Tq, int Tk, int hd,
                             long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh,
                             long long v_sb, long long v_st, long long v_sh,
                             long long o_sb, long long o_st, long long o_sh,
                             int causal, int q_offset, int has_window,
                             int window, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (Tk <= 0 || hd <= 0 || hd > 128 || (Tq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode(fn, &tq, f32, 4, kBox, kBlockQ, q, B, Tq, H, hd, q_sb, q_st,
              q_sh) ||
      !encode(fn, &tk, f32, 4, kBox, kBlockQ, k, B, Tk, H, hd, k_sb, k_st,
              k_sh) ||
      !encode(fn, &tv, f32, 4, kBox, kBlockQ, v, B, Tk, H, hd, v_sb, v_st,
              v_sh) ||
      !encode(fn, &to, f32, 4, kBox, kBlockQ, o, B, Tq, H, hd, o_sb, o_st,
              o_sh))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  if (hd <= 64)
    return launch<64>(tq, tk, tv, to, B, H, Tq, Tk, causal, q_offset,
                      has_window, window, scale_log2, stream);
  return launch<128>(tq, tk, tv, to, B, H, Tq, Tk, causal, q_offset,
                     has_window, window, scale_log2, stream);
}

// The dynamic shared memory a CTA of the hd template takes, and how many
// CTAs fit on one SM (for the build report).
int flash_attention_sm90_f32_occupancy(int hd, int* smem, int* ctas_per_sm) {
  return hd <= 64 ? occupancy<64>(smem, ctas_per_sm)
                  : occupancy<128>(smem, ctas_per_sm);
}

}  // extern "C"
