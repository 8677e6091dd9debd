// What the chunked kernels share, csrc/ssd_chunked.cu (S1, S1b) and
// csrc/mlstm_chunked.cu (S2b): swizzled f32 tiles in shared memory, the
// TF32 split, the 3xTF32 mma.sync m16n8k8 over a block's warps
// (`WarpTile`), 16-byte asynchronous copies, and a chunk's decay products.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr unsigned kAll = 0xffffffffu;

// Element (r, c) of a row-major tile W floats wide (W = 16 or a multiple
// of 32): the 4-column group XORed with bits of the row, so a fragment
// read along rows (8 rows x 4 columns) or along columns (4 rows x 8
// columns) hits 32 banks.  A 16-float row holds two rows to a bank line:
// its XOR keeps within the row (bits 2 and 3).
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
template <int W>
__device__ __forceinline__ int at(int r, int c) {
  static_assert(W == 16 || W % 32 == 0,
                "a tile is 16 floats wide or a multiple of 32");
  if constexpr (W == 16) return r * 16 + (c ^ (((r & 2) << 2) | (r & 4)));
  return r * W + (c ^ swz(r));
}

// x rounded to TF32, to nearest with ties away from zero: half a TF32 unit
// added to the magnitude's bits, the low 13 bits cleared.  The bits of
// cvt.rna.tf32.f32 for every finite x (ref.tf32_round), in two integer
// operations at the ALU's full rate instead of the conversion unit's.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// d (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's share of an (M, N) f32 product on NW warps: WM warps along the
// rows, WN along the columns, each MT tiles of 16 rows by NT of 8 columns
// (the mma's C fragment: rows g and g + 8, columns 2 t4 and 2 t4 + 1).  A
// product too small for NW warps (16 x 16 on 8) leaves the last warps idle:
// `active` is false there, and every member does nothing.
template <int M, int N, int NW>
struct WarpTile {
  // As square a warp tile as the rows allow: 4 warps 2 x 2, 8 warps 4 x 2.
  static constexpr int WM = (M / 16 < NW / 2) ? M / 16 : NW / 2;
  static constexpr int WN = (NW / WM < N / 8) ? NW / WM : N / 8;
  static constexpr int MT = M / 16 / WM;
  static constexpr int NT = N / 8 / WN;
  static_assert(WM * WN <= NW && MT * WM * 16 == M && NT * WN * 8 == N,
                "the warps must tile the product");
  float acc[MT][NT][4];
  int r0, c0, g, t4, wm, wn;
  bool active;

  __device__ __forceinline__ explicit WarpTile(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    g = lane >> 2;
    t4 = lane & 3;
    wm = warp / WN;
    wn = warp % WN;
    active = warp < WM * WN;
    r0 = wm * MT * 16;
    c0 = wn * NT * 8;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  // acc += A (M x K) . B (K x N), a(m, k) and b(k, n) the f32 operands;
  // each split, lo.hi + hi.lo + hi.hi.
  template <int K, class FA, class FB>
  __device__ __forceinline__ void mma(FA a, FB b) {
    if (!active) return;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = c0 + j * 8 + g;
        split(b(k0 + t4, n), bh[j][0], bl[j][0]);
        split(b(k0 + t4 + 4, n), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = r0 + i * 16 + g;
        uint32_t ah[4], al[4];
        split(a(m, k0 + t4), ah[0], al[0]);
        split(a(m + 8, k0 + t4), ah[1], al[1]);
        split(a(m, k0 + t4 + 4), ah[2], al[2]);
        split(a(m + 8, k0 + t4 + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_tf32(acc[i][j], al, bh[j]);
          mma_tf32(acc[i][j], ah, bl[j]);
          mma_tf32(acc[i][j], ah, bh[j]);
        }
      }
    }
  }

  // fn(row, col, element) over the elements this thread holds.
  template <class Fn>
  __device__ __forceinline__ void each(Fn fn) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fn(r0 + i * 16 + g + (e >> 1) * 8, c0 + j * 8 + 2 * t4 + (e & 1),
             acc[i][j][e]);
  }

  // fn(row, col, e) over this thread's pairs of adjacent columns: the
  // elements e and e + 1 of acc[i][j] (e = 0, 2) at (row, col + {0, 1}).
  template <class Fn>
  __device__ __forceinline__ void pairs(Fn fn) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; e += 2)
          fn(i, j, e, r0 + i * 16 + g + (e >> 1) * 8, c0 + j * 8 + 2 * t4);
  }

  // part[wn * M + row] = the sum over this warp's columns of fn(row, col,
  // element) (the lanes of a quad, then in column order within a lane).
  template <class Fn>
  __device__ __forceinline__ void row_sums(float* part, Fn fn) {
    if (!active) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + i * 16 + g + hf * 8;
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s = __fadd_rn(s, fn(row, c0 + j * 8 + 2 * t4 + e,
                                acc[i][j][2 * hf + e]));
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, 1));
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, 2));
        if (t4 == 0) part[wn * M + row] = s;
      }
  }

  // part[wm * N + col] = the sum over this warp's rows of fn(row, col,
  // element) (in row order within a lane, then over the 8 row groups).
  template <class Fn>
  __device__ __forceinline__ void col_sums(float* part, Fn fn) {
    if (!active) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + j * 8 + 2 * t4 + e;
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            s = __fadd_rn(s, fn(r0 + i * 16 + g + hf * 8, col,
                                acc[i][j][2 * hf + e]));
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, 4));
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, 8));
        s = __fadd_rn(s, __shfl_xor_sync(kAll, s, 16));
        if (g == 0) part[wm * N + col] = s;
      }
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src-size 0: nothing is read).
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// seg (threads 0..L-1, one column each, built down from its diagonal: the
// twin model's order), w = seg's last row, and p (thread L).
template <int L>
__device__ __forceinline__ void segments(const float* sDec, float* sSeg,
                                         float* sW, float* sP, int tid) {
  if (tid < L) {
    const int s = tid;
    float v = 0.0f;
#pragma unroll 16
    for (int t = 0; t < L; ++t) {
      v = t < s ? 0.0f : (t == s ? 1.0f : __fmul_rn(v, sDec[t]));
      sSeg[at<L>(t, s)] = v;
    }
    sW[s] = v;
  } else if (tid == L) {
    float p = 1.0f;
#pragma unroll 16
    for (int t = 0; t < L; ++t) {
      p = __fmul_rn(p, sDec[t]);
      sP[t] = p;
    }
  }
}

}  // namespace
