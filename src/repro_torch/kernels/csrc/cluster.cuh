// Thread block clusters and distributed shared memory (sm_90), shared by
// csrc/sroa_bisect.cu (K2's cluster kernel), csrc/topk_moves.cu (K3's) and
// csrc/ssm_scan.cu, csrc/ssm_scan_bwd.cu (S3, S3b).
//
// A block of a cluster reaches another block's shared memory through the
// cluster's window: `mapa` turns this block's shared address into block
// `rank`'s, and ld/st.shared::cluster access it.  The cluster barrier's
// release/acquire makes every store before it, to any block, visible to
// every thread of the cluster after it.  A block must not touch another's
// shared memory before that block has started (the first barrier) or
// after it may have left (its last barrier).
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// Both halves of a cluster barrier; `cluster_sync` is the pair with release
// and acquire.  Every thread of every block of the cluster must take them.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The address of `p` (this block's shared memory) in block `rank`.
__device__ __forceinline__ unsigned cluster_addr(const void* p,
                                                 unsigned rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(float* p, unsigned rank,
                                           float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(cluster_addr(p, rank)), "f"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(int* p, unsigned rank, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;"
               :: "r"(cluster_addr(p, rank)), "r"(v) : "memory");
}

__device__ __forceinline__ void st_cluster(uint2* p, unsigned rank,
                                           uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};"
               :: "r"(cluster_addr(p, rank)), "r"(v.x), "r"(v.y)
               : "memory");
}

__device__ __forceinline__ unsigned ld_cluster(const unsigned* p,
                                               unsigned rank) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];"
               : "=r"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_cluster(
    const unsigned long long* p, unsigned rank) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];"
               : "=l"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

__device__ __forceinline__ uint2 ld_cluster(const uint2* p, unsigned rank) {
  uint2 v;
  asm volatile("ld.shared::cluster.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

// A store into block `rank`'s shared memory that completes 4 bytes of a
// transaction on that block's mbarrier at `bar`'s offset (st.async): the
// receiver waits on its own mbarrier's phase (`mbar_wait_cluster`), not
// on a barrier of the whole cluster.
__device__ __forceinline__ void st_async(float* p, unsigned rank, float v,
                                         const void* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];" ::"r"(cluster_addr(p, rank)),
      "f"(v), "r"(cluster_addr(bar, rank))
      : "memory");
}

// Two adjacent floats (8-byte aligned) in one st.async: 8 bytes of the
// transaction.
__device__ __forceinline__ void st_async(float2* p, unsigned rank, float2 v,
                                         const void* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(cluster_addr(p, rank)),
      "f"(v.x), "f"(v.y), "r"(cluster_addr(bar, rank))
      : "memory");
}

// The mbarriers' initialisation made visible to the cluster's other blocks
// (before the cluster barrier that precedes their first st.async).
__device__ __forceinline__ void mbar_init_fence_cluster() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait for the phase of parity `parity` of this block's mbarrier at shared
// address `bar` to complete, acquiring at cluster scope what the other
// blocks' st.async wrote.
__device__ __forceinline__ void mbar_wait_cluster(unsigned bar,
                                                  unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace
