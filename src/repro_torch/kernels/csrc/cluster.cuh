// Thread block clusters and distributed shared memory (sm_90), shared by
// csrc/sroa_bisect.cu (K2's cluster kernel) and csrc/topk_moves.cu (K3's).
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

}  // namespace
