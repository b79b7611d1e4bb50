// Thread-block clusters: the barrier halves, a DSMEM load and the launch,
// shared by the GRU kernels (gru_common.cuh) and the wide attention kernels
// (attention_common.cuh).

#pragma once

#include <cuda_runtime.h>

// The two halves of a barrier over the cluster (each CTA's writes to its own
// or its peers' shared memory before the arrive are visible to every CTA
// after the wait): work between them overlaps the barrier's latency and may
// touch only this CTA's own shared memory and device memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `local`'s offset in the shared memory of cluster rank `rank`
// (ld.shared::cluster at the address `mapa` gives).
__device__ __forceinline__ float load_cluster(const float* local, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Launch `kernel` on `blocks` x `lanes` CTAs of `threads` in clusters of
// `cluster` along x, with `smem` bytes of dynamic shared memory; returns the
// cudaError_t (0 = ok) and leaves no error behind for the next launch. The
// grid's y is the lane: a cluster never straddles two lanes.
template <typename... Params, typename... Args>
int launch_clustered_threads(void (*kernel)(Params...), int threads, int blocks, int lanes,
                             int cluster, int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, lanes);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  return (int)cudaGetLastError();
}
