// Device helpers, the step product and the cluster launch shared by the GRU
// kernels (gru_fwd.cu, gru_bwd.cu).
//
// The walk (gru_bwd.cu) and the forward up to H = 64 (gru_fwd.cu) take a
// tile of `R` rows (8 or 16) and split its hidden units over a thread-block
// cluster of `c` CTAs (1, 2 or 4): CTA `rank` owns units
// [unit_begin(rank), unit_begin(rank + 1)), with their three gate columns.
// Each step's product runs on the tensor cores (`mma_product`, 3xTF32 at
// f32 accuracy), its operands in shared memory.
//
// Hidden sizes up to kMaxH = 256. Above H = 64 the forward and the walk are
// kernels of their own ("The wide forward" of gru_fwd.cu, "The wide walk"
// of gru_bwd.cu): persistent clusters of 2 to 8 CTAs, as many as the card
// holds at once (`resident_clusters`), each CTA owning at most 32 units
// and keeping its slice of Wh for all the row tiles its cluster walks
// (`wide_tile`). Both split their operands with integer ops
// (`split_tf32_fast`, the operands made safe by `tf32_safe` first); the
// forward sends h' to its peers with bulk copies on mbarriers (the helpers
// below), the walk reads its peers' partial sums with DSMEM loads
// (`load_cluster`).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster.cuh"

#include <map>
#include <mutex>
#include <tuple>

namespace gru {

namespace cg = cooperative_groups;

constexpr int kThreads = 192;    // threads per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 256;       // largest hidden size
constexpr int kMaxUnits = 64;    // hidden units a CTA owns at most
constexpr int kMaxCluster = 8;   // CTAs per cluster (the portable maximum)

__host__ __device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }
__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Row stride, in floats, of an operand of `mma_product` whose rows hold k
// in [0, k): padded to the mma's 8 and then by 4, so that the 8 rows x 4
// columns a warp reads for one fragment fall in 32 distinct banks.
__host__ __device__ __forceinline__ int mma_ld(int k) { return round8(k) + 4; }

// First hidden unit owned by cluster rank `rank` of `c` (an even split; the
// ranks' widths differ by at most one).
__host__ __device__ __forceinline__ int unit_begin(int rank, int h, int c) {
  return rank * h / c;
}

// How `mma_product` splits C (M x N) = A (M x K) . B^T over the warps: mt
// tiles of 16 rows of A, kt steps of 8 along K, cut into kg groups of ksg
// steps; each (tile, group) is one warp's task and one partial sum.
struct MmaPlan {
  int mt, kt, kg, ksg;
};

__host__ __device__ __forceinline__ MmaPlan mma_plan(int m, int k) {
  const int mt = (m + 15) / 16;
  const int kt = (k + 7) / 8;
  int kg = kWarps / mt;
  if (kg > kt) kg = kt;
  if (kg < 1) kg = 1;
  const int ksg = (kt + kg - 1) / kg;
  return {mt, kt, (kt + ksg - 1) / ksg, ksg};
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A thread's share of a grid of rows x `width` columns walked by all
// kThreads: column `col`, rows first, first + step, ... (width <= kThreads).
struct Share {
  int col, first, step;
  bool on;
};

__device__ __forceinline__ Share share(int width) {
  const int step = kThreads / width;
  const int tid = threadIdx.x;
  return {tid % width, tid / width, step, tid < step * width};
}

// One float from device memory into shared memory with cp.async: the copy
// runs while the thread goes on; `cp_async_wait_all` then a barrier make it
// visible.
__device__ __forceinline__ void copy_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Four floats (16 bytes, both addresses 16-byte aligned) likewise, through
// L2 only (.cg).
__device__ __forceinline__ void copy_f32x4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cp.async copies issued since the last commit form one group; a wait
// for `N` returns when at most N groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A barrier over the cluster (every CTA's writes to its peers' shared memory
// before it are visible after it), or over the CTA when the cluster is one.
__device__ __forceinline__ void cluster_barrier(int csize) {
  if (csize > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Store v at `local` in the shared memory of every CTA of the cluster
// (st.shared::cluster to the address `mapa` gives for each rank).
__device__ __forceinline__ void store_cluster(float* local, float v, int csize) {
  if (csize == 1) {
    *local = v;
    return;
  }
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  for (int q = 0; q < csize; ++q) {
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(q));
    asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
  }
}

// An mbarrier in this CTA's shared memory (its shared-window address):
// `mbar_init` (one thread, then a cluster barrier), each phase completed by
// one arrival that expects `bytes` (`mbar_expect`) and by the bulk copies
// that bring them (`bulk_copy_to`), waited on by its parity (`mbar_wait`).
__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` completes; traps (an error the
// launch's caller sees, not a hang) if that takes ~2^32 cycles.
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 32)) __trap();
  }
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from this
// CTA's shared memory at `src` to the same offset in cluster rank `rank`'s,
// completing `bytes` on that CTA's mbarrier at `mbar` (this CTA's address of
// it). Shared writes before it need `fence.proxy.async.shared::cta` and a
// barrier first.
__device__ __forceinline__ void bulk_copy_to(const float* src, unsigned bytes, int rank,
                                             unsigned mbar) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  unsigned dst, bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(s), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(bar) : "r"(mbar), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], "
      "%2, [%3];\n" ::"r"(dst),
      "r"(s), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x = hi + lo, both TF32 (10-bit mantissas): 3xTF32 keeps f32 accuracy.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// split_tf32's values at the full rate of integer and f32 ops (its
// cvt.rna runs on a slower pipe): round to nearest, ties away from zero, by
// adding half a TF32 ulp to the bits and dropping the low 13 (for every
// finite x bitwise what cvt.rna gives). A NaN must come as `tf32_safe`
// gives it: the device's own NaN (0x7fffffff) would carry into the sign
// and round to -0.
__device__ __forceinline__ void split_tf32_fast(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// x, but a NaN as 0x7fc00000, which split_tf32_fast keeps a NaN in hi (lo,
// a NaN rounded to -0, does not matter then): the operands of the wide
// kernels' products pass through it once, where they are written to
// shared memory or split, so that a NaN of an operand reaches the product
// as it does through cvt.rna.
__device__ __forceinline__ float tf32_safe(float x) {
  return x != x ? __int_as_float(0x7fc00000) : x;
}

// c (16 x 8, f32) += a (16 x 8, tf32) . b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float* c, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A's fragments of one warp's task, split into TF32 halves, held in
// registers for the whole recurrence (A is a slice of Wh, fixed over the
// steps), when every warp has at most one task of at most kRegSteps steps.
constexpr int kRegSteps = 4;

struct AFrags {
  unsigned hi[kRegSteps][4], lo[kRegSteps][4];
};

__host__ __device__ __forceinline__ bool a_in_registers(MmaPlan pl) {
  return pl.mt * pl.kg <= kWarps && pl.ksg <= kRegSteps;
}

// The host's choice for a launch, whose CTAs own `h / c` or `h / c + 1`
// units: A in registers only if every CTA's plan allows it, so that the
// kernel that keeps no fragments does not pay their registers.
inline bool a_in_registers(int h, int cluster, MmaPlan (*plan)(int h, int units)) {
  return a_in_registers(plan(h, h / cluster)) &&
         a_in_registers(plan(h, (h + cluster - 1) / cluster));
}

// The fragments a = A[g | g+8][k0 + (t | t+4)] of k-step ks, split.
__device__ __forceinline__ void load_a(const float* a0, const float* a1, int k0,
                                       unsigned* hi, unsigned* lo) {
  split_tf32(a0[k0], hi[0], lo[0]);
  split_tf32(a1[k0], hi[1], lo[1]);
  split_tf32(a0[k0 + 4], hi[2], lo[2]);
  split_tf32(a1[k0 + 4], hi[3], lo[3]);
}

// This warp's A fragments (for `mma_product<NT, true>`); A as there.
__device__ __forceinline__ void load_a_frags(const float* A, int lda, MmaPlan pl,
                                             AFrags& f) {
  const int task = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* a0 = A + ((task % pl.mt) * 16 + (lane >> 2)) * lda + (lane & 3);
  const int ks0 = (task / pl.mt) * pl.ksg;
#pragma unroll
  for (int i = 0; i < kRegSteps; ++i) {
    if (task < pl.mt * pl.kg && i < pl.ksg && ks0 + i < pl.kt)
      load_a(a0, a0 + 8 * lda, (ks0 + i) * 8, f.hi[i], f.lo[i]);
  }
}

// Partial sums of C[n][m] = sum_k A[m][k] B[n][k] on the tensor cores, at
// f32 accuracy: each product is a_hi b_hi + a_hi b_lo + a_lo b_hi (3xTF32),
// the small terms summed apart from the large. A: shared, mt*16 rows (zero
// beyond M), row stride lda, or with kAReg this warp's fragments `fr`; B:
// shared, 8*NT rows, stride ldb; both zero in columns K .. kt*8. Writes
// P[(group * 8*NT + n) * ldp + m] for every m < mt*16 and n < 8*NT, one
// slice per k-group; every warp of the CTA calls it. Fragment layouts are
// those of mma.m16n8k8 (PTX ISA): with g = lane/4, t = lane%4, a = A[g |
// g+8][t | t+4], b = B^T[t | t+4][g], c = C[g | g+8][2t | 2t+1].
template <int NT, bool kAReg>
__device__ __forceinline__ void mma_product(const float* __restrict__ A, int lda,
                                            const AFrags& fr,
                                            const float* __restrict__ B, int ldb,
                                            MmaPlan pl, float* __restrict__ P, int ldp) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int task = warp; task < pl.mt * pl.kg; task += kWarps) {
    const int mtile = task % pl.mt;
    const int grp = task / pl.mt;
    const int ks0 = grp * pl.ksg;
    const int nks = min(pl.kt, ks0 + pl.ksg) - ks0;
    float big[NT][4], small[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) big[nt][i] = small[nt][i] = 0.0f;
    }
    const float* a0 = A + (mtile * 16 + g) * lda + t;
    auto step = [&](int k0, const unsigned* ahi, const unsigned* alo) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* b = B + (nt * 8 + g) * ldb + k0 + t;
        unsigned bhi0, blo0, bhi1, blo1;
        split_tf32(b[0], bhi0, blo0);
        split_tf32(b[4], bhi1, blo1);
        mma_tf32(small[nt], alo, bhi0, bhi1);
        mma_tf32(small[nt], ahi, blo0, blo1);
        mma_tf32(big[nt], ahi, bhi0, bhi1);
      }
    };
    if (kAReg) {
#pragma unroll
      for (int i = 0; i < kRegSteps; ++i)
        if (i < nks) step((ks0 + i) * 8, fr.hi[i], fr.lo[i]);
    } else {
#pragma unroll 4
      for (int i = 0; i < nks; ++i) {
        unsigned ahi[4], alo[4];
        load_a(a0, a0 + 8 * lda, (ks0 + i) * 8, ahi, alo);
        step((ks0 + i) * 8, ahi, alo);
      }
    }
    float* p = P + grp * (8 * NT) * ldp + mtile * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = nt * 8 + 2 * t;
      p[n * ldp] = big[nt][0] + small[nt][0];
      p[(n + 1) * ldp] = big[nt][1] + small[nt][1];
      p[n * ldp + 8] = big[nt][2] + small[nt][2];
      p[(n + 1) * ldp + 8] = big[nt][3] + small[nt][3];
    }
  }
}

// `launch_clustered_threads` with kThreads a CTA.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int blocks, int lanes, int cluster,
                     int smem, cudaStream_t stream, Args... args) {
  return launch_clustered_threads(kernel, kThreads, blocks, lanes, cluster, smem, stream,
                                  args...);
}

// The host's check of a launch shape: 8- or 16-row tiles, 1 to kMaxCluster
// CTAs per cluster, each owning at least one and at most kMaxUnits hidden
// units, 1 to kMaxLanes lanes. (A shape whose shared memory exceeds the
// card's per-block limit is refused by the launch itself.)
constexpr int kMaxLanes = 65535;   // the grid's y extent
inline bool valid_shape(int h, int rows, int cluster, int lanes) {
  return h > 0 && h <= kMaxH && (rows == 8 || rows == 16) && cluster >= 1 &&
         cluster <= kMaxCluster && cluster <= h &&
         (h + cluster - 1) / cluster <= kMaxUnits && lanes >= 1 && lanes <= kMaxLanes;
}

// ---- persistent clusters (the wide kernels) ---------------------------------

// The k-th tile of cluster `cl` of `clusters`, or -1 past the last of
// `tiles` (ops/kernels/gru.py `fwd_tiles`).
__host__ __device__ __forceinline__ int wide_tile(int cl, int k, int clusters, int tiles) {
  const int tile = cl + k * clusters;
  return tile < tiles ? tile : -1;
}

// Clusters a wide launch gives each of `lanes` lanes of `tiles` tiles: as
// many as the card holds resident at once, shared among the lanes (at least
// one a lane), never more than the tiles (`fwd_clusters` of
// ops/kernels/gru.py, which takes `resident` from the card's SMs).
inline int wide_clusters(int tiles, int lanes, int resident) {
  int per = resident / lanes;
  if (per < 1) per = 1;
  return per < tiles ? per : tiles;
}

// Clusters of `cluster` CTAs of `kernel` with `smem` bytes each that the
// card holds resident at once (cudaOccupancyMaxActiveClusters), cached per
// device, kernel, cluster and size; 0 if the query fails.
template <typename... Params>
int resident_clusters(void (*kernel)(Params...), int threads, int cluster, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, int>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  const auto key = std::make_tuple(dev, (const void*)kernel, cluster, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = cache.find(key);
    if (it != cache.end()) return it->second;
  }
  int n = 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = n;
  return n;
}

}  // namespace gru
