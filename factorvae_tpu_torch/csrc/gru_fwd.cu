// GRU recurrence forward (K1) for Hopper, f32 accuracy on the tensor cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// factorvae_tpu/ops/pallas/gru.py (launched by `_forward_impl`, public
// `gru_scan`). Computes, for every row (stock) independently, with the gate
// blocks in torch order [r | z | n]:
//
//   g  = h . Wh + b                          (1, 3H)
//   r  = sigmoid(x_r + g_r)     z = sigmoid(x_z + g_z)
//   n  = tanh(x_n + r * g_n)                 (b_n is inside g_n, before r *)
//   h' = (1 - z) * n + z * h
//
// over t = 0..T-1 from h = 0, and writes the last h. Its training variant
// also writes, as it goes, the residuals the backward walk (gru_bwd.cu)
// reads: h before each step, hseq (N, T, H), and g of each step, gseq (N, T,
// 3H). Both variants are one template, so their h is bitwise the same.
//
// Inputs: xi (N, T, 3H) row-major, read in place (no per-gate transpose);
// Wh (H, 3H); b (3H). Output: h (N, H). A launch carries S lanes, each its
// own model (the fleets of train/fleet.py, the counterpart of Pallas's
// batching rule under jax.vmap): xi (S, N, T, 3H), Wh (S, H, 3H), b (S, 3H)
// -> h (S, N, H), residuals (S, N, T, .). The grid's y is the lane, so a
// CTA or a cluster never straddles two lanes and lane i computes bitwise
// what a one-lane launch of the same shape computes.
//
// Bound: 2*N*T*H*3H FLOPs of h . Wh, each done as three TF32 products
// (495 TFLOP/s dense on an H100 SXM, so 165 TFLOP/s at f32 accuracy),
// against 4*N*T*3H bytes of xi (plus 16*N*T*H bytes of residuals in
// training). Bytes bound it: 0.0014 ms at one flagship training day (N = 304,
// T = 20, H = 64; 0.0033 ms with the residuals) and 0.045 ms at a 32-day
// serving chunk (N = 9,728). Latency, not either rate, holds it back: T
// dependent steps, each a small product, the gates and a barrier.
//
// At H = 256 the product is 16 times the flagship's per row and step: 2.4
// GFLOP at one training day (N = 304, T = 20), 0.0145 ms at f32 accuracy
// on the tensor cores, above the bytes' 0.0056 ms (0.013 ms with the
// residuals): operations bound it there, and latency still holds it back.
//
// Design up to H = 64 (the launch shape comes from the wrapper's rule,
// `ops/kernels/gru.py:fwd_launch_shape`, there `launch_shape`, the walk's):
// - A tile of R = 8 or 16 rows is split over a thread-block cluster of c = 1,
//   2 or 4 CTAs (gru_common.cuh): CTA `rank` owns H/c hidden units and
//   their three gate columns of Wh, computes that slice of g and of h', and
//   stores its slice of h' into every CTA's shared memory
//   (st.shared::cluster); one cluster barrier per step then gives every CTA
//   the full h for the next product. At one flagship day 8-row tiles x c =
//   4 make 152 CTAs, where 16-row tiles alone made 19; at the serving chunk
//   16-row tiles x c = 1 make 608.
// - The step product g^T = Wh^T . h^T runs on mma.sync.m16n8k8 with TF32
//   inputs split 3 ways (a = a_hi + a_lo; a_hi b_hi + a_hi b_lo + a_lo b_hi),
//   which keeps f32 accuracy: Wh^T's gate columns are the M side, so an
//   8-row tile fills the n8 side and no half tile is wasted. Operands sit in
//   shared memory with row strides of 4 mod 8 floats (conflict-free
//   fragment loads); Wh's fragments stay in registers for all T steps when
//   each warp has one task (at one day). Partial sums over k-groups meet in
//   shared memory and the gate threads add them in a fixed order.
// - xi of step t+1 is copied into shared memory with cp.async between the
//   arrive and the wait of step t's cluster barrier, so the copy overlaps
//   the barrier and step t+1's product (a double buffer, since the
//   cluster's barrier no longer orders this CTA's own readers). Without a
//   cluster xi has one buffer and is staged right after the CTA's barrier.
// - h is double-buffered in a cluster: a peer may store step t's h' while
//   this CTA still reads step t-1's h.
//
// Design above H = 64 ("The wide forward" below). That layout, taken to H
// = 256 (8-row tiles over 8-CTA clusters), spent its time on what the
// tiles did not share (scripts/torch_gru_fwd_probe.py on an H100 SXM at
// 700 W): at a 32-day chunk 9,728 CTAs, one an SM, each staged its 100 KB
// Wh slice with 4-byte copies (2.14 of 9.96 ms at T = 1) and ran one warp's
// chain of 96 dependent MMAs a step for 8 rows (~5 us a step, 0.41 ms for
// 74 waves). The wide forward keeps each CTA's slice for all its tiles
// (persistent clusters, as many as the card holds: 15 of 8 CTAs each at H =
// 256), stages it once with 16-byte copies, and walks tiles of 16, 32 or 64
// rows (`fwd_launch_shape` weighs rounds of tiles against a step's fixed
// cost), each warp holding 3 x 2 to 3 x 4 independent accumulators; the
// TF32 split is done with integer ops (cvt.rna's pipe throttled it), the
// gates run on the accumulators, and h' goes to the peers as one bulk copy
// of this CTA's rows each (8,192 scalar DSMEM stores a step before). The
// same probe then reads 0.035 ms at T = 1 and 0.126 ms a step at the chunk
// (2.42-2.49 ms), 0.154-0.160 at one day; a row's h is bitwise what the layout above
// gave. Two pipelines of 32 rows a CTA, synchronised by mbarriers in place
// of the cluster barrier, ran slower and were not kept.
// Why not wgmma: up to H = 64 a 64-row tile would leave 5 CTAs for 132 SMs
// at one training day, a latency-bound recurrence, not a throughput-bound
// product. Above it the wide forward's tiles reach 64 rows, and its product
// is most of a step at the chunk; wgmma (64-row tiles of h^T against the Wh
// slice, the 3xTF32 split kept) is the next step there, untried.

#include <cstdint>

#include "gru_common.cuh"

namespace {

using namespace gru;

// Shared memory in floats: tiles of `rows`, units of width <= umax. The h
// and xi buffers are double only for a cluster: peers store into h, and the
// next xi is staged while the cluster barrier completes.
__host__ __device__ __forceinline__ int fwd_smem_floats(int h, int rows, int umax,
                                                        int csize) {
  const int nbuf = csize > 1 ? 2 : 1;
  return nbuf * rows * mma_ld(h)          // h (rows, ldh), cols >= h zero
         + round16(3 * umax) * mma_ld(h)  // Wh^T of this CTA's columns
         + rows * kThreads                // the product's partial sums
         + nbuf * rows * 3 * umax         // xi of a step, this CTA's columns
         + 3 * umax;                      // b, this CTA's columns
}

// The plan of the step product of a CTA that owns `units` hidden units.
__host__ __device__ inline MmaPlan fwd_plan(int h, int units) { return mma_plan(3 * units, h); }

template <int R, bool kResiduals, bool kAReg>
__global__ void __launch_bounds__(kThreads)
gru_fwd_kernel(const float* __restrict__ xi, const float* __restrict__ wh,
               const float* __restrict__ bh, float* __restrict__ h_out,
               float* __restrict__ hseq, float* __restrict__ gseq,
               int n_rows, int t_len, int h, int csize) {
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  const int ldh = mma_ld(h);
  {                         // this CTA's lane: its slice of every array
    const long long lane = blockIdx.y;
    const long long nt = (long long)n_rows * t_len;
    xi += lane * nt * h3;
    wh += lane * h * h3;
    bh += lane * h3;
    h_out += lane * n_rows * h;
    if (kResiduals) {
      hseq += lane * nt * h;
      gseq += lane * nt * h3;
    }
  }
  const int rank = blockIdx.x % csize;
  const int u0 = unit_begin(rank, h, csize);
  const int un = unit_begin(rank + 1, h, csize) - u0;   // this CTA's units
  const int umax = (h + csize - 1) / csize;
  const int ncol = 3 * un;                              // [r | z | n] of them
  const MmaPlan pl = fwd_plan(h, un);
  const int ldp = pl.mt * 16;

  float* smem = reinterpret_cast<float*>(smem4);
  const int nbuf = csize > 1 ? 2 : 1;
  float* h_buf = smem;                            // nbuf x (R, ldh)
  float* w_s = h_buf + nbuf * R * ldh;            // (round16(3 umax), ldh)
  float* p_s = w_s + round16(3 * umax) * ldh;     // (kg, R, ldp)
  float* x_buf = p_s + R * kThreads;              // nbuf x (R, ncol)
  float* b_s = x_buf + nbuf * R * 3 * umax;       // (ncol,)

  const int tid = threadIdx.x;
  const long long row0 = (long long)(blockIdx.x / csize) * R;
  const int rows = (int)min((long long)R, (long long)n_rows - row0);

  // column jj of this CTA's [r | z | n] block -> column of Wh, b and xi
  auto gcol = [&](int jj) { return (jj / un) * h + u0 + jj % un; };

  for (int i = tid; i < nbuf * R * ldh; i += kThreads) h_buf[i] = 0.0f;
  for (int i = tid; i < pl.mt * 16 * ldh; i += kThreads) {
    const int k = i / ldp;           // coalesced over the columns of Wh
    const int m = i - k * ldp;
    if (m < ncol && k < h) copy_f32(w_s + m * ldh + k, wh + k * h3 + gcol(m));
    else w_s[m * ldh + k] = 0.0f;
  }
  for (int i = tid; i < ncol; i += kThreads) copy_f32(b_s + i, bh + gcol(i));

  const Share st = share(ncol);      // this thread's xi copies: one column
  const int st_col = gcol(st.col);
  auto x_step = [&](int t) { return x_buf + (t & (nbuf - 1)) * R * 3 * umax; };
  auto stage = [&](int t) {          // xi_t of this CTA's columns into its buffer
    if (!st.on) return;
    float* x_s = x_step(t);
    for (int r = st.first; r < rows; r += st.step)
      copy_f32(x_s + r * ncol + st.col, xi + ((row0 + r) * t_len + t) * (long long)h3 + st_col);
  };
  const Share ew = share(un);        // this thread's gate items: one unit
  const int u = ew.col;
  const int c = u0 + u;

  if (t_len > 0) stage(0);
  cp_async_wait_all();
  cluster_barrier(csize);   // every peer has started and zeroed its h
  AFrags fr;
  if (kAReg) load_a_frags(w_s, ldh, pl, fr);
  float bias[3] = {0.0f, 0.0f, 0.0f};
  if (ew.on) {
    bias[0] = b_s[u];
    bias[1] = b_s[un + u];
    bias[2] = b_s[2 * un + u];
  }

  int cur = 0;
  for (int t = 0; t < t_len; ++t) {
    const float* h_cur = h_buf + cur * R * ldh;
    float* h_nxt = h_buf + (nbuf == 2 ? cur ^ 1 : cur) * R * ldh;
    mma_product<R / 8, kAReg>(w_s, ldh, fr, h_cur, ldh, pl, p_s, ldp);
    cp_async_wait_all();
    __syncthreads();

    if (ew.on) {
      for (int r = ew.first; r < rows; r += ew.step) {
        float gr = 0.0f, gz = 0.0f, gn = 0.0f;
        for (int s = 0; s < pl.kg; ++s) {
          const float* p = p_s + (s * R + r) * ldp;
          gr += p[u];
          gz += p[un + u];
          gn += p[2 * un + u];
        }
        gr += bias[0];
        gz += bias[1];
        gn += bias[2];
        const float* x = x_step(t) + r * ncol;
        const float rg = sigmoid_f(x[u] + gr);
        const float zg = sigmoid_f(x[un + u] + gz);
        const float ng = tanhf(x[2 * un + u] + rg * gn);
        const float hprev = h_cur[r * ldh + c];
        if (kResiduals) {
          const long long at = (row0 + r) * t_len + t;
          hseq[at * h + c] = hprev;
          float* g = gseq + at * h3;
          g[c] = gr;
          g[h + c] = gz;
          g[2 * h + c] = gn;
        }
        store_cluster(h_nxt + r * ldh + c, (1.0f - zg) * ng + zg * hprev, csize);
      }
    }
    if (csize > 1) {         // stage xi_{t+1} while the barrier completes
      cluster_arrive();
      if (t + 1 < t_len) stage(t + 1);
      cluster_wait();
      cur ^= 1;
    } else {
      __syncthreads();
      if (t + 1 < t_len) stage(t + 1);
    }
  }

  const float* h_fin = h_buf + cur * R * ldh;
  if (ew.on) {
    for (int r = ew.first; r < rows; r += ew.step)
      h_out[(row0 + r) * h + c] = h_fin[r * ldh + c];
  }
}

template <int R, bool kResiduals>
int launch(const float* xi, const float* wh, const float* bh, float* h_out,
           float* hseq, float* gseq, int n_rows, int t_len, int h, int cluster,
           int lanes, cudaStream_t stream) {
  const int tiles = (n_rows + R - 1) / R;
  const int smem = (int)sizeof(float) *
                   fwd_smem_floats(h, R, (h + cluster - 1) / cluster, cluster);
  return launch_clustered(a_in_registers(h, cluster, fwd_plan)
                              ? gru_fwd_kernel<R, kResiduals, true>
                              : gru_fwd_kernel<R, kResiduals, false>,
                          tiles * cluster, lanes, cluster, smem, stream, xi, wh, bh, h_out,
                          hseq, gseq,
                          n_rows, t_len, h, cluster);
}

// ---- The wide forward (64 < H <= 256) ----------------------------------------
//
// Persistent clusters: a lane's row tiles go to `clusters` clusters, tile
// cl, cl + clusters, cl + 2 clusters, ... to cluster cl (`wide_tile` of
// gru_common.cuh, a copy of ops/kernels/gru.py `fwd_tiles`); each CTA stages its slice of Wh
// (K-major, 16-byte copies where aligned) and its b once and keeps them for
// all its tiles. A CTA owns un <= 64 units in groups of 16; its Wh columns
// are laid out group by group, [r | z | n] of the group's 16 units, so one
// warp's three m16 tiles of a group hold r, z and n of the same units and
// the gates run on the accumulators in registers. h^T (k, row) of the tile,
// every unit, sits in shared memory once (a single buffer): a step is the
// product, an arrive on the cluster barrier (this CTA has read h), the
// gates and the next step's xi into registers (overlapping the barrier),
// the wait, h' into this CTA's units' rows of h^T, and those rows,
// contiguous, to every peer with one bulk copy each (cp.async.bulk), which
// completes on the peer's mbarrier: a CTA's next product waits on its own.
// The product splits its operands with integer ops (`split_tf32_fast`), so
// both pass through `tf32_safe` where they are written to shared memory
// (Wh once, h' each step), and a NaN of either reaches g as a NaN; a guard
// in the split itself cost 18-24 % of the chunk's time and registers.

constexpr int kWideGroup = 16;     // units of a group: three m16 tiles

__host__ __device__ __forceinline__ int wide_groups(int umax) {
  return (umax + kWideGroup - 1) / kWideGroup;
}
// Row strides, in floats, of the Wh slice (k, column) and of h^T (k, row):
// 8 or 24 mod 32, so a fragment's 4 k x 8 columns fall in 32 distinct banks.
__host__ __device__ __forceinline__ int wide_ldw(int umax) {
  return 3 * kWideGroup * wide_groups(umax) + 8;
}
__host__ __device__ __forceinline__ int wide_ldh(int rows) { return rows | 8; }

__host__ __device__ __forceinline__ int wide_smem_floats(int h, int rows, int umax) {
  return round8(h) * (wide_ldw(umax) + wide_ldh(rows)) + 2;   // + the mbarrier
}

// A tile of R rows is kBlocks row blocks of kNt n8 tiles over a CTA of W
// warps, and (unit group, row block) is one warp's task. Tiles of 32 and 64
// rows take at most 32 units a CTA (two groups): W / 2 blocks, so that each
// warp splits Wh's fragments once for 16 or 32 rows; 16-row tiles two
// blocks of 8 rows and 8 warps (up to 64 units, four groups).
template <int R, int W>
struct WideTiles {
  static constexpr int kBlocks = R >= 32 ? W / 2 : R / 8;
  static constexpr int kNt = R / (8 * kBlocks);
  static constexpr int kThreads = 32 * W;
};

// Warps of a CTA: 4 for tiles of 32 rows, and of 64 up to H = 128 (two CTAs
// share an SM there), 8 for tiles of 64 above (one CTA fills an SM's shared
// memory, and needs two warps a scheduler to hide the latency), 8 for
// tiles of 16 rows.
__host__ __device__ __forceinline__ int wide_warps(int h, int rows) {
  return rows == 32 || (rows == 64 && h <= 128) ? 4 : 8;
}

// The host's check of a wide launch shape: every task of a CTA on a warp of
// its own (tiles of 32 and 64 rows take at most 32 units a CTA).
inline bool valid_wide_shape(int h, int rows, int cluster, int lanes) {
  if (h <= kMaxUnits || h > kMaxH || cluster < 2 || cluster > kMaxCluster || lanes < 1 ||
      lanes > kMaxLanes || !(rows == 16 || rows == 32 || rows == 64))
    return false;
  const int umax = (h + cluster - 1) / cluster;
  const int warps = wide_warps(h, rows);
  const int blocks = rows >= 32 ? warps / 2 : rows / 8;
  return umax <= kMaxUnits && wide_groups(umax) * blocks <= warps;
}

template <int R, int W, bool kResiduals>
__global__ void __launch_bounds__(WideTiles<R, W>::kThreads, 1)
gru_fwd_wide_kernel(const float* __restrict__ xi, const float* __restrict__ wh,
                    const float* __restrict__ bh, float* __restrict__ h_out,
                    float* __restrict__ hseq, float* __restrict__ gseq,
                    int n_rows, int t_len, int h, int csize) {
  constexpr int NT = WideTiles<R, W>::kNt;
  constexpr int kThreadsR = WideTiles<R, W>::kThreads;
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  {                         // this CTA's lane: its slice of every array
    const long long lane = blockIdx.y;
    const long long nt = (long long)n_rows * t_len;
    xi += lane * nt * h3;
    wh += lane * h * h3;
    bh += lane * h3;
    h_out += lane * n_rows * h;
    if (kResiduals) {
      hseq += lane * nt * h;
      gseq += lane * nt * h3;
    }
  }
  const int rank = blockIdx.x % csize;
  const int cl = blockIdx.x / csize;
  const int clusters = gridDim.x / csize;
  const int tiles = (n_rows + R - 1) / R;
  const int u0 = unit_begin(rank, h, csize);
  const int un = unit_begin(rank + 1, h, csize) - u0;
  const int umax = (h + csize - 1) / csize;
  const int ug = wide_groups(un);
  const int kp = round8(h);
  const int ldw = wide_ldw(umax);
  const int ldh = wide_ldh(R);
  float* w_s = reinterpret_cast<float*>(smem4);   // (kp, ldw): Wh[k][this CTA's columns]
  float* h_s = w_s + kp * ldw;                     // (kp, ldh): h^T of the tile
  // the mbarrier the peers' rows of h^T arrive on, each step
  const unsigned mbar = static_cast<unsigned>(__cvta_generic_to_shared(h_s + kp * ldh));
  float* h_mine = h_s + u0 * ldh;                  // this CTA's units' rows of h^T
  const unsigned bytes_out = un * ldh * sizeof(float);
  const unsigned bytes_in = (h - un) * ldh * sizeof(float);

  const int tid = threadIdx.x;
  {  // stage Wh once: column (3 j + q) 16 + i holds gate q of unit 16 j + i
    const bool vec = h % 4 == 0 && u0 % 4 == 0 && reinterpret_cast<uintptr_t>(wh) % 16 == 0;
    const int chunks = ug * 12;                    // 4-unit chunks of a k row
    for (int idx = tid; idx < kp * chunks; idx += kThreadsR) {
      const int k = idx / chunks;
      const int c = idx - k * chunks;
      const int j = c / 12, q = (c / 4) % 3, i = (c % 4) * 4;
      const int u = j * kWideGroup + i;
      float* dst = w_s + k * ldw + (3 * j + q) * kWideGroup + i;
      const float* src = wh + (long long)k * h3 + q * h + u0 + u;
      if (vec && k < h && u + 3 < un) {
        copy_f32x4(dst, src);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (k < h && u + e < un) copy_f32(dst + e, src + e);
          else dst[e] = 0.0f;
        }
      }
    }
    for (int i = tid; i < (kp - h) * ldh; i += kThreadsR) h_s[h * ldh + i] = 0.0f;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const bool active = warp < ug * WideTiles<R, W>::kBlocks;
  const int j = warp % ug;                         // this warp's unit group
  const int n0 = (warp / ug) * 8 * NT;             // and its first row in a tile
  // this thread's units (e < 2: 16 j + g; else + 8) and their biases
  int unit[2];
  bool uon[2];
  float bias[2][3];
  for (int s = 0; s < 2; ++s) {
    unit[s] = j * kWideGroup + g + 8 * s;
    uon[s] = active && unit[s] < un;
    for (int q = 0; q < 3; ++q) bias[s][q] = uon[s] ? bh[q * h + u0 + unit[s]] : 0.0f;
  }
  if (tid == 0) mbar_init(mbar);
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < kp * ldw; i += kThreadsR) {   // Wh's NaNs as the split keeps them
    const float v = w_s[i];
    if (v != v) w_s[i] = tf32_safe(v);
  }
  cluster_barrier(csize);   // every peer has started, staged, zeroed and made its mbarrier
  unsigned phase = 0;

  const float* wa = w_s + t4 * ldw + 3 * j * kWideGroup + g;
  const float* hb = h_s + t4 * ldh + n0 + g;
  const int kt = kp / 8;
  // element e of n-tile nt: unit unit[e >> 1], tile row n0 + 8 nt + 2 t4 + (e & 1)
  float xv[NT][4][3];       // xi of the coming step
  float hn[NT][4];          // h' of the step: h of the next (the last h at the end)
  for (int k = 0;; ++k) {
    const int tile = wide_tile(cl, k, clusters, tiles);
    if (tile < 0) break;
    const long long row0 = (long long)tile * R;
    const int rows = (int)min((long long)R, (long long)n_rows - row0);
    auto load_x = [&](int t) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n0 + 8 * nt + 2 * t4 + (e & 1);
          const bool on = uon[e >> 1] && r < rows;
          const float* x = xi + ((row0 + r) * t_len + t) * (long long)h3 + u0 + unit[e >> 1];
#pragma unroll
          for (int q = 0; q < 3; ++q) xv[nt][e][q] = on ? __ldg(x + q * h) : 0.0f;
        }
    };
    if (t_len > 0) load_x(0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hn[nt][e] = 0.0f;

    for (int t = 0; t < t_len; ++t) {
      float big[3][NT][4], small[3][NT][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[q][nt][e] = small[q][nt][e] = 0.0f;
      float hp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hp[nt][e] = hn[nt][e];
      if (t > 0) {          // h = 0 before the first step: g = b there
        if (active) {
#pragma unroll 4
          for (int ks = 0; ks < kt; ++ks) {
            const float* w = wa + ks * 8 * ldw;
            const float* hh = hb + ks * 8 * ldh;
            unsigned bhi[NT][2], blo[NT][2];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              split_tf32_fast(hh[nt * 8], bhi[nt][0], blo[nt][0]);
              split_tf32_fast(hh[nt * 8 + 4 * ldh], bhi[nt][1], blo[nt][1]);
            }
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              unsigned ahi[4], alo[4];
              const float* a = w + q * kWideGroup;
              split_tf32_fast(a[0], ahi[0], alo[0]);
              split_tf32_fast(a[8], ahi[1], alo[1]);
              split_tf32_fast(a[4 * ldw], ahi[2], alo[2]);
              split_tf32_fast(a[4 * ldw + 8], ahi[3], alo[3]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                mma_tf32(small[q][nt], alo, bhi[nt][0], bhi[nt][1]);
                mma_tf32(small[q][nt], ahi, blo[nt][0], blo[nt][1]);
                mma_tf32(big[q][nt], ahi, bhi[nt][0], bhi[nt][1]);
              }
            }
          }
        }
        cluster_arrive();   // this CTA has read h: peers may overwrite it
      }
      // the gates, on the accumulators (overlapping the barrier)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = e >> 1;
          const float gr = (big[0][nt][e] + small[0][nt][e]) + bias[s][0];
          const float gz = (big[1][nt][e] + small[1][nt][e]) + bias[s][1];
          const float gn = (big[2][nt][e] + small[2][nt][e]) + bias[s][2];
          const float rg = sigmoid_f(xv[nt][e][0] + gr);
          const float zg = sigmoid_f(xv[nt][e][1] + gz);
          const float ng = tanhf(xv[nt][e][2] + rg * gn);
          hn[nt][e] = (1.0f - zg) * ng + zg * hp[nt][e];
          const int r = n0 + 8 * nt + 2 * t4 + (e & 1);
          if (kResiduals && uon[s] && r < rows) {
            const long long at = (row0 + r) * t_len + t;
            const int c = u0 + unit[s];
            hseq[at * h + c] = hp[nt][e];
            float* gp = gseq + at * h3;
            gp[c] = gr;
            gp[h + c] = gz;
            gp[2 * h + c] = gn;
          }
        }
      if (t + 1 < t_len) load_x(t + 1);
      if (t > 0) cluster_wait();   // every CTA has read h
      if (t + 1 < t_len) {   // h' into this CTA's rows, those rows to every peer
        if (active) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int s = 0; s < 2; ++s)
              if (uon[s])
                *reinterpret_cast<float2*>(h_s + (u0 + unit[s]) * ldh + n0 + 8 * nt +
                                           2 * t4) = make_float2(tf32_safe(hn[nt][2 * s]),
                                                                 tf32_safe(hn[nt][2 * s + 1]));
        }
        fence_proxy_async();
        __syncthreads();
        if (tid == 0) {
          mbar_expect(mbar, bytes_in);
          for (int q = 1; q < csize; ++q)
            bulk_copy_to(h_mine, bytes_out, (rank + q) % csize, mbar);
        }
        mbar_wait(mbar, phase);
        phase ^= 1;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = n0 + 8 * nt + 2 * t4 + (e & 1);
        if (uon[e >> 1] && r < rows) h_out[(row0 + r) * h + u0 + unit[e >> 1]] = hn[nt][e];
      }
  }
  cluster_barrier(csize);   // no CTA exits while a peer may still copy from or into it
}

template <int R, int W, bool kResiduals>
int wide_launch_clusters(int n_rows, int h, int cluster, int lanes) {
  const int smem = (int)sizeof(float) * wide_smem_floats(h, R, (h + cluster - 1) / cluster);
  const int resident = resident_clusters(gru_fwd_wide_kernel<R, W, kResiduals>,
                                         WideTiles<R, W>::kThreads, cluster, smem);
  if (resident <= 0) return 0;
  return wide_clusters((n_rows + R - 1) / R, lanes, resident);
}

template <int R, int W, bool kResiduals>
int launch_wide(const float* xi, const float* wh, const float* bh, float* h_out,
                float* hseq, float* gseq, int n_rows, int t_len, int h, int cluster,
                int lanes, cudaStream_t stream) {
  const int smem = (int)sizeof(float) * wide_smem_floats(h, R, (h + cluster - 1) / cluster);
  const int clusters = wide_launch_clusters<R, W, kResiduals>(n_rows, h, cluster, lanes);
  if (clusters <= 0) return (int)cudaErrorInvalidConfiguration;
  return launch_clustered_threads(gru_fwd_wide_kernel<R, W, kResiduals>,
                                  WideTiles<R, W>::kThreads, clusters * cluster, lanes,
                                  cluster, smem, stream, xi, wh, bh, h_out, hseq, gseq,
                                  n_rows, t_len, h, cluster);
}

// The wide forward at a checked shape: `count` only counts the clusters it
// would launch (`gru_fwd_clusters`), else it launches.
template <bool kResiduals>
int wide_dispatch(bool count, const float* xi, const float* wh, const float* bh,
                  float* h_out, float* hseq, float* gseq, int n_rows, int t_len, int h,
                  int rows, int cluster, int lanes, cudaStream_t st) {
#define GRU_WIDE(R, W)                                                                   \
  return count ? wide_launch_clusters<R, W, kResiduals>(n_rows, h, cluster, lanes)        \
               : launch_wide<R, W, kResiduals>(xi, wh, bh, h_out, hseq, gseq, n_rows,    \
                                               t_len, h, cluster, lanes, st)
  switch (rows) {
    case 16: GRU_WIDE(16, 8);
    case 32: GRU_WIDE(32, 4);
    default:
      if (wide_warps(h, 64) == 4) GRU_WIDE(64, 4);
      GRU_WIDE(64, 8);
  }
#undef GRU_WIDE
}

template <int R>
int launch_rows(const float* xi, const float* wh, const float* bh, float* h_out,
                float* hseq, float* gseq, int n_rows, int t_len, int h,
                int cluster, int lanes, cudaStream_t st) {
  return hseq != nullptr
             ? launch<R, true>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h, cluster,
                               lanes, st)
             : launch<R, false>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h, cluster,
                                lanes, st);
}

}  // namespace

extern "C" int gru_fwd_max_hidden() { return kMaxH; }

// Bytes of dynamic shared memory a gru_fwd launch takes at hidden size h,
// `rows` per tile and `cluster` CTAs (ops/kernels/gru.py `smem_bytes`
// keeps a copy of this layout to pick its launch shapes).
extern "C" int gru_fwd_smem_bytes(int h, int rows, int cluster) {
  const int umax = (h + cluster - 1) / cluster;
  return (int)sizeof(float) * (h > kMaxUnits ? wide_smem_floats(h, rows, umax)
                                             : fwd_smem_floats(h, rows, umax, cluster));
}

// Clusters a gru_fwd launch above H = 64 gives each lane (its CTAs are this
// times `cluster`, times `lanes`); 0 for a shape it refuses or H <= 64.
// The serving and the training variant share their layout and their count.
extern "C" int gru_fwd_clusters(int n_rows, int h, int rows, int cluster, int lanes) {
  if (!valid_wide_shape(h, rows, cluster, lanes) || n_rows <= 0) return 0;
  return wide_dispatch<false>(true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              n_rows, 0, h, rows, cluster, lanes, nullptr);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `hseq` and `gseq` null: the serving variant, which writes only h_out. Else
// the training variant, which also writes hseq (S, N, T, H) and gseq (S, N,
// T, 3H). `rows` (8 or 16; above H = 64 16, 32 or 64) and `cluster` (1, 2,
// 4 or 8, at most 64 units a CTA: `valid_shape`, `valid_wide_shape`) are
// the launch shape;
// `lanes` = S >= 1, the models of the launch (1: one model, the shapes above
// without their S).
extern "C" int gru_fwd(const float* xi, const float* wh, const float* bh,
                       float* h_out, float* hseq, float* gseq, int n_rows,
                       int t_len, int h, int rows, int cluster, int lanes, void* stream) {
  const bool wide = h > kMaxUnits;
  if (!(wide ? valid_wide_shape(h, rows, cluster, lanes) : valid_shape(h, rows, cluster, lanes))
      || t_len < 0 || (hseq == nullptr) != (gseq == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide) {
    return hseq != nullptr
               ? wide_dispatch<true>(false, xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                     rows, cluster, lanes, st)
               : wide_dispatch<false>(false, xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                      rows, cluster, lanes, st);
  }
  return rows == 8 ? launch_rows<8>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                    cluster, lanes, st)
                   : launch_rows<16>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                     cluster, lanes, st);
}
