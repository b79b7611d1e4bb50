// GRU recurrence backward (K2, and K3's T > 24 case) for Hopper, f32
// accuracy (the walk's product on the tensor cores).
//
// Replaces the Pallas TPU kernels `_bwd_kernel` (launched by `_bwd_full`,
// T <= 24) and `_bwd_seg_kernel` (launched by `_bwd_segmented`, T > 24) of
// factorvae_tpu/ops/pallas/gru.py. Both compute the same function: given the
// forward's inputs xi (N, T, 3H), Wh (H, 3H), b (3H) and the cotangent dh
// (N, H) of the last hidden state, they return dxi (N, T, 3H), dWh (H, 3H)
// and db (3H) through the hand-derived gate VJP of `_backward_walk` (gates
// [r | z | n]):
//
//   dz = dh (h_prev - n)      dn = dh (1 - z)       dtanh = dn (1 - n^2)
//   dr = dtanh g_n            dg_n = dtanh r
//   dg_r = dr r (1 - r)       dg_z = dz z (1 - z)
//   dxi_t = [dg_r | dg_z | dtanh]      dg = [dg_r | dg_z | dg_n]
//   dh_prev = dh z + dg . Wh^T     dWh = sum h_prev^T . dg     db = sum dg
//
// The TPU code splits T <= 24 from T > 24 only because the backward's
// (T, rows, H) blocks had to fit VMEM; none of that is a fact of this card,
// so one path serves every T. It does not re-run the recurrence: it reads
// the residuals that K1's training variant (gru_fwd.cu) wrote, h before
// each step, hseq (N, T, H), and g of each step, gseq (N, T, 3H). Two
// kernels:
//
// 1. The walk, t = T-1 .. 0, keeps one product on its serial chain:
//    dh_prev = dh z + dg . Wh^T. It writes dxi and dg_n (N, T, H), the one
//    block where dg differs from dxi. Its tile and cluster split are the
//    forward's (gru_common.cuh): CTA `rank` owns H/c hidden units, computes
//    their gate VJP, stores its three columns of dg into every CTA's shared
//    memory, and after one cluster barrier computes dh_prev for its units
//    from the full dg and its rows of Wh, on the tensor cores (3xTF32, as in
//    the forward: its units are the M side, the tile's rows the n8 side).
//    xi, g and h_prev of step t-1 are copied into shared memory with
//    cp.async between the arrive and the wait of step t's barrier.
// 2. dWh = hseq^T . dg and db = sum dg over all N*T rows, after the walk,
//    off the serial chain: (H x N*T) . (N*T x 3H). Each of at most 132
//    blocks takes a contiguous range of rows, stages 32 rows at a time in
//    shared memory with cp.async and keeps a 4 x 12 tile of dWh per thread
//    in registers; it writes its partial to its own slot, and a second
//    kernel sums the slots in block order. Deterministic, no atomics.
//
// Above H = 64 both are kernels of their own ("The wide walk" and "dWh on
// the tensor cores" below). The layout above, which the walk used up to
// H = 256 before them (8-row tiles over clusters of 8), kept every CTA's
// full (R, 3H) dg beside its rows of Wh, so 16-row tiles did not fit a
// block; its 304 short-lived CTAs at one training day restaged Wh with
// 4-byte copies, sent dg to the peers with scalar DSMEM stores and ran a
// K = 3H chain a step; its dWh ran on the CUDA cores.
//
// Bound: the walk is 2*N*T*H*3H FLOPs (dg . Wh^T) against its residual and
// gradient bytes and is held back by the same latency as the forward (T
// dependent steps, a cluster barrier each); the dWh product is another
// 2*N*T*H*3H FLOPs, 0.15 GFLOP at one flagship day (N = 304, T = 20, H =
// 64), 0.0009 ms at f32 accuracy on the tensor cores (3xTF32, 165 TFLOP/s),
// so its 6.3 MB of inputs bound it at 0.0019 ms. At H = 256 each product
// is 2.4 GFLOP at one day, 0.0145 ms at 3xTF32: operations bound both
// there. Why not wgmma: see gru_fwd.cu.
//
// Lanes: a launch carries S models (train/fleet.py), every array with a
// leading lane axis (xi (S, N, T, 3H), Wh (S, H, 3H), dWh (S, H, 3H), ...).
// Every kernel's grid has the lane as its y, so no CTA, cluster or partial
// sum mixes two lanes; dWh's partial slots and their block-order sum are per
// lane, so lane i of an S-lane launch is bitwise a one-lane launch.

#include <cstdint>

#include "gru_common.cuh"

namespace {

using namespace gru;

// ---- the walk ---------------------------------------------------------------

// Shared memory in floats: tiles of `rows`, units of width <= umax. The dg
// and residual buffers are double only for a cluster: peers store into dg,
// and the next step's residuals are staged while the cluster barrier
// completes.
__host__ __device__ __forceinline__ int walk_smem_floats(int h, int rows, int umax,
                                                         int csize) {
  return (csize > 1 ? 2 : 1) * rows * mma_ld(3 * h)   // dg (rows, ldg)
         + round16(umax) * mma_ld(3 * h) // Wh rows of this CTA's units
         + rows * kThreads               // the product's partial sums
         + rows * umax                   // dh z of this CTA's units
         + (csize > 1 ? 2 : 1) * rows * 7 * umax;  // xi, g (3 umax each) and
                                                   // h_prev (umax) of a step
}

// The plan of dg . Wh^T for a CTA that owns `units` hidden units.
__host__ __device__ inline MmaPlan walk_plan(int h, int units) { return mma_plan(units, 3 * h); }

template <int R, bool kAReg>
__global__ void __launch_bounds__(kThreads)
gru_walk_kernel(const float* __restrict__ xi, const float* __restrict__ wh,
                const float* __restrict__ hseq, const float* __restrict__ gseq,
                const float* __restrict__ dh, float* __restrict__ dxi,
                float* __restrict__ dgn, int n_rows, int t_len, int h, int csize) {
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  const int ldg = mma_ld(h3);
  {                         // this CTA's lane: its slice of every array
    const long long lane = blockIdx.y;
    const long long nt = (long long)n_rows * t_len;
    xi += lane * nt * h3;
    wh += lane * h * h3;
    hseq += lane * nt * h;
    gseq += lane * nt * h3;
    dh += lane * n_rows * h;
    dxi += lane * nt * h3;
    dgn += lane * nt * h;
  }
  const int rank = blockIdx.x % csize;
  const int u0 = unit_begin(rank, h, csize);
  const int un = unit_begin(rank + 1, h, csize) - u0;
  const int umax = (h + csize - 1) / csize;
  const int ncol = 3 * un;
  const MmaPlan pl = walk_plan(h, un);
  const int ldp = pl.mt * 16;

  float* smem = reinterpret_cast<float*>(smem4);
  const int nbuf = csize > 1 ? 2 : 1;
  float* dg_buf = smem;                        // nbuf x (R, ldg), cols >= 3H zero
  float* w_s = dg_buf + nbuf * R * ldg;        // (round16(umax), ldg)
  float* p_s = w_s + round16(umax) * ldg;      // (kg, R, ldp)
  float* dhz_s = p_s + R * kThreads;           // (R, un)
  float* s_buf = dhz_s + R * umax;             // nbuf x [xi (R, ncol), g (R, ncol),
                                               //         h_prev (R, un)]

  const int tid = threadIdx.x;
  const long long row0 = (long long)(blockIdx.x / csize) * R;
  const int rows = (int)min((long long)R, (long long)n_rows - row0);
  auto gcol = [&](int jj) { return (jj / un) * h + u0 + jj % un; };

  for (int i = tid; i < nbuf * R * ldg; i += kThreads) dg_buf[i] = 0.0f;
  for (int i = tid; i < pl.mt * 16 * ldg; i += kThreads) {
    const int m = i / ldg;
    const int k = i - m * ldg;
    if (m < un && k < h3) copy_f32(w_s + i, wh + (u0 + m) * h3 + k);
    else w_s[i] = 0.0f;
  }

  const Share st = share(ncol);    // this thread's xi and g copies: one column
  const int st_col = gcol(st.col);
  const Share ew = share(un);      // this thread's gate items (and h_prev copies)
  const int u = ew.col;
  const int c = u0 + u;
  auto step_buf = [&](int t) { return s_buf + (t & (nbuf - 1)) * R * 7 * umax; };
  auto stage = [&](int t) {        // xi, g and h_prev of step t, this CTA's part
    float* x_s = step_buf(t);
    float* g_s = x_s + R * 3 * umax;
    float* hp_s = g_s + R * 3 * umax;
    if (st.on) {
      for (int r = st.first; r < rows; r += st.step) {
        const long long at = ((row0 + r) * t_len + t) * (long long)h3 + st_col;
        copy_f32(x_s + r * ncol + st.col, xi + at);
        copy_f32(g_s + r * ncol + st.col, gseq + at);
      }
    }
    if (ew.on) {
      for (int r = ew.first; r < rows; r += ew.step)
        copy_f32(hp_s + r * un + u, hseq + ((row0 + r) * t_len + t) * (long long)h + c);
    }
  };
  if (t_len > 0) stage(t_len - 1);
  cp_async_wait_all();
  cluster_barrier(csize);   // every peer has started and zeroed its dg
  AFrags fr;
  if (kAReg) load_a_frags(w_s, ldg, pl, fr);

  for (int t = t_len - 1; t >= 0; --t) {
    cp_async_wait_all();
    __syncthreads();        // step t's residuals and step t+1's partials are in
    float* dg_nxt = dg_buf + (t & (nbuf - 1)) * R * ldg;
    const float* x_s = step_buf(t);
    const float* g_s = x_s + R * 3 * umax;
    const float* hp_s = g_s + R * 3 * umax;

    // the gate VJP of this CTA's units: dxi, dg_n, dg to every CTA, dh z
    if (ew.on) {
      for (int r = ew.first; r < rows; r += ew.step) {
        float dhv;
        if (t == t_len - 1) {
          dhv = dh[(row0 + r) * h + c];
        } else {
          float acc = 0.0f;
          for (int s = 0; s < pl.kg; ++s) acc += p_s[(s * R + r) * ldp + u];
          dhv = dhz_s[r * un + u] + acc;
        }
        const float* x = x_s + r * ncol;
        const float* g = g_s + r * ncol;
        const float hprev = hp_s[r * un + u];
        const float rg = sigmoid_f(x[u] + g[u]);
        const float zg = sigmoid_f(x[un + u] + g[un + u]);
        const float gn = g[2 * un + u];
        const float ng = tanhf(x[2 * un + u] + rg * gn);
        const float dz = dhv * (hprev - ng);
        const float dn = dhv * (1.0f - zg);
        const float dtanh = dn * (1.0f - ng * ng);
        const float dr = dtanh * gn;
        const float dghn = dtanh * rg;
        const float dghr = dr * rg * (1.0f - rg);
        const float dghz = dz * zg * (1.0f - zg);
        const long long at = (row0 + r) * t_len + t;
        float* dx = dxi + at * h3;
        dx[c] = dghr;
        dx[h + c] = dghz;
        dx[2 * h + c] = dtanh;
        dgn[at * h + c] = dghn;
        if (t > 0) {
          float* dg = dg_nxt + r * ldg;
          store_cluster(dg + c, dghr, csize);
          store_cluster(dg + h + c, dghz, csize);
          store_cluster(dg + 2 * h + c, dghn, csize);
        }
        dhz_s[r * un + u] = dhv * zg;
      }
    }
    if (t == 0) break;
    if (csize > 1) {         // dg of step t is whole in every CTA after the
      cluster_arrive();      // barrier; step t-1's residuals are staged meanwhile
      stage(t - 1);
      cluster_wait();
    } else {
      __syncthreads();
      stage(t - 1);
    }
    // dg . Wh^T for this CTA's units, into per-k-group partial sums
    mma_product<R / 8, kAReg>(w_s, ldg, fr, dg_nxt, ldg, pl, p_s, ldp);
  }
}

template <int R>
int launch_walk(const float* xi, const float* wh, const float* hseq, const float* gseq,
                const float* dh, float* dxi, float* dgn, int n_rows, int t_len, int h,
                int cluster, int lanes, cudaStream_t stream) {
  const int tiles = (n_rows + R - 1) / R;
  const int smem =
      (int)sizeof(float) * walk_smem_floats(h, R, (h + cluster - 1) / cluster, cluster);
  return launch_clustered(a_in_registers(h, cluster, walk_plan) ? gru_walk_kernel<R, true>
                                                                : gru_walk_kernel<R, false>,
                          tiles * cluster, lanes, cluster, smem, stream, xi, wh, hseq, gseq,
                          dh, dxi, dgn, n_rows, t_len, h, cluster);
}

// ---- The wide walk (64 < H <= 256) ------------------------------------------
//
// Persistent clusters of c CTAs (c = 4 up to H = 128, 8 above: at most
// kWalkUnits units a CTA), as many as the card holds at once, each walking
// the row tiles cl, cl + clusters, ... of its lane (`wide_tile`); each CTA
// stages its slice of Wh once per launch (16-byte copies where aligned).
// The product dh_prev = dh z + dg . Wh^T is split along its sum, not its
// output: CTA `rank` owns units [u0, u0 + un) and their three gate columns
// j, computes their gate VJP and so their dg columns itself, and keeps
// Wh[k][j] for every k and its columns j (the slice K1's wide forward
// keeps). A step's product is then P = Wh[:, j] . dg[:, j]^T, a partial
// dh_prev^T (H x R) over this CTA's columns only, on the tensor cores
// (3xTF32; Wh the m16 side, the tile's rows the n8 side; dg is split into
// its TF32 halves once, where the gate threads write it). P is kept
// transposed, (row, k): after a cluster barrier each CTA reads its units'
// columns of every peer's P with DSMEM loads, a warp's 32 units of a row
// one contiguous 128 bytes (loads of 16 bytes, one unit's rows a lane, ran
// at 4 bytes a cycle), and sums them in rank order, 0 .. c-1, onto dh z: a
// row's dh_prev does not depend on its tile, the cluster that ran it or
// the lanes. No (R, 3H) dg in any CTA, and a step moves (H - un) R floats
// into a CTA where the layout above moved 3 un R (c - 1).
//
// A step: the gates (dh times factors of the step's residuals, loaded and
// computed during the last step: the gate VJP is linear in dh), dxi and
// dg_n to device memory, dg into shared memory; the next step's residual
// loads; the product into registers; the wait of barrier B (every peer has
// read this CTA's last P); P into shared memory; barrier A, the next
// step's factors (sigmoid, tanh) between its arrive and its wait; the
// DSMEM sum; the arrive of B. Both halves of B overlap the next step's
// gates and product. The operands are split with integer ops
// (`split_tf32_fast`): Wh passes through `tf32_safe` once after staging,
// dg where it is written.

constexpr int kWalkWarps = 8;
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkUnits = 32;   // units a CTA owns at most

// The product's k (this CTA's gate columns, padded to 8) is stored permuted
// within each group of 8: column 8 j + i sits at 8 j + 2 i for i < 4 and at
// 8 j + 2 (i - 4) + 1 above, so the two columns t and t + 4 a fragment
// takes are neighbours: one 64-bit load for two of A's registers, and, with
// dg's hi and lo halves interleaved (16 words a group: hi(t), hi(t + 4),
// lo(t), lo(t + 4) at 4 t), one 128-bit load for all four of B's.

// Row strides, in floats: P (row, k) of round16(h) + 4 (4 or 20 mod 32:
// the accumulators' stores fall in distinct banks; a warp's DSMEM loads, 32
// units of one row, are one contiguous 128 bytes); the Wh slice (k,
// permuted column), 8 mod 16 (conflict-free 64-bit fragment loads); dg
// (row, 16 words a group of 8 columns), 16 mod 32 (conflict-free 128-bit
// loads).
__host__ __device__ __forceinline__ int walk_wide_ldp(int h) { return round16(h) + 4; }
__host__ __device__ __forceinline__ int walk_wide_ldw(int umax) {
  return ((round8(3 * umax) + 7) & ~15) + 8;
}
__host__ __device__ __forceinline__ int walk_wide_ldx(int umax) {
  return ((2 * round8(3 * umax) + 15) & ~31) + 16;
}

// Shared memory in floats: P (rows, ldp), the Wh slice (round16(h), ldw),
// dg's interleaved TF32 halves (rows, ldx) (ops/kernels/gru.py
// `walk_smem_bytes` keeps a copy).
__host__ __device__ __forceinline__ int walk_wide_smem_floats(int h, int rows, int umax) {
  return rows * (walk_wide_ldp(h) + walk_wide_ldx(umax)) + round16(h) * walk_wide_ldw(umax);
}

// The host's check of a wide walk's shape: tiles of 16, 24 or 32 rows,
// clusters of 2 to 8 CTAs of at most kWalkUnits units each.
inline bool valid_walk_wide_shape(int h, int rows, int cluster, int lanes) {
  return h > kMaxUnits && h <= kMaxH && (rows == 16 || rows == 24 || rows == 32) &&
         cluster >= 2 && cluster <= kMaxCluster && (h + cluster - 1) / cluster <= kWalkUnits &&
         lanes >= 1 && lanes <= kMaxLanes;
}

// R rows a tile (n8 tiles NT = R / 8), MT m16 tiles of Wh's k a warp.
template <int R, int MT>
__global__ void __launch_bounds__(kWalkThreads, 1)
gru_walk_wide_kernel(const float* __restrict__ xi, const float* __restrict__ wh,
                     const float* __restrict__ hseq, const float* __restrict__ gseq,
                     const float* __restrict__ dh, float* __restrict__ dxi,
                     float* __restrict__ dgn, int n_rows, int t_len, int h, int csize) {
  constexpr int NT = R / 8;
  constexpr int NQ = R / 4;          // quads of rows: a gate thread's rows
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  {                         // this CTA's lane: its slice of every array
    const long long lane = blockIdx.y;
    const long long nt = (long long)n_rows * t_len;
    xi += lane * nt * h3;
    wh += lane * h * h3;
    hseq += lane * nt * h;
    gseq += lane * nt * h3;
    dh += lane * n_rows * h;
    dxi += lane * nt * h3;
    dgn += lane * nt * h;
  }
  const int rank = blockIdx.x % csize;
  const int cl = blockIdx.x / csize;
  const int clusters = gridDim.x / csize;
  const int tiles = (n_rows + R - 1) / R;
  const int u0 = unit_begin(rank, h, csize);
  const int un = unit_begin(rank + 1, h, csize) - u0;
  const int umax = (h + csize - 1) / csize;
  const int ldp = walk_wide_ldp(h);
  const int ldw = walk_wide_ldw(umax);
  const int ldx = walk_wide_ldx(umax);
  const int hp = round16(h);
  const int mt = hp / 16;                 // m16 tiles of k
  const int kt = round8(3 * un) / 8;      // k8 steps of this CTA's columns

  float* p_s = reinterpret_cast<float*>(smem4);   // (R, ldp): P^T, at one offset in every CTA
  float* w_s = p_s + R * ldp;                     // (hp, ldw): Wh[k][walk_perm(q un + u)]
  unsigned* dgx = reinterpret_cast<unsigned*>(w_s + hp * ldw);   // (R, ldx): dg's halves

  const int tid = threadIdx.x;
  {  // stage Wh once: column q un + u holds gate q of unit u0 + u; zero beyond
    const bool vec = un % 4 == 0 && u0 % 4 == 0 && h % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(wh) % 16 == 0;
    const int c4 = ldw / 4;
    for (int i = tid; i < hp * c4; i += kWalkThreads) {
      const int k = i / c4;
      const int col = (i - k * c4) * 4;
      float* dst = w_s + k * ldw + col;
      if (vec) {
        if (k < h && col < 3 * un)
          copy_f32x4(dst, wh + (long long)k * h3 + (col / un) * h + u0 + col % un);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        continue;
      }
      for (int e = 0; e < 4; ++e) {
        const int cc = col + e;
        if (k < h && cc < 3 * un)
          copy_f32(dst + e, wh + (long long)k * h3 + (cc / un) * h + u0 + cc % un);
        else
          dst[e] = 0.0f;
      }
    }
    for (int i = tid; i < R * ldx; i += kWalkThreads) dgx[i] = 0u;
  }
  cp_async_wait_all();
  __syncthreads();
  // each group of 8 columns permuted in place (`walk_perm`), its NaNs as
  // the split keeps them
  for (int i = tid; i < hp * (ldw / 8); i += kWalkThreads) {
    float* grp = w_s + (i / (ldw / 8)) * ldw + (i % (ldw / 8)) * 8;
    const float4 lo = *reinterpret_cast<const float4*>(grp);
    const float4 hi = *reinterpret_cast<const float4*>(grp + 4);
    *reinterpret_cast<float4*>(grp) =
        make_float4(tf32_safe(lo.x), tf32_safe(hi.x), tf32_safe(lo.y), tf32_safe(hi.y));
    *reinterpret_cast<float4*>(grp + 4) =
        make_float4(tf32_safe(lo.z), tf32_safe(hi.z), tf32_safe(lo.w), tf32_safe(hi.w));
  }
  __syncthreads();
  cluster_arrive();         // B: no peer reads this CTA's P before its first step

  // the gate items: unit u0 + u of rows 4 qd .. 4 qd + 3 of a tile
  const int u = tid % un;
  const int qd = tid / un;
  const bool on = qd < NQ;
  const int c = u0 + u;
  // the product: m16 tiles warp, warp + 8, ... of k, every n8 tile of rows
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;

  for (int k = 0;; ++k) {
    const int tile = wide_tile(cl, k, clusters, tiles);
    if (tile < 0) break;
    const long long row0 = (long long)tile * R;
    const int rows = (int)min((long long)R, (long long)n_rows - row0);
    float dhv[4], dhz[4], xv[4][3], gv[4][3], hv[4];
    // the gate VJP is linear in dh: per item, the factors that give dg_r,
    // dg_z, dtanh (dxi_n), dg_n and dh z from dh, computed from the step's
    // residuals off the serial chain (while barrier A completes)
    float fr[4], fz[4], ft[4], fn[4], fh[4];
    auto load_step = [&](int t) {         // this thread's residuals of step t
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = on && 4 * qd + e < rows;
        const long long at = (row0 + 4 * qd + e) * t_len + t;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          xv[e][q] = ok ? __ldg(xi + at * h3 + q * h + c) : 0.0f;
          gv[e][q] = ok ? __ldg(gseq + at * h3 + q * h + c) : 0.0f;
        }
        hv[e] = ok ? __ldg(hseq + at * h + c) : 0.0f;
      }
    };
    auto factors = [&]() {                // of the residuals in xv, gv, hv
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rg = sigmoid_f(xv[e][0] + gv[e][0]);
        const float zg = sigmoid_f(xv[e][1] + gv[e][1]);
        const float gn = gv[e][2];
        const float ng = tanhf(xv[e][2] + rg * gn);
        ft[e] = (1.0f - zg) * (1.0f - ng * ng);
        fn[e] = ft[e] * rg;
        fr[e] = ft[e] * gn * rg * (1.0f - rg);
        fz[e] = (hv[e] - ng) * zg * (1.0f - zg);
        fh[e] = zg;
      }
    };
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = on && 4 * qd + e < rows;
      dhv[e] = ok ? dh[(row0 + 4 * qd + e) * h + c] : 0.0f;
    }
    load_step(t_len - 1);
    factors();

    for (int t = t_len - 1;; --t) {
      // the gate VJP of this thread's items: dxi, dg_n, dg's halves, dh z
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * qd + e;
        const bool ok = on && r < rows;
        const float dtanh = dhv[e] * ft[e];
        const float dghn = dhv[e] * fn[e];
        const float dghr = dhv[e] * fr[e];
        const float dghz = dhv[e] * fz[e];
        if (ok) {
          const long long at = (row0 + r) * t_len + t;
          float* dx = dxi + at * h3;
          dx[c] = dghr;
          dx[h + c] = dghz;
          dx[2 * h + c] = dtanh;
          dgn[at * h + c] = dghn;
        }
        if (on && t > 0) {
          const float dg[3] = {dghr, dghz, dghn};
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            unsigned hi, lo;
            split_tf32_fast(tf32_safe(ok ? dg[q] : 0.0f), hi, lo);
            const int col = q * un + u;
            unsigned* x = dgx + r * ldx + 2 * (col & ~7) + 4 * (col & 3) + ((col >> 2) & 1);
            x[0] = hi;
            x[2] = lo;
          }
        }
        dhz[e] = dhv[e] * fh[e];
      }
      if (t == 0) break;
      load_step(t - 1);
      __syncthreads();      // dg is whole

      // P = Wh[:, this CTA's columns] . dg^T, into registers
      float big[MT][NT][4], small[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) big[i][nt][e] = small[i][nt][e] = 0.0f;
#pragma unroll 4
      for (int ks = 0; ks < kt; ++ks) {
        uint4 b[NT];        // hi(t), hi(t + 4), lo(t), lo(t + 4) of row 8 nt + g
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          b[nt] = *reinterpret_cast<const uint4*>(dgx + (nt * 8 + g) * ldx + ks * 16 + 4 * t4);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mtile = warp + kWalkWarps * i;
          if (mtile >= mt) continue;
          const float* a = w_s + (mtile * 16 + g) * ldw + ks * 8 + 2 * t4;
          const float2 a02 = *reinterpret_cast<const float2*>(a);
          const float2 a13 = *reinterpret_cast<const float2*>(a + 8 * ldw);
          unsigned ahi[4], alo[4];
          split_tf32_fast(a02.x, ahi[0], alo[0]);
          split_tf32_fast(a13.x, ahi[1], alo[1]);
          split_tf32_fast(a02.y, ahi[2], alo[2]);
          split_tf32_fast(a13.y, ahi[3], alo[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_tf32(small[i][nt], alo, b[nt].x, b[nt].y);
            mma_tf32(small[i][nt], ahi, b[nt].z, b[nt].w);
            mma_tf32(big[i][nt], ahi, b[nt].x, b[nt].y);
          }
        }
      }
      cluster_wait();       // B: every peer has read this CTA's last P
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mtile = warp + kWalkWarps * i;
        if (mtile >= mt) continue;
        float* p = p_s + 2 * t4 * ldp + mtile * 16 + g;   // C[k][row] at P^T[row][k]
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* pn = p + nt * 8 * ldp;
          pn[0] = big[i][nt][0] + small[i][nt][0];
          pn[ldp] = big[i][nt][1] + small[i][nt][1];
          pn[8] = big[i][nt][2] + small[i][nt][2];
          pn[ldp + 8] = big[i][nt][3] + small[i][nt][3];
        }
      }
      cluster_arrive();     // A: every P is whole after the wait
      factors();            // step t-1's, its residuals loaded during the product
      cluster_wait();
      if (on) {             // dh_prev of this thread's items: dh z + the ranks' P in order
        float v[kMaxCluster][4];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q)   // every load in flight at once
          if (q < csize) {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[q][e] = load_cluster(p_s + (4 * qd + e) * ldp + c, q);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float acc = v[0][e];
#pragma unroll
          for (int q = 1; q < kMaxCluster; ++q)
            if (q < csize) acc += v[q][e];
          dhv[e] = dhz[e] + acc;
        }
      }
      cluster_arrive();     // B: this CTA has read its peers' P
    }
  }
  cluster_wait();   // B: no CTA exits while a peer may still read its P
}

template <int R, int MT>
int walk_wide_smem(int h, int cluster) {
  return (int)sizeof(float) * walk_wide_smem_floats(h, R, (h + cluster - 1) / cluster);
}

// The wide walk at a checked shape: `count` only counts the clusters it
// would give each lane (`gru_walk_clusters`), else it launches.
template <int R, int MT>
int walk_wide_run(bool count, const float* xi, const float* wh, const float* hseq,
                  const float* gseq, const float* dh, float* dxi, float* dgn, int n_rows,
                  int t_len, int h, int cluster, int lanes, cudaStream_t stream) {
  const int smem = walk_wide_smem<R, MT>(h, cluster);
  const int resident =
      resident_clusters(gru_walk_wide_kernel<R, MT>, kWalkThreads, cluster, smem);
  if (resident <= 0) return count ? 0 : (int)cudaErrorInvalidConfiguration;
  const int clusters = wide_clusters((n_rows + R - 1) / R, lanes, resident);
  if (count) return clusters;
  return launch_clustered_threads(gru_walk_wide_kernel<R, MT>, kWalkThreads,
                                  clusters * cluster, lanes, cluster, smem, stream, xi, wh,
                                  hseq, gseq, dh, dxi, dgn, n_rows, t_len, h, cluster);
}

int walk_wide_dispatch(bool count, const float* xi, const float* wh, const float* hseq,
                       const float* gseq, const float* dh, float* dxi, float* dgn,
                       int n_rows, int t_len, int h, int rows, int cluster, int lanes,
                       cudaStream_t st) {
  const bool two = round16(h) / 16 > kWalkWarps;   // two m16 tiles a warp above H = 128
#define GRU_WALK_WIDE(R, MT)                                                              \
  return walk_wide_run<R, MT>(count, xi, wh, hseq, gseq, dh, dxi, dgn, n_rows, t_len, h, \
                              cluster, lanes, st)
  if (rows == 16) {
    if (two) GRU_WALK_WIDE(16, 2);
    GRU_WALK_WIDE(16, 1);
  }
  if (rows == 24) {
    if (two) GRU_WALK_WIDE(24, 2);
    GRU_WALK_WIDE(24, 1);
  }
  if (two) GRU_WALK_WIDE(32, 2);
  GRU_WALK_WIDE(32, 1);
#undef GRU_WALK_WIDE
}

// ---- dWh and db -------------------------------------------------------------

constexpr int kDwThreads = 256;
constexpr int kDwRows = 32;        // rows staged in shared memory per pass
constexpr int kDwMaxBlocks = 132;  // one per SM
constexpr int kDwTileH = 64;       // a block's tile of dWh: kDwTileH rows (of H)
constexpr int kDwTileJ = 192;      // x kDwTileJ columns (of 3H)

// Tiles of dWh a block's rows feed: one up to H = 64 (this kernel), 16 at
// H = 256 (the tensor-core kernel below, whose tile is the same 64 x 192).
int dwh_tiles(int h) {
  return ((h + kDwTileH - 1) / kDwTileH) * ((3 * h + kDwTileJ - 1) / kDwTileJ);
}

// Row blocks: one per 32 rows, at most one per SM over all the tiles
// (so 132 up to H = 64, and 8 at H = 256, which keeps the partial slots,
// one full (dWh, db) per row block, at a few MB).
long long dwh_blocks(long long m_rows, int h) {
  const long long b = (m_rows + kDwRows - 1) / kDwRows;
  const long long cap = kDwMaxBlocks / dwh_tiles(h) > 0 ? kDwMaxBlocks / dwh_tiles(h) : 1;
  return b < cap ? b : cap;
}

// Up to H = 64. Thread (kq, jq) = (tid / 16, tid % 16) owns dWh[4 kq + a,
// jq + 16 c] for a < 4, c < 12 and, for kq = 0, db[jq + 16 c].
__global__ void __launch_bounds__(kDwThreads)
gru_dwh_kernel(const float* __restrict__ hseq, const float* __restrict__ dxi,
               const float* __restrict__ dgn, float* __restrict__ part,
               long long m_rows, long long rows_per_block, int h) {
  __shared__ float4 hs4[kDwRows * kDwTileH / 4];
  __shared__ float ds[kDwRows * kDwTileJ];
  float* hs = reinterpret_cast<float*>(hs4);
  const int h3 = 3 * h;
  const int tid = threadIdx.x;
  const int kq = tid / 16;
  const int jq = tid % 16;
  {                         // this block's lane: its rows and its slots
    const long long lane = blockIdx.y;
    hseq += lane * m_rows * h;
    dxi += lane * m_rows * h3;
    dgn += lane * m_rows * h;
    part += (lane * gridDim.x) * (long long)(h * h3 + h3);
  }
  float acc[4][12];
  float dbacc[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    dbacc[c] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][c] = 0.0f;
  }
  const long long m0 = (long long)blockIdx.x * rows_per_block;
  const long long m1 = min(m_rows, m0 + rows_per_block);
  for (long long c0 = m0; c0 < m1; c0 += kDwRows) {
    const int nr = (int)min((long long)kDwRows, m1 - c0);
    __syncthreads();        // the last pass has read its rows
    for (int i = tid; i < kDwRows * kDwTileH; i += kDwThreads) {
      const int r = i / kDwTileH;
      const int k = i - r * kDwTileH;
      if (r < nr && k < h) copy_f32(hs + i, hseq + (c0 + r) * h + k);
      else hs[i] = 0.0f;
    }
    for (int i = tid; i < kDwRows * kDwTileJ; i += kDwThreads) {
      const int r = i / kDwTileJ;
      const int j = i - r * kDwTileJ;
      if (r < nr && j < 2 * h) copy_f32(ds + i, dxi + (c0 + r) * h3 + j);
      else if (r < nr && j < h3) copy_f32(ds + i, dgn + (c0 + r) * h + j - 2 * h);
      else ds[i] = 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float4 hv = hs4[r * (kDwTileH / 4) + kq];
      const float* d = ds + r * kDwTileJ + jq;
#pragma unroll
      for (int c = 0; c < 12; ++c) {
        const float dv = d[16 * c];
        acc[0][c] = fmaf(hv.x, dv, acc[0][c]);
        acc[1][c] = fmaf(hv.y, dv, acc[1][c]);
        acc[2][c] = fmaf(hv.z, dv, acc[2][c]);
        acc[3][c] = fmaf(hv.w, dv, acc[3][c]);
      }
      if (kq == 0) {
#pragma unroll
        for (int c = 0; c < 12; ++c) dbacc[c] += d[16 * c];
      }
    }
  }
  float* slot = part + (size_t)blockIdx.x * (h * h3 + h3);
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const int j = jq + 16 * c;
    if (j >= h3) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (4 * kq + a < h) slot[(4 * kq + a) * h3 + j] = acc[a][c];
    if (kq == 0) slot[h * h3 + j] = dbacc[c];
  }
}

// Sum the blocks' partial (dWh, db) slots in block order, one thread per
// output (neighbouring threads read neighbouring floats of a slot); the
// grid's y is the lane.
__global__ void gru_dwh_reduce_kernel(const float* __restrict__ part, int blocks,
                                      int h, float* __restrict__ dwh,
                                      float* __restrict__ db) {
  const int h3 = 3 * h;
  const int len = h * h3 + h3;
  part += (size_t)blockIdx.y * blocks * len;
  dwh += (size_t)blockIdx.y * h * h3;
  db += (size_t)blockIdx.y * h3;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * len + e];
  if (e < h * h3) dwh[e] = s;
  else db[e - h * h3] = s;
}


// ---- dWh on the tensor cores (64 < H <= 256) ----------------------------------
//
// The same split as above (row blocks of `dwh_blocks`, one 64 x 192 tile of
// dWh a block, the grid's z; per-block partial slots summed in block order
// by gru_dwh_reduce_kernel), the product on mma.sync m16n8k8 at 3xTF32:
// dWh's rows (H) the m16 side, its columns (3H) the n8 side, the data rows
// the k8 side. 32 rows are staged a pass (16-byte cp.async where aligned,
// double buffered); warp w owns a 32 x 48 block of the tile, 2 x 6 pairs
// of accumulators. Each pass's products (32 rows, four k8 steps) start from
// zero and are added to the block's sums on the CUDA cores: the tensor
// cores' own f32 accumulation rounds towards zero, and over the thousands
// of rows of a block (760 at one day, H = 256) its bias reached 1.4e-5 of
// dWh's largest value at eight days. The operands pass through `tf32_safe`
// as they are split (`split_tf32_fast`), so a NaN reaches dWh. db: in the
// tiles of dWh's first rows, thread j < 192 sums column j of the staged
// rows, in order.

constexpr int kDwLdh = kDwTileH + 8;     // row strides of the staged hseq and dg
constexpr int kDwLdd = kDwTileJ + 8;     // (8 mod 32: conflict-free fragments)
constexpr int kDwStage = kDwRows * (kDwLdh + kDwLdd);   // floats of one stage
constexpr int kDwWideSmem = 2 * kDwStage * (int)sizeof(float);

__device__ __forceinline__ void split_safe(float x, unsigned& hi, unsigned& lo) {
  split_tf32_fast(tf32_safe(x), hi, lo);
}

__global__ void __launch_bounds__(kDwThreads, 1)
gru_dwh_wide_kernel(const float* __restrict__ hseq, const float* __restrict__ dxi,
                    const float* __restrict__ dgn, float* __restrict__ part,
                    long long m_rows, long long rows_per_block, int h) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h3 = 3 * h;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % 2, wn = warp / 2;   // this warp's 32 x 48 block of the tile
  const int tiles_j = (h3 + kDwTileJ - 1) / kDwTileJ;
  const int i0 = (blockIdx.z / tiles_j) * kDwTileH;
  const int j0 = (blockIdx.z % tiles_j) * kDwTileJ;
  {                         // this block's lane: its rows and its slots
    const long long lane_i = blockIdx.y;
    hseq += lane_i * m_rows * h;
    dxi += lane_i * m_rows * h3;
    dgn += lane_i * m_rows * h;
    part += (lane_i * gridDim.x) * (long long)(h * h3 + h3);
  }
  const long long m0 = (long long)blockIdx.x * rows_per_block;
  const long long m1 = min(m_rows, m0 + rows_per_block);
  const bool vec = h % 4 == 0 && reinterpret_cast<uintptr_t>(hseq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dxi) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dgn) % 16 == 0;
  auto stage = [&](long long c0, float* hs, float* ds) {   // rows c0 .. c0 + 31
    const int nr = (int)min((long long)kDwRows, m1 - c0);
    for (int i = tid; i < kDwRows * (kDwTileH / 4); i += kDwThreads) {
      const int r = i / (kDwTileH / 4);
      const int k = (i - r * (kDwTileH / 4)) * 4;
      float* dst = hs + r * kDwLdh + k;
      const float* src = hseq + (c0 + r) * h + i0 + k;
      if (vec && r < nr && i0 + k + 3 < h) {
        copy_f32x4(dst, src);
        continue;
      }
      for (int e = 0; e < 4; ++e) {
        if (r < nr && i0 + k + e < h) copy_f32(dst + e, src + e);
        else dst[e] = 0.0f;
      }
    }
    for (int i = tid; i < kDwRows * (kDwTileJ / 4); i += kDwThreads) {
      const int r = i / (kDwTileJ / 4);
      const int j = j0 + (i - r * (kDwTileJ / 4)) * 4;
      float* dst = ds + r * kDwLdd + j - j0;
      // dg = [dxi_r | dxi_z | dg_n]; with h % 4 == 0 no 4 columns straddle 2H
      if (vec && r < nr && j + 3 < h3) {
        copy_f32x4(dst, j < 2 * h ? dxi + (c0 + r) * h3 + j : dgn + (c0 + r) * h + j - 2 * h);
        continue;
      }
      for (int e = 0; e < 4; ++e) {
        const int jj = j + e;
        if (r < nr && jj < 2 * h) copy_f32(dst + e, dxi + (c0 + r) * h3 + jj);
        else if (r < nr && jj < h3) copy_f32(dst + e, dgn + (c0 + r) * h + jj - 2 * h);
        else dst[e] = 0.0f;
      }
    }
  };

  float acc[2][6][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 6; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
  float dbacc = 0.0f;
  const bool db_thread = i0 == 0 && tid < kDwTileJ;

  if (m0 < m1) stage(m0, smem, smem + kDwRows * kDwLdh);
  cp_async_commit();
  int buf = 0;
  for (long long c0 = m0; c0 < m1; c0 += kDwRows) {
    if (c0 + kDwRows < m1) {
      float* nxt = smem + (buf ^ 1) * kDwStage;
      stage(c0 + kDwRows, nxt, nxt + kDwRows * kDwLdh);
    }
    cp_async_commit();
    cp_async_wait_group<1>();   // this pass's rows have landed
    __syncthreads();
    const float* hs = smem + buf * kDwStage;
    const float* ds = hs + kDwRows * kDwLdh;
    float big[2][6][4], small[2][6][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 6; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) big[mi][nj][e] = small[mi][nj][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kDwRows / 8; ++ks) {
      const float* ha = hs + (ks * 8 + t4) * kDwLdh + wm * 32 + g;
      const float* bd = ds + (ks * 8 + t4) * kDwLdd + wn * 48 + g;
      unsigned ahi[2][4], alo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        split_safe(ha[mi * 16], ahi[mi][0], alo[mi][0]);
        split_safe(ha[mi * 16 + 8], ahi[mi][1], alo[mi][1]);
        split_safe(ha[4 * kDwLdh + mi * 16], ahi[mi][2], alo[mi][2]);
        split_safe(ha[4 * kDwLdh + mi * 16 + 8], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 6; ++nj) {
        unsigned bhi0, blo0, bhi1, blo1;
        split_safe(bd[nj * 8], bhi0, blo0);
        split_safe(bd[4 * kDwLdd + nj * 8], bhi1, blo1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(small[mi][nj], alo[mi], bhi0, bhi1);
          mma_tf32(small[mi][nj], ahi[mi], blo0, blo1);
          mma_tf32(big[mi][nj], ahi[mi], bhi0, bhi1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 6; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += big[mi][nj][e] + small[mi][nj][e];
    if (db_thread) {
      const int nr = (int)min((long long)kDwRows, m1 - c0);
      for (int r = 0; r < nr; ++r) dbacc += ds[r * kDwLdd + tid];
    }
    __syncthreads();        // every warp has read this pass's buffer
    buf ^= 1;
  }

  float* slot = part + (size_t)blockIdx.x * (h * h3 + h3);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 6; ++nj) {
      const int i = i0 + wm * 32 + mi * 16 + g;
      const int j = j0 + wn * 48 + nj * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = i + 8 * (e >> 1);
        const int jj = j + (e & 1);
        if (ii < h && jj < h3) slot[ii * h3 + jj] = acc[mi][nj][e];
      }
    }
  if (db_thread && j0 + tid < h3) slot[h * h3 + j0 + tid] = dbacc;
}

}  // namespace

extern "C" int gru_bwd_max_hidden() { return kMaxH; }

// Bytes of dynamic shared memory a gru_walk launch takes, as gru_fwd_smem_bytes:
// up to H = 64 `walk_smem_floats`, above it `walk_wide_smem_floats`
// (ops/kernels/gru.py `walk_smem_bytes` keeps a copy of both).
extern "C" int gru_walk_smem_bytes(int h, int rows, int cluster) {
  const int umax = (h + cluster - 1) / cluster;
  return (int)sizeof(float) * (h > kMaxUnits ? walk_wide_smem_floats(h, rows, umax)
                                             : walk_smem_floats(h, rows, umax, cluster));
}

// Clusters a gru_walk launch above H = 64 gives each lane (its CTAs are this
// times `cluster`, times `lanes`); 0 for a shape it refuses or H <= 64.
extern "C" int gru_walk_clusters(int n_rows, int h, int rows, int cluster, int lanes) {
  if (!valid_walk_wide_shape(h, rows, cluster, lanes) || n_rows <= 0) return 0;
  return walk_wide_dispatch(true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, n_rows, 0, h, rows, cluster, lanes, nullptr);
}

// The walk: dxi (S, N, T, 3H) and dg_n (S, N, T, H) from xi, Wh, the
// residuals hseq and gseq, and dh (S, N, H), for `lanes` = S models.
// Launches on `stream`; returns the cudaError_t (0 = ok). `rows` and
// `cluster` as in gru_fwd up to H = 64 (`valid_shape`); above it the wide
// walk's (`valid_walk_wide_shape`: 16, 24 or 32 rows, at most 32 units a
// CTA).
extern "C" int gru_walk(const float* xi, const float* wh, const float* hseq,
                        const float* gseq, const float* dh, float* dxi, float* dgn,
                        int n_rows, int t_len, int h, int rows, int cluster, int lanes,
                        void* stream) {
  const bool wide = h > kMaxUnits;
  if (!(wide ? valid_walk_wide_shape(h, rows, cluster, lanes)
             : valid_shape(h, rows, cluster, lanes)) || t_len < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || t_len == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide)
    return walk_wide_dispatch(false, xi, wh, hseq, gseq, dh, dxi, dgn, n_rows, t_len, h,
                              rows, cluster, lanes, st);
  return rows == 8 ? launch_walk<8>(xi, wh, hseq, gseq, dh, dxi, dgn, n_rows, t_len, h,
                                    cluster, lanes, st)
                   : launch_walk<16>(xi, wh, hseq, gseq, dh, dxi, dgn, n_rows, t_len, h,
                                     cluster, lanes, st);
}

// Floats of scratch gru_dwh needs for m_rows = N * T rows of each of `lanes`
// models: one partial (dWh, db) slot per block and lane.
extern "C" long long gru_dwh_scratch_floats(long long m_rows, int h, int lanes) {
  return (long long)lanes * dwh_blocks(m_rows, h) * (3LL * h * h + 3 * h);
}

// dWh (S, H, 3H) = hseq^T . [dxi_r | dxi_z | dg_n] and db (S, 3H) = its
// column sums, over m_rows = N * T rows of each of `lanes` = S models: up
// to H = 64 on the CUDA cores, above it on the tensor cores. Launches on
// `stream`; returns the cudaError_t.
extern "C" int gru_dwh(const float* hseq, const float* dxi, const float* dgn,
                       float* dwh, float* db, float* scratch, long long m_rows,
                       int h, int lanes, void* stream) {
  if (h <= 0 || h > kMaxH || m_rows <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = dwh_blocks(m_rows, h);
  const long long per_block = (m_rows + blocks - 1) / blocks;
  const int tiles = dwh_tiles(h);
  if (tiles == 1) {
    gru_dwh_kernel<<<dim3((unsigned)blocks, lanes), kDwThreads, 0, st>>>(
        hseq, dxi, dgn, scratch, m_rows, per_block, h);
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        gru_dwh_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwWideSmem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    gru_dwh_wide_kernel<<<dim3((unsigned)blocks, lanes, tiles), kDwThreads, kDwWideSmem, st>>>(
        hseq, dxi, dgn, scratch, m_rows, per_block, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * h * h + 3 * h;
  gru_dwh_reduce_kernel<<<dim3((len + 255) / 256, lanes), 256, 0, st>>>(
      scratch, (int)blocks, h, dwh, db);
  return (int)cudaGetLastError();
}
