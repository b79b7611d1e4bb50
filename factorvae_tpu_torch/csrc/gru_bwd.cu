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
//    kernel sums the slots in block order. Deterministic, no atomics. Above
//    H = 64 a block owns one 64 x 192 tile of dWh (the grid's z), and the
//    row blocks are fewer (132 over all the tiles: 8 at H = 256).
//
// Bound: the walk is 2*N*T*H*3H FLOPs (dg . Wh^T) against its residual and
// gradient bytes and is held back by the same latency as the forward (T
// dependent steps, a cluster barrier each); the dWh product is another
// 2*N*T*H*3H FLOPs, 0.15 GFLOP at one flagship day (N = 304, T = 20, H =
// 64), 0.0009 ms at f32 accuracy on the tensor cores (3xTF32, 165 TFLOP/s),
// so its 6.3 MB of inputs bound it at 0.0019 ms. Why not wgmma: see
// gru_fwd.cu.
//
// Lanes: a launch carries S models (train/fleet.py), every array with a
// leading lane axis (xi (S, N, T, 3H), Wh (S, H, 3H), dWh (S, H, 3H), ...).
// Every kernel's grid has the lane as its y, so no CTA, cluster or partial
// sum mixes two lanes; dWh's partial slots and their block-order sum are per
// lane, so lane i of an S-lane launch is bitwise a one-lane launch.

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

// ---- dWh and db -------------------------------------------------------------

constexpr int kDwThreads = 256;
constexpr int kDwRows = 32;        // rows staged in shared memory per pass
constexpr int kDwMaxBlocks = 132;  // one per SM
constexpr int kDwTileH = 64;       // a block's tile of dWh: kDwTileH rows (of H)
constexpr int kDwTileJ = 192;      // x kDwTileJ columns (of 3H)

// Tiles of dWh a block's rows feed: one up to H = 64, 16 at H = 256.
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

// Thread (kq, jq) = (tid / 16, tid % 16) owns dWh[i0 + 4 kq + a, j0 + jq +
// 16 c] for a < 4, c < 12 and, for kq = 0 in the tiles of i0 = 0, db[j0 +
// jq + 16 c]. The tile (i0, j0) is blockIdx.z's (kTiled, H > 64); up to
// H = 64 one tile covers dWh (i0 = j0 = 0): the tuned kernel, unchanged.
template <bool kTiled>
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
  int i0 = 0, j0 = 0;
  if (kTiled) {
    const int tiles_j = (h3 + kDwTileJ - 1) / kDwTileJ;
    i0 = (blockIdx.z / tiles_j) * kDwTileH;
    j0 = (blockIdx.z % tiles_j) * kDwTileJ;
  }
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
      const int k = i - r * kDwTileH + i0;
      if (r < nr && k < h) copy_f32(hs + i, hseq + (c0 + r) * h + k);
      else hs[i] = 0.0f;
    }
    for (int i = tid; i < kDwRows * kDwTileJ; i += kDwThreads) {
      const int r = i / kDwTileJ;
      const int j = i - r * kDwTileJ + j0;
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
    const int j = j0 + jq + 16 * c;
    if (j >= h3) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      if (i0 + 4 * kq + a < h) slot[(i0 + 4 * kq + a) * h3 + j] = acc[a][c];
    if (kq == 0 && i0 == 0) slot[h * h3 + j] = dbacc[c];
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

}  // namespace

extern "C" int gru_bwd_max_hidden() { return kMaxH; }

// Bytes of dynamic shared memory a gru_walk launch takes, as gru_fwd_smem_bytes.
extern "C" int gru_walk_smem_bytes(int h, int rows, int cluster) {
  return (int)sizeof(float) * walk_smem_floats(h, rows, (h + cluster - 1) / cluster, cluster);
}

// The walk: dxi (S, N, T, 3H) and dg_n (S, N, T, H) from xi, Wh, the
// residuals hseq and gseq, and dh (S, N, H), for `lanes` = S models.
// Launches on `stream`; returns the cudaError_t (0 = ok). `rows` and
// `cluster` as in gru_fwd.
extern "C" int gru_walk(const float* xi, const float* wh, const float* hseq,
                        const float* gseq, const float* dh, float* dxi, float* dgn,
                        int n_rows, int t_len, int h, int rows, int cluster, int lanes,
                        void* stream) {
  if (!valid_shape(h, rows, cluster, lanes) || t_len < 0) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0 || t_len == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
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
// column sums, over m_rows = N * T rows of each of `lanes` = S models.
// Launches on `stream`; returns the cudaError_t.
extern "C" int gru_dwh(const float* hseq, const float* dxi, const float* dgn,
                       float* dwh, float* db, float* scratch, long long m_rows,
                       int h, int lanes, void* stream) {
  if (h <= 0 || h > kMaxH || m_rows <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = dwh_blocks(m_rows, h);
  const long long per_block = (m_rows + blocks - 1) / blocks;
  const int tiles = dwh_tiles(h);
  if (tiles == 1)
    gru_dwh_kernel<false><<<dim3((unsigned)blocks, lanes), kDwThreads, 0, st>>>(
        hseq, dxi, dgn, scratch, m_rows, per_block, h);
  else
    gru_dwh_kernel<true><<<dim3((unsigned)blocks, lanes, tiles), kDwThreads, 0, st>>>(
        hseq, dxi, dgn, scratch, m_rows, per_block, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * h * h + 3 * h;
  gru_dwh_reduce_kernel<<<dim3((len + 255) / 256, lanes), 256, 0, st>>>(
      scratch, (int)blocks, h, dwh, db);
  return (int)cudaGetLastError();
}
