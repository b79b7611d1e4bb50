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
// Design (the launch shape comes from the wrapper's rule,
// `ops/kernels/gru.py:launch_shape`):
// - A tile of R = 8 or 16 rows is split over a thread-block cluster of c = 1,
//   2, 4 or 8 CTAs (8 only above H = 64, where a CTA's at most 64 units
//   make H / 64 the least c; gru_common.cuh): CTA `rank` owns H/c hidden
//   units and their three gate
//   columns of Wh, computes that slice of g and of h', and stores its slice
//   of h' into every CTA's shared memory (st.shared::cluster); one cluster
//   barrier per step then gives every CTA the full h for the next product.
//   At one flagship day 8-row tiles x c = 4 make 152 CTAs, where 16-row
//   tiles alone made 19; at the serving chunk 16-row tiles x c = 1 make 608.
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
// Why not wgmma: it takes 64-row tiles, which at one training day would
// leave 5 CTAs for 132 SMs; this is a latency-bound recurrence, not a
// throughput-bound product.

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
  return (int)sizeof(float) * fwd_smem_floats(h, rows, (h + cluster - 1) / cluster, cluster);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `hseq` and `gseq` null: the serving variant, which writes only h_out. Else
// the training variant, which also writes hseq (S, N, T, H) and gseq (S, N,
// T, 3H). `rows` (8 or 16) and `cluster` (1, 2, 4 or 8, at most 64 units a
// CTA: `valid_shape`) are the launch shape;
// `lanes` = S >= 1, the models of the launch (1: one model, the shapes above
// without their S).
extern "C" int gru_fwd(const float* xi, const float* wh, const float* bh,
                       float* h_out, float* hseq, float* gseq, int n_rows,
                       int t_len, int h, int rows, int cluster, int lanes, void* stream) {
  if (!valid_shape(h, rows, cluster, lanes) || t_len < 0 ||
      (hseq == nullptr) != (gseq == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows == 8 ? launch_rows<8>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                    cluster, lanes, st)
                   : launch_rows<16>(xi, wh, bh, h_out, hseq, gseq, n_rows, t_len, h,
                                     cluster, lanes, st);
}
