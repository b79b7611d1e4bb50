// K-head cross-section attention forward (K4) for Hopper, f32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `_head_kernel` of
// factorvae_tpu/ops/pallas/attention.py (`multihead_cross_section_attention`,
// reached through `attention_grad.fused_attention`). The JAX code vmaps the
// single-day kernel over days; this one takes the day axis directly. For
// head k of day b:
//
//   key   = L . Wk[k] + bk[k]               (N, H)
//   s     = key . q[k] / sqrt(H + 1e-6)     (N,)
//   s     = s * keep[b, k]                  (dropout keep-mask, optional) ...
//   s     = relu(s)                         ... applied BEFORE the ReLU
//   bad   = any valid s is non-finite       -> the head's context is zero
//   a     = masked softmax of s over stocks (masked rows: weight 0)
//   ctx   = a . nan_to_num(L . Wv[k] + bv[k])
//
// A fully masked day (denominator 0, as on every -1-padded day of the last
// scoring chunk) gives a zero context, not NaN.
//
// Inputs: latent (B, N, H), mask (B, N) bytes, keep (B, K, N) or null,
// q (K, H), Wk/Wv (K, H, H), bk/bv (K, H). Output: ctx (B, K, H), and, if
// `exact` is not null, exact[b] = 1 for a day that took the exact path.
// A launch carries S lanes, each its own model and its own days
// (train/fleet.py): every array above gains a leading lane axis (latent
// (S, B, N, H), mask (S, B, N), q (S, K, H), ..., ctx (S, B, K, H), exact
// (S, B)). The grid's y is the lane, so a CTA never mixes two lanes, a
// lane's guard and exact path stay in that lane, and lane i is bitwise a
// one-lane launch.
//
// Neither per-row product is needed on a day whose valid latent rows are
// finite: s_n = L_n . u + c with u = Wk . q, c = bk . q, and ctx = (a^T L) .
// Wv + bv . sum(a). A day with a non-finite valid element takes the exact
// path: the key and value rows as written, one head at a time
// (attention_common.cuh), so nan_to_num and the guard keep exactly their
// meaning there; a clean day never takes it.
//
// Up to H = 64 (`attention_fwd_kernel`, the S = 1 and 2 instances): one CTA
// per (day, group of G heads), G from the wrapper's `launch_group` (one head
// per CTA at one training day, 96 CTAs; groups of 8 at a 32-day serving
// chunk, so each day's rows are read twelve times, not 96). The CTA
// compacts the day's valid rows, stages them in shared memory (78 KB at N =
// 304, H = 64; read through the row list from device memory when the
// staged layout does not fit, above N of about 830), checks them for
// non-finite values, forms u and c for its heads, the (n_v x G) scores, the
// masked softmax, P = a^T L (G x H) and ctx = P . Wv + bv sum(a), reading
// Wk[k] and Wv[k] once. Work per valid row and head: about 4H FLOP (the
// score dot and the P sum), against 4H^2 + 3H as the TPU kernel writes it.
// Bound: least work ~4H per valid row and head, 2H^2 per head (u) and per
// (day, head) (ctx): about 0.26 GFLOP at a 32-day flagship chunk (B = 32,
// N = 304, K = 96, H = 64, ~9,100 valid rows) against ~6.5 MB read, so the
// f32 rate bounds it at ~0.0038 ms; at one day the 3.2 MB of Wk and Wv
// bound it at ~0.001 ms (bytes). What keeps the kernel from its bound is
// latency, not work: each CTA runs a chain of phases (compact, stage, u,
// scores, softmax, P, ctx) with a block barrier between, and the phases
// that read device memory load a batch of elements per thread at once
// (clamped addresses, no branch between the loads) so that one round trip,
// not one per element, is paid.
//
// Above H = 64 (`launch_wide`, the S = 4 and 8 instances: "The wide design"
// below and in attention_common.cuh), three kernels on one stream:
//   1. `attention_fwd_prep_kernel`: u and c per (lane, head), once per
//      launch; every head's Wk is read once, not once per day (25 MB at H =
//      256, K = 96, against 0.8 GB at a 32-day chunk when each (day, group)
//      CTA formed its own);
//   2. `attention_fwd_wide_kernel`: a cluster of 2 (H <= 128) or 4 CTAs per
//      (day, group of G heads), G from `wide_launch_group`, each CTA holding
//      a column slice of the day's valid rows: partial scores over its
//      slice, summed in rank order through DSMEM, the softmax, P's slice;
//      it writes P, sum a and each (day, head)'s state to the scratch;
//   3. `attention_fwd_ctx_kernel`: ctx = P . Wv + bv sum(a) for every day of
//      a head at once, a CTA a tile of 32 columns of Wv[k] staged once:
//      each head's Wv is read once per launch.
// Bound at one flagship day of H = 256: the 50 MB of Wk and Wv, ~0.015 ms;
// at a 32-day chunk ~0.02 ms (the f32 rate). What keeps it from there: the
// day clusters read their slices of the day's rows from L2 once per group
// of heads, and each CTA's phases (compact, stage, partial scores, the
// cluster exchange, softmax, P) are a chain of barriers; the prep and
// context kernels stream the weights at a fraction of the card's rate. The
// products stay on the CUDA cores: the context product at a 32-day chunk of
// H = 256 is 0.4 GFLOP, ~0.006 ms at the f32 rate, and the kernel's time is
// in its staging and barriers, not its arithmetic.

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// The exact path for one head: the as-written key and value rows. Up to
// H = 64 (S <= 2) the head's Wk and Wv are staged whole and a lane owns S
// columns; above, they stream through shared memory kChunk columns at a
// time (attention_common.cuh), and the context is formed a chunk at a time.
template <int S>
__device__ void exact_head(const float* lat, const int* idx, int nv, const float* kp,
                           const float* q, const float* wk, const float* bk,
                           const float* wv, const float* bv, int head, int h,
                           float* smem, const Layout& L, float* out_row) {
  const int hp = round4(h);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* wk_s = smem + L.wk;
  float* wv_s = smem + L.wv;
  float* q_s = smem + L.q;
  float* bk_s = smem + L.bk;
  float* bv_s = smem + L.bv;
  float* ctx_s = smem + L.red;
  float* s_s = smem + L.xs;
  float* tile = smem + L.tile + warp * kTile * hp;
  if constexpr (S > 2) {
    const size_t hh = (size_t)h * h;
    __syncthreads();          // the previous head's readers are done
    stage_vectors(q, bk, bv, head, h, hp, q_s, bk_s, bv_s);
    __syncthreads();
    if (!head_softmax_streamed(lat, idx, nv, kp, wk + head * hh, bk_s, q_s, h, hp, wk_s,
                               tile, s_s, s_s)) {
      for (int j = tid; j < h; j += kThreads) out_row[j] = 0.0f;
      return;
    }
    for (int j0 = 0; j0 < h; j0 += kChunk) {
      __syncthreads();        // the last chunk's and ctx_s's readers are done
      stage_chunk(wv + head * hh, j0, h, hp, wv_s);
      __syncthreads();
      const float bj = j0 + lane < h ? bv_s[j0 + lane] : 0.0f;
      float acc = 0.0f;
      for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
        stage_tile(lat, idx, g, nv, h, hp, lane, tile);
        float val[kTile];
        tile_chunk(tile, wv_s, hp, lane, val);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          if (g + t >= nv) break;
          acc = fmaf(s_s[g + t], nan_to_num_f(val[t] + bj), acc);
        }
        __syncwarp();
      }
      ctx_s[warp * kChunk + lane] = acc;
      __syncthreads();
      if (tid < kChunk && j0 + tid < h) {
        float v = 0.0f;
        for (int w = 0; w < kWarps; ++w) v += ctx_s[w * kChunk + tid];
        out_row[j0 + tid] = v;
      }
    }
  } else {
    __syncthreads();            // the previous head's readers are done
    stage_head(q, wk, bk, wv, bv, head, h, hp, q_s, wk_s, bk_s, wv_s, bv_s);
    __syncthreads();
    if (!head_softmax<S>(lat, idx, nv, kp, wk_s, bk_s, q_s, h, hp, tile, s_s, s_s)) {
      for (int j = tid; j < h; j += kThreads) out_row[j] = 0.0f;
      return;
    }
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.0f;
    for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
      stage_tile(lat, idx, g, nv, h, hp, lane, tile);
      float val[kTile][S];
      tile_times<S>(tile, wv_s, bv_s, h, hp, lane, val);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        if (g + t >= nv) break;
        const float a = s_s[g + t];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = fmaf(a, nan_to_num_f(val[t][s]), acc[s]);
      }
      __syncwarp();
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = lane + 32 * s;
      if (j < h) ctx_s[warp * hp + j] = acc[s];
    }
    __syncthreads();
    for (int j = tid; j < h; j += kThreads) {
      float v = 0.0f;
      for (int w = 0; w < kWarps; ++w) v += ctx_s[w * hp + j];
      out_row[j] = v;
    }
  }
}

// ctx[g][j] = P[g] . Wv_g[:, j] + bv_g[j] * sa[g], 0 for a guarded head: i
// cut into slices summed in order, Wv read once, coalesced along j.
__device__ void fold_context(const float* p, const float* __restrict__ wv,
                             const float* __restrict__ bv, const float* sa,
                             const int* ok, int G, int h, float* part, float* out) {
  const int pairs = G * h;
  const int slices = pairs >= kThreads ? 1 : kThreads / pairs;
  const int chunk = (h + slices - 1) / slices;
  for (int t = threadIdx.x; t < pairs * slices; t += kThreads) {
    const int pair = t % pairs;
    const int sl = t / pairs;
    const int g = pair / h;
    const int j = pair - g * h;
    const float* wg = wv + (size_t)g * h * h + j;
    const float* pg = p + g * h;
    const int i1 = min(h, (sl + 1) * chunk);
    float acc = 0.0f;
#pragma unroll 16
    for (int i = sl * chunk; i < i1; ++i) acc = fmaf(pg[i], __ldg(wg + (size_t)i * h), acc);
    if (slices == 1) out[pair] = ok[g] ? acc + bv[pair] * sa[g] : 0.0f;
    else part[t] = acc;
  }
  if (slices > 1) {
    __syncthreads();
    for (int pair = threadIdx.x; pair < pairs; pair += kThreads) {
      const int g = pair / h;
      float acc = 0.0f;
      for (int sl = 0; sl < slices; ++sl) acc += part[sl * pairs + pair];
      out[pair] = ok[g] ? acc + bv[pair] * sa[g] : 0.0f;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ latent,
                     const unsigned char* __restrict__ mask,
                     const float* __restrict__ keep,
                     const float* __restrict__ q,
                     const float* __restrict__ wk,
                     const float* __restrict__ bk,
                     const float* __restrict__ wv,
                     const float* __restrict__ bv,
                     float* __restrict__ out, int* __restrict__ exact,
                     int n, int k_heads, int h, int group, int staged) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(n, h, group, staged, false);
  int* idx = reinterpret_cast<int*>(smem + L.idx);

  const int groups = (k_heads + group - 1) / group;
  {                         // this CTA's lane: its slice of every array
    const size_t lane = blockIdx.y;
    const size_t b_days = gridDim.x / groups;
    const size_t kh = (size_t)k_heads * h;
    latent += lane * b_days * n * h;
    mask += lane * b_days * n;
    if (keep) keep += lane * b_days * k_heads * n;
    q += lane * kh;
    wk += lane * kh * h;
    bk += lane * kh;
    wv += lane * kh * h;
    bv += lane * kh;
    out += lane * b_days * kh;
    if (exact) exact += lane * b_days;
  }
  const int day = blockIdx.x / groups;
  const int grp = blockIdx.x - day * groups;
  const int head0 = grp * group;
  const int gn = min(group, k_heads - head0);
  const size_t bk0 = (size_t)day * k_heads + head0;
  const float* lat = latent + (size_t)day * n * h;
  const float* keep_g = keep ? keep + bk0 * n : nullptr;
  float* out_g = out + bk0 * h;

  const size_t group_bytes = (size_t)gn * h * h * sizeof(float);
  prefetch_l2(wk + (size_t)head0 * h * h, group_bytes);
  prefetch_l2(wv + (size_t)head0 * h * h, group_bytes);
  const int nv = compact_rows(mask + (size_t)day * n, n, idx);
  const bool flagged = stage_rows(lat, idx, nv, h, staged, smem + L.rows);
  if (exact && grp == 0 && threadIdx.x == 0) exact[day] = flagged;

  if (flagged) {               // the exact path, one head at a time
    for (int g = 0; g < gn; ++g)
      exact_head<S>(lat, idx, nv, keep_g ? keep_g + (size_t)g * n : nullptr, q, wk,
                    bk, wv, bv, head0 + g, h, smem, L, out_g + (size_t)g * h);
    return;
  }

  const Rows rows = staged ? Rows{smem + L.rows, idx, row_ld(h), true}
                           : Rows{lat, idx, h, false};
  float* sc = smem + L.sc;
  int* ok = reinterpret_cast<int*>(smem + L.ok);
  head_matvec<(S < 2 ? 2 : S)>(wk + (size_t)head0 * h * h, bk + (size_t)head0 * h,
                               q + (size_t)head0 * h, gn, h, L.gp, smem + L.u, smem + L.c);
  row_dots(rows, nv, h, smem + L.u, smem + L.c, gn, L.gp, sc, L.ldn);
  fold_softmax(sc, sc, L.ldn, smem + L.at, L.gt, nv, idx, keep_g, n, gn,
               sqrtf((float)h + 1e-6f), ok, smem + L.sa);
  column_sums(rows, nv, h, smem + L.at, L.gt, gn, smem + L.part, smem + L.p, h);
  fold_context(smem + L.p, wv + (size_t)head0 * h * h, bv + (size_t)head0 * h,
               smem + L.sa, ok, gn, h, smem + L.part, out_g);
}

// ---------------------------------------------------------------------------
// The wide design (H > 64): three kernels
// ---------------------------------------------------------------------------

// 1. u = Wk q and c = bk q of every (lane, head), once per launch.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ wk,
                          const float* __restrict__ bk, float* __restrict__ u,
                          float* __restrict__ c, int k_heads, int h) {
  const size_t lane = blockIdx.y;
  const size_t kh = (size_t)k_heads * h;
  prep_rows<S>(q + lane * kh, wk + lane * kh * h, bk + lane * kh, nullptr, nullptr, nullptr,
               u + lane * kh, c + lane * k_heads, nullptr, 0, nullptr, 0, k_heads, h);
}

// 2. A cluster of wide_cluster(h) CTAs per (lane, day, group of G heads),
// CTA `rank` holding columns [slice_begin(rank), slice_begin(rank + 1)) of
// the day's valid rows: its partial scores over its slice, the partials
// summed in rank order through DSMEM (every CTA the same scores, so the
// same softmax), then P's slice = a^T L[:, slice] from its own rows. Writes
// P (B, K, H), sum a (B, K) and the state of each (day, head) (B, K): 0
// guarded (a zero context), 1 fold, 2 the exact path (context written here,
// the group's heads dealt to the ranks, each one head at a time).
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_wide_kernel(const float* __restrict__ latent,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ keep,
                          const float* __restrict__ q,
                          const float* __restrict__ wk,
                          const float* __restrict__ bk,
                          const float* __restrict__ wv,
                          const float* __restrict__ bv,
                          const float* __restrict__ u, const float* __restrict__ cu,
                          float* __restrict__ p_out, float* __restrict__ sa_out,
                          int* __restrict__ st_out, float* __restrict__ out,
                          int* __restrict__ exact, int n, int k_heads, int h, int group,
                          int staged) {
  ATTN_PHASE_START
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WideLayout W = wide_layout(n, h, group, staged, false, keep != nullptr);
  int* idx = reinterpret_cast<int*>(smem + W.idx);
  const int cs = wide_cluster(h);
  const int rank = (int)cluster_rank();
  const int groups = (k_heads + group - 1) / group;
  {                         // this CTA's lane: its slice of every array
    const size_t lane = blockIdx.y;
    const size_t b_days = gridDim.x / (groups * cs);
    const size_t kh = (size_t)k_heads * h;
    latent += lane * b_days * n * h;
    mask += lane * b_days * n;
    if (keep) keep += lane * b_days * k_heads * n;
    q += lane * kh;
    wk += lane * kh * h;
    bk += lane * kh;
    wv += lane * kh * h;
    bv += lane * kh;
    u += lane * kh;
    cu += lane * k_heads;
    p_out += lane * b_days * kh;
    sa_out += lane * b_days * k_heads;
    st_out += lane * b_days * k_heads;
    out += lane * b_days * kh;
    if (exact) exact += lane * b_days;
  }
  const int cid = blockIdx.x / cs;
  const int day = cid / groups;
  const int grp = cid - day * groups;
  const int head0 = grp * group;
  const int gn = min(group, k_heads - head0);
  const size_t bk0 = (size_t)day * k_heads + head0;
  const float* lat = latent + (size_t)day * n * h;
  const float* keep_g = keep ? keep + bk0 * n : nullptr;
  const int c0 = slice_begin(rank, h);
  const int cw = slice_begin(rank + 1, h) - c0;

  const int nv = compact_rows(mask + (size_t)day * n, n, idx);
  ATTN_PHASE(0);
  stage_vectors_slice(u, h, cu, head0, gn, W.gp, W.sw, c0, cw, smem + W.v, smem + W.cv);
  const bool bad = stage_slice(lat, idx, nv, h, c0, cw, W.ld, staged, smem + W.rows, keep_g,
                               gn, n, W.ldn, smem + W.kp);
  ATTN_PHASE(1);
  const Rows rows = staged ? Rows{smem + W.rows, idx, W.ld, true}
                           : Rows{lat + c0, idx, h, false};
  slice_dots<false>(rows, nv, cw, smem + W.v, nullptr, gn, W.gp, smem + W.p, nullptr, W.ldn,
                    (h & 3) == 0);
  ATTN_PHASE(2);
  float* flag = smem + W.flag;
  if (threadIdx.x == 0) flag[0] = bad ? 1.0f : 0.0f;
  cluster_arrive();
  cluster_wait();
  bool flagged = false;
  for (int r = 0; r < cs; ++r) flagged |= load_cluster(flag, r) != 0.0f;
  float* sc = smem + W.sc;
  if (!flagged) cluster_sum(smem + W.p, smem + W.cv, sc, nv, gn, W.ldn, cs);
  cluster_arrive();         // every peer has read this CTA's partials and flag
  cluster_wait();
  ATTN_PHASE(3);
  if (exact && grp == 0 && rank == 0 && threadIdx.x == 0) exact[day] = flagged;

  if (flagged) {             // the exact path, the group's heads dealt to the ranks
    const Layout L = layout(n, h, group, false, false);
    for (int g = rank; g < gn; g += cs)
      exact_head<S>(lat, idx, nv, keep_g ? keep_g + (size_t)g * n : nullptr, q, wk, bk, wv,
                    bv, head0 + g, h, smem, L, out + (bk0 + g) * h);
    if (rank == 0)
      for (int g = threadIdx.x; g < gn; g += kThreads) st_out[bk0 + g] = 2;
    return;
  }

  int* ok = reinterpret_cast<int*>(smem + W.ok);
  wide_softmax(sc, sc, W.ldn, nullptr, 0, nv, keep_g ? smem + W.kp : nullptr, gn,
               sqrtf((float)h + 1e-6f), ok, smem + W.sa);
  ATTN_PHASE(4);
  slice_column_sums(rows, nv, cw, sc, 1, W.ldn, gn, smem + W.part, p_out + bk0 * h + c0, h);
  if (rank == 0)
    for (int g = threadIdx.x; g < gn; g += kThreads) {
      sa_out[bk0 + g] = smem[W.sa + g];
      st_out[bk0 + g] = ok[g];
    }
  ATTN_PHASE(5);
}

// 3. ctx[b, k, j] = P[b, k, :] . Wv[k][:, j] + bv[k, j] sum a[b, k] for every
// day of the launch, 0 for a guarded head, the exact path's days left as
// written: one CTA per (lane, head, tile of kCtxCols columns) stages its
// tile of Wv[k] once (16-byte cp.async copies where H is a multiple of 4)
// and takes the days kCtxDays at a time, P transposed so that one i gives a
// thread its days in two float4 reads; a thread a column and one of
// kCtxParts fixed runs of i (each an fmaf chain per day), the runs summed
// in order. Each head's Wv is read once per launch.
__global__ void __launch_bounds__(kThreads)
attention_fwd_ctx_kernel(const float* __restrict__ wv, const float* __restrict__ bv,
                         const float* __restrict__ p, const float* __restrict__ sa,
                         const int* __restrict__ st, float* __restrict__ out, int b_days,
                         int k_heads, int h) {
  static_assert(kCtxDays == 8, "a context thread reads its days as two float4");
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);      // (h, kCtxCols)
  float* p_t = w_s + h * kCtxCols;                   // (h, kCtxDays)
  float* part = p_t + kCtxDays * h;                  // (kCtxParts, kCtxDays, kCtxCols)
  {                         // this CTA's lane
    const size_t lane = blockIdx.y;
    const size_t kh = (size_t)k_heads * h;
    wv += lane * kh * h;
    bv += lane * kh;
    p += lane * b_days * kh;
    sa += lane * b_days * k_heads;
    st += lane * b_days * k_heads;
    out += lane * b_days * kh;
  }
  const int tiles = (h + kCtxCols - 1) / kCtxCols;
  const int head = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - head * tiles) * kCtxCols;
  const float* wh = wv + (size_t)head * h * h;
  if ((h & 3) == 0) {
    constexpr int q4 = kCtxCols / 4;
    for (int e = threadIdx.x; e < h * q4; e += kThreads) {
      const int i = e / q4;
      const int j = (e - i * q4) * 4;
      float* dst = w_s + i * kCtxCols + j;
      if (j0 + j < h) {
        const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(wh + (size_t)i * h + j0 + j) : "memory");
      } else {
        *reinterpret_cast<float4*>(dst) = float4{0.0f, 0.0f, 0.0f, 0.0f};
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int e = threadIdx.x; e < h * kCtxCols; e += kThreads) {
      const int i = e / kCtxCols;
      const int j = j0 + e - i * kCtxCols;
      w_s[e] = j < h ? __ldg(wh + (size_t)i * h + j) : 0.0f;
    }
  }
  const int j = threadIdx.x % kCtxCols;
  const int run = threadIdx.x / kCtxCols;
  const int per = (h + kCtxParts - 1) / kCtxParts;
  const int i0 = min(h, run * per);
  const int i1 = min(h, i0 + per);
  for (int b0 = 0; b0 < b_days; b0 += kCtxDays) {
    const int nb = min(kCtxDays, b_days - b0);
    __syncthreads();        // w_s is staged; the last days' readers are done
    for (int e = threadIdx.x; e < kCtxDays * h; e += kThreads) {
      const int d = e / h;
      const int i = e - d * h;
      p_t[i * kCtxDays + d] = d < nb ? p[((size_t)(b0 + d) * k_heads + head) * h + i] : 0.0f;
    }
    __syncthreads();
    float acc[kCtxDays];
#pragma unroll
    for (int d = 0; d < kCtxDays; ++d) acc[d] = 0.0f;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const float wij = w_s[i * kCtxCols + j];
      const float4 pa = *reinterpret_cast<const float4*>(p_t + i * kCtxDays);
      const float4 pb = *reinterpret_cast<const float4*>(p_t + i * kCtxDays + 4);
      acc[0] = fmaf(pa.x, wij, acc[0]);
      acc[1] = fmaf(pa.y, wij, acc[1]);
      acc[2] = fmaf(pa.z, wij, acc[2]);
      acc[3] = fmaf(pa.w, wij, acc[3]);
      acc[4] = fmaf(pb.x, wij, acc[4]);
      acc[5] = fmaf(pb.y, wij, acc[5]);
      acc[6] = fmaf(pb.z, wij, acc[6]);
      acc[7] = fmaf(pb.w, wij, acc[7]);
    }
#pragma unroll
    for (int d = 0; d < kCtxDays; ++d) part[(run * kCtxDays + d) * kCtxCols + j] = acc[d];
    __syncthreads();
    for (int e = threadIdx.x; e < nb * kCtxCols; e += kThreads) {
      const int d = e / kCtxCols;
      const int jj = e - d * kCtxCols;
      if (j0 + jj >= h) continue;
      const size_t bkr = (size_t)(b0 + d) * k_heads + head;
      const int state = st[bkr];
      if (state == 2) continue;           // the exact path wrote this context
      float v = part[d * kCtxCols + jj];
      for (int r = 1; r < kCtxParts; ++r) v += part[(r * kCtxDays + d) * kCtxCols + jj];
      out[bkr * h + j0 + jj] = state ? v + bv[(size_t)head * h + j0 + jj] * sa[bkr] : 0.0f;
    }
  }
}

// Floats of scratch of a wide launch for `lanes` models: u (K, H), c (K),
// P (B, K, H), sum a (B, K), the states (B, K, as ints), each per lane.
inline long long wide_scratch_floats(int b, int k_heads, int h, int lanes) {
  const long long bk = (long long)b * k_heads;
  return (long long)lanes * ((long long)k_heads * h + k_heads + bk * h + 2 * bk);
}

template <int S>
int launch_wide(const float* latent, const unsigned char* mask, const float* keep,
                const float* q, const float* wk, const float* bk, const float* wv,
                const float* bv, float* out, int* exact, float* scratch, int b, int n,
                int k_heads, int h, int group, int lanes, cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t kh = (size_t)lanes * k_heads;
  float* u = scratch;
  float* c = u + kh * h;
  float* p = c + kh;
  float* sa = p + kh * b * h;
  int* st = reinterpret_cast<int*>(sa + kh * b);
  const dim3 prep_grid(prep_blocks(k_heads, h), lanes);
  attention_fwd_prep_kernel<S><<<prep_grid, kThreads, 0, stream>>>(
      q, wk, bk, u, c, k_heads, h);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int staged = 0;
  const int smem = plan_wide_smem(n, h, group, false, keep != nullptr, &staged);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  const int cs = wide_cluster(h);
  const int groups = (k_heads + group - 1) / group;
  err = launch_clustered_threads(attention_fwd_wide_kernel<S>, kThreads, b * groups * cs,
                                 lanes, cs, smem, stream, latent, mask, keep, q, wk, bk, wv,
                                 bv, (const float*)u, (const float*)c, p, sa, st, out, exact,
                                 n, k_heads, h, group, staged);
  if (err != 0) return err;
  const int ctx_smem = (int)sizeof(float) * (h * kCtxCols + kCtxDays * h +
                                             kCtxParts * kCtxDays * kCtxCols);
  cudaError_t e = cudaFuncSetAttribute(attention_fwd_ctx_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, ctx_smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int tiles = (h + kCtxCols - 1) / kCtxCols;
  attention_fwd_ctx_kernel<<<dim3(k_heads * tiles, lanes), kThreads, ctx_smem, stream>>>(
      wv, bv, p, sa, st, out, b, k_heads, h);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const float* latent, const unsigned char* mask, const float* keep,
           const float* q, const float* wk, const float* bk, const float* wv,
           const float* bv, float* out, int* exact, int b, int n, int k_heads, int h,
           int group, int lanes, cudaStream_t stream) {
  int staged = 0;
  const int smem = plan_smem(n, h, group, false, &staged);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const int groups = (k_heads + group - 1) / group;
  attention_fwd_kernel<S><<<dim3(b * groups, lanes), kThreads, smem, stream>>>(
      latent, mask, keep, q, wk, bk, wv, bv, out, exact, n, k_heads, h, group, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_fwd_max_hidden() { return kMaxH; }

// Floats of scratch `attention_fwd` needs (the kernels write all of it):
// none up to H = 64; above, u, c, P, sum a and the states of each lane.
extern "C" long long attention_fwd_scratch_floats(int b, int n, int k_heads, int h,
                                                  int lanes) {
  (void)n;
  return h <= kMaxStagedH ? 0 : wide_scratch_floats(b, k_heads, h, lanes);
}

// Launches on `stream` with `group` heads per CTA (above H = 64: per
// cluster), for `lanes` = S models; returns the cudaError_t of the launch
// (0 = ok). An N whose row list and scores do not fit one block's shared
// memory even with the rows left in device memory is refused (at G = 1:
// above N of about 18,800 at H = 64; above it about 18,700 at H = 128 and
// 15,900 at H = 256, 14,400 with a keep-mask, where the exact path's
// streamed chunk and row tiles or the keep-mask's rows bind).
extern "C" int attention_fwd(const float* latent, const unsigned char* mask,
                             const float* keep, const float* q,
                             const float* wk, const float* bk,
                             const float* wv, const float* bv, float* out,
                             int* exact, float* scratch, int b, int n, int k_heads, int h,
                             int group, int lanes, void* stream) {
  if (h <= 0 || h > kMaxH || n <= 0 || group <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || k_heads <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto fn) {
    return fn(latent, mask, keep, q, wk, bk, wv, bv, out, exact, b, n, k_heads, h, group,
              lanes, st);
  };
  auto wide = [&](auto fn) {
    return fn(latent, mask, keep, q, wk, bk, wv, bv, out, exact, scratch, b, n, k_heads, h,
              group, lanes, st);
  };
  if (h <= 32) return go(launch<1>);
  if (h <= 64) return go(launch<2>);
  if (h <= 128) return wide(launch_wide<4>);
  return wide(launch_wide<8>);
}
