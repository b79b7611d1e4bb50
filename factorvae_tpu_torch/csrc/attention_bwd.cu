// K-head cross-section attention backward (K5) for Hopper, f32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// factorvae_tpu/ops/pallas/attention_grad.py (launched by `_bwd_pallas`, the
// custom VJP of `fused_attention`). The JAX code vmaps the one-day kernel
// over the days of a batch; here the day axis is a grid axis. Per (day b,
// head k), with a = softmax weights, r = relu(s) the scores as K4 computes
// them, V = nan_to_num(L . Wv + bv) and dctx the cotangent of the context:
//
//   da  = V . dctx                       t  = a da
//   dz  = 1[r > 0] (t - a sum(t)) / sqrt(H + 1e-6) * keep
//   dkey = dz (x) q                      dV = a (x) dctx
//   dq  = key^T dz     dWk = L^T dkey    dbk = sum dkey
//   dWv = L^T dV       dbv = sum dV      dL = dkey Wk^T + dV Wv^T
//
// and a head caught by the guard (a non-finite valid score), or a day with
// no valid row, gives exactly zero to every gradient, by a select. The mask
// and the keep-mask get none.
//
// Both dkey and dV are rank one per (day, head), so every product with L or
// a weight reduces to vectors:
//
//   lz = L^T dz,  la = L^T a  (H)        dWk[k] = (sum_b lz) (x) q
//   dbk[k] = (sum_b sum dz) q            dq[k]  = Wk^T (sum_b lz) + bk sum_b sum dz
//   dWv[k] = sum_b la (x) dctx           dbv[k] = sum_b (sum a) dctx
//   dL[b, n] = sum_k dz[b,k,n] u_k + a[b,k,n] w_bk,  u_k = Wk q,  w_bk = Wv dctx
//
// and on a day whose valid rows are finite, so is da: da_n = L_n . w + bv .
// dctx. Up to H = 64 three kernels, launched in order on one stream:
//   1. one CTA per (day, group of G heads), G from the wrapper's launch rule:
//      the scores and softmax by K4's own fold code (attention_common.cuh;
//      the weights a are bitwise K4's), w and da folded, then dz; writes a
//      and dz per stock (B, K, N) and lz, la, w, sum dz, sum a per (day,
//      head). No per-row H x H product: about 8H FLOP per valid row and head
//      (score, da, lz, la). A day with a non-finite valid element takes the
//      exact path in the same CTA, head by head: the key and value rows as
//      written, as K4's exact path computes them;
//   2. four blocks per head: sum those over the days in day order and form
//      dq, dWk, dbk, dWv, dbv and u;
//   3. one thread per (day, stock, column): dL summed over heads in head
//      order.
// Every sum runs in a fixed order, so a repeated call gives bitwise the same
// gradients; there are no atomics.
//
// Lanes: a launch carries S models, each with its own days (train/fleet.py):
// every input, gradient and scratch array gains a leading lane axis, and
// each kernel's grid has the lane as its y. The cross-day sums of kernel 2
// run over one lane's days only, in day order, and a guarded head stays in
// its lane, so lane i is bitwise a one-lane launch.
//
// Bound: at one flagship day (N = 304, ~300 valid, K = 96, H = 64) the
// least work is ~12H per valid row and head and a few H^2 per head: ~30
// MFLOP, against reading Wk and Wv and writing dWk and dWv (6.3 MB of 6.7),
// so the bytes bound it at ~0.002 ms. What keeps it from there is latency:
// three launches, kernel 1's weight reads and barriers, 96 CTAs at one day.
//
// Above H = 64 ("The wide design" below and in attention_common.cuh) four
// kernels, the weight work that no day changes done once per launch:
//   0. `attention_bwd_prep_kernel`: u = Wk q and c = bk q per head (the
//      function K4's prep kernel calls, so the scores, and with them a, are
//      bitwise K4's), w = Wv dctx and cw = bv dctx per (day, head): every
//      head's Wk and Wv read once per launch, not once per (day, group);
//   1. `attention_bwd_head_wide_kernel`: K4's clusters (2 or 4 CTAs per
//      (day, group of heads), a column slice of the day's rows each): the
//      partial scores and the partial da from one pass over the CTA's rows,
//      both summed in rank order through DSMEM, the softmax, dz, then lz and
//      la over its own columns in one pass; rank 0 writes a, dz and the
//      sums; the exact path's heads are dealt to the ranks;
//   2. `attention_bwd_weights_wide_kernel`: as kernel 2, with dq spread over
//      the head's four blocks (Wk read along its rows, float4) and float4
//      stores of dWk and dWv; u is the prep kernel's;
//   3. `attention_bwd_latent_wide_kernel`: dL in tiles of 16 stocks and 32
//      columns, each element one fmaf chain over the heads in order, the
//      next heads' u, w, a and dz copied (cp.async) while these are summed.
// At H = 256 the weights are 16 times larger than at 64 (101 MB read and
// written at one day, ~0.03 ms): the weights kernel's stores and the prep
// kernel's reads are most of the bytes; the day clusters re-read their
// slices of the day's rows from L2 once per group of heads and run a chain
// of barriers (compact, stage, partial sums, the cluster exchange, softmax,
// dz, lz and la).

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// The exact path for one (day, head): the as-written key and value rows.
// Up to H = 64 (S <= 2) the head's Wk and Wv are staged whole; above, they
// stream through shared memory kChunk columns at a time (attention_common.
// cuh), da and w = Wv dctx summed over the chunks in order.
template <int S>
__device__ void exact_head(const float* lat, const int* idx, int nv, const float* kp,
                           const float* q, const float* wk, const float* bk,
                           const float* wv, const float* bv, const float* dctx_row,
                           int head, int h, float* smem, const Layout& L,
                           float* a_row, float* dz_row, float* vec, float* sums) {
  __shared__ float red_f[kWarps];
  __shared__ float shared_val;
  const int hp = round4(h);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* wk_s = smem + L.wk;
  float* wv_s = smem + L.wv;
  float* q_s = smem + L.q;
  float* bk_s = smem + L.bk;
  float* bv_s = smem + L.bv;
  float* dc_s = smem + L.dc;
  float* wa_s = smem + L.wa;
  float* sc_s = smem + L.xs;
  float* a_s = smem + L.xa;
  float* dz_s = smem + L.xd;
  float* tile = smem + L.tile + warp * kTile * hp;
  const size_t hh = (size_t)h * h;
  __syncthreads();            // the previous head's readers are done
  if constexpr (S > 2) {
    stage_vectors(q, bk, bv, head, h, hp, q_s, bk_s, bv_s);
  } else {
    stage_head(q, wk, bk, wv, bv, head, h, hp, q_s, wk_s, bk_s, wv_s, bv_s);
  }
  for (int i = tid; i < hp; i += kThreads) {
    dc_s[i] = i < h ? dctx_row[i] : 0.0f;
    if constexpr (S > 2) wa_s[i] = 0.0f;
  }
  __syncthreads();

  bool live;
  if constexpr (S > 2) {
    live = head_softmax_streamed(lat, idx, nv, kp, wk + head * hh, bk_s, q_s, h, hp, wk_s,
                                 tile, sc_s, a_s);
  } else {
    live = head_softmax<S>(lat, idx, nv, kp, wk_s, bk_s, q_s, h, hp, tile, sc_s, a_s);
  }
  if (!live) {
    // a zero context: no gradient (a_out and dz_out come zeroed)
    for (int i = tid; i < 3 * h; i += kThreads) vec[i] = 0.0f;
    if (tid < 2) sums[tid] = 0.0f;
    return;
  }

  // ---- da = nan_to_num(value) . dctx for each valid stock ----------------
  if constexpr (S > 2) {
    // and w = Wv dctx, a chunk of Wv's columns at a time
    for (int g = tid; g < nv; g += kThreads) dz_s[g] = 0.0f;
    for (int j0 = 0; j0 < h; j0 += kChunk) {
      __syncthreads();        // dz_s is zeroed; the last chunk's readers are done
      stage_chunk(wv + head * hh, j0, h, hp, wv_s);
      __syncthreads();
      const int j = j0 + lane;
      const bool on = j < h;
      const float bj = on ? bv_s[j] : 0.0f;
      const float dj = on ? dc_s[j] : 0.0f;
      for (int i = warp; i < h; i += kWarps) {
        const float part = warp_sum(wv_s[i * kChunk + lane] * dj);
        if (lane == 0) wa_s[i] += part;
      }
      for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
        stage_tile(lat, idx, g, nv, h, hp, lane, tile);
        float val[kTile];
        tile_chunk(tile, wv_s, hp, lane, val);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const float part = warp_sum(on ? nan_to_num_f(val[t] + bj) * dj : 0.0f);
          if (lane == 0 && g + t < nv) dz_s[g + t] += part;
        }
        __syncwarp();
      }
    }
  } else {
    for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
      stage_tile(lat, idx, g, nv, h, hp, lane, tile);
      float val[kTile][S];
      tile_times<S>(tile, wv_s, bv_s, h, hp, lane, val);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        float part = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (lane + 32 * s < h)
            part = fmaf(nan_to_num_f(val[t][s]), dc_s[lane + 32 * s], part);
        part = warp_sum(part);
        if (lane == 0 && g + t < nv) dz_s[g + t] = part;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- sum(t), t = a da, then dz -----------------------------------------
  float st = 0.0f;
  for (int g = tid; g < nv; g += kThreads) st += a_s[g] * dz_s[g];
  st = warp_sum(st);
  if (lane == 0) red_f[warp] = st;
  __syncthreads();
  if (tid == 0) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += red_f[w];
    shared_val = v;
  }
  __syncthreads();
  const float sum_t = shared_val;
  const float scale = sqrtf((float)h + 1e-6f);
  for (int g = tid; g < nv; g += kThreads) {
    const float a = a_s[g];
    const float dr = a * dz_s[g] - a * sum_t;
    float dz = sc_s[g] > 0.0f ? dr : 0.0f;
    dz = dz / scale;
    if (kp) dz = dz * kp[idx[g]];
    dz_s[g] = dz;
    a_row[idx[g]] = a;
    dz_row[idx[g]] = dz;
  }
  __syncthreads();

  // ---- lz = L^T dz, la = L^T a, w = Wv dctx, sum dz, sum a: one item a
  // thread, each an fmaf chain in order. Up to H = 64 the items sit in
  // bands of kBand threads (3 kBand + 2 <= kThreads); above, a thread takes
  // every kThreads-th item.
  constexpr int kBand = 64;
  if constexpr (S <= 2) {
    if (tid < h) {
      float acc = 0.0f;
      for (int g = 0; g < nv; ++g) acc = fmaf(dz_s[g], lat[(size_t)idx[g] * h + tid], acc);
      vec[tid] = acc;
    } else if (tid >= kBand && tid < kBand + h) {
      const int i = tid - kBand;
      float acc = 0.0f;
      for (int g = 0; g < nv; ++g) acc = fmaf(a_s[g], lat[(size_t)idx[g] * h + i], acc);
      vec[h + i] = acc;
    } else if (tid >= 2 * kBand && tid < 2 * kBand + h) {
      const int i = tid - 2 * kBand;
      float acc = 0.0f;
      for (int j = 0; j < h; ++j) acc = fmaf(wv_s[i * h + j], dc_s[j], acc);
      vec[2 * h + i] = acc;
    } else if (tid == 3 * kBand || tid == 3 * kBand + 1) {
      const float* v = tid == 3 * kBand ? dz_s : a_s;
      float acc = 0.0f;
      for (int g = 0; g < nv; ++g) acc += v[g];
      sums[tid - 3 * kBand] = acc;
    }
  } else {
    for (int e = tid; e < 3 * h + 2; e += kThreads) {
      if (e < 2 * h) {
        const float* v = e < h ? dz_s : a_s;
        const int i = e < h ? e : e - h;
        float acc = 0.0f;
        for (int g = 0; g < nv; ++g) acc = fmaf(v[g], lat[(size_t)idx[g] * h + i], acc);
        vec[e] = acc;
      } else if (e < 3 * h) {
        vec[e] = wa_s[e - 2 * h];
      } else {
        const float* v = e == 3 * h ? dz_s : a_s;
        float acc = 0.0f;
        for (int g = 0; g < nv; ++g) acc += v[g];
        sums[e - 3 * h] = acc;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
attention_bwd_head_kernel(const float* __restrict__ latent,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ keep,
                          const float* __restrict__ q,
                          const float* __restrict__ wk,
                          const float* __restrict__ bk,
                          const float* __restrict__ wv,
                          const float* __restrict__ bv,
                          const float* __restrict__ dctx,
                          float* __restrict__ a_out,      // (B, K, N)
                          float* __restrict__ dz_out,     // (B, K, N)
                          float* __restrict__ vec_out,    // (B, K, 3, H): lz, la, w
                          float* __restrict__ sum_out,    // (B, K, 2): sum dz, sum a
                          int* __restrict__ exact,
                          int n, int k_heads, int h, int group, int staged) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout(n, h, group, staged, true);
  int* idx = reinterpret_cast<int*>(smem + L.idx);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int groups = (k_heads + group - 1) / group;
  {                         // this CTA's lane: its slice of every array
    const size_t lane = blockIdx.y;
    const size_t b_days = gridDim.x / groups;
    const size_t kh = (size_t)k_heads * h;
    const size_t bkn = b_days * k_heads * n;
    latent += lane * b_days * n * h;
    mask += lane * b_days * n;
    if (keep) keep += lane * bkn;
    q += lane * kh;
    wk += lane * kh * h;
    bk += lane * kh;
    wv += lane * kh * h;
    bv += lane * kh;
    dctx += lane * b_days * kh;
    a_out += lane * bkn;
    dz_out += lane * bkn;
    vec_out += lane * b_days * 3 * kh;
    sum_out += lane * b_days * k_heads * 2;
    if (exact) exact += lane * b_days;
  }
  const int day = blockIdx.x / groups;
  const int grp = blockIdx.x - day * groups;
  const int head0 = grp * group;
  const int gn = min(group, k_heads - head0);
  const size_t bk0 = (size_t)day * k_heads + head0;
  const float* lat = latent + (size_t)day * n * h;
  const float* keep_g = keep ? keep + bk0 * n : nullptr;
  float* vec = vec_out + bk0 * 3 * h;
  float* sums = sum_out + bk0 * 2;

  const size_t group_bytes = (size_t)gn * h * h * sizeof(float);
  prefetch_l2(wk + (size_t)head0 * h * h, group_bytes);
  prefetch_l2(wv + (size_t)head0 * h * h, group_bytes);
  // a and dz per stock: zero for every row, the valid ones written below
  // (after the barrier in stage_rows)
  for (int e = tid; e < gn * n; e += kThreads) a_out[bk0 * n + e] = dz_out[bk0 * n + e] = 0.0f;
  const int nv = compact_rows(mask + (size_t)day * n, n, idx);
  const bool flagged = stage_rows(lat, idx, nv, h, staged, smem + L.rows);
  if (exact && grp == 0 && tid == 0) exact[day] = flagged;

  if (flagged) {               // the exact path, one head at a time
    for (int g = 0; g < gn; ++g)
      exact_head<S>(lat, idx, nv, keep_g ? keep_g + (size_t)g * n : nullptr, q, wk, bk,
                    wv, bv, dctx + (bk0 + g) * h, head0 + g, h, smem, L,
                    a_out + (bk0 + g) * n, dz_out + (bk0 + g) * n,
                    vec + (size_t)g * 3 * h, sums + 2 * g);
    return;
  }

  const Rows rows = staged ? Rows{smem + L.rows, idx, row_ld(h), true}
                           : Rows{lat, idx, h, false};
  float* sc = smem + L.sc;
  float* a = smem + L.a;
  float* d = smem + L.d;
  float* w = smem + L.w;
  float* sa = smem + L.sa;
  int* ok = reinterpret_cast<int*>(smem + L.ok);
  const float scale = sqrtf((float)h + 1e-6f);

  // the forward's scores and weights, then w = Wv dctx and da = L w + bv . dctx
  head_matvec<(S < 2 ? 2 : S)>(wk + (size_t)head0 * h * h, bk + (size_t)head0 * h,
                               q + (size_t)head0 * h, gn, h, L.gp, smem + L.u, smem + L.c);
  row_dots(rows, nv, h, smem + L.u, smem + L.c, gn, L.gp, sc, L.ldn);
  fold_softmax(sc, a, L.ldn, smem + L.at, L.gt, nv, idx, keep_g, n, gn, scale, ok, sa);
  head_matvec<(S < 2 ? 2 : S)>(wv + (size_t)head0 * h * h, bv + (size_t)head0 * h,
                               dctx + bk0 * h, gn, h, L.gp, w, smem + L.cw);
  row_dots(rows, nv, h, w, smem + L.cw, gn, L.gp, d, L.ldn);

  // dz = 1[r > 0] (a da - a sum(a da)) / scale * keep, per head (one warp),
  // also transposed into dt; a guarded head's transposed a and dz are zero,
  // so its lz and la come out zero
  float* dt = smem + L.dt;
  for (int g = warp; g < gn; g += kWarps) {
    const float* ag = a + g * L.ldn;
    const float* dg = d + g * L.ldn;
    const float* sg = sc + g * L.ldn;
    if (!ok[g]) {
      for (int r = lane; r < nv; r += 32) dt[r * L.gt + g] = 0.0f;
      if (lane < 2) sums[2 * g + lane] = 0.0f;
      continue;
    }
    const float* kp = keep_g ? keep_g + (size_t)g * n : nullptr;
    float* a_row = a_out + (bk0 + g) * n;
    float* dz_row = dz_out + (bk0 + g) * n;
    float st = 0.0f;
    for (int r = lane; r < nv; r += 32) st += ag[r] * dg[r];
    st = warp_sum(st);
    float sdz = 0.0f;
#pragma unroll 4
    for (int r = lane; r < nv; r += 32) {
      const float av = ag[r];
      const float dr = av * dg[r] - av * st;
      float dz = sg[r] > 0.0f ? dr : 0.0f;
      dz = dz / scale;
      if (kp) dz = dz * kp[idx[r]];
      dt[r * L.gt + g] = dz;
      sdz += dz;
      a_row[idx[r]] = av;
      dz_row[idx[r]] = dz;
    }
    sdz = warp_sum(sdz);
    if (lane == 0) {
      sums[2 * g] = sdz;
      sums[2 * g + 1] = sa[g];
    }
  }
  __syncthreads();
  column_sums(rows, nv, h, dt, L.gt, gn, smem + L.part, vec, 3 * h);             // lz
  column_sums(rows, nv, h, smem + L.at, L.gt, gn, smem + L.part, vec + h, 3 * h);  // la
  for (int e = tid; e < gn * h; e += kThreads) {
    const int g = e / h;
    const int i = e - g * h;
    vec[(size_t)g * 3 * h + 2 * h + i] = ok[g] ? w[i * L.gp + g] : 0.0f;
  }
}

// One block per (head, quarter of the H x H elements): those elements of
// dWk and dWv, summed over the days in order; quarter 0 also forms dq and
// dbk, quarter 1 dbv, quarter 2 u = Wk q for the latent pass.
constexpr int kWeightParts = 4;

__global__ void __launch_bounds__(kThreads)
attention_bwd_weights_kernel(const float* __restrict__ q,
                             const float* __restrict__ wk,
                             const float* __restrict__ bk,
                             const float* __restrict__ dctx,
                             const float* __restrict__ vec,   // (B, K, 3, H)
                             const float* __restrict__ sums,  // (B, K, 2)
                             float* __restrict__ dq, float* __restrict__ dwk,
                             float* __restrict__ dbk, float* __restrict__ dwv,
                             float* __restrict__ dbv, float* __restrict__ u,
                             int b_days, int k_heads, int h) {
  __shared__ float lz_s[kMaxH];
  __shared__ float q_s[kMaxH];
  __shared__ float sdz_s;
  const int head = blockIdx.x / kWeightParts;
  const int part = blockIdx.x - head * kWeightParts;
  const int tid = threadIdx.x;
  const size_t hh = (size_t)h * h;
  {                         // this block's lane
    const size_t lane = blockIdx.y;
    const size_t kh = (size_t)k_heads * h;
    q += lane * kh;
    wk += lane * kh * h;
    bk += lane * kh;
    dctx += lane * b_days * kh;
    vec += lane * b_days * 3 * kh;
    sums += lane * b_days * k_heads * 2;
    dq += lane * kh;
    dwk += lane * kh * h;
    dbk += lane * kh;
    dwv += lane * kh * h;
    dbv += lane * kh;
    u += lane * kh;
  }
  const float* wk_k = wk + head * hh;

  for (int i = tid; i <= h; i += kThreads) {   // lz and q by column, then sum dz
    float acc = 0.0f;
    if (i < h) {
      for (int b = 0; b < b_days; ++b) acc += vec[(((size_t)b * k_heads + head) * 3) * h + i];
      lz_s[i] = acc;
      q_s[i] = q[(size_t)head * h + i];
    } else {
      for (int b = 0; b < b_days; ++b) acc += sums[((size_t)b * k_heads + head) * 2];
      sdz_s = acc;
    }
  }
  __syncthreads();

  const int e1 = (int)((part + 1) * hh / kWeightParts);
#pragma unroll 4
  for (int e = (int)(part * hh / kWeightParts) + tid; e < e1; e += kThreads) {
    const int i = e / h;
    const int j = e - i * h;
    dwk[head * hh + e] = lz_s[i] * q_s[j];
    float acc = 0.0f;
    for (int b = 0; b < b_days; ++b) {
      const size_t bk_idx = (size_t)b * k_heads + head;
      acc = fmaf(vec[(bk_idx * 3 + 1) * h + i], dctx[bk_idx * h + j], acc);
    }
    dwv[head * hh + e] = acc;
  }
  for (int j = tid; j < h; j += kThreads) {
    if (part == 0) {
      dbk[(size_t)head * h + j] = sdz_s * q_s[j];
      float acc = 0.0f;
#pragma unroll 16
      for (int i = 0; i < h; ++i) acc = fmaf(lz_s[i], wk_k[i * h + j], acc);
      dq[(size_t)head * h + j] = acc + bk[(size_t)head * h + j] * sdz_s;
    } else if (part == 1) {
      float accv = 0.0f;
      for (int b = 0; b < b_days; ++b) {
        const size_t bk_idx = (size_t)b * k_heads + head;
        accv = fmaf(sums[bk_idx * 2 + 1], dctx[bk_idx * h + j], accv);
      }
      dbv[(size_t)head * h + j] = accv;
    } else if (part == 2) {
      float accu = 0.0f;
#pragma unroll 16
      for (int c = 0; c < h; ++c) accu = fmaf(wk_k[j * h + c], q_s[c], accu);
      u[(size_t)head * h + j] = accu;
    }
  }
}

// dL[b, n, i] = sum_k dz[b,k,n] u[k,i] + a[b,k,n] w[b,k,i] up to H = 64: one
// block per (day, stock), a thread per (column, slice of the heads), each
// slice an fmaf chain over its heads in order, the slices summed in order.
// kHC = 64: kThreads / kHC = four slices.
template <int kHC>
__global__ void __launch_bounds__(kThreads)
attention_bwd_latent_kernel(const float* __restrict__ a,
                            const float* __restrict__ dz,
                            const float* __restrict__ u,
                            const float* __restrict__ vec,
                            float* __restrict__ dlatent,
                            int n, int k_heads, int h) {
  constexpr int kLatentSlices = kThreads / kHC;
  __shared__ float part[kLatentSlices][kHC];
  {                         // this block's lane
    const size_t lane = blockIdx.y;
    const size_t bkn = (size_t)gridDim.x * k_heads;     // B * K * N
    a += lane * bkn;
    dz += lane * bkn;
    u += lane * k_heads * h;
    vec += lane * bkn / n * 3 * h;
    dlatent += lane * gridDim.x * h;
  }
  const int b = blockIdx.x / n;
  const int row = blockIdx.x - b * n;
  const int i = threadIdx.x % kHC;
  const int sl = threadIdx.x / kHC;
  const int per = (k_heads + kLatentSlices - 1) / kLatentSlices;
  const int k1 = min(k_heads, (sl + 1) * per);
  float acc = 0.0f;
  if (i < h) {
#pragma unroll 8
    for (int k = sl * per; k < k1; ++k) {
      const size_t bk_idx = (size_t)b * k_heads + k;
      acc = fmaf(dz[bk_idx * n + row], u[(size_t)k * h + i], acc);
      acc = fmaf(a[bk_idx * n + row], vec[(bk_idx * 3 + 2) * h + i], acc);
    }
  }
  part[sl][i] = acc;
  __syncthreads();
  if (sl == 0 && i < h) {
    float v = 0.0f;
    for (int s = 0; s < kLatentSlices; ++s) v += part[s][i];
    dlatent[(size_t)blockIdx.x * h + i] = v;
  }
}

// ---------------------------------------------------------------------------
// The wide design (H > 64): kernel 1 split in two, a latent pass of its own
// ---------------------------------------------------------------------------

// 0. u = Wk q, c = bk q per (lane, head) and w = Wv dctx, cw = bv dctx per
// (lane, day, head), once per launch: the function K4's prep kernel calls,
// so the scores below are bitwise K4's. w goes to its place in vec.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ wk,
                          const float* __restrict__ bk, const float* __restrict__ wv,
                          const float* __restrict__ bv, const float* __restrict__ dctx,
                          float* __restrict__ u, float* __restrict__ c,
                          float* __restrict__ vec, float* __restrict__ cw, int b_days,
                          int k_heads, int h) {
  const size_t lane = blockIdx.y;
  const size_t kh = (size_t)k_heads * h;
  const size_t bkh = (size_t)b_days * kh;
  prep_rows<S>(q + lane * kh, wk + lane * kh * h, bk + lane * kh, wv + lane * kh * h,
               bv + lane * kh, dctx + lane * bkh, u + lane * kh, c + lane * k_heads,
               vec + lane * 3 * bkh + 2 * h, 3 * h, cw + lane * b_days * k_heads, b_days,
               k_heads, h);
}

// 1. A cluster of wide_cluster(h) CTAs per (lane, day, group of G heads),
// each holding a column slice of the day's valid rows (K4's layout): its
// partial scores L u and partial da L w over its slice from one pass over
// its rows, both summed in rank order through DSMEM, the softmax (every
// CTA the same), dz, then lz and la over its own columns. Rank 0 writes a
// and dz per stock and the sums; a day with a non-finite valid element
// takes the exact path as kernel 1 of H <= 64 does, the group's heads dealt
// to the ranks.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_head_wide_kernel(const float* __restrict__ latent,
                               const unsigned char* __restrict__ mask,
                               const float* __restrict__ keep,
                               const float* __restrict__ q,
                               const float* __restrict__ wk,
                               const float* __restrict__ bk,
                               const float* __restrict__ wv,
                               const float* __restrict__ bv,
                               const float* __restrict__ dctx,
                               const float* __restrict__ u, const float* __restrict__ cu,
                               const float* __restrict__ cwv,
                               float* __restrict__ a_out,      // (B, K, N)
                               float* __restrict__ dz_out,     // (B, K, N)
                               float* __restrict__ vec_out,    // (B, K, 3, H): lz, la, w
                               float* __restrict__ sum_out,    // (B, K, 2): sum dz, sum a
                               int* __restrict__ exact, int n, int k_heads, int h,
                               int group, int staged) {
  ATTN_PHASE_START
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const WideLayout W = wide_layout(n, h, group, staged, true, keep != nullptr);
  int* idx = reinterpret_cast<int*>(smem + W.idx);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int cs = wide_cluster(h);
  const int rank = (int)cluster_rank();
  const int groups = (k_heads + group - 1) / group;
  {                         // this CTA's lane: its slice of every array
    const size_t ln = blockIdx.y;
    const size_t b_days = gridDim.x / (groups * cs);
    const size_t kh = (size_t)k_heads * h;
    const size_t bkn = b_days * k_heads * n;
    latent += ln * b_days * n * h;
    mask += ln * b_days * n;
    if (keep) keep += ln * bkn;
    q += ln * kh;
    wk += ln * kh * h;
    bk += ln * kh;
    wv += ln * kh * h;
    bv += ln * kh;
    dctx += ln * b_days * kh;
    u += ln * kh;
    cu += ln * k_heads;
    cwv += ln * b_days * k_heads;
    a_out += ln * bkn;
    dz_out += ln * bkn;
    vec_out += ln * b_days * 3 * kh;
    sum_out += ln * b_days * k_heads * 2;
    if (exact) exact += ln * b_days;
  }
  const int cid = blockIdx.x / cs;
  const int day = cid / groups;
  const int grp = cid - day * groups;
  const int head0 = grp * group;
  const int gn = min(group, k_heads - head0);
  const size_t bk0 = (size_t)day * k_heads + head0;
  const float* lat = latent + (size_t)day * n * h;
  const float* keep_g = keep ? keep + bk0 * n : nullptr;
  float* vec = vec_out + bk0 * 3 * h;
  float* sums = sum_out + bk0 * 2;
  const int c0 = slice_begin(rank, h);
  const int cw = slice_begin(rank + 1, h) - c0;

  // a and dz per stock: zero for every row, the valid ones written below
  if (rank == 0)
    for (int e = tid; e < gn * n; e += kThreads) a_out[bk0 * n + e] = dz_out[bk0 * n + e] = 0.0f;
  const int nv = compact_rows(mask + (size_t)day * n, n, idx);
  ATTN_PHASE(0);
  stage_vectors_slice(u, h, cu, head0, gn, W.gp, W.sw, c0, cw, smem + W.v, smem + W.cv);
  stage_vectors_slice(vec_out + (size_t)day * k_heads * 3 * h + 2 * h, 3 * h,
                      cwv + (size_t)day * k_heads, head0, gn, W.gp, W.sw, c0, cw,
                      smem + W.v2, smem + W.cv2);
  const bool bad = stage_slice(lat, idx, nv, h, c0, cw, W.ld, staged, smem + W.rows, keep_g,
                               gn, n, W.ldn, smem + W.kp);
  ATTN_PHASE(1);
  const Rows rows = staged ? Rows{smem + W.rows, idx, W.ld, true}
                           : Rows{lat + c0, idx, h, false};
  slice_dots<true>(rows, nv, cw, smem + W.v, smem + W.v2, gn, W.gp, smem + W.p, smem + W.p2,
                   W.ldn, (h & 3) == 0);
  ATTN_PHASE(2);
  float* flag = smem + W.flag;
  if (tid == 0) flag[0] = bad ? 1.0f : 0.0f;
  cluster_arrive();
  cluster_wait();
  bool flagged = false;
  for (int r = 0; r < cs; ++r) flagged |= load_cluster(flag, r) != 0.0f;
  float* sc = smem + W.sc;
  float* d = smem + W.d;
  if (!flagged) {
    cluster_sum(smem + W.p, smem + W.cv, sc, nv, gn, W.ldn, cs);
    cluster_sum(smem + W.p2, smem + W.cv2, d, nv, gn, W.ldn, cs);
  }
  cluster_arrive();         // every peer has read this CTA's partials and flag
  cluster_wait();
  ATTN_PHASE(3);
  if (exact && grp == 0 && rank == 0 && tid == 0) exact[day] = flagged;

  if (flagged) {             // the exact path, the group's heads dealt to the ranks
    const Layout L = layout(n, h, group, false, true);
    for (int g = rank; g < gn; g += cs)
      exact_head<S>(lat, idx, nv, keep_g ? keep_g + (size_t)g * n : nullptr, q, wk, bk, wv,
                    bv, dctx + (bk0 + g) * h, head0 + g, h, smem, L, a_out + (bk0 + g) * n,
                    dz_out + (bk0 + g) * n, vec + (size_t)g * 3 * h, sums + 2 * g);
    return;
  }

  float* a = smem + W.a;
  float* sa = smem + W.sa;
  int* ok = reinterpret_cast<int*>(smem + W.ok);
  const float scale = sqrtf((float)h + 1e-6f);
  wide_softmax(sc, a, W.ldn, smem + W.at, W.gt, nv, keep_g ? smem + W.kp : nullptr, gn,
               scale, ok, sa);
  ATTN_PHASE(4);

  // dz = 1[r > 0] (a da - a sum(a da)) / scale * keep, per head (one warp),
  // also transposed into dt; a guarded head's transposed a and dz are zero,
  // so its lz and la come out zero
  float* dt = smem + W.dt;
  for (int g = warp; g < gn; g += kWarps) {
    const float* ag = a + g * W.ldn;
    const float* dg = d + g * W.ldn;
    const float* sg = sc + g * W.ldn;
    if (!ok[g]) {
      for (int r = lane; r < nv; r += 32) dt[r * W.gt + g] = 0.0f;
      if (rank == 0 && lane < 2) sums[2 * g + lane] = 0.0f;
      continue;
    }
    const float* kp = keep_g ? smem + W.kp + g * W.ldn : nullptr;
    float* a_row = a_out + (bk0 + g) * n;
    float* dz_row = dz_out + (bk0 + g) * n;
    float st = 0.0f;
    for (int r = lane; r < nv; r += 32) st += ag[r] * dg[r];
    st = warp_sum(st);
    float sdz = 0.0f;
#pragma unroll 4
    for (int r = lane; r < nv; r += 32) {
      const float av = ag[r];
      const float dr = av * dg[r] - av * st;
      float dz = sg[r] > 0.0f ? dr : 0.0f;
      dz = dz / scale;
      if (kp) dz = dz * kp[r];
      dt[r * W.gt + g] = dz;
      sdz += dz;
      if (rank == 0) {
        a_row[idx[r]] = av;
        dz_row[idx[r]] = dz;
      }
    }
    sdz = warp_sum(sdz);
    if (rank == 0 && lane == 0) {
      sums[2 * g] = sdz;
      sums[2 * g + 1] = sa[g];
    }
  }
  __syncthreads();
  ATTN_PHASE(5);
  slice_column_sums2(rows, nv, cw, dt, smem + W.at, W.gt, gn, smem + W.part, vec + c0,
                     vec + h + c0, 3 * h);                                  // lz and la
  ATTN_PHASE(6);
}

// 2. One block per (lane, head, quarter): rows [r0, r1) of dWk = (sum_b lz)
// (x) q and of dWv = sum_b la (x) dctx (summed over the days in order;
// float4 stores where H is a multiple of 4), and dq = Wk^T (sum_b lz) + bk
// sum_b sum dz for its quarter of the columns: a thread kDqCols columns of
// one of kDqRuns fixed runs of the rows, Wk read along its rows (float4
// where H is a multiple of 4), the runs summed in order. Quarter 0 also
// forms dbk, quarter 1 dbv. u comes from the prep kernel.
constexpr int kDqCols = 4;                                   // dq columns a thread
constexpr int kDqRuns = kThreads / (64 / kDqCols);           // runs of the rows of dq

__global__ void __launch_bounds__(kThreads)
attention_bwd_weights_wide_kernel(const float* __restrict__ q,
                                  const float* __restrict__ wk,
                                  const float* __restrict__ bk,
                                  const float* __restrict__ dctx,
                                  const float* __restrict__ vec,   // (B, K, 3, H)
                                  const float* __restrict__ sums,  // (B, K, 2)
                                  float* __restrict__ dq, float* __restrict__ dwk,
                                  float* __restrict__ dbk, float* __restrict__ dwv,
                                  float* __restrict__ dbv, int b_days, int k_heads, int h) {
  constexpr int kQuads = 64 / kDqCols;                       // threads along the columns
  __shared__ float lz_s[kMaxH];
  __shared__ float q_s[kMaxH];
  __shared__ float4 part_s[kDqRuns][kQuads];
  __shared__ float sdz_s;
  const int head = blockIdx.x / kWeightParts;
  const int part = blockIdx.x - head * kWeightParts;
  const int tid = threadIdx.x;
  const size_t hh = (size_t)h * h;
  {                         // this block's lane
    const size_t lane = blockIdx.y;
    const size_t kh = (size_t)k_heads * h;
    q += lane * kh;
    wk += lane * kh * h;
    bk += lane * kh;
    dctx += lane * b_days * kh;
    vec += lane * b_days * 3 * kh;
    sums += lane * b_days * k_heads * 2;
    dq += lane * kh;
    dwk += lane * kh * h;
    dbk += lane * kh;
    dwv += lane * kh * h;
    dbv += lane * kh;
  }
  const bool vec4 = (h & 3) == 0;
  // rows and columns a quarter: a multiple of 4, so a quarter's columns
  // start on a float4
  const int per = round4((h + kWeightParts - 1) / kWeightParts);
  const int r0 = min(h, part * per);
  const int r1 = min(h, r0 + per);
  const float* wk_k = wk + head * hh;
  // dq's reads of Wk first, in flight while the sums below are formed:
  // columns [r0 + 4 jq, + 4) of the rows of run `run`
  const int jq = tid % kQuads;
  const int run = tid / kQuads;
  const int j = r0 + jq * kDqCols;
  const int rlen = (h + kDqRuns - 1) / kDqRuns;
  const int i0 = min(h, run * rlen);
  const int i1 = min(h, i0 + rlen);
  constexpr int kMaxRun = (kMaxH + kDqRuns - 1) / kDqRuns;
  float4 wrow[kMaxRun];
#pragma unroll
  for (int t = 0; t < kMaxRun; ++t) {
    const int i = i0 + t;
    wrow[t] = float4{0.0f, 0.0f, 0.0f, 0.0f};
    if (i < i1 && j < r1) {
      const float* src = wk_k + (size_t)i * h + j;
      if (vec4) {
        wrow[t] = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        wrow[t].x = __ldg(src);
        if (j + 1 < r1) wrow[t].y = __ldg(src + 1);
        if (j + 2 < r1) wrow[t].z = __ldg(src + 2);
        if (j + 3 < r1) wrow[t].w = __ldg(src + 3);
      }
    }
  }
  for (int i = tid; i <= h; i += kThreads) {   // lz and q by column, then sum dz
    float acc = 0.0f;
    if (i < h) {
      for (int b = 0; b < b_days; ++b) acc += vec[(((size_t)b * k_heads + head) * 3) * h + i];
      lz_s[i] = acc;
      q_s[i] = q[(size_t)head * h + i];
    } else {
      for (int b = 0; b < b_days; ++b) acc += sums[((size_t)b * k_heads + head) * 2];
      sdz_s = acc;
    }
  }
  __syncthreads();

  float4 acc4 = float4{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < kMaxRun; ++t) {
    const int i = i0 + t;
    if (i < i1) {
      const float l = lz_s[i];
      acc4.x = fmaf(l, wrow[t].x, acc4.x);
      acc4.y = fmaf(l, wrow[t].y, acc4.y);
      acc4.z = fmaf(l, wrow[t].z, acc4.z);
      acc4.w = fmaf(l, wrow[t].w, acc4.w);
    }
  }
  part_s[run][jq] = acc4;

  // rows [r0, r1) of dWk and dWv, four elements a thread where H allows
  if (vec4) {
    const int q4 = h >> 2;
    for (int e = r0 * q4 + tid; e < r1 * q4; e += kThreads) {
      const int i = e / q4;
      const int c = (e - i * q4) << 2;
      const float l = lz_s[i];
      *reinterpret_cast<float4*>(dwk + head * hh + (size_t)i * h + c) =
          float4{l * q_s[c], l * q_s[c + 1], l * q_s[c + 2], l * q_s[c + 3]};
      float4 acc = float4{0.0f, 0.0f, 0.0f, 0.0f};
      for (int b = 0; b < b_days; ++b) {
        const size_t bk_idx = (size_t)b * k_heads + head;
        const float la = vec[(bk_idx * 3 + 1) * h + i];
        const float4 d = __ldg(reinterpret_cast<const float4*>(dctx + bk_idx * h + c));
        acc.x = fmaf(la, d.x, acc.x);
        acc.y = fmaf(la, d.y, acc.y);
        acc.z = fmaf(la, d.z, acc.z);
        acc.w = fmaf(la, d.w, acc.w);
      }
      *reinterpret_cast<float4*>(dwv + head * hh + (size_t)i * h + c) = acc;
    }
  } else {
    for (int e = r0 * h + tid; e < r1 * h; e += kThreads) {
      const int i = e / h;
      const int c = e - i * h;
      dwk[head * hh + e] = lz_s[i] * q_s[c];
      float acc = 0.0f;
      for (int b = 0; b < b_days; ++b) {
        const size_t bk_idx = (size_t)b * k_heads + head;
        acc = fmaf(vec[(bk_idx * 3 + 1) * h + i], dctx[bk_idx * h + c], acc);
      }
      dwv[head * hh + e] = acc;
    }
  }
  __syncthreads();
  if (run == 0) {
    float4 v = part_s[0][jq];
    for (int r = 1; r < kDqRuns; ++r) {
      const float4 o = part_s[r][jq];
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < kDqCols; ++c)
      if (j + c < r1) dq[(size_t)head * h + j + c] = vv[c] + bk[(size_t)head * h + j + c] * sdz_s;
  }
  for (int jb = tid; jb < h; jb += kThreads) {
    if (part == 0) {
      dbk[(size_t)head * h + jb] = sdz_s * q_s[jb];
    } else if (part == 1) {
      float accv = 0.0f;
      for (int b = 0; b < b_days; ++b) {
        const size_t bk_idx = (size_t)b * k_heads + head;
        accv = fmaf(sums[bk_idx * 2 + 1], dctx[bk_idx * h + jb], accv);
      }
      dbv[(size_t)head * h + jb] = accv;
    }
  }
}

// 3. dL[b, n, i] = sum_k dz[b,k,n] u[k,i] + a[b,k,n] w[b,k,i], one fmaf chain
// over the heads in order (dz u, then a w, per head) for every element,
// whatever the tile: one CTA per (lane, day, kLatRows stocks, kLatCols
// columns), a thread a column and two stocks, u, w, a and dz staged
// kLatHeads heads at a time by cp.async, the next heads' copies in flight
// while these are summed.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kThreads)
attention_bwd_latent_wide_kernel(const float* __restrict__ a,
                                 const float* __restrict__ dz,
                                 const float* __restrict__ u,
                                 const float* __restrict__ vec,
                                 float* __restrict__ dlatent,
                                 int b_days, int n, int k_heads, int h) {
  constexpr int kPairs = kLatRows / 2;
  static_assert(kLatCols * kPairs == kThreads, "a thread a column and two stocks");
  __shared__ float us[2][kLatHeads][kLatCols];
  __shared__ float ws[2][kLatHeads][kLatCols];
  __shared__ float2 dzs[2][kLatHeads][kPairs];
  __shared__ float2 as[2][kLatHeads][kPairs];
  {                         // this block's lane
    const size_t lane = blockIdx.y;
    const size_t bkn = (size_t)b_days * k_heads * n;
    a += lane * bkn;
    dz += lane * bkn;
    u += lane * k_heads * h;
    vec += lane * b_days * k_heads * 3 * h;
    dlatent += lane * b_days * n * h;
  }
  const int col_tiles = (h + kLatCols - 1) / kLatCols;
  const int row_tiles = (n + kLatRows - 1) / kLatRows;
  const int ct = blockIdx.x % col_tiles;
  const int rt = (blockIdx.x / col_tiles) % row_tiles;
  const int b = blockIdx.x / (col_tiles * row_tiles);
  const int n0 = rt * kLatRows;
  const int j0 = ct * kLatCols;
  const int j = threadIdx.x % kLatCols;
  const int pair = threadIdx.x / kLatCols;
  auto stage = [&](int buf, int k0) {
    const int kn = min(kLatHeads, k_heads - k0);
    for (int e = threadIdx.x; e < kLatHeads * kLatCols; e += kThreads) {
      const int kk = e / kLatCols;
      const int jj = e - kk * kLatCols;
      if (kk < kn && j0 + jj < h) {
        copy4(&us[buf][kk][jj], u + (size_t)(k0 + kk) * h + j0 + jj);
        copy4(&ws[buf][kk][jj], vec + (((size_t)b * k_heads + k0 + kk) * 3 + 2) * h + j0 + jj);
      } else {
        us[buf][kk][jj] = ws[buf][kk][jj] = 0.0f;
      }
    }
    for (int e = threadIdx.x; e < kLatHeads * kLatRows; e += kThreads) {
      const int kk = e / kLatRows;
      const int r = e - kk * kLatRows;
      float* zd = reinterpret_cast<float*>(dzs[buf][kk]) + r;
      float* ad = reinterpret_cast<float*>(as[buf][kk]) + r;
      if (kk < kn && n0 + r < n) {
        const size_t o = ((size_t)b * k_heads + k0 + kk) * n + n0 + r;
        copy4(zd, dz + o);
        copy4(ad, a + o);
      } else {
        *zd = *ad = 0.0f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float2 acc = float2{0.0f, 0.0f};
  stage(0, 0);
  for (int k0 = 0, buf = 0; k0 < k_heads; k0 += kLatHeads, buf ^= 1) {
    if (k0 + kLatHeads < k_heads) {
      stage(buf ^ 1, k0 + kLatHeads);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();        // this buffer's copies are whole
    const int kn = min(kLatHeads, k_heads - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float uv = us[buf][kk][j];
      const float wv = ws[buf][kk][j];
      const float2 z = dzs[buf][kk][pair];
      const float2 av = as[buf][kk][pair];
      acc.x = fmaf(av.x, wv, fmaf(z.x, uv, acc.x));
      acc.y = fmaf(av.y, wv, fmaf(z.y, uv, acc.y));
    }
    __syncthreads();        // this buffer's readers are done before it is staged again
  }
  if (j0 + j >= h) return;
  const int row = n0 + 2 * pair;
  if (row < n) dlatent[((size_t)b * n + row) * h + j0 + j] = acc.x;
  if (row + 1 < n) dlatent[((size_t)b * n + row + 1) * h + j0 + j] = acc.y;
}

template <int S>
int launch_head(const float* latent, const unsigned char* mask,
                const float* keep, const float* q, const float* wk,
                const float* bk, const float* wv, const float* bv,
                const float* dctx, float* a, float* dz, float* vec, float* sums,
                int* exact, int b, int n, int k_heads, int h, int group, int lanes,
                cudaStream_t stream) {
  int staged = 0;
  const int smem = plan_smem(n, h, group, true, &staged);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_head_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const int groups = (k_heads + group - 1) / group;
  attention_bwd_head_kernel<S><<<dim3(b * groups, lanes), kThreads, smem, stream>>>(
      latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, exact, n, k_heads,
      h, group, staged);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_bwd_max_hidden() { return kMaxH; }

// Floats of scratch the wrapper allocates (the kernels write all of it), for
// `lanes` = S models: a and dz (S, B, K, N), then lz, la, w (S, B, K, 3, H),
// sum dz and sum a (S, B, K, 2), u (S, K, H), and above H = 64 c (S, K) and
// cw (S, B, K).
extern "C" long long attention_bwd_scratch_floats(int b, int n, int k_heads, int h,
                                                  int lanes) {
  const long long bk = (long long)b * k_heads;
  const long long wide = h > kMaxStagedH ? k_heads + bk : 0;
  return (long long)lanes * (2 * bk * n + bk * 3 * h + bk * 2 + (long long)k_heads * h + wide);
}

template <int S>
int launch_wide(const float* latent, const unsigned char* mask, const float* keep,
                const float* q, const float* wk, const float* bk, const float* wv,
                const float* bv, const float* dctx, float* a, float* dz, float* vec,
                float* sums, float* u, float* c, float* cw, int* exact, int b, int n,
                int k_heads, int h, int group, int lanes, cudaStream_t stream) {
  const dim3 prep_grid(prep_blocks(k_heads, h), lanes);
  attention_bwd_prep_kernel<S><<<prep_grid, kThreads, 0, stream>>>(
      q, wk, bk, wv, bv, dctx, u, c, vec, cw, b, k_heads, h);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int staged = 0;
  const int smem = plan_wide_smem(n, h, group, true, keep != nullptr, &staged);
  if (smem < 0) return (int)cudaErrorInvalidConfiguration;
  const int cs = wide_cluster(h);
  const int groups = (k_heads + group - 1) / group;
  return launch_clustered_threads(attention_bwd_head_wide_kernel<S>, kThreads,
                                  b * groups * cs, lanes, cs, smem, stream, latent, mask, keep,
                                  q, wk, bk, wv, bv, dctx, (const float*)u, (const float*)c,
                                  (const float*)cw, a, dz, vec, sums, exact, n, k_heads, h,
                                  group, staged);
}

// Launches the kernels on `stream`, kernel 1 with `group` heads per CTA
// (above H = 64: per cluster), for `lanes` = S models; returns the first
// cudaError_t (0 = ok). An N whose row list and per-head arrays do not fit
// one block's shared memory even with the rows left in device memory is
// refused (at G = 1: above N of about 9,300 at H = 64, and about 6,900 at
// H = 128 and 256, 6,100 with a keep-mask; at H = 64 and G = 2, above
// 3,700).
extern "C" int attention_bwd(const float* latent, const unsigned char* mask,
                             const float* keep, const float* q,
                             const float* wk, const float* bk,
                             const float* wv, const float* bv,
                             const float* dctx, float* dlatent, float* dq,
                             float* dwk, float* dbk, float* dwv, float* dbv,
                             float* scratch, int* exact, int b, int n, int k_heads,
                             int h, int group, int lanes, void* stream) {
  if (h <= 0 || h > kMaxH || n <= 0 || b <= 0 || k_heads <= 0 || group <= 0 ||
      lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bk_n = (size_t)lanes * b * k_heads;
  float* a = scratch;
  float* dz = a + bk_n * n;
  float* vec = dz + bk_n * n;
  float* sums = vec + bk_n * 3 * h;
  float* u = sums + bk_n * 2;
  if (h > kMaxStagedH) {
    float* c = u + (size_t)lanes * k_heads * h;
    float* cw = c + (size_t)lanes * k_heads;
    auto wide = [&](auto fn) {
      return fn(latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, u, c, cw,
                exact, b, n, k_heads, h, group, lanes, st);
    };
    int err = h <= 128 ? wide(launch_wide<4>) : wide(launch_wide<8>);
    if (err != 0) return err;
    attention_bwd_weights_wide_kernel<<<dim3(k_heads * kWeightParts, lanes), kThreads, 0,
                                         st>>>(q, wk, bk, dctx, vec, sums, dq, dwk, dbk, dwv,
                                               dbv, b, k_heads, h);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int tiles = b * ((n + kLatRows - 1) / kLatRows) * ((h + kLatCols - 1) / kLatCols);
    attention_bwd_latent_wide_kernel<<<dim3(tiles, lanes), kThreads, 0, st>>>(
        a, dz, u, vec, dlatent, b, n, k_heads, h);
    return (int)cudaGetLastError();
  }
  auto head = [&](auto fn) {
    return fn(latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, exact, b, n,
              k_heads, h, group, lanes, st);
  };
  int err = h <= 32 ? head(launch_head<1>) : head(launch_head<2>);
  if (err != 0) return err;
  attention_bwd_weights_kernel<<<dim3(k_heads * kWeightParts, lanes), kThreads, 0, st>>>(
      q, wk, bk, dctx, vec, sums, dq, dwk, dbk, dwv, dbv, u, b, k_heads, h);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  attention_bwd_latent_kernel<64><<<dim3(b * n, lanes), kThreads, 0, st>>>(a, dz, u, vec,
                                                                          dlatent, n, k_heads, h);
  return (int)cudaGetLastError();
}
