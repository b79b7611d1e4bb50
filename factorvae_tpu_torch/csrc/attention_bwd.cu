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
// dctx. Three kernels, launched in order on one stream:
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
// At H = 256 the weights are 16 times larger (101 MB read and written at
// one day, ~0.03 ms); kernel 1 takes the S = 8 instance (rows unstaged
// above N of about 210, the exact path streaming Wk and Wv), the latent
// pass one slice of the heads per column.

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

// dL[b, n, i] = sum_k dz[b,k,n] u[k,i] + a[b,k,n] w[b,k,i]: one block per
// (day, stock), a thread per (column, slice of the heads), each slice an
// fmaf chain over its heads in order, the slices summed in order. kHC is
// the class's largest H (64, 128 or 256): kThreads / kHC slices, four at
// H <= 64 (the tuned kernel, unchanged), one at H <= 256.
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
// sum dz and sum a (S, B, K, 2), u (S, K, H).
extern "C" long long attention_bwd_scratch_floats(int b, int n, int k_heads, int h,
                                                  int lanes) {
  const long long bk = (long long)b * k_heads;
  return (long long)lanes * (2 * bk * n + bk * 3 * h + bk * 2 + (long long)k_heads * h);
}

// Launches the three kernels on `stream`, kernel 1 with `group` heads per
// CTA, for `lanes` = S models; returns the first cudaError_t (0 = ok). An N
// whose row list and per-head arrays do not fit one block's shared memory
// even with the rows left in device memory is refused (at G = 1: above N
// of about 9,300 at H = 64, 9,200 at H = 128 and 7,900 at H = 256, where the
// exact path's streamed chunk and row tiles bind; at H = 64 and G = 2,
// above 3,700).
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
  auto head = [&](auto fn) {
    return fn(latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, exact, b, n,
              k_heads, h, group, lanes, st);
  };
  int err = h <= 32 ? head(launch_head<1>) : h <= 64 ? head(launch_head<2>)
            : h <= 128 ? head(launch_head<4>) : head(launch_head<8>);
  if (err != 0) return err;
  attention_bwd_weights_kernel<<<dim3(k_heads * kWeightParts, lanes), kThreads, 0, st>>>(
      q, wk, bk, dctx, vec, sums, dq, dwk, dbk, dwv, dbv, u, b, k_heads, h);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid(b * n, lanes);
  if (h <= 64)
    attention_bwd_latent_kernel<64><<<grid, kThreads, 0, st>>>(a, dz, u, vec, dlatent, n,
                                                               k_heads, h);
  else if (h <= 128)
    attention_bwd_latent_kernel<128><<<grid, kThreads, 0, st>>>(a, dz, u, vec, dlatent, n,
                                                                k_heads, h);
  else
    attention_bwd_latent_kernel<256><<<grid, kThreads, 0, st>>>(a, dz, u, vec, dlatent, n,
                                                                k_heads, h);
  return (int)cudaGetLastError();
}
