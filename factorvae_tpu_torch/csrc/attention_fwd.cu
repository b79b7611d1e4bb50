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
// Wv + bv . sum(a). Design: one CTA per (day, group of G heads), G from the
// wrapper's launch rule (one head per CTA at one training day, 96 CTAs;
// groups of 8 at a 32-day serving chunk, so each day's rows are read twelve
// times, not 96). The CTA compacts the day's valid rows, stages them in
// shared memory (78 KB at N = 304, H = 64; read through the row list from
// device memory when the staged layout does not fit, above N of about 830),
// checks them for non-finite values, forms u and c for its heads, the
// (n_v x G) scores, the masked softmax, P = a^T L (G x H) and ctx = P . Wv
// + bv sum(a), reading Wk[k] and Wv[k] once. Work per valid row and head:
// about 4H FLOP (the score dot and the P sum), against 4H^2 + 3H as the TPU
// kernel writes it. A day with a non-finite valid element takes the exact
// path inside the same CTA: the key and value rows as written, one head at
// a time (attention_common.cuh), so nan_to_num and the guard keep exactly
// their meaning there; a clean day never takes it.
//
// Bound: least work ~4H per valid row and head, 2H^2 per head (u) and per
// (day, head) (ctx): about 0.26 GFLOP at a 32-day flagship chunk (B = 32,
// N = 304, K = 96, H = 64, ~9,100 valid rows) against ~6.5 MB read, so the
// f32 rate bounds it at ~0.0038 ms; at one day the 3.2 MB of Wk and Wv
// bound it at ~0.001 ms (bytes). The products are small (n_v x H x G per
// CTA) and run as fmaf chains on the CUDA cores; what keeps the kernel from
// its bound is latency, not work: each CTA runs a chain of phases (compact,
// stage, u, scores, softmax, P, ctx) with a block barrier between, and the
// phases that read device memory load a batch of elements per thread at
// once (clamped addresses, no branch between the loads) so that one round
// trip, not one per element, is paid. At one training day the grid is 96
// CTAs on 132 SMs.
//
// Wider H (the S = 4 and S = 8 instances, H <= 128 and <= 256): the same
// phases; a day's rows are staged up to N of about 420 at H = 128 and are
// read through the row list at H = 256 (304 rows of 257 floats exceed a
// block's shared memory), and the exact path streams Wk and Wv. At one
// flagship day of H = 256 the 50 MB of Wk and Wv bound it at ~0.015 ms.

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

// Launches on `stream` with `group` heads per CTA, for `lanes` = S models;
// returns the cudaError_t of the launch (0 = ok). An N whose row list and
// scores do not fit one block's shared memory even with the rows left in
// device memory is refused (at G = 1: above N of about 18,800 at H = 64,
// 18,700 at H = 128 and 15,800 at H = 256, where the exact path's streamed
// chunk and row tiles bind).
extern "C" int attention_fwd(const float* latent, const unsigned char* mask,
                             const float* keep, const float* q,
                             const float* wk, const float* bk,
                             const float* wv, const float* bv, float* out,
                             int* exact, int b, int n, int k_heads, int h, int group,
                             int lanes, void* stream) {
  if (h <= 0 || h > kMaxH || n <= 0 || group <= 0 || lanes < 1 || lanes > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  if (b <= 0 || k_heads <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto fn) {
    return fn(latent, mask, keep, q, wk, bk, wv, bv, out, exact, b, n, k_heads, h, group,
              lanes, st);
  };
  if (h <= 32) return go(launch<1>);
  if (h <= 64) return go(launch<2>);
  if (h <= 128) return go(launch<4>);
  return go(launch<8>);
}
