// Device code shared by the K-head attention forward (K4, attention_fwd.cu)
// and backward (K5, attention_bwd.cu).
//
// Up to H = 64 (the S = 1 and S = 2 instances, S the columns of H a lane
// owns where a warp spans H): a CTA takes one day and a group of G
// consecutive heads. It compacts the day's valid rows into a list, stages
// them in shared memory when they fit (else it reads them from device
// memory through the list), and notes whether any element of a valid row
// is non-finite.
//
// The fold path, for a day whose valid rows are finite: per head
//
//   u = Wk . q (H),  c = bk . q          s_n = (L_n . u + c) / sqrt(H + 1e-6)
//
// so no per-row key product is formed (`head_matvec`, `row_dots`,
// `fold_softmax`). Forward and backward call the same functions, and each
// score is one fmaf chain over the hidden units in order, whatever G is, so
// the backward's softmax weights are bitwise the forward's.
//
// The exact path, for a day with a non-finite valid element: the key and
// value rows as written, L . Wk + bk and nan_to_num(L . Wv + bv), one head at
// a time (`stage_head`, `head_softmax`, `tile_times`). There the fold is not
// the same function: with L_n = (+inf, 0, ...) the key row is +-inf by the
// sign of Wk[0, j] and key . q is NaN (the head is guarded), while
// L_n . u = +inf * u_0 is -inf where u_0 < 0, which the ReLU turns into 0.
// Above H = 64 the exact path does not stage a head's Wk and Wv whole (2 x
// 256 x 257 floats, 526 KB, at H = 256): it streams them through shared
// memory kChunk columns at a time (`stage_chunk`, `head_softmax_streamed`),
// a lane per column of the chunk, and sums each score and each da over the
// chunks in order.
//
// Above H = 64 (the S = 4 and S = 8 instances, H <= 128 and <= 256) the
// fold path is "the wide design" at the end of this file. Its CTAs once
// formed u, c (and K5's w = Wv . dctx) per (day, head), reading every head's
// Wk and Wv once per day, 1.6 GB at a 32-day chunk of H = 256, and read the
// day's rows (304 x 257 floats, which do not fit a block) through the row
// list in one 256-long chain per thread. Now:
//
//   - `prep_rows`: u and c per (lane, head), and K5's w and cw per (lane,
//     day, head), once per launch, a warp a few weight rows read along the
//     row (float4 where H is a multiple of 4). K4 and K5 call this one
//     function, so K5's scores and weights stay bitwise K4's.
//   - A cluster of wide_cluster(H) CTAs (2 up to H = 128, 4 above) per (day,
//     group of G heads): rank r stages its slice of at most 64 columns of
//     the day's valid rows (`stage_slice`: 16-byte cp.async, 304 x 68
//     floats, 83 KB at H = 256; read through the row list when N is too
//     large), forms its partial scores L . u (and K5's partial da = L . w)
//     over its columns (`slice_dots`), and reads its peers' partials through
//     DSMEM, summed in rank order (`cluster_sum`), so every CTA holds the
//     same scores and softmax (`wide_softmax`). After that each works on
//     its own columns: K4's P = a^T L, K5's lz and la
//     (`slice_column_sums`). The exact path deals the group's heads to the
//     cluster's ranks.
//   - No sum depends on G, on the lane count or on the grid: a score is the
//     partials of the slices (fixed by H) in rank order, a column sum's
//     rows run in kSumSlices fixed runs.
//
// What bounds the wide kernels is in attention_fwd.cu and attention_bwd.cu.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "cluster.cuh"

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxH = 256;           // largest hidden size (8 columns per lane)
constexpr int kMaxStagedH = 64;      // the exact path stages Wk and Wv whole up to here
constexpr int kChunk = 32;           // columns of a streamed weight chunk (above it)
constexpr int kMaxLanes = 65535;     // models per launch: the grid's y extent
constexpr int kTile = 8;             // valid rows per warp step (exact path)
constexpr float kNegInf = -1e30f;
constexpr int kSmemSlack = 1024;     // bytes left for the kernels' static shared memory

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Row stride of the staged rows: odd, so a warp that reads one column of 32
// consecutive rows touches 32 banks.
__host__ __device__ __forceinline__ int row_ld(int h) { return h | 1; }

// Offsets, in floats, into a CTA's dynamic shared memory for n rows, hidden
// size h and groups of g heads. The valid-row list comes first; the fold
// path's arrays and the exact path's share the space after it.
struct Layout {
  int ldn;                 // stride of the per-head row arrays: round4(n)
  int gp;                  // stride of the head vectors: round4(g)
  int gt;                  // row stride of the transposed arrays: 1 for one
                           // head, 4 for up to four, else gp + 4 (fewer bank
                           // conflicts on write)
  int idx;                 // (n) valid rows, as ints
  // fold path
  int rows;                // (n, row_ld(h)) staged rows, when staged
  int sc, a, d;            // (g, ldn) scores r, weights a (the forward: = sc), da / dz
  int at, dt;              // (n, gt) a and (backward) dz, transposed
  int u, c;                // (h, gp), (gp): u = Wk . q and c = bk . q per head
  int w, cw;               // backward: (h, gp), (gp): w = Wv . dctx, bv . dctx
  int sa, ok;              // (gp) sum of a; (gp ints) the head is not guarded
  int p;                   // forward: (g, h) P = a^T L
  int part;                // (4 kThreads) partial sums
  // exact path (wk = wv: one streamed chunk, above kMaxStagedH)
  int wk, wv, tile, q, bk, bv, dc, wa, red;
  int xs, xa, xd;          // (ldn) scores, weights (backward), da / dz (backward)
  int total;
};

__host__ __device__ inline Layout layout(int n, int h, int g, bool staged, bool bwd) {
  Layout L;
  const int hp = round4(h);
  L.ldn = round4(n);
  L.gp = round4(g);
  L.gt = g == 1 ? 1 : L.gp == 4 ? 4 : L.gp + 4;
  int o = 0;
  L.idx = o;
  o += L.ldn;
  const int base = o;
  L.rows = o;
  if (staged) o += round4(n * row_ld(h));
  L.sc = o;
  o += g * L.ldn;
  L.a = L.sc;
  L.d = o;
  if (bwd) {
    L.a = o;
    o += g * L.ldn;
    L.d = o;
    o += g * L.ldn;
  }
  L.at = L.dt = o;
  o += round4(n * L.gt);
  if (bwd) {
    L.dt = o;
    o += round4(n * L.gt);
  }
  L.u = o;
  o += h * L.gp;
  L.c = o;
  o += L.gp;
  L.w = L.cw = o;
  if (bwd) {
    L.cw = o + h * L.gp;
    o += (h + 1) * L.gp;
  }
  L.sa = o;
  o += L.gp;
  L.ok = o;
  o += L.gp;
  L.p = o;
  if (!bwd) o += round4(g * h);
  L.part = o;
  o += 4 * kThreads;
  const int fold_end = o;

  o = base;
  const bool streamed = h > kMaxStagedH;
  L.wk = o;
  o += streamed ? hp * kChunk : hp * h;
  L.wv = streamed ? L.wk : o;
  if (!streamed) o += hp * h;
  L.tile = o;
  o += kWarps * kTile * hp;
  L.q = o;
  o += hp;
  L.bk = o;
  o += hp;
  L.bv = o;
  o += hp;
  L.dc = o;
  o += hp;
  L.wa = o;                // streamed: w = Wv dctx, summed over the chunks
  if (streamed) o += hp;
  L.red = o;
  o += kWarps * (streamed ? kChunk : hp);
  L.xs = L.xa = L.xd = o;
  o += L.ldn;
  if (bwd) {
    L.xa = o;
    o += L.ldn;
    L.xd = o;
    o += L.ldn;
  }
  L.total = fold_end > o ? fold_end : o;
  return L;
}

// Bytes of dynamic shared memory of a launch, and whether the rows are
// staged (*staged = 1): staged whenever that layout fits the card's
// per-block limit. Returns -1 when not even the unstaged one fits.
inline int plan_smem(int n, int h, int g, bool bwd, int* staged) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int s = 1; s >= 0; --s) {
    const long long bytes = (long long)sizeof(float) * layout(n, h, g, s, bwd).total;
    if (bytes + kSmemSlack <= limit) {
      *staged = s;
      return (int)bytes;
    }
  }
  return -1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float nan_to_num_f(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

// Ask L2 for the 128-byte lines of [p, p + bytes), spread over the block's
// threads: a later read of them finds them there and not in device memory.
__device__ __forceinline__ void prefetch_l2(const float* p, size_t bytes) {
  const char* c = reinterpret_cast<const char*>(p);
  for (size_t o = (size_t)threadIdx.x * 128; o < bytes; o += (size_t)kThreads * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
}

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The indices of the day's valid rows, in order, into idx_s; returns their
// count. Every thread calls it; each loads its rows' mask bytes of up to
// kMaskChunks chunks of kThreads rows at once, then a ballot per warp and
// the warps' counts in order place them. Ends with __syncthreads.
constexpr int kMaskChunks = 4;

__device__ __forceinline__ int compact_rows(const unsigned char* m, int n, int* idx_s) {
  __shared__ int warp_count[kMaskChunks][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int r0 = 0; r0 < n; r0 += kMaskChunks * kThreads) {
    bool v[kMaskChunks];
    unsigned bal[kMaskChunks];
#pragma unroll
    for (int c = 0; c < kMaskChunks; ++c) {
      const int r = r0 + c * kThreads + threadIdx.x;
      v[c] = r < n && m[r];
    }
#pragma unroll
    for (int c = 0; c < kMaskChunks; ++c) {
      bal[c] = __ballot_sync(0xffffffffu, v[c]);
      if (lane == 0) warp_count[c][warp] = __popc(bal[c]);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kMaskChunks; ++c) {
      int before = 0, total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int count = warp_count[c][w];
        if (w < warp) before += count;
        total += count;
      }
      if (v[c])
        idx_s[base + before + __popc(bal[c] & ((1u << lane) - 1u))] =
            r0 + c * kThreads + threadIdx.x;
      base += total;
    }
    __syncthreads();          // warp_count is written again by the next chunk
  }
  return base;
}

// ---------------------------------------------------------------------------
// The fold path
// ---------------------------------------------------------------------------

// The day's valid rows: staged in shared memory (row r at base + r * ld), or
// in device memory through the list (row r at base + idx[r] * ld).
struct Rows {
  const float* base;
  const int* idx;
  int ld;
  bool staged;
  __device__ __forceinline__ const float* row(int r) const {
    return base + (size_t)(staged ? r : idx[r]) * ld;
  }
};

// Copy the nv valid rows of the day to rows_s (when staged) and return, on
// every thread, whether any element of a valid row is non-finite. Each
// thread loads kStageBatch elements at once (clamped addresses, so no
// branch keeps a load waiting for the one before it), then stores them.
// Every thread calls it after compact_rows.
constexpr int kStageBatch = 8;

__device__ __forceinline__ bool stage_rows(const float* lat, const int* idx, int nv,
                                           int h, bool staged, float* rows_s) {
  const int ld = row_ld(h);
  const int total = nv * h;
  int bad = 0;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * kThreads) {
    float v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int e = min(e0 + k * kThreads, total - 1);
      const int r = e / h;
      v[k] = __ldg(lat + (size_t)idx[r] * h + (e - r * h));
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int e = e0 + k * kThreads;
      if (e < total) {
        const int r = e / h;
        bad |= !isfinite(v[k]);
        if (staged) rows_s[r * ld + (e - r * h)] = v[k];
      }
    }
  }
  return __syncthreads_or(bad) != 0;
}

// For the g < G heads of a group: v[i * gp + g] = mat_g[i] . x_g (i < h) and
// cv[g] = bias_g . x_g, with mat_g = mat + g*h*h (h rows of h), bias_g =
// bias + g*h and x_g = x + g*h, all in device memory. A warp loads a batch
// of outputs' rows at once (16 at S = 2; clamped addresses, so every load
// is in flight before the first sum), a lane the columns lane + 32 s for
// s < S, then a butterfly sum: each output's order of summation is fixed,
// whatever G is. Zeroes v's padding heads [G, gp). Ends with
// __syncthreads.
constexpr int kMatvecBatch = 16;

template <int S>
__device__ __forceinline__ void head_matvec(const float* __restrict__ mat,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ x, int G,
                                            int h, int gp, float* v, float* cv) {
  constexpr int kBatch = kMatvecBatch * 2 / S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int total = G * (h + 1);
  int jc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) jc[s] = min(lane + 32 * s, h - 1);
  for (int o0 = warp * kBatch; o0 < total; o0 += kWarps * kBatch) {
    float m[kBatch][S], xv[kBatch][S];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int o = min(o0 + k, total - 1);
      const int g = o / (h + 1);
      const int i = o - g * (h + 1);
      const float* mp = i < h ? mat + ((size_t)g * h + i) * h : bias + (size_t)g * h;
      const float* xg = x + (size_t)g * h;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        m[k][s] = __ldg(mp + jc[s]);
        xv[k][s] = __ldg(xg + jc[s]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      float part = lane < h ? m[k][0] * xv[k][0] : 0.0f;
#pragma unroll
      for (int s = 1; s < S; ++s)
        if (lane + 32 * s < h) part = fmaf(m[k][s], xv[k][s], part);
      const float acc = warp_sum(part);
      const int o = o0 + k;
      if (lane == 0 && o < total) {
        const int g = o / (h + 1);
        const int i = o - g * (h + 1);
        if (i < h) v[i * gp + g] = acc;
        else cv[g] = acc;
      }
    }
  }
  for (int e = threadIdx.x; e < h * gp; e += kThreads)
    if (e % gp >= G) v[e] = 0.0f;
  __syncthreads();
}

// out[g * ldo + r] = row(r) . v[:, g] + cv[g] for r < nv and g < G: one fmaf
// chain over i in order per value, four heads per thread, so a value does
// not depend on G. v is (h, gp) in shared memory. Ends with __syncthreads.
__device__ __forceinline__ void row_dots(const Rows& rows, int nv, int h,
                                         const float* v, const float* cv, int G,
                                         int gp, float* out, int ldo) {
  const int quads = gp >> 2;
  for (int t = threadIdx.x; t < nv * quads; t += kThreads) {
    const int r = t % nv;
    const int g0 = (t / nv) * 4;
    const float* x = rows.row(r);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < h; ++i) {
      const float l = x[i];
      const float4 vv = *reinterpret_cast<const float4*>(v + i * gp + g0);
      a0 = fmaf(l, vv.x, a0);
      a1 = fmaf(l, vv.y, a1);
      a2 = fmaf(l, vv.z, a2);
      a3 = fmaf(l, vv.w, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (g0 + c < G) out[(g0 + c) * ldo + r] = acc[c] + cv[g0 + c];
  }
  __syncthreads();
}

// For each head g < G (warp g % kWarps), over the nv valid rows:
//   r = relu(s / sqrt(H + 1e-6) * keep)   in place in sc (a ReLU that keeps NaN)
//   ok[g] = no r is non-finite (the guard) and nv > 0
//   a = softmax(r) into a (may alias sc; a guarded head's a is left unset)
//       and into a_t[r * gt + g] (zero for a guarded head),
//   sa[g] = sum a, 0 if !ok[g].
// keep: this day's and group's (G, n) keep-mask, or null. Ends with
// __syncthreads.
__device__ __forceinline__ void fold_softmax(float* sc, float* a, int ldo, float* a_t,
                                             int gt, int nv, const int* idx,
                                             const float* keep, int n, int G, float scale,
                                             int* ok, float* sa) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += kWarps) {
    float* s = sc + g * ldo;
    float* ag = a + g * ldo;
    const float* kp = keep ? keep + (size_t)g * n : nullptr;
    float mx = kNegInf;
    int bad = 0;
#pragma unroll 4
    for (int r = lane; r < nv; r += 32) {
      float v = s[r] / scale;
      if (kp) v = v * kp[idx[r]];
      v = isnan(v) ? v : fmaxf(v, 0.0f);
      if (!isfinite(v)) bad = 1;
      else mx = fmaxf(mx, v);
      s[r] = v;
    }
    mx = warp_max(mx);
    const bool good = !__any_sync(0xffffffffu, bad) && nv > 0;
    float tot = 0.0f;
    if (good) {
      float sum = 0.0f;
      for (int r = lane; r < nv; r += 32) {
        const float e = expf(s[r] - mx);
        ag[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int r = lane; r < nv; r += 32) {
        const float w = ag[r] / sum;
        ag[r] = w;
        a_t[r * gt + g] = w;
        tot += w;
      }
      tot = warp_sum(tot);
    } else {
      for (int r = lane; r < nv; r += 32) a_t[r * gt + g] = 0.0f;
    }
    if (lane == 0) {
      ok[g] = good;
      sa[g] = tot;
    }
  }
  __syncthreads();
}

// out[g * ostride + i] = sum over r < nv of coef_t[r * gt + g] * row(r)[i],
// for g < G and i < h. A task is a column i and four heads (one float4 of
// coef_t per row; one float when gt = 1, a group of one head); the rows are cut into
// `slices` runs, each an fmaf chain,
// then summed in slice order (a fixed order for a given G). part: 4 *
// kThreads floats of shared memory. Ends with __syncthreads.
__device__ __forceinline__ void column_sums(const Rows& rows, int nv, int h,
                                            const float* coef_t, int gt, int G,
                                            float* part, float* out, int ostride) {
  const int pairs = h * ((G + 3) >> 2);
  const int slices = pairs >= kThreads ? 1 : kThreads / pairs;
  const int chunk = (nv + slices - 1) / slices;
  for (int t = threadIdx.x; t < pairs * slices; t += kThreads) {
    const int pair = t % pairs;
    const int sl = t / pairs;
    const int g0 = (pair / h) * 4;
    const int i = pair - (g0 >> 2) * h;
    const int r1 = min(nv, (sl + 1) * chunk);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int r = sl * chunk; r < r1; ++r) {
      const float l = rows.row(r)[i];
      const float4 c = gt == 1 ? float4{coef_t[r], 0.0f, 0.0f, 0.0f}
                              : *reinterpret_cast<const float4*>(coef_t + r * gt + g0);
      a0 = fmaf(c.x, l, a0);
      a1 = fmaf(c.y, l, a1);
      a2 = fmaf(c.z, l, a2);
      a3 = fmaf(c.w, l, a3);
    }
    const float acc[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (g0 + c >= G) break;
      if (slices == 1) out[(g0 + c) * ostride + i] = acc[c];
      else part[4 * t + c] = acc[c];
    }
  }
  if (slices > 1) {
    __syncthreads();
    for (int e = threadIdx.x; e < pairs * 4; e += kThreads) {
      const int pair = e >> 2;
      const int c = e & 3;
      const int g0 = (pair / h) * 4;
      if (g0 + c >= G) continue;
      float acc = 0.0f;
      for (int sl = 0; sl < slices; ++sl) acc += part[4 * (sl * pairs + pair) + c];
      out[(g0 + c) * ostride + pair - (g0 >> 2) * h] = acc;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The exact path: the key and value rows as the TPU kernel writes them
// ---------------------------------------------------------------------------

// Stage the warp's tile of valid rows (zeros past the list's end and in
// the padding columns [h, hp)) into `tile` (kTile, hp).
__device__ __forceinline__ void stage_tile(const float* lat, const int* idx,
                                           int g, int nv, int h, int hp,
                                           int lane, float* tile) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    const bool ok = g + t < nv;
    const float* src = ok ? lat + (size_t)idx[g + t] * h : lat;
    for (int i = lane; i < hp; i += 32) tile[t * hp + i] = ok && i < h ? src[i] : 0.0f;
  }
  __syncwarp();
}

// tile (kTile, hp) times a head matrix W (hp rows of H, rows >= h zero),
// plus bias: out[t][s] for the lane's columns j = lane + 32*s.
template <int S>
__device__ __forceinline__ void tile_times(const float* tile, const float* w,
                                           const float* bias, int h, int hp,
                                           int lane, float out[kTile][S]) {
#pragma unroll
  for (int t = 0; t < kTile; ++t)
#pragma unroll
    for (int s = 0; s < S; ++s) out[t][s] = 0.0f;
  for (int i = 0; i < hp; i += 4) {
    float4 l[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      l[t] = *reinterpret_cast<const float4*>(tile + t * hp + i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float wv[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j = lane + 32 * s;
        wv[s] = j < h ? w[(i + c) * h + j] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float lc = component(l[t], c);
#pragma unroll
        for (int s = 0; s < S; ++s) out[t][s] = fmaf(lc, wv[s], out[t][s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = lane + 32 * s;
    const float b = j < h ? bias[j] : 0.0f;
#pragma unroll
    for (int t = 0; t < kTile; ++t) out[t][s] += b;
  }
}

// Head `head`'s Wk and Wv (hp rows of H, rows >= h zero) and q, bk, bv
// (hp, zero padded) into shared memory.
__device__ __forceinline__ void stage_head(const float* q, const float* wk,
                                           const float* bk, const float* wv,
                                           const float* bv, int head, int h,
                                           int hp, float* q_s, float* wk_s,
                                           float* bk_s, float* wv_s,
                                           float* bv_s) {
  const size_t hh = (size_t)h * h;
  for (int i = threadIdx.x; i < hp * h; i += kThreads) {
    const bool ok = i < h * h;
    wk_s[i] = ok ? wk[head * hh + i] : 0.0f;
    wv_s[i] = ok ? wv[head * hh + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < hp; i += kThreads) {
    const bool ok = i < h;
    q_s[i] = ok ? q[(size_t)head * h + i] : 0.0f;
    bk_s[i] = ok ? bk[(size_t)head * h + i] : 0.0f;
    bv_s[i] = ok ? bv[(size_t)head * h + i] : 0.0f;
  }
}

// The guard and the softmax of head_softmax once every valid score is in
// sc_s: the block's max score and guard from each warp's `mx` and `bad`
// (each warp-uniform), then a = softmax(sc) into a_s (may alias sc_s).
// Returns false, a_s unset, for a guarded head or a day without valid rows.
// Every thread of the block calls it. Ends with __syncthreads.
__device__ __forceinline__ bool finish_softmax(float mx, int bad, int nv, const float* sc_s,
                                               float* a_s) {
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float shared_val;
  __shared__ int shared_bad;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (lane == 0) {
    red_f[warp] = mx;
    red_i[warp] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    float v = kNegInf;
    int b = 0;
    for (int w = 0; w < kWarps; ++w) {
      v = fmaxf(v, red_f[w]);
      b |= red_i[w];
    }
    shared_val = v;
    shared_bad = b;
  }
  __syncthreads();
  if (shared_bad || nv == 0) return false;   // the guard, or a fully masked day
  mx = shared_val;

  // ---- softmax over the valid stocks -------------------------------------
  float sum = 0.0f;
  for (int r = tid; r < nv; r += kThreads) {
    const float e = expf(sc_s[r] - mx);
    a_s[r] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  __syncthreads();            // every red_f read above is done
  if (lane == 0) red_f[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += red_f[w];
    shared_val = v;
  }
  __syncthreads();
  const float denom = shared_val;
  for (int r = tid; r < nv; r += kThreads) a_s[r] = a_s[r] / denom;
  __syncthreads();
  return true;
}

// Scores and softmax weights of one (day, head) over its nv valid rows, with
// the key rows as written:
//
//   s  = (L . Wk + bk) . q / sqrt(H + 1e-6), times the keep-mask kp if any,
//   r  = relu(s) (NaN kept)  -> sc_s[g]
//   a  = softmax of r over the valid rows -> a_s[g] (may alias sc_s)
//
// Returns false, with a_s unset, when the head's context is zero: a valid
// score is non-finite (the guard), or the day has no valid row. Every
// thread of the block calls it, after a __syncthreads() that follows
// compact_rows and stage_head; `tile` is the warp's (kTile, hp) slice.
template <int S>
__device__ bool head_softmax(const float* lat, const int* idx_s, int nv,
                             const float* kp, const float* wk_s,
                             const float* bk_s, const float* q_s, int h,
                             int hp, float* tile, float* sc_s, float* a_s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float scale = sqrtf((float)h + 1e-6f);

  // ---- pass 1: scores of the valid stocks --------------------------------
  float mx = kNegInf;
  int bad = 0;
  for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
    stage_tile(lat, idx_s, g, nv, h, hp, lane, tile);
    float key[kTile][S];
    tile_times<S>(tile, wk_s, bk_s, h, hp, lane, key);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      float part = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (lane + 32 * s < h) part = fmaf(key[t][s], q_s[lane + 32 * s], part);
      float sc = warp_sum(part) / scale;
      if (g + t >= nv) continue;
      if (kp) sc = sc * kp[idx_s[g + t]];
      sc = isnan(sc) ? sc : fmaxf(sc, 0.0f);   // ReLU that keeps NaN
      if (!isfinite(sc)) bad = 1;
      else mx = fmaxf(mx, sc);
      if (lane == 0) sc_s[g + t] = sc;
    }
    __syncwarp();
  }
  return finish_softmax(mx, bad, nv, sc_s, a_s);
}

// ---------------------------------------------------------------------------
// The exact path above kMaxStagedH: Wk and Wv streamed kChunk columns at a time
// ---------------------------------------------------------------------------

// Head `head`'s q, bk and bv (hp, zero padded) into shared memory.
__device__ __forceinline__ void stage_vectors(const float* q, const float* bk,
                                              const float* bv, int head, int h, int hp,
                                              float* q_s, float* bk_s, float* bv_s) {
  for (int i = threadIdx.x; i < hp; i += kThreads) {
    const bool ok = i < h;
    q_s[i] = ok ? q[(size_t)head * h + i] : 0.0f;
    bk_s[i] = ok ? bk[(size_t)head * h + i] : 0.0f;
    bv_s[i] = ok ? bv[(size_t)head * h + i] : 0.0f;
  }
}

// Columns [j0, j0 + kChunk) of a head's matrix w (h x h, device memory)
// into chunk (hp, kChunk), zero in rows >= h and columns >= h; a row's 32
// columns are one 128-byte read. Every thread calls it, between barriers.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ w, int j0, int h,
                                            int hp, float* chunk) {
  for (int e = threadIdx.x; e < hp * kChunk; e += kThreads) {
    const int i = e / kChunk;
    const int j = j0 + e % kChunk;
    chunk[e] = i < h && j < h ? __ldg(w + (size_t)i * h + j) : 0.0f;
  }
}

// tile (kTile, hp) times the chunk (hp, kChunk): out[t] = sum over i of
// tile[t][i] chunk[i][lane], one fmaf chain in i order.
__device__ __forceinline__ void tile_chunk(const float* tile, const float* chunk, int hp,
                                           int lane, float out[kTile]) {
#pragma unroll
  for (int t = 0; t < kTile; ++t) out[t] = 0.0f;
  for (int i = 0; i < hp; i += 4) {
    float4 l[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      l[t] = *reinterpret_cast<const float4*>(tile + t * hp + i);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float w = chunk[(i + c) * kChunk + lane];
#pragma unroll
      for (int t = 0; t < kTile; ++t) out[t] = fmaf(component(l[t], c), w, out[t]);
    }
  }
}

// head_softmax with the key rows' Wk streamed: each valid row's score is
// the sum, in chunk order, of its chunks' warp sums of (L_n . Wk[:, j] +
// bk_j) q_j over the chunk's columns j; then the guard and the softmax of
// finish_softmax. wk: this head's matrix in device memory; chunk: the
// (hp, kChunk) buffer. A sum that meets a non-finite key element is
// non-finite in any order, so the guard is head_softmax's. Every thread of
// the block calls it, after a __syncthreads() that follows compact_rows
// and stage_vectors. Ends with __syncthreads.
__device__ bool head_softmax_streamed(const float* lat, const int* idx_s, int nv,
                                      const float* kp, const float* __restrict__ wk,
                                      const float* bk_s, const float* q_s, int h, int hp,
                                      float* chunk, float* tile, float* sc_s, float* a_s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float scale = sqrtf((float)h + 1e-6f);
  for (int r = tid; r < nv; r += kThreads) sc_s[r] = 0.0f;
  for (int j0 = 0; j0 < h; j0 += kChunk) {
    __syncthreads();          // sc_s is zeroed; the last chunk's readers are done
    stage_chunk(wk, j0, h, hp, chunk);
    __syncthreads();
    const int j = j0 + lane;
    const bool on = j < h;
    const float qj = on ? q_s[j] : 0.0f;
    const float bj = on ? bk_s[j] : 0.0f;
    for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
      stage_tile(lat, idx_s, g, nv, h, hp, lane, tile);
      float key[kTile];
      tile_chunk(tile, chunk, hp, lane, key);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float part = warp_sum(on ? (key[t] + bj) * qj : 0.0f);
        if (lane == 0 && g + t < nv) sc_s[g + t] += part;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  float mx = kNegInf;
  int bad = 0;
  for (int r = tid; r < nv; r += kThreads) {
    float sc = sc_s[r] / scale;
    if (kp) sc = sc * kp[idx_s[r]];
    sc = isnan(sc) ? sc : fmaxf(sc, 0.0f);     // ReLU that keeps NaN
    if (!isfinite(sc)) bad = 1;
    else mx = fmaxf(mx, sc);
    sc_s[r] = sc;
  }
  return finish_softmax(warp_max(mx), __any_sync(0xffffffffu, bad), nv, sc_s, a_s);
}

// ---------------------------------------------------------------------------
// The wide design (H > 64): weight work once per launch, the day's rows
// staged across a cluster
// ---------------------------------------------------------------------------

// Phase marks of the wide day kernels, for scripts/torch_attention_phases.py,
// which defines them before this header; nothing otherwise.
#ifndef ATTN_PHASE
#define ATTN_PHASE_START
#define ATTN_PHASE(i)
#endif

constexpr int kPrepRows = 4;     // weight rows a warp of the prep kernels takes at once
constexpr int kSumSlices = 4;    // fixed runs of rows of a wide column sum
constexpr int kCtxCols = 32;     // columns of a tile of K4's context kernel
constexpr int kCtxDays = 8;      // days it takes at once
constexpr int kCtxParts = kThreads / kCtxCols;   // fixed runs of i of a context sum
constexpr int kLatRows = 16;     // stocks of a tile of K5's wide latent kernel
constexpr int kLatCols = 32;     // columns of that tile
constexpr int kLatHeads = 32;    // heads it stages at once

// The CTAs of a day's cluster: 2 up to H = 128, 4 above, CTA `rank` owning
// columns [slice_begin(rank), slice_begin(rank + 1)) of the hidden units,
// at most 64. A function of H alone, so the partial sums a score is made
// of are the same at every group size and lane count.
__host__ __device__ __forceinline__ int wide_cluster(int h) { return h <= 128 ? 2 : 4; }

__host__ __device__ __forceinline__ int slice_width(int h) {
  const int c = wide_cluster(h);
  return round4((h + c - 1) / c);
}

__host__ __device__ __forceinline__ int slice_begin(int rank, int h) {
  const int c0 = rank * slice_width(h);
  return c0 < h ? c0 : h;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Offsets, in floats, into a wide day CTA's dynamic shared memory for n
// rows, hidden size h and groups of g heads; the exact path's arrays
// (`layout`) share the space after the row list.
struct WideLayout {
  int ldn, gp, gt;         // as in Layout
  int sw, ld;              // slice width; row stride of the staged slice (sw + 4 where
                           // H is a multiple of 4, read as float4; else sw + 1, odd)
  int idx;                 // (n) valid rows, as ints
  int rows;                // (n, ld) the slice of the valid rows, when staged
  int v, v2;               // (sw, gp): u's slice; the backward: w's slice
  int cv, cv2;             // (gp): c; the backward: cw
  int p, p2;               // (g, ldn): partial scores; the backward: partial da
  int sc, a, d;            // (g, ldn): scores, weights (the forward: = sc), da / dz
  int at, dt;              // the backward: (n, gt) a and dz, transposed
  int kp;                  // (g, ldn): the keep-mask of the valid rows, in list order
                           // (with a keep-mask)
  int sa, ok, flag;        // (gp) sum of a; (gp ints) the head is not guarded; this
                           // CTA's slice holds a non-finite valid element
  int part;                // (4 kSumSlices sw quads, twice for the backward) a column
                           // sum's partial sums (the forward: over p)
  int total;
};

__host__ __device__ inline WideLayout wide_layout(int n, int h, int g, bool staged, bool bwd,
                                                  bool keep) {
  WideLayout L;
  L.ldn = round4(n);
  L.gp = round4(g);
  L.gt = g == 1 ? 1 : L.gp == 4 ? 4 : L.gp + 4;
  L.sw = slice_width(h);
  L.ld = L.sw + ((h & 3) == 0 ? 4 : 1);
  const int part = (bwd ? 8 : 4) * kSumSlices * L.sw * (L.gp >> 2);
  int o = 0;
  L.idx = o;
  o += L.ldn;
  L.rows = o;
  if (staged) o += round4(n * L.ld);
  L.v = L.v2 = o;
  o += L.sw * L.gp;
  if (bwd) {
    L.v2 = o;
    o += L.sw * L.gp;
  }
  L.cv = L.cv2 = o;
  o += L.gp;
  if (bwd) {
    L.cv2 = o;
    o += L.gp;
  }
  // the forward's column sums reuse the partial scores' space (the peers
  // read it only before the second cluster barrier); the backward's have
  // their own
  L.p = L.p2 = L.part = o;
  o += bwd || g * L.ldn >= part ? g * L.ldn : part;
  if (bwd) {
    L.p2 = o;
    o += g * L.ldn;
  }
  L.sc = L.a = o;
  o += g * L.ldn;
  L.d = o;
  if (bwd) {
    L.a = o;
    o += g * L.ldn;
    L.d = o;
    o += g * L.ldn;
  }
  L.at = L.dt = o;          // the forward's column sums read a from sc: no at
  if (bwd) {
    o += round4(n * L.gt);
    L.dt = o;
    o += round4(n * L.gt);
  }
  L.kp = o;
  if (keep) o += g * L.ldn;
  L.sa = o;
  o += L.gp;
  L.ok = o;
  o += L.gp;
  L.flag = o;
  o += 4;
  if (bwd) {
    L.part = o;
    o += part;
  }
  const int exact = layout(n, h, g, false, bwd).total;
  L.total = o > exact ? o : exact;
  return L;
}

// plan_smem for the wide day kernels.
inline int plan_wide_smem(int n, int h, int g, bool bwd, bool keep, int* staged) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int s = 1; s >= 0; --s) {
    const long long bytes =
        (long long)sizeof(float) * wide_layout(n, h, g, s, bwd, keep).total;
    if (bytes + kSmemSlack <= limit) {
      *staged = s;
      return (int)bytes;
    }
  }
  return -1;
}

// A lane's part of a weight row times a vector, one fmaf chain: columns j =
// lane + 32 s in s order (any H), or, where H is a multiple of 4, the four
// columns 128 f + 4 lane + (0..3) of its float4 f, in f order.
template <int S>
__device__ __forceinline__ float lane_dot(const float (&m)[S], const float (&x)[S],
                                          const bool (&on)[S]) {
  float part = on[0] ? fmaf(m[0], x[0], 0.0f) : 0.0f;
#pragma unroll
  for (int s = 1; s < S; ++s)
    if (on[s]) part = fmaf(m[s], x[s], part);
  return part;
}

template <int F>
__device__ __forceinline__ float lane_dot4(const float4 (&m)[F], const float4 (&x)[F],
                                           const bool (&on)[F]) {
  float part = 0.0f;
#pragma unroll
  for (int f = 0; f < F; ++f)
    if (on[f]) {
      part = fmaf(m[f].x, x[f].x, part);
      part = fmaf(m[f].y, x[f].y, part);
      part = fmaf(m[f].z, x[f].z, part);
      part = fmaf(m[f].w, x[f].w, part);
    }
  return part;
}

// The lane's share of row `row` (< h: of mat, = h: the bias) of head `head`
// times the vector x, `lane_dot` or `lane_dot4` (F = S / 4 float4 a lane),
// then the warp's butterfly sum: one summation order per H, whatever the
// grid.
template <int S>
struct PrepRow {
  static constexpr int F = S / 4;
  bool vec4;                // H is a multiple of 4: float4 reads
  bool on[S];
  bool on4[F];
  int jc[S];
  int j4[F];

  __device__ __forceinline__ PrepRow(int h, int lane) : vec4((h & 3) == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = lane + 32 * s;
      on[s] = j < h;
      jc[s] = on[s] ? j : 0;
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int j = 128 * f + 4 * lane;
      on4[f] = j < h;
      j4[f] = on4[f] ? j : 0;
    }
  }
};

// The weight products no day changes, once per launch, for the rows o <
// K (H + 1) of one lane's heads (head k = o / (H + 1), row i = o % (H + 1)):
//
//   u[k H + i] = Wk[k, i, :] . q[k] (i < H),   c[k] = bk[k] . q[k] (i = H),
//
// and with wv (the backward), for each day b < B:
//
//   w[(b K + k) w_ld + i] = Wv[k, i, :] . dctx[b, k],   cw[b K + k] = bv[k] . dctx[b, k].
//
// A warp takes kPrepRows rows at once (every row's load, Wk's and Wv's, in
// flight before the first sum) and reads each vector at its use; the sums
// are PrepRow's.
// K4's and K5's prep kernels call this one function, so K5's scores and
// softmax weights are bitwise K4's.
template <int S>
__device__ __forceinline__ void prep_rows(const float* __restrict__ q,
                                          const float* __restrict__ wk,
                                          const float* __restrict__ bk,
                                          const float* __restrict__ wv,
                                          const float* __restrict__ bv,
                                          const float* __restrict__ dctx, float* u, float* c,
                                          float* w, int w_ld, float* cw, int b_days,
                                          int k_heads, int h) {
  constexpr int F = S / 4;
  const int lane = threadIdx.x & 31;
  const int rows = k_heads * (h + 1);
  const int o0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPrepRows;
  if (o0 >= rows) return;
  const PrepRow<S> pr(h, lane);
  int head[kPrepRows], row[kPrepRows];
#pragma unroll
  for (int r = 0; r < kPrepRows; ++r) {
    const int o = min(o0 + r, rows - 1);
    head[r] = o / (h + 1);
    row[r] = o - head[r] * (h + 1);
  }
  // Wk's rows (a head's bias as its row h) and, for the backward, Wv's
  // loaded, then u and c, then w and cw day by day
  auto run = [&](auto& mk, auto& mv, auto load, auto dot, auto vecload) {
    load(wk, bk, mk);
    if (wv != nullptr) load(wv, bv, mv);
#pragma unroll
    for (int r = 0; r < kPrepRows; ++r) {
      const float acc = warp_sum(dot(mk[r], vecload(q + (size_t)head[r] * h)));
      if (lane == 0 && o0 + r < rows) {
        if (row[r] < h) u[(size_t)head[r] * h + row[r]] = acc;
        else c[head[r]] = acc;
      }
    }
    if (wv == nullptr) return;
    for (int b = 0; b < b_days; ++b) {
#pragma unroll
      for (int r = 0; r < kPrepRows; ++r) {
        const size_t bkr = (size_t)b * k_heads + head[r];
        const float acc = warp_sum(dot(mv[r], vecload(dctx + bkr * h)));
        if (lane == 0 && o0 + r < rows) {
          if (row[r] < h) w[bkr * w_ld + row[r]] = acc;
          else cw[bkr] = acc;
        }
      }
    }
  };
  auto row_ptr = [&](const float* mat, const float* bias, int r) {
    return row[r] < h ? mat + ((size_t)head[r] * h + row[r]) * h : bias + (size_t)head[r] * h;
  };
  if (pr.vec4) {
    struct V { float4 v[F]; };
    V mk[kPrepRows], mv[kPrepRows];
    run(mk, mv,
        [&](const float* mat, const float* bias, V (&m)[kPrepRows]) {
#pragma unroll
          for (int r = 0; r < kPrepRows; ++r) {
            const float* mp = row_ptr(mat, bias, r);
#pragma unroll
            for (int f = 0; f < F; ++f)
              m[r].v[f] = __ldg(reinterpret_cast<const float4*>(mp + pr.j4[f]));
          }
        },
        [&](const V& m, const V& x) { return lane_dot4<F>(m.v, x.v, pr.on4); },
        [&](const float* xp) {
          V x;
#pragma unroll
          for (int f = 0; f < F; ++f) x.v[f] = __ldg(reinterpret_cast<const float4*>(xp + pr.j4[f]));
          return x;
        });
  } else {
    struct V { float v[S]; };
    V mk[kPrepRows], mv[kPrepRows];
    run(mk, mv,
        [&](const float* mat, const float* bias, V (&m)[kPrepRows]) {
#pragma unroll
          for (int r = 0; r < kPrepRows; ++r) {
            const float* mp = row_ptr(mat, bias, r);
#pragma unroll
            for (int s = 0; s < S; ++s) m[r].v[s] = __ldg(mp + pr.jc[s]);
          }
        },
        [&](const V& m, const V& x) { return lane_dot<S>(m.v, x.v, pr.on); },
        [&](const float* xp) {
          V x;
#pragma unroll
          for (int s = 0; s < S; ++s) x.v[s] = __ldg(xp + pr.jc[s]);
          return x;
        });
  }
}

// Grid of the prep kernels: blocks of kWarps warps of kPrepRows rows.
__host__ __device__ __forceinline__ int prep_blocks(int k_heads, int h) {
  const int per = kWarps * kPrepRows;
  return (k_heads * (h + 1) + per - 1) / per;
}

// Columns [c0, c0 + cw) of the day's nv valid rows into rows_s (row r at
// r * ld) when staged, and whether any of those elements is non-finite, on
// every thread. Staged, H a multiple of 4: a 16-byte cp.async per four
// columns (every copy in flight at once, no register held), then the check
// on the copies; otherwise each thread loads kStageBatch elements before it
// checks (and stores) them. With keep, the keep-mask of the G heads' valid
// rows too (4-byte cp.async), in list order: kp_s[g ldn + r] = keep[g n +
// idx[r]]. Every thread calls it after compact_rows; ends with a barrier.
__device__ __forceinline__ bool stage_slice(const float* lat, const int* idx, int nv, int h,
                                            int c0, int cw, int ld, bool staged,
                                            float* rows_s, const float* keep, int G, int n,
                                            int ldn, float* kp_s) {
  int bad = 0;
  const bool copies = staged && (h & 3) == 0;
  const int q4 = cw >> 2;
  if (copies)
    for (int e = threadIdx.x; e < nv * q4; e += kThreads) {
      const int r = e / q4;
      const int c = (e - r * q4) << 2;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(rows_s + r * ld + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(lat + (size_t)idx[r] * h + c0 + c) : "memory");
    }
  if (keep)
    for (int e = threadIdx.x; e < G * nv; e += kThreads) {
      const int g = e / nv;
      const int r = e - g * nv;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(kp_s + g * ldn + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(keep + (size_t)g * n + idx[r]) : "memory");
    }
  if (copies) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int e = threadIdx.x; e < nv * q4; e += kThreads) {   // each thread its own copies
      const int r = e / q4;
      const float4 v = *reinterpret_cast<const float4*>(rows_s + r * ld + ((e - r * q4) << 2));
      bad |= !isfinite(v.x) || !isfinite(v.y) || !isfinite(v.z) || !isfinite(v.w);
    }
    return __syncthreads_or(bad) != 0;
  }
  const int total = nv * cw;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * kThreads) {
    float v[kStageBatch];
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int e = min(e0 + k * kThreads, total - 1);
      const int r = e / cw;
      v[k] = __ldg(lat + (size_t)idx[r] * h + c0 + (e - r * cw));
    }
#pragma unroll
    for (int k = 0; k < kStageBatch; ++k) {
      const int e = e0 + k * kThreads;
      if (e < total) {
        const int r = e / cw;
        bad |= !isfinite(v[k]);
        if (staged) rows_s[r * ld + (e - r * cw)] = v[k];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  return __syncthreads_or(bad) != 0;
}

// The partial sums of a CTA's column slice: p[g ldn + r] = sum over c < cw
// of row(r)[c] v[c gp + g] for r < nv, g < G, one fmaf chain in c order,
// four heads a thread; with kTwo the same of v2 into p2 from the same row
// reads. v, v2: (cw, gp) in shared memory. vec4 (H a multiple of 4, so
// every row and cw are): the row read four columns at a time. Ends with
// __syncthreads.
template <bool kTwo>
__device__ __forceinline__ void slice_dots(const Rows& rows, int nv, int cw, const float* v,
                                           const float* v2, int G, int gp, float* p,
                                           float* p2, int ldn, bool vec4) {
  const int quads = gp >> 2;
  for (int t = threadIdx.x; t < nv * quads; t += kThreads) {
    const int r = t % nv;
    const int g0 = (t / nv) * 4;
    const float* x = rows.row(r);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    auto step = [&](float l, int c) {
      const float4 vv = *reinterpret_cast<const float4*>(v + c * gp + g0);
      a[0] = fmaf(l, vv.x, a[0]);
      a[1] = fmaf(l, vv.y, a[1]);
      a[2] = fmaf(l, vv.z, a[2]);
      a[3] = fmaf(l, vv.w, a[3]);
      if constexpr (kTwo) {
        const float4 ww = *reinterpret_cast<const float4*>(v2 + c * gp + g0);
        b[0] = fmaf(l, ww.x, b[0]);
        b[1] = fmaf(l, ww.y, b[1]);
        b[2] = fmaf(l, ww.z, b[2]);
        b[3] = fmaf(l, ww.w, b[3]);
      }
    };
    if (vec4) {             // four columns a read; the same chain in c order
#pragma unroll 2
      for (int c = 0; c < cw; c += 4) {
        const float4 l = *reinterpret_cast<const float4*>(x + c);
        step(l.x, c);
        step(l.y, c + 1);
        step(l.z, c + 2);
        step(l.w, c + 3);
      }
    } else {
#pragma unroll 4
      for (int c = 0; c < cw; ++c) step(x[c], c);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (g0 + k >= G) break;
      p[(g0 + k) * ldn + r] = a[k];
      if constexpr (kTwo) p2[(g0 + k) * ldn + r] = b[k];
    }
  }
  __syncthreads();
}

// out[g ldn + r] = (p_0 + p_1 + ... + p_{cs-1})[g ldn + r] + cv[g] for r <
// nv, g < G: the partial sums of the cluster's ranks in rank order (DSMEM
// loads), then the bias term. Call between two cluster barriers.
__device__ __forceinline__ void cluster_sum(const float* p, const float* cv, float* out,
                                            int nv, int G, int ldn, int cs) {
  for (int t = threadIdx.x; t < G * nv; t += kThreads) {
    const int g = t / nv;
    const int e = g * ldn + t - g * nv;
    float acc = load_cluster(p + e, 0);
    for (int q = 1; q < cs; ++q) acc += load_cluster(p + e, q);
    out[e] = acc + cv[g];
  }
}

// out[g ostride + c] = sum over r < nv of coef[r rs + g gs] row(r)[c] for c
// < cw, g < G: the rows cut into kSumSlices fixed runs of ceil(nv /
// kSumSlices), each an fmaf chain, the runs summed in order (an order no
// group size, cluster or lane count changes). part: 4 kSumSlices cw
// ceil(G / 4) floats of shared memory; out in device or shared memory.
// Ends with __syncthreads.
__device__ __forceinline__ void slice_column_sums(const Rows& rows, int nv, int cw,
                                                  const float* coef, int rs, int gs, int G,
                                                  float* part, float* out, int ostride) {
  const int pairs = cw * ((G + 3) >> 2);
  const int chunk = (nv + kSumSlices - 1) / kSumSlices;
  for (int t = threadIdx.x; t < pairs * kSumSlices; t += kThreads) {
    const int pair = t % pairs;
    const int sl = t / pairs;
    const int g0 = (pair / cw) * 4;
    const int c = pair - (g0 >> 2) * cw;
    const int r1 = min(nv, (sl + 1) * chunk);
    const int gn = min(4, G - g0);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int r = sl * chunk; r < r1; ++r) {
      const float l = rows.row(r)[c];
      const float* cf = coef + r * rs + g0 * gs;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < gn) a[k] = fmaf(cf[k * gs], l, a[k]);
    }
    float* pt = part + 4 * t;
#pragma unroll
    for (int k = 0; k < 4; ++k) pt[k] = a[k];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < pairs * 4; e += kThreads) {
    const int pair = e >> 2;
    const int k = e & 3;
    const int g0 = (pair / cw) * 4;
    if (g0 + k >= G) continue;
    float acc = part[e];
    for (int sl = 1; sl < kSumSlices; ++sl) acc += part[4 * (sl * pairs + pair) + k];
    out[(g0 + k) * ostride + pair - (g0 >> 2) * cw] = acc;
  }
  __syncthreads();
}

// fold_softmax with the keep-mask in list order (kp_s[g ldn + r], or null):
// for each head g < G (warp g % kWarps) over the nv valid rows,
//   r = relu(s / sqrt(H + 1e-6) * keep) in place in sc (a ReLU that keeps NaN),
//   ok[g] = no r is non-finite (the guard) and nv > 0,
//   a = softmax(r) into a (may alias sc; a guarded head's a is left unset)
//       and, unless a_t is null, into a_t[r * gt + g] (zero for a guarded
//       head),
//   sa[g] = sum a, 0 if !ok[g].
// Ends with __syncthreads.
__device__ __forceinline__ void wide_softmax(float* sc, float* a, int ldn, float* a_t,
                                             int gt, int nv, const float* kp_s, int G,
                                             float scale, int* ok, float* sa) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int g = warp; g < G; g += kWarps) {
    float* s = sc + g * ldn;
    float* ag = a + g * ldn;
    const float* kp = kp_s ? kp_s + g * ldn : nullptr;
    float mx = kNegInf;
    int bad = 0;
#pragma unroll 4
    for (int r = lane; r < nv; r += 32) {
      float v = s[r] / scale;
      if (kp) v = v * kp[r];
      v = isnan(v) ? v : fmaxf(v, 0.0f);
      if (!isfinite(v)) bad = 1;
      else mx = fmaxf(mx, v);
      s[r] = v;
    }
    mx = warp_max(mx);
    const bool good = !__any_sync(0xffffffffu, bad) && nv > 0;
    float tot = 0.0f;
    if (good) {
      float sum = 0.0f;
      for (int r = lane; r < nv; r += 32) {
        const float e = expf(s[r] - mx);
        ag[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int r = lane; r < nv; r += 32) {
        const float w = ag[r] / sum;
        ag[r] = w;
        if (a_t) a_t[r * gt + g] = w;
        tot += w;
      }
      tot = warp_sum(tot);
    } else if (a_t) {
      for (int r = lane; r < nv; r += 32) a_t[r * gt + g] = 0.0f;
    }
    if (lane == 0) {
      ok[g] = good;
      sa[g] = tot;
    }
  }
  __syncthreads();
}

// Two slice_column_sums from one pass over the rows: out1 of coef1_t and
// out2 of coef2_t, each summed as slice_column_sums sums (so each is
// bitwise what slice_column_sums gives). part: 8 kSumSlices cw ceil(G / 4)
// floats. Ends with __syncthreads.
__device__ __forceinline__ void slice_column_sums2(const Rows& rows, int nv, int cw,
                                                   const float* coef1_t, const float* coef2_t,
                                                   int gt, int G, float* part, float* out1,
                                                   float* out2, int ostride) {
  const int pairs = cw * ((G + 3) >> 2);
  const int chunk = (nv + kSumSlices - 1) / kSumSlices;
  for (int t = threadIdx.x; t < pairs * kSumSlices; t += kThreads) {
    const int pair = t % pairs;
    const int sl = t / pairs;
    const int g0 = (pair / cw) * 4;
    const int c = pair - (g0 >> 2) * cw;
    const int r1 = min(nv, (sl + 1) * chunk);
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
    for (int r = sl * chunk; r < r1; ++r) {
      const float l = rows.row(r)[c];
      const float4 c1 = gt == 1 ? float4{coef1_t[r], 0.0f, 0.0f, 0.0f}
                               : *reinterpret_cast<const float4*>(coef1_t + r * gt + g0);
      const float4 c2 = gt == 1 ? float4{coef2_t[r], 0.0f, 0.0f, 0.0f}
                               : *reinterpret_cast<const float4*>(coef2_t + r * gt + g0);
      a[0] = fmaf(c1.x, l, a[0]);
      a[1] = fmaf(c1.y, l, a[1]);
      a[2] = fmaf(c1.z, l, a[2]);
      a[3] = fmaf(c1.w, l, a[3]);
      b[0] = fmaf(c2.x, l, b[0]);
      b[1] = fmaf(c2.y, l, b[1]);
      b[2] = fmaf(c2.z, l, b[2]);
      b[3] = fmaf(c2.w, l, b[3]);
    }
    float* pt = part + 8 * t;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pt[k] = a[k];
      pt[4 + k] = b[k];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < pairs * 8; e += kThreads) {
    const int pair = e >> 3;
    const int k = e & 7;
    const int g0 = (pair / cw) * 4;
    if (g0 + (k & 3) >= G) continue;
    float acc = part[e];
    for (int sl = 1; sl < kSumSlices; ++sl) acc += part[8 * (sl * pairs + pair) + k];
    (k < 4 ? out1 : out2)[(g0 + (k & 3)) * ostride + pair - (g0 >> 2) * cw] = acc;
  }
  __syncthreads();
}

// A wide day CTA's slice of u (and of w) and c (and cw) for its G heads
// into shared memory: v[c gp + g] = u[(head0 + g) u_ld + c0 + c], zero for
// g >= G and c >= cw. Every thread calls it; a barrier follows before use.
__device__ __forceinline__ void stage_vectors_slice(const float* u, int u_ld, const float* cu,
                                                    int head0, int G, int gp, int sw, int c0,
                                                    int cw, float* v, float* cv) {
  for (int e = threadIdx.x; e < sw * gp; e += kThreads) {
    const int c = e / gp;
    const int g = e - c * gp;
    v[e] = g < G && c < cw ? u[(size_t)(head0 + g) * u_ld + c0 + c] : 0.0f;
  }
  for (int g = threadIdx.x; g < gp; g += kThreads) cv[g] = g < G ? cu[head0 + g] : 0.0f;
}

}  // namespace attn
