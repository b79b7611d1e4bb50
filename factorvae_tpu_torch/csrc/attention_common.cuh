// Device code shared by the K-head attention forward (K4, attention_fwd.cu)
// and backward (K5, attention_bwd.cu).
//
// A CTA takes one day and a group of G consecutive heads. It compacts the
// day's valid rows into a list, stages them in shared memory when they fit
// (else it reads them from device memory through the list), and notes
// whether any element of a valid row is non-finite.
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
//
// Hidden sizes: the kernels are templated on S, the columns of H a lane
// owns where a warp spans H: S = 1 (H <= 32), 2 (H <= 64), 4 (H <= 128) and
// 8 (H <= 256), one instance per class, picked per launch. The S <= 2
// instances are the tuned code, unchanged. Above H = 64 the exact path no
// longer stages a head's Wk and Wv whole (2 x 256 x 257 floats, 526 KB, at
// H = 256): it streams them through shared memory kChunk columns at a time
// (`stage_chunk`, `head_softmax_streamed`), a lane per column of the chunk,
// and sums each score and each da over the chunks in order.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

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

}  // namespace attn
