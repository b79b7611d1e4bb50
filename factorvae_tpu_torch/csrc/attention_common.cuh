// Device code shared by the K-head attention forward (K4, attention_fwd.cu)
// and backward (K5, attention_bwd.cu): one block per (day, head) compacts the
// day's valid rows, stages the head's weights, and computes the scores and
// softmax weights exactly as the forward does, so the backward recomputes
// the forward's own numbers.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxH = 64;            // largest hidden size (2 columns per lane)
constexpr int kTile = 8;             // valid rows per warp step
constexpr float kNegInf = -1e30f;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float nan_to_num_f(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? FLT_MAX : -FLT_MAX;
  return v;
}

__device__ __forceinline__ float component(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

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

// Warp 0 writes the indices of the day's valid rows, in order, to idx_s and
// their count to *nv_s.
__device__ __forceinline__ void compact_rows(const unsigned char* m, int n,
                                             int* idx_s, int* nv_s) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  int base = 0;
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    const bool v = r < n && m[r];
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    if (v) idx_s[base + __popc(bal & ((1u << lane) - 1u))] = r;
    base += __popc(bal);
  }
  if (lane == 0) *nv_s = base;
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

// Scores and softmax weights of one (day, head) over its nv valid rows:
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
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float shared_val;
  __shared__ int shared_bad;
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

}  // namespace attn
