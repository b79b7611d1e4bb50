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
// no valid row, gives exactly zero to every gradient. The mask and the
// keep-mask get none.
//
// Both dkey and dV are rank one per (day, head), so every product with L or
// a weight reduces to vectors:
//
//   lz = L^T dz,  la = L^T a  (H)        dWk[k] = (sum_b lz) (x) q
//   dbk[k] = (sum_b sum dz) q            dq[k]  = Wk^T (sum_b lz) + bk sum_b sum dz
//   dWv[k] = sum_b la (x) dctx           dbv[k] = sum_b (sum a) dctx
//   dL[b, n] = sum_k dz[b,k,n] u_k + a[b,k,n] w_bk,  u_k = Wk q,  w_bk = Wv dctx
//
// Three kernels, launched in order on one stream:
//   1. one block per (day, head): recompute scores and softmax with K4's own
//      code (attention_common.cuh), the value rows for da (the (K, N, H) key
//      and value stacks never touch device memory), then dz, and write a and
//      dz per stock (B, K, N) and lz, la, sum dz, sum a, w per (day, head);
//   2. one block per head: sum those over the days in day order and form dq,
//      dWk, dbk, dWv, dbv and u;
//   3. one thread per (day, stock, column): dL summed over heads in head
//      order.
// Every sum runs in a fixed order, so a repeated call gives bitwise the same
// gradients; there are no atomics.
//
// Bound: at one flagship day (N = 304, ~300 valid, K = 96, H = 64) the work
// the function needs is the value product per valid row and head (2*H*H) and
// O(H) terms, about 0.27 GFLOP against 0.9 MB of inputs, so the f32 CUDA-core
// rate bounds it. Kernel 1 also recomputes the key product as K4 writes it,
// which doubles that; kernels 2 and 3 are a few MFLOP. At one day kernel 1 runs
// 96 blocks on 132 SMs; the grid is what keeps it far from the bound.

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

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
                          int n, int k_heads, int h) {
  extern __shared__ float4 smem4[];
  const int hp = round4(h);
  float* smem = reinterpret_cast<float*>(smem4);
  float* wk_s = smem;                        // (hp, H), rows >= h zero
  float* wv_s = wk_s + hp * h;               // (hp, H)
  float* tile_s = wv_s + hp * h;             // (kWarps, kTile, hp)
  float* q_s = tile_s + kWarps * kTile * hp; // (hp,)
  float* bk_s = q_s + hp;                    // (hp,)
  float* bv_s = bk_s + hp;                   // (hp,)
  float* dc_s = bv_s + hp;                   // (hp,) dctx of this (day, head)
  float* sc_s = dc_s + hp;                   // (N,) scores r
  float* a_s = sc_s + n;                     // (N,) softmax weights
  float* dz_s = a_s + n;                     // (N,) da, then dz
  int* idx_s = reinterpret_cast<int*>(dz_s + n);  // (N,) valid rows
  __shared__ float red_f[kWarps];
  __shared__ float shared_val;
  __shared__ int shared_nv;

  const int day = blockIdx.x / k_heads;
  const int head = blockIdx.x - day * k_heads;
  const size_t bk_idx = (size_t)day * k_heads + head;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  compact_rows(mask + (size_t)day * n, n, idx_s, &shared_nv);
  stage_head(q, wk, bk, wv, bv, head, h, hp, q_s, wk_s, bk_s, wv_s, bv_s);
  for (int i = tid; i < hp; i += kThreads) dc_s[i] = i < h ? dctx[bk_idx * h + i] : 0.0f;
  __syncthreads();

  const int nv = shared_nv;
  const float* lat = latent + (size_t)day * n * h;
  const float* kp = keep ? keep + bk_idx * n : nullptr;
  float* vec = vec_out + bk_idx * 3 * h;
  float* tile = tile_s + warp * kTile * hp;

  if (!head_softmax<S>(lat, idx_s, nv, kp, wk_s, bk_s, q_s, h, hp, tile, sc_s, a_s)) {
    // a zero context: no gradient (a_out and dz_out come zeroed)
    for (int i = tid; i < 3 * h; i += kThreads) vec[i] = 0.0f;
    if (tid < 2) sum_out[bk_idx * 2 + tid] = 0.0f;
    return;
  }

  // ---- da = nan_to_num(value) . dctx for each valid stock ----------------
  for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
    stage_tile(lat, idx_s, g, nv, h, hp, lane, tile);
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
    if (kp) dz = dz * kp[idx_s[g]];
    dz_s[g] = dz;
    a_out[bk_idx * n + idx_s[g]] = a;
    dz_out[bk_idx * n + idx_s[g]] = dz;
  }
  __syncthreads();

  // ---- lz = L^T dz, la = L^T a, w = Wv dctx, sum dz, sum a ---------------
  if (tid < h) {
    float acc = 0.0f;
    for (int g = 0; g < nv; ++g) acc = fmaf(dz_s[g], lat[(size_t)idx_s[g] * h + tid], acc);
    vec[tid] = acc;
  } else if (tid >= kMaxH && tid < kMaxH + h) {
    const int i = tid - kMaxH;
    float acc = 0.0f;
    for (int g = 0; g < nv; ++g) acc = fmaf(a_s[g], lat[(size_t)idx_s[g] * h + i], acc);
    vec[h + i] = acc;
  } else if (tid >= 2 * kMaxH && tid < 2 * kMaxH + h) {
    const int i = tid - 2 * kMaxH;
    float acc = 0.0f;
    for (int j = 0; j < h; ++j) acc = fmaf(wv_s[i * h + j], dc_s[j], acc);
    vec[2 * h + i] = acc;
  } else if (tid == 3 * kMaxH || tid == 3 * kMaxH + 1) {
    const float* v = tid == 3 * kMaxH ? dz_s : a_s;
    float acc = 0.0f;
    for (int g = 0; g < nv; ++g) acc += v[g];
    sum_out[bk_idx * 2 + (tid - 3 * kMaxH)] = acc;
  }
}

// One block per head: the weight gradients, summed over the days in order,
// and u = Wk q for the latent pass.
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
  const int head = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t hh = (size_t)h * h;
  const float* wk_k = wk + head * hh;

  if (tid < h) {
    float acc = 0.0f;
    for (int b = 0; b < b_days; ++b) acc += vec[(((size_t)b * k_heads + head) * 3) * h + tid];
    lz_s[tid] = acc;
    q_s[tid] = q[(size_t)head * h + tid];
  } else if (tid == kMaxH) {
    float acc = 0.0f;
    for (int b = 0; b < b_days; ++b) acc += sums[((size_t)b * k_heads + head) * 2];
    sdz_s = acc;
  }
  __syncthreads();

  for (int e = tid; e < h * h; e += kThreads) {
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
    dbk[(size_t)head * h + j] = sdz_s * q_s[j];
    float acc = 0.0f;
    for (int i = 0; i < h; ++i) acc = fmaf(lz_s[i], wk_k[i * h + j], acc);
    dq[(size_t)head * h + j] = acc + bk[(size_t)head * h + j] * sdz_s;
    float accv = 0.0f;
    for (int b = 0; b < b_days; ++b) {
      const size_t bk_idx = (size_t)b * k_heads + head;
      accv = fmaf(sums[bk_idx * 2 + 1], dctx[bk_idx * h + j], accv);
    }
    dbv[(size_t)head * h + j] = accv;
    float accu = 0.0f;
    for (int c = 0; c < h; ++c) accu = fmaf(wk_k[j * h + c], q_s[c], accu);
    u[(size_t)head * h + j] = accu;
  }
}

// dL[b, n, i] = sum_k dz[b,k,n] u[k,i] + a[b,k,n] w[b,k,i], heads in order.
__global__ void attention_bwd_latent_kernel(const float* __restrict__ a,
                                            const float* __restrict__ dz,
                                            const float* __restrict__ u,
                                            const float* __restrict__ vec,
                                            float* __restrict__ dlatent,
                                            int b_days, int n, int k_heads, int h) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)b_days * n * h) return;
  const int i = (int)(e % h);
  const size_t bn = e / h;
  const int b = (int)(bn / n);
  const int row = (int)(bn - (size_t)b * n);
  float acc = 0.0f;
  for (int k = 0; k < k_heads; ++k) {
    const size_t bk_idx = (size_t)b * k_heads + k;
    acc = fmaf(dz[bk_idx * n + row], u[(size_t)k * h + i], acc);
    acc = fmaf(a[bk_idx * n + row], vec[(bk_idx * 3 + 2) * h + i], acc);
  }
  dlatent[e] = acc;
}

template <int S>
int launch_head(const float* latent, const unsigned char* mask,
                const float* keep, const float* q, const float* wk,
                const float* bk, const float* wv, const float* bv,
                const float* dctx, float* a, float* dz, float* vec, float* sums,
                int b, int n, int k_heads, int h, cudaStream_t stream) {
  const int hp = round4(h);
  const int smem = (int)sizeof(float) *
                   (2 * hp * h + kWarps * kTile * hp + 4 * hp + 4 * n);
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_head_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  attention_bwd_head_kernel<S><<<b * k_heads, kThreads, smem, stream>>>(
      latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, n, k_heads, h);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int attention_bwd_max_hidden() { return kMaxH; }

// Floats of scratch the wrapper allocates, zeroed: a and dz (B, K, N), then
// lz, la, w (B, K, 3, H), sum dz and sum a (B, K, 2), u (K, H).
extern "C" long long attention_bwd_scratch_floats(int b, int n, int k_heads, int h) {
  const long long bk = (long long)b * k_heads;
  return 2 * bk * n + bk * 3 * h + bk * 2 + (long long)k_heads * h;
}

// Launches the three kernels on `stream`; returns the first cudaError_t (0 = ok).
// An N whose scores and row lists do not fit in one block's shared memory is
// refused by cudaFuncSetAttribute (above N of about 12,000 at H = 64).
extern "C" int attention_bwd(const float* latent, const unsigned char* mask,
                             const float* keep, const float* q,
                             const float* wk, const float* bk,
                             const float* wv, const float* bv,
                             const float* dctx, float* dlatent, float* dq,
                             float* dwk, float* dbk, float* dwv, float* dbv,
                             float* scratch, int b, int n, int k_heads, int h,
                             void* stream) {
  if (h <= 0 || h > kMaxH || n <= 0 || b <= 0 || k_heads <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bk_n = (size_t)b * k_heads;
  float* a = scratch;
  float* dz = a + bk_n * n;
  float* vec = dz + bk_n * n;
  float* sums = vec + bk_n * 3 * h;
  float* u = sums + bk_n * 2;
  int err = h <= 32
      ? launch_head<1>(latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, b, n, k_heads, h, st)
      : launch_head<2>(latent, mask, keep, q, wk, bk, wv, bv, dctx, a, dz, vec, sums, b, n, k_heads, h, st);
  if (err != 0) return err;
  attention_bwd_weights_kernel<<<k_heads, kThreads, 0, st>>>(
      q, wk, bk, dctx, vec, sums, dq, dwk, dbk, dwv, dbv, u, b, k_heads, h);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const size_t total = (size_t)b * n * h;
  attention_bwd_latent_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      a, dz, u, vec, dlatent, b, n, k_heads, h);
  return (int)cudaGetLastError();
}
