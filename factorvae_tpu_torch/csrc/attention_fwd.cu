// K-head cross-section attention forward (K4) for Hopper, f32 on CUDA cores.
//
// Replaces the Pallas TPU kernel `_head_kernel` of
// factorvae_tpu/ops/pallas/attention.py (`multihead_cross_section_attention`,
// reached through `attention_grad.fused_attention`). The JAX code vmaps the
// single-day kernel over days; this one takes the day axis directly and runs
// one block per (day, head). For head k of day b:
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
// q (K, H), Wk/Wv (K, H, H), bk/bv (K, H). Output: ctx (B, K, H).
//
// Bound: the function needs, per valid row and head, one value product
// (2*H*H FLOP) and a few O(H) terms; the score needs only L . (Wk[k] . q[k]),
// so its least work is 2*H per row. That is about 7.5 GFLOP for a 32-day
// flagship chunk (B=32, N=304, K=96, H=64, about 9,100 valid rows) against
// ~2.5 MB of latent, so the f32 CUDA-core rate bounds it. This kernel does
// the key product as written (2*H*H per row, twice the least work), so its
// own ceiling is half that rate. What stands between the kernel and it is
// shared-memory traffic: a product that reads one weight and one latent
// element from shared memory per FMA runs at a quarter of the FMA rate at
// best. Design: the head's Wk and Wv sit in shared memory (32 KB at
// H = 64). The valid rows of the day are first compacted into a list, so
// masked and padded stocks cost nothing.
// Each warp then takes a tile of kTile valid rows at a time, staged in
// shared memory; a lane owns the output columns j = lane + 32*s, loads
// each weight once for the kTile rows and reads the rows as float4
// broadcasts, so one shared-memory load feeds several FMAs. Scores for the
// N stocks stay in shared memory (4 KB at N = 1024). Pass 1 computes the
// scores, a block max and sum give the softmax weights, pass 2 recomputes
// the value rows and accumulates the context per warp; the (K, N, H) key
// and value stacks never touch device memory. The algebra is not rewritten
// (s = L.(Wk.q) + bk.q would halve the work), so nan_to_num and the guard
// keep exactly the meaning they have in the TPU kernel. Pass 1 and the
// softmax live in attention_common.cuh, so that the backward (K5,
// attention_bwd.cu) recomputes this kernel's own weights.

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

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
                     float* __restrict__ out,
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
  float* ctx_s = bv_s + hp;                  // (kWarps, hp) per-warp ctx
  float* s_s = ctx_s + kWarps * hp;          // (N,) scores, then weights
  int* idx_s = reinterpret_cast<int*>(s_s + n);  // (N,) valid rows
  __shared__ int shared_nv;

  const int day = blockIdx.x / k_heads;
  const int head = blockIdx.x - day * k_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  compact_rows(mask + (size_t)day * n, n, idx_s, &shared_nv);
  stage_head(q, wk, bk, wv, bv, head, h, hp, q_s, wk_s, bk_s, wv_s, bv_s);
  __syncthreads();

  const int nv = shared_nv;
  const float* lat = latent + (size_t)day * n * h;
  const float* kp = keep ? keep + ((size_t)day * k_heads + head) * n : nullptr;
  float* out_row = out + ((size_t)day * k_heads + head) * h;
  float* tile = tile_s + warp * kTile * hp;

  // pass 1 and the softmax: s_s holds the weights of the valid stocks
  if (!head_softmax<S>(lat, idx_s, nv, kp, wk_s, bk_s, q_s, h, hp, tile, s_s, s_s)) {
    for (int j = tid; j < h; j += kThreads) out_row[j] = 0.0f;
    return;
  }

  // ---- pass 2: ctx = a . nan_to_num(value) --------------------------------
  float acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = 0.0f;
  for (int g = warp * kTile; g < nv; g += kWarps * kTile) {
    stage_tile(lat, idx_s, g, nv, h, hp, lane, tile);
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

template <int S>
int launch(const float* latent, const unsigned char* mask, const float* keep,
           const float* q, const float* wk, const float* bk, const float* wv,
           const float* bv, float* out, int b, int n, int k_heads, int h,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  attention_fwd_kernel<S><<<b * k_heads, kThreads, smem, stream>>>(
      latent, mask, keep, q, wk, bk, wv, bv, out, n, k_heads, h);
  return (int)cudaGetLastError();
}

int smem_bytes(int n, int h) {
  const int hp = round4(h);
  return (int)sizeof(float) *
         (2 * hp * h + kWarps * kTile * hp + 3 * hp + kWarps * hp + 2 * n);
}

}  // namespace

extern "C" int attention_fwd_max_hidden() { return kMaxH; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok). An
// N whose scores and row list do not fit in one block's shared memory is
// refused by cudaFuncSetAttribute (above N of about 22,500 at H = 64).
extern "C" int attention_fwd(const float* latent, const unsigned char* mask,
                             const float* keep, const float* q,
                             const float* wk, const float* bk,
                             const float* wv, const float* bv, float* out,
                             int b, int n, int k_heads, int h, void* stream) {
  if (h <= 0 || h > kMaxH || n <= 0) return (int)cudaErrorInvalidValue;
  if (b <= 0 || k_heads <= 0) return 0;
  const int smem = smem_bytes(n, h);
  const cudaStream_t st = (cudaStream_t)stream;
  if (h <= 32)
    return launch<1>(latent, mask, keep, q, wk, bk, wv, bv, out, b, n, k_heads, h, smem, st);
  return launch<2>(latent, mask, keep, q, wk, bk, wv, bv, out, b, n, k_heads, h, smem, st);
}
