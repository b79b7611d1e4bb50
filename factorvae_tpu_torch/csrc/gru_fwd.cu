// GRU recurrence forward (K1) for Hopper, f32 on CUDA cores.
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
// over t = 0..T-1 from h = 0, and writes only the last h.
//
// Inputs: xi (N, T, 3H) row-major, read in place (no per-gate transpose);
// Wh (H, 3H); b (3H). Output: h (N, H).
//
// Bound: at the flagship serving shape (N = 32 days x 304 stocks, T = 20,
// H = 64) the h . Wh products are 2*N*T*H*3H = 4.8 GFLOP against 149 MB of
// xi, so the f32 CUDA-core rate bounds it. Design: one block holds kRows
// rows; Wh and b are staged once in shared memory (49,152 B at H = 64, so
// the launch asks for dynamic shared memory above the 48 KB static limit),
// h stays in shared memory for all T steps, and each thread owns one gate
// column for all kRows rows, so every Wh element read from shared memory
// feeds kRows FMAs; h is read as float4 broadcasts (its rows and Wh's rows
// are zero-padded to a multiple of 4), so one load of h feeds 4 FMAs. The
// ragged last tile is masked. Tensor cores are left for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;   // rows per block
constexpr int kMaxH = 64;   // largest hidden size (3H = 192 threads)

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_fwd_kernel(const float* __restrict__ xi,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               float* __restrict__ h_out,
                               int n_rows, int t_len, int h) {
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  const int hp = round4(h);
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;               // (hp, 3H), rows >= h zero
  float* h_s = w_s + hp * h3;      // (kRows, hp): the running hidden state
  float* b_s = h_s + kRows * hp;   // (3H,)
  float* g_s = b_s + h3;           // (kRows, 3H): h . Wh + b of this step

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)n_rows - row0);

  for (int i = tid; i < hp * h3; i += nthr) w_s[i] = i < h * h3 ? wh[i] : 0.0f;
  for (int i = tid; i < h3; i += nthr) b_s[i] = bh[i];
  for (int i = tid; i < kRows * hp; i += nthr) h_s[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    for (int j = tid; j < h3; j += nthr) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      for (int k = 0; k < hp; k += 4) {
        const float w0 = w_s[k * h3 + j];
        const float w1 = w_s[(k + 1) * h3 + j];
        const float w2 = w_s[(k + 2) * h3 + j];
        const float w3 = w_s[(k + 3) * h3 + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + r * hp + k);
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) g_s[r * h3 + j] = acc[r] + b_s[j];
    }
    __syncthreads();
    for (int i = tid; i < rows * h; i += nthr) {
      const int r = i / h;
      const int c = i - r * h;
      const float* x = xi + ((row0 + r) * t_len + t) * (long long)h3;
      const float* g = g_s + r * h3;
      const float rg = sigmoid_f(x[c] + g[c]);
      const float zg = sigmoid_f(x[h + c] + g[h + c]);
      const float ng = tanhf(x[2 * h + c] + rg * g[2 * h + c]);
      float* hc = h_s + r * hp + c;
      *hc = (1.0f - zg) * ng + zg * *hc;
    }
    __syncthreads();
  }
  for (int i = tid; i < rows * h; i += nthr) {
    const int r = i / h;
    h_out[row0 * h + i] = h_s[r * hp + (i - r * h)];
  }
}

}  // namespace

extern "C" int gru_fwd_max_hidden() { return kMaxH; }

extern "C" int gru_fwd_smem_bytes(int h) {
  const int hp = round4(h);
  return (int)sizeof(float) * (3 * hp * h + kRows * hp + 3 * h + kRows * 3 * h);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int gru_fwd(const float* xi, const float* wh, const float* bh,
                       float* h_out, int n_rows, int t_len, int h,
                       void* stream) {
  if (h <= 0 || h > kMaxH) return (int)cudaErrorInvalidValue;
  if (n_rows <= 0) return 0;
  const int smem = gru_fwd_smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const int threads = ((3 * h + 31) / 32) * 32;
  const int blocks = (n_rows + kRows - 1) / kRows;
  gru_fwd_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      xi, wh, bh, h_out, n_rows, t_len, h);
  return (int)cudaGetLastError();
}
