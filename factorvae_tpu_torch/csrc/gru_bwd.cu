// GRU recurrence backward (K2, and K3's T > 24 case) for Hopper, f32 on CUDA
// cores.
//
// Replaces the Pallas TPU kernels `_bwd_kernel` (launched by `_bwd_full`,
// T <= 24) and `_bwd_seg_kernel` (launched by `_bwd_segmented`, T > 24) of
// factorvae_tpu/ops/pallas/gru.py. Both compute the same function: given the
// forward's inputs xi (N, T, 3H), Wh (H, 3H), b (3H) and the cotangent dh
// (N, H) of the last hidden state, they return dxi (N, T, 3H), dWh (H, 3H)
// and db (3H), by re-running the recurrence and walking t backwards through
// the hand-derived gate VJP of `_backward_walk` (gates [r | z | n]):
//
//   dz = dh (h_prev - n)      dn = dh (1 - z)       dtanh = dn (1 - n^2)
//   dr = dtanh g_n            dg_n = dtanh r
//   dg_r = dr r (1 - r)       dg_z = dz z (1 - z)
//   dxi_t = [dg_r | dg_z | dtanh]      dg = [dg_r | dg_z | dg_n]
//   dh_prev = dh z + dg . Wh^T     dWh += h_prev^T . dg     db += sum dg
//
// The TPU code splits T <= 24 from T > 24 only because the backward's
// (T, rows, H) blocks had to fit VMEM; the segmented variant checkpoints h at
// segment starts and carries dh across grid steps. None of that is a fact of
// this card, so one kernel serves every T: each block takes a tile of kRows
// rows, re-runs the recurrence once writing h before each step and the
// pre-activations g = h . Wh + b to a global scratch (N, T, H) + (N, T, 3H)
// (1.6 + 4.7 MB for one flagship day: it stays in the 50 MB L2), then walks
// t = T-1 .. 0 carrying dh in shared memory. There are no segments and no
// carry between blocks.
//
// Bound: at one flagship day (N = 304, T = 20, H = 64) the three products
// per step (h . Wh in the recompute, dg . Wh^T and h^T . dg in the walk) are
// 3 * 2*N*T*H*3H = 0.45 GFLOP against 9.3 MB of xi and dxi, so the f32
// CUDA-core rate bounds it. Design: Wh (for h . Wh) and its transpose (for
// dg . Wh^T) sit in shared memory, so every product reads its weight operand
// conflict-free along the lanes and its row operand as a broadcast (float4
// where the layout allows); each thread keeps one gate column of dWh (H
// values) in registers for the whole walk. At one day the grid is 19 blocks
// on 132 SMs, far from the bound; that is left for a later version.
//
// Deterministic reductions: the rows of a block sum into its registers in a
// fixed order; each block writes its partial dWh and db to its own slot of
// `part`, and a second kernel sums the slots in block order. No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;       // rows per block
constexpr int kMaxH = 64;       // largest hidden size
constexpr int kRowsPerThread = (kRows + 2) / 3;   // dh product, >= 3 groups

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_bwd_kernel(const float* __restrict__ xi,
                               const float* __restrict__ wh,
                               const float* __restrict__ bh,
                               const float* __restrict__ dh,
                               float* __restrict__ dxi,
                               float* __restrict__ hseq,    // (N, T, H)
                               float* __restrict__ gseq,    // (N, T, 3H)
                               float* __restrict__ part,    // (blocks, H*3H + 3H)
                               int n_rows, int t_len, int h) {
  extern __shared__ float4 smem4[];
  const int h3 = 3 * h;
  const int hp = round4(h);
  const int h3p = round4(h3);
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;                 // (hp, 3H): Wh, rows >= h zero
  float* wt_s = w_s + hp * h3;       // (h3p, hp): Wh^T, zero padded
  float* h_s = wt_s + h3p * hp;      // (kRows, hp): h (before the step)
  float* dh_s = h_s + kRows * hp;    // (kRows, hp): dL/dh
  float* g_s = dh_s + kRows * hp;    // (kRows, h3p): g, then dg
  float* b_s = g_s + kRows * h3p;    // (3H,)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, (long long)n_rows - row0);

  for (int i = tid; i < hp * h3; i += nthr) w_s[i] = i < h * h3 ? wh[i] : 0.0f;
  for (int i = tid; i < h3p * hp; i += nthr) {
    const int j = i / hp;
    const int k = i - j * hp;
    wt_s[i] = (j < h3 && k < h) ? wh[k * h3 + j] : 0.0f;
  }
  for (int i = tid; i < h3; i += nthr) b_s[i] = bh[i];
  for (int i = tid; i < kRows * hp; i += nthr) h_s[i] = 0.0f;
  __syncthreads();

  // ---- recompute: the forward recurrence (K1's arithmetic), keeping h
  //      before each step and g = h . Wh + b for the walk ----------------------
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
      for (int r = 0; r < kRows; ++r) {
        const float g = acc[r] + b_s[j];
        g_s[r * h3p + j] = g;
        if (r < rows) gseq[((row0 + r) * t_len + t) * h3 + j] = g;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * h; i += nthr) {
      const int r = i / h;
      const int c = i - r * h;
      const long long at = (row0 + r) * t_len + t;
      const float* x = xi + at * h3;
      const float* g = g_s + r * h3p;
      const float rg = sigmoid_f(x[c] + g[c]);
      const float zg = sigmoid_f(x[h + c] + g[h + c]);
      const float ng = tanhf(x[2 * h + c] + rg * g[2 * h + c]);
      float* hc = h_s + r * hp + c;
      hseq[at * h + c] = *hc;
      *hc = (1.0f - zg) * ng + zg * *hc;
    }
    __syncthreads();
  }

  // ---- the walk -------------------------------------------------------------
  for (int i = tid; i < kRows * h3p; i += nthr) g_s[i] = 0.0f;
  for (int i = tid; i < kRows * hp; i += nthr) {
    const int r = i / hp;
    const int c = i - r * hp;
    h_s[i] = 0.0f;
    dh_s[i] = (r < rows && c < h) ? dh[(row0 + r) * h + c] : 0.0f;
  }
  float dw_acc[kMaxH];            // this thread's gate column j = tid of dWh
#pragma unroll
  for (int k = 0; k < kMaxH; ++k) dw_acc[k] = 0.0f;
  float db_acc = 0.0f;
  const int ngrp = nthr / h;      // >= 3: nthr >= 3H
  const int kcol = tid % h;
  const int grp = tid / h;
  __syncthreads();

  for (int t = t_len - 1; t >= 0; --t) {
    // the gate VJP, elementwise: dxi, dg, the direct part dh z of dh_prev
    for (int i = tid; i < rows * h; i += nthr) {
      const int r = i / h;
      const int c = i - r * h;
      const long long at = (row0 + r) * t_len + t;
      const float* x = xi + at * h3;
      const float* g = gseq + at * h3;
      const float hprev = hseq[at * h + c];
      const float dhv = dh_s[r * hp + c];
      const float rg = sigmoid_f(x[c] + g[c]);
      const float zg = sigmoid_f(x[h + c] + g[h + c]);
      const float gn = g[2 * h + c];
      const float ng = tanhf(x[2 * h + c] + rg * gn);
      const float dz = dhv * (hprev - ng);
      const float dn = dhv * (1.0f - zg);
      const float dtanh = dn * (1.0f - ng * ng);
      const float dr = dtanh * gn;
      const float dghn = dtanh * rg;
      const float dghr = dr * rg * (1.0f - rg);
      const float dghz = dz * zg * (1.0f - zg);
      float* dx = dxi + at * h3;
      dx[c] = dghr;
      dx[h + c] = dghz;
      dx[2 * h + c] = dtanh;
      float* dg = g_s + r * h3p;
      dg[c] = dghr;
      dg[h + c] = dghz;
      dg[2 * h + c] = dghn;
      h_s[r * hp + c] = hprev;
      dh_s[r * hp + c] = dhv * zg;
    }
    __syncthreads();

    // dh_prev += dg . Wh^T: thread (kcol, grp) owns rows grp, grp+ngrp, ...
    if (grp < ngrp) {
      float acc[kRowsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.0f;
      for (int j = 0; j < h3p; j += 4) {
        const float w0 = wt_s[j * hp + kcol];
        const float w1 = wt_s[(j + 1) * hp + kcol];
        const float w2 = wt_s[(j + 2) * hp + kcol];
        const float w3 = wt_s[(j + 3) * hp + kcol];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int r = grp + m * ngrp;
          if (r < kRows) {
            const float4 d = *reinterpret_cast<const float4*>(g_s + r * h3p + j);
            acc[m] = fmaf(d.x, w0, acc[m]);
            acc[m] = fmaf(d.y, w1, acc[m]);
            acc[m] = fmaf(d.z, w2, acc[m]);
            acc[m] = fmaf(d.w, w3, acc[m]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = grp + m * ngrp;
        if (r < kRows) dh_s[r * hp + kcol] += acc[m];
      }
    }
    // dWh[:, j] += h_prev^T . dg[:, j] and db[j] += sum dg[:, j], j = tid
    if (tid < h3) {
      for (int r = 0; r < kRows; ++r) {
        const float d = g_s[r * h3p + tid];
        db_acc += d;
#pragma unroll
        for (int k = 0; k < kMaxH; k += 4) {
          if (k < hp) {
            const float4 hv = *reinterpret_cast<const float4*>(h_s + r * hp + k);
            dw_acc[k] = fmaf(hv.x, d, dw_acc[k]);
            dw_acc[k + 1] = fmaf(hv.y, d, dw_acc[k + 1]);
            dw_acc[k + 2] = fmaf(hv.z, d, dw_acc[k + 2]);
            dw_acc[k + 3] = fmaf(hv.w, d, dw_acc[k + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // this block's partial dWh (H, 3H) and db (3H) into its own slot
  if (tid < h3) {
    float* slot = part + (size_t)blockIdx.x * (h * h3 + h3);
#pragma unroll
    for (int k = 0; k < kMaxH; ++k)
      if (k < h) slot[k * h3 + tid] = dw_acc[k];
    slot[h * h3 + tid] = db_acc;
  }
}

// Sum the blocks' partial (dWh, db) slots in block order.
__global__ void gru_bwd_reduce_kernel(const float* __restrict__ part, int blocks,
                                      int h, float* __restrict__ dwh,
                                      float* __restrict__ db) {
  const int h3 = 3 * h;
  const int len = h * h3 + h3;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * len + e];
  if (e < h * h3) dwh[e] = s;
  else db[e - h * h3] = s;
}

int smem_bytes(int h) {
  const int hp = round4(h);
  const int h3 = 3 * h;
  const int h3p = round4(h3);
  return (int)sizeof(float) *
         (hp * h3 + h3p * hp + 2 * kRows * hp + kRows * h3p + h3);
}

}  // namespace

extern "C" int gru_bwd_max_hidden() { return kMaxH; }

// Floats of scratch the wrapper allocates: h before each step (N, T, H),
// g (N, T, 3H), and one partial (dWh, db) slot per block.
extern "C" long long gru_bwd_scratch_floats(int n_rows, int t_len, int h) {
  const long long blocks = (n_rows + kRows - 1) / kRows;
  return (long long)n_rows * t_len * 4 * h + blocks * (3LL * h * h + 3 * h);
}

// Launches on `stream`; returns the cudaError_t of the launches (0 = ok).
extern "C" int gru_bwd(const float* xi, const float* wh, const float* bh,
                       const float* dh, float* dxi, float* dwh, float* db,
                       float* scratch, int n_rows, int t_len, int h,
                       void* stream) {
  if (h <= 0 || h > kMaxH || n_rows <= 0 || t_len < 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (n_rows + kRows - 1) / kRows;
  float* hseq = scratch;
  float* gseq = hseq + (size_t)n_rows * t_len * h;
  float* part = gseq + (size_t)n_rows * t_len * 3 * h;
  const int threads = ((3 * h + 31) / 32) * 32;
  gru_bwd_kernel<<<blocks, threads, smem, st>>>(xi, wh, bh, dh, dxi, hseq, gseq,
                                               part, n_rows, t_len, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int len = 3 * h * h + 3 * h;
  gru_bwd_reduce_kernel<<<(len + 255) / 256, 256, 0, st>>>(part, blocks, h, dwh, db);
  return (int)cudaGetLastError();
}
