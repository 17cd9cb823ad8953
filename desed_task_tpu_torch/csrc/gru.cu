// Hand-written Hopper kernel for the bidirectional GRU recurrence (fp32).
//
// Replaces desed_task_tpu/ops/pallas_gru.py _fwd_kernel (pallas_gru.py:38,
// called from _run_fwd at :146).
//
// Per step and direction, from precomputed input gates xg = x W_ih^T + b_ih
// (torch r/z/n order):
//   r = sigmoid(xr + h Wr + br), z = sigmoid(xz + h Wz + bz),
//   n = tanh(xn + r * (h Wn + bn)), h' = (1 - z) n + z h.
// The backward direction walks time in reverse and writes its states in the
// original time order.
//
// What bounds it: the T steps are sequential. Per step one direction reads
// all of W_hh (3*H*H fp32: 432 KiB at H=192) and does 2*B*3H*H FLOP; over the
// whole call that is ~2.2 GFLOP and ~30 MB of gates and states, so neither the
// card's FLOP rate nor its memory rate is near the limit: the latency of the
// step chain is.
// Design: one block per (direction, tile of BT batch rows), looping over T
// inside the kernel with h in shared memory. W_hh does not fit in one
// block's 227 KB of shared memory, so each step streams it through L2,
// transposed to [H, 3H] so that neighbouring threads read neighbouring gate
// columns; each loaded weight feeds BT FMAs. A step is two phases split by
// __syncthreads: thread j computes gate column j of h W_hh + b_hh for the BT
// rows, then each thread turns (r, z, n) into h' for its (row, unit) pairs.

#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;  // batch rows per block

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(1024) bigru_fwd_kernel(const float* __restrict__ xg_f,
                                 const float* __restrict__ xg_b,
                                 const float* __restrict__ wt,   // [2, H, 3H]
                                 const float* __restrict__ bhh,  // [2, 3H]
                                 float* __restrict__ out_f,      // [B, T, H]
                                 float* __restrict__ out_b,
                                 int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;            // [BT][H]
  float* g_s = smem + BT * H;   // [BT][3H]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int H3 = 3 * H;
  const float* xg = d == 0 ? xg_f : xg_b;
  float* out = d == 0 ? out_f : out_b;
  const float* w = wt + (long long)d * H * H3;
  const float* bias = bhh + d * H3;

  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float wv = w[(long long)k * H3 + j];
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(h_s[b * H + k], wv, acc[b]);
      }
      const float bj = bias[j];
#pragma unroll
      for (int b = 0; b < BT; ++b) g_s[b * H3 + j] = acc[b] + bj;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i - b * H;
      const int bb = b0 + b;
      if (bb >= B) continue;
      const float* x = xg + ((long long)bb * T + t) * H3;
      const float* g = g_s + b * H3;
      const float r = sigmoidf(x[u] + g[u]);
      const float zg = sigmoidf(x[H + u] + g[H + u]);
      const float n = tanhf(x[2 * H + u] + r * g[2 * H + u]);
      const float hn = (1.f - zg) * n + zg * h_s[i];
      h_s[i] = hn;
      out[((long long)bb * T + t) * H + u] = hn;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// xg_f/xg_b [B, T, 3H]; wt [2, H, 3H] (W_hh^T per direction); bhh [2, 3H];
// out_f/out_b [B, T, H].
int bigru_fwd(const float* xg_f, const float* xg_b, const float* wt,
              const float* bhh, float* out_f, float* out_b, int B, int T, int H,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * 4 * H;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dim3 grid((B + BT - 1) / BT, 2);
  bigru_fwd_kernel<<<grid, threads, smem, stream>>>(xg_f, xg_b, wt, bhh, out_f,
                                                     out_b, B, T, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
