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
//
// The backward (bigru_bwd) replaces _bwd_kernel (pallas_gru.py:58, called
// from _bigru_core_bwd at :178). Two kernels:
//   bigru_bwd_kernel: one block per (direction, tile of BT batch rows),
//     walking the direction's steps in reverse with dh in shared memory.
//     Each step recomputes h_prev W_hh^T + b_hh from the saved state (the
//     forward direction's h_prev is out_f[t-1], the backward direction's
//     out_b[t+1], zero at the sequence start), the gates r, z, n, and then
//     d(input gates) = (dr_in, dz_in, dn_in) and the hidden-side gate
//     gradients (dr_in, dz_in, dn_in * r) (pallas_gru.py:87-120), and
//     dh_prev = dh z + dg_hidden W_hh. Rows past B (B=60 is not a multiple
//     of BT) hold zeros and write nothing.
//   bigru_dw_kernel: dW_hh[d] = sum over (b, t) of dg_hidden^T h_prev and
//     db_hh[d] = sum of dg_hidden, a [3H, B*T] x [B*T, H] product per
//     direction; each block owns a 64x64 tile of dW_hh and walks all rows
//     in order (one direction's W_hh is 432 KiB, so per-block accumulators
//     of the whole matrix do not fit; no atomics, so reruns are bitwise equal).
// What bounds it: like the forward, the step chain: each step streams W_hh
// twice (h_prev W_hh^T and dg W_hh), ~8 GFLOP of recurrence and ~4 GFLOP of
// dW_hh at B=60, T=156, H=192, far from either roofline. Within a step,
// dg W_hh runs on all 3H threads, one gate block of 192 rows each, the
// three partial sums added in a fixed order, so that no thread walks a
// chain of 3H weight loads.

#include <cuda_runtime.h>

namespace {

constexpr int BT = 8;  // batch rows per block

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// acc[b] += sum over k < H of h[b * ldh + k] * wt[k * ld + j], k in order:
// each weight, loaded through const __restrict__ pointers with 8 in flight
// per thread, feeds BT FMAs. The callers pad the rows of h to HP floats, a
// multiple of 4 (zeros past H): with that row stride the loop measured ~25 %
// faster on the H100 than with stride H, though H = 192 gives the same
// addresses (PERF.md).
__device__ __forceinline__ void row_times_col(const float* __restrict__ h, int ldh,
                                              const float* __restrict__ wt, int ld, int j,
                                              int H, float (&acc)[BT]) {
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    const float wv = wt[(long long)k * ld + j];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = fmaf(h[b * ldh + k], wv, acc[b]);
  }
}

__global__ void __launch_bounds__(1024) bigru_fwd_kernel(const float* __restrict__ xg_f,
                                 const float* __restrict__ xg_b,
                                 const float* __restrict__ wt,   // [2, H, 3H]
                                 const float* __restrict__ bhh,  // [2, 3H]
                                 float* __restrict__ out_f,      // [B, T, H]
                                 float* __restrict__ out_b,
                                 int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const int HP = (H + 3) & ~3;
  float* h_s = smem;             // [BT][HP]
  float* g_s = smem + BT * HP;   // [BT][3H]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const int H3 = 3 * H;
  const float* xg = d == 0 ? xg_f : xg_b;
  float* out = d == 0 ? out_f : out_b;
  const float* w = wt + (long long)d * H * H3;
  const float* bias = bhh + d * H3;

  for (int i = threadIdx.x; i < BT * HP; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      row_times_col(h_s, HP, w, H3, j, H, acc);
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
      const float hn = (1.f - zg) * n + zg * h_s[b * HP + u];
      h_s[b * HP + u] = hn;
      out[((long long)bb * T + t) * H + u] = hn;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(1024) bigru_bwd_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ wt,    // [2, H, 3H]  W_hh^T
    const float* __restrict__ w,     // [2, 3H, H]  W_hh
    const float* __restrict__ bhh,   // [2, 3H]
    const float* __restrict__ out_f, const float* __restrict__ out_b,    // [B, T, H]
    const float* __restrict__ dout_f, const float* __restrict__ dout_b,  // [B, T, H]
    float* __restrict__ dxg_f, float* __restrict__ dxg_b,  // [B, T, 3H]
    float* __restrict__ dgh,                               // [2, B, T, 3H]
    int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H3 = 3 * H;
  const int HP = (H + 3) & ~3;
  float* h_s = smem;                 // [BT][HP]    h_prev (zeros past H)
  float* g_s = h_s + BT * HP;        // [BT][3H]    h_prev W_hh^T + b_hh
  float* dg_s = g_s + BT * H3;       // [BT][3][HP] hidden-side gate gradients
  float* dh_s = dg_s + BT * 3 * HP;  // [BT][H]     dL/dh carried backwards in time
  float* dhz_s = dh_s + BT * H;      // [BT][H]     dh_tot * z
  float* dhp_s = dhz_s + BT * H;     // [3][BT][H]  dg W_hh, one part per gate
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const float* xg = d == 0 ? xg_f : xg_b;
  const float* out = d == 0 ? out_f : out_b;
  const float* dout = d == 0 ? dout_f : dout_b;
  float* dxg = d == 0 ? dxg_f : dxg_b;
  float* dgd = dgh + (long long)d * B * T * H3;
  const float* wtd = wt + (long long)d * H * H3;
  const float* wd = w + (long long)d * H3 * H;
  const float* bias = bhh + d * H3;
  const int shift = d == 0 ? -1 : 1;

  for (int i = threadIdx.x; i < BT * HP; i += blockDim.x) h_s[i] = 0.f;
  for (int i = threadIdx.x; i < BT * 3 * HP; i += blockDim.x) dg_s[i] = 0.f;
  for (int i = threadIdx.x; i < BT * H; i += blockDim.x) dh_s[i] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? T - 1 - step : step;
    const int tp = t + shift;
    const bool has_prev = tp >= 0 && tp < T;
    __syncthreads();  // the previous step's dh is complete
    for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i - b * H;
      const int bb = b0 + b;
      h_s[b * HP + u] = (bb < B && has_prev) ? out[((long long)bb * T + tp) * H + u] : 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      row_times_col(h_s, HP, wtd, H3, j, H, acc);
      const float bj = bias[j];
#pragma unroll
      for (int b = 0; b < BT; ++b) g_s[b * H3 + j] = acc[b] + bj;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i - b * H;
      const int bb = b0 + b;
      float* dgr = dg_s + b * 3 * HP;
      if (bb >= B) {
        dgr[u] = dgr[HP + u] = dgr[2 * HP + u] = 0.f;
        dhz_s[i] = 0.f;
        continue;
      }
      const long long row = (long long)bb * T + t;
      const float* x = xg + row * H3;
      const float* gg = g_s + b * H3;
      const float r = sigmoidf(x[u] + gg[u]);
      const float z = sigmoidf(x[H + u] + gg[H + u]);
      const float hn = gg[2 * H + u];
      const float n = tanhf(x[2 * H + u] + r * hn);
      const float dht = dh_s[i] + dout[row * H + u];
      const float dnin = dht * (1.f - z) * (1.f - n * n);
      const float dzin = dht * (h_s[b * HP + u] - n) * z * (1.f - z);
      const float drin = dnin * hn * r * (1.f - r);
      const float dhn = dnin * r;
      float* dx = dxg + row * H3;
      dx[u] = drin;
      dx[H + u] = dzin;
      dx[2 * H + u] = dnin;  // n = tanh(xn + r hn): the pre-tanh gradient
      float* dgo = dgd + row * H3;
      dgo[u] = drin;
      dgo[H + u] = dzin;
      dgo[2 * H + u] = dhn;
      dgr[u] = drin;
      dgr[HP + u] = dzin;
      dgr[2 * HP + u] = dhn;
      dhz_s[i] = dht * z;
    }
    __syncthreads();
    // dg W_hh, one gate block per thread (3H threads: gate, unit), then the
    // three blocks and dh_tot * z added in a fixed order
    for (int q = threadIdx.x; q < H3; q += blockDim.x) {
      const int gate = q / H;
      const int u = q - gate * H;
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      row_times_col(dg_s + gate * HP, 3 * HP, wd + (long long)gate * H * H, H, u, H, acc);
#pragma unroll
      for (int b = 0; b < BT; ++b) dhp_s[(gate * BT + b) * H + u] = acc[b];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT * H; i += blockDim.x) {
      dh_s[i] = dhz_s[i] + dhp_s[i] + dhp_s[BT * H + i] + dhp_s[2 * BT * H + i];
    }
  }
}

// dW_hh[d][j][u] = sum_r dgh[d][r][j] * h_prev[d][r][u], r = b*T + t, and
// db_hh[d][j] = sum_r dgh[d][r][j]. A 64x64 tile per block (4x4 per thread),
// 16 rows per stage, rows in order.
__global__ void __launch_bounds__(256) bigru_dw_kernel(
    const float* __restrict__ dgh, const float* __restrict__ out_f,
    const float* __restrict__ out_b, float* __restrict__ dw, float* __restrict__ db,
    int B, int T, int H) {
  constexpr int BJ = 64, BU = 64, BR = 16;
  __shared__ __align__(16) float As[BR][BJ + 4];
  __shared__ __align__(16) float Bs[BR][BU + 4];
  const int H3 = 3 * H;
  const int d = blockIdx.z;
  const int j0 = blockIdx.x * BJ;
  const int u0 = blockIdx.y * BU;
  const long long R = (long long)B * T;
  const float* dg = dgh + (long long)d * R * H3;
  const float* out = d == 0 ? out_f : out_b;
  const int shift = d == 0 ? -1 : 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool do_bias = blockIdx.y == 0 && tid < BJ;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  for (long long r0 = 0; r0 < R; r0 += BR) {
    for (int i = tid; i < BR * BJ; i += 256) {
      const int r = i / BJ;
      const int jj = i - r * BJ;
      const long long row = r0 + r;
      As[r][jj] = (row < R && j0 + jj < H3) ? dg[row * H3 + j0 + jj] : 0.f;
    }
    for (int i = tid; i < BR * BU; i += 256) {
      const int r = i / BU;
      const int uu = i - r * BU;
      const long long row = r0 + r;
      float v = 0.f;
      if (row < R && u0 + uu < H) {
        const int t = (int)(row % T);
        const int tp = t + shift;
        if (tp >= 0 && tp < T) v = out[(row + shift) * H + u0 + uu];
      }
      Bs[r][uu] = v;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[r][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[r][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (do_bias) {
#pragma unroll
      for (int r = 0; r < BR; ++r) bsum += As[r][tid];
    }
    __syncthreads();
  }
  float* dwd = dw + (long long)d * H3 * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty * 4 + i;
    if (j >= H3) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int u = u0 + tx * 4 + k;
      if (u < H) dwd[(long long)j * H + u] = acc[i][k];
    }
  }
  if (do_bias && j0 + tid < H3) db[d * H3 + j0 + tid] = bsum;
}

}  // namespace

extern "C" {

// xg_f/xg_b [B, T, 3H]; wt [2, H, 3H] (W_hh^T per direction); bhh [2, 3H];
// out_f/out_b [B, T, H].
int bigru_fwd(const float* xg_f, const float* xg_b, const float* wt,
              const float* bhh, float* out_f, float* out_b, int B, int T, int H,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * ((H + 3) / 4 * 4 + 3 * H);
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

// Backward of bigru_fwd. wt [2, H, 3H] and w [2, 3H, H] are W_hh^T and W_hh
// per direction; out_*/dout_* [B, T, H]; dxg_* [B, T, 3H]; dgh [2, B, T, 3H]
// scratch; dw [2, 3H, H]; db [2, 3H].
int bigru_bwd(const float* xg_f, const float* xg_b, const float* wt, const float* w,
              const float* bhh, const float* out_f, const float* out_b,
              const float* dout_f, const float* dout_b, float* dxg_f, float* dxg_b,
              float* dgh, float* dw, float* db, int B, int T, int H,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT * (4 * ((H + 3) / 4 * 4) + 8 * H);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dim3 grid((B + BT - 1) / BT, 2);
  bigru_bwd_kernel<<<grid, threads, smem, stream>>>(xg_f, xg_b, wt, w, bhh, out_f, out_b,
                                                    dout_f, dout_b, dxg_f, dxg_b, dgh,
                                                    B, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((3 * H + 63) / 64, (H + 63) / 64, 2);
  bigru_dw_kernel<<<grid2, 256, 0, stream>>>(dgh, out_f, out_b, dw, db, B, T, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
