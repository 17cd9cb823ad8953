// Hand-written Hopper kernels for one fused CRNN conv block (fp32).
//
// Replaces desed_task_tpu/ops/pallas_cnn.py:
//   conv_bn_stats  <- _conv_stats_kernel (pallas_cnn.py:147, called at :403)
//   glu_drop_pool  <- _epilogue_kernel   (pallas_cnn.py:269, called at :589)
//
// Layout: activations are NHWC, x [B, T, F, Ci], y [B, T, F, Co]; a "lane" is
// one (f, c) pair, lane = f * Co + c, as in the TPU kernels. None of the
// TPU layout tricks (lane folding, banded weights, block-diagonal GLU, P/Q
// pool matrices) is carried over: they exist only for Mosaic.
//
// conv_bn_stats
//   What bounds it: about 110 GFLOP of fp32 FMA per 2024 forward at B=64
//   (67 TFLOP/s fp32 peak outside the tensor cores -> ~1.6 ms), against
//   ~0.9 GB of activations (~0.3 ms at 3.35 TB/s): operations.
//   Design: an implicit GEMM, rows m = (b*T + t)*F + f, columns = Co,
//   depth k = (dt*3 + df)*Ci + ci, so w [3,3,Ci,Co] is the [K, Co] operand
//   as it lies in memory. Tiles of BM x BN outputs per block, BK-deep slices
//   of the im2col'd input staged in shared memory with the zero padding
//   applied at load time, a TM x TN register tile per thread, fp32
//   accumulation, bias added in fp32 before the statistics (pallas_cnn.py
//   :173-178). The per-lane sum and sum of squares of y over all rows are a
//   deterministic two-pass reduction (no atomics): pass 1 gives per-chunk
//   partial sums, pass 2 adds the chunks in a fixed order. On the TPU the
//   sequential grid carried them in scratch (pallas_cnn.py:155, :180).
//
// glu_drop_pool
//   What bounds it: the GLU is a [Co] x [Co, Co] product at every position,
//   about 18 GFLOP per forward at B=64 (~0.3 ms at fp32 peak) against ~0.9 GB
//   of y read once (~0.27 ms): both about even.
//   Design: persistent blocks (as many as fit on the card) keep Wg^T in
//   shared memory and walk over tiles of pooled outputs. A tile first
//   locates each of its rows (pooled output, window element) in y once,
//   then stages BN(y) for the pt*pf input positions of each pooled output,
//   then each thread produces 4 channels of one pooled output: the GLU
//   product reads float4s of the BN(y) row (shared by the warp) and of four
//   Wg^T rows, 16 FMAs per 5 shared-memory reads; then
//   GLU = (ybn . Wg + bg) * sigmoid(ybn), dropout from the given uint8 bits
//   (keep if bits < thresh, scale by 1/keep, pallas_cnn.py:573), and the
//   T- and F-average pool. Rows past T//pt and columns past F//pf are never
//   produced (torch floor pooling).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3x3_bias_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int B, int T, int F, int Ci, int Co) {
  constexpr int NT = (BM / TM) * (BN / TN);
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int row_t[BM];
  __shared__ int row_f[BM];

  const long long M = (long long)B * T * F;
  const int K = 9 * Ci;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  for (int r = tid; r < BM; r += NT) {
    const long long m = m0 + r;
    if (m < M) {
      row_f[r] = (int)(m % F);
      row_t[r] = (int)((m / F) % T);
    } else {
      row_f[r] = 0;
      row_t[r] = -4;  // every tap falls outside [0, T): the row loads zeros
    }
  }
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: im2col rows with SAME zero padding; k fastest so that
    // neighbouring threads read neighbouring channels.
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK;
      const int kk = i - r * BK;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < K) {
        const int tap = k / Ci;
        const int ci = k - tap * Ci;
        const int dt = tap / 3 - 1;
        const int df = tap % 3 - 1;
        const int t = row_t[r] + dt;
        const int f = row_f[r] + df;
        if (t >= 0 && t < T && f >= 0 && f < F) {
          v = x[(m0 + r + (long long)dt * F + df) * Ci + ci];
        }
      }
      As[kk][r] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN;
      const int n = i - kk * BN;
      const int k = k0 + kk;
      const int co = n0 + n;
      Bs[kk][n] = (k < K && co < Co) ? w[(long long)k * Co + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Co) y[m * Co + co] = acc[i][j] + bias[co];
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_conv(const float* x, const float* w, const float* bias, float* y,
                        int B, int T, int F, int Ci, int Co, cudaStream_t s) {
  const long long M = (long long)B * T * F;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  conv3x3_bias_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, s>>>(x, w, bias, y, B, T, F, Ci, Co);
  return cudaGetLastError();
}

// Pass 1: part[c][l] = sum of y[r][l] over the rows r of chunk c, in order.
__global__ void lane_stats_partial_kernel(const float* __restrict__ y,
                                          float* __restrict__ part_s,
                                          float* __restrict__ part_q,
                                          long long R, int L, int rows_per_chunk) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (l >= L) return;
  const long long r0 = (long long)c * rows_per_chunk;
  const long long r1 = min(R, r0 + rows_per_chunk);
  float s = 0.f, q = 0.f;
  for (long long r = r0; r < r1; ++r) {
    const float v = y[r * L + l];
    s += v;
    q = fmaf(v, v, q);
  }
  part_s[(long long)c * L + l] = s;
  part_q[(long long)c * L + l] = q;
}

// Pass 2: s[l] = sum over chunks of part[c][l], chunks in order.
__global__ void lane_stats_final_kernel(const float* __restrict__ part_s,
                                        const float* __restrict__ part_q,
                                        float* __restrict__ s, float* __restrict__ q,
                                        int L, int n_chunks) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float a = 0.f, b = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    a += part_s[(long long)c * L + l];
    b += part_q[(long long)c * L + l];
  }
  s[l] = a;
  q[l] = b;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// smem: WgT [Co][S] | BN(y) rows [NQ*W][S] | row offsets | lane offsets.
// Rows are padded to S floats (S/4 odd) so that float4 reads of 8
// neighbouring rows fall in distinct banks; the padding holds zeros.
__global__ void __launch_bounds__(256) glu_drop_pool_kernel(
    const float* __restrict__ y, const float* __restrict__ scale_f,
    const float* __restrict__ bias_f, const float* __restrict__ wg,
    const float* __restrict__ bg, const uint8_t* __restrict__ bits,
    float* __restrict__ z, int B, int T, int F, int Co, int pt, int pf,
    int keep_thresh, float inv_keep, int NQ, int S) {
  extern __shared__ __align__(16) float smem[];
  const int W = pt * pf;
  const int NR = NQ * W;
  float* wgT_s = smem;
  float* ybn_s = smem + Co * S;
  long long* rowoff_s = reinterpret_cast<long long*>(ybn_s + NR * S);
  int* laneoff_s = reinterpret_cast<int*>(rowoff_s + NR);
  const int Tout = T / pt;
  const int Fout = F / pf;
  const long long Q = (long long)B * Tout * Fout;
  const long long n_tiles = (Q + NQ - 1) / NQ;
  const int K4 = (Co + 3) & ~3;  // depth of the GLU product, padded to float4
  const int CG = (Co + 3) / 4;   // threads per pooled output, 4 channels each
  const float inv_w = 1.f / (float)W;

  for (int i = threadIdx.x; i < Co * S; i += blockDim.x) {
    const int c = i / S;
    const int k = i - c * S;
    wgT_s[i] = k < Co ? wg[k * Co + c] : 0.f;
  }
  for (int i = threadIdx.x; i < NR * S; i += blockDim.x) ybn_s[i] = 0.f;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long q0 = tile * NQ;
    __syncthreads();  // staging done / previous tile no longer read
    // each row r = (pooled output qq, window element wi): where it lies in y
    for (int r = threadIdx.x; r < NR; r += blockDim.x) {
      const int qq = r / W;
      const int wi = r - qq * W;
      const long long q = q0 + qq;
      long long off = -1;
      int lane = 0;
      if (q < Q) {
        const int fo = (int)(q % Fout);
        const long long bt = q / Fout;
        const int to = (int)(bt % Tout);
        const long long b = bt / Tout;
        const int t = to * pt + wi / pf;
        const int f = fo * pf + wi % pf;
        off = ((b * T + t) * F + f) * (long long)Co;
        lane = f * Co;
      }
      rowoff_s[r] = off;
      laneoff_s[r] = lane;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < NR * Co; i += blockDim.x) {
      const int r = i / Co;
      const int c = i - r * Co;
      const long long off = rowoff_s[r];
      float v = 0.f;
      if (off >= 0) {
        const int lane = laneoff_s[r] + c;
        v = fmaf(y[off + c], scale_f[lane], bias_f[lane]);
      }
      ybn_s[r * S + c] = v;
    }
    __syncthreads();
    // thread (qq, cl) produces channels cl + j*CG, j < 4, of pooled output qq
    for (int i = threadIdx.x; i < NQ * CG; i += blockDim.x) {
      const int qq = i / CG;
      const int cl = i - qq * CG;
      if (rowoff_s[qq * W] < 0) continue;  // past the last pooled output
      int cj[4];
      const float* wrow[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cj[j] = cl + j * CG;
        wrow[j] = wgT_s + (cj[j] < Co ? cj[j] : Co - 1) * S;
      }
      float pooled[4] = {0.f, 0.f, 0.f, 0.f};
      for (int wi = 0; wi < W; ++wi) {
        const int r = qq * W + wi;
        const float* yr = ybn_s + r * S;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < K4; k += 4) {
          const float4 yv = *reinterpret_cast<const float4*>(yr + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wv = *reinterpret_cast<const float4*>(wrow[j] + k);
            acc[j] = fmaf(yv.x, wv.x, acc[j]);
            acc[j] = fmaf(yv.y, wv.y, acc[j]);
            acc[j] = fmaf(yv.z, wv.z, acc[j]);
            acc[j] = fmaf(yv.w, wv.w, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cj[j] >= Co) continue;
          float g = (acc[j] + bg[cj[j]]) * sigmoidf(yr[cj[j]]);
          if (bits != nullptr) {
            g = (int)bits[rowoff_s[r] + cj[j]] < keep_thresh ? g * inv_keep : 0.f;
          }
          pooled[j] += g;
        }
      }
      const long long q = q0 + qq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cj[j] < Co) z[q * Co + cj[j]] = pooled[j] * inv_w;
      }
    }
  }
}

}  // namespace

extern "C" {

// y = conv3x3_same(x, w) + bias; s, q = per-lane sum / sum of squares of y
// over the B*T rows. part_s/part_q: scratch [n_chunks, F*Co].
int conv_bn_stats(const float* x, const float* w, const float* bias, float* y,
                  float* part_s, float* part_q, float* s, float* q,
                  int B, int T, int F, int Ci, int Co, int n_chunks,
                  cudaStream_t stream) {
  cudaError_t err;
  if (Co >= 128)
    err = launch_conv<128, 128, 16, 8, 8>(x, w, bias, y, B, T, F, Ci, Co, stream);
  else if (Co >= 64)
    err = launch_conv<128, 64, 16, 8, 4>(x, w, bias, y, B, T, F, Ci, Co, stream);
  else if (Co >= 32)
    err = launch_conv<128, 32, 16, 4, 4>(x, w, bias, y, B, T, F, Ci, Co, stream);
  else
    err = launch_conv<128, 16, 16, 4, 2>(x, w, bias, y, B, T, F, Ci, Co, stream);
  if (err != cudaSuccess) return (int)err;
  const long long R = (long long)B * T;
  const int L = F * Co;
  const int rows_per_chunk = (int)((R + n_chunks - 1) / n_chunks);
  dim3 g1((L + 255) / 256, n_chunks);
  lane_stats_partial_kernel<<<g1, 256, 0, stream>>>(y, part_s, part_q, R, L, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lane_stats_final_kernel<<<(L + 255) / 256, 256, 0, stream>>>(part_s, part_q, s, q, L, n_chunks);
  return (int)cudaGetLastError();
}

// z [B, T//pt, F//pf, Co] = pool(drop(GLU(y * scale_f + bias_f))).
// bits: uint8 [B, T, F*Co] or NULL; keep_thresh 256 keeps every element.
int glu_drop_pool(const float* y, const float* scale_f, const float* bias_f,
                  const float* wg, const float* bg, const uint8_t* bits, float* z,
                  int B, int T, int F, int Co, int pt, int pf,
                  int keep_thresh, float inv_keep, cudaStream_t stream) {
  const int W = pt * pf;
  int NQ = 4096 / (W * Co);
  if (NQ < 1) NQ = 1;
  const int K4 = (Co + 3) & ~3;
  const int S = (K4 / 4) % 2 == 0 ? K4 + 4 : K4 + 8;
  const int NR = NQ * W;
  const size_t smem = sizeof(float) * ((size_t)Co * S + (size_t)NR * S) +
                      (size_t)NR * (sizeof(long long) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      glu_drop_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glu_drop_pool_kernel, 256, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) per_sm = 1;
  const long long Q = (long long)B * (T / pt) * (F / pf);
  const long long n_tiles = (Q + NQ - 1) / NQ;
  if (n_tiles == 0) return (int)cudaGetLastError();
  long long grid = (long long)per_sm * n_sm;
  if (grid > n_tiles) grid = n_tiles;
  glu_drop_pool_kernel<<<(unsigned)grid, 256, smem, stream>>>(
      y, scale_f, bias_f, wg, bg, bits, z, B, T, F, Co, pt, pf, keep_thresh,
      inv_keep, NQ, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
