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
//   :173-178). A slice's (dt, df, ci) per depth index come from a small
//   table that 16 threads fill (no integer division per staged element),
//   and the next slice is loaded into registers while the current one is
//   multiplied. The per-lane sum and sum of squares of y over all rows are a
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
//
// The backward passes (the training step's kernels):
//   conv_bn_stats_bwd <- _conv_stats_bwd_kernel (pallas_cnn.py:186, :443)
//   glu_drop_pool_bwd <- _epilogue_bwd_kernel   (pallas_cnn.py:295, :637)
//
// conv_bn_stats_bwd
//   What bounds it: dx and dW are each about as many FMAs as the forward
//   conv, ~200 GFLOP per 2024 train step at B=60 (~3 ms at the fp32 peak)
//   against ~2 GB of x, y, dy and dx: operations.
//   Design: dy_eff = dy + ds[lane] + 2 y dq[lane] (the BatchNorm statistics'
//   cotangents, pallas_cnn.py:207) is formed while staging, never stored.
//   dx is the forward's implicit GEMM over dy_eff with the flipped,
//   transposed weight w[::-1, ::-1]^T (pallas_cnn.py:439). dW is a
//   [9*Ci, M] x [M, Co] product with M = B*T*F up to 4.8 M rows: the rows
//   are cut into chunks (about 528 blocks in all), each block writes its
//   chunk's partial dW tile (and dbias), and a second pass adds the chunks
//   in a fixed order. No atomics: two runs give bitwise-equal gradients.
//   On the TPU the sequential grid carried dW in scratch (:195-198, :247).
//
// glu_drop_pool_bwd
//   What bounds it: three [Co] x [Co, Co] products per position (the GLU
//   recomputed, dlin Wg^T, and ybn^T dlin for dWg), ~50 GFLOP per train
//   step at B=60 (~0.75 ms at the fp32 peak), against ~1.5 GB of y, dy and
//   bits (~0.45 ms): operations.
//   Design: one pass over y. Persistent blocks each walk a contiguous run of
//   frames (b, t) = F*Co lanes, recomputing BN(y), the GLU and the sigmoid
//   in shared memory; the incoming gradient is unpooled (rows and columns
//   past the pooled extent get 0, their dy is then the statistics' share
//   alone) and masked by the saved bits with the thresholds of
//   pallas_cnn.py:616. The two per-position products (the GLU and
//   dlin Wg^T) give each thread 4 channels: float4 rows of Wg and of a
//   transposed copy of it in shared memory, 4 FMAs per broadcast value.
//   Per-lane sums of dybn*y, dybn and dlin live in shared memory (one owner
//   thread per lane); dWg in registers (an 8x8 tile per thread at Co=128).
//   Block partials are added in a fixed order by two small passes.
//   Co <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Depth index k = tap * C + c of the implicit GEMMs, tap = (dt+1)*3 + (df+1):
// the (dt, df, c) of one k. dt is NO_TAP past the depth K, so that every
// row reads 0 there.
constexpr int NO_TAP = -(1 << 28);

__device__ __forceinline__ void decode_tap(int k, int K, int C, int& dt, int& df, int& c) {
  if (k < K) {
    const int tap = k / C;
    c = k - tap * C;
    dt = tap / 3 - 1;
    df = tap % 3 - 1;
  } else {
    dt = NO_TAP;
    df = 0;
    c = 0;
  }
}

// One im2col element of row r (coordinates t, f) at tap (dt, df, c), zero
// outside the SAME padding; with EFF the staged value is
// dy_eff = dy + ds[lane] + 2 * ye * dq[lane], lane = (f + df) * C + c.
template <bool EFF>
__device__ __forceinline__ float im2col_at(const float* __restrict__ x,
                                           const float* __restrict__ ye,
                                           const float* __restrict__ ds,
                                           const float* __restrict__ dq, long long m,
                                           int t, int f, int dt, int df, int c, int T,
                                           int F, int C) {
  const int tt = t + dt;
  const int ff = f + df;
  if (tt < 0 || tt >= T || ff < 0 || ff >= F) return 0.f;
  const long long idx = (m + (long long)dt * F + df) * C + c;
  if constexpr (EFF) {
    const int lane = ff * C + c;
    return x[idx] + ds[lane] + 2.f * ye[idx] * dq[lane];
  } else {
    return x[idx];
  }
}

// EFF (the backward's dx): the input is dy and each staged element is
// dy_eff (im2col_at); no bias. Each BK-deep slice's (dt, df, c) come from a
// small table that 16 threads fill for the next slice, and the next slice's
// global loads are issued into registers before the current slice's
// products, so they overlap.
template <bool EFF, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3x3_bias_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    const float* __restrict__ ye, const float* __restrict__ ds,
                    const float* __restrict__ dq,
                    int B, int T, int F, int Ci, int Co) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int AE = BM * BK / NT;  // A-tile elements per thread
  constexpr int BE = BK * BN / NT;  // B-tile elements per thread
  constexpr int RS = NT / BK;       // row stride between a thread's A elements
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0 && (BK * BN) % NT == 0, "tile shape");
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int row_t[BM];
  __shared__ int row_f[BM];
  __shared__ int tap[2][3][BK];

  const long long M = (long long)B * T * F;
  const int K = 9 * Ci;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int kk_a = tid % BK;  // this thread's A-tile depth column
  const int r_a = tid / BK;   // and its first row

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
  if (tid < BK) decode_tap(tid, K, Ci, tap[0][0][tid], tap[0][1][tid], tap[0][2][tid]);
  __syncthreads();

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[AE], b_reg[BE];
  const int n_slices = (K + BK - 1) / BK;
  for (int sl = 0; sl <= n_slices; ++sl) {
    // sl == 0 only loads slice 0; afterwards slice sl - 1 is staged and
    // multiplied while slice sl is loaded.
    if (sl > 0) {
#pragma unroll
      for (int j = 0; j < AE; ++j) As[kk_a][r_a + j * RS] = a_reg[j];
#pragma unroll
      for (int j = 0; j < BE; ++j) {
        const int i = tid + j * NT;
        Bs[i / BN][i % BN] = b_reg[j];
      }
      if (tid < BK && sl < n_slices)
        decode_tap(sl * BK + tid, K, Ci, tap[sl & 1][0][tid], tap[sl & 1][1][tid],
                   tap[sl & 1][2][tid]);
      __syncthreads();
    }
    if (sl < n_slices) {
      const int k0 = sl * BK;
      const int dt = tap[sl & 1][0][kk_a], df = tap[sl & 1][1][kk_a], c = tap[sl & 1][2][kk_a];
#pragma unroll
      for (int j = 0; j < AE; ++j) {
        const int r = r_a + j * RS;
        a_reg[j] = im2col_at<EFF>(x, ye, ds, dq, m0 + r, row_t[r], row_f[r], dt, df, c, T,
                                  F, Ci);
      }
#pragma unroll
      for (int j = 0; j < BE; ++j) {
        const int i = tid + j * NT;
        const int k = k0 + i / BN;
        const int co = n0 + i % BN;
        b_reg[j] = (k < K && co < Co) ? w[(long long)k * Co + co] : 0.f;
      }
    }
    if (sl > 0) {
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
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Co) y[m * Co + co] = EFF ? acc[i][j] : acc[i][j] + bias[co];
    }
  }
}

template <bool EFF, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_conv(const float* x, const float* w, const float* bias, float* y,
                        const float* ye, const float* ds, const float* dq,
                        int B, int T, int F, int Ci, int Co, cudaStream_t s) {
  const long long M = (long long)B * T * F;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  conv3x3_bias_kernel<EFF, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(
      x, w, bias, y, ye, ds, dq, B, T, F, Ci, Co);
  return cudaGetLastError();
}

// Output-channel count Co picks the tile: small Co keeps a 128-wide tile
// from running mostly empty.
template <bool EFF>
cudaError_t launch_conv_any(const float* x, const float* w, const float* bias, float* y,
                            const float* ye, const float* ds, const float* dq,
                            int B, int T, int F, int Ci, int Co, cudaStream_t s) {
  if (Co >= 128)
    return launch_conv<EFF, 128, 128, 16, 8, 8>(x, w, bias, y, ye, ds, dq, B, T, F, Ci, Co, s);
  if (Co >= 64)
    return launch_conv<EFF, 128, 64, 16, 8, 4>(x, w, bias, y, ye, ds, dq, B, T, F, Ci, Co, s);
  if (Co >= 32)
    return launch_conv<EFF, 128, 32, 16, 4, 4>(x, w, bias, y, ye, ds, dq, B, T, F, Ci, Co, s);
  return launch_conv<EFF, 128, 16, 16, 4, 2>(x, w, bias, y, ye, ds, dq, B, T, F, Ci, Co, s);
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

// ---------------------------------------------------------------------------
// conv_bn_stats_bwd: dW and dbias partials. Block (kt, ct, chunk) computes
// the [BKO x BNO] tile of dW[k][co] = sum_m im2col(x)[m][k] * dy_eff[m][co]
// over the rows m of its chunk, 16 rows per stage; blocks with kt == 0 also
// sum dy_eff per channel (dbias). 256 threads, each a TM x TN register
// tile. A thread stages one fixed depth column k (and one channel co), so
// its (dt, df, c) are decoded once; the next stage's loads are issued into
// registers before the current stage's products.
// ---------------------------------------------------------------------------
template <int BKO, int BNO>
__global__ void __launch_bounds__(256) conv3x3_dw_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ dy, const float* __restrict__ ds,
    const float* __restrict__ dq, float* __restrict__ part_w,
    float* __restrict__ part_b, int B, int T, int F, int Ci, int Co,
    long long rows_per_chunk) {
  constexpr int BR = 16;
  constexpr int TM = BKO / 16;
  constexpr int TN = BNO / 16;
  constexpr int AE = BR * BKO / 256;  // staged elements per thread
  constexpr int BE = BR * BNO / 256;
  __shared__ __align__(16) float As[BR][BKO + 4];
  __shared__ __align__(16) float Bs[BR][BNO + 4];
  __shared__ int row_t[2][BR];
  __shared__ int row_f[2][BR];

  const long long M = (long long)B * T * F;
  const int K = 9 * Ci;
  const int k0 = blockIdx.x * BKO;
  const int n0 = blockIdx.y * BNO;
  const long long chunk = blockIdx.z;
  const long long r_begin = chunk * rows_per_chunk;
  const long long r_end = min(M, r_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool do_bias = blockIdx.x == 0 && tid < BNO;
  const int kk_a = tid % BKO, r_a = tid / BKO;  // A: rows r_a + j * (256 / BKO)
  const int n_b = tid % BNO, r_b = tid / BNO;   // B: rows r_b + j * (256 / BNO)
  const int co_b = n0 + n_b;
  int dt, df, c;
  decode_tap(k0 + kk_a, K, Ci, dt, df, c);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;
  float a_reg[AE], b_reg[BE];

  auto rows_of = [&](int buf, long long m0) {
    if (tid < BR) {
      const long long m = m0 + tid;
      if (m < r_end) {
        row_f[buf][tid] = (int)(m % F);
        row_t[buf][tid] = (int)((m / F) % T);
      } else {
        row_f[buf][tid] = 0;
        row_t[buf][tid] = -4;  // every tap outside [0, T), and no dy_eff
      }
    }
  };
  rows_of(0, r_begin);
  __syncthreads();

  const long long n_stages = r_end > r_begin ? (r_end - r_begin + BR - 1) / BR : 0;
  for (long long st = 0; st <= n_stages; ++st) {
    const int buf = (int)(st & 1);
    // st == 0 only loads stage 0; afterwards stage st - 1 is staged and
    // multiplied while stage st is loaded.
    if (st > 0) {
#pragma unroll
      for (int j = 0; j < AE; ++j) As[r_a + j * (256 / BKO)][kk_a] = a_reg[j];
#pragma unroll
      for (int j = 0; j < BE; ++j) Bs[r_b + j * (256 / BNO)][n_b] = b_reg[j];
      if (st < n_stages) rows_of(buf, r_begin + st * BR);
      __syncthreads();
    }
    if (st < n_stages) {
      const long long m0 = r_begin + st * BR;
#pragma unroll
      for (int j = 0; j < AE; ++j) {
        const int r = r_a + j * (256 / BKO);
        a_reg[j] = im2col_at<false>(x, nullptr, nullptr, nullptr, m0 + r, row_t[buf][r],
                                    row_f[buf][r], dt, df, c, T, F, Ci);
      }
#pragma unroll
      for (int j = 0; j < BE; ++j) {
        const int r = r_b + j * (256 / BNO);
        float v = 0.f;
        if (co_b < Co && row_t[buf][r] >= 0) {
          const long long idx = (m0 + r) * Co + co_b;
          const int lane = row_f[buf][r] * Co + co_b;
          v = dy[idx] + ds[lane] + 2.f * y[idx] * dq[lane];
        }
        b_reg[j] = v;
      }
    }
    if (st > 0) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[r][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[r][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (do_bias) {
#pragma unroll
        for (int r = 0; r < BR; ++r) bsum += Bs[r][tid];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty * TM + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Co) part_w[(chunk * K + k) * Co + co] = acc[i][j];
    }
  }
  if (do_bias && n0 + tid < Co) part_b[chunk * Co + n0 + tid] = bsum;
}

template <int BKO, int BNO>
cudaError_t launch_dw(const float* x, const float* y, const float* dy, const float* ds,
                      const float* dq, float* part_w, float* part_b, int B, int T, int F,
                      int Ci, int Co, int n_chunks, cudaStream_t s) {
  const long long M = (long long)B * T * F;
  long long rpc = (M + n_chunks - 1) / n_chunks;
  rpc = (rpc + 15) / 16 * 16;
  dim3 grid((9 * Ci + BKO - 1) / BKO, (Co + BNO - 1) / BNO, n_chunks);
  conv3x3_dw_kernel<BKO, BNO><<<grid, 256, 0, s>>>(x, y, dy, ds, dq, part_w, part_b,
                                                   B, T, F, Ci, Co, rpc);
  return cudaGetLastError();
}

// dW tile sides: the depth K = 9*Ci and the channels Co pick 16, 32, 64 or
// 128 (128 only where the tile stays mostly full: K >= 512, Co > 64).
int dw_tile_k(int K) { return K <= 16 ? 16 : (K <= 32 ? 32 : (K < 512 ? 64 : 128)); }
int dw_tile_n(int Co) { return Co <= 16 ? 16 : (Co <= 32 ? 32 : (Co <= 64 ? 64 : 128)); }

template <int BKO>
cudaError_t launch_dw_n(const float* x, const float* y, const float* dy, const float* ds,
                        const float* dq, float* part_w, float* part_b, int B, int T, int F,
                        int Ci, int Co, int n_chunks, cudaStream_t s) {
  switch (dw_tile_n(Co)) {
    case 16: return launch_dw<BKO, 16>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, s);
    case 32: return launch_dw<BKO, 32>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, s);
    case 64: return launch_dw<BKO, 64>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, s);
    default: return launch_dw<BKO, 128>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, s);
  }
}

// dW[e] and dbias[c]: the chunks' partials added in chunk order.
__global__ void dw_final_kernel(const float* __restrict__ part_w,
                                const float* __restrict__ part_b, float* __restrict__ dw,
                                float* __restrict__ db, int KC, int Co, int n_chunks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < KC) {
    float a = 0.f;
    for (int c = 0; c < n_chunks; ++c) a += part_w[(long long)c * KC + e];
    dw[e] = a;
  }
  if (e < Co) {
    float b = 0.f;
    for (int c = 0; c < n_chunks; ++c) b += part_b[(long long)c * Co + e];
    db[e] = b;
  }
}

// ---------------------------------------------------------------------------
// glu_drop_pool_bwd. Persistent blocks of 256 threads; block i walks a
// contiguous run of frames (b, t), each frame the F positions x Co channels
// of y[b, t]. Per frame: (1) ybn and the unpooled, dropout-masked incoming
// gradient gu, per lane; (2) lin = ybn Wg + bg and dlin = gu * sigmoid(ybn);
// (3) dybn = dlin Wg^T + gu lin s (1 - s), dy = dybn * scale, and per-lane
// sums of dybn * y, dybn and dlin; (4) dWg += ybn^T dlin, each thread an
// NI x NI register tile of dWg (rows ty + 16 i, columns tx + 16 j). Steps 2
// and 3 give each thread 4 channels of one position: a float4 row of Wg
// (step 2) or of Wg^T (step 3) feeds 4 FMAs per broadcast BN(y) or dlin
// value. Each lane's sums have one owner thread, and the block's partials
// go to global memory at the end.
// smem: Wg [Co][C4] | Wg^T [Co][C4] | ybn | gu | lin | dlin [F][C4+1] |
// lane sums [3][F][C4+1], C4 = Co rounded up to 4 (zero columns); the odd
// row stride C4+1 keeps the per-position reads of step 2 and 3 apart in the
// banks when one warp spans several positions.
// ---------------------------------------------------------------------------
template <int NI>
__global__ void __launch_bounds__(256) glu_drop_pool_bwd_kernel(
    const float* __restrict__ y, const float* __restrict__ scale_f,
    const float* __restrict__ bias_f, const float* __restrict__ wg,
    const float* __restrict__ bg, const uint8_t* __restrict__ bits,
    const float* __restrict__ g, float* __restrict__ dy, float* __restrict__ part_l,
    float* __restrict__ part_w, int B, int T, int F, int Co, int pt, int pf,
    int keep_thresh, float inv_keep) {
  extern __shared__ __align__(16) float smem[];
  const int L = F * Co;
  const int C4 = (Co + 3) & ~3;
  const int G = C4 / 4;  // channel groups of 4
  const int YS = C4 + 1;
  const int FY = F * YS;
  float* wg_s = smem;             // [k][c]
  float* wgT_s = wg_s + Co * C4;  // [c][k]
  float* ybn_s = wgT_s + Co * C4;
  float* gu_s = ybn_s + FY;
  float* lin_s = gu_s + FY;
  float* dlin_s = lin_s + FY;
  float* acc_s = dlin_s + FY;  // [3][F][YS]
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long n_frames = (long long)B * T;
  const long long per = (n_frames + gridDim.x - 1) / gridDim.x;
  const long long fr0 = blockIdx.x * per;
  const long long fr1 = min(n_frames, fr0 + per);
  const int To = T / pt, Fo = F / pf;
  const float inv_w = 1.f / (float)(pt * pf);

  for (int i = tid; i < Co * C4; i += 256) {
    const int row = i / C4;
    const int col = i - row * C4;
    wg_s[i] = col < Co ? wg[row * Co + col] : 0.f;
    wgT_s[i] = col < Co ? wg[col * Co + row] : 0.f;
  }
  for (int i = tid; i < 3 * FY; i += 256) acc_s[i] = 0.f;
  float accw[NI][NI];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) accw[i][j] = 0.f;

  for (long long fr = fr0; fr < fr1; ++fr) {
    const int t = (int)(fr % T);
    const long long b = fr / T;
    const float* yf = y + fr * L;
    __syncthreads();  // Wg staged / the previous frame's step 4 is done
    for (int l = tid; l < L; l += 256) {
      const int f = l / Co;
      const int c = l - f * Co;
      ybn_s[f * YS + c] = fmaf(yf[l], scale_f[l], bias_f[l]);
      float gv = 0.f;
      if (t < To * pt && f < Fo * pf) {
        gv = g[((b * To + t / pt) * Fo + f / pf) * Co + c] * inv_w;
      }
      if (bits != nullptr) gv = (int)bits[fr * L + l] < keep_thresh ? gv * inv_keep : 0.f;
      gu_s[f * YS + c] = gv;
    }
    __syncthreads();
    for (int it = tid; it < F * G; it += 256) {
      const int f = it / G;
      const int c0 = 4 * (it - f * G);
      const float* yr = ybn_s + f * YS;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int k = 0; k < Co; ++k) {
        const float v = yr[k];
        const float4 w4 = *reinterpret_cast<const float4*>(wg_s + k * C4 + c0);
        a.x = fmaf(v, w4.x, a.x);
        a.y = fmaf(v, w4.y, a.y);
        a.z = fmaf(v, w4.z, a.z);
        a.w = fmaf(v, w4.w, a.w);
      }
      const float lin[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j;
        if (c >= Co) break;
        const int o = f * YS + c;
        lin_s[o] = lin[j] + bg[c];
        dlin_s[o] = gu_s[o] * sigmoidf(ybn_s[o]);
      }
    }
    __syncthreads();
    for (int it = tid; it < F * G; it += 256) {
      const int f = it / G;
      const int k0 = 4 * (it - f * G);
      const float* dr = dlin_s + f * YS;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = 0; c < Co; ++c) {
        const float v = dr[c];
        const float4 w4 = *reinterpret_cast<const float4*>(wgT_s + c * C4 + k0);
        a.x = fmaf(v, w4.x, a.x);
        a.y = fmaf(v, w4.y, a.y);
        a.z = fmaf(v, w4.z, a.z);
        a.w = fmaf(v, w4.w, a.w);
      }
      const float dglu[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j;
        if (k >= Co) break;
        const int o = f * YS + k;
        const int lane = f * Co + k;
        const float s = sigmoidf(ybn_s[o]);
        const float dybn = dglu[j] + gu_s[o] * lin_s[o] * s * (1.f - s);
        dy[fr * L + lane] = dybn * scale_f[lane];
        acc_s[o] += dybn * yf[lane];
        acc_s[FY + o] += dybn;
        acc_s[2 * FY + o] += dlin_s[o];
      }
    }
    for (int f = 0; f < F; ++f) {
      const float* yr = ybn_s + f * YS;
      const float* dr = dlin_s + f * YS;
      float a[NI], d[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int k = ty + 16 * i;
        a[i] = k < Co ? yr[k] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = tx + 16 * j;
        d[j] = c < Co ? dr[c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) accw[i][j] = fmaf(a[i], d[j], accw[i][j]);
    }
  }
  __syncthreads();
  float* pl = part_l + (long long)blockIdx.x * 3 * L;
  for (int i = tid; i < 3 * L; i += 256) {
    const int a = i / L;
    const int l = i - a * L;
    const int f = l / Co;
    pl[i] = acc_s[a * FY + f * YS + (l - f * Co)];
  }
  float* pw = part_w + (long long)blockIdx.x * Co * Co;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int k = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int c = tx + 16 * j;
      if (k < Co && c < Co) pw[k * Co + c] = accw[i][j];
    }
  }
}

size_t glu_bwd_smem(int F, int Co) {
  const size_t c4 = (size_t)((Co + 3) & ~3);
  return sizeof(float) * (2 * (size_t)Co * c4 + 7 * (size_t)F * (c4 + 1));
}

template <int NI>
cudaError_t glu_bwd_occupancy(size_t smem, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(glu_drop_pool_bwd_kernel<NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, glu_drop_pool_bwd_kernel<NI>,
                                                       256, smem);
}

int glu_ni(int Co) { return Co <= 16 ? 1 : (Co <= 32 ? 2 : (Co <= 64 ? 4 : 8)); }

// Lane sums of the blocks' partials, in block order; the dlin lane sums are
// left in part_l[0][2] for glu_bwd_final_w.
__global__ void glu_bwd_final_lanes(float* __restrict__ part_l, float* __restrict__ dscale_f,
                                    float* __restrict__ dbias_f, int L, int n_blocks) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float a = 0.f, b = 0.f, c = 0.f;
  for (int i = 0; i < n_blocks; ++i) {
    const float* p = part_l + (long long)i * 3 * L;
    a += p[l];
    b += p[L + l];
    c += p[2 * L + l];
  }
  dscale_f[l] = a;
  dbias_f[l] = b;
  part_l[2 * L + l] = c;
}

// dWg[e] over blocks in order; dbg[c] over the F lanes of channel c in order.
__global__ void glu_bwd_final_w(const float* __restrict__ part_l,
                                const float* __restrict__ part_w, float* __restrict__ dwg,
                                float* __restrict__ dbg, int F, int Co, int n_blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int CC = Co * Co;
  if (e < CC) {
    float a = 0.f;
    for (int i = 0; i < n_blocks; ++i) a += part_w[(long long)i * CC + e];
    dwg[e] = a;
  }
  if (e < Co) {
    const float* lanes = part_l + 2 * (long long)F * Co;
    float a = 0.f;
    for (int f = 0; f < F; ++f) a += lanes[f * Co + e];
    dbg[e] = a;
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
  cudaError_t err = launch_conv_any<false>(x, w, bias, y, nullptr, nullptr, nullptr,
                                           B, T, F, Ci, Co, stream);
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

extern "C" {

// Number of row chunks of conv_bn_stats_bwd's dW pass (the wrapper sizes the
// partial buffers [n_chunks, 9*Ci, Co] and [n_chunks, Co] with it): about
// 528 blocks in all, at least 64 rows per chunk. It depends on the shapes
// only, so the summation order is the same on every run.
int conv_bn_stats_bwd_chunks(int B, int T, int F, int Ci, int Co) {
  const long long M = (long long)B * T * F;
  const int tiles = ((9 * Ci + dw_tile_k(9 * Ci) - 1) / dw_tile_k(9 * Ci)) *
                    ((Co + dw_tile_n(Co) - 1) / dw_tile_n(Co));
  long long n = 528 / tiles;
  const long long max_n = (M + 63) / 64;
  if (n > max_n) n = max_n;
  return n < 1 ? 1 : (int)n;
}

// Backward of conv_bn_stats. x [B,T,F,Ci], y/dy [B,T,F,Co], ds/dq [F*Co];
// wt [3,3,Co,Ci] = w flipped in (dt, df) and transposed in (Ci, Co);
// dx [B,T,F,Ci] (skipped when dx or wt is NULL); dw [3,3,Ci,Co]; db [Co].
int conv_bn_stats_bwd(const float* x, const float* wt, const float* y, const float* dy,
                      const float* ds, const float* dq, float* dx, float* part_w,
                      float* part_b, float* dw, float* db, int B, int T, int F, int Ci,
                      int Co, int n_chunks, cudaStream_t stream) {
  cudaError_t err;
  if (dx != nullptr && wt != nullptr) {
    // dx = SAME conv3x3 of dy_eff (Co channels in, Ci out) with wt
    err = launch_conv_any<true>(dy, wt, nullptr, dx, y, ds, dq, B, T, F, Co, Ci, stream);
    if (err != cudaSuccess) return (int)err;
  }
  switch (dw_tile_k(9 * Ci)) {
    case 16: err = launch_dw_n<16>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, stream); break;
    case 32: err = launch_dw_n<32>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, stream); break;
    case 64: err = launch_dw_n<64>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, stream); break;
    default: err = launch_dw_n<128>(x, y, dy, ds, dq, part_w, part_b, B, T, F, Ci, Co, n_chunks, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int KC = 9 * Ci * Co;
  dw_final_kernel<<<(KC + 255) / 256, 256, 0, stream>>>(part_w, part_b, dw, db, KC, Co, n_chunks);
  return (int)cudaGetLastError();
}

// Number of persistent blocks of glu_drop_pool_bwd (the wrapper sizes the
// partial buffers with it), or 0 when Co > 128 or a frame's F*Co lanes do
// not fit in shared memory.
int glu_drop_pool_bwd_blocks(int n_frames, int F, int Co) {
  if (Co > 128 || Co < 1) return 0;
  const size_t smem = glu_bwd_smem(F, Co);
  if (smem > 227 * 1024) return 0;
  int per_sm = 0, dev = 0, n_sm = 0;
  cudaError_t err;
  switch (glu_ni(Co)) {
    case 1: err = glu_bwd_occupancy<1>(smem, &per_sm); break;
    case 2: err = glu_bwd_occupancy<2>(smem, &per_sm); break;
    case 4: err = glu_bwd_occupancy<4>(smem, &per_sm); break;
    default: err = glu_bwd_occupancy<8>(smem, &per_sm); break;
  }
  if (err != cudaSuccess || per_sm < 1) return 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  long long n = (long long)per_sm * n_sm;
  if (n > n_frames) n = n_frames;
  return n < 1 ? 1 : (int)n;
}

// Backward of glu_drop_pool. g [B, T//pt, F//pf, Co]; dy like y;
// part_l [n_blocks, 3, F*Co], part_w [n_blocks, Co*Co] scratch;
// dscale_f, dbias_f [F*Co]; dwg [Co, Co]; dbg [Co].
int glu_drop_pool_bwd(const float* y, const float* scale_f, const float* bias_f,
                      const float* wg, const float* bg, const uint8_t* bits, const float* g,
                      float* dy, float* part_l, float* part_w, float* dscale_f,
                      float* dbias_f, float* dwg, float* dbg, int B, int T, int F, int Co,
                      int pt, int pf, int keep_thresh, int n_blocks, float inv_keep,
                      cudaStream_t stream) {
  const size_t smem = glu_bwd_smem(F, Co);
  int per_sm = 0;
  cudaError_t err;
#define GLU_BWD_CASE(NI)                                                                   \
  err = glu_bwd_occupancy<NI>(smem, &per_sm);                                              \
  if (err != cudaSuccess) return (int)err;                                                 \
  glu_drop_pool_bwd_kernel<NI><<<n_blocks, 256, smem, stream>>>(                           \
      y, scale_f, bias_f, wg, bg, bits, g, dy, part_l, part_w, B, T, F, Co, pt, pf,        \
      keep_thresh, inv_keep);                                                              \
  break;
  switch (glu_ni(Co)) {
    case 1: GLU_BWD_CASE(1)
    case 2: GLU_BWD_CASE(2)
    case 4: GLU_BWD_CASE(4)
    default: GLU_BWD_CASE(8)
  }
#undef GLU_BWD_CASE
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int L = F * Co;
  glu_bwd_final_lanes<<<(L + 255) / 256, 256, 0, stream>>>(part_l, dscale_f, dbias_f, L,
                                                           n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glu_bwd_final_w<<<(Co * Co + 255) / 256, 256, 0, stream>>>(part_l, part_w, dwg, dbg, F, Co,
                                                             n_blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
