// Hand-written Hopper kernels for the fused log-mel front-end.
//
// Replace desed_task_tpu/ops/pallas_mel.py: the inner `kernel` of
// pallas_log_mel (pallas_mel.py:96, called at :147).
//
// Per clip b and frame t, from the center-padded audio xpad (the caller
// pads; power 1):
//   re[f], im[f] = sum over k of xpad[b, t*hop + k] * (cos, -sin)[k, f]
//                  (the windowed DFT basis, frontend._dft_basis)
//   mag[f]       = sqrt(re^2 + im^2)
//   mel[m]       = sum over f of mag[f] * fb[f, m]
//   out[b, m, t] = clamp(20 * ln(max(mel, amin)) * log10(e) - shift, lo, hi)
// In bf16 mode the frame samples, the basis, the magnitudes and the
// filterbank are rounded to bf16 where the TPU kernel rounds them
// (pallas_mel.py:77-87, :119, :128) and every product is summed in fp32.
//
// What bounds it: at B=64 ten-second clips (626 frames, n_fft 2048, 1025
// frequencies, 128 mels) the DFT is 2 * 40064 * 2048 * 2050 = 336.4 GFLOP
// and the mel product 10.5 GFLOP: ~347 GFLOP, 5.18 ms at the H100's
// 67 TFLOP/s fp32 CUDA-core peak, 0.35 ms at 989 TFLOP/s on the bf16 tensor
// cores. The bytes are ~41 MB of audio in and 20.5 MB of log-mel out,
// ~0.02 ms at 3.35 TB/s: operations bound it.
//
// Two kernels share one design. fused_log_mel_kernel<E> runs fp32 (E =
// float) and, for the shapes the other does not take, bf16 (E =
// __nv_bfloat16), as fp32 FMAs on the CUDA cores. fused_log_mel_tc_kernel
// runs bf16 on the tensor cores (mma.sync m16n8k16) when hop % 8 == 0 and
// n_mels <= 128; `plan` picks one. In both:
//   - One block owns TT frames of one clip (64 when they fit) and every
//     output of those frames, so no sum crosses blocks: no atomics, and
//     reruns are bitwise equal. The TPU carried the mel accumulator in
//     scratch across a sequential grid axis over frequency tiles
//     (pallas_mel.py:89-90, :131-137); here a loop inside the block walks
//     the frequency tiles.
//   - The block's contiguous span of padded audio, (TT - 1) * hop + n_fft
//     samples (72.7 KB fp32 at TT = 64), is staged once in shared memory.
//     Frame t's sample k is span[t * hop + k]: frames are never written out.
//   - For each tile of TF = 128 frequencies, the basis streams through
//     shared memory in slices of a few samples (cp.async, two stages, the
//     next slice in flight while the current one is used; the whole basis
//     stays in the 50 MB L2). The wrapper lays the basis out slice by slice
//     for the frequencies from the first to the last whose filterbank row is
//     not all zero (with f_min = 0 the DC row is, which leaves 1024 bins:
//     8 tiles instead of 9 at n_fft 2048), zero past the last (a ragged last
//     tile) and past n_fft. Here n_freqs counts the frequencies laid out.
//   - After a tile, its magnitudes go to shared memory and the tile's mel
//     contribution mag^T fb is added to an fp32 accumulator.
//   - The log-dB and clamp epilogue writes out[b, :, t0:t0+TT], t fastest.
// fused_log_mel_kernel: warp w owns frames 8w..8w+7, lane l frequencies
//   4l..4l+3; a thread keeps an 8 x 4 tile of re and of im in registers and
//   per sample reads the warp's 8 samples (broadcast) and one float4 each of
//   cos and -sin. The mel accumulator [TT][n_mels] lives in shared memory,
//   fb is read through L1. Takes any hop, n_fft, n_mels and frame count for
//   which some TT in {64, 32, 16, 8} fits 227 KB of shared memory.
// fused_log_mel_tc_kernel: see its own note below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF = 128;  // frequencies per tile: 32 lanes x 4
constexpr int BK = 32;   // samples per staged basis slice
constexpr int RPT = 8;   // frames per thread (one warp = 8 frames)
constexpr int FPT = 4;   // frequencies (and mels) per thread
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the opt-in limit per block
constexpr float LOG10E = 0.43429448190325176f;

template <typename E>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// out[b, m, t0 + t] = clamp(20 * ln(max(acc[t][m], amin)) * log10(e) - shift,
// lo, hi) for the block's frames below T, t fastest (coalesced writes).
__device__ __forceinline__ void log_db_out(const float* acc, int MS, int TT, int t0, int T,
                                           int b, int n_mels, float amin, float shift,
                                           float lo, float hi, float* __restrict__ out) {
  for (int i = threadIdx.x; i < TT * n_mels; i += blockDim.x) {
    const int t = i % TT, m = i / TT;
    if (t0 + t >= T) continue;
    float v = acc[t * MS + m];
    v = v < amin ? amin : v;  // NaN stays NaN, as with jnp.maximum
    float db = 20.f * (logf(v) * LOG10E) - shift;
    db = db < lo ? lo : db;
    db = db > hi ? hi : db;
    out[((size_t)b * n_mels + m) * T + t0 + t] = db;
  }
}

// Shared-memory layout, in bytes: span (floats, padded to 16 B), two basis
// slices (E), the magnitude buffer [TF][TT + 4] and the mel accumulator
// [TT][n_mels + 1] (floats).
struct Layout {
  int span_len, mag_off, acc_off;
  size_t stage_off, bytes;
  __host__ __device__ Layout(int TT, int n_fft, int hop, int n_mels, int esize) {
    span_len = round_up((TT - 1) * hop + round_up(n_fft, BK), 4);
    stage_off = (size_t)span_len * 4;
    const size_t stage_bytes = (size_t)2 * BK * 2 * TF * esize;
    mag_off = (int)((stage_off + stage_bytes) / 4);
    acc_off = mag_off + TF * (TT + 4);
    bytes = (size_t)(acc_off + TT * (n_mels + 1)) * 4;
  }
};

template <typename E, bool VEC>
__global__ void __launch_bounds__(256) fused_log_mel_kernel(
    const float* __restrict__ x,      // [B, n_pad] center-padded audio
    const E* __restrict__ kbasis,     // [n_tiles][KP][2 * TF]
    const E* __restrict__ kfb,        // [n_tiles * TF][MP]
    float* __restrict__ out,          // [B, n_mels, T]
    int n_pad, int T, int TT, int n_fft, int hop, int n_freqs, int n_mels,
    float amin, float shift, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(TT, n_fft, hop, n_mels, sizeof(E));
  float* span = smem;
  E* stage = reinterpret_cast<E*>(reinterpret_cast<char*>(smem) + L.stage_off);
  float* magT = smem + L.mag_off;  // [TF][TS]
  float* acc = smem + L.acc_off;   // [TT][MS]
  const int TS = TT + 4, MS = n_mels + 1;
  const int MP = round_up(n_mels, 4);
  constexpr int SLICE = BK * 2 * TF;                    // elements of one slice
  constexpr int CHUNKS = SLICE * (int)sizeof(E) / 16;  // 16-byte copies per slice

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  const int n_chunks = round_up(n_fft, BK) / BK;
  const int n_tiles = (n_freqs + TF - 1) / TF;
  const int n_steps = n_tiles * n_chunks;
  auto issue = [&](int step) {
    const char* src = reinterpret_cast<const char*>(kbasis + (size_t)step * SLICE);
    char* dst = reinterpret_cast<char*>(stage + (step & 1) * SLICE);
    for (int c = tid; c < CHUNKS; c += nthreads) cp_async16(dst + c * 16, src + c * 16);
    cp_async_commit();
  };
  issue(0);

  const float* xb = x + (size_t)b * n_pad;
  const long long s0 = (long long)t0 * hop;
  for (int i = tid; i < L.span_len; i += nthreads) {
    const long long g = s0 + i;
    span[i] = g < n_pad ? round_to<E>(xb[g]) : 0.f;
  }
  for (int i = tid; i < TT * MS; i += nthreads) acc[i] = 0.f;

  const int r0 = warp * RPT;  // this warp's first frame in the tile
  const float* arow = span + r0 * hop;
  float re[RPT][FPT], im[RPT][FPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < FPT; ++j) re[i][j] = im[i][j] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) issue(step + 1);
    else cp_async_commit();  // an empty group keeps the wait count uniform
    cp_async_wait_one();
    __syncthreads();
    const int chunk = step % n_chunks;
    const E* bt = stage + (step & 1) * SLICE;
    const float* a = arow + chunk * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float av[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if constexpr (VEC) {
          const float4 v = *reinterpret_cast<const float4*>(a + i * hop + kk);
          av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) av[i][q] = a[i * hop + kk + q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 c = load4(bt + (kk + q) * 2 * TF + lane * FPT);
        const float4 s = load4(bt + (kk + q) * 2 * TF + TF + lane * FPT);
        const float cv[4] = {c.x, c.y, c.z, c.w}, sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < FPT; ++j) {
            re[i][j] = fmaf(av[i][q], cv[j], re[i][j]);
            im[i][j] = fmaf(av[i][q], sv[j], im[i][j]);
          }
      }
    }
    __syncthreads();  // the slice's buffer is refilled two steps on
    if (chunk != n_chunks - 1) continue;

    // frequency tile done: magnitudes, then this warp's mel contribution
    const int f0 = (step / n_chunks) * TF;
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      float m[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        m[i] = round_to<E>(sqrtf(__fadd_rn(__fmul_rn(re[i][j], re[i][j]),
                                           __fmul_rn(im[i][j], im[i][j]))));
        re[i][j] = im[i][j] = 0.f;
      }
      float* dst = magT + (lane * FPT + j) * TS + r0;
      *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(m[4], m[5], m[6], m[7]);
    }
    __syncwarp();
    const int nf = min(TF, n_freqs - f0);
    for (int mc = 0; mc < n_mels; mc += 32 * FPT) {
      const int m = mc + lane * FPT;
      if (m < n_mels) {
        float s[RPT][FPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < FPT; ++j) s[i][j] = 0.f;
        const E* w = kfb + (size_t)f0 * MP + m;
        for (int f = 0; f < nf; ++f) {
          const float4 wv = load4(w + (size_t)f * MP);
          const float4 ma = *reinterpret_cast<const float4*>(magT + f * TS + r0);
          const float4 mb = *reinterpret_cast<const float4*>(magT + f * TS + r0 + 4);
          const float mv[RPT] = {ma.x, ma.y, ma.z, ma.w, mb.x, mb.y, mb.z, mb.w};
          const float wa[FPT] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < FPT; ++j) s[i][j] = fmaf(mv[i], wa[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < FPT; ++j)
            if (m + j < n_mels) acc[(r0 + i) * MS + m + j] += s[i][j];
      }
    }
    __syncwarp();  // the warp's magnitude rows are rewritten by the next tile
  }
  __syncthreads();
  log_db_out(acc, MS, TT, t0, T, b, n_mels, amin, shift, lo, hi, out);
}

int rows_that_fit(int n_fft, int hop, int n_mels, int esize) {
  for (int TT = 64; TT >= RPT; TT /= 2)
    if (Layout(TT, n_fft, hop, n_mels, esize).bytes <= MAX_SMEM) return TT;
  return 0;
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores: hop % 8 == 0, n_mels <= 128
// --------------------------------------------------------------------------

constexpr int TC_TT = 64;          // frames per block: 4 row tiles of 16
constexpr int TC_BK = 32;          // samples per staged basis slice
constexpr int TC_LDB = TC_BK + 8;  // slice row stride (bf16): conflict-free ldmatrix
constexpr int TC_LDM = TF + 8;     // magnitude row stride (bf16)
constexpr int TC_MELS = 128;       // 8 warps x 16 mels

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += a b for one 16x8x16 tile: a row-major bf16, b column-major bf16, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory, in bytes: the span as rows of hop bf16 samples (row q holds
// samples q*hop .. q*hop + hop - 1, stride hop + 8, so that the frame rows
// t, t+1, ... of an ldmatrix fall in different banks), two basis slices
// [2 * TF][TC_LDB] and the magnitudes [TC_TT][TC_LDM] (bf16). The epilogue's
// fp32 [TC_TT][n_mels + 1] accumulator reuses the slices' 40 KB.
struct TcLayout {
  int span_ld, span_rows;
  size_t stage_off, mag_off, bytes;
  __host__ __device__ TcLayout(int n_fft, int hop) {
    span_ld = hop + 8;
    span_rows = TC_TT - 1 + (round_up(n_fft, TC_BK) + hop - 1) / hop;
    stage_off = (size_t)round_up(span_rows * span_ld * 2, 16);
    mag_off = stage_off + (size_t)2 * 2 * TF * TC_LDB * 2;
    bytes = mag_off + (size_t)TC_TT * TC_LDM * 2;
  }
};

// The same chain as fused_log_mel_kernel<__nv_bfloat16, *>, with both
// products on the tensor cores (mma.sync m16n8k16, bf16 operands, fp32
// sums). Warp w owns frequencies 16w..16w+15 of each tile (re and im of the
// same frequencies land in the same fragment slots, so the magnitude is
// taken in registers) and, for the mel product, mels 16w..16w+15 of all 64
// frames, accumulated in registers across the tiles.
__global__ void __launch_bounds__(256, 2) fused_log_mel_tc_kernel(
    const float* __restrict__ x,                // [B, n_pad]
    const __nv_bfloat16* __restrict__ kbasis,   // [n_tiles][KP / TC_BK][2 * TF][TC_BK]
    const __nv_bfloat16* __restrict__ kfbt,     // [n_tiles][TC_MELS][TF] (fb transposed)
    float* __restrict__ out,                    // [B, n_mels, T]
    int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, float amin, float shift,
    float lo, float hi) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const TcLayout L(n_fft, hop);
  __nv_bfloat16* span = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_tc + L.stage_off);
  __nv_bfloat16* mag = reinterpret_cast<__nv_bfloat16*>(smem_tc + L.mag_off);
  constexpr int SLICE = 2 * TF * TC_BK;     // one slice in global memory (elements)
  constexpr int SLICE_S = 2 * TF * TC_LDB;  // ... in shared memory

  const int b = blockIdx.y, t0 = blockIdx.x * TC_TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  // ldmatrix x4 of a 16x16 A tile: lanes 0-15 give rows 0-15 at k 0, lanes
  // 16-31 rows 0-15 at k 8
  const int arow = lane & 15, akoff = (lane >> 4) * 8;
  const int n_chunks = round_up(n_fft, TC_BK) / TC_BK;
  const int n_steps = (n_freqs + TF - 1) / TF * n_chunks;

  auto issue = [&](int step) {
    const char* src = reinterpret_cast<const char*>(kbasis + (size_t)step * SLICE);
    __nv_bfloat16* dst = stage + (step & 1) * SLICE_S;
    for (int q = tid; q < SLICE / 8; q += blockDim.x)  // 16-byte pieces, 4 per row
      cp_async16(dst + (q >> 2) * TC_LDB + (q & 3) * 8, src + q * 16);
    cp_async_commit();
  };
  issue(0);

  const float* xb = x + (size_t)b * n_pad;
  const long long s0 = (long long)t0 * hop;
  for (int i = tid; i < L.span_rows * hop; i += blockDim.x) {
    const int q = i / hop;
    const long long gi = s0 + i;
    span[q * L.span_ld + (i - q * hop)] = __float2bfloat16(gi < n_pad ? xb[gi] : 0.f);
  }

  float re[4][2][4], im[4][2][4], mel[4][2][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) re[mt][nt][e] = im[mt][nt][e] = mel[mt][nt][e] = 0.f;

  int kq = 0, ke = 0;  // this lane's A sample: k = kq * hop + ke
  for (int step = 0; step < n_steps; ++step) {
    const int chunk = step % n_chunks;
    if (chunk == 0) {
      kq = akoff / hop;
      ke = akoff - kq * hop;
    }
    if (step + 1 < n_steps) issue(step + 1);
    else cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const __nv_bfloat16* bt = stage + (step & 1) * SLICE_S;
#pragma unroll
    for (int s = 0; s < TC_BK / 16; ++s) {
      unsigned bf[2][4];  // per 8 frequencies: cos k0-7, cos k8-15, -sin k0-7, -sin k8-15
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = lane >> 3;
        const int n = (j >> 1) * TF + warp * 16 + nt * 8 + (lane & 7);
        ldsm_x4(smem_u32(bt + n * TC_LDB + s * 16 + (j & 1) * 8), bf[nt]);
      }
      const __nv_bfloat16* a0 = span + (arow + kq) * L.span_ld + ke;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned a[4];
        ldsm_x4(smem_u32(a0 + mt * 16 * L.span_ld), a);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(re[mt][nt], a, bf[nt][0], bf[nt][1]);
          mma_bf16(im[mt][nt], a, bf[nt][2], bf[nt][3]);
        }
      }
      ke += 16;
      while (ke >= hop) {
        ke -= hop;
        ++kq;
      }
    }
    __syncthreads();  // the slice's buffer is refilled two steps on
    if (chunk != n_chunks - 1) continue;

    // frequency tile done: bf16 magnitudes [t][f], then the mel product
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m2[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float r = re[mt][nt][2 * h + q], i = im[mt][nt][2 * h + q];
            m2[q] = sqrtf(__fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)));
            re[mt][nt][2 * h + q] = im[mt][nt][2 * h + q] = 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(
              mag + (mt * 16 + g + 8 * h) * TC_LDM + warp * 16 + nt * 8 + 2 * c) =
              __floats2bfloat162_rn(m2[0], m2[1]);
        }
    __syncthreads();
    const __nv_bfloat16* fbt = kfbt + (size_t)(step / n_chunks) * TC_MELS * TF;
#pragma unroll 2
    for (int s = 0; s < TF / 16; ++s) {
      unsigned fbf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* p = fbt + (warp * 16 + nt * 8 + g) * TF + s * 16 + 2 * c;
        fbf[nt][0] = *reinterpret_cast<const unsigned*>(p);
        fbf[nt][1] = *reinterpret_cast<const unsigned*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned a[4];
        ldsm_x4(smem_u32(mag + (mt * 16 + arow) * TC_LDM + s * 16 + akoff), a);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(mel[mt][nt], a, fbf[nt][0], fbf[nt][1]);
      }
    }
  }
  __syncthreads();  // the slices are free: the mel sums go out through them

  float* acc = reinterpret_cast<float*>(smem_tc + L.stage_off);  // [TC_TT][MS]
  const int MS = n_mels + 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = warp * 16 + nt * 8 + 2 * c + (e & 1);
        if (m < n_mels) acc[(mt * 16 + g + 8 * (e >> 1)) * MS + m] = mel[mt][nt][e];
      }
  __syncthreads();
  log_db_out(acc, MS, TC_TT, t0, T, b, n_mels, amin, shift, lo, hi, out);
}

// 2: bf16 on the tensor cores; 1: fused_log_mel_kernel; 0: no kernel takes
// these shapes.
int plan(int n_fft, int hop, int n_mels, int bf16) {
  if (bf16 && hop % 8 == 0 && n_mels <= TC_MELS && TcLayout(n_fft, hop).bytes <= MAX_SMEM)
    return 2;
  return rows_that_fit(n_fft, hop, n_mels, bf16 ? 2 : 4) ? 1 : 0;
}

int launch_tc(const float* x, const void* kbasis, const void* kfbt, float* out, int B,
              int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, float amin,
              float shift, float lo, float hi, cudaStream_t stream) {
  const size_t smem = TcLayout(n_fft, hop).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_log_mel_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_log_mel_tc_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TC_TT - 1) / TC_TT, B);
  fused_log_mel_tc_kernel<<<grid, 256, smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(kbasis), static_cast<const __nv_bfloat16*>(kfbt),
      out, n_pad, T, n_fft, hop, n_freqs, n_mels, amin, shift, lo, hi);
  return (int)cudaGetLastError();
}

template <typename E, bool VEC>
int launch(const float* x, const void* kbasis, const void* kfb, float* out, int B,
           int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, float amin,
           float shift, float lo, float hi, cudaStream_t stream) {
  const int TT = rows_that_fit(n_fft, hop, n_mels, sizeof(E));
  if (TT == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(TT, n_fft, hop, n_mels, sizeof(E)).bytes;
  cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<E, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  fused_log_mel_kernel<E, VEC><<<grid, TT / RPT * 32, smem, stream>>>(
      x, static_cast<const E*>(kbasis), static_cast<const E*>(kfb), out, n_pad, T, TT,
      n_fft, hop, n_freqs, n_mels, amin, shift, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Which kernel takes these shapes: 2 the tensor-core kernel (bf16 only),
// 1 the CUDA-core kernel, 0 none (they do not fit shared memory).
int fused_log_mel_plan(int n_fft, int hop, int n_mels, int bf16) {
  return plan(n_fft, hop, n_mels, bf16);
}

// x [B, n_pad] fp32; out [B, n_mels, T] fp32. The constants are fp32 or
// (bf16 != 0) bf16, laid out for the plan's kernel:
//   plan 1: kbasis [n_tiles][round_up(n_fft, bk)][2 * tf] and
//           kfb [n_tiles * tf][round_up(n_mels, 4)];
//   plan 2: kbasis [n_tiles][round_up(n_fft, bk) / bk][2 * tf][bk] and
//           kfb [n_tiles][128][tf] (the filterbank transposed),
// n_tiles = ceil(n_freqs / tf), n_freqs the frequencies laid out, zero past
// n_fft, n_freqs and n_mels. tf and bk are the wrapper's layout constants,
// checked against this file's.
int fused_log_mel(const float* x, const void* kbasis, const void* kfb, float* out, int B,
                  int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, int bf16,
                  int tf, int bk, float amin, float shift, float lo, float hi,
                  cudaStream_t stream) {
  const int p = plan(n_fft, hop, n_mels, bf16);
  if (p == 0 || tf != TF || bk != (p == 2 ? TC_BK : BK)) return (int)cudaErrorInvalidValue;
  if (p == 2)
    return launch_tc(x, kbasis, kfb, out, B, n_pad, T, n_fft, hop, n_freqs, n_mels, amin,
                     shift, lo, hi, stream);
  const bool vec = hop % 4 == 0;
  if (bf16)
    return vec ? launch<__nv_bfloat16, true>(x, kbasis, kfb, out, B, n_pad, T, n_fft, hop,
                                             n_freqs, n_mels, amin, shift, lo, hi, stream)
               : launch<__nv_bfloat16, false>(x, kbasis, kfb, out, B, n_pad, T, n_fft, hop,
                                              n_freqs, n_mels, amin, shift, lo, hi, stream);
  return vec ? launch<float, true>(x, kbasis, kfb, out, B, n_pad, T, n_fft, hop, n_freqs,
                                   n_mels, amin, shift, lo, hi, stream)
             : launch<float, false>(x, kbasis, kfb, out, B, n_pad, T, n_fft, hop, n_freqs,
                                    n_mels, amin, shift, lo, hi, stream);
}

}  // extern "C"
