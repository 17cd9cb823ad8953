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
// Two kernels; `plan` picks one per shape. fused_log_mel_wg_kernel runs bf16
// on the tensor cores (wgmma) when hop % 8 == 0 and n_mels <= 128;
// fused_log_mel_kernel<E> runs fp32 (E = float) and bf16 at the other
// shapes (E = __nv_bfloat16), as fp32 FMAs on the CUDA cores. In both:
//   - A block (fused_log_mel_kernel) or a cluster of two blocks
//     (fused_log_mel_wg_kernel) owns a run of frames of one clip and every
//     output of those frames, and adds its sums in a fixed order: no
//     atomics, and reruns are bitwise equal. The TPU carried the mel
//     accumulator in scratch across a sequential grid axis over frequency
//     tiles (pallas_mel.py:89-90, :131-137); here a loop inside the block
//     walks the frequency tiles.
//   - The block's contiguous span of padded audio is staged once in shared
//     memory; frame t's sample k is read from it in place, so frames are
//     never written out.
//   - The basis streams through shared memory in slices of a few samples,
//     for the frequencies from the first to the last whose filterbank row is
//     not all zero (with f_min = 0 the DC row is, which leaves 1024 bins at
//     n_fft 2048), zero past the last (a ragged last tile) and past n_fft.
//     Here n_freqs counts the frequencies laid out. The whole basis stays in
//     the 50 MB L2.
//   - After a frequency tile, its magnitudes feed the tile's mel
//     contribution mag^T fb, added to fp32 sums that live across the tiles.
//   - The log-dB and clamp epilogue writes out[b, :, t0:t0+TT], t fastest.
// fused_log_mel_kernel: TT frames a block (64 when they fit); warp w owns
//   frames 8w..8w+7, lane l frequencies 4l..4l+3 of a tile of TF = 128; a
//   thread keeps an 8 x 4 tile of re and of im in registers and per sample
//   reads the warp's 8 samples (broadcast) and one float4 each of cos and
//   -sin from a two-stage cp.async ring. The mel accumulator [TT][n_mels]
//   lives in shared memory, fb is read through L1. Takes any hop, n_fft,
//   n_mels and frame count for which some TT in {64, 32, 16, 8} fits 227 KB
//   of shared memory.
// fused_log_mel_wg_kernel: see its own note below.
//
// A third kernel, mel_linear_wg_kernel, replaces no TPU kernel: it is the
// GEMM front-end's bf16 chain (ops/frontend.py mel_spectrogram: the DFT
// GEMM of bf16-rounded frames and basis, the fp32 magnitude, the fp32 mel
// GEMM) in one launch on fused_log_mel_wg_kernel's mainloop, with an fp32
// epilogue that writes the linear mel. The train and eval paths take it on
// the card (ops/fused_mel.py `linear_mel_takes`); see its note below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

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
// lo, hi) for the block's frames below T, t fastest (coalesced writes), by
// threads tid of nthreads.
__device__ __forceinline__ void log_db_out(const float* acc, int MS, int TT, int t0, int T,
                                           int b, int n_mels, float amin, float shift,
                                           float lo, float hi, float* __restrict__ out, int tid,
                                           int nthreads) {
  for (int i = tid; i < TT * n_mels; i += nthreads) {
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
  log_db_out(acc, MS, TT, t0, T, b, n_mels, amin, shift, lo, hi, out, threadIdx.x, blockDim.x);
}

int rows_that_fit(int n_fft, int hop, int n_mels, int esize) {
  for (int TT = 64; TT >= RPT; TT /= 2)
    if (Layout(TT, n_fft, hop, n_mels, esize).bytes <= MAX_SMEM) return TT;
  return 0;
}

// --------------------------------------------------------------------------
// bf16 on the tensor cores: hop % 8 == 0, n_mels <= 128
// --------------------------------------------------------------------------
//
// fused_log_mel_wg_kernel. Both products run on wgmma, fed by a TMA ring.
//   - A thread-block cluster of WG_SPLIT = 2 blocks owns WG_TT = 128 frames
//     of one clip; block r of the cluster takes its share of the frequency
//     tiles (r * n_tiles / 2 .. (r + 1) * n_tiles / 2 - 1). A block has 288
//     threads: two consumer warpgroups of 64 frames each and one producer
//     warp. Splitting the frequencies makes 2 * B * ceil(T / 128) units of
//     half the work (640 at B=64): 4.85 rounds of the 132 SMs, so the last
//     round idles less than the 2.42 rounds of whole units do.
//   - Each block stages its span of audio once, as bf16 rows of hop samples
//     (row q holds samples q*hop .. q*hop + hop - 1 at a stride of hop + 8,
//     so that the 8 frame rows of an ldmatrix fall in 8 bank groups): frame
//     t's sample k is span[t + k / hop][k % hop].
//   - The constants are one sequence of ring items of 128 rows x 64 bf16
//     (16 KB), per tile of WG_TF = 64 frequencies: n_chunks items of the
//     basis, row j < 64 cos and row 64 + j -sin of frequency f0 + j over 64
//     samples (K-major), then one item of the filterbank, row m holding
//     fb[f0 .. f0 + 63][m] (ops/fused_mel.py `_kernel_constants`, plan 3).
//   - The producer warp's one thread walks the block's items through a ring
//     of WG_STAGES stages on mbarriers, one TMA copy (cp.async.bulk.tensor,
//     128-byte swizzle) an item; a stage is refilled once both consumer
//     warpgroups have released it. (Multicasting each item into a cluster
//     of blocks on neighbouring frame tiles, which cuts the basis's L2
//     reads, ran no faster: PERF.md section 6.)
//   - A consumer warpgroup runs wgmma.m64n128k16 with A from registers and
//     B from the stage by descriptor. A is ldmatrix'd from the span: warp w
//     of the warpgroup gives rows 16w..16w+15, the mma.sync A fragment. The
//     span's rows lie a stride of hop apart, which no canonical shared-memory
//     layout of wgmma describes, so A cannot be read by descriptor. The
//     accumulator, 64 floats a thread, holds re of the tile's 64 frequencies
//     in columns 0-63 and im in 64-127: re[f] and im[f] land in the same
//     thread (registers i and i + 32), so the magnitude is taken there.
//     One group of wgmmas stays in flight: A is double-buffered, and a stage
//     is released when the next item's group has been committed and the
//     previous one is complete.
//   - The mel product is a second wgmma.m64n128k16 into the same
//     accumulator: the bf16 magnitudes, repacked from it (columns 16s..16s+15
//     of it are k-step s's A fragment), times the filterbank item by
//     descriptor. n_mels is padded to WG_MELS = 128 in the layout. Each
//     thread adds the tile's mel products into its own entries of the
//     block's fp32 sums [WG_TT][WG_MS] in shared memory, in tile order.
//     Keeping the sums out of registers leaves a consumer thread one
//     64-float accumulator and three A buffers (~150 registers): two
//     accumulators live through the loop went past the 168 a thread that
//     288 threads allow, and ptxas then serialized the wgmmas.
//   - Epilogue: after a cluster barrier, block r adds the other block's
//     sums of frames 64r .. 64r + 63 to its own (read through distributed
//     shared memory; block 0's sums + block 1's, the same order for every
//     frame), and log_db_out writes those frames. A second cluster barrier
//     keeps each block's sums until the other has read them.

constexpr int WG_TT = 128;            // frames per cluster: two warpgroups of 64
constexpr int WG_TK = 64;             // samples per basis item (128 bytes a row)
constexpr int WG_TF = 64;             // frequencies per tile
constexpr int WG_N = 2 * WG_TF;       // rows of a basis item: cos | -sin
constexpr int WG_MELS = 128;          // mels of the filterbank item (rows)
constexpr int WG_ITEM = WG_N * WG_TK * 2;  // bytes of one ring item, 16 KB
constexpr int WG_STAGES = 4;          // ring stages
constexpr int WG_SPLIT = 2;           // blocks per cluster, each a share of the tiles
constexpr int WG_THREADS = 288;       // two consumer warpgroups, one producer warp
constexpr int WG_MS = WG_MELS + 4;    // row stride of the mel sums (float2 rows)
constexpr int WG_WARPS = 8;           // consumer warps, 16 frames each
constexpr int WG_MAG_F = 32;          // linear mode: frequencies a warp stages at once
constexpr int WG_MAG_LD = 20;         // linear mode: row stride of the staged magnitudes
constexpr int ERR_NO_CLUSTER = 10001; // no cluster of this shape can be resident
constexpr int ERR_TENSOR_MAP = 10002; // the tensor map could not be encoded
static_assert(WG_ITEM == WG_MELS * WG_TK * 2, "basis and filterbank items differ in size");
static_assert(WG_TT % (64 * WG_SPLIT) == 0, "each block writes whole 64-frame halves");

// Shared memory, in bytes from a 1024-byte aligned base (TMA's 128-byte
// swizzle repeats every 1024 bytes): the ring, the span, the fp32 mel sums
// [WG_TT][WG_MS], in the linear mode each consumer warp's staged magnitudes
// [WG_MAG_F][WG_MAG_LD], then the full and empty barriers.
struct WgLayout {
  int span_ld, span_rows;
  size_t span_off, sums_off, mags_off, bar_off, bytes;
  __host__ __device__ WgLayout(int n_fft, int hop, bool linear = false) {
    span_ld = hop + 8;
    span_rows = WG_TT - 1 + (round_up(n_fft, WG_TK) + hop - 1) / hop;
    span_off = (size_t)WG_STAGES * WG_ITEM;
    sums_off = (span_off + (size_t)span_rows * span_ld * 2 + 15) / 16 * 16;
    mags_off = sums_off + (size_t)WG_TT * WG_MS * 4;
    bar_off = mags_off + (linear ? (size_t)WG_WARPS * WG_MAG_F * WG_MAG_LD * 4 : 0);
    bytes = bar_off + 2 * WG_STAGES * 8 + 1024;  // + room to align the base
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done, tries = 0;
  do {
    if (++tries == (1u << 30)) __trap();  // a wait that cannot end faults, not hangs
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// rows c1 .. c1 + 127 of the tensor map's [rows][64] bf16 into dst, counted
// on the barrier bar
__device__ __forceinline__ void tma_item(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major [rows][64] bf16 tile written by TMA with the
// 128-byte swizzle: start address >> 4, leading offset 1 (unused when K fits
// the swizzle), stride 1024 B between 8-row groups, layout "128B swizzle".
// Adding 2 steps K by 16 elements (32 bytes) inside the swizzle atom.
__device__ __forceinline__ uint64_t wg_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of d across the asm around it
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (+)= a b: a 64x16 bf16 from registers (the warp's mma.sync A fragment),
// b 16x128 bf16 by descriptor, d 64x128 fp32 (scale_d = 0: d = a b)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const unsigned (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// A consumer warpgroup's place in the ring: the stage it reads next, its
// phase, and the stage it read last (released once that item's wgmmas are
// complete, by one thread of the warpgroup).
struct WgRing {
  unsigned ring, full0, empty0;
  bool signaller;
  int stage, prev;
  unsigned phase;
  __device__ __forceinline__ void release(int s) const {
    if (signaller) mbar_arrive(empty0 + 8 * s);
  }
  __device__ __forceinline__ void advance() {
    prev = stage;
    if (++stage == WG_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One basis item: A for its 64 samples (4 k16 steps) from the span into a,
// then four wgmmas into acc. One group stays in flight: the previous item's
// stage is released once its group is complete.
__device__ __forceinline__ void wg_dft_item(float (&acc)[64], unsigned (&a)[4][4], int& kq, int& ke,
                                            bool first, WgRing& rg, unsigned arow, int span_ld,
                                            int hop) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldsm_x4(arow + (unsigned)((kq * span_ld + ke) * 2), a[kk]);
    ke += 16;
    while (ke >= hop) {
      ke -= hop;
      ++kq;
    }
  }
  mbar_wait(rg.full0 + 8 * rg.stage, rg.phase);
  wgmma_fence();
  const uint64_t d = wg_desc(rg.ring + rg.stage * WG_ITEM);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], d + 2 * kk, first && kk == 0 ? 0 : 1);
  wgmma_commit();
  wgmma_wait<1>();
  if (rg.prev >= 0) rg.release(rg.prev);
  rg.advance();
}

// span[q][0 .. hop - 1] = bf16(xb[s0 + q * hop ..]) for q < rows, zero at and
// past n_pad, by the 256 consumer threads. The
// samples go 4 at a time (float4 where xb's rows are 16-byte aligned, n_pad
// % 4 == 0: s0 and hop are multiples of 4), 8 loads in flight a thread:
// the span is the one read of device memory that the ring does not hide.
__device__ __forceinline__ void stage_span(__nv_bfloat16* span, int span_ld, int rows,
                                           const float* __restrict__ xb, int n_pad,
                                           long long s0, int hop, int tid) {
  constexpr int U = 8;
  const int n4 = rows * hop / 4, h4 = hop / 4;
  const bool vec = (n_pad & 3) == 0;
  for (int i0 = tid; i0 < n4; i0 += 2 * 128 * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 2 * 128;
      const long long gi = s0 + 4LL * i;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= n4) continue;
      if (vec && gi + 3 < n_pad) {
        v[u] = __ldg(reinterpret_cast<const float4*>(xb + gi));
      } else {
        if (gi < n_pad) v[u].x = xb[gi];
        if (gi + 1 < n_pad) v[u].y = xb[gi + 1];
        if (gi + 2 < n_pad) v[u].z = xb[gi + 2];
        if (gi + 3 < n_pad) v[u].w = xb[gi + 3];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * 2 * 128;
      if (i >= n4) continue;
      const int q = i / h4, col = 4 * (i - q * h4);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
      uint2 w;
      w.x = *reinterpret_cast<const unsigned*>(&lo);
      w.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(span + q * span_ld + col) = w;
    }
  }
}

// --------------------------------------------------------------------------
// The linear mel in fp32 on the same mainloop: mel_linear_wg_kernel
// --------------------------------------------------------------------------
//
// The GEMM front-end's numerics in bf16 (ops/frontend.py): the DFT of the
// bf16-rounded frames and basis summed in fp32 (the wgmma mainloop above),
// then per frame
//   mag[f] = sqrt(re^2 + im^2), fp32, products and sum rounded apart (no
//            FMA contraction), not rounded to bf16
//   mel[m] = sum over f of mag[f] * fb[f, m], fp32 FMAs in ascending f,
//            with the fp32 filterbank
// written as the linear mel (no log). The chain stays compute-bound as row
// 7b's: the epilogue adds 2 FMAs a frequency a frame to the DFT's 4096.
//   - The filterbank is banded: row f is zero but for fb[f][m0] = w0 and
//     fb[f][m0 + 1] = w1, with m0 nondecreasing in f (triangular filters
//     whose edges ascend: each frequency lies in at most two neighbours).
//     The wrapper passes one float4 {w0, w1, m0's bits, 0} a laid-out
//     frequency (ops/fused_mel.py `band_table`), and the mel product costs
//     2 FMAs a frequency instead of n_mels. The ring carries only the basis
//     items: each tile's filterbank item in the sequence is skipped.
//   - At a tile's end each consumer warp stages its 16 frames' magnitudes,
//     half a tile (WG_MAG_F = 32 frequencies) at a time, as rows of
//     WG_MAG_LD floats [frequency][frame] in its own shared memory (the
//     quad's four column pairs land 8 banks apart: no conflicts). Lane l
//     then walks the staged frequencies in order for frame l % 16 and the
//     mels of parity l / 16: of a frequency's two mels m0, m0 + 1, the one
//     of its parity. Its running sum is one mel's chain of FMAs, kept in a
//     register across the block's tiles and stored into the block's sums
//     once, when the lane's mel changes (m0 is nondecreasing, so a mel is
//     one run of frequencies for a lane). No two lanes store one entry; no
//     atomics.
//   - The two blocks' sums are added as in row 7b (block 0's + block 1's),
//     and mel_out writes out[b][t][m], m fastest: the memory layout of the
//     GEMM front-end's product, whose [B, n_mels, T] view the wrapper
//     returns.

// out[b, t0 + t, m] = acc[t][m] for the block's 64 frames below T, m fastest
// (coalesced writes), by threads tid of nthreads.
__device__ __forceinline__ void mel_out(const float* acc, int t0, int T, int b, int n_mels,
                                        float* __restrict__ out, int tid, int nthreads) {
  for (int i = tid; i < 64 * n_mels; i += nthreads) {
    const int t = i / n_mels, m = i - t * n_mels;
    if (t0 + t < T) out[((size_t)b * T + t0 + t) * n_mels + m] = acc[t * WG_MS + m];
  }
}

// The body of both tensor-core kernels; LINEAR picks the epilogue.
template <bool LINEAR>
__device__ __forceinline__ void wg_body(const CUtensorMap* items, const float* __restrict__ x,
                                        const float4* __restrict__ band, float* __restrict__ out,
                                        int n_pad, int T, int n_tt, int n_fft, int hop,
                                        int n_chunks, int n_tiles, int n_mels, float amin,
                                        float shift, float lo, float hi) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* sm = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  const WgLayout L(n_fft, hop, LINEAR);
  const unsigned ring = smem_u32(sm);
  const unsigned full0 = ring + (unsigned)L.bar_off, empty0 = full0 + 8 * WG_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster_rank();
  const int u = blockIdx.x / WG_SPLIT;  // the cluster's frame tile: clip u / n_tt
  const int b = u / n_tt, t0 = (u - b * n_tt) * WG_TT;
  // this block's frequency tiles
  const int tile_lo = n_tiles * rank / WG_SPLIT, tile_hi = n_tiles * (rank + 1) / WG_SPLIT;
  float* sums = reinterpret_cast<float*>(sm + L.sums_off);  // [WG_TT][WG_MS]

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 2 * 4) {  // the producer warp
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(items))
                   : "memory");
      int stage = 0;
      unsigned phase = 0;
      // per tile its basis items, then (row 7b) its filterbank item
      for (int tile = tile_lo; tile < tile_hi; ++tile)
        for (int ch = 0; ch < n_chunks + (LINEAR ? 0 : 1); ++ch) {
          const int i = tile * (n_chunks + 1) + ch;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full0 + 8 * stage, WG_ITEM);
          tma_item(ring + stage * WG_ITEM, items, full0 + 8 * stage, i * WG_N);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    cluster_sync();  // the sums of both blocks are in
    cluster_sync();  // and read by the other block
    return;
  }

  // the span, as bf16 rows of hop samples (zero past the padded audio)
  __nv_bfloat16* span = reinterpret_cast<__nv_bfloat16*>(sm + L.span_off);
  stage_span(span, L.span_ld, L.span_rows, x + (size_t)b * n_pad, n_pad, (long long)t0 * hop, hop,
             tid);
  for (int i = tid; i < WG_TT * WG_MS; i += 2 * 128) sums[i] = 0.f;
  named_sync(1, 2 * 128);

  const int wi = warp & 3, g = lane >> 2, c = lane & 3;
  // this lane's ldmatrix row: frame row, and sample offset 0 or 8 in a k16 step
  const unsigned arow =
      smem_u32(span) + (unsigned)(((warp >> 2) * 64 + wi * 16 + (lane & 15)) * L.span_ld * 2);
  const int koff = (lane >> 4) * 8;
  const int kq0 = koff / hop, ke0 = koff - kq0 * hop;
  // this thread's rows of the sums: accumulator rows g and g + 8
  float* srow = sums + ((warp >> 2) * 64 + wi * 16 + g) * WG_MS + 2 * c;
  // linear mode: this lane's running sum of mel `cur` (none yet: -1)
  int cur = -1;
  float run = 0.f;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  unsigned a0[4][4], a1[4][4], ma[4][4];
  WgRing rg{ring, full0, empty0, wi == 0 && lane == 0, 0, -1, 0};
  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    int kq = kq0, ke = ke0;
    if constexpr (LINEAR) {
      // whole pairs, then an odd item on a0: with a pair's second item
      // conditional (row 7b's loop, below), ptxas serializes this kernel's
      // wgmmas one at a time (C7513), 1.2x its device time
      int ch = 0;
      for (; ch + 1 < n_chunks; ch += 2) {
        wg_dft_item(acc, a0, kq, ke, ch == 0, rg, arow, L.span_ld, hop);
        wg_dft_item(acc, a1, kq, ke, false, rg, arow, L.span_ld, hop);
      }
      if (ch < n_chunks) wg_dft_item(acc, a0, kq, ke, ch == 0, rg, arow, L.span_ld, hop);
    } else {
      for (int ch = 0; ch < n_chunks; ch += 2) {
        wg_dft_item(acc, a0, kq, ke, ch == 0, rg, arow, L.span_ld, hop);
        if (ch + 1 < n_chunks) wg_dft_item(acc, a1, kq, ke, false, rg, arow, L.span_ld, hop);
      }
    }
    if constexpr (LINEAR) {
      // the tile's re and im complete; its last basis item released
      wgmma_wait<0>();
      fence_regs(acc);
      rg.release(rg.prev);
      rg.prev = -1;
      // fp32 magnitudes (re at register i, im at i + 32); re^2 + im^2 is
      // >= 0 or NaN, so this is torch.sqrt(clamp(., min=0)) of it
      float mg[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mg[i] = sqrtf(__fadd_rn(__fmul_rn(acc[i], acc[i]), __fmul_rn(acc[i + 32], acc[i + 32])));
      // this warp's staging rows; this lane's frame (a row of the sums) and
      // mel parity
      float* mags = reinterpret_cast<float*>(sm + L.mags_off) + warp * WG_MAG_F * WG_MAG_LD;
      const int mt = lane & 15, mp = lane >> 4;
      float* mrow = sums + ((warp >> 2) * 64 + wi * 16 + mt) * WG_MS;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        // accumulator columns 32hh .. 32hh + 31, staged [frequency][frame]
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int v = 0; v < 2; ++v)
              mags[(8 * jj + 2 * c + v) * WG_MAG_LD + g + 8 * h] =
                  mg[4 * (4 * hh + jj) + 2 * h + v];
        __syncwarp();
        const float4* e = band + tile * WG_TF + WG_MAG_F * hh;
#pragma unroll 8
        for (int k = 0; k < WG_MAG_F; ++k) {
          const float4 w = __ldg(e + k);
          const int m0 = __float_as_int(w.z), odd = (m0 ^ mp) & 1;
          if (m0 + odd != cur) {
            if (cur >= 0) mrow[cur] = run;
            cur = m0 + odd;
            run = 0.f;
          }
          run = fmaf(mags[k * WG_MAG_LD + mt], odd ? w.y : w.x, run);
        }
        __syncwarp();  // the staged rows are rewritten by the next half
      }
    } else {
      // the tile's filterbank item; its re and im complete
      mbar_wait(rg.full0 + 8 * rg.stage, rg.phase);
      wgmma_wait<0>();
      fence_regs(acc);
      rg.release(rg.prev);
      // bf16 magnitudes as A fragments: k-step s takes accumulator columns
      // 16s..16s+15 (chunks j = 2s, 2s + 1 of 8), im[f] at register i + 32
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int i = 4 * (2 * s + h) + 2 * p;
            float m2[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float r = acc[i + q], im = acc[i + q + 32];
              m2[q] = sqrtf(__fadd_rn(__fmul_rn(r, r), __fmul_rn(im, im)));
            }
            ma[s][2 * h + p] = pack_bf16(m2[0], m2[1]);
          }
      // the tile's mel products into acc, then into this thread's sums
      wgmma_fence();
      const uint64_t d = wg_desc(ring + rg.stage * WG_ITEM);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(acc, ma[s], d + 2 * s, s == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      rg.release(rg.stage);
      rg.advance();
      rg.prev = -1;  // released
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p = reinterpret_cast<float2*>(srow + 8 * h * WG_MS + 8 * j);
          const float2 v = *p;
          *p = make_float2(v.x + acc[4 * j + 2 * h], v.y + acc[4 * j + 2 * h + 1]);
        }
    }
  }
  if constexpr (LINEAR) {
    if (cur >= 0) sums[((warp >> 2) * 64 + wi * 16 + (lane & 15)) * WG_MS + cur] = run;
  }

  // frames 64 * rank .. + 63: block 0's sums + block 1's, then the output
  cluster_sync();
  float* mine = sums + 64 * rank * WG_MS;
  const float* other = cg::this_cluster().map_shared_rank(mine, rank ^ 1);
  for (int i = tid; i < 64 * WG_MS; i += 2 * 128) mine[i] = rank == 0 ? mine[i] + other[i]
                                                                       : other[i] + mine[i];
  named_sync(1, 2 * 128);
  if constexpr (LINEAR)
    mel_out(mine, t0 + 64 * rank, T, b, n_mels, out, tid, 2 * 128);
  else
    log_db_out(mine, WG_MS, 64, t0 + 64 * rank, T, b, n_mels, amin, shift, lo, hi, out, tid,
               2 * 128);
  cluster_sync();  // the other block has read this block's sums
}

// row 7b: the log-mel [B, n_mels, T], magnitudes and filterbank in bf16
// (band is not read)
__global__ void __launch_bounds__(WG_THREADS, 1) fused_log_mel_wg_kernel(
    const __grid_constant__ CUtensorMap items,  // [n_tiles * (n_chunks + 1) * 128][64] bf16
    const float* __restrict__ x,                 // [B, n_pad]
    const float4* __restrict__ band,             // unused
    float* __restrict__ out,                     // [B, n_mels, T]
    int n_pad, int T, int n_tt, int n_fft, int hop, int n_chunks, int n_tiles, int n_mels,
    float amin, float shift, float lo, float hi) {
  wg_body<false>(&items, x, band, out, n_pad, T, n_tt, n_fft, hop, n_chunks, n_tiles, n_mels,
                 amin, shift, lo, hi);
}

// the linear mel [B, T, n_mels] of the GEMM front-end's numerics
__global__ void __launch_bounds__(WG_THREADS, 1) mel_linear_wg_kernel(
    const __grid_constant__ CUtensorMap items,  // as above; the filterbank items unread
    const float* __restrict__ x,                 // [B, n_pad]
    const float4* __restrict__ band,             // [n_tiles * WG_TF] {w0, w1, m0, 0}
    float* __restrict__ out,                     // [B, T, n_mels]
    int n_pad, int T, int n_tt, int n_fft, int hop, int n_chunks, int n_tiles, int n_mels,
    float amin, float shift, float lo, float hi) {
  wg_body<true>(&items, x, band, out, n_pad, T, n_tt, n_fft, hop, n_chunks, n_tiles, n_mels,
                amin, shift, lo, hi);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so that the build links no libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of the ring items: [rows][64] bf16, boxes of 128 rows,
// 128-byte swizzle; encoded once per (pointer, rows).
int items_map(CUtensorMap* map, const void* items, int rows) {
  static struct {
    const void* p;
    int rows;
    CUtensorMap map;
  } cache[8];
  static int n_cached = 0;
  for (int i = 0; i < (n_cached < 8 ? n_cached : 8); ++i)
    if (cache[i].p == items && cache[i].rows == rows) {
      *map = cache[i].map;
      return 0;
    }
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return ERR_TENSOR_MAP;
  const cuuint64_t dims[2] = {(cuuint64_t)WG_TK, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)WG_TK * 2};
  const cuuint32_t box[2] = {(cuuint32_t)WG_TK, (cuuint32_t)WG_N};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(items), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP;
  auto& slot = cache[n_cached++ % 8];
  slot.p = items;
  slot.rows = rows;
  slot.map = *map;
  return 0;
}

template <bool LINEAR>
int launch_wg(const float* x, const void* items, const float4* band, float* out, int B, int n_pad,
              int T, int n_fft, int hop, int n_freqs, int n_mels, float amin, float shift,
              float lo, float hi, cudaStream_t stream) {
  const int n_chunks = round_up(n_fft, WG_TK) / WG_TK;
  const int n_tiles = (n_freqs + WG_TF - 1) / WG_TF;
  const int n_tt = (T + WG_TT - 1) / WG_TT;
  CUtensorMap map;
  const int merr = items_map(&map, items, n_tiles * (n_chunks + 1) * WG_N);
  if (merr != 0) return merr;
  const int smem = (int)WgLayout(n_fft, hop, LINEAR).bytes;
  auto kern = LINEAR ? mel_linear_wg_kernel : fused_log_mel_wg_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(WG_SPLIT * B * n_tt);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WG_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return ERR_NO_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, kern, map, x, band, out, n_pad, T, n_tt, n_fft, hop, n_chunks,
                           n_tiles, n_mels, amin, shift, lo, hi);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 3: bf16 on the tensor cores (wgmma); 1: fused_log_mel_kernel; 0: no kernel
// takes these shapes.
int plan(int n_fft, int hop, int n_mels, int bf16) {
  if (bf16 && hop % 8 == 0 && n_mels <= WG_MELS && WgLayout(n_fft, hop).bytes <= MAX_SMEM)
    return 3;
  return rows_that_fit(n_fft, hop, n_mels, bf16 ? 2 : 4) ? 1 : 0;
}

// Whether mel_linear_wg_kernel takes these shapes: a banded filterbank
// needs two mels at least.
bool linear_plan(int n_fft, int hop, int n_mels) {
  return hop % 8 == 0 && n_mels >= 2 && n_mels <= WG_MELS &&
         WgLayout(n_fft, hop, true).bytes <= MAX_SMEM;
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

// Which kernel takes these shapes: 3 the tensor-core kernel (bf16 only),
// 1 the CUDA-core kernel, 0 none (they do not fit shared memory).
int fused_log_mel_plan(int n_fft, int hop, int n_mels, int bf16) {
  return plan(n_fft, hop, n_mels, bf16);
}

// x [B, n_pad] fp32; out [B, n_mels, T] fp32. The constants are fp32 or
// (bf16 != 0) bf16, laid out for the plan's kernel:
//   plan 1: kbasis [n_tiles][round_up(n_fft, bk)][2 * tf] and
//           kfb [n_tiles * tf][round_up(n_mels, 4)];
//   plan 3: kbasis the ring items [n_tiles][n_chunks + 1][128][bk], n_chunks
//           = round_up(n_fft, bk) / bk: per tile the basis items [cos | -sin
//           of tf frequencies][bk samples], then the filterbank item
//           [128 mels][tf frequencies]; kfb is not read,
// n_tiles = ceil(n_freqs / tf), n_freqs the frequencies laid out, zero past
// n_fft, n_freqs and n_mels. tf and bk are the wrapper's layout constants,
// checked against this file's.
int fused_log_mel(const float* x, const void* kbasis, const void* kfb, float* out, int B,
                  int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, int bf16,
                  int tf, int bk, float amin, float shift, float lo, float hi,
                  cudaStream_t stream) {
  const int p = plan(n_fft, hop, n_mels, bf16);
  if (p == 0 || tf != (p == 3 ? WG_TF : TF) || bk != (p == 3 ? WG_TK : BK))
    return (int)cudaErrorInvalidValue;
  if (p == 3)
    return launch_wg<false>(x, kbasis, nullptr, out, B, n_pad, T, n_fft, hop, n_freqs, n_mels,
                            amin, shift, lo, hi, stream);
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

// Whether mel_linear_wg_kernel takes these shapes (1) or not (0).
int fused_mel_linear_plan(int n_fft, int hop, int n_mels) {
  return linear_plan(n_fft, hop, n_mels) ? 1 : 0;
}

// The GEMM front-end's linear mel in bf16 (mel_linear_wg_kernel): x [B,
// n_pad] fp32; items the plan-3 ring items of fused_log_mel (their
// filterbank items unread); band [n_tiles * tf] float4 {w0, w1, m0's int
// bits, 0} per laid-out frequency, zero weights past n_freqs; out [B, T,
// n_mels] fp32. tf and bk are checked as fused_log_mel checks them.
int fused_mel_linear(const float* x, const void* items, const void* band, float* out, int B,
                     int n_pad, int T, int n_fft, int hop, int n_freqs, int n_mels, int tf,
                     int bk, cudaStream_t stream) {
  if (!linear_plan(n_fft, hop, n_mels) || tf != WG_TF || bk != WG_TK)
    return (int)cudaErrorInvalidValue;
  return launch_wg<true>(x, items, static_cast<const float4*>(band), out, B, n_pad, T, n_fft, hop,
                         n_freqs, n_mels, 0.f, 0.f, 0.f, 0.f, stream);
}

}  // extern "C"
