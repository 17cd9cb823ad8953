// Hand-written Hopper kernels for one fused CRNN conv block, forward and
// backward, in fp32 and in bf16.
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
//   Design: the halo-tiled implicit GEMM of conv_bn_stats_bwd's dx, which
//   is the same operation (a SAME 3x3 conv; w [3,3,Ci,Co] is already
//   [9][Ci][Co]): one kernel body, `conv3x3_kernel`, with a template
//   epilogue. A block takes a row tile of TT frames x FF frequencies of one
//   clip and BN output channels (the grid's second axis covers any Co).
//   Each stage copies DX_BC input channels of the tile's halo (zeros where
//   the SAME padding lies, so the nine taps are fixed offsets) and the
//   matching [9][DX_BC][BN] weight slice with cp.async, the next stage in
//   flight; 8 x 8 outputs a thread, a channel's 10 halo values read once for
//   three taps where FF % 8 == 0 and BN >= 64. The STATS epilogue adds the
//   bias in fp32 (pallas_cnn.py:173-178), puts the tile's y in shared
//   memory, writes it out in 16-byte pieces and adds each lane's frames in
//   frame order into one partial per (clip, frame tile); a small pass adds
//   each lane's partials in a fixed order (no atomics: bitwise reruns). y is
//   not read back from device memory. The first block (Ci = 1: 9 taps of
//   one channel) is bound by the bytes of y and has its own streaming
//   kernel, a thread a frequency and 4 channels over a run of frames. On
//   the TPU the sequential grid carried the statistics in scratch
//   (pallas_cnn.py:155, :180). ops/fused_cnn.py `conv_fwd_plan` picks the
//   tiles from the shape.
//
// glu_drop_pool
//   What bounds it: the GLU is a [Co] x [Co, Co] product at every position,
//   about 18 GFLOP per forward at B=64 (~0.3 ms at fp32 peak) against ~0.9 GB
//   of y read once (~0.27 ms): both about even.
//   Design: persistent blocks of 256 threads walk tiles of P positions
//   ordered by pooled output, then window element, so that a thread's 4
//   positions are whole windows where pt*pf divides 4 and the average pool
//   is taken in its registers (other pools add the window in shared
//   memory). BN(y) of a tile goes into a channel-major tile yt[c][p]
//   (16-byte loads, all issued before the first is used); lin = ybn Wg + bg
//   is a register tile of 4 positions x 4 channels a thread from float4
//   reads of yt and of a Wg row, warps of 8 channel groups x 4 position
//   groups where the shape allows. Wg is staged in slices of depth (once,
//   where it fits whole) and the grid's second axis takes channel tiles of
//   up to 128, so any Co fits. GLU = lin * sigmoid(ybn), dropout from the
//   given uint8 bits read 4 at a time (keep if bits < thresh, scale by
//   1/keep, pallas_cnn.py:573). Rows past T//pt and columns past F//pf are
//   never produced (torch floor pooling). ops/fused_cnn.py `glu_fwd_plan`
//   gives the tile, the grid and the shared memory.
//
// The bf16 modes (pallas_cnn.py's bf16 mode: bf16 operands, fp32 sums,
// pallas_cnn.py:28-29), the serving path of crnn_2024(compute_dtype=bf16):
// conv_bn_stats bf16
//   What bounds it: x (64 M elements) and y (182 M) in bf16 per 2024 forward
//   at B=64, ~0.49 GB (~0.15 ms at 3.35 TB/s), against ~90 GFLOP of products
//   (~0.09 ms at the bf16 tensor cores' 989 TFLOP/s): bytes.
//   Design: the halo-tiled implicit GEMM of conv3x3_kernel with its
//   products on the tensor cores (mma.sync m16n8k16, fp32 accumulators in
//   registers; A and B fragments by ldmatrix straight from the staged halo
//   and weight rows, each lane naming the row of its position + the tap's
//   offset, so no im2col is formed; 16-byte chunks XORed by the row, so
//   ldmatrix reads no bank twice). Where Ci % 16 == 0, Co % 32 == 0 and F
//   is a power of two (every 2024 block but the first),
//   `conv3x3_bf16_fwd_kernel`: persistent CTAs walk runs of 256-row tiles
//   of whole frames, keep each lane's sums in registers over the run (one
//   partial row per CTA: at most 264 rows a lane, not one per tile), stage
//   the weights once per CTA where they fit (else per 16-channel slice,
//   with the halo) in a ring of stages that runs across tiles, read w as
//   [3, 3, Ci, Co] (ldmatrix.trans: no per-call transpose), and stage the
//   rounded y as bf16 for 16-byte stores and the sums. Other shapes:
//   `conv3x3_bf16_kernel`, one tile a block (w as [3, 3, Co, Ci], rows of
//   16 channels, the halves swapped on rows 4..7 of every 8), one partial
//   row per (clip, frame tile). The epilogues add the bias in fp32, round y
//   to bf16 and take the lane sums of the rounded y (pallas_cnn.py:171-178).
//   Ci = 1: `conv_c1_bf16_kernel` (F % 8 == 0, Co % 8 == 0, F Co <= 2048):
//   a CTA stages a run of frames' x once, a thread computes 8 channels of
//   a position (fp32 FMA: a product of two bf16 values is exact in fp32)
//   and writes them in one 16-byte store; other shapes the streaming
//   `conv_c1_kernel` with bf16 loads and stores. wgmma and TMA are left to
//   a later change. Its times on the H100 are in PERF.md.
// glu_drop_pool bf16
//   What bounds it: y and z in bf16 and, in training, the uint8 dropout
//   bits: ~0.48 GB per 2024 forward at B=64 (~0.145 ms at 3.35 TB/s; ~0.19
//   ms with bits at B=60), against 17.7 GFLOP of GLU products (0.02 ms on
//   the tensor cores): bytes, on paper. On the card the instructions per
//   element bound it: BN(y), the sigmoid (two special-function operations
//   an element, ~0.044 ms at the first block alone), dropout and the pool.
//   A first design (`glu_fwd_mma_kernel`, removed) ran at 12-18 % of the
//   bytes bound: phases one after another with one 16-byte load a thread in
//   flight, tiles of positions ordered by pooled output gathered through a
//   table, the bits read a byte at a time, and every element written to and
//   read back from shared memory three times (As, gt, the GLU).
//   Design, two kernels (`glu_fwd_plan` picks one from the shape):
//   `glu_fwd_frag_kernel` (Co = 16-128, pools up to 2 x 2: every 2024
//   block) keeps a tile in registers: each warp works alone on its own
//   tiles of 2 frames x 8-32 frequencies (or 16 consecutive rows of narrow
//   frames), its raw y and bits copied by 16-byte cp.async into its own
//   ring of 2-4 stages, 1-3 tiles ahead; an m16 tile is 8 frequencies of
//   two frames, so a lane's fragment rows g and g + 8 are one frequency in
//   the window's two frames and lane ^ 4 holds the next frequency: BN(y) is
//   formed in fp32 on the ldmatrix'd A fragment, rounded for mma.sync and
//   kept unrounded as the gate of the accumulators of the same rows and
//   channels, and the GLU, dropout and window sum (in window order, through
//   __shfl_xor_sync) run on the accumulators. No block barrier after the
//   weights are staged. `glu_fwd_ring_kernel` takes every other shape (Co
//   not 16-128 or not a multiple of 16, larger pools, Fo*pf neither a
//   multiple nor a divisor of 8): tiles of whole frames (or runs of whole
//   windows where frames are too wide), a block-wide ring of raw y and bits
//   by cp.async (element loads where F*Co or the tile's run is not a
//   multiple of 8 elements), As and gt in shared memory, mma.sync, the GLU
//   over gt, dropout from the staged bits and the pool from gt, z 16 bytes
//   at a time. Both: the sigmoid as ex2 and rcp (a few ulp from expf);
//   wgmma was not tried (depth 16-128; the tensor cores are not the limit).
//   A ring kernel with warp-group tiles, stages 2-4, tiles of 2-8 KB and an
//   unrolled m16 loop were measured and did not move the time (PERF.md).
//   Measured (H100 80GB HBM3, 700 W, scripts/time_conv_fwd.py --kernels):
//   the seven 2024 blocks take 0.41 ms of device time at B=64 (0.88 with
//   glu_fwd_mma_kernel) and 0.44 ms at B=60 with bits (1.18), each block at
//   13-41 % of its bytes bound; the register kernel uses 62-128 registers,
//   242 at Co = 128 (one block an SM).
// conv_bn_stats_bwd bf16 (the bf16 train step)
//   What bounds it: x, y, dy and dx in bf16 per 2024 train step at B=60,
//   ~0.9 GB (~0.27 ms), against ~167 GFLOP of bf16 products (~0.17 ms on
//   the tensor cores): bytes.
//   Design: `dy_eff_bf16_kernel` forms dy_eff in fp32 (no FMA, in
//   pallas_cnn.py:207's order), writes its bf16 rounding once for the two
//   products (:208) and the blocks' dbias partials of the unrounded values
//   (:211); dx is `conv3x3_bf16_kernel` without STATS (the same tensor-core
//   implicit GEMM as the bf16 forward, w flipped); dW is
//   `conv_dw_taps_kernel` on mma.sync with transposed fragments
//   (ldmatrix.trans, both operands rows-first in shared memory): a block
//   owns [9 taps x 16 or 32 channels] x up to 128 output channels of dW,
//   and one stage of a row tile's halo and dy_eff rows serves all nine
//   taps, so dy_eff is staged Ci / 32 times and the halo once (a first
//   design, a depth tile of one tap a block, staged both for every tap and
//   ran its products at 8 % of the tensor cores' peak). For Ci % 16 != 0
//   or Co % 8 != 0, conv_dw_kernel from bf16 stages on the CUDA cores
//   (exact: a product of two bf16 values is exact in fp32). Ci = 1:
//   `conv_dw_c1_bf16_kernel`, a streaming pass over y and dy (16-byte
//   loads, 8 channels a thread), x from a shared-memory tile, dbias from
//   its own fp32 dy_eff. dw and dbias are rounded once from their fp32
//   totals in the final fixed-order pass (:473-474). No atomics.
// glu_drop_pool_bwd bf16
//   What bounds it: dglu = dlin Wg^T and dWg = BN(y)^T dlin take dlin in
//   fp32 (:341-350: fp32 x bf16 dots keep the fp32 operand), so only lin is
//   a product of bf16 values: ~35 GFLOP at the fp32 peak (~0.53 ms) + ~18 at
//   the bf16 peak, against ~0.9 GB of bf16 y, dy, g and the bits (~0.28
//   ms): operations.
//   Design: Co = 16, 32, 64, 128 (every 2024 block): `glu_bwd_frag_kernel`
//   runs lin, the one product of bf16 values, on mma.sync and keeps the
//   fp32 kernel's phases C, D, E1 and E2 on the CUDA cores. A tile's raw y
//   and bits come by 16-byte cp.async into one of two stages, the next
//   tile's copies in flight behind the whole current tile; each warp
//   ldmatrix'es the A fragment of its m16 rows, forms BN(y) on it (a
//   multiply, then an add; its bf16 rounding the operand of lin and of
//   dWg, :312, :347), keeps the unrounded values of its own k16 steps as
//   the gates of its accumulators (the sigmoid's argument, :314), takes B
//   fragments by ldmatrix from Wg^T in bf16 (which D reads too), and
//   stores bf16(BN(y)), dlin and gu lin s (1 - s) from the accumulators'
//   layout into the [c][p] buffers the CUDA-core phases read; D reads y
//   from the stage. Other widths, and Co > 128: the fp32 kernel's
//   CUDA-core register tiles on bf16 loads and stores (`glu_bwd_kernel`
//   with TY = bf16). Both: the sigmoid as the fp32 kernel takes it; dy
//   rounded to bf16 (:354); dwg and dbg rounded once in the final pass
//   (:666-667). Splitting dlin into bf16 terms for the tensor cores is
//   left to a later change.
//
// The backward passes (the training step's kernels; their bf16 modes above):
//   conv_bn_stats_bwd <- _conv_stats_bwd_kernel (pallas_cnn.py:186, :443)
//   glu_drop_pool_bwd <- _epilogue_bwd_kernel   (pallas_cnn.py:295, :637)
//
// conv_bn_stats_bwd
//   What bounds it: dx and dW are each as many FMAs as the forward conv,
//   ~210 GFLOP per 2024 train step at B=60 (~3.1 ms at the fp32 peak of 67
//   TFLOP/s) against ~1.8 GB of x, y, dy and dx (~0.55 ms): operations,
//   except the first block (Ci = 1: 9 taps x 16 channels a row), which is
//   bound by the bytes of y and dy.
//   Design: dy_eff = dy + ds[lane] + 2 y dq[lane] (the BatchNorm statistics'
//   cotangents, pallas_cnn.py:207) is written once by an elementwise pass
//   (12 bytes an element); each GEMM would otherwise form it from four loads
//   for every tap and depth tile. Both GEMMs work on row tiles of whole
//   frames of one clip and copy a tile with its one-row halo into shared
//   memory with cp.async, zeros where the SAME padding lies, so the 9 taps
//   are 9 fixed offsets into the staged tile. dx (the transposed conv:
//   dy_eff with w flipped and transposed, pallas_cnn.py:439) stages DX_BC
//   channels of the halo and the matching weight slice per stage, 8 x 8
//   outputs a thread. dW (a [9*Ci, M] x [M, Co] product, M = B*T*F up to
//   4.8 M rows) stages the x halo of all Ci channels and the tile's dy_eff
//   rows; 8 x 4 or 8 x 8 outputs a thread, in row groups where [9*Ci, Co]
//   is small; blocks split the rows into chunks (about four blocks per SM
//   in all) and write one partial each, added in chunk order by a second
//   pass (no atomics: reruns give bitwise-equal gradients). The first block
//   (Ci = 1) skips both: one pass reads y and dy, forms dy_eff in registers
//   and keeps 9 x 4 + 4 sums a thread. ops/fused_cnn.py `conv_bwd_plan`
//   picks tiles, chunks and shared memory from the shape alone (two blocks
//   an SM). On the TPU the sequential grid carried dW in scratch
//   (pallas_cnn.py:195-198, :247).
//
// glu_drop_pool_bwd
//   What bounds it: three [Co] x [Co, Co] products per position (the GLU
//   recomputed, dlin Wg^T, and ybn^T dlin for dWg), ~53 GFLOP per train
//   step at B=60 (~0.8 ms at the fp32 peak), against ~1.8 GB of y, dy, g
//   and bits (~0.55 ms): operations, the first block bytes.
//   Design: one pass over y. Persistent blocks of 512 threads (16 warps, one
//   block per SM, Wg and Wg^T in shared memory) walk tiles of P positions
//   (P x Co = 8192: 64 positions at Co = 128, 512 at Co = 16), recomputing
//   BN(y), the GLU and the sigmoid; the incoming gradient is unpooled (rows
//   and columns past the pooled extent get 0, their dy is then the
//   statistics' share alone) and masked by the saved bits with the
//   thresholds of pallas_cnn.py:616. A thread's loads of y, g and the bits
//   (16-byte and 4-byte vectors where Co % 4 == 0) are all issued before the
//   first is used. The three products are register-tiled
//   GEMMs over the staged tile (4 positions x 4 channels a thread; dWg 4 x 4
//   or 4 x 8 entries a thread, in registers for the whole run). Lane sums of
//   dybn * y, dybn and dlin are read from shared memory only, one owner
//   thread per lane (f, c) adding the tile's positions of its lane in order.
//   Block partials are added in a fixed order by two small passes
//   (`glu_bwd_plan`). Where the F*Co lane sums do not fit in shared memory,
//   each block keeps them in its own partial row in device memory (one
//   owner thread per lane a tile, in tile order). Co > 128 (the wide
//   kernel, a correct simple path): Wg and Wg^T are staged in slices of as
//   many rows as fit, per product and tile, and dWg is taken in passes of
//   512 entry tiles, each thread reading its entries of the block's partial
//   from device memory, adding the tile's positions and writing them back,
//   in tile order. Deterministic throughout: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }
// the same to within a few ulp, on the special function unit (ex2, rcp)
__device__ __forceinline__ float sigmoid_fast(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// fp32 <-> the activations' type: the identity for float; for bf16 the
// round to nearest even that the TPU kernels' astype(bfloat16) does
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename TY>
__device__ __forceinline__ TY from_f(float v) {
  if constexpr (std::is_same<TY, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}
// v as the activations' type holds it, back in fp32
template <typename TY>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<TY>(v));
}
// the two bf16 halves of a 32-bit word (element 0 in the low half)
__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Asynchronous copies into shared memory (cp.async). A copy whose source lies
// outside the tensor writes zeros: src-size 0 reads nothing.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
// 16 (8) bytes into shared memory, of which the first n are read from src
// and the rest are zeros
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async8_n(void* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  cp_async16_n(dst, src, ok ? 16 : 0);
}
template <int VEC>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src, bool ok) {
  if constexpr (VEC == 4) {
    cp_async16(dst, src, ok);
  } else {
    cp_async4(dst, src, ok);
  }
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  cp_async8_n(dst, src, ok ? 8 : 0);
}
// VEC elements of the activations' type: cp.async of 4 or 16 bytes (fp32),
// of 8 bytes (bf16, VEC = 4), or a copy through a register (one bf16 value:
// below cp.async's 4 bytes; visible after the barrier that ends the stage)
template <int VEC, typename TX>
__device__ __forceinline__ void cp_async_x(TX* dst, const TX* src, bool ok) {
  if constexpr (std::is_same<TX, float>::value) {
    cp_async_vec<VEC>(dst, src, ok);
  } else if constexpr (VEC == 4) {
    cp_async8(dst, src, ok);
  } else {
    *dst = ok ? *src : __float2bfloat16_rn(0.f);
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// p[c .. c+3], zeros past Co: one 16-byte load where Co % 4 == 0 (p then
// lies on 16 bytes), else four guarded ones.
__device__ __forceinline__ float4 ld4(const float* __restrict__ p, int c, int Co) {
  if ((Co & 3) == 0) {
    return c < Co ? __ldg(reinterpret_cast<const float4*>(p + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(c < Co ? p[c] : 0.f, c + 1 < Co ? p[c + 1] : 0.f,
                     c + 2 < Co ? p[c + 2] : 0.f, c + 3 < Co ? p[c + 3] : 0.f);
}

// bf16 p[c .. c+3] as fp32, zeros past Co: one 8-byte load where Co % 4 == 0
__device__ __forceinline__ float4 ld4(const bf16* __restrict__ p, int c, int Co) {
  if ((Co & 3) == 0) {
    if (c >= Co) return make_float4(0.f, 0.f, 0.f, 0.f);
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p + c));
    return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
  }
  return make_float4(c < Co ? to_f(p[c]) : 0.f, c + 1 < Co ? to_f(p[c + 1]) : 0.f,
                     c + 2 < Co ? to_f(p[c + 2]) : 0.f, c + 3 < Co ? to_f(p[c + 3]) : 0.f);
}

// p[0 .. 3] from shared memory as fp32 (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

// bytes p[c .. c+3] (zeros past Co) packed little-endian into one word
__device__ __forceinline__ uint32_t ld_bytes4(const uint8_t* __restrict__ p, int c, int Co) {
  if ((Co & 3) == 0) return c < Co ? __ldg(reinterpret_cast<const uint32_t*>(p + c)) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) v |= (c + j < Co ? (uint32_t)p[c + j] : 0u) << (8 * j);
  return v;
}

// p[c .. c+3] = o, nothing past Co
__device__ __forceinline__ void st4(float* __restrict__ p, int c, int Co, const float* o) {
  if ((Co & 3) == 0) {
    if (c < Co) *reinterpret_cast<float4*>(p + c) = make_float4(o[0], o[1], o[2], o[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < Co) p[c + j] = o[j];
}

// bf16 p[c .. c+3] = o rounded, nothing past Co: one 8-byte store where Co % 4 == 0
__device__ __forceinline__ void st4(bf16* __restrict__ p, int c, int Co, const float* o) {
  if ((Co & 3) == 0) {
    if (c < Co) *reinterpret_cast<uint2*>(p + c) = make_uint2(bf_pack(o[0], o[1]), bf_pack(o[2], o[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < Co) p[c + j] = __float2bfloat16_rn(o[j]);
}

// ---------------------------------------------------------------------------
// The conv kernels' row tiles (conv_bn_stats and conv_bn_stats_bwd). A row
// tile is TT frames x FF frequencies of one clip b
// from (t0, f0); tiles are numbered f-tile fastest, then t-tile, then b
// (tests/test_torch_fused_cnn_plan.py walks the same numbering). Its halo
// adds one frame and one frequency on each side: (TT + 2) x (FF + 2) positions,
// pos = (jt + 1) * (FF + 2) + jf + 1, zero outside the clip (the SAME
// padding), so the 9 taps of a row are 9 fixed position offsets and no row
// needs a test.
// ---------------------------------------------------------------------------
struct RowTile {
  int b, t0, f0;
};

__device__ __forceinline__ RowTile row_tile(long long i, int T, int F, int TT, int FF) {
  const int nf = (F + FF - 1) / FF;
  const int nt = (T + TT - 1) / TT;
  RowTile r;
  r.f0 = (int)(i % nf) * FF;
  i /= nf;
  r.t0 = (int)(i % nt) * TT;
  r.b = (int)(i / nt);
  return r;
}

// Halo of tile rt, channels [c0, c0 + CS) of a [B, T, F, C] tensor, into
// dst[c][pos] (channel-major: a warp's 32 rows read 32 banks), 4-byte copies.
__device__ __forceinline__ void stage_halo_cm(float* dst, const float* __restrict__ src,
                                              RowTile rt, int TT, int FF, int T, int F,
                                              int C, int c0, int CS, int tid, int nthreads) {
  const int W = FF + 2;
  const int NP = (TT + 2) * W;
  for (int i = tid; i < NP * CS; i += nthreads) {
    const int pos = i / CS;
    const int q = i - pos * CS;
    const int jt = pos / W;
    const int t = rt.t0 + jt - 1, f = rt.f0 + pos - jt * W - 1, c = c0 + q;
    const bool ok = t >= 0 && t < T && f >= 0 && f < F && c < C;
    cp_async4(dst + q * NP + pos, ok ? src + (((long long)rt.b * T + t) * F + f) * C + c : src,
              ok);
  }
}

// Halo of tile rt, all C channels, into dst[pos][C] (position-major: a row's
// channels are contiguous), copies of VEC elements (VEC = 4 needs C % 4 == 0).
template <int VEC, typename TX>
__device__ __forceinline__ void stage_halo_pm(TX* dst, const TX* __restrict__ src,
                                              RowTile rt, int TT, int FF, int T, int F,
                                              int C, int tid, int nthreads) {
  const int W = FF + 2;
  const int per = C / VEC;
  const int n = (TT + 2) * W * per;
  for (int i = tid; i < n; i += nthreads) {
    const int pos = i / per;
    const int c = (i - pos * per) * VEC;
    const int jt = pos / W;
    const int t = rt.t0 + jt - 1, f = rt.f0 + pos - jt * W - 1;
    const bool ok = t >= 0 && t < T && f >= 0 && f < F;
    cp_async_x<VEC>(dst + pos * C + c,
                    ok ? src + (((long long)rt.b * T + t) * F + f) * C + c : src, ok);
  }
}

// dy_eff = dy + ds[lane] + 2 y dq[lane], lane = f * Co + c = e % L
// (pallas_cnn.py:207), written once for the two GEMMs that read it.
__global__ void dy_eff_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                              const float* __restrict__ ds, const float* __restrict__ dq,
                              float* __restrict__ dye, long long n, int L) {
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4; e < n;
       e += stride) {
    const int l = (int)(e % L);
    if (L % 4 == 0) {  // four elements of one frame
      const float4 a = *reinterpret_cast<const float4*>(dy + e);
      const float4 b = *reinterpret_cast<const float4*>(y + e);
      const float4 s = *reinterpret_cast<const float4*>(ds + l);
      const float4 q = *reinterpret_cast<const float4*>(dq + l);
      float4 o;
      o.x = a.x + s.x + 2.f * b.x * q.x;
      o.y = a.y + s.y + 2.f * b.y * q.y;
      o.z = a.z + s.z + 2.f * b.z * q.z;
      o.w = a.w + s.w + 2.f * b.w * q.w;
      *reinterpret_cast<float4*>(dye + e) = o;
    } else {
      for (long long k = e; k < e + 4 && k < n; ++k) {
        const int lk = (int)(k % L);
        dye[k] = dy[k] + ds[lk] + 2.f * y[k] * dq[lk];
      }
    }
  }
}

// bf16 dy_eff: dy + ds[lane] + 2 y dq[lane] in fp32 from bf16 y and dy (the
// sum, then the product added, each rounded, in pallas_cnn.py:207's order,
// no FMA), rounded to bf16 into dye as the operand of the dx and dW products
// (:208). With part_b, the block's dbias partial of the UNROUNDED values
// (:211): block b takes rows [b * rows, (b + 1) * rows) of M; thread (rs, g)
// channels 8g .. 8g + 7 (16-byte loads where Co % 8 == 0) of rows rs,
// rs + RS, ...; the block adds its RS row slots in order (no atomics).
constexpr int EFF_THREADS = 256;

__global__ void __launch_bounds__(EFF_THREADS) dy_eff_bf16_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ dy, const float* __restrict__ ds,
    const float* __restrict__ dq, bf16* __restrict__ dye, float* __restrict__ part_b,
    long long M, int F, int Co, int rows) {
  __shared__ float red[EFF_THREADS * 8];
  const int G = (Co + 7) / 8, RS = EFF_THREADS / G;
  const int tid = threadIdx.x, g = tid % G, rs = tid / G, c0 = 8 * g;
  const long long r0 = (long long)blockIdx.x * rows;
  const long long r1 = min(M, r0 + rows);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (rs < RS) {
#pragma unroll 2
    for (long long m = r0 + rs; m < r1; m += RS) {
      const int l0 = (int)(m % F) * Co + c0;
      const long long e0 = m * Co + c0;
      float a[8], b[8], o[8];
      if ((Co & 7) == 0) {
        const uint4 ua = __ldg(reinterpret_cast<const uint4*>(dy + e0));
        const uint4 ub = __ldg(reinterpret_cast<const uint4*>(y + e0));
        const uint32_t wa[4] = {ua.x, ua.y, ua.z, ua.w}, wb[4] = {ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[2 * k] = bf_lo(wa[k]);
          a[2 * k + 1] = bf_hi(wa[k]);
          b[2 * k] = bf_lo(wb[k]);
          b[2 * k + 1] = bf_hi(wb[k]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a[j] = c0 + j < Co ? to_f(dy[e0 + j]) : 0.f;
          b[j] = c0 + j < Co ? to_f(y[e0 + j]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = c0 + j < Co;
        const float sv = ok ? __ldg(ds + l0 + j) : 0.f, qv = ok ? __ldg(dq + l0 + j) : 0.f;
        o[j] = __fadd_rn(__fadd_rn(a[j], sv), __fmul_rn(__fmul_rn(2.f, b[j]), qv));
        acc[j] += o[j];
      }
      if ((Co & 7) == 0) {
        *reinterpret_cast<uint4*>(dye + e0) = make_uint4(bf_pack(o[0], o[1]), bf_pack(o[2], o[3]),
                                                         bf_pack(o[4], o[5]), bf_pack(o[6], o[7]));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < Co) dye[e0 + j] = __float2bfloat16_rn(o[j]);
      }
    }
  }
  if (part_b == nullptr) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) red[tid * 8 + j] = acc[j];
  __syncthreads();
  for (int c = tid; c < Co; c += EFF_THREADS) {
    float sum = 0.f;
    for (int r = 0; r < RS; ++r) sum += red[(r * G + c / 8) * 8 + c % 8];
    part_b[(long long)blockIdx.x * Co + c] = sum;
  }
}

// out = SAME conv3x3 of `in` [B, T, F, Cin] with wk [9][Cin][Cout]: an
// implicit GEMM of M rows x BN output channels per block, depth 9 * Cin.
// It is conv_bn_stats' conv (wk = w) and conv_bn_stats_bwd's dx (in =
// dy_eff, wk = w flipped and transposed). Each stage copies DX_BC channels
// of the tile's halo (once, for all 9 taps) and the matching
// [9][DX_BC][BN] slice of wk, the next stage in flight while one is
// multiplied. 256 threads, 8 x 8 outputs each: columns tx*4 + {0..3} and
// BN/2 + tx*4 + {0..3}; rows ty + NY i, or with SEG (FF % 8 == 0, BN >= 64)
// the 8 neighbouring frequencies ty*8 + i of one frame: then
// the 10 halo values that a channel's three taps of one frame offset dt
// need are read once for the three, 10 shared loads for 192 FMAs instead of
// 24. (At BN < 64 a warp spans more than 4 segments, 8 floats apart, and
// their reads would meet in the same banks.)
// Epilogue: without STATS the outputs go straight from registers to `out`
// (dx). With STATS (conv_bn_stats) the bias is added, the tile's y is put
// in shared memory as [TT * FF][BN] (the stage buffers are free by then),
// written to `out` in VEC-float pieces, and each lane (f, c) of the tile
// adds its frames in order into part_s / part_q row (b * nt + t-tile).
constexpr int DX_BC = 8;

template <int BN, int VEC, bool SEG, bool STATS>
__global__ void __launch_bounds__(256, 2) conv3x3_kernel(
    const float* __restrict__ in, const float* __restrict__ wk, float* __restrict__ out,
    const float* __restrict__ bias, float* __restrict__ part_s, float* __restrict__ part_q,
    int B, int T, int F, int Cin, int Cout, int TT, int FF) {
  constexpr int BC = DX_BC, NX = BN / 8, NY = 256 / NX;
  extern __shared__ __align__(16) float smem[];
  const int W = FF + 2;
  const int NP = (TT + 2) * W;
  const int NPA = (NP + 3) & ~3;  // keeps the weight slices 16-byte aligned
  // halo of stage buffer b at smem + b * NPA * BC, its weight slice after both
  float* const wsl0 = smem + 2 * NPA * BC;
  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const RowTile rt = row_tile(blockIdx.x, T, F, TT, FF);
  const int n0 = blockIdx.y * BN;

  int pos[8];  // halo position of each row (SEG: of the segment's first row)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = SEG ? ty * 8 : ty + NY * i;
    const int jt = r / FF;
    pos[i] = (jt < TT ? jt : 0) * W + (jt < TT ? r - jt * FF : 0) + W + 1;  // past the tile: any
  }

  auto stage = [&](int sl, int buf) {
    const int c0 = sl * BC;
    stage_halo_cm(smem + buf * NPA * BC, in, rt, TT, FF, T, F, Cin, c0, BC, tid, 256);
    constexpr int per = BN / VEC;
    for (int i = tid; i < 9 * BC * per; i += 256) {
      const int row = i / per;  // tap * BC + channel
      const int n = (i - row * per) * VEC;
      const int tap = row / BC;
      const int c = c0 + row - tap * BC;
      const bool ok = c < Cin && n0 + n < Cout;
      cp_async_vec<VEC>(wsl0 + buf * 9 * BC * BN + row * BN + n,
                        ok ? wk + ((long long)tap * Cin + c) * Cout + n0 + n : wk, ok);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_sl = (Cin + BC - 1) / BC;
  stage(0, 0);
  for (int sl = 0; sl < n_sl; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < n_sl) {
      stage(sl + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (SEG) {
#pragma unroll 1
      for (int dt = 0; dt < 3; ++dt) {
        const float* H = smem + buf * NPA * BC + pos[0] + (dt - 1) * W - 1;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          float v[10];
#pragma unroll
          for (int q = 0; q < 10; ++q) v[q] = H[c * NP + q];
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const float* wr = wsl0 + ((buf * 9 + dt * 3 + df) * BC + c) * BN + tx * 4;
            const float4 b0 = *reinterpret_cast<const float4*>(wr);
            const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(v[i + df], b[j], acc[i][j]);
          }
        }
      }
    } else {
      // taps not unrolled: unrolled, the 72 x 8 halo addresses outgrow the
      // registers and spill
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const float* H = smem + buf * NPA * BC + (tap / 3 - 1) * W + tap % 3 - 1;
        const float* Ws = wsl0 + (buf * 9 + tap) * BC * BN + tx * 4;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          float a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = H[c * NP + pos[i]];
          const float* wr = Ws + c * BN;
          const float4 b0 = *reinterpret_cast<const float4*>(wr);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (STATS) {
    const int R = TT * FF;
    float* const ys = smem;  // [R][BN]
    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 4 + (j / 4) * (BN / 2) + j % 4;
      bv[j] = n < Cout ? bias[n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = SEG ? ty * 8 + i : ty + NY * i;
      if (r >= R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(ys + r * BN + h * (BN / 2) + tx * 4) =
            make_float4(acc[i][4 * h] + bv[4 * h], acc[i][4 * h + 1] + bv[4 * h + 1],
                        acc[i][4 * h + 2] + bv[4 * h + 2], acc[i][4 * h + 3] + bv[4 * h + 3]);
    }
    __syncthreads();
    constexpr int per = BN / VEC;
    for (int e = tid; e < R * per; e += 256) {
      const int r = e / per;
      const int n = (e - r * per) * VEC;
      const int jt = r / FF;
      const int t = rt.t0 + jt, f = rt.f0 + r - jt * FF;
      if (t >= T || f >= F || n0 + n >= Cout) continue;
      float* o = out + (((long long)rt.b * T + t) * F + f) * Cout + n0 + n;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(ys + r * BN + n);
      } else {
        *o = ys[r * BN + n];
      }
    }
    // the lane sums of the tile's frames, in frame order
    const int L = F * Cout;
    const long long prow = blockIdx.x / ((F + FF - 1) / FF);  // b * nt + t-tile
    const int frames = min(TT, T - rt.t0);
    for (int l = tid; l < FF * BN; l += 256) {
      const int fl = l / BN, c = l - fl * BN;
      const int f = rt.f0 + fl, n = n0 + c;
      if (f >= F || n >= Cout) continue;
      float s = 0.f, q = 0.f;
      for (int jt = 0; jt < frames; ++jt) {
        const float v = ys[(jt * FF + fl) * BN + c];
        s += v;
        q = fmaf(v, v, q);
      }
      part_s[prow * L + f * Cout + n] = s;
      part_q[prow * L + f * Cout + n] = q;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = SEG ? ty * 8 + i : ty + NY * i;
      const int jt = r / FF;
      const int t = rt.t0 + jt, f = rt.f0 + r - jt * FF;
      if (jt >= TT || t >= T || f >= F) continue;
      float* o = out + (((long long)rt.b * T + t) * F + f) * Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx * 4 + (j / 4) * (BN / 2) + j % 4;
        if (n < Cout) o[n] = acc[i][j];
      }
    }
  }
}

// conv_bn_stats for Ci = 1 (the first block: 9 taps of one input channel),
// bound by the bytes of y, which it writes once. Thread (f, g) of block
// (x, part) makes channels 4g .. 4g+3 at frequency f of frames
// (b, t) = rows part * rows_per_part ..., in order, from 9 x values and its
// 9 x 4 weights in registers, and adds y and y^2 of its lanes over them
// into part_s / part_q row `part`. TY = bf16: x, w and the bias are read as
// bf16 (a product of two bf16 values is exact in fp32), the fp32 sum plus
// the bias is rounded to bf16 and y is written as bf16; the sums take the
// rounded y (pallas_cnn.py:173-178).
template <typename TY>
__global__ void __launch_bounds__(256, 4) conv_c1_kernel(
    const TY* __restrict__ x, const TY* __restrict__ w, const TY* __restrict__ bias,
    TY* __restrict__ y, float* __restrict__ part_s, float* __restrict__ part_q, int B, int T,
    int F, int Co, int rows_per_part) {
  const int G = (Co + 3) / 4;
  const int lg = blockIdx.x * 256 + threadIdx.x;
  if (lg >= F * G) return;
  const int f = lg / G, c0 = (lg - f * G) * 4;
  const int R = B * T;  // rows fit in an int (the plan checks)
  const int r0 = blockIdx.y * rows_per_part;
  const int r1 = min(R, r0 + rows_per_part);
  float wv[9][4], bv[4], s[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool ok = c0 + j < Co;
    bv[j] = ok ? to_f(bias[c0 + j]) : 0.f;
    s[j] = q[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wv[tap][j] = ok ? to_f(w[tap * Co + c0 + j]) : 0.f;
  }
  // unrolled so that several frames' loads are in flight at once
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const int t = r % T;
    const long long m = (long long)r * F + f;
    float xv[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3 - 1, df = tap % 3 - 1;
      const bool ok = t + dt >= 0 && t + dt < T && f + df >= 0 && f + df < F;
      xv[tap] = ok ? to_f(x[m + dt * F + df]) : 0.f;
    }
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float a = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) a = fmaf(xv[tap], wv[tap][j], a);
      o[j] = rnd<TY>(a + bv[j]);
      s[j] += o[j];
      q[j] = fmaf(o[j], o[j], q[j]);
    }
    st4(y + m * Co, c0, Co, o);
  }
  const long long base = (long long)blockIdx.y * F * Co + f * Co + c0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c0 + j < Co) {
      part_s[base + j] = s[j];
      part_q[base + j] = q[j];
    }
  }
}

// s[l], q[l]: lane l's n partial rows added in row order, as 32 runs of
// consecutive rows (one warp each, 32 lanes a block) added in run order.
constexpr int STATS_RUNS = 32;

__global__ void __launch_bounds__(32 * STATS_RUNS) lane_stats_final_kernel(
    const float* __restrict__ part_s, const float* __restrict__ part_q, float* __restrict__ s,
    float* __restrict__ q, int L, int n) {
  __shared__ float red[2][STATS_RUNS][32];
  const int lane = threadIdx.x % 32, g = threadIdx.x / 32;
  const int l = blockIdx.x * 32 + lane;
  const int per = (n + STATS_RUNS - 1) / STATS_RUNS;
  const int r1 = min(n, (g + 1) * per);
  float a = 0.f, b = 0.f;
  if (l < L) {
#pragma unroll 4
    for (int r = g * per; r < r1; ++r) {
      a += part_s[(long long)r * L + l];
      b += part_q[(long long)r * L + l];
    }
  }
  red[0][g][lane] = a;
  red[1][g][lane] = b;
  __syncthreads();
  if (g == 0 && l < L) {
    float u = 0.f, v = 0.f;
#pragma unroll
    for (int k = 0; k < STATS_RUNS; ++k) {
      u += red[0][k][lane];
      v += red[1][k][lane];
    }
    s[l] = u;
    q[l] = v;
  }
}

// ---------------------------------------------------------------------------
// conv_bn_stats in bf16 (Ci > 1): the halo-tiled implicit GEMM of
// conv3x3_kernel with its products on the tensor cores. Rows: a tile of TT
// frames x FF frequencies of one clip (M = TT * FF <= MT rows); columns: BN
// output channels (the grid's second axis); depth: 9 taps x Cin. Each stage
// copies BK = 16 input channels of the tile's halo and the matching
// [9][BN][16] slice of wt = w as [3, 3, Co, Ci] (bf16, zeros past Cin and
// Cout), the next stage in flight while one is multiplied: for every tap a
// warp takes its rows' A fragments from the halo by ldmatrix (each lane
// names the row of its position + the tap's offset, so no im2col is formed)
// and the B fragments of its n8 tiles by ldmatrix, and issues
// mma.m16n8k16 bf16 x bf16 -> fp32. 8 warps as WM x WN, each MI m16 tiles
// of rows x NI n8 tiles; fp32 accumulators in registers. Narrow channel
// tiles take more rows (MT = 128 rows at BN = 128, 256 at 64, 512 below),
// so that the tiles, and the lane partials they write, are as few as the
// shared memory allows.
// Epilogue as conv3x3_kernel's STATS one: + bias in fp32, y rounded to bf16
// (pallas_cnn.py:173-178) and put in shared memory as fp32, written out in
// 16-byte pieces where Cout % 8 == 0, each lane's frames of the tile added
// in order from the rounded values into part_s / part_q row (b * nt + t-tile).
// Without STATS (conv_bn_stats_bwd's dx in bf16: x = bf16 dy_eff, wt = w
// flipped in (dt, df), which is [3, 3, Ci, Co] = [tap][out][in] of the
// transposed conv): no bias and no sums, the output rounded to bf16 once
// (pallas_cnn.py:239).
// ---------------------------------------------------------------------------
constexpr int BK = 16;  // input channels a stage: one k-step of the mma per tap

// element offset of (row, 8-channel chunk) in a [rows][16] bf16 array whose
// chunks are swapped on rows 4..7 of every 8, so that ldmatrix's 8 rows of
// one chunk (32 bytes apart) fall in 8 distinct groups of 4 banks
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ (row >> 2)) & 1) * 8;
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(unsigned addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN, bool VEC, bool STATS>
__global__ void __launch_bounds__(256, 2) conv3x3_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wt, const bf16* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ part_s, float* __restrict__ part_q, int B, int T,
    int F, int Cin, int Cout, int TT, int FF) {
  constexpr int WN = BN >= 64 ? 2 : 1, WM = 8 / WN, MI = BN == 128 ? 2 : 4, NI = BN / (8 * WN);
  constexpr int YS = BN + 8;  // row stride of the epilogue's fp32 tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int W = FF + 2;
  const int NP = (TT + 2) * W;
  const int STG = (NP + 9 * BN) * BK;  // a stage: halo rows, then weight rows tap * BN + n
  const int R = TT * FF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const RowTile rt = row_tile(blockIdx.x, T, F, TT, FF);
  const int n0 = blockIdx.y * BN;

  // the halo position of this lane's ldmatrix row (row lane % 16 of each of
  // the warp's m16 tiles); rows past the tile read any position
  int apos[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = wm * 16 * MI + mi * 16 + (lane & 15);
    const int jt = r / FF;
    apos[mi] = r < R ? (jt + 1) * W + r - jt * FF + 1 : W + 1;
  }
  const int achunk = lane >> 4;
  // B: lane l names row l % 8 of n8 tile (l / 16) of a pair, chunk (l / 8) % 2
  const int brow = wn * NI * 8 + (NI >= 2 ? (lane >> 4) * 8 : 0) + (lane & 7);
  const int bchunk = (lane >> 3) & 1;

  auto stage = [&](int sl, int buf) {
    bf16* const H = sm + buf * STG;
    bf16* const Wt = H + NP * BK;
    const int c0 = sl * BK;
    if constexpr (VEC) {  // Cin % 8 == 0: 16-byte copies of 8 channels
      for (int i = tid; i < NP * 2; i += 256) {
        const int pos = i >> 1, ch = i & 1;
        const int jt = pos / W;
        const int t = rt.t0 + jt - 1, f = rt.f0 + pos - jt * W - 1, c = c0 + ch * 8;
        const bool ok = t >= 0 && t < T && f >= 0 && f < F && c < Cin;
        cp_async16(H + swz(pos, ch), ok ? x + (((long long)rt.b * T + t) * F + f) * Cin + c : x,
                   ok);
      }
      for (int i = tid; i < 9 * BN * 2; i += 256) {
        const int row = i >> 1, ch = i & 1;
        const int tap = row / BN;
        const int n = n0 + row - tap * BN, c = c0 + ch * 8;
        const bool ok = n < Cout && c < Cin;
        cp_async16(Wt + swz(row, ch), ok ? wt + ((long long)tap * Cout + n) * Cin + c : wt, ok);
      }
    } else {  // any Cin: element copies through registers
      const bf16 zero = __float2bfloat16_rn(0.f);
      for (int i = tid; i < NP * BK; i += 256) {
        const int pos = i / BK, q = i - pos * BK;
        const int jt = pos / W;
        const int t = rt.t0 + jt - 1, f = rt.f0 + pos - jt * W - 1, c = c0 + q;
        const bool ok = t >= 0 && t < T && f >= 0 && f < F && c < Cin;
        H[swz(pos, q >> 3) + (q & 7)] =
            ok ? x[(((long long)rt.b * T + t) * F + f) * Cin + c] : zero;
      }
      for (int i = tid; i < 9 * BN * BK; i += 256) {
        const int row = i / BK, q = i - row * BK;
        const int tap = row / BN;
        const int n = n0 + row - tap * BN, c = c0 + q;
        Wt[swz(row, q >> 3) + (q & 7)] =
            n < Cout && c < Cin ? wt[((long long)tap * Cout + n) * Cin + c] : zero;
      }
    }
    cp_async_commit();
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int n_sl = (Cin + BK - 1) / BK;
  stage(0, 0);
  for (int sl = 0; sl < n_sl; ++sl) {
    const int buf = sl & 1;
    if (sl + 1 < n_sl) {
      stage(sl + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned hs = (unsigned)__cvta_generic_to_shared(sm + buf * STG);
    const unsigned ws = hs + 2u * (unsigned)(NP * BK);
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * W + tap % 3 - 1;
      uint32_t a[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldsm_x4(hs + 2u * (unsigned)swz(apos[mi] + off, achunk), a[mi][0], a[mi][1], a[mi][2],
                a[mi][3]);
      const int rb = tap * BN + brow;
      if constexpr (NI >= 2) {
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(ws + 2u * (unsigned)swz(rb + ni * 8, bchunk), b0, b1, b2, b3);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][ni], a[mi], b0, b1);
            mma_bf16(acc[mi][ni + 1], a[mi], b2, b3);
          }
        }
      } else {
        uint32_t b0, b1;
        ldsm_x2(ws + 2u * (unsigned)swz(rb, bchunk), b0, b1);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_bf16(acc[mi][0], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: the stage buffers are free; ys [R][YS] fp32 holds the rounded y
  float* const ys = reinterpret_cast<float*>(smem_raw);
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int n = wn * NI * 8 + ni * 8 + 2 * tq;
    const float b0 = STATS && n0 + n < Cout ? to_f(bias[n0 + n]) : 0.f;
    const float b1 = STATS && n0 + n + 1 < Cout ? to_f(bias[n0 + n + 1]) : 0.f;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int r = wm * 16 * MI + mi * 16 + gq;
      if (r < R)
        *reinterpret_cast<float2*>(ys + r * YS + n) =
            make_float2(rnd<bf16>(acc[mi][ni][0] + b0), rnd<bf16>(acc[mi][ni][1] + b1));
      if (r + 8 < R)
        *reinterpret_cast<float2*>(ys + (r + 8) * YS + n) =
            make_float2(rnd<bf16>(acc[mi][ni][2] + b0), rnd<bf16>(acc[mi][ni][3] + b1));
    }
  }
  __syncthreads();
  constexpr int per = BN / 8;
  for (int e = tid; e < R * per; e += 256) {
    const int r = e / per;
    const int n = (e - r * per) * 8;
    const int jt = r / FF;
    const int t = rt.t0 + jt, f = rt.f0 + r - jt * FF;
    if (t >= T || f >= F || n0 + n >= Cout) continue;
    bf16* o = y + (((long long)rt.b * T + t) * F + f) * Cout + n0 + n;
    const float* v = ys + r * YS + n;
    if ((Cout & 7) == 0) {
      *reinterpret_cast<uint4*>(o) = make_uint4(bf_pack(v[0], v[1]), bf_pack(v[2], v[3]),
                                                bf_pack(v[4], v[5]), bf_pack(v[6], v[7]));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n0 + n + j < Cout) o[j] = __float2bfloat16_rn(v[j]);
    }
  }
  if constexpr (STATS) {  // the lane sums of the tile's frames, in frame order
    const int L = F * Cout;
    const long long prow = blockIdx.x / ((F + FF - 1) / FF);  // b * nt + t-tile
    const int frames = min(TT, T - rt.t0);
    for (int l = tid; l < FF * BN; l += 256) {
      const int fl = l / BN, c = l - fl * BN;
      const int f = rt.f0 + fl, n = n0 + c;
      if (f >= F || n >= Cout) continue;
      float s = 0.f, q = 0.f;
      for (int jt = 0; jt < frames; ++jt) {
        const float v = ys[(jt * FF + fl) * YS + c];
        s += v;
        q = fmaf(v, v, q);
      }
      part_s[prow * L + f * Cout + n] = s;
      part_q[prow * L + f * Cout + n] = q;
    }
  }
}

// dW and dbias partials: block (kt, ct, chunk) computes the [BKO x BNO] tile
// of dW[k][co] = sum over rows m of x[m + tap offset][ci] * dy_eff[m][co],
// k = tap * Ci + ci, over the row tiles of its chunk, in order. Per tile:
// the x halo (all Ci channels, position-major) and the tile's dy_eff rows,
// in a ring of DW_STAGES buffers (cp.async, 16-byte copies where Ci and Co
// allow): the next tile is in flight while one is multiplied, one barrier
// a tile (a third stage measured no faster on the H100).
// 256 threads as RG = 256 / (NTY * NTX) row groups of NTY x NTX threads,
// TM x TN outputs a thread (8 x 4 or 8 x 8: four 16-byte shared loads or
// fewer per 32 or 64 FMAs); group g takes rows g, g + RG, ... of each tile,
// so a small [K, Co] (the early blocks) still keeps every thread busy with a
// full register tile. A thread's TM depth indices are fixed, so their
// (tap, ci) offsets into the halo are computed once; the rows' offsets come
// from a table. At the end the groups' tiles are added in group order.
// TX = bf16 (the bf16 mode): x and the rounded dy_eff are staged as bf16 and
// multiplied on the CUDA cores in fp32 (a product of two bf16 values is
// exact in fp32, so the sums are those of bf16 operands with fp32
// accumulators); dbias comes from the dy_eff pass instead (unrounded).
constexpr int DW_MAX_ROWS = 256;
constexpr int DW_STAGES = 2;

template <int TN, int NTY, int NTX, int VEC, typename TX>
__global__ void __launch_bounds__(256, 2) conv_dw_kernel(
    const TX* __restrict__ x, const TX* __restrict__ dye, float* __restrict__ part_w,
    float* __restrict__ part_b, int B, int T, int F, int Ci, int Co, int TT, int FF,
    int n_tiles, int tiles_per_chunk) {
  constexpr int TM = 8, BKO = NTY * TM, BNO = NTX * TN, NG = NTY * NTX, RG = 256 / NG;
  constexpr bool F32 = std::is_same<TX, float>::value;
  static_assert(256 % NG == 0 && 256 % BNO == 0, "thread tiles");
  extern __shared__ __align__(16) unsigned char smem_dw[];
  float* const smem = reinterpret_cast<float*>(smem_dw);  // the groups' tiles at the end
  __shared__ int rowoff[DW_MAX_ROWS];  // halo offset of row r from row (0, 0)
  __shared__ float bred[256];
  const int W = FF + 2;
  const int NP = (TT + 2) * W;
  const int R = TT * FF;
  const int XS = F32 ? (NP * Ci + 3) & ~3 : (NP * Ci + 7) & ~7;  // 16-byte multiples
  // stage buffer b: the x halo at sx + b * XS, the dy_eff rows at ds0 + b * R * BNO
  TX* const sx = reinterpret_cast<TX*>(smem_dw);
  TX* const ds0 = sx + DW_STAGES * XS;
  const int K = 9 * Ci;
  const int k0 = blockIdx.x * BKO, n0 = blockIdx.y * BNO;
  const int tid = threadIdx.x, grp = tid / NG, tx = tid % NTX, ty = (tid % NG) / NTX;
  const bool kt0 = blockIdx.x == 0;  // these blocks also sum dbias
  const int tile0 = blockIdx.z * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);

  for (int r = tid; r < R; r += 256) rowoff[r] = ((r / FF) * W + r % FF) * Ci;
  int aoff[TM];  // offset of depth index k in the halo, from the row's position
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int k = k0 + ty * TM + i;
    const int tap = k / Ci;
    aoff[i] = k < K ? ((tap / 3 - 1) * W + tap % 3 - 1) * Ci + k - tap * Ci : 0;
  }
  int co[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) co[j] = TN == 8 ? tx * 4 + (j / 4) * (BNO / 2) + j % 4 : tx * 4 + j;

  auto stage = [&](int tile, int buf) {
    const RowTile rt = row_tile(tile, T, F, TT, FF);
    stage_halo_pm<VEC>(sx + buf * XS, x, rt, TT, FF, T, F, Ci, tid, 256);
    constexpr int per = BNO / VEC;
    for (int i = tid; i < R * per; i += 256) {
      const int r = i / per;
      const int n = (i - r * per) * VEC;
      const int jt = r / FF;
      const int t = rt.t0 + jt, f = rt.f0 + r - jt * FF;
      const bool ok = t < T && f < F && n0 + n < Co;
      cp_async_x<VEC>(ds0 + buf * R * BNO + r * BNO + n,
                      ok ? dye + (((long long)rt.b * T + t) * F + f) * Co + n0 + n : dye, ok);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  // one commit group per tile, empty past the chunk's last tile, so that
  // waiting for all but DW_STAGES - 2 groups means the current tile landed
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (tile0 + s < tile1) {
      stage(tile0 + s, s);
    } else {
      cp_async_commit();
    }
  }
  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) % DW_STAGES;
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();  // the tile landed for all; the previous buffer is free
    if (tile + DW_STAGES - 1 < tile1) {
      stage(tile + DW_STAGES - 1, (buf + DW_STAGES - 1) % DW_STAGES);
    } else {
      cp_async_commit();
    }
    const TX* X = sx + buf * XS + (W + 1) * Ci;  // the position of row (0, 0)
    const TX* D = ds0 + buf * R * BNO;
    for (int r = grp; r < R; r += RG) {
      const TX* xr = X + rowoff[r];
      const TX* dr = D + r * BNO;
      float a[TM], b[TN];
      if constexpr (VEC == 4) {
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 v = lds4(xr + aoff[4 * g]);
          a[4 * g] = v.x;
          a[4 * g + 1] = v.y;
          a[4 * g + 2] = v.z;
          a[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 v = lds4(dr + co[4 * g]);
          b[4 * g] = v.x;
          b[4 * g + 1] = v.y;
          b[4 * g + 2] = v.z;
          b[4 * g + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = to_f(xr[aoff[i]]);
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = to_f(dr[co[j]]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (F32 && kt0)  // thread t sums channel t % BNO over rows t / BNO, + 256 / BNO, ...
      for (int r = tid / BNO; r < R; r += 256 / BNO) bsum += to_f(D[r * BNO + tid % BNO]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read

  const long long chunk = blockIdx.z;
  if constexpr (RG > 1) {  // the stage buffers are free: [RG][BKO][BNO]
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) smem[(grp * BKO + ty * TM + i) * BNO + co[j]] = acc[i][j];
    __syncthreads();
    for (int e = tid; e < BKO * BNO; e += 256) {
      const int k = k0 + e / BNO, n = n0 + e % BNO;
      float s = 0.f;
      for (int q = 0; q < RG; ++q) s += smem[q * BKO * BNO + e];
      if (k < K && n < Co) part_w[(chunk * K + k) * Co + n] = s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int k = k0 + ty * TM + i;
      if (k >= K) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + co[j];
        if (n < Co) part_w[(chunk * K + k) * Co + n] = acc[i][j];
      }
    }
  }
  if (F32 && kt0) {
    bred[tid] = bsum;
    __syncthreads();
    if (tid < BNO && n0 + tid < Co) {
      float s = 0.f;
      for (int q = 0; q < 256 / BNO; ++q) s += bred[q * BNO + tid];
      part_b[chunk * Co + n0 + tid] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// dW in bf16 on the tensor cores (Ci % 16 == 0, Co % 8 == 0):
// conv_dw_taps_kernel. Block (kg, nt, chunk) computes the [9 taps x CS
// channels] x [BNO] tile of dW[k][co] = sum over rows m of x[m + tap
// offset][ci] * dy_eff[m][co] (k = tap * Ci + ci, ci in [kg CS, kg CS + CS),
// co in [nt BNO, nt BNO + BNO), dy_eff in bf16) over the row tiles of its
// chunk, in order, on mma.sync m16n8k16 with fp32 accumulators: the
// product's M is 16 channels of one tap, its N 8 channels co, its K 16 rows
// m. A stage holds a row tile's halo of the block's CS channels and its
// dy_eff rows, and all nine taps' products come from that one stage: a
// warp's B fragments (its dy_eff channels, 16 rows) are loaded once an m16
// step and serve its nine k16 tiles, one a tap, and each A fragment serves
// its NI n8 tiles. So dy_eff passes through shared memory Ci / CS times and
// the halo once per channel tile (a depth tile of one tap, the first
// design, staged both again for every tap: 18 and 9 times at block 4).
// Both operands lie rows-first in shared memory (the halo [row][channel],
// the dy_eff rows [r][co]), the transpose of what mma takes, so their
// fragments come through ldmatrix.trans; each lane names the halo row of
// its position + the tap's offset (rowtab), so no im2col is formed. 8 warps
// as WK x WN x WR: WK = CS / 16 channel slices, WN groups of NI n8 tiles,
// WR groups that split each stage's m16 steps and add their tiles in group
// order at the end. A ring of DWT_STAGES stages (cp.async), one barrier a
// tile, one block an SM. Bank groups: halo position (a, b) (frame a,
// frequency b of the halo) lies in row a WP + b, its 16-byte chunks XORed
// by the key a FF + b. The 8 rows of one ldmatrix are 8 consecutive output
// rows at one tap, so their keys are 8 consecutive integers, across frame
// ends too. With WP = FF + 2 at CS = 32 (4 chunks a row: the bank group is
// 4 (row mod 2) + chunk, row = key mod 2) and FF + 4 at CS = 16 (2 chunks:
// 2 (row mod 4) + chunk, row = key mod 4), the key alone sets the group,
// and 8 consecutive keys give 8 groups. The dy_eff rows are consecutive
// (swz_rows). Each block writes its tile as the chunk's partial;
// dw_final_kernel adds the chunks in order (no atomics).
// ---------------------------------------------------------------------------

// element offset of 16-byte chunk c of a [rows][CG chunks] bf16 array, the
// chunk index XORed with the row (CG a power of two, or a multiple of 8):
// any 8 consecutive rows of one chunk lie in 8 bank groups
__device__ __forceinline__ int swz_rows(int row, int c, int CG) {
  const int sw = CG >= 8 ? (row & 7) : (row / (8 / CG)) & (CG - 1);
  return (row * CG + (c ^ sw)) * 8;
}

// element offset of 16-byte chunk c of halo row `row` (CG = 2 or 4 chunks a
// row), XORed by the position's key (see conv_dw_taps_kernel)
template <int CG>
__device__ __forceinline__ int swz_halo(int row, int key, int c) {
  const int sw = CG == 4 ? (key >> 1) & 3 : (key >> 2) & 1;
  return (row * CG + (c ^ sw)) * 8;
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// n / d for 0 <= n < 2^16 and 1 <= d < 2^16: with m = ceil(2^32 / d), n m /
// 2^32 is n / d plus less than 2^-16, which never reaches the next integer
struct FastDiv {
  unsigned long long m;
  __device__ explicit FastDiv(int d) : m(((1ull << 32) + d - 1) / (unsigned long long)d) {}
  __device__ __forceinline__ int operator()(int n) const {
    return (int)(((unsigned long long)n * m) >> 32);
  }
};

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 (Granlund and Montgomery's
// round-up multiplier): with s = ceil(log2 d) and M = 2^32 + m =
// ceil(2^(32 + s) / d), n / d = (n M / 2^32) >> s, where n M / 2^32 = n +
// umulhi(m, n) stays below 2^32
struct FastDiv32 {
  unsigned m;
  int s;
  __device__ explicit FastDiv32(int d) : s(0) {
    while ((1ll << s) < d) ++s;
    m = (unsigned)(((1ull << 32) * ((1ull << s) - (unsigned long long)d)) / (unsigned long long)d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi(m, (unsigned)n) + (unsigned)n) >> s);
  }
};

constexpr int DWT_STAGES = 3;
constexpr int DWT_MAX_ROWS = 512;

template <int WK, int WN, int NI, int WR>
__global__ void __launch_bounds__(256, 1) conv_dw_taps_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dye, float* __restrict__ part_w,
    int B, int T, int F, int Ci, int Co, int TT, int FF, int n_tiles, int tiles_per_chunk) {
  constexpr int CS = 16 * WK, CG = 2 * WK, BNO = 8 * WN * NI, CGD = BNO / 8;
  static_assert(WK * WN * WR == 8 && NI % 2 == 0 && (WK == 1 || WK == 2), "warp tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int2 rowtab[DWT_MAX_ROWS];  // (halo row, key) of row r at the centre tap
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  const int W = FF + 2, WP = FF + (CG == 4 ? 2 : 4);
  const int NH = (TT + 2) * WP, R = TT * FF, R16 = (R + 15) & ~15;
  const int STG = NH * CS + R16 * BNO;  // a stage: the halo rows, then the dy_eff rows
  const int K = 9 * Ci, cs0 = blockIdx.x * CS, n0 = blockIdx.y * BNO;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % WK, wn = warp / WK % WN, wr = warp / (WK * WN);
  const int tile0 = blockIdx.z * tiles_per_chunk;
  const int tile1 = min(n_tiles, tile0 + tiles_per_chunk);
  const FastDiv div_w(W), div_ff(FF);

  for (int r = tid; r < R16; r += 256) {  // padding rows (zero dy_eff): row 0's
    const int q = r < R ? r : 0;
    const int jt = q / FF;
    rowtab[r] = make_int2((jt + 1) * WP + q - jt * FF + 1, q + FF + 1);
  }
  const int arow = ((lane >> 4) << 3) + (lane & 7);        // A: rows m of matrix l / 8
  const int ach = 2 * wk + ((lane >> 3) & 1);               // A: its channel chunk
  const int brow = (((lane >> 3) & 1) << 3) + (lane & 7);  // B: rows m of matrix l / 8
  const int bch = wn * NI + (lane >> 4);                    // B: n8 tile of the pair

  auto stage = [&](int tile, int buf) {
    const RowTile rt = row_tile(tile, T, F, TT, FF);
    bf16* const H = sm + buf * STG;
    bf16* const D = H + NH * CS;
    const long long bt = (long long)rt.b * T;
    for (int i = tid; i < (TT + 2) * W * CG; i += 256) {
      const int pos = i / CG, c = i % CG;
      const int a = div_w(pos), b = pos - a * W;
      const int t = rt.t0 + a - 1, f = rt.f0 + b - 1;
      const bool ok = t >= 0 && t < T && f >= 0 && f < F;
      cp_async16(H + swz_halo<CG>(a * WP + b, a * FF + b, c),
                 ok ? x + ((bt + t) * F + f) * Ci + cs0 + c * 8 : x, ok);
    }
    for (int i = tid; i < R16 * CGD; i += 256) {
      const int r = i / CGD, c = i % CGD;
      const int jt = div_ff(r);
      const int t = rt.t0 + jt, f = rt.f0 + r - jt * FF;
      const bool ok = r < R && t < T && f < F && n0 + c * 8 < Co;
      cp_async16(D + swz_rows(r, c, CGD), ok ? dye + ((bt + t) * F + f) * Co + n0 + c * 8 : dye,
                 ok);
    }
    cp_async_commit();
  };

  float acc[9][NI][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tap][ni][e] = 0.f;

  // one commit group per tile, empty past the chunk's last tile, so that
  // waiting for all but DWT_STAGES - 2 groups means the current tile landed
  for (int st = 0; st < DWT_STAGES - 1; ++st) {
    if (tile0 + st < tile1) {
      stage(tile0 + st, st);
    } else {
      cp_async_commit();
    }
  }
  for (int tile = tile0; tile < tile1; ++tile) {
    const int buf = (tile - tile0) % DWT_STAGES;
    cp_async_wait<DWT_STAGES - 2>();
    __syncthreads();  // the tile landed for all; the previous buffer is free
    if (tile + DWT_STAGES - 1 < tile1) {
      stage(tile + DWT_STAGES - 1, (buf + DWT_STAGES - 1) % DWT_STAGES);
    } else {
      cp_async_commit();
    }
    const unsigned hs = (unsigned)__cvta_generic_to_shared(sm + buf * STG);
    const unsigned ds = hs + 2u * (unsigned)(NH * CS);
    for (int m0 = wr * 16; m0 < R16; m0 += 16 * WR) {
      uint32_t b[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ni += 2)
        ldsm_x4_t(ds + 2u * (unsigned)swz_rows(m0 + brow, bch + ni, CGD), b[ni][0], b[ni][1],
                  b[ni + 1][0], b[ni + 1][1]);
      const int2 rk = rowtab[m0 + arow];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3 - 1, df = tap % 3 - 1;
        uint32_t a[4];
        ldsm_x4_t(hs + 2u * (unsigned)swz_halo<CG>(rk.x + dt * WP + df, rk.y + dt * FF + df, ach),
                  a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[tap][ni], a, b[ni][0], b[ni][1]);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator e of (tap, ni): channel cs0 + 16 wk + gq + 8 (e / 2) of the
  // tap, column (wn NI + ni) 8 + 2 tq + e % 2 of the tile
  const int gq = lane >> 2, tq = lane & 3;
  if constexpr (WR > 1) {  // the row groups' tiles, added in group order
    float* const red = reinterpret_cast<float*>(smem_raw);  // [9 CS][BNO], the ring is free
    __syncthreads();
    for (int g = 0; g < WR; ++g) {
      if (wr == g) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* p = red + (tap * CS + 16 * wk + gq + 8 * (e >> 1)) * BNO +
                         (wn * NI + ni) * 8 + 2 * tq + (e & 1);
              if (g == 0) {
                *p = acc[tap][ni][e];
              } else if (g < WR - 1) {
                *p += acc[tap][ni][e];
              } else {
                acc[tap][ni][e] = *p + acc[tap][ni][e];
              }
            }
      }
      if (g < WR - 1) __syncthreads();
    }
  }
  if (wr != WR - 1) return;
  const long long chunk = blockIdx.z;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + (wn * NI + ni) * 8 + 2 * tq;
      if (n >= Co) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = tap * Ci + cs0 + 16 * wk + gq + 8 * h;
        *reinterpret_cast<float2*>(part_w + (chunk * K + k) * Co + n) =
            make_float2(acc[tap][ni][2 * h], acc[tap][ni][2 * h + 1]);
      }
    }
}

// dW and dbias partials for Ci = 1 (the first block: 9 taps of one input
// channel), bound by the bytes of y and dy, which it reads once: dy_eff is
// formed as they are read, a thread keeps 9 taps x 4 channels of dW and 4 of
// dbias in registers over rows rs, rs + RS, ... of its block's range, and the
// block adds its RS row slots in order. Launched with TX = float (row 3);
// the bf16 mode has its own kernel, conv_dw_c1_bf16_kernel below. Its TX =
// bf16 branches read x, y and dy as bf16, form dy_eff in fp32 without FMA
// (pallas_cnn.py:207), sum it unrounded into dbias (:211) and take its bf16
// rounding as the dW products' operand (:208).
constexpr int C1_VALS = 40;  // 9 * 4 + 4 sums a thread

template <typename TX>
__global__ void __launch_bounds__(256) conv_dw_c1_kernel(
    const TX* __restrict__ x, const TX* __restrict__ y, const TX* __restrict__ dy,
    const float* __restrict__ ds, const float* __restrict__ dq, float* __restrict__ part_w,
    float* __restrict__ part_b, int B, int T, int F, int Co, int rows_per_block) {
  constexpr bool F32 = std::is_same<TX, float>::value;
  __shared__ float red[256 * C1_VALS];
  const int G = (Co + 3) / 4;  // channel groups of 4
  const int RS = 256 / G;      // row slots
  const int tid = threadIdx.x, g = tid % G, rs = tid / G;
  const int M = B * T * F;     // rows fit in an int (the plan checks)
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(M, r0 + rows_per_block);
  float acc[9][4], bacc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bacc[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[tap][j] = 0.f;
  }
  if (rs < RS) {
    // unrolled so that several rows' loads are in flight at once: the loop
    // is otherwise bound by the latency of device memory
#pragma unroll 4
    for (int m = r0 + rs; m < r1; m += RS) {
      const int f = m % F, t = m / F % T;
      const long long mc = (long long)m * Co;
      float xv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3 - 1, df = tap % 3 - 1;
        const bool ok = t + dt >= 0 && t + dt < T && f + df >= 0 && f + df < F;
        xv[tap] = ok ? to_f(x[m + dt * F + df]) : 0.f;
      }
      float e[4];
      if (Co % 4 == 0) {
        const float4 a = ld4(dy + mc, 4 * g, Co);
        const float4 b = ld4(y + mc, 4 * g, Co);
        const float4 s = *reinterpret_cast<const float4*>(ds + f * Co + 4 * g);
        const float4 q = *reinterpret_cast<const float4*>(dq + f * Co + 4 * g);
        if constexpr (F32) {
          e[0] = a.x + s.x + 2.f * b.x * q.x;
          e[1] = a.y + s.y + 2.f * b.y * q.y;
          e[2] = a.z + s.z + 2.f * b.z * q.z;
          e[3] = a.w + s.w + 2.f * b.w * q.w;
        } else {
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
          const float sv[4] = {s.x, s.y, s.z, s.w}, qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            e[j] = __fadd_rn(__fadd_rn(av[j], sv[j]), __fmul_rn(__fmul_rn(2.f, bv[j]), qv[j]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * g + j;
          if constexpr (F32) {
            e[j] = c < Co ? dy[mc + c] + ds[f * Co + c] + 2.f * y[mc + c] * dq[f * Co + c] : 0.f;
          } else {
            e[j] = c < Co ? __fadd_rn(__fadd_rn(to_f(dy[mc + c]), ds[f * Co + c]),
                                      __fmul_rn(__fmul_rn(2.f, to_f(y[mc + c])), dq[f * Co + c]))
                          : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bacc[j] += e[j];
        const float ec = rnd<TX>(e[j]);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) acc[tap][j] = fmaf(xv[tap], ec, acc[tap][j]);
      }
    }
  }
  float* mine = red + tid * C1_VALS;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mine[36 + j] = bacc[j];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) mine[tap * 4 + j] = acc[tap][j];
  }
  __syncthreads();
  for (int e = tid; e < 10 * Co; e += 256) {
    const int tap = e / Co;  // 9: dbias
    const int c = e - tap * Co;
    const int v = (tap < 9 ? tap * 4 : 36) + c % 4;
    float s = 0.f;
    for (int r = 0; r < RS; ++r) s += red[(r * G + c / 4) * C1_VALS + v];
    if (tap < 9) {
      part_w[((long long)blockIdx.x * 9 + tap) * Co + c] = s;
    } else {
      part_b[(long long)blockIdx.x * Co + c] = s;
    }
  }
}

// dW and dbias partials in bf16 for Ci = 1 (the first block of the bf16
// train step): conv_dw_c1_bf16_kernel. Bound by the bytes of y and dy (bf16,
// 154 MB each at B = 60, against 9.6 MB of x); the fp32 kernel's design
// (conv_dw_c1_kernel: 4 channels a thread, 9 x taps a thread from device
// memory, 36 loads per x value) is bound by its instructions instead. Block
// i takes the rows of frames [i FPB, i FPB + FPB) (frame = b T + t) and
// first stages their x, with one frame more on each side, into shared memory
// [FPB + 2][F + 16] (x of frame j - 1 at column 8 + f, zeros at 7 and
// 8 + F, so the frequency taps need no test; a time tap across the clip's
// edge reads 0 by the row's t). Thread (slot s, group g) takes channels
// 8g .. 8g + 7 (16-byte loads of y and dy where Co % 8 == 0; 2 threads a row
// at Co = 16) of rows s, s + RS, ... of the block, forms dy_eff in fp32
// without FMA in pallas_cnn.py:207's order, adds it unrounded into dbias
// (:211), rounds it to bf16 as the product operand (:208) and keeps 9 x 8
// dW sums in registers; ds and dq are loaded again only where the row's
// frequency changes. The block adds its row slots in a fixed order: the
// lanes of a group by butterfly shuffles, then the 8 warps in order.
constexpr int C1B_THREADS = 256;

__global__ void __launch_bounds__(C1B_THREADS, 2) conv_dw_c1_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ y, const bf16* __restrict__ dy,
    const float* __restrict__ ds, const float* __restrict__ dq, float* __restrict__ part_w,
    float* __restrict__ part_b, int B, int T, int F, int Co, int FPB) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const xs = reinterpret_cast<bf16*>(smem_raw);
  const int FP = F + 16;  // the x tile's row pitch
  float* const red =      // [8 warps][10][8 GP]: the warps' sums (9 taps, dbias)
      reinterpret_cast<float*>(smem_raw + ((2 * (FPB + 2) * FP + 15) & ~15));
  const int G = (Co + 7) / 8;
  int GP = 1;  // threads a row, a power of two (the shuffles' lanes)
  while (GP < G) GP *= 2;
  const int RS = C1B_THREADS / GP;
  const int tid = threadIdx.x, g = tid & (GP - 1), rs = tid / GP, c0 = 8 * g;
  const int lane = tid & 31, warp = tid >> 5;
  const int NF = B * T;
  const int fr0 = blockIdx.x * FPB;
  const int nfr = min(NF, fr0 + FPB) - fr0;
  const bf16 zero = __float2bfloat16_rn(0.f);

  if ((F & 7) == 0) {  // 16-byte rows
    const int per = F / 8;
    for (int i = tid; i < (nfr + 2) * per; i += C1B_THREADS) {
      const int j = i / per, v = i - j * per;
      const int fr = fr0 - 1 + j;
      const uint4 val = fr >= 0 && fr < NF
                            ? __ldg(reinterpret_cast<const uint4*>(x + (long long)fr * F) + v)
                            : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(xs + j * FP + 8 + 8 * v) = val;
    }
  } else {
    for (int i = tid; i < (nfr + 2) * F; i += C1B_THREADS) {
      const int j = i / F, f = i - j * F;
      const int fr = fr0 - 1 + j;
      xs[j * FP + 8 + f] = fr >= 0 && fr < NF ? x[(long long)fr * F + f] : zero;
    }
  }
  for (int j = tid; j < nfr + 2; j += C1B_THREADS) {
    xs[j * FP + 7] = zero;
    xs[j * FP + 8 + F] = zero;
  }
  __syncthreads();

  float acc[9][8], bacc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    bacc[k] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[tap][k] = 0.f;
  }
  if (g < G) {
    // row i of the block is frame j = i / F (time t), frequency f = i % F,
    // stepped by RS rows without a division
    const int dj = RS / F, dfr = RS - dj * F, djt = dj % T;
    int j = rs / F, f = rs - j * F, t = (fr0 + j) % T, fs = -1;
    float sv[8], qv[8];
#pragma unroll 2
    for (int i = rs; i < nfr * F; i += RS) {
      if (f != fs) {  // this row's ds, dq
        fs = f;
        const int l0 = f * Co + c0;
        if ((Co & 7) == 0) {
          const float4 s0 = __ldg(reinterpret_cast<const float4*>(ds + l0));
          const float4 s1 = __ldg(reinterpret_cast<const float4*>(ds + l0) + 1);
          const float4 q0 = __ldg(reinterpret_cast<const float4*>(dq + l0));
          const float4 q1 = __ldg(reinterpret_cast<const float4*>(dq + l0) + 1);
          sv[0] = s0.x, sv[1] = s0.y, sv[2] = s0.z, sv[3] = s0.w;
          sv[4] = s1.x, sv[5] = s1.y, sv[6] = s1.z, sv[7] = s1.w;
          qv[0] = q0.x, qv[1] = q0.y, qv[2] = q0.z, qv[3] = q0.w;
          qv[4] = q1.x, qv[5] = q1.y, qv[6] = q1.z, qv[7] = q1.w;
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            sv[k] = c0 + k < Co ? __ldg(ds + l0 + k) : 0.f;
            qv[k] = c0 + k < Co ? __ldg(dq + l0 + k) : 0.f;
          }
        }
      }
      const long long e0 = ((long long)(fr0 + j) * F + f) * Co + c0;
      float a[8], b[8];
      if ((Co & 7) == 0) {
        const uint4 ua = __ldg(reinterpret_cast<const uint4*>(dy + e0));
        const uint4 ub = __ldg(reinterpret_cast<const uint4*>(y + e0));
        const uint32_t wa[4] = {ua.x, ua.y, ua.z, ua.w}, wb[4] = {ub.x, ub.y, ub.z, ub.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[2 * k] = bf_lo(wa[k]);
          a[2 * k + 1] = bf_hi(wa[k]);
          b[2 * k] = bf_lo(wb[k]);
          b[2 * k + 1] = bf_hi(wb[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          a[k] = c0 + k < Co ? to_f(dy[e0 + k]) : 0.f;
          b[k] = c0 + k < Co ? to_f(y[e0 + k]) : 0.f;
        }
      }
      const bf16* xr = xs + (j + 1) * FP + 8 + f;  // x of (t, f)
      float xv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dt = tap / 3 - 1, df = tap % 3 - 1;
        const bool ok = dt == 0 || (dt < 0 ? t > 0 : t < T - 1);
        xv[tap] = ok ? to_f(xr[dt * FP + df]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float e = __fadd_rn(__fadd_rn(a[k], sv[k]), __fmul_rn(__fmul_rn(2.f, b[k]), qv[k]));
        bacc[k] += e;
        const float ec = rnd<bf16>(e);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) acc[tap][k] = fmaf(xv[tap], ec, acc[tap][k]);
      }
      f += dfr;
      j += dj;
      t += djt;
      if (f >= F) {
        f -= F;
        ++j;
        ++t;
      }
      if (t >= T) t -= T;
    }
  }
  // the lanes of one group (lane % GP), then the warps, in a fixed order
  for (int off = GP; off < 32; off *= 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      bacc[k] += __shfl_xor_sync(0xffffffffu, bacc[k], off);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        acc[tap][k] += __shfl_xor_sync(0xffffffffu, acc[tap][k], off);
    }
  }
  const int NC = 8 * GP;
  if (lane < GP) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      red[(warp * 10 + 9) * NC + c0 + k] = bacc[k];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) red[(warp * 10 + tap) * NC + c0 + k] = acc[tap][k];
    }
  }
  __syncthreads();
  for (int e = tid; e < 10 * Co; e += C1B_THREADS) {
    const int v = e / Co, c = e - v * Co;  // v = 9: dbias
    float s = 0.f;
    for (int w = 0; w < C1B_THREADS / 32; ++w) s += red[(w * 10 + v) * NC + c];
    if (v < 9) {
      part_w[((long long)blockIdx.x * 9 + v) * Co + c] = s;
    } else {
      part_b[(long long)blockIdx.x * Co + c] = s;
    }
  }
}

// dW[e] and dbias[c]: the partials added in order (n_w chunks of dW, n_b
// rows of dbias), each total rounded once to the output type (bf16:
// pallas_cnn.py:473-474).
template <typename TO>
__global__ void dw_final_kernel(const float* __restrict__ part_w,
                                const float* __restrict__ part_b, TO* __restrict__ dw,
                                TO* __restrict__ db, int KC, int Co, int n_w, int n_b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < KC) {
    float a = 0.f;
    for (int c = 0; c < n_w; ++c) a += part_w[(long long)c * KC + e];
    dw[e] = from_f<TO>(a);
  }
  if (e < Co) {
    float b = 0.f;
    for (int c = 0; c < n_b; ++c) b += part_b[(long long)c * Co + e];
    db[e] = from_f<TO>(b);
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The shared-memory attribute of a kernel, set once per kernel and size:
// `done` is the kernel's own static, the largest size set so far.
template <typename Kernel>
cudaError_t ensure_smem(Kernel kernel, int bytes, int& done) {
  if (bytes <= done) return cudaSuccess;
  const cudaError_t err = set_smem(kernel, bytes);
  if (err == cudaSuccess) done = bytes;
  return err;
}

template <int BN, int VEC>
cudaError_t launch_dx(const float* dye, const float* wt, float* dx, int B, int T, int F,
                      int Co, int Ci, int TT, int FF, int smem, cudaStream_t s) {
  static int smem_set[2] = {0, 0};  // the two kernels' attributes, set once per size
  const bool seg = BN >= 64 && FF % 8 == 0;
  auto kernel = seg ? conv3x3_kernel<BN, VEC, true, false> : conv3x3_kernel<BN, VEC, false, false>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set[seg]);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((T + TT - 1) / TT) * ((F + FF - 1) / FF);
  dim3 grid((unsigned)tiles, (unsigned)((Ci + BN - 1) / BN));
  kernel<<<grid, 256, smem, s>>>(dye, wt, dx, nullptr, nullptr, nullptr, B, T, F, Co, Ci, TT,
                                 FF);
  return cudaGetLastError();
}

// conv_bn_stats' conv: conv3x3_kernel with the STATS epilogue
template <int BN, int VEC, bool SEG>
cudaError_t launch_fwd(const float* x, const float* w, const float* bias, float* y,
                       float* part_s, float* part_q, int B, int T, int F, int Ci, int Co,
                       int TT, int FF, int smem, cudaStream_t s) {
  static int smem_set = 0;
  auto kernel = conv3x3_kernel<BN, VEC, SEG, true>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((T + TT - 1) / TT) * ((F + FF - 1) / FF);
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, 256, smem, s>>>(x, w, y, bias, part_s, part_q, B, T, F, Ci, Co, TT, FF);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_fwd_bn(int BN, bool seg, const float* x, const float* w, const float* bias,
                          float* y, float* part_s, float* part_q, int B, int T, int F, int Ci,
                          int Co, int TT, int FF, int smem, cudaStream_t s) {
#define FWD_ARGS x, w, bias, y, part_s, part_q, B, T, F, Ci, Co, TT, FF, smem, s
  switch (BN) {  // SEG only where BN >= 64 (the plan's rule)
    case 8: return launch_fwd<8, VEC, false>(FWD_ARGS);
    case 16: return launch_fwd<16, VEC, false>(FWD_ARGS);
    case 32: return launch_fwd<32, VEC, false>(FWD_ARGS);
    case 64: return seg ? launch_fwd<64, VEC, true>(FWD_ARGS) : launch_fwd<64, VEC, false>(FWD_ARGS);
    case 128: return seg ? launch_fwd<128, VEC, true>(FWD_ARGS) : launch_fwd<128, VEC, false>(FWD_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FWD_ARGS
}

template <int VEC>
cudaError_t launch_dx_bn(int BN, const float* dye, const float* wt, float* dx, int B, int T,
                         int F, int Co, int Ci, int TT, int FF, int smem, cudaStream_t s) {
  switch (BN) {
    case 8: return launch_dx<8, VEC>(dye, wt, dx, B, T, F, Co, Ci, TT, FF, smem, s);
    case 16: return launch_dx<16, VEC>(dye, wt, dx, B, T, F, Co, Ci, TT, FF, smem, s);
    case 32: return launch_dx<32, VEC>(dye, wt, dx, B, T, F, Co, Ci, TT, FF, smem, s);
    case 64: return launch_dx<64, VEC>(dye, wt, dx, B, T, F, Co, Ci, TT, FF, smem, s);
    case 128: return launch_dx<128, VEC>(dye, wt, dx, B, T, F, Co, Ci, TT, FF, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int TN, int NTY, int NTX, int VEC, typename TX>
cudaError_t launch_dw(const TX* x, const TX* dye, float* part_w, float* part_b, int B,
                      int T, int F, int Ci, int Co, int TT, int FF, int n_tiles, int tpc,
                      int chunks, int smem, cudaStream_t s) {
  static int smem_set = 0;
  auto kernel = conv_dw_kernel<TN, NTY, NTX, VEC, TX>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((9 * Ci + 8 * NTY - 1) / (8 * NTY), (Co + NTX * TN - 1) / (NTX * TN), chunks);
  kernel<<<grid, 256, smem, s>>>(x, dye, part_w, part_b, B, T, F, Ci, Co, TT, FF, n_tiles, tpc);
  return cudaGetLastError();
}

// The dW tile [BKO x BNO] picks the thread grid: NTY = BKO / 8 depth rows of
// threads; BNO of 16 or 32 channels in 4-wide, 64 or 128 in 8-wide thread tiles.
template <int NTY, int VEC, typename TX>
cudaError_t launch_dw_n(int BNO, const TX* x, const TX* dye, float* part_w,
                        float* part_b, int B, int T, int F, int Ci, int Co, int TT, int FF,
                        int n_tiles, int tpc, int chunks, int smem, cudaStream_t s) {
#define DW_ARGS x, dye, part_w, part_b, B, T, F, Ci, Co, TT, FF, n_tiles, tpc, chunks, smem, s
  switch (BNO) {
    case 16: return launch_dw<4, NTY, 4, VEC, TX>(DW_ARGS);
    case 32: return launch_dw<4, NTY, 8, VEC, TX>(DW_ARGS);
    case 64: return launch_dw<8, NTY, 8, VEC, TX>(DW_ARGS);
    case 128: return launch_dw<8, NTY, 16, VEC, TX>(DW_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

template <int VEC, typename TX>
cudaError_t launch_dw_any(int BKO, int BNO, const TX* x, const TX* dye, float* part_w,
                          float* part_b, int B, int T, int F, int Ci, int Co, int TT, int FF,
                          int n_tiles, int tpc, int chunks, int smem, cudaStream_t s) {
  switch (BKO) {
    case 16: return launch_dw_n<2, VEC, TX>(BNO, DW_ARGS);
    case 32: return launch_dw_n<4, VEC, TX>(BNO, DW_ARGS);
    case 64: return launch_dw_n<8, VEC, TX>(BNO, DW_ARGS);
    case 128: return launch_dw_n<16, VEC, TX>(BNO, DW_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DW_ARGS
}

// ---------------------------------------------------------------------------
// glu_drop_pool_bwd. 512 threads; block i walks tiles i*tpb .. of P
// positions (rows m of y, P * CP <= 8192), CP = Co padded to 4 (or 8) with
// zero weights. Per tile:
//   A  BN(y) into yt[c][p] and the unpooled, dropout-masked gradient gu (in
//      registers), each product thread 4 positions x 4 channels;
//   B  lin = ybn Wg + bg (float4 of yt and of a Wg row per depth step),
//      dlin = gu s into dt[c][p], and gu lin s (1 - s) kept in registers;
//   E1 the lane sums of dlin, one owner thread per lane (f, c), adding the
//      tile's positions of its lane in order;
//   C  dWg += ybn^T dlin over the tile's positions: a thread owns 4 x CT
//      entries (rows wk + nk i, columns wc + nc j), PG groups of threads
//      split the positions (small Co);
//   D  dybn = dlin Wg^T + gu lin s (1 - s) (float4 of dt and of a Wg^T row),
//      dy = dybn * scale; dybn replaces ybn in yt, dybn * y dlin in dt;
//   E2 the lane sums of dybn * y and dybn, as E1.
// Partials: lanes and dWg per block (the PG groups' dWg added in group
// order first); two small passes add the blocks' in block order.
// smem: Wg [Co][CP] | Wg^T [Co][CP] | yt [CP][P+4] | dt [CP][P+4] | lanes [3][F*Co].
// Where the F*Co lane sums do not fit in shared memory (`lanes` 0), the
// block keeps them in its own partial row of part_l in device memory, each
// lane added to by one thread a tile, in tile order. WIDE (Co > 128: the
// dWg tiles outnumber the threads, and Wg and Wg^T do not fit whole): B and
// D stage slices of KS rows of Wg and of Wg^T (passed transposed as wgt)
// into one buffer in turn, and C runs `passes` passes over the dWg
// entries, each thread adding the tile's positions into its entries of the
// block's partial in part_w (read and written back a tile: the same thread,
// in tile order). smem WIDE: slice [KS][CP] | yt | dt | lanes.
// TY = bf16 (the bf16 mode, pallas_cnn.py:295-357 with bf16 refs): y, g,
// Wg and bg read as bf16 and held in fp32; A forms BN(y) as a multiply, then
// an add (no FMA, as the JAX kernel's separate ops), puts its bf16 rounding
// in yt (lin's operand and dWg's left operand, :312, :347) and the unrounded
// value in dt, whose sigmoid B takes before it writes dlin there (:314).
// dlin stays fp32 in both of its products (:341-350 are fp32 x bf16
// dots, the fp32 operand kept), so they stay on the CUDA cores; dy is
// rounded to bf16 (:354), the lane sums and dWg stay fp32 partials.
// glu_bwd_frag_kernel<NI> (bf16, Co = 8 NI = 16 .. 128; glu_bwd_plan's
// frag): A and B from two cp.async stages of the raw y and bits of a tile
// on mma.sync (the body's FRAG branch), then C, D, E1 and E2 as above, D
// reading Wg^T in bf16 and y from the stage. smem: Wg^T [Co][Co + 8] bf16
// | yt | dt | t2 [Co][P + 4] | y stages [2][P][Co + 8] bf16 | bits stages
// [2][P][Co + 16] | lanes [3][F*Co] (ops/fused_cnn.py glu_bwd_frag_smem).
// ---------------------------------------------------------------------------

constexpr int GLU_THREADS = 512;

// BN(y) of the two bf16 values of u with (s_k, s_k+1, b_k, b_k+1): the fp32
// values into lo, hi, their bf16 rounding back into u
__device__ __forceinline__ void bn_pair(uint32_t& u, float4 sb, float& lo, float& hi) {
  lo = __fadd_rn(__fmul_rn(bf_lo(u), sb.x), sb.z);
  hi = __fadd_rn(__fmul_rn(bf_hi(u), sb.y), sb.w);
  u = bf_pack(lo, hi);
}

#define GLU_BWD_PARAMS(TY)                                                                    \
  const TY *__restrict__ y, const float *__restrict__ scale_f,                                \
      const float *__restrict__ bias_f, const TY *__restrict__ wg,                            \
      const TY *__restrict__ wgt, const TY *__restrict__ bg, const uint8_t *__restrict__ bits, \
      const TY *__restrict__ g, TY *__restrict__ dy, float *__restrict__ part_l,              \
      float *__restrict__ part_w, int B, int T, int F, int Co, int pt, int pf,                \
      int keep_thresh, float inv_keep, int CP, int P, int PG, int n_tiles,                    \
      int tiles_per_block, int KS, int lanes_smem, int passes
#define GLU_BWD_ARGS                                                                          \
  y, scale_f, bias_f, wg, wgt, bg, bits, g, dy, part_l, part_w, B, T, F, Co, pt, pf,          \
      keep_thresh, inv_keep, CP, P, PG, n_tiles, tiles_per_block, KS, lanes_smem, passes

// The body of glu_bwd_kernel (NI = 0) and of glu_bwd_frag_kernel (NI > 0,
// bf16, Co = 8 NI: phases A and B on the tensor cores, see below).
template <int CT, bool WIDE, typename TY, int NI>
__device__ __forceinline__ void glu_bwd_body(GLU_BWD_PARAMS(TY)) {
  constexpr bool BF = std::is_same<TY, bf16>::value;
  constexpr bool FRAG = NI > 0;
  // FRAG: the bf16 rows of Wg^T and of the y stage, and the byte rows of the bits stage
  constexpr int YP = 8 * NI + 8, BP = 8 * NI + 16;
  extern __shared__ __align__(16) float smem[];
  const int L = F * Co;
  const int PS = P + 4;
  float* wg_s = smem;                          // [k][c] (WIDE: the slice [KS][CP])
  float* wgT_s = WIDE ? smem : wg_s + Co * CP;  // [c][k]
  bf16* const wgTb = reinterpret_cast<bf16*>(smem);  // FRAG: Wg^T [Co][YP] bf16
  float* yt = WIDE ? smem + KS * CP : FRAG ? reinterpret_cast<float*>(wgTb + Co * YP)
                                           : wgT_s + Co * CP;  // [c][p]: BN(y), then dybn
  float* dt = yt + CP * PS;                    // [c][p]: dlin
  float* t2s = dt + CP * PS;                   // FRAG: [c][p] gu lin s (1 - s)
  bf16* const ystage = reinterpret_cast<bf16*>(t2s + CP * PS);  // FRAG: [2][P][YP] raw y
  uint8_t* const bstage = reinterpret_cast<uint8_t*>(ystage + 2 * P * YP);  // FRAG: [2][P][BP]
  float* lane_s = lanes_smem ? (FRAG ? reinterpret_cast<float*>(bstage + 2 * P * BP) : dt + CP * PS)
                             : part_l + (long long)blockIdx.x * 3 * L;  // [3][L]
  const int tid = threadIdx.x;
  const int CG = CP / 4;
  const bool prod = tid < CG * (P / 4);
  // product thread (cg, pg): channels cg*4.., positions pg*4... Where the
  // shape allows, a warp holds 8 channel groups x 4 position groups, so its
  // float4 reads of a Wg row and of a yt column span 128 and 64 bytes (one
  // shared-memory wavefront each, not four and one)
  const bool w8 = CG % 8 == 0 && (P / 4) % 4 == 0;
  const int cg = w8 ? (tid / 32) % (CG / 8) * 8 + tid % 8 : tid % CG;
  const int pg = w8 ? (tid / 32) / (CG / 8) * 4 + (tid % 32) / 8 : tid / CG;
  const int nk = CP / 4, nc = CP / CT, NW = nk * nc;
  const bool wthr = tid < NW * PG;
  const int wc = tid % nc, wk = (tid / nc) % nk, wp = tid / NW;
  const int pr = P / PG;  // positions of a dWg group
  const int Ptot = B * T * F;  // positions fit in an int (the wrapper checks)
  const int To = T / pt, Fo = F / pf;
  const float inv_w = 1.f / (float)(pt * pf);
  const int nl = min(P, F) * Co;  // the lanes a tile touches: its first min(P, F) frequencies

  // FRAG: the rows of tile `tile`, y and (where given) the bits, into stage
  // `sb` (zeros past the last row), 16-byte copies, one commit group
  auto stage_tile = [&](int tile, int sb) {
    const int m0 = tile * P;
    bf16* const ys = ystage + sb * P * YP;
    for (int q = tid; q < P * NI; q += GLU_THREADS) {
      const int r = q / NI, c = (q - r * NI) * 8;
      const bool ok = m0 + r < Ptot;
      cp_async16(ys + r * YP + c, y + (long long)(ok ? m0 + r : 0) * Co + c, ok);
    }
    if (bits != nullptr) {
      uint8_t* const bs = bstage + sb * P * BP;
      constexpr int NB = NI > 1 ? NI / 2 : 1;  // 16-byte chunks of a row of bits
      for (int q = tid; q < P * NB; q += GLU_THREADS) {
        const int r = q / NB, c = (q - r * NB) * 16;
        const bool ok = m0 + r < Ptot;
        cp_async16(bs + r * BP + c, bits + (long long)(ok ? m0 + r : 0) * Co + c, ok);
      }
    }
    cp_async_commit();
  };
  if constexpr (FRAG) {  // Wg^T [n][k] in bf16: mma.sync's B fragments and D's rows
    for (int i = tid; i < Co * Co; i += GLU_THREADS) {
      const int r = i / Co;
      wgTb[r * YP + i - r * Co] = wg[(i - r * Co) * Co + r];
    }
  } else if constexpr (!WIDE) {
    for (int i = tid; i < Co * CP; i += GLU_THREADS) {
      const int r = i / CP;
      const int c = i - r * CP;
      wg_s[i] = c < Co ? to_f(wg[r * Co + c]) : 0.f;
      wgT_s[i] = c < Co ? to_f(wg[c * Co + r]) : 0.f;
    }
  }
  // rows k0 .. k0 + KS of `src` [Co][Co] into the slice buffer [KS][CP], zeros past Co
  auto stage_rows = [&](const TY* __restrict__ src, int k0) {
    const int per = CP / 4;
    for (int i = tid; i < KS * per; i += GLU_THREADS) {
      const int k = i / per, c = (i - k * per) * 4;
      *reinterpret_cast<float4*>(wg_s + k * CP + c) =
          k0 + k < Co ? ld4(src + (long long)(k0 + k) * Co, c, Co)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // acc[i][j] += a[p + i][k] w[k][c + j] over the depth rows [k0, k0 + kn);
  // w fp32 with rows of CP, or (FRAG) bf16 with rows of YP
  auto product = [&](float (&acc)[4][4], const float* __restrict__ a, const auto* w,
                     int k0, int kn) {
    const int wp = std::is_same<decltype(w), const bf16*>::value ? YP : CP;
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(a + (k0 + k) * PS + pg * 4);
      const float4 wv4 = lds4(w + k * wp + cg * 4);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w}, wv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  };
  for (int i = tid; i < 3 * L; i += GLU_THREADS) lane_s[i] = 0.f;
  float accw[4][CT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) accw[i][j] = 0.f;

  const bool has_g = To > 0 && Fo > 0;  // else g is empty and every gradient is 0
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(n_tiles, tile0 + tiles_per_block);
  // FRAG: a position's (b, t, f) and pooled indices without 32-bit divisions
  const FastDiv32 div_f(FRAG ? F : 1), div_t(FRAG ? T : 1), div_pt(FRAG ? pt : 1),
      div_pf(FRAG ? pf : 1);
  if constexpr (FRAG) {
    if (tile0 < tile1) stage_tile(tile0, 0);
  }
  for (int tile = tile0; tile < tile1; ++tile) {
    const int m0 = tile * P;
    const int f_first = m0 % F;
    float gu[4][4], t2[4][4];
    const int sb = (tile - tile0) & 1;  // FRAG: this tile's stage
    if constexpr (FRAG) {
      // A + B on the tensor cores. Unit u of the tile (warp w takes u = w,
      // w + 16): m16 tile mt = u / NG (rows 16 mt .., positions m0 + ..) at
      // WN n8 tiles from channel n0. Its lane (gq, tq) holds rows gq and
      // gq + 8 and, per n8 tile, channels 2 tq and 2 tq + 1. Per k16 step the
      // unit ldmatrix'es the A fragment of its rows from the stage, forms
      // BN(y) per element (a multiply, then an add; rounded into A,
      // pallas_cnn.py:312), keeps the fp32 values of its own k16 steps (n0 /
      // 16 ..) as the gates of its accumulators (:314) and runs mma.sync
      // against B fragments ldmatrix'ed from Wg^T; lin = A Wg + bg. Then per
      // accumulator: gu from pooled g, dropout from the staged bits, dlin =
      // gu s and gu lin s (1 - s), stored with bf16(BN(y)) into yt, dt and
      // t2s in [c][p] (0 past the last row). Two units a warp (Co = 16):
      // their loads of g are issued before the barrier that waits for the
      // stage.
      constexpr int WN = NI < 4 ? NI : 4, NG = NI / WN, MU = NI == 2 ? 2 : 1, KT = NI / 2;
      const int lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
      const int units = P / 16 * NG;
      bool ok[MU][2], pooled[MU][2];
      int fr[MU][2];
      uint32_t gw[MU][2][WN];  // g as bf16 pairs
      auto load_g = [&]() {
#pragma unroll
        for (int uu = 0; uu < MU; ++uu) {
          const int u = warp + uu * (GLU_THREADS / 32);
          const int mt = u / NG, n0 = (u - mt * NG) * WN * 8;
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows gq + 8 h: (b, t, f)
            const int m = m0 + 16 * mt + gq + 8 * h;
            ok[uu][h] = u < units && m < Ptot;
            const int mm = ok[uu][h] ? m : 0;
            const int q = div_f(mm), f = mm - q * F, b = div_t(q), t = q - b * T;
            pooled[uu][h] = ok[uu][h] && t < To * pt && f < Fo * pf;
            fr[uu][h] = f * Co;
            const long long gi =
                pooled[uu][h] ? ((long long)(b * To + div_pt(t)) * Fo + div_pf(f)) * Co : 0;
#pragma unroll
            for (int ni = 0; ni < WN; ++ni)
              gw[uu][h][ni] = pooled[uu][h]
                  ? __ldg(reinterpret_cast<const uint32_t*>(g + gi + n0 + ni * 8 + 2 * tq)) : 0u;
          }
        }
      };
      if constexpr (MU > 1) load_g();  // two units a warp: both units' loads in flight
      cp_async_wait<0>();
      __syncthreads();  // the tile's stage landed; the previous tile's lane pass and D done
      if (tile + 1 < tile1) stage_tile(tile + 1, sb ^ 1);  // the stage tile - 1 read
      if constexpr (MU == 1) load_g();
      const unsigned ys_s = (unsigned)__cvta_generic_to_shared(ystage + sb * P * YP);
      const unsigned wb_s = (unsigned)__cvta_generic_to_shared(wgTb);
      const uint8_t* const bst = bstage + sb * P * BP;
      // ldmatrix rows: A, row lane & 15 of the m16 tile at k chunk lane >> 4;
      // B, row (lane >> 4) 8 + (lane & 7) of Wg^T (channel n) at k chunk (lane >> 3) & 1
      const int a_off = (lane & 15) * YP + (lane >> 4) * 8;
      const int b_off = ((lane >> 4) * 8 + (lane & 7)) * YP + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int uu = 0; uu < MU; ++uu) {
        const int u = warp + uu * (GLU_THREADS / 32);
        if (u >= units) continue;
        const int mt = u / NG, n0 = (u - mt * NG) * WN * 8;
        float acc[WN][4], gv[WN / 2][8];
#pragma unroll
        for (int ni = 0; ni < WN; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KT; ++ks) {
          uint32_t a[4];
          ldsm_x4(ys_s + 2u * (unsigned)(16 * mt * YP + ks * 16 + a_off), a[0], a[1], a[2], a[3]);
          float v[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // register r: row gq + 8 (r & 1), channels + 8 (r >> 1)
            const int l = fr[uu][r & 1] + ks * 16 + 8 * (r >> 1) + 2 * tq;
            const float2 sc = __ldg(reinterpret_cast<const float2*>(scale_f + l));
            const float2 bi = __ldg(reinterpret_cast<const float2*>(bias_f + l));
            bn_pair(a[r], make_float4(sc.x, sc.y, bi.x, bi.y), v[2 * r], v[2 * r + 1]);
          }
          if (ks / (WN / 2) == n0 / (8 * WN)) {  // the unit's own k16 steps: the gates
#pragma unroll
            for (int e = 0; e < 8; ++e) gv[ks % (WN / 2)][e] = v[e];
          }
#pragma unroll
          for (int ni = 0; ni < WN; ni += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(wb_s + 2u * (unsigned)((n0 + ni * 8) * YP + ks * 16 + b_off), b0, b1, b2, b3);
            mma_bf16(acc[ni], a, b0, b1);
            mma_bf16(acc[ni + 1], a, b2, b3);
          }
        }
        // accumulator e of n8 tile ni: row gq + 8 (e >> 1), channel n0 + ni * 8
        // + 2 tq + (e & 1); its gate is gv[ni / 2][4 (ni % 2) + e]
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const int c = n0 + ni * 8 + 2 * tq;
          const float bg0 = to_f(bg[c]), bg1 = to_f(bg[c + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, p = 16 * mt + gq + 8 * h;
            const float gate = gv[ni >> 1][4 * (ni & 1) + e];
            const float s = sigmoidf(gate);
            const float lin = acc[ni][e] + ((e & 1) ? bg1 : bg0);
            const uint32_t gp = gw[uu][h][ni];
            float gj = pooled[uu][h] ? ((e & 1) ? bf_hi(gp) : bf_lo(gp)) * inv_w : 0.f;
            if (bits != nullptr)
              gj = (int)bst[p * BP + c + (e & 1)] < keep_thresh ? gj * inv_keep : 0.f;
            const int i = (c + (e & 1)) * PS + p;
            yt[i] = ok[uu][h] ? rnd<bf16>(gate) : 0.f;
            dt[i] = gj * s;
            t2s[i] = gj * lin * s * (1.f - s);
          }
        }
      }
    } else {
      __syncthreads();  // weights staged / the previous tile's lane pass done
      if (prod) {  // A: the loads from device memory issued before the first use
        float4 yq[4], gq[4];
        uint32_t kb[4];
        int fl[4];
        bool ok[4], pooled[4];
        int m = m0 + pg * 4;  // the position, and its (b, t, f), stepped along
        int f = m % F, t = (m / F) % T, b = m / F / T;
#pragma unroll
        for (int i = 0; i < 4; ++i, ++m) {
          if (i > 0 && ++f == F) {
            f = 0;
            if (++t == T) {
              t = 0;
              ++b;
            }
          }
          ok[i] = m < Ptot;
          const int mm = ok[i] ? m : 0;
          pooled[i] = ok[i] && t < To * pt && f < Fo * pf;
          const long long gi = pooled[i] ? ((long long)(b * To + t / pt) * Fo + f / pf) * Co : 0;
          fl[i] = f * Co;
          yq[i] = ld4(y + (long long)mm * Co, cg * 4, Co);
          gq[i] = has_g ? ld4(g + gi, cg * 4, Co) : make_float4(0.f, 0.f, 0.f, 0.f);
          kb[i] = bits != nullptr ? ld_bytes4(bits + (long long)mm * Co, cg * 4, Co) : 0u;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 sc = ld4(scale_f + fl[i], cg * 4, Co);  // small, cached
          const float4 bi = ld4(bias_f + fl[i], cg * 4, Co);
          const float yv[4] = {yq[i].x, yq[i].y, yq[i].z, yq[i].w};
          const float sv[4] = {sc.x, sc.y, sc.z, sc.w};
          const float bv[4] = {bi.x, bi.y, bi.z, bi.w};
          const float gv[4] = {gq[i].x, gq[i].y, gq[i].z, gq[i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // padded channels load zeros: v = 0, gu = 0
            float gj = pooled[i] ? gv[j] * inv_w : 0.f;
            if (bits != nullptr) gj = (int)((kb[i] >> (8 * j)) & 255u) < keep_thresh ? gj * inv_keep : 0.f;
            const int e = (cg * 4 + j) * PS + pg * 4 + i;
            if constexpr (BF) {
              const float v = ok[i] ? __fadd_rn(__fmul_rn(yv[j], sv[j]), bv[j]) : 0.f;
              yt[e] = rnd<bf16>(v);
              dt[e] = v;
            } else {
              yt[e] = ok[i] ? fmaf(yv[j], sv[j], bv[j]) : 0.f;
            }
            gu[i][j] = gj;
          }
        }
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if constexpr (WIDE) {  // B over slices of Wg
        for (int k0 = 0; k0 < Co; k0 += KS) {
          __syncthreads();  // the previous slice read
          stage_rows(wg, k0);
          __syncthreads();
          if (prod) product(acc, yt, wg_s, k0, min(KS, Co - k0));
        }
      } else if (prod) {
        product(acc, yt, wg_s, 0, Co);
      }
      if (prod) {  // B's epilogue
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg * 4 + j;
          const float bgc = c < Co ? to_f(bg[c]) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = sigmoidf(BF ? dt[c * PS + pg * 4 + i] : yt[c * PS + pg * 4 + i]);
            const float lin = acc[i][j] + bgc;
            dt[c * PS + pg * 4 + i] = gu[i][j] * s;
            t2[i][j] = gu[i][j] * lin * s * (1.f - s);
          }
        }
      }
    }
    __syncthreads();
    // E1: the lane sums of dlin, one owner thread per lane (f, c) of the
    // tile, the tile's positions of its lane in order (the tile's j-th
    // position from its first has frequency f_first + j, mod F)
    for (int e = tid; e < nl; e += GLU_THREADS) {
      const int j = e / Co;
      const int c = e - j * Co;
      const int f = f_first + j < F ? f_first + j : f_first + j - F;
      float s3 = 0.f;
      for (int p = j; p < P && m0 + p < Ptot; p += F) s3 += dt[c * PS + p];
      lane_s[2 * L + f * Co + c] += s3;
    }
    if constexpr (WIDE) {  // C in passes over the dWg entries, through part_w
      float* pw = part_w + (long long)blockIdx.x * Co * Co;
      for (int ps = 0; ps < passes; ++ps) {
        const int id = ps * GLU_THREADS + tid;
        if (id >= NW) break;
        const int wc2 = id % nc, wk2 = id / nc;
        float aw[4][CT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int k = wk2 + nk * i, c = wc2 + nc * j;
            aw[i][j] = tile > tile0 && k < Co && c < Co ? pw[k * Co + c] : 0.f;
          }
        for (int p = 0; p < P; p += 4) {
          float4 a[4], d[CT];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(yt + (wk2 + nk * i) * PS + p);
#pragma unroll
          for (int j = 0; j < CT; ++j) d[j] = *reinterpret_cast<const float4*>(dt + (wc2 + nc * j) * PS + p);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < CT; ++j) {
              float sw = aw[i][j];
              sw = fmaf(a[i].x, d[j].x, sw);
              sw = fmaf(a[i].y, d[j].y, sw);
              sw = fmaf(a[i].z, d[j].z, sw);
              aw[i][j] = fmaf(a[i].w, d[j].w, sw);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            const int k = wk2 + nk * i, c = wc2 + nc * j;
            if (k < Co && c < Co) pw[k * Co + c] = aw[i][j];
          }
      }
    } else if (wthr) {  // C
      for (int p = wp * pr; p < wp * pr + pr; p += 4) {
        float4 a[4], d[CT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(yt + (wk + nk * i) * PS + p);
#pragma unroll
        for (int j = 0; j < CT; ++j) d[j] = *reinterpret_cast<const float4*>(dt + (wc + nc * j) * PS + p);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) {
            float s = accw[i][j];
            s = fmaf(a[i].x, d[j].x, s);
            s = fmaf(a[i].y, d[j].y, s);
            s = fmaf(a[i].z, d[j].z, s);
            accw[i][j] = fmaf(a[i].w, d[j].w, s);
          }
      }
    }
    float acc2[4][4];
    float4 yq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
    if constexpr (WIDE) {  // D's product over slices of Wg^T (B's slice is read)
      for (int c0 = 0; c0 < Co; c0 += KS) {
        __syncthreads();
        stage_rows(wgt, c0);
        __syncthreads();
        if (prod) product(acc2, dt, wgT_s, c0, min(KS, Co - c0));
      }
    } else if constexpr (FRAG) {
      if (prod) product(acc2, dt, static_cast<const bf16*>(wgTb), 0, Co);
    } else if (prod) {
      product(acc2, dt, wgT_s, 0, Co);
    }
    if (prod) {  // D
      // y again (FRAG: from the stage; else from L2), for the lane sums of
      // dybn * y; loaded after the product, whose registers it would
      // otherwise crowd into spills
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (FRAG) {
          yq[i] = lds4(ystage + (sb * P + pg * 4 + i) * YP + cg * 4);
        } else {
          const int m = m0 + pg * 4 + i;
          yq[i] = ld4(y + (long long)(m < Ptot ? m : 0) * Co, cg * 4, Co);
        }
      }
    }
    __syncthreads();  // yt and dt are read no more
    if (prod) {  // dybn into yt, dybn * y into dt, dy = dybn * scale out
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = pg * 4 + i;
        const int m = m0 + p;
        const int f = m % F;
        const float yv[4] = {yq[i].x, yq[i].y, yq[i].z, yq[i].w};
        float o[4], sv[4];
        if constexpr (FRAG) {  // Co % 16 == 0: the scale of 4 channels in one load
          const float4 sc = ld4(scale_f + f * Co, cg * 4, Co);
          sv[0] = sc.x, sv[1] = sc.y, sv[2] = sc.z, sv[3] = sc.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = cg * 4 + j;
          float dybn;
          if constexpr (FRAG) {
            dybn = acc2[i][j] + t2s[k * PS + p];
            o[j] = dybn * sv[j];
          } else {
            dybn = acc2[i][j] + t2[i][j];
            o[j] = dybn * (k < Co ? scale_f[f * Co + k] : 0.f);
          }
          yt[k * PS + p] = dybn;
          dt[k * PS + p] = dybn * yv[j];
        }
        if (m < Ptot) st4(dy + (long long)m * Co, cg * 4, Co, o);
      }
    }
    __syncthreads();
    for (int e = tid; e < nl; e += GLU_THREADS) {  // E2: the lane sums of dybn * y and dybn
      const int j = e / Co;
      const int c = e - j * Co;
      const int f = f_first + j < F ? f_first + j : f_first + j - F;
      float s1 = 0.f, s2 = 0.f;
      for (int p = j; p < P && m0 + p < Ptot; p += F) {
        s1 += dt[c * PS + p];
        s2 += yt[c * PS + p];
      }
      lane_s[f * Co + c] += s1;
      lane_s[L + f * Co + c] += s2;
    }
  }
  __syncthreads();
  if (lanes_smem) {
    float* pl = part_l + (long long)blockIdx.x * 3 * L;
    for (int i = tid; i < 3 * L; i += GLU_THREADS) pl[i] = lane_s[i];
  }
  if constexpr (WIDE) return;  // dWg is in part_w already
  // the PG position groups' dWg, added in group order into the block's
  // partial (yt and dt, free now, hold PG * Co * Co <= 8192 floats)
  const int CC = Co * Co;
  if (wthr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = wk + nk * i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int c = wc + nc * j;
        if (k < Co && c < Co) yt[wp * CC + k * Co + c] = accw[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < CC; e += GLU_THREADS) {
    float a = 0.f;
    for (int q = 0; q < PG; ++q) a += yt[q * CC + e];
    part_w[(long long)blockIdx.x * CC + e] = a;
  }
}

template <int CT, bool WIDE, typename TY>
__global__ void __launch_bounds__(GLU_THREADS, 1) glu_bwd_kernel(GLU_BWD_PARAMS(TY)) {
  glu_bwd_body<CT, WIDE, TY, 0>(GLU_BWD_ARGS);
}

// bf16, Co = 8 NI (16, 32, 64 or 128): phases A and B from the staged y on
// mma.sync, then C, D, E1 and E2 as glu_bwd_kernel runs them
template <int NI>
__global__ void __launch_bounds__(GLU_THREADS, 1) glu_bwd_frag_kernel(GLU_BWD_PARAMS(bf16)) {
  glu_bwd_body<NI == 16 ? 8 : 4, false, bf16, NI>(GLU_BWD_ARGS);
}

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

// dWg[e] over the partials in order; dbg[c] over the F lanes of channel c in
// order; each total rounded once to the output type (bf16: pallas_cnn.py:666-667).
template <typename TO>
__global__ void glu_bwd_final_w(const float* __restrict__ part_l,
                                const float* __restrict__ part_w, TO* __restrict__ dwg,
                                TO* __restrict__ dbg, int F, int Co, int n_parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int CC = Co * Co;
  if (e < CC) {
    float a = 0.f;
    for (int i = 0; i < n_parts; ++i) a += part_w[(long long)i * CC + e];
    dwg[e] = from_f<TO>(a);
  }
  if (e < Co) {
    const float* lanes = part_l + 2 * (long long)F * Co;
    float a = 0.f;
    for (int f = 0; f < F; ++f) a += lanes[f * Co + e];
    dbg[e] = from_f<TO>(a);
  }
}

// ---------------------------------------------------------------------------
// glu_drop_pool. 256 threads; a tile is NQ pooled outputs (q0 = tile * NQ ..),
// its P positions ordered by pooled output, then window element:
// p = qq * W + wi, wi = dt * pf + df (positions past NQ * W idle). Block
// (x, y) takes output channels [n0, n0 + CT), n0 = y * CT, of tiles x,
// x + gridDim.x, ... Per tile:
//   A  BN(y) of all CP channels into yt[c][p], 4 positions x 4 channels an
//      item, the item's loads issued before the first is used;
//   B  lin = ybn Wg + bg over Wg slices of KS rows (staged once where
//      KS >= Co), a 4 x 4 register tile a thread: positions pg*4 + i,
//      channels n0 + cg*4 + j; (CT / 4) x (P / 4) = 256 threads;
//   C  GLU, dropout, and the pool: where W divides 4 the thread's positions
//      are 4 / W whole windows, added in registers; else the GLU values go
//      into yt and a window's W values are added there, in order.
// Each tile first writes, per pooled output, the row of y of its window's
// first element and that element's frequency into two small tables, so a
// position's row is a table read and an offset (positions count in 32-bit
// ints: the plan checks B*T*F < 2^31); where W divides 4 the offsets of a
// thread's 4 positions are the same on every tile and are computed once.
// smem: Wg slice [KS][CT] | yt [CP][P + 4], CP = max(Co padded to 4, CT) |
// rowq [NQ] | fq [NQ].
// ---------------------------------------------------------------------------
constexpr int GLU_FWD_THREADS = 256;

// WR: the window pt * pf where it divides 4 (the pool in registers), else 0.
template <int WR>
__global__ void __launch_bounds__(GLU_FWD_THREADS, 3) glu_fwd_kernel(
    const float* __restrict__ y, const float* __restrict__ scale_f,
    const float* __restrict__ bias_f, const float* __restrict__ wg,
    const float* __restrict__ bg, const uint8_t* __restrict__ bits, float* __restrict__ z,
    int B, int T, int F, int Co, int pt, int pf, int keep_thresh, float inv_keep, int CT,
    int P, int NQ, int KS, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int PS = P + 4;
  const int CP = max((Co + 3) & ~3, CT);  // yt's rows: the depth, or a tile of outputs
  float* const wg_s = smem;          // [KS][CT]: Wg rows k0 .., columns n0 ..
  float* const yt = smem + KS * CT;  // [CP][PS]
  int* const rowq = reinterpret_cast<int*>(yt + CP * PS);  // [NQ], -1 past the last
  int* const fq = rowq + NQ;                                // [NQ]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * CT;
  const int W = WR > 0 ? WR : pt * pf, To = T / pt, Fo = F / pf;
  const int Q = B * To * Fo;
  const int CG = CT / 4, NCP = CP / 4;
  // product thread (cg, pg); where the shape allows a warp holds 8 channel
  // groups x 4 position groups: its float4 reads of a Wg row and of a yt
  // row span 128 and 64 bytes, one shared-memory wavefront each
  const bool w8 = CG % 8 == 0 && (P / 4) % 4 == 0;
  const int cg = w8 ? (tid / 32) % (CG / 8) * 8 + tid % 8 : tid % CG;
  const int pg = w8 ? (tid / 32) / (CG / 8) * 4 + (tid % 32) / 8 : tid / CG;
  const int c0 = n0 + cg * 4;  // this thread's output channels c0 .. c0 + 3
  const bool whole = KS >= Co;
  const float inv_w = 1.f / (float)W;
  // WR > 0: position 4 s + i of a tile is window element i % WR
  int woff[4], wf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int wi = WR > 0 ? i % WR : 0;
    woff[i] = wi / pf * F + wi % pf;
    wf[i] = wi % pf;
  }
  // row of y of tile position 4 s + i (its frequency in f), or -1
  auto row_of = [&](int s4, int i, int& f) -> int {
    const int p = 4 * s4 + i;
    const int qq = p / W;
    const int base = qq < NQ ? rowq[qq] : -1;
    if (base < 0) return -1;
    if constexpr (WR > 0) {
      f = fq[qq] + wf[i];
      return base + woff[i];
    } else {
      const int wi = p - qq * W;
      f = fq[qq] + wi % pf;
      return base + wi / pf * F + wi % pf;
    }
  };

  auto stage_w = [&](int k0) {
    for (int i = tid; i < KS * CG; i += GLU_FWD_THREADS) {
      const int k = i / CG, c = (i - k * CG) * 4;
      *reinterpret_cast<float4*>(wg_s + k * CT + c) =
          k0 + k < Co ? ld4(wg + (long long)(k0 + k) * Co, n0 + c, Co)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (whole) stage_w(0);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = tile * NQ;
    __syncthreads();  // Wg staged / the previous tile's yt and tables read
    for (int qq = tid; qq < NQ; qq += GLU_FWD_THREADS) {
      const int q = q0 + qq;
      int base = -1, f0 = 0;
      if (q < Q) {
        const int fo = q % Fo, bt = q / Fo;
        f0 = fo * pf;
        base = ((bt / To) * T + (bt % To) * pt) * F + f0;
      }
      rowq[qq] = base;
      fq[qq] = f0;
    }
    __syncthreads();
    // A: channel groups fastest, so that neighbouring threads read one row
    for (int it = tid; it < NCP * (P / 4); it += GLU_FWD_THREADS) {
      const int sc = it % NCP, sp = it / NCP;
      int m[4], fm[4];
      float4 yq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fm[i] = 0;
        m[i] = row_of(sp, i, fm[i]);
        yq[i] = m[i] >= 0 ? ld4(y + (long long)m[i] * Co, sc * 4, Co)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float v[4][4];  // [channel][position]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lane = fm[i] * Co;
        const float4 s4 = ld4(scale_f + lane, sc * 4, Co);  // small, cached
        const float4 b4 = ld4(bias_f + lane, sc * 4, Co);
        const bool ok = m[i] >= 0;
        v[0][i] = ok ? fmaf(yq[i].x, s4.x, b4.x) : 0.f;
        v[1][i] = ok ? fmaf(yq[i].y, s4.y, b4.y) : 0.f;
        v[2][i] = ok ? fmaf(yq[i].z, s4.z, b4.z) : 0.f;
        v[3][i] = ok ? fmaf(yq[i].w, s4.w, b4.w) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(yt + (sc * 4 + j) * PS + sp * 4) =
            make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    }
    // the thread's dropout bits, in flight during the product
    uint32_t kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int f;
      const int mo = bits != nullptr ? row_of(pg, i, f) : -1;
      kb[i] = mo >= 0 ? ld_bytes4(bits + (long long)mo * Co, c0, Co) : 0u;
    }
    // B
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Co; k0 += KS) {
      if (!whole) {
        __syncthreads();  // the previous slice read
        stage_w(k0);
      }
      __syncthreads();  // yt (and the slice) staged
      const int kn = min(KS, Co - k0);
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(yt + (k0 + k) * PS + pg * 4);
        const float4 w = *reinterpret_cast<const float4*>(wg_s + k * CT + cg * 4);
        const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
    }
    // C: GLU and dropout in place of acc
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      const float bgc = c < Co ? bg[c] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ybn = c < Co ? yt[c * PS + pg * 4 + i] : 0.f;
        float g = (acc[i][j] + bgc) * sigmoidf(ybn);
        if (bits != nullptr) g = (int)((kb[i] >> (8 * j)) & 255u) < keep_thresh ? g * inv_keep : 0.f;
        acc[i][j] = g;
      }
    }
    if constexpr (WR > 0) {  // whole windows in registers
#pragma unroll
      for (int w0 = 0; w0 < 4; w0 += WR) {
        const int qq = (pg * 4 + w0) / WR;
        const int q = q0 + qq;
        if (qq >= NQ || q >= Q) continue;
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < WR; ++e) s += acc[w0 + e][j];
          o[j] = s * inv_w;
        }
        st4(z + (long long)q * Co, c0, Co, o);
      }
    } else {  // windows across threads: through yt, [CT][PS] at its start
      __syncthreads();  // every product read of yt done
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(yt + (cg * 4 + j) * PS + pg * 4) =
            make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      __syncthreads();
      for (int e = tid; e < NQ * CT; e += GLU_FWD_THREADS) {
        const int qq = e / CT, c = e - qq * CT;
        const int q = q0 + qq;
        if (q >= Q || n0 + c >= Co) continue;
        float s = 0.f;
        for (int wi = 0; wi < W; ++wi) s += yt[c * PS + qq * W + wi];
        z[(long long)q * Co + n0 + c] = s * inv_w;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// glu_drop_pool in bf16 on the tensor cores at the shapes that
// glu_fwd_frag_kernel does not take: whole-frame tiles through a ring of
// asynchronous copies. A tile is TT frames (a multiple of pt, below To*pt)
// x FF frequencies (a multiple of pf, below Fo*pf; FF = Fo*pf, whole frames,
// wherever they fit) of one clip, at all Co channels: TT runs of FF*Co
// consecutive elements of y and of the bits, one run where FF = F. Tiles are
// numbered f-tile fastest, then t-tile, then clip; block (x, y) takes output
// channels [n0, n0 + CT) of tiles x, x + gridDim.x, ... Shared memory:
//   Bs [CT][KP + 8] bf16   Wg^T of the channel tile, staged once
//   As [RM*16][KP + 8]     bf16(BN(y)) of the tile's rows, the product's
//                          operand (pallas_cnn.py:277); RM = rows / 16 up
//   gt [RM*16][CT + 8]     BN(y) in fp32 for the block's channels (the
//                          sigmoid's operand, :279), then the GLU over it
//   ring, S stages         the tile's raw y [rows][Co] bf16, then its bits
//                          [rows][Co] uint8, as they lie in device memory
// Row r of a tile is frame r / FF, frequency r % FF. Per tile:
//   wait for its stage (issued S - 1 tiles ago), sync, and issue the copies
//   of the tile S - 1 ahead into the stage the previous tile freed: 16-byte
//   cp.async of y and 8-byte cp.async of the bits (vec: F*Co and FF*Co
//   multiples of 8, so every run starts on 16 bytes; a run's last chunk
//   copies what is left and zero-fills the rest), else element loads (the
//   plain path; the plan chooses it from the shape);
//   A  BN(y) = y * scale + bias in fp32 (a multiply, then an add, each
//      rounded), 8 channels an item, into As (rounded) and gt (not); each
//      thread keeps the scale and bias of the last lane it read, which
//      stays its lane at every tile where FF*KP/8 divides the block;
//   B  lin = As Wg on mma.sync m16n8k16, fp32 accumulators: 8 warps as WM
//      row x WN column groups (NI n8 tiles a warp), a warp's MI m16 tiles
//      interleaved (tile wm + WM mi of each pass of WM MI tiles);
//   C  GLU = (lin + bg) sigmoid(BN(y)) over gt, each element by the thread
//      that holds its accumulator;
//   D  dropout from the staged bits, the window's sum in window order
//      wi = dt pf + df, times 1 / (pt pf), z rounded to bf16 once (:292), 8
//      channels (16 bytes of z) an item where Co % 8 == 0.
// Row strides of KP + 8 (bf16) and CT + 8 (fp32) keep ldmatrix's 8 rows in
// 8 distinct bank groups. No atomics, no sums across tiles.
// ---------------------------------------------------------------------------
constexpr int GLU_RING_THREADS = 256;

struct GluTile {
  int b, t0, f0, tv, fv;  // clip, first frame and frequency, valid frames and frequencies
};

__device__ __forceinline__ GluTile glu_tile(int i, int Ts, int Fs, int TT, int FF) {
  const int nf = (Fs + FF - 1) / FF, nt = (Ts + TT - 1) / TT;
  GluTile g;
  g.f0 = (i % nf) * FF;
  i /= nf;
  g.t0 = (i % nt) * TT;
  g.b = i / nt;
  g.tv = min(TT, Ts - g.t0);
  g.fv = min(FF, Fs - g.f0);
  return g;
}

// wait until at most n (0, 1 or 2) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 2) {
    cp_async_wait<2>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

template <int NI, int WN>
__global__ void __launch_bounds__(GLU_RING_THREADS, 2) glu_fwd_ring_kernel(
    const bf16* __restrict__ y, const float* __restrict__ scale_f,
    const float* __restrict__ bias_f, const bf16* __restrict__ wg, const bf16* __restrict__ bg,
    const uint8_t* __restrict__ bits, bf16* __restrict__ z, int T, int F, int Co, int pt, int pf,
    int keep_thresh, float inv_keep, int TT, int FF, int S, int vec, int KP, int n_tiles) {
  constexpr int CT = WN * NI * 8, WM = 8 / WN, MI = 8 / NI, GS = CT + 8, C8 = CT / 8;
  constexpr int NT = GLU_RING_THREADS;
  const int AS = KP + 8;
  const int rows = TT * FF, RM = (rows + 15) / 16;
  const int ybytes = (rows * Co * 2 + 15) & ~15, sbytes = ybytes + ((rows * Co + 15) & ~15);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Bs = reinterpret_cast<bf16*>(smem_raw);          // [CT][AS]
  bf16* const As = Bs + CT * AS;                               // [RM * 16][AS]
  float* const gt = reinterpret_cast<float*>(As + RM * 16 * AS);  // [RM * 16][GS]
  unsigned char* const ring = reinterpret_cast<unsigned char*>(gt + RM * 16 * GS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.y * CT;
  const int To = T / pt, Fo = F / pf, Ts = To * pt, Fs = Fo * pf;
  const float inv_w = 1.f / (float)(pt * pf);
  const bool has_bits = bits != nullptr;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // Bs[n][k] = Wg[k][n0 + n], zeros past Co (reads along n, coalesced)
  for (int i = tid; i < CT * KP; i += NT) {
    const int k = i / CT, n = i - k * CT;
    Bs[n * AS + k] = k < Co && n0 + n < Co ? wg[(long long)k * Co + n0 + n] : zero;
  }
  // the tile's copies into stage s (nothing past the last tile)
  auto issue = [&](int tile, int s) {
    if (tile >= n_tiles) return;
    const GluTile g = glu_tile(tile, Ts, Fs, TT, FF);
    bf16* const yd = reinterpret_cast<bf16*>(ring + s * sbytes);
    uint8_t* const bd = ring + s * sbytes + ybytes;
    const int len = g.fv * Co, dst = FF * Co;  // a frame's run; its place in the stage
    const long long src0 = (((long long)g.b * T + g.t0) * F + g.f0) * Co;
    const long long fstride = (long long)F * Co;
    if (vec) {
      const int per = (len + 7) >> 3;
      for (int i = tid; i < g.tv * per; i += NT) {
        const int j = i / per, k = (i - j * per) * 8;
        const int n = min(8, len - k);
        const long long src = src0 + j * fstride + k;
        cp_async16_n(yd + j * dst + k, y + src, 2 * n);
        if (has_bits) cp_async8_n(bd + j * dst + k, bits + src, n);
      }
    } else {
      for (int i = tid; i < g.tv * len; i += NT) {
        const int j = i / len, k = i - j * len;
        const long long src = src0 + j * fstride + k;
        yd[j * dst + k] = y[src];
        if (has_bits) bd[j * dst + k] = bits[src];
      }
    }
  };

  const int nch = KP / 8;
  int lane_c = -1;  // the BN lane (f * Co + c) whose scale and bias sv, bv hold
  float sv[8], bv[8];
  const int gq = lane >> 2, tq = lane & 3;
  float bgv[NI][2];  // bg at this thread's accumulator columns
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int n = n0 + wn * NI * 8 + ni * 8 + 2 * tq;
    bgv[ni][0] = n < Co ? to_f(bg[n]) : 0.f;
    bgv[ni][1] = n + 1 < Co ? to_f(bg[n + 1]) : 0.f;
  }
  const unsigned as = (unsigned)__cvta_generic_to_shared(As);
  const unsigned bs = (unsigned)__cvta_generic_to_shared(Bs);
  const int achunk = (lane >> 4) * 8;
  const int brow = wn * NI * 8 + (NI >= 2 ? (lane >> 4) * 8 : 0) + (lane & 7);
  const int bchunk = ((lane >> 3) & 1) * 8;
  const int qt = FF / pf, nq = (TT / pt) * qt;  // pooled outputs a tile: TT/pt rows x qt

  for (int s = 0; s < S - 1; ++s) {
    issue(blockIdx.x + s * gridDim.x, s);
    cp_async_commit();
  }
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int s = k % S;
    cp_async_wait_upto(S - 2);
    __syncthreads();  // the tile's stage landed; the previous tile's reads done
    issue(tile + (S - 1) * gridDim.x, (k + S - 1) % S);
    cp_async_commit();
    const GluTile g = glu_tile(tile, Ts, Fs, TT, FF);
    const bf16* const yr = reinterpret_cast<const bf16*>(ring + s * sbytes);
    const uint8_t* const br = ring + s * sbytes + ybytes;
    // A: row r, channels c .. c + 7
    for (int it = tid; it < rows * nch; it += NT) {
      const int r = it / nch, c = (it - r * nch) * 8;
      const int j = r / FF, fl = r - j * FF;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (j < g.tv && fl < g.fv && c < Co) {
        const int lf = (g.f0 + fl) * Co + c;
        if (lf != lane_c) {
          lane_c = lf;
          const float4 s0 = ld4(scale_f + lf, 0, Co - c), s1 = ld4(scale_f + lf, 4, Co - c);
          const float4 b0 = ld4(bias_f + lf, 0, Co - c), b1 = ld4(bias_f + lf, 4, Co - c);
          sv[0] = s0.x; sv[1] = s0.y; sv[2] = s0.z; sv[3] = s0.w;
          sv[4] = s1.x; sv[5] = s1.y; sv[6] = s1.z; sv[7] = s1.w;
          bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
          bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
        }
        float yv[8];
        if ((Co & 7) == 0) {
          const uint4 u = *reinterpret_cast<const uint4*>(yr + r * Co + c);
          yv[0] = bf_lo(u.x); yv[1] = bf_hi(u.x); yv[2] = bf_lo(u.y); yv[3] = bf_hi(u.y);
          yv[4] = bf_lo(u.z); yv[5] = bf_hi(u.z); yv[6] = bf_lo(u.w); yv[7] = bf_hi(u.w);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) yv[e] = c + e < Co ? to_f(yr[r * Co + c + e]) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = c + e < Co ? __fadd_rn(__fmul_rn(yv[e], sv[e]), bv[e]) : 0.f;
      }
      *reinterpret_cast<uint4*>(As + r * AS + c) =
          make_uint4(bf_pack(v[0], v[1]), bf_pack(v[2], v[3]), bf_pack(v[4], v[5]),
                     bf_pack(v[6], v[7]));
      const int cl = c - n0;
      if (cl >= 0 && cl < CT) {
        *reinterpret_cast<float4*>(gt + r * GS + cl) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(gt + r * GS + cl + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();
    // B and C, in passes of WM * MI m16 tiles
    for (int mb = 0; mb < RM; mb += WM * MI) {
      float acc[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      for (int k0 = 0; k0 < KP; k0 += 16) {
        uint32_t b[NI][2];
        if constexpr (NI >= 2) {
#pragma unroll
          for (int ni = 0; ni < NI; ni += 2)
            ldsm_x4(bs + 2u * (unsigned)((brow + ni * 8) * AS + k0 + bchunk), b[ni][0],
                    b[ni][1], b[ni + 1][0], b[ni + 1][1]);
        } else {
          ldsm_x2(bs + 2u * (unsigned)(brow * AS + k0 + bchunk), b[0][0], b[0][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int mt = mb + wm + WM * mi;
          if (mt >= RM) continue;  // warp-uniform
          uint32_t a[4];
          ldsm_x4(as + 2u * (unsigned)((mt * 16 + (lane & 15)) * AS + k0 + achunk), a[0], a[1],
                  a[2], a[3]);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a, b[ni][0], b[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int mt = mb + wm + WM * mi;
        if (mt >= RM) continue;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int n = wn * NI * 8 + ni * 8 + 2 * tq;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* gp = reinterpret_cast<float2*>(gt + (mt * 16 + gq + 8 * h) * GS + n);
            const float2 gv = *gp;
            *gp = make_float2((acc[mi][ni][2 * h] + bgv[ni][0]) * sigmoid_fast(gv.x),
                              (acc[mi][ni][2 * h + 1] + bgv[ni][1]) * sigmoid_fast(gv.y));
          }
        }
      }
    }
    __syncthreads();
    // D: pooled output (jo, fo) of the tile, channels c .. c + 7
    for (int it = tid; it < nq * C8; it += NT) {
      const int qi = it / C8, cl = (it - qi * C8) * 8;
      const int jo = qi / qt, fo = qi - jo * qt;
      const int c = n0 + cl;
      if (jo * pt >= g.tv || fo * pf >= g.fv || c >= Co) continue;
      float sum[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] = 0.f;
      for (int dt = 0; dt < pt; ++dt)
        for (int df = 0; df < pf; ++df) {
          const int r = (jo * pt + dt) * FF + fo * pf + df;
          const float4 g0 = *reinterpret_cast<const float4*>(gt + r * GS + cl);
          const float4 g1 = *reinterpret_cast<const float4*>(gt + r * GS + cl + 4);
          float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
          if (has_bits) {
            uint32_t kb[2];
            if ((Co & 7) == 0) {
              const uint2 u = *reinterpret_cast<const uint2*>(br + r * Co + c);
              kb[0] = u.x;
              kb[1] = u.y;
            } else {
              kb[0] = kb[1] = 0u;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (c + e < Co) kb[e >> 2] |= (uint32_t)br[r * Co + c + e] << (8 * (e & 3));
            }
#pragma unroll
            for (int e = 0; e < 8; ++e)
              gv[e] = (int)((kb[e >> 2] >> (8 * (e & 3))) & 255u) < keep_thresh ? gv[e] * inv_keep
                                                                               : 0.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] += gv[e];
        }
      bf16* const zp =
          z + (((long long)g.b * To + g.t0 / pt + jo) * Fo + g.f0 / pf + fo) * Co + c;
      if ((Co & 7) == 0) {
        *reinterpret_cast<uint4*>(zp) =
            make_uint4(bf_pack(sum[0] * inv_w, sum[1] * inv_w), bf_pack(sum[2] * inv_w, sum[3] * inv_w),
                       bf_pack(sum[4] * inv_w, sum[5] * inv_w), bf_pack(sum[6] * inv_w, sum[7] * inv_w));
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < Co) zp[e] = __float2bfloat16_rn(sum[e] * inv_w);
      }
    }
  }
  cp_async_wait<0>();  // the tail's groups are empty; nothing is left in flight
}

template <int NI, int WN>
cudaError_t launch_glu_fwd_ring(const bf16* y, const float* scale_f, const float* bias_f,
                                const bf16* wg, const bf16* bg, const uint8_t* bits, bf16* z,
                                int T, int F, int Co, int pt, int pf, int keep_thresh,
                                float inv_keep, const int* plan, cudaStream_t stream) {
  static int smem_set = 0;
  const int TT = plan[1], FF = plan[2], S = plan[3], vec = plan[4], KP = plan[5];
  const int n_tiles = plan[6], grid_x = plan[7], grid_y = plan[8], smem = plan[9];
  cudaError_t err = ensure_smem(glu_fwd_ring_kernel<NI, WN>, smem, smem_set);
  if (err != cudaSuccess) return err;
  glu_fwd_ring_kernel<NI, WN><<<dim3(grid_x, grid_y), GLU_RING_THREADS, smem, stream>>>(
      y, scale_f, bias_f, wg, bg, bits, z, T, F, Co, pt, pf, keep_thresh, inv_keep, TT, FF, S,
      vec, KP, n_tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// glu_drop_pool in bf16 in registers, for the shapes GluBf16Plan gives
// `frag` (ops/fused_cnn.py glu_frag_takes): Co = 16, 32, 64 or 128, pools
// of at most 2 x 2, Fo*pf a multiple of 8 (frag 1) or, at pt = 1, a divisor
// of 8 (frag 2). Each warp works alone on its own tiles: TT frames x FW
// frequencies of one clip at all Co channels, numbered f-tile fastest, then
// t-tile, then clip; warp w of block x takes tiles 8 x + w, stepping by
// 8 gridDim.x. Shared memory: Bs [Co][Co + 8] (Wg as it is, read by
// ldmatrix.trans) and sb [Fs][Co/2 + 4] float4 (the scale and bias of
// channel pairs, (s_k, s_k+1, b_k, b_k+1)) for the block, staged once, then
// each warp's ring of S stages: y [TT][FW][Co + 8] bf16 (16-byte cp.async,
// rows padded so that ldmatrix's 8 rows fall in 8 bank groups) and bits
// [TT][FW][Co] uint8. The 16 rows of an m16 tile are, with frag 1 (TT =
// 2), 8 frequencies of frame 0 and the same 8 of frame 1; with frag 2 (FW
// = Fs, TT Fs a multiple of 16), 16 consecutive (frame, frequency) rows. So
// a lane's fragment rows g and g + 8 are one frequency in two frames, and
// lane ^ 4 holds the next frequency. Per m16 tile, with no shared-memory
// round trip:
//   ldmatrix of the raw y, BN(y) in fp32 (a multiply, then an add) per
//   fragment element, rounded into the A fragment (pallas_cnn.py:277) and
//   kept unrounded as the gate of the accumulators of the same rows and
//   channels (:279: the A fragment of depth step ks holds exactly the
//   elements of accumulator tiles 2 ks and 2 ks + 1);
//   lin = A Wg on mma.sync m16n8k16, GLU, dropout from the staged bits,
//   the window's sum in window order wi = dt pf + df (rows g and g + 8 are
//   dt = 0, 1 at pt = 2; lane ^ 4, by __shfl_xor_sync, is df = 1), times
//   1 / (pt pf), z rounded once (:292) and stored 2 channels a lane.
// ---------------------------------------------------------------------------
constexpr int GLU_FRAG_THREADS = 256;

// blocks an SM that the registers allow (ops/fused_cnn.py GLU_FRAG_PER_SM)
constexpr int glu_frag_per_sm(int ni) { return ni == 16 ? 1 : ni == 2 ? 3 : 2; }

template <int NI>  // Co = 8 NI
__global__ void __launch_bounds__(GLU_FRAG_THREADS, glu_frag_per_sm(NI)) glu_fwd_frag_kernel(
    const bf16* __restrict__ y, const float* __restrict__ scale_f,
    const float* __restrict__ bias_f, const bf16* __restrict__ wg, const bf16* __restrict__ bg,
    const uint8_t* __restrict__ bits, bf16* __restrict__ z, int T, int F, int pt, int pf,
    int keep_thresh, float inv_keep, int TT, int FW, int consec, int S, int n_tiles) {
  constexpr int Co = 8 * NI, KS = Co / 16, YP = Co + 8, SP = Co / 2 + 4;
  constexpr int NW = GLU_FRAG_THREADS / 32;
  const int To = T / pt, Fo = F / pf, Ts = To * pt, Fs = Fo * pf;
  const int ybytes = TT * FW * YP * 2, sbytes = ybytes + TT * FW * Co;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const Bs = reinterpret_cast<bf16*>(smem_raw);          // [Co][YP]
  float4* const sb = reinterpret_cast<float4*>(Bs + Co * YP);  // [Fs][SP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned char* const ring = reinterpret_cast<unsigned char*>(sb + Fs * SP) + warp * S * sbytes;
  const bool has_bits = bits != nullptr;
  const float inv_w = 1.f / (float)(pt * pf);

  for (int i = tid; i < Co * NI; i += GLU_FRAG_THREADS) {
    const int k = i / NI, c = (i - k * NI) * 8;
    cp_async16(Bs + k * YP + c, wg + k * Co + c, true);
  }
  cp_async_commit();
  for (int i = tid; i < Fs * (Co / 2); i += GLU_FRAG_THREADS) {
    const int f = i / (Co / 2), p = i - f * (Co / 2), l = f * Co + 2 * p;
    sb[f * SP + p] = make_float4(scale_f[l], scale_f[l + 1], bias_f[l], bias_f[l + 1]);
  }
  const int gq = lane >> 2, tq = lane & 3;
  float bgv[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    bgv[ni][0] = to_f(bg[ni * 8 + 2 * tq]);
    bgv[ni][1] = to_f(bg[ni * 8 + 2 * tq + 1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // Bs and sb staged; from here on each warp works alone

  const int nf = (Fs + FW - 1) / FW, nt = (Ts + TT - 1) / TT;
  auto decode = [&](int tile, int& b, int& t0, int& f0, int& tv, int& fv) {
    const int fi = tile % nf, r = tile / nf;
    b = r / nt;
    t0 = (r - b * nt) * TT;
    f0 = fi * FW;
    tv = min(TT, Ts - t0);
    fv = min(FW, Fs - f0);
  };
  auto issue = [&](int tile, int s) {
    if (tile >= n_tiles) return;
    int b, t0, f0, tv, fv;
    decode(tile, b, t0, f0, tv, fv);
    bf16* const yd = reinterpret_cast<bf16*>(ring + s * sbytes);
    uint8_t* const bd = ring + s * sbytes + ybytes;
    const int per = fv * NI;  // 16-byte chunks of a frame's run
    for (int j = 0; j < tv; ++j) {
      const long long src0 = (((long long)b * T + t0 + j) * F + f0) * Co;
      for (int q = lane; q < per; q += 32) {
        const int f = q / NI, c = (q - f * NI) * 8;
        cp_async16(yd + (j * FW + f) * YP + c, y + src0 + q * 8, true);
        if (has_bits) cp_async8(bd + (j * FW + f) * Co + c, bits + src0 + q * 8, true);
      }
    }
  };

  const int first = blockIdx.x * NW + warp, stride = gridDim.x * NW;
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned bs_s = (unsigned)__cvta_generic_to_shared(Bs);
  // ldmatrix rows: A, row (lane & 15) of the m16 tile at chunk lane >> 4;
  // B (.trans), depth row ((lane >> 3) & 1) 8 + (lane & 7) at n8 tile lane >> 4
  const int a_row = consec ? (lane & 15) : ((lane >> 3) & 1) * FW + (lane & 7);
  const int a_chunk = (lane >> 4) * 8;
  const int b_off = (((lane >> 3) & 1) * 8 + (lane & 7)) * YP + (lane >> 4) * 8;
  for (int s = 0; s < S - 1; ++s) {
    issue(first + s * stride, s);
    cp_async_commit();
  }
  int k = 0;
  for (int tile = first; tile < n_tiles; tile += stride, ++k) {
    const int s = k % S;
    cp_async_wait_upto(S - 2);
    __syncwarp();  // every lane's copies of the tile landed; the previous tile read
    issue(tile + (S - 1) * stride, (k + S - 1) % S);
    cp_async_commit();
    int b, t0, f0, tv, fv;
    decode(tile, b, t0, f0, tv, fv);
    const unsigned ys = ring_s + s * sbytes;
    const uint8_t* const bd = ring + s * sbytes + ybytes;
    const int n_m = consec ? (tv * FW + 15) / 16 : fv / 8;  // m16 tiles
    for (int mt = 0; mt < n_m; ++mt) {
      // this lane's rows g, g + 8: frames j0, j1 at frequency fl of the tile
      int fl, j0, j1;
      if (consec) {
        const int r0 = 16 * mt + gq;
        j0 = r0 / FW;
        fl = r0 - j0 * FW;
        j1 = j0 + 8 / FW;
      } else {
        fl = 8 * mt + gq;
        j0 = 0;
        j1 = 1;
      }
      const int row0 = consec ? 16 * mt : 8 * mt;  // the m16 tile's first stage row
      const int fg = f0 + fl;
      uint32_t a[KS][4];
      float gv[KS][8];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldsm_x4(ys + 2u * (unsigned)((a_row + row0) * YP + ks * 16 + a_chunk), a[ks][0],
                a[ks][1], a[ks][2], a[ks][3]);
        const float4 s0 = sb[fg * SP + ks * 8 + tq], s1 = sb[fg * SP + ks * 8 + 4 + tq];
        bn_pair(a[ks][0], s0, gv[ks][0], gv[ks][1]);  // row g, channels 16 ks + 2 tq, + 1
        bn_pair(a[ks][1], s0, gv[ks][2], gv[ks][3]);  // row g + 8
        bn_pair(a[ks][2], s1, gv[ks][4], gv[ks][5]);  // row g, channels + 8
        bn_pair(a[ks][3], s1, gv[ks][6], gv[ks][7]);  // row g + 8, channels + 8
      }
      float acc[NI][4];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(bs_s + 2u * (unsigned)(ks * 16 * YP + ni * 8 + b_off), b0, b1, b2, b3);
          mma_bf16(acc[ni], a[ks], b0, b1);
          mma_bf16(acc[ni + 1], a[ks], b2, b3);
        }
      // GLU and dropout: accumulator e of tile ni is row g (e < 2) or g + 8,
      // channel ni * 8 + 2 tq + e % 2; its gate is gv[ni / 2][4 (ni % 2) + e]
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t kb = 0xffffffffu;
        if (has_bits) {
          const int c = ni * 8 + 2 * tq;
          kb = (uint32_t)*reinterpret_cast<const uint16_t*>(bd + (j0 * FW + fl) * Co + c) |
               (uint32_t)*reinterpret_cast<const uint16_t*>(bd + (j1 * FW + fl) * Co + c) << 16;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = (acc[ni][e] + bgv[ni][e & 1]) * sigmoid_fast(gv[ni >> 1][4 * (ni & 1) + e]);
          if (has_bits) v = (int)((kb >> (8 * e)) & 255u) < keep_thresh ? v * inv_keep : 0.f;
          acc[ni][e] = v;
        }
      }
      // the pool: rows g, g + 8 are frames j0, j1; lane ^ 4 the next frequency
      const bool lead = pf == 1 || (gq & 1) == 0;
      const int fo = fg / pf;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[ni][e], 4);
        const int c = ni * 8 + 2 * tq;
        if (!lead) continue;
        if (pt == 2) {  // one window row: frame t0, then t0 + 1
          float o0 = acc[ni][0], o1 = acc[ni][1];
          if (pf == 2) {
            o0 += p[0];
            o1 += p[1];
          }
          o0 += acc[ni][2];
          o1 += acc[ni][3];
          if (pf == 2) {
            o0 += p[2];
            o1 += p[3];
          }
          *reinterpret_cast<uint32_t*>(z + (((long long)b * To + t0 / 2) * Fo + fo) * Co + c) =
              bf_pack(o0 * inv_w, o1 * inv_w);
        } else {  // pt == 1: each frame a window row of its own
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = h ? j1 : j0;
            if (j >= tv) continue;
            float o0 = acc[ni][2 * h], o1 = acc[ni][2 * h + 1];
            if (pf == 2) {
              o0 += p[2 * h];
              o1 += p[2 * h + 1];
            }
            *reinterpret_cast<uint32_t*>(z + (((long long)b * To + t0 + j) * Fo + fo) * Co + c) =
                bf_pack(o0 * inv_w, o1 * inv_w);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // the tail's groups are empty; nothing is left in flight
}

// ---------------------------------------------------------------------------
// conv_bn_stats in bf16 with Ci % 16 == 0, Co a multiple of 32 and F a
// power of two (every 2024 block but the first; ops/fused_cnn.py
// fwd16_takes): conv3x3_bf16_fwd_kernel. The same function as
// conv3x3_bf16_kernel with STATS (y = bf16(conv3x3(x, w) + bias), the
// products bf16 x bf16 into fp32, s and q the fp32 lane sums of the rounded
// y, pallas_cnn.py:171-178), in persistent CTAs. The grid is n_parts CTAs
// per channel tile of BN channels (blockIdx.y); CTA g walks the contiguous
// run [g n / G, (g + 1) n / G) of the n = B ceil(T / TT) tiles, a tile TT
// whole frames of one clip (FWD16_ROWS = TT F rows), in row order. Whole frames
// make a lane (f, c) the same for every tile, so thread f BN / 8 + ch
// (F BN / 8 <= 256 of them) keeps the sums of lanes (f, 8 ch .. 8 ch + 7)
// in registers across the run, adding each tile's frames in frame order
// from the same 16-byte reads of the staged y that write y out, and
// writes one partial row at the end: n_parts
// rows per lane, added in a fixed order by lane_stats_final_kernel (no
// atomics). A ring of S stages runs across tiles: stage u is slice u % NS
// of tile u / NS, copied by cp.async S - 1 stages ahead, so the next tile's
// copies fly during a tile's last products and its epilogue; one barrier a
// stage. A stage holds the tile's halo, (TT + 2) x (F + 2) positions of KC
// channels (zeros where the SAME padding lies, so the nine taps are fixed
// offsets), rows of KC / 8 16-byte chunks XORed by the position
// (RowSwz). Where [9 Ci][BN] fits and Ci is a power of two (RES;
// ops/fused_cnn.py fwd16_res_takes), the weights are staged once per CTA
// and stay for the whole run, and a stage holds all Ci channels (KC = Ci,
// NS = 1); else a stage holds 16 channels and their weight slice
// [9][16][BN] (KC = 16 at compile time, NS = Ci / 16). B fragments come by ldmatrix.trans
// from w as the wrapper has it, [3, 3, Ci, Co] = rows [tap Ci + k] of BN
// channels (chunks XORed by the row, RowSwz), as glu_fwd_frag_kernel reads Wg; A
// fragments by ldmatrix from the halo, each lane naming the position of its
// row plus the tap's offset. 8 warps, each MI = 2 m16 tiles (32 rows) x
// NI = BN / 8 n8 tiles (all BN channels), fp32 accumulators in registers.
// Epilogue: + bias in
// fp32, rounded to bf16 into a [FWD16_ROWS][BN + 8] bf16 tile, one barrier, y out
// in 16-byte pieces (a frame's rows are contiguous in y) and the lane sums
// from the same staged rounded values. Rows past T are computed from zero
// halo rows and neither stored nor summed.
// ---------------------------------------------------------------------------
constexpr int FWD16_THREADS = 256;
constexpr int FWD16_ROWS = 256;  // rows a tile: 8 warps x 32
constexpr int FWD16_STAGES = 2;  // the ring (three measured no faster on the H100)

// conv3x3_bf16_fwd_kernel's one address rule, for its halo and its weight
// rows: swz_rows at CG = 2^cg_shift chunks a row, by shifts (a chunk
// count known only at run time would cost an integer division a call,
// more than the ldmatrix it addresses). The key (row >> sh) & msk is
// swz_rows' row & 7 (CG >= 8) or (row / (8 / CG)) & (CG - 1). Valid only
// for a power-of-two CG: the plan (fwd16_res_takes) and launch_fwd16 hold
// to it, and tests/test_torch_fused_cnn_plan.py _row_swz mirrors it.
struct RowSwz {
  int cg_shift, sh, msk;
  __host__ __device__ constexpr explicit RowSwz(int cg_shift_)
      : cg_shift(cg_shift_), sh(cg_shift_ >= 3 ? 0 : 3 - cg_shift_),
        msk(cg_shift_ >= 3 ? 7 : (1 << cg_shift_) - 1) {}
  __device__ __forceinline__ int operator()(int row, int c) const {
    return ((row << cg_shift) + (c ^ ((row >> sh) & msk))) << 3;
  }
};

// CTAs an SM that the registers allow (ops/fused_cnn.py fwd16_per_sm): two
// where a thread keeps 32 accumulators (BN = 32), else one
constexpr int fwd16_per_sm(int bn) { return bn <= 32 ? 2 : 1; }

template <int BN, bool RES>
__global__ void __launch_bounds__(FWD16_THREADS, fwd16_per_sm(BN)) conv3x3_bf16_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ part_s, float* __restrict__ part_q, int T, int F,
    int Ci, int Co, int TT, int n_tiles) {
  constexpr int S = FWD16_STAGES;
  constexpr bool res = RES;
  constexpr int MI = 2, NI = BN / 8;
  static_assert(NI % 2 == 0, "n8 tiles in pairs");
  constexpr int YS = BN + 8;   // bf16 row pitch of the staged y tile
  constexpr int CGW = BN / 8;  // 16-byte chunks of a weight row
  static_assert(CGW == 4 || CGW == 8 || CGW == 16, "weight rows of 4, 8 or 16 chunks");
  const RowSwz swz_w(CGW == 4 ? 2 : CGW == 8 ? 3 : 4);  // the weight rows' chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = F + 2, NP = (TT + 2) * W;
  const int KC = res ? Ci : 16, CG = KC / 8, cg_shift = __ffs(CG) - 1, NS = Ci / KC;
  const int halo = NP * KC, STG = halo + (res ? 0 : 9 * 16 * BN);
  bf16* const Wr = reinterpret_cast<bf16*>(smem_raw);  // resident weights [9 Ci][BN]
  bf16* const ring = Wr + (res ? 9 * Ci * BN : 0);      // S stages of STG elements
  bf16* const ys = ring + S * STG;                       // the rounded y [FWD16_ROWS][YS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const int k0 = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  const int k1 = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
  const int U = (k1 - k0) * NS;  // stages of this CTA's run
  const int nt = (T + TT - 1) / TT, f_shift = __ffs(F) - 1;
  const FastDiv div_w(W);
  const RowSwz swz_h(cg_shift);  // the halo rows' chunks

  if (res) {  // the weights of the channel tile, once (in the first stage's group)
    for (int e = tid; e < 9 * Ci * CGW; e += FWD16_THREADS) {
      const int row = e / CGW, ch = e % CGW;
      cp_async16(Wr + swz_w(row, ch), w + (long long)row * Co + n0 + ch * 8, true);
    }
  }
  // stage u: slice j of tile k0 + u / NS into ring slot u % S (an empty
  // group past the run, so that every thread commits one group a stage)
  auto issue = [&](int u) {
    if (u < U) {
      const int kt = u / NS, j = u - kt * NS;
      const int tile = k0 + kt, b = tile / nt, t0 = (tile - b * nt) * TT, c0 = j * KC;
      bf16* const H = ring + (u % S) * STG;
      for (int e = tid; e < NP * CG; e += FWD16_THREADS) {
        const int pos = e >> cg_shift, ch = e & (CG - 1);
        const int jt = div_w(pos);
        const int t = t0 + jt - 1, f = pos - jt * W - 1;
        const bool ok = t >= 0 && t < T && f >= 0 && f < F;
        cp_async16(H + swz_h(pos, ch),
                   ok ? x + (((long long)b * T + t) * F + f) * Ci + c0 + ch * 8 : x, ok);
      }
      if (!res) {
        bf16* const Ws = H + halo;
        for (int e = tid; e < 9 * 16 * CGW; e += FWD16_THREADS) {
          const int row = e / CGW, ch = e % CGW;  // row = tap * 16 + k
          cp_async16(Ws + swz_w(row, ch),
                     w + (long long)((row >> 4) * Ci + c0 + (row & 15)) * Co + n0 + ch * 8, true);
        }
      }
    }
    cp_async_commit();
  };

  // ldmatrix rows: A, row (lane & 15) of each m16 tile at chunk lane >> 4 of
  // a k16 step; B (.trans), depth row ((lane >> 3) & 1) 8 + (lane & 7) at
  // chunk lane >> 4 of an n8 pair
  int apos[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = warp * 32 + mi * 16 + (lane & 15);
    apos[mi] = ((r >> f_shift) + 1) * W + (r & (F - 1)) + 1;
  }
  const int achunk = lane >> 4;
  const int brow = ((lane >> 3) & 1) * 8 + (lane & 7), bchunk = lane >> 4;
  const int gq = lane >> 2, tq = lane & 3;
  const int L = F * Co;

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float ls[8], lq[8];  // the sums of lanes (f, 8 ch + j), thread tid = f BN / 8 + ch
#pragma unroll
  for (int j = 0; j < 8; ++j) ls[j] = lq[j] = 0.f;

  for (int s = 0; s < S - 1; ++s) issue(s);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned wr_s = (unsigned)__cvta_generic_to_shared(Wr);
  const int wk = res ? Ci : 16;  // weight rows a tap
  for (int u = 0; u < U; ++u) {
    cp_async_wait<S - 2>();
    __syncthreads();  // stage u landed; every warp is done with stage u - 1's slot
    issue(u + S - 1);
    const int kt = u / NS, j = u - kt * NS;
    const unsigned hs = ring_s + 2u * (unsigned)((u % S) * STG);
    const unsigned ws = res ? wr_s : hs + 2u * (unsigned)halo;
#pragma unroll 3
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3 - 1) * W + tap % 3 - 1;
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldsm_x4(hs + 2u * (unsigned)swz_h(apos[mi] + off, 2 * kk + achunk), a[mi][0], a[mi][1],
                  a[mi][2], a[mi][3]);
        const int wrow = tap * wk + kk * 16 + brow;
#pragma unroll
        for (int ni = 0; ni < NI; ni += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(ws + 2u * (unsigned)swz_w(wrow, bchunk + ni), b0, b1, b2, b3);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_bf16(acc[mi][ni], a[mi], b0, b1);
            mma_bf16(acc[mi][ni + 1], a[mi], b2, b3);
          }
        }
      }
    }
    if (j != NS - 1) continue;
    // the tile's epilogue: y + bias rounded to bf16 into ys
    const int tile = k0 + kt, b = tile / nt, t0 = (tile - b * nt) * TT;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = ni * 8 + 2 * tq;
      const float b0 = to_f(bias[n0 + n]), b1 = to_f(bias[n0 + n + 1]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = warp * 32 + mi * 16 + gq;
        *reinterpret_cast<uint32_t*>(ys + r * YS + n) =
            bf_pack(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
        *reinterpret_cast<uint32_t*>(ys + (r + 8) * YS + n) =
            bf_pack(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
      }
    }
    __syncthreads();
    // thread (f, ch) < (F, BN / 8): y's 16-byte piece at lanes (f, 8 ch ..
    // 8 ch + 7) of each frame, in frame order, and those 8 lanes' sums
    if (tid < F * CGW) {
      const int frames = min(TT, T - t0);
      const bf16* src = ys + (tid / CGW) * YS + (tid % CGW) * 8;
      bf16* dst = y + (((long long)b * T + t0) * F + tid / CGW) * Co + n0 + (tid % CGW) * 8;
#pragma unroll 4
      for (int jt = 0; jt < frames; ++jt, src += F * YS, dst += (long long)F * Co) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        *reinterpret_cast<uint4*>(dst) = v;
        const uint32_t u4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float v0 = bf_lo(u4[h]), v1 = bf_hi(u4[h]);
          ls[2 * h] += v0;
          ls[2 * h + 1] += v1;
          lq[2 * h] = fmaf(v0, v0, lq[2 * h]);
          lq[2 * h + 1] = fmaf(v1, v1, lq[2 * h + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the tail's groups are empty; nothing is left in flight
  if (tid < F * CGW) {
    const long long o = (long long)blockIdx.x * L + (tid / CGW) * Co + n0 + (tid % CGW) * 8;
    *reinterpret_cast<float4*>(part_s + o) = make_float4(ls[0], ls[1], ls[2], ls[3]);
    *reinterpret_cast<float4*>(part_s + o + 4) = make_float4(ls[4], ls[5], ls[6], ls[7]);
    *reinterpret_cast<float4*>(part_q + o) = make_float4(lq[0], lq[1], lq[2], lq[3]);
    *reinterpret_cast<float4*>(part_q + o + 4) = make_float4(lq[4], lq[5], lq[6], lq[7]);
  }
}

// ---------------------------------------------------------------------------
// conv_bn_stats in bf16 at Ci = 1 (the first block; ops/fused_cnn.py
// c1_bf16_takes: F % 8 == 0, Co % 8 == 0, F Co / 8 <= 256):
// conv_c1_bf16_kernel. Bound by the bytes of y (2 Co bytes a position
// against 2 of x). CTA g takes fpc consecutive frames r of the B T (runs
// cross clips; t = r % T decides the SAME padding in time) and stages their
// x, with the frame before and the frame after, once, by 16-byte cp.async
// ([frame][F] bf16). Thread (f, c0) computes the 8 channels c0 .. c0 + 7 of
// position f in every frame of the run, in order: the 9 x 8 weights and the
// bias in registers, the nine x values from shared memory, fp32 FMAs (a
// product of two bf16 values is exact in fp32), + bias, rounded to bf16,
// one 16-byte store (a warp writes 512 contiguous bytes), and adds the
// rounded values and their squares into its lanes' sums in frame order; the
// CTA writes one partial row (pallas_cnn.py:171-178).
// ---------------------------------------------------------------------------
constexpr int C1F_THREADS = 256;

__global__ void __launch_bounds__(C1F_THREADS, 2) conv_c1_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    bf16* __restrict__ y, float* __restrict__ part_s, float* __restrict__ part_q, int B, int T,
    int F, int Co, int fpc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const xs = reinterpret_cast<bf16*>(smem_raw);  // frame r0 - 1 + i in row i
  const int R = B * T;  // rows fit in an int (the plan checks)
  const int r0 = blockIdx.x * fpc, r1 = min(R, r0 + fpc);
  const int g0 = max(r0 - 1, 0), g1 = min(R, r1 + 1);  // the frames staged
  const int tid = threadIdx.x;
  {
    const bf16* const src = x + (long long)g0 * F;
    bf16* const dst = xs + (g0 - r0 + 1) * F;
    for (int e = tid; e < (g1 - g0) * F / 8; e += C1F_THREADS)
      cp_async16(dst + e * 8, src + e * 8, true);
    cp_async_commit();
  }
  const int G = Co / 8;
  const int f = tid / G, c0 = (tid - f * G) * 8;
  const bool live = f < F;
  float wv[9][8], bv[8], s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bv[j] = live ? to_f(bias[c0 + j]) : 0.f;
    s[j] = q[j] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) wv[tap][j] = live ? to_f(w[tap * Co + c0 + j]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  int t = r0 % T;
#pragma unroll 2
  for (int r = r0; r < r1; ++r) {
    const bf16* const row = xs + (r - r0 + 1) * F + f;
    float xv[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dt = tap / 3 - 1, df = tap % 3 - 1;
      const bool ok = (dt < 0 ? t > 0 : dt > 0 ? t < T - 1 : true) && f + df >= 0 && f + df < F;
      xv[tap] = ok ? to_f(row[dt * F + df]) : 0.f;
    }
    float o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) a = fmaf(xv[tap], wv[tap][j], a);
      o[j] = rnd<bf16>(a + bv[j]);
      s[j] += o[j];
      q[j] = fmaf(o[j], o[j], q[j]);
    }
    *reinterpret_cast<uint4*>(y + ((long long)r * F + f) * Co + c0) =
        make_uint4(bf_pack(o[0], o[1]), bf_pack(o[2], o[3]), bf_pack(o[4], o[5]),
                   bf_pack(o[6], o[7]));
    if (++t == T) t = 0;
  }
  const long long o = (long long)blockIdx.x * F * Co + f * Co + c0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part_s[o + j] = s[j];
    part_q[o + j] = q[j];
  }
}

template <int NI>
cudaError_t launch_glu_fwd_frag(const bf16* y, const float* scale_f, const float* bias_f,
                                const bf16* wg, const bf16* bg, const uint8_t* bits, bf16* z,
                                int T, int F, int pt, int pf, int keep_thresh, float inv_keep,
                                const int* plan, cudaStream_t stream) {
  static int smem_set = 0;
  const int TT = plan[1], FW = plan[2], S = plan[3], n_tiles = plan[6], grid_x = plan[7];
  const int smem = plan[9], consec = plan[11] == 2;
  cudaError_t err = ensure_smem(glu_fwd_frag_kernel<NI>, smem, smem_set);
  if (err != cudaSuccess) return err;
  glu_fwd_frag_kernel<NI><<<grid_x, GLU_FRAG_THREADS, smem, stream>>>(
      y, scale_f, bias_f, wg, bg, bits, z, T, F, pt, pf, keep_thresh, inv_keep, TT, FW, consec,
      S, n_tiles);
  return cudaGetLastError();
}

template <int WR>
cudaError_t launch_glu_fwd(const float* y, const float* scale_f, const float* bias_f,
                           const float* wg, const float* bg, const uint8_t* bits, float* z,
                           int B, int T, int F, int Co, int pt, int pf, int keep_thresh,
                           float inv_keep, const int* plan, cudaStream_t stream) {
  static int smem_set = 0;
  const int CT = plan[0], P = plan[1], NQ = plan[2], KS = plan[3];
  const int n_tiles = plan[4], grid_x = plan[5], grid_y = plan[6], smem = plan[7];
  cudaError_t err = ensure_smem(glu_fwd_kernel<WR>, smem, smem_set);
  if (err != cudaSuccess) return err;
  glu_fwd_kernel<WR><<<dim3(grid_x, grid_y), GLU_FWD_THREADS, smem, stream>>>(
      y, scale_f, bias_f, wg, bg, bits, z, B, T, F, Co, pt, pf, keep_thresh, inv_keep, CT, P,
      NQ, KS, n_tiles);
  return cudaGetLastError();
}

// conv_bn_stats in bf16 (Ci > 1): conv3x3_bf16_kernel at tile width BN
template <int BN, bool VEC>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* wt, const bf16* bias, bf16* y,
                            float* part_s, float* part_q, int B, int T, int F, int Ci, int Co,
                            int TT, int FF, int smem, cudaStream_t s) {
  static int smem_set = 0;
  auto kernel = conv3x3_bf16_kernel<BN, VEC, true>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((T + TT - 1) / TT) * ((F + FF - 1) / FF);
  dim3 grid((unsigned)tiles, (unsigned)((Co + BN - 1) / BN));
  kernel<<<grid, 256, smem, s>>>(x, wt, bias, y, part_s, part_q, B, T, F, Ci, Co, TT, FF);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_fwd_bf16_bn(int BN, const bf16* x, const bf16* wt, const bf16* bias, bf16* y,
                               float* part_s, float* part_q, int B, int T, int F, int Ci,
                               int Co, int TT, int FF, int smem, cudaStream_t s) {
#define FWD16_ARGS x, wt, bias, y, part_s, part_q, B, T, F, Ci, Co, TT, FF, smem, s
  switch (BN) {
    case 8: return launch_fwd_bf16<8, VEC>(FWD16_ARGS);
    case 16: return launch_fwd_bf16<16, VEC>(FWD16_ARGS);
    case 32: return launch_fwd_bf16<32, VEC>(FWD16_ARGS);
    case 64: return launch_fwd_bf16<64, VEC>(FWD16_ARGS);
    case 128: return launch_fwd_bf16<128, VEC>(FWD16_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FWD16_ARGS
}

// conv_bn_stats in bf16: conv3x3_bf16_fwd_kernel at channel tile BN
template <int BN, bool RES>
cudaError_t launch_fwd16(const bf16* x, const bf16* w, const bf16* bias, bf16* y, float* part_s,
                         float* part_q, int B, int T, int F, int Ci, int Co, int TT, int ctas,
                         int smem, cudaStream_t s) {
  static int smem_set = 0;
  auto kernel = conv3x3_bf16_fwd_kernel<BN, RES>;
  if (Ci % 16 || (RES && (Ci & (Ci - 1)))) return cudaErrorInvalidValue;  // RowSwz's chunks
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = B * ((T + TT - 1) / TT);
  kernel<<<dim3(ctas, Co / BN), FWD16_THREADS, smem, s>>>(x, w, bias, y, part_s, part_q, T, F, Ci,
                                                          Co, TT, n_tiles);
  return cudaGetLastError();
}

// conv_bn_stats in bf16 at Ci = 1: conv_c1_bf16_kernel
cudaError_t launch_c1_bf16(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
                           float* part_s, float* part_q, int B, int T, int F, int Co, int fpc,
                           int ctas, int smem, cudaStream_t s) {
  static int smem_set = 0;
  cudaError_t err = ensure_smem(conv_c1_bf16_kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  conv_c1_bf16_kernel<<<ctas, C1F_THREADS, smem, s>>>(x, w, bias, y, part_s, part_q, B, T, F,
                                                      Co, fpc);
  return cudaGetLastError();
}

// conv_bn_stats_bwd's dW in bf16 on the tensor cores: conv_dw_taps_kernel
// with 8 warps as WK x WN x WR of NI n8 tiles each
template <int WK, int WN, int NI, int WR>
cudaError_t launch_dw_taps(const bf16* x, const bf16* dye, float* part_w, int B, int T, int F,
                           int Ci, int Co, int TT, int FF, int n_tiles, int tpc, int chunks,
                           int smem, cudaStream_t s) {
  static int smem_set = 0;
  constexpr int CS = 16 * WK, BNO = 8 * WN * NI;
  auto kernel = conv_dw_taps_kernel<WK, WN, NI, WR>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(Ci / CS, (Co + BNO - 1) / BNO, chunks);
  kernel<<<grid, 256, smem, s>>>(x, dye, part_w, B, T, F, Ci, Co, TT, FF, n_tiles, tpc);
  return cudaGetLastError();
}

// the warps of conv_dw_taps_kernel by (CS, BNO) (ops/fused_cnn.py
// dw_taps_warps: NI = min(4, BNO / 8), WK = CS / 16, WN = BNO / 8 NI, WR = 8 / WK WN)
cudaError_t launch_dw_taps_tile(int CS, int BNO, const bf16* x, const bf16* dye, float* part_w,
                                int B, int T, int F, int Ci, int Co, int TT, int FF,
                                int n_tiles, int tpc, int chunks, int smem, cudaStream_t s) {
#define DWT_ARGS x, dye, part_w, B, T, F, Ci, Co, TT, FF, n_tiles, tpc, chunks, smem, s
  switch (CS * 1000 + BNO) {
    case 16016: return launch_dw_taps<1, 1, 2, 8>(DWT_ARGS);
    case 16032: return launch_dw_taps<1, 1, 4, 8>(DWT_ARGS);
    case 16064: return launch_dw_taps<1, 2, 4, 4>(DWT_ARGS);
    case 16128: return launch_dw_taps<1, 4, 4, 2>(DWT_ARGS);
    case 32016: return launch_dw_taps<2, 1, 2, 4>(DWT_ARGS);
    case 32032: return launch_dw_taps<2, 1, 4, 4>(DWT_ARGS);
    case 32064: return launch_dw_taps<2, 2, 4, 2>(DWT_ARGS);
    case 32128: return launch_dw_taps<2, 4, 4, 1>(DWT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DWT_ARGS
}

// conv_bn_stats_bwd's dW and dbias in bf16 at Ci = 1: conv_dw_c1_bf16_kernel
cudaError_t launch_dw_c1_bf16(const bf16* x, const bf16* y, const bf16* dy, const float* ds,
                              const float* dq, float* part_w, float* part_b, int B, int T,
                              int F, int Co, int fpb, int blocks, int smem, cudaStream_t s) {
  static int smem_set = 0;
  cudaError_t err = ensure_smem(conv_dw_c1_bf16_kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  conv_dw_c1_bf16_kernel<<<blocks, C1B_THREADS, smem, s>>>(x, y, dy, ds, dq, part_w, part_b, B,
                                                          T, F, Co, fpb);
  return cudaGetLastError();
}

// conv_bn_stats_bwd's dx in bf16: conv3x3_bf16_kernel without STATS over
// the bf16 dy_eff (Co channels in, Ci out) with w flipped
template <int BN, bool VEC>
cudaError_t launch_dx_bf16(const bf16* dye, const bf16* wf, bf16* dx, int B, int T, int F,
                           int Co, int Ci, int TT, int FF, int smem, cudaStream_t s) {
  static int smem_set = 0;
  auto kernel = conv3x3_bf16_kernel<BN, VEC, false>;
  cudaError_t err = ensure_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((T + TT - 1) / TT) * ((F + FF - 1) / FF);
  dim3 grid((unsigned)tiles, (unsigned)((Ci + BN - 1) / BN));
  kernel<<<grid, 256, smem, s>>>(dye, wf, nullptr, dx, nullptr, nullptr, B, T, F, Co, Ci, TT,
                                 FF);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_dx_bf16_bn(int BN, const bf16* dye, const bf16* wf, bf16* dx, int B, int T,
                              int F, int Co, int Ci, int TT, int FF, int smem, cudaStream_t s) {
#define DX16_ARGS dye, wf, dx, B, T, F, Co, Ci, TT, FF, smem, s
  switch (BN) {
    case 8: return launch_dx_bf16<8, VEC>(DX16_ARGS);
    case 16: return launch_dx_bf16<16, VEC>(DX16_ARGS);
    case 32: return launch_dx_bf16<32, VEC>(DX16_ARGS);
    case 64: return launch_dx_bf16<64, VEC>(DX16_ARGS);
    case 128: return launch_dx_bf16<128, VEC>(DX16_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DX16_ARGS
}

// glu_drop_pool_bwd in either type: the kernel, then the lane and dWg passes
template <typename TY>
cudaError_t launch_glu_bwd(const TY* y, const float* scale_f, const float* bias_f, const TY* wg,
                           const TY* wgt, const TY* bg, const uint8_t* bits, const TY* g, TY* dy,
                           float* part_l, float* part_w, float* dscale_f, float* dbias_f,
                           TY* dwg, TY* dbg, int B, int T, int F, int Co, int pt, int pf,
                           int keep_thresh, float inv_keep, const int* plan,
                           cudaStream_t stream) {
  const int CP = plan[0], CT = plan[1], P = plan[2], PG = plan[3];
  const int n_tiles = plan[4], tpb = plan[5], n_blocks = plan[6], smem = plan[7];
  const int KS = plan[8], lanes_smem = plan[9], passes = plan[10], frag = plan[11];
  const int tiles_per_block = tpb;
  // each kernel's shared-memory attribute, set once per size (ensure_smem)
  static int smem_set[7] = {0, 0, 0, 0, 0, 0, 0};
  cudaError_t err;
  bool launched = false;
  if constexpr (std::is_same<TY, bf16>::value) {
    if (frag) {  // glu_bwd_frag_kernel<Co / 8>
      if (Co != 16 && Co != 32 && Co != 64 && Co != 128) return cudaErrorInvalidValue;
      auto kernel = Co == 16 ? glu_bwd_frag_kernel<2>
                    : Co == 32 ? glu_bwd_frag_kernel<4>
                    : Co == 64 ? glu_bwd_frag_kernel<8>
                               : glu_bwd_frag_kernel<16>;
      const int slot = Co == 16 ? 3 : Co == 32 ? 4 : Co == 64 ? 5 : 6;
      if ((err = ensure_smem(kernel, smem, smem_set[slot])) != cudaSuccess) return err;
      kernel<<<n_blocks, GLU_THREADS, smem, stream>>>(GLU_BWD_ARGS);
      launched = true;
    }
  }
  if (!launched) {
    auto kernel = passes > 1 ? glu_bwd_kernel<8, true, TY>
                  : CT == 8  ? glu_bwd_kernel<8, false, TY>
                             : glu_bwd_kernel<4, false, TY>;
    const int slot = passes > 1 ? 0 : CT == 8 ? 1 : 2;
    if ((err = ensure_smem(kernel, smem, smem_set[slot])) != cudaSuccess) return err;
    kernel<<<n_blocks, GLU_THREADS, smem, stream>>>(GLU_BWD_ARGS);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int L = F * Co;
  glu_bwd_final_lanes<<<(L + 255) / 256, 256, 0, stream>>>(part_l, dscale_f, dbias_f, L,
                                                           n_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  glu_bwd_final_w<TY><<<(Co * Co + 255) / 256, 256, 0, stream>>>(part_l, part_w, dwg, dbg, F,
                                                                 Co, n_blocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y = conv3x3_same(x, w) + bias; s, q = per-lane sum / sum of squares of y
// over the B*T rows. part_s/part_q: scratch [n_parts, F*Co]. plan: the ints
// of ops/fused_cnn.py ConvFwdPlan, in its field order.
int conv_bn_stats(const float* x, const float* w, const float* bias, float* y,
                  float* part_s, float* part_q, float* s, float* q, int B, int T, int F,
                  int Ci, int Co, const int* plan, cudaStream_t stream) {
  const int stream_c1 = plan[0], vec = plan[1], bn = plan[2], tt = plan[3], ff = plan[4];
  const int seg = plan[5], smem = plan[6], n_parts = plan[7], rows_per_part = plan[8];
  cudaError_t err;
  if (stream_c1) {
    const int G = (Co + 3) / 4;
    dim3 grid((unsigned)((F * G + 255) / 256), (unsigned)n_parts);
    conv_c1_kernel<float><<<grid, 256, 0, stream>>>(x, w, bias, y, part_s, part_q, B, T, F,
                                                    Co, rows_per_part);
    err = cudaGetLastError();
  } else {
    err = vec ? launch_fwd_bn<4>(bn, seg, x, w, bias, y, part_s, part_q, B, T, F, Ci, Co, tt, ff,
                                 smem, stream)
              : launch_fwd_bn<1>(bn, seg, x, w, bias, y, part_s, part_q, B, T, F, Ci, Co, tt, ff,
                                 smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int L = F * Co;
  lane_stats_final_kernel<<<(L + 31) / 32, 32 * STATS_RUNS, 0, stream>>>(part_s, part_q, s, q,
                                                                        L, n_parts);
  return (int)cudaGetLastError();
}

// z [B, T//pt, F//pf, Co] = pool(drop(GLU(y * scale_f + bias_f))).
// bits: uint8 [B, T, F*Co] or NULL; keep_thresh 256 keeps every element.
// plan: the ints of ops/fused_cnn.py GluFwdPlan, in its field order (no
// launch where it has no tile).
int glu_drop_pool(const float* y, const float* scale_f, const float* bias_f,
                  const float* wg, const float* bg, const uint8_t* bits, float* z,
                  int B, int T, int F, int Co, int pt, int pf,
                  int keep_thresh, float inv_keep, const int* plan, cudaStream_t stream) {
  if (plan[4] == 0) return (int)cudaSuccess;
#define GLU_ARGS y, scale_f, bias_f, wg, bg, bits, z, B, T, F, Co, pt, pf, keep_thresh, inv_keep, plan, stream
  switch (pt * pf) {
    case 1: return (int)launch_glu_fwd<1>(GLU_ARGS);
    case 2: return (int)launch_glu_fwd<2>(GLU_ARGS);
    case 4: return (int)launch_glu_fwd<4>(GLU_ARGS);
    default: return (int)launch_glu_fwd<0>(GLU_ARGS);
  }
}

// conv_bn_stats in bf16: x [B,T,F,Ci], bias [Co] and y bf16; w bf16 as
// [3,3,Ci,Co] (conv3x3_bf16_fwd_kernel, plan kernel 1; conv_c1_bf16_kernel,
// kernel 2; conv_c1_kernel<bf16>, kernel 3) or [3,3,Co,Ci]
// (conv3x3_bf16_kernel, kernel 0); s, q and the partials fp32. plan:
// ops/fused_cnn.py ConvFwdPlan for bf16 (FWD_KERNELS names the kernels).
int conv_bn_stats_bf16(const bf16* x, const bf16* w, const bf16* bias, bf16* y,
                       float* part_s, float* part_q, float* s, float* q, int B, int T, int F,
                       int Ci, int Co, const int* plan, cudaStream_t stream) {
  const int vec = plan[1], bn = plan[2], tt = plan[3], ff = plan[4];
  const int smem = plan[6], n_parts = plan[7], rows_per_part = plan[8];
  const int kernel = plan[9], res = plan[10];
  cudaError_t err;
  if (kernel == 1) {
#define FWD16_ARGS x, w, bias, y, part_s, part_q, B, T, F, Ci, Co, tt, n_parts, smem, stream
    switch (tt * F == FWD16_ROWS ? bn * 2 + res : 0) {
      case 65: err = launch_fwd16<32, true>(FWD16_ARGS); break;
      case 64: err = launch_fwd16<32, false>(FWD16_ARGS); break;
      case 129: err = launch_fwd16<64, true>(FWD16_ARGS); break;
      case 128: err = launch_fwd16<64, false>(FWD16_ARGS); break;
      case 257: err = launch_fwd16<128, true>(FWD16_ARGS); break;
      case 256: err = launch_fwd16<128, false>(FWD16_ARGS); break;
      default: err = cudaErrorInvalidValue;
    }
#undef FWD16_ARGS
  } else if (kernel == 2) {
    err = launch_c1_bf16(x, w, bias, y, part_s, part_q, B, T, F, Co, rows_per_part, n_parts, smem,
                         stream);
  } else if (kernel == 3) {
    const int G = (Co + 3) / 4;
    dim3 grid((unsigned)((F * G + 255) / 256), (unsigned)n_parts);
    conv_c1_kernel<bf16><<<grid, 256, 0, stream>>>(x, w, bias, y, part_s, part_q, B, T, F, Co,
                                                   rows_per_part);
    err = cudaGetLastError();
  } else {
    err = vec ? launch_fwd_bf16_bn<true>(bn, x, w, bias, y, part_s, part_q, B, T, F, Ci, Co, tt,
                                         ff, smem, stream)
              : launch_fwd_bf16_bn<false>(bn, x, w, bias, y, part_s, part_q, B, T, F, Ci, Co,
                                          tt, ff, smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int L = F * Co;
  lane_stats_final_kernel<<<(L + 31) / 32, 32 * STATS_RUNS, 0, stream>>>(part_s, part_q, s, q,
                                                                        L, n_parts);
  return (int)cudaGetLastError();
}

// glu_drop_pool in bf16 (glu_fwd_frag_kernel where plan[11], else
// glu_fwd_ring_kernel): y, wg, bg and z bf16; scale_f, bias_f fp32. plan:
// ops/fused_cnn.py GluBf16Plan, in its field order (CT = plan[0]; no launch
// where it has no tile).
int glu_drop_pool_bf16(const bf16* y, const float* scale_f, const float* bias_f,
                       const bf16* wg, const bf16* bg, const uint8_t* bits, bf16* z,
                       int B, int T, int F, int Co, int pt, int pf,
                       int keep_thresh, float inv_keep, const int* plan, cudaStream_t stream) {
  if (plan[6] == 0) return (int)cudaSuccess;
#define RING_ARGS y, scale_f, bias_f, wg, bg, bits, z, T, F, Co, pt, pf, keep_thresh, inv_keep, plan, stream
  if (plan[11]) {  // the register kernel, Co = 8 NI
#define FRAG_ARGS y, scale_f, bias_f, wg, bg, bits, z, T, F, pt, pf, keep_thresh, inv_keep, plan, stream
    switch (Co) {
      case 16: return (int)launch_glu_fwd_frag<2>(FRAG_ARGS);
      case 32: return (int)launch_glu_fwd_frag<4>(FRAG_ARGS);
      case 64: return (int)launch_glu_fwd_frag<8>(FRAG_ARGS);
      case 128: return (int)launch_glu_fwd_frag<16>(FRAG_ARGS);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FRAG_ARGS
  }
  switch (plan[0]) {  // CT = 8 WN NI
    case 16: return (int)launch_glu_fwd_ring<1, 2>(RING_ARGS);
    case 32: return (int)launch_glu_fwd_ring<2, 2>(RING_ARGS);
    case 64: return (int)launch_glu_fwd_ring<4, 2>(RING_ARGS);
    case 128: return (int)launch_glu_fwd_ring<4, 4>(RING_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RING_ARGS
}
#undef GLU_ARGS

}  // extern "C"

extern "C" {

// Backward of conv_bn_stats. x [B,T,F,Ci], y/dy [B,T,F,Co], ds/dq [F*Co];
// wt [3,3,Co,Ci] = w flipped in (dt, df) and transposed in (Ci, Co);
// dye [B,T,F,Co] scratch for dy_eff (NULL on the Ci = 1 path without dx);
// dx [B,T,F,Ci] (skipped when NULL); part_w [chunks, 9*Ci, Co], part_b
// [chunks, Co] scratch; dw [3,3,Ci,Co]; db [Co]. plan: the ints of
// ops/fused_cnn.py ConvBwdPlan, in its field order.
int conv_bn_stats_bwd(const float* x, const float* wt, const float* y, const float* dy,
                      const float* ds, const float* dq, float* dye, float* dx, float* part_w,
                      float* part_b, float* dw, float* db, int B, int T, int F, int Ci,
                      int Co, const int* plan, cudaStream_t stream) {
  const int stream_dw = plan[0], vec = plan[1];
  const int dx_bn = plan[2], dx_tt = plan[3], dx_ff = plan[4], dx_smem = plan[5];
  const int dw_bko = plan[6], dw_bno = plan[7], dw_tt = plan[8], dw_ff = plan[9];
  const int dw_tiles = plan[10], dw_tpc = plan[11], chunks = plan[12], dw_smem = plan[13];
  const int rows_per_block = plan[14];
  const long long M = (long long)B * T * F;
  cudaError_t err = cudaSuccess;
  if (dye != nullptr) {
    const long long n = M * Co;
    long long blocks = (n / 4 + 255) / 256;
    if (blocks > 4096) blocks = 4096;
    if (blocks < 1) blocks = 1;
    dy_eff_kernel<<<(unsigned)blocks, 256, 0, stream>>>(y, dy, ds, dq, dye, n, F * Co);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (dx != nullptr) {
    err = vec ? launch_dx_bn<4>(dx_bn, dye, wt, dx, B, T, F, Co, Ci, dx_tt, dx_ff, dx_smem, stream)
              : launch_dx_bn<1>(dx_bn, dye, wt, dx, B, T, F, Co, Ci, dx_tt, dx_ff, dx_smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (stream_dw) {
    conv_dw_c1_kernel<float><<<chunks, 256, 0, stream>>>(x, y, dy, ds, dq, part_w, part_b, B,
                                                         T, F, Co, rows_per_block);
    err = cudaGetLastError();
  } else {
    err = vec ? launch_dw_any<4, float>(dw_bko, dw_bno, x, dye, part_w, part_b, B, T, F, Ci, Co,
                                        dw_tt, dw_ff, dw_tiles, dw_tpc, chunks, dw_smem, stream)
              : launch_dw_any<1, float>(dw_bko, dw_bno, x, dye, part_w, part_b, B, T, F, Ci, Co,
                                        dw_tt, dw_ff, dw_tiles, dw_tpc, chunks, dw_smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int KC = 9 * Ci * Co;
  dw_final_kernel<float><<<(KC + 255) / 256, 256, 0, stream>>>(part_w, part_b, dw, db, KC, Co,
                                                               chunks, chunks);
  return (int)cudaGetLastError();
}

// Backward of conv_bn_stats in bf16: x, y, dy bf16 [B,T,F,Ci|Co]; ds, dq
// fp32; wf = w flipped in (dt, df), bf16 [3,3,Ci,Co] (NULL without dx);
// dye bf16 scratch (rounded dy_eff), dx bf16; part_w [chunks, 9*Ci, Co] and
// part_b fp32 scratch ([eff_blocks, Co], or [chunks, Co] on the Ci = 1
// path, whose kernel sums dbias itself); dw, db bf16. plan: ConvBwdPlan
// for bf16 (dx_vec, eff_blocks, eff_rows, dw_cs at 15-18; dw_cs > 0: dW on
// the tensor cores, conv_dw_taps_kernel, [9 taps x dw_cs] x dw_bno a block;
// stream: conv_dw_c1_bf16_kernel, `chunks` blocks of dw_tt frames).
int conv_bn_stats_bwd_bf16(const bf16* x, const bf16* wf, const bf16* y, const bf16* dy,
                           const float* ds, const float* dq, bf16* dye, bf16* dx, float* part_w,
                           float* part_b, bf16* dw, bf16* db, int B, int T, int F, int Ci,
                           int Co, const int* plan, cudaStream_t stream) {
  const int stream_dw = plan[0], vec = plan[1];
  const int dx_bn = plan[2], dx_tt = plan[3], dx_ff = plan[4], dx_smem = plan[5];
  const int dw_bko = plan[6], dw_bno = plan[7], dw_tt = plan[8], dw_ff = plan[9];
  const int dw_tiles = plan[10], dw_tpc = plan[11], chunks = plan[12], dw_smem = plan[13];
  const int dx_vec = plan[15], eff_blocks = plan[16], eff_rows = plan[17], dw_cs = plan[18];
  const long long M = (long long)B * T * F;
  cudaError_t err = cudaSuccess;
  if (dye != nullptr) {
    dy_eff_bf16_kernel<<<eff_blocks, EFF_THREADS, 0, stream>>>(
        y, dy, ds, dq, dye, stream_dw ? nullptr : part_b, M, F, Co, eff_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (dx != nullptr) {
    err = dx_vec ? launch_dx_bf16_bn<true>(dx_bn, dye, wf, dx, B, T, F, Co, Ci, dx_tt, dx_ff,
                                           dx_smem, stream)
                 : launch_dx_bf16_bn<false>(dx_bn, dye, wf, dx, B, T, F, Co, Ci, dx_tt, dx_ff,
                                            dx_smem, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (stream_dw) {
    err = launch_dw_c1_bf16(x, y, dy, ds, dq, part_w, part_b, B, T, F, Co, dw_tt, chunks,
                            dw_smem, stream);
  } else if (dw_cs > 0) {
    err = launch_dw_taps_tile(dw_cs, dw_bno, x, dye, part_w, B, T, F, Ci, Co, dw_tt, dw_ff,
                              dw_tiles, dw_tpc, chunks, dw_smem, stream);
  } else {
    err = vec ? launch_dw_any<4, bf16>(dw_bko, dw_bno, x, dye, part_w, part_b, B, T, F, Ci, Co,
                                       dw_tt, dw_ff, dw_tiles, dw_tpc, chunks, dw_smem, stream)
              : launch_dw_any<1, bf16>(dw_bko, dw_bno, x, dye, part_w, part_b, B, T, F, Ci, Co,
                                       dw_tt, dw_ff, dw_tiles, dw_tpc, chunks, dw_smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  const int KC = 9 * Ci * Co;
  dw_final_kernel<bf16><<<(KC + 255) / 256, 256, 0, stream>>>(
      part_w, part_b, dw, db, KC, Co, chunks, stream_dw ? chunks : eff_blocks);
  return (int)cudaGetLastError();
}

// Backward of glu_drop_pool. g [B, T//pt, F//pf, Co]; dy like y;
// part_l [n_blocks, 3, F*Co], part_w [n_blocks, Co*Co] scratch;
// dscale_f, dbias_f [F*Co]; dwg [Co, Co]; dbg [Co]. plan: the ints of
// ops/fused_cnn.py GluBwdPlan, in its field order.
int glu_drop_pool_bwd(const float* y, const float* scale_f, const float* bias_f,
                      const float* wg, const float* wgt, const float* bg, const uint8_t* bits,
                      const float* g, float* dy, float* part_l, float* part_w, float* dscale_f,
                      float* dbias_f, float* dwg, float* dbg, int B, int T, int F, int Co,
                      int pt, int pf, int keep_thresh, float inv_keep, const int* plan,
                      cudaStream_t stream) {
  return (int)launch_glu_bwd<float>(y, scale_f, bias_f, wg, wgt, bg, bits, g, dy, part_l, part_w,
                                    dscale_f, dbias_f, dwg, dbg, B, T, F, Co, pt, pf, keep_thresh,
                                    inv_keep, plan, stream);
}

// Backward of glu_drop_pool in bf16: y, wg, wgt, bg, g, dy, dwg, dbg bf16;
// scale_f, bias_f, the partials, dscale_f and dbias_f fp32. plan: GluBwdPlan.
int glu_drop_pool_bwd_bf16(const bf16* y, const float* scale_f, const float* bias_f,
                           const bf16* wg, const bf16* wgt, const bf16* bg, const uint8_t* bits,
                           const bf16* g, bf16* dy, float* part_l, float* part_w,
                           float* dscale_f, float* dbias_f, bf16* dwg, bf16* dbg, int B, int T,
                           int F, int Co, int pt, int pf, int keep_thresh, float inv_keep,
                           const int* plan, cudaStream_t stream) {
  return (int)launch_glu_bwd<bf16>(y, scale_f, bias_f, wg, wgt, bg, bits, g, dy, part_l, part_w,
                                   dscale_f, dbias_f, dwg, dbg, B, T, F, Co, pt, pf, keep_thresh,
                                   inv_keep, plan, stream);
}

}  // extern "C"
