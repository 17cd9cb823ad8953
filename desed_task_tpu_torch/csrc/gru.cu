// Hand-written Hopper kernels for the bidirectional GRU recurrence (fp32).
//
// Per step and direction, from precomputed input gates xg = x W_ih^T + b_ih
// (torch r/z/n order):
//   r = sigmoid(xr + h Wr + br), z = sigmoid(xz + h Wz + bz),
//   n = tanh(xn + r * (h Wn + bn)), h' = (1 - z) n + z h.
// The backward direction walks time in reverse and writes its states in the
// original time order.
//
// bigru_fwd_cluster replaces desed_task_tpu/ops/pallas_gru.py _fwd_kernel
// (pallas_gru.py:38, called from _run_fwd at :146). bigru_bwd_cluster
// replaces _bwd_kernel (pallas_gru.py:58, called from _bigru_core_bwd at
// :178). bigru_fwd / bigru_bwd (the "stream" kernels) take the hidden sizes
// whose W_hh slices do not fit a cluster's registers and shared memory;
// ops/gru.py bigru_plan chooses by shape alone.
//
// What bounds them: the T steps are sequential, and per step one direction
// does 2*B*3H*H FLOP against all of W_hh (3*H*H fp32: 432 KiB at H=192).
// Over a call that is ~2.2 GFLOP (forward, B=64, T=156) and ~30 MB, far from
// the card's FLOP and memory rates: the latency of the step chain bounds it.
// One block cannot hold W_hh in its 227 KB of shared memory, so a single
// block per (direction, batch tile) streams it from L2 on every step (the
// stream kernels), on 16 of the 132 SMs.
//
// Design of the cluster kernels: one thread-block cluster of C CTAs per
// (direction, tile of BT = 8 batch rows); ops/gru.py takes C = 6 (at H=192,
// 96 CTAs, one per SM). CTA c owns the hidden units
// U_c = [c*Uc, min(H, (c+1)*Uc)) and keeps the W_hh rows {r, z, n} x U_c on
// chip for all T steps, in its product threads' registers (at most 48 a
// thread, loaded once from a [depth][column] block the wrapper packs:
// ops/gru.py cluster_layout, pack_weights); shared memory holds h, the
// depth-block partials and the cp.async ring of the next steps' operands.
// The product splits the depth in KS blocks, one per warp group: a warp
// reads one operand row by broadcast against its 32 threads' weights, and
// the KS partials are added in block order where they are used. Per forward
// step each CTA computes its 3*Uc gate columns for the BT rows, applies the
// gate math to its own units and pushes h' into the double-buffered h of every CTA of the cluster
// (distributed shared memory stores), then passes one cluster barrier:
// arrive.release; the global stores of out[b, t, U_c] and the cp.async
// prefetch of step t+2's input gates; wait.acquire. No global access sits on
// the step chain, and no global store comes before a release.
//
// The backward is three kernels:
//   bigru_hg_kernel: G = h_prev W_hh^T + b_hh for all B*T rows at once, a
//     tiled fp32 product over all SMs; h_prev is the saved output shifted by
//     one step (zero at the sequence start), so this part of the TPU
//     kernel's step (pallas_gru.py:80-82) leaves the serial chain. For r and
//     z it stores the pre-activation xg + G, for n G alone.
//   bigru_bwd_cluster_kernel: clusters laid out as in the forward, CTA c
//     keeping the same W_hh rows. Per step it reads the pre-activations, xn,
//     G_n, h_prev and dout of its units (prefetched two steps ahead with
//     cp.async) and the carried dh, forms dxg, the hidden-side gate gradients
//     dg = (dr_in, dz_in, dn_in * r) and dh_tot * z (pallas_gru.py:87-120),
//     and its partial of dg W_hh for all H units, pushed to each unit's
//     owner; after the cluster barrier each CTA adds the partials of its
//     units in rank order, depth blocks in order: no atomics, reruns bitwise
//     equal. dg overwrites G in place (the CTA's own cp.async read of a G
//     entry has completed before it writes dg there).
//   bigru_dw_kernel + bigru_dw_reduce_kernel: dW_hh = sum over (b, t) of
//     dg^T h_prev and db_hh = sum of dg, rows split in S chunks (a grid over
//     all SMs), per-chunk partials added in chunk order by a second pass.
// Rows past B (B=60 is not a multiple of BT) hold zeros and write nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 8;     // batch rows per cluster (ops/gru.py CLUSTER_ROWS)
constexpr int NSLOT = 3;  // cp.async ring: the step in use and two ahead
constexpr int KC_MAX = 48;  // depth rows of a product thread's weights (registers)
constexpr int ERR_NO_CLUSTER = 10001;  // a cluster of this shape cannot be resident

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
// Copies of 16 bytes when the rows allow them (H and Uc multiples of 4,
// 16-byte aligned bases), else of 4.
__device__ __forceinline__ bool vec4_rows(int H, int Uc, const float* a, const float* b,
                                          const float* c, const float* d) {
  const unsigned long long m = (unsigned long long)a | (unsigned long long)b |
                               (unsigned long long)c | (unsigned long long)d;
  return H % 4 == 0 && Uc % 4 == 0 && m % 16 == 0;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group done
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// A product thread's weights: column n of depth block ks of the CTA's block
// [KS*KC][NP] (ops/gru.py pack_weights), wr[kk] = w[(ks*KC + kk)*NP + n],
// zero past KC. They stay in registers for all T steps.
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int n, int ks,
                                             int KC, int NP, float (&wr)[KC_MAX]) {
#pragma unroll
  for (int kk = 0; kk < KC_MAX; ++kk)
    wr[kk] = kk < KC ? w[(long long)(ks * KC + kk) * NP + n] : 0.f;
}

// acc[b] = sum over kk < KC of a[kk*BT + b] * wr[kk], kk in order, for the
// operand rows a of one depth block. All lanes of a warp take one depth
// block, so each operand row is one broadcast read.
__device__ __forceinline__ void block_product(const float* __restrict__ a,
                                              const float (&wr)[KC_MAX], int KC,
                                              float (&acc)[BT]) {
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KC_MAX; ++kk) {
    if (kk < KC) {
      const float4* a4 = reinterpret_cast<const float4*>(a + kk * BT);
#pragma unroll
      for (int q = 0; q < BT / 4; ++q) {
        const float4 v = a4[q];
        acc[4 * q + 0] = fmaf(v.x, wr[kk], acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, wr[kk], acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, wr[kk], acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, wr[kk], acc[4 * q + 3]);
      }
    }
  }
}

__device__ __forceinline__ void store_rows(float* dst, const float (&v)[BT]) {
#pragma unroll
  for (int q = 0; q < BT / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
}

// Forward. Grid (C, ceil(B/BT), 2), clusters of (C, 1, 1): blockIdx.x is the
// rank in the cluster, blockIdx.y the batch tile, blockIdx.z the direction.
// Warp w of the product takes depth block ks = w / (NP/32) and 32 columns;
// thread (ks, j) keeps its column's KC weights in registers.
// Shared memory (floats): h [2][KS*KC][BT] (h^T, zero past H) | red
// [KS][NP][BT] (depth-block partials) | xs [NSLOT][3][BT][Uc] | bias [3][Uc].
__global__ void __launch_bounds__(512) bigru_fwd_cluster_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ wpack,  // [2, C, KS*KC*NP]
    const float* __restrict__ bhh,    // [2, 3H]
    float* __restrict__ out_f, float* __restrict__ out_b, int B, int T, int H, int Uc,
    int KS, int KC, int NP) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x;
  const int rank = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int d = blockIdx.z;
  const int H3 = 3 * H;
  const int U0 = rank * Uc;
  const int nu = max(0, min(H, U0 + Uc) - U0);
  const int HBUF = KS * KC * BT;
  const int XS = 3 * Uc * BT;
  float* hbuf = smem;
  float* red = hbuf + 2 * HBUF;
  float* xs = red + KS * NP * BT;
  float* bias_s = xs + NSLOT * XS;
  const float* xg = d == 0 ? xg_f : xg_b;
  float* out = d == 0 ? out_f : out_b;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int pj = tid % NP;  // the product thread's column and depth block
  const int pks = tid / NP;
  float wr[KC_MAX];
  if (pks < KS)
    load_weights(wpack + ((long long)d * C + rank) * KS * KC * NP, pj, pks, KC, NP, wr);
  for (int i = tid; i < 2 * HBUF; i += nt) hbuf[i] = 0.f;
  for (int i = tid; i < 3 * Uc; i += nt) {
    const int gate = i / Uc;
    const int u = i - gate * Uc;
    bias_s[i] = u < nu ? bhh[d * H3 + gate * H + U0 + u] : 0.f;
  }

  // the input gates of step s into ring slot s % NSLOT, laid out [gate][b][u]
  const bool vec = vec4_rows(H, Uc, xg, xg, xg, xg);
  const int wc = vec ? 4 : 1;  // floats per copy
  const int nw = Uc / wc;      // copies per row
  auto prefetch = [&](int s) {
    if (s < T) {
      const int t = d == 0 ? s : T - 1 - s;
      float* dst = xs + (s % NSLOT) * XS;
      for (int i = tid; i < 3 * BT * nw; i += nt) {
        const int r = i / nw;  // gate * BT + b
        const int u = (i - r * nw) * wc;
        const int bb = b0 + r % BT;
        const bool ok = bb < B && u < nu;
        const float* src = xg + ((long long)bb * T + t) * H3 + (r / BT) * H + U0 + u;
        if (vec)
          cp_async16(dst + r * Uc + u, ok ? src : xg, ok);
        else
          cp_async4(dst + r * Uc + u, ok ? src : xg, ok);
      }
    }
    cp_async_commit();  // an empty group past T keeps the count uniform
  };
  prefetch(0);
  prefetch(1);
  cp_async_wait_one();
  // every CTA has started and zeroed its h before any push; step 0's input
  // gates are in place. Each step's cluster barrier does the same for the
  // next step: its arrive follows the wait for that step's copies.
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? s : T - 1 - s;
    const float* hc = hbuf + (s & 1) * HBUF;
    float* hn = hbuf + ((s + 1) & 1) * HBUF;
    // gate columns j = gate*Uc + u: red[ks][j][b] = the depth block ks of
    // sum_k h[b][k] W_hh[gate*H + U0 + u][k]
    if (pks < KS) {
      float acc[BT];
      block_product(hc + pks * KC * BT, wr, KC, acc);
      store_rows(red + (pks * NP + pj) * BT, acc);
    }
    __syncthreads();
    const float* x = xs + (s % NSLOT) * XS;
    for (int i = tid; i < nu * BT; i += nt) {
      const int u = i / BT;
      const int b = i - u * BT;
      float g[3];
#pragma unroll
      for (int gate = 0; gate < 3; ++gate) {  // depth blocks added in order
        const float* p = red + (gate * Uc + u) * BT + b;
        float v = p[0];
        for (int ks = 1; ks < KS; ++ks) v += p[ks * NP * BT];
        g[gate] = v + bias_s[gate * Uc + u];
      }
      const int ix = b * Uc + u;
      const float r = sigmoidf(x[ix] + g[0]);
      const float z = sigmoidf(x[XS / 3 + ix] + g[1]);
      const float n = tanhf(x[2 * XS / 3 + ix] + r * g[2]);
      const int off = (U0 + u) * BT + b;
      const float h = (1.f - z) * n + z * hc[off];
      for (int c = 0; c < C; ++c) cluster.map_shared_rank(hn, c)[off] = h;
    }
    cp_async_wait_all();  // step s + 1's input gates
    cluster_arrive();
    // off the step chain: the outputs of this step, the input gates of s + 2
    for (int i = tid; i < nu * BT; i += nt) {
      const int u = i / BT;
      const int bb = b0 + i - u * BT;
      if (bb < B) out[((long long)bb * T + t) * H + U0 + u] = hn[(U0 + u) * BT + i - u * BT];
    }
    prefetch(s + 2);
    cluster_wait();  // all of h' is in every CTA; the last one doubles as the exit sync
  }
}

// Backward, serial part. Grid and clusters as in the forward; thread (ks, v)
// keeps in registers its column v of the rows {r,z,n} x U_c of W_hh (depth
// k = gate*Uc + u), depth block ks.
// Shared memory (floats): dg [KS*KC][BT] | part [2][C][KS][Uc][BT] |
// dhz [Uc][BT] | dn [Uc][BT] | st [NSLOT][6][BT][Uc] (the pre-activations
// xr + Gr and xz + Gz, xn, Gn, h_prev, dout).
__global__ void __launch_bounds__(512) bigru_bwd_cluster_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ wpack,  // [2, C, KS*KC*NP]
    const float* __restrict__ out_f, const float* __restrict__ out_b,
    const float* __restrict__ dout_f, const float* __restrict__ dout_b,
    float* __restrict__ dxg_f, float* __restrict__ dxg_b,
    float* __restrict__ gd,  // [2, B, T, 3H]: (xr + Gr, xz + Gz, Gn) in, dg out (in place)
    int B, int T, int H, int Uc, int KS, int KC, int NP) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x;
  const int rank = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int d = blockIdx.z;
  const int H3 = 3 * H;
  const int U0 = rank * Uc;
  const int nu = max(0, min(H, U0 + Uc) - U0);
  const int UB = Uc * BT;
  const int ST = 6 * UB;
  float* dg_s = smem;
  float* part = dg_s + KS * KC * BT;
  float* dhz = part + 2 * C * KS * UB;
  float* dn_s = dhz + UB;
  float* st = dn_s + UB;
  const float* xg = d == 0 ? xg_f : xg_b;
  const float* out = d == 0 ? out_f : out_b;
  const float* dout = d == 0 ? dout_f : dout_b;
  float* dxg = d == 0 ? dxg_f : dxg_b;
  float* gdd = gd + (long long)d * B * T * H3;
  const int shift = d == 0 ? -1 : 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int pv = tid % NP;  // the product thread's unit column and depth block
  const int pks = tid / NP;
  float wr[KC_MAX];
  if (pks < KS)
    load_weights(wpack + ((long long)d * C + rank) * KS * KC * NP, pv, pks, KC, NP, wr);
  for (int i = tid; i < KS * KC * BT; i += nt) dg_s[i] = 0.f;

  // step s's operands into ring slot s % NSLOT, laid out [q][b][u]
  const bool vec = vec4_rows(H, Uc, xg, gdd, out, dout);
  const int wc = vec ? 4 : 1;  // floats per copy
  const int nw = Uc / wc;      // copies per row
  auto prefetch = [&](int s) {
    if (s < T) {
      const int t = d == 0 ? T - 1 - s : s;
      const int tp = t + shift;
      const bool has_prev = tp >= 0 && tp < T;
      float* dst = st + (s % NSLOT) * ST;
      for (int i = tid; i < 6 * BT * nw; i += nt) {
        const int r = i / nw;  // q * BT + b
        const int u = (i - r * nw) * wc;
        const int q = r / BT;
        const int bb = b0 + r - q * BT;
        bool ok = bb < B && u < nu;
        const long long row = (long long)bb * T + t;
        const float* src;
        if (q == 0 || q == 1 || q == 3) {
          src = gdd + row * H3 + (q == 3 ? 2 : q) * H + U0 + u;
        } else if (q == 2) {
          src = xg + row * H3 + 2 * H + U0 + u;
        } else if (q == 4) {
          src = out + (row + shift) * H + U0 + u;
          ok = ok && has_prev;
        } else {
          src = dout + row * H + U0 + u;
        }
        if (vec)
          cp_async16(dst + r * Uc + u, ok ? src : xg, ok);
        else
          cp_async4(dst + r * Uc + u, ok ? src : xg, ok);
      }
    }
    cp_async_commit();
  };
  prefetch(0);
  prefetch(1);
  cp_async_wait_one();
  cluster.sync();  // as in the forward: started, zeroed, step 0's operands in place

  for (int s = 0; s < T; ++s) {
    const int t = d == 0 ? T - 1 - s : s;
    const float* sb = st + (s % NSLOT) * ST;
    const float* pp = part + ((s + 1) & 1) * C * KS * UB;  // the partials of step s - 1
    for (int i = tid; i < nu * BT; i += nt) {
      const int u = i / BT;
      const int b = i - u * BT;
      const int si = b * Uc + u;
      float dh = 0.f;
      if (s > 0) {  // ranks, then depth blocks, in order
        float p = pp[i];
        for (int c = 1; c < C * KS; ++c) p += pp[c * UB + i];
        dh = dhz[i] + p;
      }
      const float r = sigmoidf(sb[si]);
      const float z = sigmoidf(sb[UB + si]);
      const float hg = sb[3 * UB + si];
      const float n = tanhf(sb[2 * UB + si] + r * hg);
      const float dht = b0 + b < B ? dh + sb[5 * UB + si] : 0.f;
      const float dnin = dht * (1.f - z) * (1.f - n * n);
      const float dzin = dht * (sb[4 * UB + si] - n) * z * (1.f - z);
      dg_s[i] = dnin * hg * r * (1.f - r);  // dr_in
      dg_s[UB + i] = dzin;
      dg_s[2 * UB + i] = dnin * r;  // the hidden-side n gradient
      dn_s[i] = dnin;               // n = tanh(xn + r hn): the pre-tanh gradient
      dhz[i] = dht * z;
    }
    __syncthreads();
    // this CTA's part of dg W_hh for every unit v, depth block ks, pushed to
    // v's owner
    if (pks < KS) {
      float acc[BT];
      block_product(dg_s + pks * KC * BT, wr, KC, acc);
      if (pv < H) {
        const int o = pv / Uc;
        const int u = pv - o * Uc;
        store_rows(cluster.map_shared_rank(
                           part + (((s & 1) * C + rank) * KS + pks) * UB + u * BT, o),
                       acc);
      }
    }
    cp_async_wait_all();  // step s + 1's operands
    cluster_arrive();
    // off the step chain: dxg and dg of this step, the operands of step s + 2
    for (int i = tid; i < nu * BT; i += nt) {
      const int u = i / BT;
      const int bb = b0 + i - u * BT;
      if (bb >= B) continue;
      const long long row = (long long)bb * T + t;
      float* dx = dxg + row * H3 + U0 + u;
      float* dgo = gdd + row * H3 + U0 + u;
      dx[0] = dgo[0] = dg_s[i];
      dx[H] = dgo[H] = dg_s[UB + i];
      dx[2 * H] = dn_s[i];
      dgo[2 * H] = dg_s[2 * UB + i];
    }
    prefetch(s + 2);
    cluster_wait();
  }
}

// acc[i][j] += sum over k < BK of As[k][ty*4 + i] * Bs[k][tx*4 + j], k in order.
template <int BK, int LD>
__device__ __forceinline__ void tile_fma(const float (*As)[LD], const float (*Bs)[LD], int ty,
                                         int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// G[d][r][j] = bhh[d][j] + sum_k h_prev[d][r][k] * W[d][j][k], r = b*T + t,
// h_prev[d][r] = out_d[b][t + shift] (zero outside [0, T)); for the r and z
// gates (j < 2H) the input gate is added, xg[d][r][j] + G, the pre-activation.
// 64x64 tiles, 16-deep stages double-buffered (the next stage's loads are in
// flight during this stage's FMAs), 4x4 outputs per thread, k in order.
__global__ void __launch_bounds__(256) bigru_hg_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ out_f, const float* __restrict__ out_b,
    const float* __restrict__ w,    // [2, 3H, H]
    const float* __restrict__ bhh,  // [2, 3H]
    float* __restrict__ G, int B, int T, int H) {
  constexpr int BM = 64, BN = 64, BK = 16, LD = 68;
  __shared__ __align__(16) float As[2][BK][LD];
  __shared__ __align__(16) float Bs[2][BK][LD];
  const int H3 = 3 * H;
  const int d = blockIdx.z;
  const long long r0 = (long long)blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const long long R = (long long)B * T;
  const float* out = d == 0 ? out_f : out_b;
  const float* wd = w + (long long)d * H3 * H;
  const int shift = d == 0 ? -1 : 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // this thread loads depth kk of rows / columns tid/BK + 16e, e < 4
  const int kk = tid % BK;
  const float* pa[4];
  const float* pb[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long row = r0 + tid / BK + 16 * e;
    const int tp = (int)(row % T) + shift;
    pa[e] = row < R && tp >= 0 && tp < T ? out + (row + shift) * H + kk : nullptr;
    const int j = j0 + tid / BK + 16 * e;
    pb[e] = j < H3 ? wd + (long long)j * H + kk : nullptr;
  }
  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ra[e] = pa[e] && k0 + kk < H ? pa[e][k0] : 0.f;
      rb[e] = pb[e] && k0 + kk < H ? pb[e][k0] : 0.f;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0, buf = 0; k0 < H; k0 += BK, buf ^= 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[buf][kk][tid / BK + 16 * e] = ra[e];
      Bs[buf][kk][tid / BK + 16 * e] = rb[e];
    }
    __syncthreads();
    if (k0 + BK < H) load(k0 + BK);
    tile_fma<BK, LD>(As[buf], Bs[buf], ty, tx, acc);
  }
  float* Gd = G + (long long)d * R * H3;
  const float* xg = d == 0 ? xg_f : xg_b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = r0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (jj >= H3) continue;
      const float g = acc[i][j] + bhh[d * H3 + jj];
      Gd[row * H3 + jj] = jj < 2 * H ? xg[row * H3 + jj] + g : g;
    }
  }
}

// Chunk c of the rows [c*RC, min(R, (c+1)*RC)):
// part[c][d][j][u] = sum_r dg[d][r][j] * h_prev[d][r][u] and, after the
// 2*3H*H weight entries, part[c][d][j] = sum_r dg[d][r][j]. A 64x64 tile per
// block (4x4 per thread), 16 rows per stage double-buffered, rows in order.
__global__ void __launch_bounds__(256) bigru_dw_kernel(
    const float* __restrict__ dgh, const float* __restrict__ out_f,
    const float* __restrict__ out_b, float* __restrict__ part, int B, int T, int H, int RC) {
  constexpr int BJ = 64, BU = 64, BR = 16, LD = 68;
  __shared__ __align__(16) float As[2][BR][LD];
  __shared__ __align__(16) float Bs[2][BR][LD];
  const int H3 = 3 * H;
  const int d = blockIdx.z & 1;
  const int chunk = blockIdx.z >> 1;
  const int j0 = blockIdx.x * BJ;
  const int u0 = blockIdx.y * BU;
  const long long R = (long long)B * T;
  const long long rbeg = (long long)chunk * RC;
  const long long rend = rbeg + RC < R ? rbeg + RC : R;
  const float* dg = dgh + (long long)d * R * H3;
  const float* out = d == 0 ? out_f : out_b;
  const int shift = d == 0 ? -1 : 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const bool do_bias = blockIdx.y == 0 && tid < BJ;
  // this thread loads column tid % 64 of stage rows tid/64 + 4e, e < 4
  const int col = tid % BJ;
  const bool ja = j0 + col < H3;
  const bool ub = u0 + col < H;
  int tr[4];  // t of the thread's rows, kept without a division per stage
#pragma unroll
  for (int e = 0; e < 4; ++e) tr[e] = (int)((rbeg + tid / BJ + 4 * e) % T);
  float ra[4], rb[4];
  auto load = [&](long long r0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long row = r0 + tid / BJ + 4 * e;
      const int tp = tr[e] + shift;
      ra[e] = row < rend && ja ? dg[row * H3 + j0 + col] : 0.f;
      rb[e] = row < rend && ub && tp >= 0 && tp < T ? out[(row + shift) * H + u0 + col] : 0.f;
      tr[e] += BR;
      while (tr[e] >= T) tr[e] -= T;
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  load(rbeg);
  int buf = 0;
  for (long long r0 = rbeg; r0 < rend; r0 += BR, buf ^= 1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[buf][tid / BJ + 4 * e][col] = ra[e];
      Bs[buf][tid / BJ + 4 * e][col] = rb[e];
    }
    __syncthreads();
    if (r0 + BR < rend) load(r0 + BR);
    tile_fma<BR, LD>(As[buf], Bs[buf], ty, tx, acc);
    if (do_bias) {
#pragma unroll
      for (int r = 0; r < BR; ++r) bsum += As[buf][r][tid];
    }
  }
  float* p = part + (long long)chunk * (2 * H3 * H + 2 * H3);
  float* dwd = p + (long long)d * H3 * H;
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
  if (do_bias && j0 + tid < H3) p[2 * H3 * H + d * H3 + j0 + tid] = bsum;
}

// dwdb[i] = sum over chunks c = 0..S-1, in order, of part[c][i].
__global__ void bigru_dw_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dwdb, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int c = 1; c < S; ++c) v += part[(long long)c * n + i];
  dwdb[i] = v;
}

int launch_dw(const float* dgh, const float* out_f, const float* out_b, float* part,
              float* dwdb, int B, int T, int H, int S, cudaStream_t stream) {
  const long long R = (long long)B * T;
  const int RC = (int)((R + S - 1) / S);
  dim3 grid((3 * H + 63) / 64, (H + 63) / 64, 2 * S);
  bigru_dw_kernel<<<grid, 256, 0, stream>>>(dgh, out_f, out_b, part, B, T, H, RC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * 3 * H * H + 2 * 3 * H;
  bigru_dw_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part, dwdb, n, S);
  return (int)cudaGetLastError();
}

// A cluster launch of `kern` on grid (C, ceil(B/BT), 2); refuses (with
// ERR_NO_CLUSTER) a shape of which no cluster can be resident on the card.
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kern, int C, int B, int threads, int smem,
                   cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + BT - 1) / BT, 2);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return ERR_NO_CLUSTER;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- the stream kernels (hidden sizes whose slices do not fit a cluster) ----

constexpr int BT_S = 8;  // batch rows per block

// acc[b] += sum over k < H of h[b * ldh + k] * wt[k * ld + j], k in order:
// each weight, loaded through const __restrict__ pointers with 8 in flight
// per thread, feeds BT_S FMAs. The callers pad the rows of h to HP floats, a
// multiple of 4 (zeros past H).
__device__ __forceinline__ void row_times_col(const float* __restrict__ h, int ldh,
                                              const float* __restrict__ wt, int ld, int j,
                                              int H, float (&acc)[BT_S]) {
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    const float wv = wt[(long long)k * ld + j];
#pragma unroll
    for (int b = 0; b < BT_S; ++b) acc[b] = fmaf(h[b * ldh + k], wv, acc[b]);
  }
}

// One block per (direction, tile of BT_S rows), W_hh^T streamed from L2 per step.
__global__ void __launch_bounds__(1024) bigru_fwd_kernel(const float* __restrict__ xg_f,
                                 const float* __restrict__ xg_b,
                                 const float* __restrict__ wt,   // [2, H, 3H]
                                 const float* __restrict__ bhh,  // [2, 3H]
                                 float* __restrict__ out_f,      // [B, T, H]
                                 float* __restrict__ out_b,
                                 int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const int HP = (H + 3) & ~3;
  float* h_s = smem;               // [BT_S][HP]
  float* g_s = smem + BT_S * HP;   // [BT_S][3H]
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT_S;
  const int H3 = 3 * H;
  const float* xg = d == 0 ? xg_f : xg_b;
  float* out = d == 0 ? out_f : out_b;
  const float* w = wt + (long long)d * H * H3;
  const float* bias = bhh + d * H3;

  for (int i = threadIdx.x; i < BT_S * HP; i += blockDim.x) h_s[i] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT_S];
#pragma unroll
      for (int b = 0; b < BT_S; ++b) acc[b] = 0.f;
      row_times_col(h_s, HP, w, H3, j, H, acc);
      const float bj = bias[j];
#pragma unroll
      for (int b = 0; b < BT_S; ++b) g_s[b * H3 + j] = acc[b] + bj;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT_S * H; i += blockDim.x) {
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

// Reverse-time BPTT, one block per (direction, tile of BT_S rows): each step
// recomputes h_prev W_hh^T + b_hh, forms dxg and the hidden-side gate
// gradients (written to dgh for bigru_dw_kernel), and dh_prev = dh z + dg W_hh.
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
  float* h_s = smem;                   // [BT_S][HP]    h_prev (zeros past H)
  float* g_s = h_s + BT_S * HP;        // [BT_S][3H]    h_prev W_hh^T + b_hh
  float* dg_s = g_s + BT_S * H3;       // [BT_S][3][HP] hidden-side gate gradients
  float* dh_s = dg_s + BT_S * 3 * HP;  // [BT_S][H]     dL/dh carried backwards in time
  float* dhz_s = dh_s + BT_S * H;      // [BT_S][H]     dh_tot * z
  float* dhp_s = dhz_s + BT_S * H;     // [3][BT_S][H]  dg W_hh, one part per gate
  const int d = blockIdx.y;
  const int b0 = blockIdx.x * BT_S;
  const float* xg = d == 0 ? xg_f : xg_b;
  const float* out = d == 0 ? out_f : out_b;
  const float* dout = d == 0 ? dout_f : dout_b;
  float* dxg = d == 0 ? dxg_f : dxg_b;
  float* dgd = dgh + (long long)d * B * T * H3;
  const float* wtd = wt + (long long)d * H * H3;
  const float* wd = w + (long long)d * H3 * H;
  const float* bias = bhh + d * H3;
  const int shift = d == 0 ? -1 : 1;

  for (int i = threadIdx.x; i < BT_S * HP; i += blockDim.x) h_s[i] = 0.f;
  for (int i = threadIdx.x; i < BT_S * 3 * HP; i += blockDim.x) dg_s[i] = 0.f;
  for (int i = threadIdx.x; i < BT_S * H; i += blockDim.x) dh_s[i] = 0.f;

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? T - 1 - step : step;
    const int tp = t + shift;
    const bool has_prev = tp >= 0 && tp < T;
    __syncthreads();  // the previous step's dh is complete
    for (int i = threadIdx.x; i < BT_S * H; i += blockDim.x) {
      const int b = i / H;
      const int u = i - b * H;
      const int bb = b0 + b;
      h_s[b * HP + u] = (bb < B && has_prev) ? out[((long long)bb * T + tp) * H + u] : 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < H3; j += blockDim.x) {
      float acc[BT_S];
#pragma unroll
      for (int b = 0; b < BT_S; ++b) acc[b] = 0.f;
      row_times_col(h_s, HP, wtd, H3, j, H, acc);
      const float bj = bias[j];
#pragma unroll
      for (int b = 0; b < BT_S; ++b) g_s[b * H3 + j] = acc[b] + bj;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT_S * H; i += blockDim.x) {
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
      dx[2 * H + u] = dnin;
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
      float acc[BT_S];
#pragma unroll
      for (int b = 0; b < BT_S; ++b) acc[b] = 0.f;
      row_times_col(dg_s + gate * HP, 3 * HP, wd + (long long)gate * H * H, H, u, H, acc);
#pragma unroll
      for (int b = 0; b < BT_S; ++b) dhp_s[(gate * BT_S + b) * H + u] = acc[b];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BT_S * H; i += blockDim.x) {
      dh_s[i] = dhz_s[i] + dhp_s[i] + dhp_s[BT_S * H + i] + dhp_s[2 * BT_S * H + i];
    }
  }
}

}  // namespace

extern "C" {

// Cluster forward. xg_f/xg_b [B, T, 3H]; wpack [2, C, KS*KC*NP] (ops/gru.py
// pack_weights, "fwd"); bhh [2, 3H]; out_f/out_b [B, T, H]. The layout
// integers, threads and shared-memory bytes come from ops/gru.py
// cluster_layout.
int bigru_fwd_cluster(const float* xg_f, const float* xg_b, const float* wpack,
                      const float* bhh, float* out_f, float* out_b, int B, int T, int H,
                      int C, int Uc, int KS, int KC, int NP, int threads, int smem,
                      cudaStream_t stream) {
  return launch_cluster(bigru_fwd_cluster_kernel, C, B, threads, smem, stream, xg_f, xg_b,
                        wpack, bhh, out_f, out_b, B, T, H, Uc, KS, KC, NP);
}

// Cluster backward: the G pre-pass, the serial cluster kernel, then dW_hh /
// db_hh over S row chunks. w [2, 3H, H] (W_hh per direction); wpack
// [2, C, KS*KC*NP] (pack_weights, "bwd"); gd [2, B, T, 3H] scratch; part
// [S, 2*3H*H + 2*3H] scratch; dwdb [2*3H*H + 2*3H]: dW_hh then db_hh.
int bigru_bwd_cluster(const float* xg_f, const float* xg_b, const float* w, const float* bhh,
                      const float* wpack, const float* out_f, const float* out_b,
                      const float* dout_f, const float* dout_b, float* dxg_f, float* dxg_b,
                      float* gd, float* part, float* dwdb, int B, int T, int H, int C, int Uc,
                      int KS, int KC, int NP, int threads, int smem, int S,
                      cudaStream_t stream) {
  const long long R = (long long)B * T;
  dim3 grid((unsigned)((R + 63) / 64), (3 * H + 63) / 64, 2);
  bigru_hg_kernel<<<grid, 256, 0, stream>>>(xg_f, xg_b, out_f, out_b, w, bhh, gd, B, T, H);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = launch_cluster(bigru_bwd_cluster_kernel, C, B, threads, smem, stream, xg_f, xg_b, wpack,
                       out_f, out_b, dout_f, dout_b, dxg_f, dxg_b, gd, B, T, H, Uc, KS, KC, NP);
  if (err != 0) return err;
  return launch_dw(gd, out_f, out_b, part, dwdb, B, T, H, S, stream);
}

// Stream forward. xg_f/xg_b [B, T, 3H]; wt [2, H, 3H] (W_hh^T per
// direction); bhh [2, 3H]; out_f/out_b [B, T, H].
int bigru_fwd(const float* xg_f, const float* xg_b, const float* wt,
              const float* bhh, float* out_f, float* out_b, int B, int T, int H,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT_S * ((H + 3) / 4 * 4 + 3 * H);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dim3 grid((B + BT_S - 1) / BT_S, 2);
  bigru_fwd_kernel<<<grid, threads, smem, stream>>>(xg_f, xg_b, wt, bhh, out_f,
                                                     out_b, B, T, H);
  return (int)cudaGetLastError();
}

// Stream backward. wt [2, H, 3H] and w [2, 3H, H] are W_hh^T and W_hh per
// direction; out_*/dout_* [B, T, H]; dxg_* [B, T, 3H]; dgh [2, B, T, 3H] and
// part [S, 2*3H*H + 2*3H] scratch; dwdb [2*3H*H + 2*3H]: dW_hh then db_hh.
int bigru_bwd(const float* xg_f, const float* xg_b, const float* wt, const float* w,
              const float* bhh, const float* out_f, const float* out_b,
              const float* dout_f, const float* dout_b, float* dxg_f, float* dxg_b,
              float* dgh, float* part, float* dwdb, int B, int T, int H, int S,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BT_S * (4 * ((H + 3) / 4 * 4) + 8 * H);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int threads = ((3 * H + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dim3 grid((B + BT_S - 1) / BT_S, 2);
  bigru_bwd_kernel<<<grid, threads, smem, stream>>>(xg_f, xg_b, wt, w, bhh, out_f, out_b,
                                                    dout_f, dout_b, dxg_f, dxg_b, dgh,
                                                    B, T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dw(dgh, out_f, out_b, part, dwdb, B, T, H, S, stream);
}

}  // extern "C"
