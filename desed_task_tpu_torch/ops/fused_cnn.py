"""Fused CNN block: conv3x3 + BatchNorm + GLU + dropout + avg-pool.

Counterpart of desed_task_tpu/ops/pallas_cnn.py. Two hand-written CUDA
kernels (csrc/fused_cnn.cu) carry one block:

  conv_bn_stats   conv3x3 SAME + bias -> y, and the per-(f, c) sum and sum
                  of squares of y over all rows (the BatchNorm batch stats).
                  Replaces _conv_stats_kernel (pallas_cnn.py:147, :403).
  glu_drop_pool   BN as a per-lane affine, GLU = (ybn Wg + bg) sigmoid(ybn),
                  optional dropout from given uint8 bits, T- and F-avg-pool.
                  Replaces _epilogue_kernel (pallas_cnn.py:269, :589).

and their backward passes (csrc/fused_cnn.cu as well):

  conv_bn_stats_bwd   dy_eff = dy + ds + 2 y dq; dx (transposed conv3x3 of
                      dy_eff), dW and dbias. Replaces _conv_stats_bwd_kernel
                      (pallas_cnn.py:186, :443).
  glu_drop_pool_bwd   gradients of glu_drop_pool with respect to y, the
                      per-lane BN scale and bias, Wg and bg. Replaces
                      _epilogue_bwd_kernel (pallas_cnn.py:295, :637).

The source notes in csrc/fused_cnn.cu give each kernel's bound on the H100
and its design; `conv_fwd_plan`, `glu_fwd_plan`, `conv_bwd_plan` and
`glu_bwd_plan` pick their tiles from the shape alone. Each wrapper takes its
plain PyTorch version (`*_plain`, beside it) only for CPU tensors; for CUDA
tensors it launches the kernel or raises. Two `torch.autograd.Function`s tie
each forward to its backward.
`fused_glu_block` keeps the contract of pallas_cnn.py:678-747, with the
BatchNorm scale and bias math in torch, so autograd carries the gradients
of the batch mean and variance back into conv_bn_stats_bwd as ds and dq.

bf16 mode (the JAX kernels' bf16 mode): given bf16 activations, the four
kernels take bf16 operands, sum their products in fp32 and store y, z, dy
and dx in bf16, rounding where pallas_cnn.py rounds (the plain versions
write each bf16 product as an fp32 product of bf16-rounded values: exact,
as "bf16 operands, fp32 accumulation" is). Forward: :171-178, :277, :292.
conv_bn_stats_bwd: dy_eff in fp32 (:203-207), dbias from the unrounded
dy_eff (:211), bf16(dy_eff) the operand of the dW and dx products (:208),
dx rounded (:239), dw and dbias rounded once from their fp32 totals
(:473-474). glu_drop_pool_bwd: bf16(BN(y)) the operand of lin and the left
operand of dWg, the sigmoid of the unrounded BN(y), dlin kept in fp32 in
both of its products (:341-350: fp32 x bf16 dots, which keep the fp32
operand), dy rounded (:354), dscale_f and dbias_f fp32, dwg and dbg rounded
once (:666-667). The BN statistics and affine stay fp32.

Layouts follow the JAX package: x [B, T, F, Ci] (NHWC), w [3, 3, Ci, Co]
(HWIO), GLU weight wg [Co_in, Co_out] (flax Dense kernel), lane = f*Co + c.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, fields

import torch

from . import _build
from .dropout import keep_threshold, random_bytes

# --------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and what the kernels are held against)
# --------------------------------------------------------------------------


def conv2d_nhwc(x, w, bias=None, stride: int = 1, pad: int = 1):
    """Cross-correlation of x [B, H, W, Ci] with w [kh, kw, Ci, Co] as a sum of
    per-tap products (no library convolution), zero padding `pad`."""
    kh, kw = w.shape[0], w.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (xp.shape[1] - kh) // stride + 1
    wo = (xp.shape[2] - kw) // stride + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i : i + stride * (ho - 1) + 1 : stride,
                     j : j + stride * (wo - 1) + 1 : stride, :]
            term = torch.matmul(win, w[i, j])
            out = term if out is None else out + term
    return out if bias is None else out + bias


def _io_dtype(name: str, *tensors) -> torch.dtype:
    """The activations' dtype of a call: bf16 where any of `tensors` is,
    and then all of them must be."""
    bf = [t.dtype == torch.bfloat16 for t in tensors]
    if any(bf) and not all(bf):
        raise TypeError(f"{name}: mixed dtypes "
                        f"{[str(t.dtype) for t in tensors]}: all bf16 or none")
    return torch.bfloat16 if bf[0] else tensors[0].dtype


def conv_bn_stats_plain(x, w, bias):
    """y = conv3x3_same(x, w) + bias [B, T, F, Co]; s, q = per-lane sum and
    sum of squares of y over the B*T rows, each [F*Co]. bf16 x, w, bias:
    the products of bf16 values summed in fp32, + bias in fp32, y rounded to
    bf16, s and q (fp32) of the rounded y (pallas_cnn.py:171-178)."""
    if _io_dtype("conv_bn_stats", x, w, bias) == torch.bfloat16:
        y = conv2d_nhwc(x.float(), w.float(), bias.float()).to(torch.bfloat16)
        B, T, F, Co = y.shape
        yl = y.float().reshape(B * T, F * Co)
        return y, yl.sum(0), (yl * yl).sum(0)
    y = conv2d_nhwc(x, w, bias)
    B, T, F, Co = y.shape
    yl = y.reshape(B * T, F * Co)
    return y, yl.sum(0), (yl * yl).sum(0)


def glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits=None, *, pool, keep_prob=1.0):
    """z [B, T//pt, F//pf, Co] = avgpool(drop(GLU(y * scale_f + bias_f))).
    bf16 y, wg, bg: BN(y) in fp32, rounded to bf16 as the product's operand
    (pallas_cnn.py:277), the sigmoid of the unrounded BN(y) (:279), dropout
    and pool in fp32, z rounded to bf16 once (:292)."""
    bf = _io_dtype("glu_drop_pool", y, wg, bg) == torch.bfloat16
    B, T, F, Co = y.shape
    pt, pf = pool
    if bf:
        y, wg, bg = y.float(), wg.float(), bg.float()
    ybn = y * scale_f.view(F, Co) + bias_f.view(F, Co)
    lin_in = ybn.to(torch.bfloat16).float() if bf else ybn  # bf16-rounded, in fp32
    z = (torch.matmul(lin_in, wg) + bg) * torch.sigmoid(ybn)
    if bits is not None:
        keep = bits.view(B, T, F, Co).to(torch.int32) < keep_threshold(keep_prob)
        z = torch.where(keep, z * (1.0 / keep_prob), torch.zeros_like(z))
    To, Fo = T // pt, F // pf
    z = z[:, : To * pt, : Fo * pf].reshape(B, To, pt, Fo, pf, Co).mean(dim=(2, 4))
    return z.to(torch.bfloat16) if bf else z


def conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx: bool = True):
    """Backward of conv_bn_stats: cotangents dy [B, T, F, Co] of y and ds, dq
    [F*Co] of the lane sums -> (dx [B, T, F, Ci] or None, dw [3, 3, Ci, Co],
    dbias [Co]), with dy_eff = dy + ds + 2 y dq (pallas_cnn.py:207).
    bf16 x, w, y, dy (ds, dq fp32): dy_eff in fp32, dbias summed from it
    (:211), bf16(dy_eff) the operand of the dW and dx products (:208), dx,
    dw and dbias rounded to bf16 once (:239, :473-474)."""
    bf = _io_dtype("conv_bn_stats_bwd", x, w, y, dy) == torch.bfloat16
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    if bf:
        x, w, y, dy = x.float(), w.float(), y.float(), dy.float()
    dy_eff = dy + ds.view(F, Co) + 2.0 * y * dq.view(F, Co)
    dbias = dy_eff.sum(dim=(0, 1, 2))
    if bf:
        dy_eff = dy_eff.to(torch.bfloat16).float()
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    d2 = dy_eff.reshape(-1, Co)
    dw = torch.stack([
        torch.stack([xp[:, i : i + T, j : j + F].reshape(-1, Ci).t() @ d2 for j in range(3)])
        for i in range(3)])
    dx = None
    if need_dx:  # transposed conv: SAME conv with the flipped, transposed kernel
        dx = conv2d_nhwc(dy_eff, w.flip(0, 1).transpose(2, 3))
    if bf:
        dx = None if dx is None else dx.to(torch.bfloat16)
        dw, dbias = dw.to(torch.bfloat16), dbias.to(torch.bfloat16)
    return dx, dw, dbias


def _unpool(g, T, F, pool):
    """Adjoint of the floor T/F average pool: [B, To, Fo, Co] -> [B, T, F, Co]."""
    B, To, Fo, Co = g.shape
    pt, pf = pool
    gu = g.new_zeros((B, T, F, Co))
    gu[:, : To * pt, : Fo * pf] = (
        g[:, :, None, :, None, :].expand(B, To, pt, Fo, pf, Co).reshape(B, To * pt, Fo * pf, Co)
        / (pt * pf))
    return gu


def glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bits, g, *, pool, keep_prob=1.0):
    """Backward of glu_drop_pool for the cotangent g [B, T//pt, F//pf, Co] ->
    (dy [B, T, F, Co], dscale_f [F*Co], dbias_f [F*Co], dwg [Co, Co], dbg [Co]).
    bf16 y, wg, bg, g: BN(y) in fp32 (a multiply, then an add), rounded to
    bf16 as lin's operand and dWg's left operand (pallas_cnn.py:312, :347),
    the sigmoid of the unrounded BN(y); dlin stays fp32 in both of its
    products (:341-350); dy rounded to bf16 (:354), dscale_f and dbias_f
    fp32, dwg and dbg rounded to bf16 once (:666-667)."""
    bf = _io_dtype("glu_drop_pool_bwd", y, wg, bg, g) == torch.bfloat16
    B, T, F, Co = y.shape
    if bf:
        y, wg, bg, g = y.float(), wg.float(), bg.float(), g.float()
    sc, bi = scale_f.view(F, Co), bias_f.view(F, Co)
    ybn = y * sc + bi
    ybn_c = ybn.to(torch.bfloat16).float() if bf else ybn  # bf16-rounded, in fp32
    lin = torch.matmul(ybn_c, wg) + bg
    s = torch.sigmoid(ybn)
    gu = _unpool(g, T, F, pool)
    if bits is not None:
        keep = bits.view(B, T, F, Co).to(torch.int32) < keep_threshold(keep_prob)
        gu = torch.where(keep, gu * (1.0 / keep_prob), torch.zeros_like(gu))
    dlin = gu * s
    dybn = torch.matmul(dlin, wg.t()) + gu * lin * s * (1.0 - s)
    dscale_f = (dybn * y).sum(dim=(0, 1)).reshape(-1)
    dbias_f = dybn.sum(dim=(0, 1)).reshape(-1)
    dwg = ybn_c.reshape(-1, Co).t() @ dlin.reshape(-1, Co)
    dy, dbg = dybn * sc, dlin.sum(dim=(0, 1, 2))
    if bf:
        dy, dwg, dbg = (t.to(torch.bfloat16) for t in (dy, dwg, dbg))
    return dy, dscale_f, dbias_f, dwg, dbg


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def conv_bn_stats(x, w, bias):
    """conv3x3 SAME + bias and the per-lane BN statistics.

    x [B, T, F, Ci], w [3, 3, Ci, Co], bias [Co], all float32 or all bf16 ->
    (y [B, T, F, Co] in x's dtype, s [F*Co], q [F*Co] float32), s/q summed
    over all B*T rows (in bf16 mode: of the rounded y; its kernels run
    their products on the tensor cores, and take w as it is at every 2024
    block: `conv_fwd_plan(...).kernel`). Deterministic: lane partials per
    tile or per CTA, added in a fixed order (`conv_fwd_plan`). Launches
    count under "conv_bn_stats" (fp32) or "conv_bn_stats.bf16".
    """
    dtype = _io_dtype("conv_bn_stats", x, w, bias)
    if x.device.type == "cpu":
        return conv_bn_stats_plain(x, w, bias)
    bf = dtype == torch.bfloat16
    _build.require_cuda("conv_bn_stats", torch.bfloat16 if bf else torch.float32, x, w, bias)
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    if tuple(w.shape) != (3, 3, Ci, Co) or tuple(bias.shape) != (Co,):
        raise ValueError(f"conv_bn_stats: w {tuple(w.shape)}, bias {tuple(bias.shape)}")
    plan = conv_fwd_plan(B, T, F, Ci, Co, bf16=bf)
    if bf and plan.kernel == 0:  # conv3x3_bf16_kernel reads w as [3, 3, Co, Ci]
        w = w.permute(0, 1, 3, 2).contiguous()
    x, w = _aligned(x), _aligned(w)
    L = F * Co
    y = torch.empty((B, T, F, Co), device=x.device, dtype=dtype)
    part = torch.empty((2, plan.n_parts, L), device=x.device, dtype=torch.float32)
    s = torch.empty((L,), device=x.device, dtype=torch.float32)
    q = torch.empty((L,), device=x.device, dtype=torch.float32)
    entry = "conv_bn_stats_bf16" if bf else "conv_bn_stats"
    fn = _build.function("fused_cnn", entry, [_build.P] * 8 + [_build.I] * 5 + [_build.P] * 2)
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
             part[0].data_ptr(), part[1].data_ptr(), s.data_ptr(), q.data_ptr(),
             B, T, F, Ci, Co, _c_ints(plan), _build.stream_ptr(x))
    _build.check(err, entry)
    _build.count_launch("conv_bn_stats.bf16" if bf else "conv_bn_stats")
    return y, s, q


def glu_drop_pool(y, scale_f, bias_f, wg, bg, bits=None, *, pool, keep_prob=1.0):
    """BN-apply + GLU + optional dropout + T/F avg-pool.

    y [B, T, F, Co], wg [Co, Co], bg [Co], all float32 or all bf16;
    scale_f, bias_f [F*Co] float32; bits uint8 [B, T, F*Co] or None.
    Returns z [B, T//pt, F//pf, Co] in y's dtype. fp32: any Co, the kernel
    takes channel tiles and Wg in slices; bf16: tensor-core kernels, a
    warp's tile in registers at the 2024 shapes (`glu_frag_takes`), else
    tiles through shared memory that hold Wg^T of a channel tile whole, Co
    up to about 700 (`glu_fwd_plan`).
    Launches count under "glu_drop_pool" (fp32) or "glu_drop_pool.bf16".
    """
    dtype = _io_dtype("glu_drop_pool", y, wg, bg)
    if y.device.type == "cpu":
        return glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits,
                                   pool=pool, keep_prob=keep_prob)
    bf = dtype == torch.bfloat16
    _build.require_cuda("glu_drop_pool", torch.bfloat16 if bf else torch.float32, y, wg, bg)
    _build.require_cuda_f32("glu_drop_pool", scale_f, bias_f)
    if scale_f.device != y.device:
        raise ValueError("glu_drop_pool: all tensors must be on one CUDA device")
    B, T, F, Co = y.shape
    pt, pf = pool
    if scale_f.numel() != F * Co or bias_f.numel() != F * Co or tuple(wg.shape) != (Co, Co):
        raise ValueError("glu_drop_pool: scale_f/bias_f must be [F*Co], wg [Co, Co]")
    if bits is not None:
        if bits.dtype != torch.uint8 or bits.numel() != y.numel() or not bits.is_contiguous():
            raise ValueError("glu_drop_pool: bits must be contiguous uint8 like y")
        if bits.device != y.device:
            raise ValueError("glu_drop_pool: bits must be on y's device")
    plan = glu_fwd_plan(B, T, F, Co, (pt, pf), bf16=bf)
    y, scale_f, bias_f, wg = (_aligned(t) for t in (y, scale_f, bias_f, wg))
    bits = None if bits is None else _aligned(bits)
    z = torch.empty((B, T // pt, F // pf, Co), device=y.device, dtype=dtype)
    entry = "glu_drop_pool_bf16" if bf else "glu_drop_pool"
    fn = _build.function("fused_cnn", entry,
                         [_build.P] * 7 + [_build.I] * 7 + [_build.Fl, _build.P, _build.P])
    err = fn(y.data_ptr(), scale_f.data_ptr(), bias_f.data_ptr(), wg.data_ptr(),
             bg.data_ptr(), None if bits is None else bits.data_ptr(), z.data_ptr(),
             B, T, F, Co, pt, pf, keep_threshold(keep_prob), 1.0 / keep_prob,
             _c_ints(plan), _build.stream_ptr(y))
    _build.check(err, entry)
    _build.count_launch("glu_drop_pool.bf16" if bf else "glu_drop_pool")
    return z


# --------------------------------------------------------------------------
# the kernels' plans: pure functions of the shape (csrc/fused_cnn.cu takes
# them as they are), so the tiles, the split over rows and the order in
# which partial sums are added are the same on every run
# --------------------------------------------------------------------------

SM_COUNT = 132  # H100 SXM; the plans size their grids for it
SMEM_LIMIT = 232448  # shared memory one block may use (227 KB)
SMEM_HALF = 110 * 1024  # two blocks an SM (228 KB), static shared memory beside
DX_BC = 8  # dy_eff channels per stage of the dx GEMM (csrc DX_BC)
DW_BLOCKS = 4 * SM_COUNT  # blocks of the dW pass, all tiles and chunks
DW_MAX_ROWS = 256  # rows of one dW stage (csrc DW_MAX_ROWS)
DW_STAGES = 2  # the dW kernel's ring of stages (csrc DW_STAGES)
GLU_THREADS = 512  # glu_drop_pool_bwd's block


@dataclass(frozen=True)
class ConvBwdPlan:
    """conv_bn_stats_bwd's kernels at one shape. dx: tiles of dx_tt frames x
    dx_ff frequencies (dx_bn output channels, 16384 / dx_bn rows at most),
    DX_BC channels of dy_eff per stage. dW: [dw_bko x dw_bno] tiles of
    [9*Ci, Co] (`dw_threads`: 8 x 4 or 8 x 8 a thread, row groups) over row
    tiles of dw_tt x dw_ff, dw_tiles in all, dw_tpc per chunk, `chunks`
    chunks; or (stream, Ci = 1) `chunks` blocks of rows_per_block rows. The
    partials are added in chunk order. In bf16: dx is the tensor-core conv
    (conv3x3_bf16_kernel's tiles, `_bf16_conv_tiles`; dx_vec: 16-byte
    copies of dy_eff, Co % 8 == 0); dW runs on the tensor cores where
    `dw_taps_takes` (conv_dw_taps_kernel: blocks of [9 taps x dw_cs
    channels] x dw_bno, dw_bko = 9 dw_cs, warps by `dw_taps_warps`, row
    tiles from `dw_taps_smem`), else on the CUDA cores from bf16 stages
    (dw_cs 0, the fp32 tiles, dw_smem in bf16); the dy_eff pass writes
    dbias partials from the unrounded dy_eff, one per block of eff_rows
    rows (eff_blocks blocks; 0 in fp32). bf16 at Ci = 1 (stream):
    conv_dw_c1_bf16_kernel, `chunks` blocks of dw_tt whole frames (dw_ff =
    F, rows_per_block = dw_tt F rows), the frames' x in dw_smem bytes of
    shared memory (`c1_bf16_smem`)."""

    stream: int
    vec: int
    dx_bn: int
    dx_tt: int
    dx_ff: int
    dx_smem: int
    dw_bko: int
    dw_bno: int
    dw_tt: int
    dw_ff: int
    dw_tiles: int
    dw_tpc: int
    chunks: int
    dw_smem: int
    rows_per_block: int
    dx_vec: int = 0
    eff_blocks: int = 0
    eff_rows: int = 0
    dw_cs: int = 0

    def ints(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in fields(self)]


def _c_ints(plan):
    """The plan's fields as a C int array, for the kernels' entry points."""
    ints = plan.ints()
    return ctypes.cast((ctypes.c_int * len(ints))(*ints), ctypes.c_void_p)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _shrink(tt: int, ff: int, smem, limit: int) -> tuple[int, int]:
    """Halve the frames, then the frequencies, of a tile until it fits."""
    while smem(tt, ff) > limit and (tt > 1 or ff > 1):
        if tt > 1:
            tt = _cdiv(tt, 2)
        else:
            ff = _cdiv(ff, 2)
    if smem(tt, ff) > limit:
        raise ValueError("conv_bn_stats_bwd: one tile does not fit in shared memory")
    return tt, ff


def _pow2_tile(n: int, lo: int, hi: int) -> int:
    t = lo
    while t < min(n, hi):
        t *= 2
    return t


def dx_smem(tt: int, ff: int, bn: int) -> int:
    npa = _cdiv((tt + 2) * (ff + 2), 4) * 4
    return 4 * 2 * (npa * DX_BC + 9 * DX_BC * bn)


def dw_threads(bko: int, bno: int) -> tuple[int, int, int, int, int]:
    """(tm, tn, nty, ntx, rg) of the dW kernel: tm x tn outputs a thread,
    nty x ntx threads a row group, rg = 256 / (nty * ntx) row groups."""
    tn = 4 if bno <= 32 else 8
    nty, ntx = bko // 8, bno // tn
    return 8, tn, nty, ntx, 256 // (nty * ntx)


def dw_smem(tt: int, ff: int, ci: int, bko: int, bno: int, esize: int = 4) -> int:
    """The ring of stages (x halo, dy_eff rows; `esize`-byte elements, the
    halo padded to 16 bytes), or the row groups' fp32 tiles added at the
    end, whichever is larger."""
    xs = _cdiv((tt + 2) * (ff + 2) * ci, 16 // esize) * (16 // esize)
    _, _, _, _, rg = dw_threads(bko, bno)
    return max(esize * DW_STAGES * (xs + tt * ff * bno), 4 * rg * bko * bno if rg > 1 else 0)


EFF_MAX_CO = 8 * 256  # the bf16 dy_eff pass: 8 channels a thread, one row slot at least
# conv_dw_taps_kernel (bf16 dW on the tensor cores): a ring of DWT_STAGES
# stages of up to DWT_MAX_ROWS rows, one block an SM (csrc DWT_STAGES,
# DWT_MAX_ROWS); the row table [DWT_MAX_ROWS] of int2 is static
DWT_STAGES = 3
DWT_MAX_ROWS = 512
DWT_SMEM = SMEM_LIMIT - 8 * DWT_MAX_ROWS


def dw_taps_takes(Ci: int, Co: int) -> bool:
    """The tensor-core dW: k16 tiles of 16 channels of one tap (Ci % 16 ==
    0) and whole n8 tiles of 16-byte dy_eff chunks (Co % 8 == 0)."""
    return Co % 8 == 0 and Ci % 16 == 0


def dw_taps_tile(Ci: int, Co: int) -> tuple[int, int]:
    """(CS, BNO) of conv_dw_taps_kernel: CS staged halo channels (32 where
    they divide Ci, else 16), BNO dW channels (16 .. 128)."""
    return (32 if Ci % 32 == 0 else 16), _pow2_tile(Co, 16, 128)


def dw_taps_warps(cs: int, bno: int) -> tuple[int, int, int, int]:
    """(WK, WN, NI, WR) of conv_dw_taps_kernel: 8 warps as WK = cs / 16
    channel slices (all nine taps each) x WN column groups of NI n8 tiles x
    WR groups that split each stage's m16 steps (csrc launch_dw_taps_tile)."""
    ni = min(4, bno // 8)
    wk, wn = cs // 16, bno // (8 * ni)
    return wk, wn, ni, 8 // (wk * wn)


def dw_halo_pitch(ff: int, cs: int) -> int:
    """Halo rows a frame of conv_dw_taps_kernel's stage: ff + 2 at cs = 32
    (rows of 4 chunks: the bank group follows the row's parity), ff + 4 at
    cs = 16 (2 chunks: the row mod 4), so that row = a (ff + 2 or 4) + b
    and the bank key a ff + b agree where the swizzle reads the row."""
    return ff + (2 if cs == 32 else 4)


def dw_taps_smem(tt: int, ff: int, cs: int, bno: int) -> int:
    """DWT_STAGES stages of the halo [(tt+2) dw_halo_pitch][cs] and the
    dy_eff rows [tt ff padded to 16][bno], bf16, or the fp32 tile [9 cs][bno]
    through which the WR row groups add their sums, whichever is larger."""
    ring = 2 * DWT_STAGES * ((tt + 2) * dw_halo_pitch(ff, cs) * cs
                             + _cdiv(tt * ff, 16) * 16 * bno)
    return max(ring, 4 * 9 * cs * bno if dw_taps_warps(cs, bno)[3] > 1 else 0)


def _balance(n: int, tile: int) -> int:
    """The tile that splits n into as many tiles as `tile` does, evenly."""
    return _cdiv(n, _cdiv(n, tile))


C1_BF16_BLOCKS = 2 * SM_COUNT  # blocks of conv_dw_c1_bf16_kernel (two an SM)


def c1_bf16_groups(Co: int) -> int:
    """Threads a row of conv_dw_c1_bf16_kernel: 8 channels each, padded to a
    power of two (the shuffle reduction's lanes)."""
    g = 1
    while g < _cdiv(Co, 8):
        g *= 2
    return g


def c1_bf16_smem(frames: int, F: int, Co: int) -> int:
    """conv_dw_c1_bf16_kernel's x tile [frames + 2][F + 16] bf16 (16-byte
    rows where F % 8 == 0), then the warps' sums [8][10][8 groups] fp32."""
    return _cdiv(2 * (frames + 2) * (F + 16), 16) * 16 + 4 * 8 * 10 * 8 * c1_bf16_groups(Co)


@functools.lru_cache(maxsize=None)
def conv_bwd_plan(B: int, T: int, F: int, Ci: int, Co: int, bf16: bool = False) -> ConvBwdPlan:
    """conv_bn_stats_bwd's plan at a shape, computed once per shape (the
    wrapper asks on every call)."""
    M, K = B * T * F, 9 * Ci
    vec = int(Ci % 4 == 0 and Co % 4 == 0)
    if bf16:  # dx on the tensor cores, dbias partials from the dy_eff pass
        if Co > EFF_MAX_CO:
            raise ValueError(f"conv_bn_stats_bwd: bf16 takes Co <= {EFF_MAX_CO}")
        dxp = _bf16_conv_tiles(T, F, Ci)
        blocks = max(1, min(DW_BLOCKS, _cdiv(M, 256)))
        rows = _cdiv(M, blocks)
        extra = dict(dx_vec=int(Co % 8 == 0), eff_blocks=_cdiv(M, rows), eff_rows=rows)
    else:
        bn = _pow2_tile(Ci, 8, 128)
        ff = min(F, 16384 // bn)
        tt, ff = _shrink(min(T, 16384 // bn // ff), ff, lambda a, b: dx_smem(a, b, bn), SMEM_HALF)
        dxp, extra = (bn, tt, ff, dx_smem(tt, ff, bn)), {}
    if Ci == 1 and Co <= 128:  # the streaming dW kernel: blocks of rows, no tiles
        if M >= 2**31:
            raise ValueError("conv_bn_stats_bwd: the Ci=1 kernel counts rows in 32-bit ints")
        if bf16:  # blocks of whole frames, their x staged once
            frames = B * T
            most = (SMEM_HALF - c1_bf16_smem(0, F, Co)) // (2 * (F + 16))
            if most < 1:
                raise ValueError(f"conv_bn_stats_bwd: F={F}: one frame of x does not fit")
            fpb = min(most, _cdiv(frames, C1_BF16_BLOCKS))
            return ConvBwdPlan(1, vec, *dxp, 0, 0, fpb, F, 0, 0, _cdiv(frames, fpb),
                               c1_bf16_smem(fpb, F, Co), fpb * F, **extra)
        blocks = max(1, min(DW_BLOCKS, _cdiv(M, 256)))
        rpb = _cdiv(M, blocks)
        return ConvBwdPlan(1, vec, *dxp, 0, 0, 0, 0, 0, 0, _cdiv(M, rpb), 0, rpb, **extra)
    if bf16 and dw_taps_takes(Ci, Co):  # dW on the tensor cores, all nine taps a stage
        cs, bno = dw_taps_tile(Ci, Co)
        wff = _balance(F, 64)
        lo, hi = 1, max(1, min(T, DWT_MAX_ROWS // wff))  # the most frames that fit
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if dw_taps_smem(mid, wff, cs, bno) <= DWT_SMEM else (lo, mid - 1)
        wtt = _balance(T, lo)
        tiles = B * _cdiv(T, wtt) * _cdiv(F, wff)
        per_chunk = Ci // cs * _cdiv(Co, bno)
        chunks = max(1, min(tiles, SM_COUNT // per_chunk))
        tpc = _cdiv(tiles, chunks)
        return ConvBwdPlan(0, vec, *dxp, 9 * cs, bno, wtt, wff, tiles, tpc, _cdiv(tiles, tpc),
                           dw_taps_smem(wtt, wff, cs, bno), 0, **extra, dw_cs=cs)
    # dW tiles: 16, 32, 64 or 128 a side. Each depth tile reads all rows
    # again (from L2), so the depth tile trades the depth computed past K
    # against the number of tiles. Stages of 128 rows (8 a row group at
    # least) where shared memory allows, to spread each stage's fixed costs
    bko = min((16, 32, 64, 128), key=lambda t: (_cdiv(K, t) * (t + 32), t))
    bno = _pow2_tile(Co, 16, 128)
    rg = dw_threads(bko, bno)[4]
    wff = min(F, 64)
    rows = min(DW_MAX_ROWS, max(128, 8 * rg))
    wtt, wff = _shrink(min(T, max(1, rows // wff)), wff,
                       lambda a, b: dw_smem(a, b, Ci, bko, bno), SMEM_HALF)
    tiles = B * _cdiv(T, wtt) * _cdiv(F, wff)
    per_chunk = _cdiv(K, bko) * _cdiv(Co, bno)
    chunks = max(1, min(tiles, DW_BLOCKS // per_chunk))
    tpc = _cdiv(tiles, chunks)
    return ConvBwdPlan(0, vec, *dxp, bko, bno, wtt, wff, tiles, tpc, _cdiv(tiles, tpc),
                       dw_smem(wtt, wff, Ci, bko, bno, 2 if bf16 else 4), 0, **extra)


@dataclass(frozen=True)
class ConvFwdPlan:
    """conv_bn_stats' kernels at one shape. Ci > 1: conv3x3_kernel with the
    STATS epilogue on tiles of tt frames x ff frequencies (bn output
    channels, seg: three taps a halo read), DX_BC input channels a stage,
    smem bytes; one lane partial per (clip, frame tile), n_parts = B *
    ceil(T / tt). Ci = 1 (stream): n_parts runs of rows_per_part frames
    (b, t). Each lane's partials are added in row order, as STATS_RUNS runs
    of consecutive rows added in run order.
    bf16 (`kernel` names the CUDA kernel, FWD_KERNELS):
    kernel 1, conv3x3_bf16_fwd_kernel (`fwd16_takes`: Ci % 16 == 0, Co a
    multiple of 32, F a power of two; every 2024 block but the first):
    persistent CTAs, n_parts of them per channel tile of bn channels
    (ceil(Co / bn) tiles), each walking a contiguous run of the B *
    ceil(T / tt) tiles of tt whole frames (ff = F, FWD16_ROWS = tt F rows),
    in row order, keeping its lanes' sums on chip and writing one partial
    row; a ring of FWD16_STAGES stages, each the halo of a tile at all Ci
    channels with the weights [9 Ci][bn] resident for the whole run (res,
    Ci a power of two: its halo rows are Ci / 8 chunks, addressed by
    shifts), or at 16 channels with that slice's weights [9][16][bn] (res
    0); smem bytes.
    kernel 2, conv_c1_bf16_kernel (Ci = 1, `c1_bf16_takes`): n_parts CTAs,
    each rows_per_part consecutive frames of the B * T (runs cross clips),
    x staged once (smem bytes), a thread 8 channels of a position.
    kernel 3, conv_c1_kernel<bf16> (other Ci = 1 shapes): the fp32
    streaming plan (stream 1) with bf16 loads.
    kernel 0: conv3x3_bf16_kernel on tiles of tt x ff <= bf16_rows(bn)
    rows, BF16_BK input channels a stage, vec: 16-byte copies (Ci % 8 ==
    0), one partial per (clip, frame tile)."""

    stream: int
    vec: int
    bn: int
    tt: int
    ff: int
    seg: int
    smem: int
    n_parts: int
    rows_per_part: int
    kernel: int = 0
    res: int = 0

    def ints(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in fields(self)]


C1_BLOCKS = 8 * SM_COUNT  # blocks of the Ci = 1 streaming conv
STATS_RUNS = 32  # runs of partial rows in the lane sums' final pass (csrc STATS_RUNS)
# the bf16 forward's CUDA kernels by ConvFwdPlan.kernel (chip_smoke.py prints them)
FWD_KERNELS = ("conv3x3_bf16_kernel", "conv3x3_bf16_fwd_kernel", "conv_c1_bf16_kernel",
               "conv_c1_kernel<bf16>")


def fwd_smem(tt: int, ff: int, bn: int) -> int:
    """The stages of conv3x3_kernel, or the tile's y [tt * ff][bn] that its
    STATS epilogue puts in the same memory, whichever is larger."""
    return max(dx_smem(tt, ff, bn), 4 * tt * ff * bn)


BF16_BK = 16  # input channels a stage of the bf16 conv: one mma k-step a tap (csrc BK)


def bf16_rows(bn: int) -> int:
    """Rows of a bf16 conv tile: 8 warps as 4 x 2 (bn >= 64) or 8 x 1 over
    the tile's rows and channels, each 2 (bn = 128) or 4 m16 tiles of rows
    (csrc WM, WN, MI)."""
    wm, mi = (4 if bn >= 64 else 8), (2 if bn == 128 else 4)
    return wm * 16 * mi


def fwd_bf16_smem(tt: int, ff: int, bn: int) -> int:
    """Two stages of the halo and the [9][bn] weight rows, 16 bf16 channels a
    row, or the epilogue's fp32 y tile [tt * ff][bn + 8], whichever is larger."""
    return max(2 * 2 * BF16_BK * ((tt + 2) * (ff + 2) + 9 * bn), 4 * tt * ff * (bn + 8))


def _bf16_conv_tiles(T: int, F: int, Cout: int) -> tuple[int, int, int, int]:
    """(bn, tt, ff, smem) of conv3x3_bf16_kernel for Cout output channels."""
    bn = _pow2_tile(Cout, 8, 128)
    ff = min(F, bf16_rows(bn))
    tt, ff = _shrink(max(1, min(T, bf16_rows(bn) // ff)), ff,
                     lambda a, b: fwd_bf16_smem(a, b, bn), SMEM_HALF)
    return bn, tt, ff, fwd_bf16_smem(tt, ff, bn)


FWD16_RES_MAX = 80 * 1024  # resident weights [9 Ci][bn] of conv3x3_bf16_fwd_kernel at most
FWD16_LANES = 8 * 256  # F * bn: a thread's 8 lanes each, 256 threads
FWD16_ROWS = 256  # rows of a tile: 8 warps x 32 (csrc FWD16_ROWS)
FWD16_STAGES = 2  # its ring of stages (3 measured no faster on the H100, PERF.md)


def fwd16_warps(bn: int) -> tuple[int, int]:
    """(MI, NI) of conv3x3_bf16_fwd_kernel: each of the 8 warps takes MI = 2
    m16 tiles of rows (32 rows) x NI = bn / 8 n8 tiles (every channel of the
    tile)."""
    return 2, bn // 8


def fwd16_per_sm(bn: int) -> int:
    """CTAs an SM that the registers allow (csrc fwd16_per_sm): two where a
    thread keeps 32 accumulators (bn = 32), else one."""
    return 2 if bn <= 32 else 1


def fwd16_smem(res: bool, Ci: int, F: int, tt: int, bn: int, stages: int) -> int:
    """conv3x3_bf16_fwd_kernel's shared memory: the resident weights [9 Ci][bn]
    (res), `stages` stages of the halo [(tt + 2) (F + 2)][kc] (kc = Ci, or
    16 with the slice's weights [9 16][bn]), the rounded y [FWD16_ROWS][bn +
    8], all bf16."""
    kc = Ci if res else 16
    stage = (tt + 2) * (F + 2) * kc + (0 if res else 9 * 16 * bn)
    return 2 * ((9 * Ci * bn if res else 0) + stages * stage + FWD16_ROWS * (bn + 8))


def fwd16_takes(F: int, Ci: int, Co: int) -> bool:
    """The shapes of conv3x3_bf16_fwd_kernel: 16-channel depth steps, channel
    tiles of 32 or more that divide Co, whole frames of a power-of-two F
    (FWD16_ROWS rows are whole frames) whose lane sums fit a thread's."""
    return Ci % 16 == 0 and Co % 32 == 0 and F & (F - 1) == 0 and F * 32 <= FWD16_LANES


def fwd16_res_takes(Ci: int) -> bool:
    """Resident weights take a stage of all Ci channels, Ci / 8 16-byte
    chunks a halo row, which csrc RowSwz addresses by shifts: Ci a power of
    two. Other Ci take 16-channel stages (2 chunks a row)."""
    return Ci & (Ci - 1) == 0


def _fwd16_plan(B: int, T: int, F: int, Ci: int, Co: int) -> ConvFwdPlan | None:
    """conv3x3_bf16_fwd_kernel's plan, or None where it does not fit: tiles
    of FWD16_ROWS rows (whole frames), FWD16_STAGES stages; the weights
    resident (fwd16_res_takes) at the largest bn of 128, 64 and 32 that
    divides Co with [9 Ci][bn] <= FWD16_RES_MAX and fits, else 16-channel
    stages with their
    weight slices at the largest such bn that fits; as many CTAs per
    channel tile as fill the card (fwd16_per_sm, two an SM only where
    shared memory allows), at most one a tile. The choice follows a sweep
    of these plans on the H100 (PERF.md)."""
    if not fwd16_takes(F, Ci, Co):
        return None
    tt = FWD16_ROWS // F
    for res in (True, False) if fwd16_res_takes(Ci) else (False,):
        for bn in (128, 64, 32):
            if Co % bn or F * bn > FWD16_LANES or (res and 2 * 9 * Ci * bn > FWD16_RES_MAX):
                continue
            smem = fwd16_smem(res, Ci, F, tt, bn, FWD16_STAGES)
            if smem > SMEM_LIMIT:
                continue
            per_sm = fwd16_per_sm(bn) if smem <= SMEM_HALF else 1
            tiles = B * _cdiv(T, tt)
            ctas = max(1, min(tiles, per_sm * SM_COUNT // (Co // bn)))
            return ConvFwdPlan(0, 1, bn, tt, F, 0, smem, ctas, 0, kernel=1, res=int(res))
    return None


C1B_CTAS = 2 * SM_COUNT  # CTAs of conv_c1_bf16_kernel (two an SM)


def c1_bf16_takes(F: int, Co: int) -> bool:
    """conv_c1_bf16_kernel's shapes: 16-byte rows of x (F % 8 == 0) and of y
    (Co % 8 == 0), a thread per 8 channels of a frame's positions in one CTA."""
    return F % 8 == 0 and Co % 8 == 0 and F * Co // 8 <= 256


def c1_fwd_smem(frames: int, F: int) -> int:
    """conv_c1_bf16_kernel's x: its frames and the two beside them, bf16."""
    return 2 * (frames + 2) * F


def _c1_bf16_plan(B: int, T: int, F: int, Co: int) -> ConvFwdPlan | None:
    if not c1_bf16_takes(F, Co) or B * T * F >= 2**31:
        return None
    frames = B * T
    fpc = _cdiv(frames, C1B_CTAS)
    fpc = min(fpc, SMEM_HALF // (2 * F) - 2)
    if fpc < 1:
        return None
    return ConvFwdPlan(1, 1, 0, 0, F, 0, c1_fwd_smem(fpc, F), _cdiv(frames, fpc), fpc, kernel=2)


@functools.lru_cache(maxsize=None)
def conv_fwd_plan(B: int, T: int, F: int, Ci: int, Co: int, bf16: bool = False) -> ConvFwdPlan:
    """conv_bn_stats' plan at a shape, computed once per shape."""
    vec = int(Co % 4 == 0)
    if bf16 and Ci > 1:  # the tensor-core kernels
        plan = _fwd16_plan(B, T, F, Ci, Co)
        if plan is not None:
            return plan
        bn, tt, ff, smem = _bf16_conv_tiles(T, F, Co)
        return ConvFwdPlan(0, int(Ci % 8 == 0), bn, tt, ff, 0, smem, B * _cdiv(T, tt), 0)
    if bf16:
        plan = _c1_bf16_plan(B, T, F, Co)
        if plan is not None:
            return plan
    if Ci == 1:  # the streaming kernel: a thread a frequency and 4 channels
        if B * T * F >= 2**31:
            raise ValueError("conv_bn_stats: the Ci=1 kernel counts rows in 32-bit ints")
        lane_blocks = _cdiv(F * _cdiv(Co, 4), 256)
        parts = max(1, min(B * T, C1_BLOCKS // lane_blocks))
        rpp = _cdiv(B * T, parts)
        return ConvFwdPlan(1, vec, 0, 0, 0, 0, 0, _cdiv(B * T, rpp), rpp, kernel=3 if bf16 else 0)
    bn = _pow2_tile(Co, 8, 128)
    ff = min(F, 16384 // bn)
    tt, ff = _shrink(min(T, 16384 // bn // ff), ff, lambda a, b: fwd_smem(a, b, bn), SMEM_HALF)
    seg = int(ff % 8 == 0 and bn >= 64)
    return ConvFwdPlan(0, vec, bn, tt, ff, seg, fwd_smem(tt, ff, bn), B * _cdiv(T, tt), 0)


@dataclass(frozen=True)
class GluBwdPlan:
    """glu_drop_pool_bwd's kernel at one shape: channels padded to cp (zero
    weights), dWg thread tiles of 4 x ct, tiles of p positions (p x cp <=
    16 x GLU_THREADS), pg groups of threads splitting a tile's positions
    for dWg, n_tiles tiles, tpb per block, n_blocks blocks; smem bytes;
    ks: 0 where Wg and Wg^T are staged whole, once, else the rows of the
    slices staged per product (the wide kernel, Co > 128); lanes: 1 where
    the F*Co lane sums are kept in shared memory, 0 where each block keeps
    them in its partial row in device memory; passes: the wide kernel's
    passes over the dWg entries (1: dWg in registers); frag: 1 where the
    bf16 mode runs glu_bwd_frag_kernel (`glu_bwd_frag_takes`: phases A and B
    on the tensor cores, smem by `glu_bwd_frag_smem`), 0 for
    glu_bwd_kernel."""

    cp: int
    ct: int
    p: int
    pg: int
    n_tiles: int
    tpb: int
    n_blocks: int
    smem: int
    ks: int
    lanes: int
    passes: int
    frag: int = 0

    def ints(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in fields(self)]


GLU_MAX_CP = 4 * GLU_THREADS  # four channels a product thread, one position group at least


def glu_smem(F: int, Co: int, cp: int, p: int, ks: int = 0, lanes: int = 1) -> int:
    """Wg and Wg^T whole (ks 0) or one slice of ks rows, the tile's two
    [cp, p + 4] buffers, and the lane sums where they are kept in shared
    memory (lanes 1)."""
    w = 2 * Co * cp if ks == 0 else ks * cp
    return 4 * (w + 2 * cp * (p + 4) + (3 * F * Co if lanes else 0))


def _glu_bwd_threads(Co: int) -> tuple[int, int, int, int]:
    """(cp, ct, pg, passes) of glu_drop_pool_bwd: dWg tiles of 4 x ct a
    thread, pg position groups where the tiles leave threads over, else
    `passes` passes of GLU_THREADS tiles."""
    cp = _cdiv(Co, 4) * 4
    if (cp // 4) ** 2 > GLU_THREADS:  # 4 x 8 dWg tiles
        cp = _cdiv(Co, 8) * 8
    ct = 4 if (cp // 4) ** 2 <= GLU_THREADS else 8
    nw = (cp // 4) * (cp // ct)
    return cp, ct, max(1, GLU_THREADS // nw), _cdiv(nw, GLU_THREADS)


def glu_bwd_frag_takes(Co: int) -> bool:
    """Widths of glu_bwd_frag_kernel (bf16): Co = 8 NI with NI = 2, 4, 8
    or 16, whole k16 steps of mma.sync and no padded channel."""
    return Co in (16, 32, 64, 128)


def glu_bwd_frag_units(Co: int) -> tuple[int, int]:
    """(wn, mu) of glu_bwd_frag_kernel: a warp's unit is an m16 tile at wn
    n8 tiles (the channels of wn / 2 k16 steps), and a warp takes at most
    mu units of a tile (csrc WN, MU)."""
    ni = Co // 8
    return min(ni, 4), 2 if ni == 2 else 1


def glu_bwd_frag_smem(F: int, Co: int, p: int, lanes: int = 1) -> int:
    """glu_bwd_frag_kernel's shared memory: Wg^T [Co][Co + 8] bf16, the
    tile's yt, dt and t2 [Co][p + 4] fp32, two stages of y [p][Co + 8] bf16
    and of the bits [p][Co + 16] uint8, and the lane sums where they are kept
    in shared memory (lanes 1)."""
    return (2 * Co * (Co + 8) + 12 * Co * (p + 4) + 2 * (2 * p * (Co + 8) + p * (Co + 16))
            + (12 * F * Co if lanes else 0))


def _glu_bwd_frag_plan(plan: GluBwdPlan, B: int, T: int, F: int, Co: int) -> GluBwdPlan:
    """The fp32 plan's threads at the frag kernel's tile of p = 16 x 16 mu
    wn / NI positions (every warp mu units; the fp32 plan's tile at these
    widths), the lane sums in shared memory where they fit beside it, else
    in device memory."""
    wn, mu = glu_bwd_frag_units(Co)
    p = 16 * GLU_THREADS // 32 * mu * wn // (Co // 8)
    lanes = int(glu_bwd_frag_smem(F, Co, p) <= SMEM_LIMIT)
    n_tiles = max(1, _cdiv(B * T * F, p))
    tpb = _cdiv(n_tiles, min(SM_COUNT, n_tiles))
    return GluBwdPlan(plan.cp, plan.ct, p, plan.pg, n_tiles, tpb, _cdiv(n_tiles, tpb),
                      glu_bwd_frag_smem(F, Co, p, lanes), 0, lanes, 1, 1)


@functools.lru_cache(maxsize=None)
def glu_bwd_plan(B: int, T: int, F: int, Co: int, bf16: bool = False) -> GluBwdPlan:
    """Up to Co = 128 (one dWg tile a thread at most): Wg and Wg^T staged
    once, the lane sums in shared memory at the largest tile that fits them,
    else in device memory at the full tile. Wider: Wg and Wg^T in slices of
    as many rows as fit beside the tile (and the lane sums, where they fit),
    dWg in passes through the block's partial in device memory. bf16 at
    the widths of `glu_bwd_frag_takes`: glu_bwd_frag_kernel's plan.
    Computed once per shape."""
    if Co < 1:
        raise ValueError(f"glu_drop_pool_bwd: Co={Co}")
    cp, ct, pg, passes = _glu_bwd_threads(Co)
    if cp > GLU_MAX_CP:
        raise ValueError(f"glu_drop_pool_bwd: Co={Co}: the kernel takes Co <= {GLU_MAX_CP} "
                         f"(four channels a thread, {GLU_THREADS} threads)")
    if B * T * F + 16 * GLU_THREADS >= 2**31:
        raise ValueError("glu_drop_pool_bwd: the kernel counts positions in 32-bit ints")
    step = 4 * pg
    p_full = max(step, 16 * GLU_THREADS // cp // step * step)
    fits = lambda p, ks, lanes: glu_smem(F, Co, cp, p, ks, lanes) <= SMEM_LIMIT
    if passes == 1:
        ks, p = 0, p_full
        while not fits(p, 0, 1) and p > step:
            p = max(step, p // 2 // step * step)
        lanes = int(fits(p, 0, 1))
        if not lanes:
            p = p_full
    else:
        p = p_full
        lanes = int(fits(p, 4, 1))
        rest = SMEM_LIMIT - 4 * (2 * cp * (p + 4) + (3 * F * Co if lanes else 0))
        ks = min(Co, rest // (4 * cp) // 4 * 4)
    if not fits(p, ks, lanes):
        raise ValueError(f"glu_drop_pool_bwd: F={F}, Co={Co}: one tile does not fit")
    n_tiles = max(1, _cdiv(B * T * F, p))
    tpb = _cdiv(n_tiles, min(SM_COUNT, n_tiles))
    plan = GluBwdPlan(cp, ct, p, pg, n_tiles, tpb, _cdiv(n_tiles, tpb),
                      glu_smem(F, Co, cp, p, ks, lanes), ks, lanes, passes)
    return _glu_bwd_frag_plan(plan, B, T, F, Co) if bf16 and glu_bwd_frag_takes(Co) else plan


GLU_FWD_THREADS = 256  # glu_drop_pool's block (csrc GLU_FWD_THREADS)
GLU_FWD_PER_SM = 3  # its blocks an SM at most (csrc __launch_bounds__)
SMEM_SM = 228 * 1024  # shared memory of one SM, 1 KB of it reserved per block


@dataclass(frozen=True)
class GluFwdPlan:
    """glu_drop_pool's fp32 kernel at one shape: channel tiles of ct (a power
    of two, at most 128; grid_y of them), tiles of p positions = nq pooled
    outputs of pt*pf positions each (ordered by pooled output, then window
    element), ct/4 x p/4 = 256 threads of 4 x 4; Wg in slices of ks rows
    (ks >= Co: staged once); n_tiles tiles over grid_x persistent blocks;
    smem bytes (with two int tables of nq, the rows of the tile's windows)."""

    ct: int
    p: int
    nq: int
    ks: int
    n_tiles: int
    grid_x: int
    grid_y: int
    smem: int

    def ints(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in fields(self)]


def glu_fwd_smem(Co: int, ct: int, p: int, ks: int, nq: int) -> int:
    """The Wg slice [ks][ct], the tile yt [max(Co padded to 4, ct)][p + 4]
    and the tile's window tables [2][nq]."""
    return 4 * (ks * ct + max(_cdiv(Co, 4) * 4, ct) * (p + 4) + 2 * nq)


@dataclass(frozen=True)
class GluBf16Plan:
    """glu_drop_pool's bf16 kernels at one shape. glu_fwd_ring_kernel (frag
    0): channel tiles of ct = 16 .. 128 (grid_y of them; warps by
    `glu_ring_warps`), tiles of tt frames (a multiple of pt) x ff
    frequencies (a multiple of pf; Fo*pf, whole frames, where they fit) of
    one clip at all Co channels, numbered f-tile fastest, then t-tile, then
    clip; a ring of `stages` stages of the tiles' raw y and bits, filled by
    16-byte copies where vec (F*Co and ff*Co multiples of 8), else by
    element loads; kp = Co padded to 16 (the product's depth); n_tiles
    tiles over grid_x persistent blocks, per_sm of them an SM; smem bytes
    (`glu_ring_layout`). glu_fwd_frag_kernel (frag 1 or 2, where
    `glu_frag_takes`): each warp alone on tiles of tt frames x ff
    frequencies, ct = kp = Co, a ring of `stages` stages a warp
    (`glu_frag_layout`), n_tiles warp tiles over grid_x blocks of 8 warps;
    frag 1: tt = 2, ff a multiple of 8 (m16 tiles of 8 frequencies x 2
    frames); frag 2 (pt = 1, Fo*pf dividing 8): ff = Fo*pf, tt ff a multiple
    of 16 (m16 tiles of 16 consecutive rows)."""

    ct: int
    tt: int
    ff: int
    stages: int
    vec: int
    kp: int
    n_tiles: int
    grid_x: int
    grid_y: int
    smem: int
    per_sm: int
    frag: int = 0

    def ints(self) -> list[int]:
        return [int(getattr(self, f.name)) for f in fields(self)]


GLU_RING_ELEMS = 4096  # elements of y a tile aims at (8 KB of bf16)
GLU_FRAG_WARPS = 8  # glu_fwd_frag_kernel's block (csrc GLU_FRAG_THREADS / 32)
GLU_FRAG_ELEMS = 1024  # elements of y a warp's tile aims at (2 KB of bf16)
GLU_FRAG_PER_SM = {16: 3, 32: 2, 64: 2, 128: 1}  # its blocks an SM (csrc glu_frag_per_sm)


def glu_ring_warps(ct: int) -> tuple[int, int, int, int]:
    """(WN, NI, WM, MI) of glu_fwd_ring_kernel: 8 warps as WM row x WN column
    groups, NI n8 tiles a warp (ct = 8 WN NI), MI = 8 / NI m16 tiles a warp
    a pass (32 accumulators a thread)."""
    wn = 4 if ct == 128 else 2
    ni = ct // (8 * wn)
    return wn, ni, 8 // wn, 8 // ni


def _r16(n: int) -> int:
    return _cdiv(n, 16) * 16


def glu_ring_layout(Co: int, ct: int, rows: int, stages: int) -> dict:
    """Byte offsets of glu_fwd_ring_kernel's shared memory: Bs [ct][kp + 8]
    and As [rows padded to 16][kp + 8] bf16, gt [rows padded to 16][ct + 8]
    fp32, then `stages` stages of y [rows][Co] bf16 and bits [rows][Co]
    uint8, each part padded to 16 bytes; `end` is the size."""
    a_row = 2 * (_cdiv(Co, 16) * 16 + 8)
    as_ = ct * a_row
    gt = as_ + _r16(rows) * a_row
    ring = gt + 4 * _r16(rows) * (ct + 8)
    ybytes = _r16(2 * rows * Co)
    stage = ybytes + _r16(rows * Co)
    return dict(bs=0, As=as_, gt=gt, ring=ring, ybytes=ybytes, stage=stage,
                end=ring + stages * stage)


def glu_frag_takes(T: int, F: int, Co: int, pool) -> bool:
    """Shapes of glu_fwd_frag_kernel: Co = 16, 32, 64 or 128 (whole k16
    steps, all channels a warp), pools of at most 2 x 2 (a window's elements
    in one lane and lane ^ 4), at least one pooled frame, and Fo*pf a
    multiple of 8 (m16 tiles of 8 frequencies x 2 frames) or, at pt = 1, a
    divisor of 8 (m16 tiles of 16 consecutive rows)."""
    pt, pf = pool
    Fs = F // pf * pf
    return (Co in (16, 32, 64, 128) and pt <= 2 and pf <= 2 and T // pt >= 1 and Fs >= 1
            and (Fs % 8 == 0 or (pt == 1 and 8 % Fs == 0)))


def glu_frag_layout(Co: int, Fs: int, tt: int, ff: int, stages: int) -> dict:
    """Byte offsets of glu_fwd_frag_kernel's shared memory: Bs [Co][Co + 8]
    bf16 and sb [Fs][Co/2 + 4] float4 for the block, then each of its 8
    warps' `stages` stages of y [tt][ff][Co + 8] bf16 and bits [tt][ff][Co]
    uint8 (`stage` bytes each, the first warp's at `ring`); `end` is the
    size."""
    sb = 2 * Co * (Co + 8)
    ring = sb + 16 * Fs * (Co // 2 + 4)
    ybytes = 2 * tt * ff * (Co + 8)
    stage = ybytes + tt * ff * Co
    return dict(bs=0, sb=sb, ring=ring, ybytes=ybytes, stage=stage,
                end=ring + GLU_FRAG_WARPS * stages * stage)


def _stages(smem, most: int = 2) -> tuple[int, int]:
    """(per_sm, stages): the most blocks an SM (`most` down to 1), then the
    most stages (4, 3 or 2) that fit them; (0, 0) where not even two stages
    fit one block."""
    for per_sm in range(most, 0, -1):
        for s in (4, 3, 2):
            if smem(s) <= SMEM_LIMIT and per_sm * (smem(s) + 1024) <= SMEM_SM:
                return per_sm, s
    return 0, 0


def _glu_frag_plan(B: int, T: int, F: int, Co: int, pool) -> GluBf16Plan | None:
    pt, pf = pool
    Ts, Fs = T // pt * pt, F // pf * pf
    if Fs % 8 == 0:  # 2 frames x ff frequencies
        frag, tt = 1, 2
        ff = min(Fs, max(8, GLU_FRAG_ELEMS // (2 * Co) // 8 * 8))
    else:  # whole frames of Fs | 8 frequencies, 16 rows at least
        frag, ff, step = 2, Fs, 16 // Fs
        tt = max(step, GLU_FRAG_ELEMS // (Fs * Co) // step * step)
    per_sm, stages = _stages(lambda s: glu_frag_layout(Co, Fs, tt, ff, s)["end"],
                             GLU_FRAG_PER_SM[Co])
    if not stages:
        return None
    n_tiles = B * _cdiv(Ts, tt) * _cdiv(Fs, ff)
    if n_tiles >= 2**31:
        raise ValueError("glu_drop_pool: the bf16 kernel counts tiles in 32-bit ints")
    grid_x = min(_cdiv(n_tiles, GLU_FRAG_WARPS), SM_COUNT * per_sm)
    return GluBf16Plan(Co, tt, ff, stages, 1, Co, n_tiles, grid_x, 1,
                       glu_frag_layout(Co, Fs, tt, ff, stages)["end"], per_sm, frag)


def _glu_ring_plan(B: int, T: int, F: int, Co: int, pool) -> GluBf16Plan:
    pt, pf = pool
    ct = _pow2_tile(Co, 16, 128)
    To, Fo = T // pt, F // pf
    Ts, Fs = To * pt, Fo * pf
    smem = lambda tt, ff, s: glu_ring_layout(Co, ct, tt * ff, s)["end"]
    fits = lambda tt, ff, s: smem(tt, ff, s) <= SMEM_LIMIT
    # whole frames where a window's pt of them fit, else the widest run of
    # windows whose elements stay a multiple of 8 (16-byte copies)
    step = pf * (8 // math.gcd(pf * Co, 8))
    ff = max(Fs, pf)
    if not fits(pt, ff, 2):
        ff = max((f for f in range(step, Fs + 1, step) if fits(pt, f, 2)), default=0)
        ff = ff or max((f for f in range(pf, Fs + 1, pf) if fits(pt, f, 2)), default=0)
    if not ff:
        raise ValueError(f"glu_drop_pool: Co={Co}, pool {pool}: one bf16 tile of a window "
                         f"does not fit in shared memory")
    k = max(1, min(max(To, 1), GLU_RING_ELEMS // Co // (pt * ff)))
    k = _balance(max(To, 1), k)
    while k > 1 and not fits(k * pt, ff, 2):
        k = _cdiv(k, 2)
    tt = k * pt
    per_sm, stages = _stages(lambda s: smem(tt, ff, s))
    n_tiles = B * _cdiv(Ts, tt) * _cdiv(Fs, ff)
    if n_tiles >= 2**31:
        raise ValueError("glu_drop_pool: the bf16 kernel counts tiles in 32-bit ints")
    grid_y = _cdiv(Co, ct)
    grid_x = min(n_tiles, max(1, SM_COUNT * per_sm // grid_y))
    vec = int(F * Co % 8 == 0 and ff * Co % 8 == 0)
    return GluBf16Plan(ct, tt, ff, stages, vec, _cdiv(Co, 16) * 16, n_tiles, grid_x, grid_y,
                       smem(tt, ff, stages), per_sm)


@functools.lru_cache(maxsize=None)
def glu_fwd_plan(B: int, T: int, F: int, Co: int, pool, bf16: bool = False):
    """glu_drop_pool's plan at a shape (`GluBf16Plan` in bf16, else
    `GluFwdPlan`), computed once per shape."""
    pt, pf = pool
    if bf16:  # the register kernel where it takes the shape and fits, else the ring
        plan = _glu_frag_plan(B, T, F, Co, pool) if glu_frag_takes(T, F, Co, pool) else None
        return plan or _glu_ring_plan(B, T, F, Co, pool)
    cg = 1
    while cg < min(_cdiv(Co, 4), 32):
        cg *= 2
    ct, p = 4 * cg, 4 * (GLU_FWD_THREADS // cg)
    if pt * pf > p:
        raise ValueError(f"glu_drop_pool: a pool window of {pt * pf} positions outgrows "
                         f"the kernel's tile of {p}")
    if B * T * F + p >= 2**31:
        raise ValueError("glu_drop_pool: the kernel counts positions in 32-bit ints")
    nq = p // (pt * pf)
    ks = Co
    if glu_fwd_smem(Co, ct, p, ks, nq) > SMEM_HALF:
        ks = (SMEM_HALF - glu_fwd_smem(Co, ct, p, 0, nq)) // (4 * ct) // 4 * 4
        if ks < 4:
            raise ValueError(f"glu_drop_pool: Co={Co}: one tile does not fit in shared memory")
    smem = glu_fwd_smem(Co, ct, p, ks, nq)
    n_tiles = _cdiv(B * (T // pt) * (F // pf), nq)
    grid_y = _cdiv(Co, ct)
    per_sm = max(1, min(GLU_FWD_PER_SM, SMEM_SM // (smem + 1024)))
    grid_x = min(n_tiles, max(1, SM_COUNT * per_sm // grid_y))
    return GluFwdPlan(ct, p, nq, ks, n_tiles, grid_x, grid_y, smem)


def _aligned(t):
    """t itself when its data starts on 16 bytes (the kernels read float4s),
    else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx: bool = True):
    """Backward of conv_bn_stats (see `conv_bn_stats_bwd_plain`); dx is
    skipped when `need_dx` is false. x, w, y, dy all float32 or all bf16;
    ds, dq float32. Deterministic: per-chunk partial sums of dW and dbias,
    added in a fixed order (`conv_bwd_plan`). bf16: dx, dw and dbias come
    back in bf16, each rounded once from its fp32 total; dx runs on the
    tensor cores. Launches count under "conv_bn_stats_bwd" (fp32) or
    "conv_bn_stats_bwd.bf16"."""
    dtype = _io_dtype("conv_bn_stats_bwd", x, w, y, dy)
    if x.device.type == "cpu":
        return conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx)
    bf = dtype == torch.bfloat16
    _build.require_cuda("conv_bn_stats_bwd", torch.bfloat16 if bf else torch.float32, x, w, y, dy)
    _build.require_cuda_f32("conv_bn_stats_bwd", ds, dq)
    if ds.device != x.device:
        raise ValueError("conv_bn_stats_bwd: all tensors must be on one CUDA device")
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    if (tuple(w.shape) != (3, 3, Ci, Co) or tuple(y.shape) != (B, T, F, Co)
            or tuple(dy.shape) != (B, T, F, Co) or ds.numel() != F * Co
            or dq.numel() != F * Co):
        raise ValueError(f"conv_bn_stats_bwd: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"y {tuple(y.shape)}, dy {tuple(dy.shape)}")
    plan = conv_bwd_plan(B, T, F, Ci, Co, bf16=bf)
    x, y, dy, ds, dq = (_aligned(t) for t in (x, y, dy, ds, dq))
    dev = x.device
    wt = None
    if need_dx:  # w flipped in (dt, df); transposed to [3, 3, Co, Ci] for the fp32 kernel
        wt = (w.flip(0, 1) if bf else w.flip(0, 1).transpose(2, 3)).contiguous()
    dx = torch.empty_like(x) if need_dx else None
    dye = torch.empty_like(y) if need_dx or not plan.stream else None
    part_w = torch.empty((plan.chunks, 9 * Ci, Co), device=dev, dtype=torch.float32)
    n_b = plan.eff_blocks if bf and not plan.stream else plan.chunks
    part_b = torch.empty((n_b, Co), device=dev, dtype=torch.float32)
    dw = torch.empty((3, 3, Ci, Co), device=dev, dtype=dtype)
    dbias = torch.empty((Co,), device=dev, dtype=dtype)
    entry = "conv_bn_stats_bwd_bf16" if bf else "conv_bn_stats_bwd"
    fn = _build.function("fused_cnn", entry, [_build.P] * 12 + [_build.I] * 5 + [_build.P] * 2)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(x.data_ptr(), ptr(wt), y.data_ptr(), dy.data_ptr(), ds.data_ptr(),
             dq.data_ptr(), ptr(dye), ptr(dx), part_w.data_ptr(), part_b.data_ptr(),
             dw.data_ptr(), dbias.data_ptr(), B, T, F, Ci, Co, _c_ints(plan),
             _build.stream_ptr(x))
    _build.check(err, entry)
    _build.count_launch("conv_bn_stats_bwd.bf16" if bf else "conv_bn_stats_bwd")
    return dx, dw, dbias


def glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bits, g, *, pool, keep_prob=1.0):
    """Backward of glu_drop_pool (see `glu_drop_pool_bwd_plain`), one pass
    over y recomputing BN(y), the GLU product and the sigmoid, at any Co up
    to GLU_MAX_CP and any F (`glu_bwd_plan`). y, wg, bg, g all float32 or
    all bf16; scale_f, bias_f float32. Deterministic: per-block partial sums
    in a fixed order. bf16: dy, dwg and dbg come back in bf16 (dwg and dbg
    rounded once from their fp32 totals), dscale_f and dbias_f in fp32; at
    Co = 16, 32, 64 and 128 (`glu_bwd_frag_takes`) lin runs on the tensor
    cores.
    Launches count under "glu_drop_pool_bwd" (fp32) or
    "glu_drop_pool_bwd.bf16"."""
    dtype = _io_dtype("glu_drop_pool_bwd", y, wg, bg, g)
    if y.device.type == "cpu":
        return glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bits, g,
                                       pool=pool, keep_prob=keep_prob)
    bf = dtype == torch.bfloat16
    _build.require_cuda("glu_drop_pool_bwd", torch.bfloat16 if bf else torch.float32, y, wg, bg, g)
    _build.require_cuda_f32("glu_drop_pool_bwd", scale_f, bias_f)
    if scale_f.device != y.device:
        raise ValueError("glu_drop_pool_bwd: all tensors must be on one CUDA device")
    B, T, F, Co = y.shape
    pt, pf = pool
    if (scale_f.numel() != F * Co or bias_f.numel() != F * Co or tuple(wg.shape) != (Co, Co)
            or tuple(g.shape) != (B, T // pt, F // pf, Co)):
        raise ValueError("glu_drop_pool_bwd: scale_f/bias_f must be [F*Co], wg [Co, Co], "
                         "g [B, T//pt, F//pf, Co]")
    if bits is not None and (bits.dtype != torch.uint8 or bits.numel() != y.numel()
                             or not bits.is_contiguous() or bits.device != y.device):
        raise ValueError("glu_drop_pool_bwd: bits must be contiguous uint8 like y")
    plan = glu_bwd_plan(B, T, F, Co, bf16=bf)
    y, scale_f, bias_f, g = (_aligned(t) for t in (y, scale_f, bias_f, g))
    bits = None if bits is None else _aligned(bits)
    dev = y.device
    L = F * Co
    dy = torch.empty_like(y)
    part_l = torch.empty((plan.n_blocks, 3, L), device=dev, dtype=torch.float32)
    part_w = torch.empty((plan.n_blocks, Co * Co), device=dev, dtype=torch.float32)
    dscale_f = torch.empty((L,), device=dev, dtype=torch.float32)
    dbias_f = torch.empty((L,), device=dev, dtype=torch.float32)
    dwg = torch.empty((Co, Co), device=dev, dtype=dtype)
    dbg = torch.empty((Co,), device=dev, dtype=dtype)
    wgt = wg.t().contiguous() if plan.passes > 1 else None  # the wide kernel's Wg^T slices
    entry = "glu_drop_pool_bwd_bf16" if bf else "glu_drop_pool_bwd"
    fn = _build.function("fused_cnn", entry,
                         [_build.P] * 15 + [_build.I] * 7 + [_build.Fl, _build.P, _build.P])
    err = fn(y.data_ptr(), scale_f.data_ptr(), bias_f.data_ptr(), wg.data_ptr(),
             None if wgt is None else wgt.data_ptr(), bg.data_ptr(),
             None if bits is None else bits.data_ptr(), g.data_ptr(),
             dy.data_ptr(), part_l.data_ptr(), part_w.data_ptr(), dscale_f.data_ptr(),
             dbias_f.data_ptr(), dwg.data_ptr(), dbg.data_ptr(), B, T, F, Co, pt, pf,
             keep_threshold(keep_prob), 1.0 / keep_prob, _c_ints(plan), _build.stream_ptr(y))
    _build.check(err, entry)
    _build.count_launch("glu_drop_pool_bwd.bf16" if bf else "glu_drop_pool_bwd")
    return dy, dscale_f, dbias_f, dwg, dbg


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------


class ConvBnStats(torch.autograd.Function):
    """(y, s, q) = conv_bn_stats(x, w, bias) with conv_bn_stats_bwd as its
    backward; dx is skipped when x needs no gradient."""

    @staticmethod
    def forward(ctx, x, w, bias):
        y, s, q = conv_bn_stats(x, w, bias)
        ctx.save_for_backward(x, w, y)
        return y, s, q

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, y = ctx.saved_tensors
        dx, dw, dbias = conv_bn_stats_bwd(x, w, y, dy.contiguous(), ds.contiguous(),
                                          dq.contiguous(), ctx.needs_input_grad[0])
        return dx, dw, dbias


class GluDropPool(torch.autograd.Function):
    """z = glu_drop_pool(y, scale_f, bias_f, wg, bg, bits) with
    glu_drop_pool_bwd as its backward; the dropout bits are saved as they
    are, so the backward drops the same elements."""

    @staticmethod
    def forward(ctx, y, scale_f, bias_f, wg, bg, bits, pool, keep_prob):
        z = glu_drop_pool(y, scale_f, bias_f, wg, bg, bits, pool=pool, keep_prob=keep_prob)
        ctx.save_for_backward(y, scale_f, bias_f, wg, bg, bits)
        ctx.pool, ctx.keep_prob = pool, keep_prob
        return z

    @staticmethod
    def backward(ctx, g):
        y, scale_f, bias_f, wg, bg, bits = ctx.saved_tensors
        dy, dsc, dbi, dwg, dbg = glu_drop_pool_bwd(
            y, scale_f, bias_f, wg, bg, bits, g.contiguous(), pool=ctx.pool,
            keep_prob=ctx.keep_prob)
        return dy, dsc, dbi, dwg, dbg, None, None, None


# --------------------------------------------------------------------------
# block-level glue
# --------------------------------------------------------------------------


def fused_glu_block(
    x, w, bias, gamma, beta, ra_mean, ra_var, wg, bg,
    *, pool, train: bool, dropout_rate: float = 0.0, bits=None,
    generator: torch.Generator | None = None, eps: float = 1e-3,
    momentum: float = 0.01,
):
    """One CNN block: conv3x3(SAME) + BatchNorm + GLU + dropout + avgpool.

    x [B, T, F, Ci]; w [3, 3, Ci, Co]; the rest [Co] except wg [Co, Co].
    Returns (z [B, T//pt, F//pf, Co], new_ra_mean, new_ra_var) with flax
    BatchNorm semantics: biased batch variance, ra = m*ra + (1-m)*batch.
    In train mode with dropout, `bits` (uint8 [B, T, F*Co]) may be given;
    otherwise they are drawn from `generator` (on x's device). The kernels
    enter the autograd graph only when grad mode is on and an input needs a
    gradient; the running-statistics update is detached (pallas_cnn.py:720).
    bf16 x: w, the conv bias, wg and bg are rounded to bf16 (pallas_cnn.py:
    713, :738), the kernels run in their bf16 mode and z is bf16; the BN
    statistics, scale and bias stay fp32 (:727-728). The backward kernels'
    bf16 mode gives the bf16 gradients of the rounded parameters, which the
    cast's backward carries to fp32 parameters unchanged (JAX's astype VJP).
    """
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, bias, gamma, beta, wg, bg))
    if x.dtype == torch.bfloat16:
        w, bias, wg, bg = (t.to(torch.bfloat16) for t in (w, bias, wg, bg))
    w, bias, wg, bg = w.contiguous(), bias.contiguous(), wg.contiguous(), bg.contiguous()
    if grad:
        y, s, q = ConvBnStats.apply(x, w, bias)
    else:
        y, s, q = conv_bn_stats(x, w, bias)
    if train:
        n = B * T * F
        mean = s.view(F, Co).sum(0) / n
        var = q.view(F, Co).sum(0) / n - mean * mean
        new_mean = momentum * ra_mean + (1.0 - momentum) * mean.detach()
        new_var = momentum * ra_var + (1.0 - momentum) * var.detach()
    else:
        mean, var = ra_mean, ra_var
        new_mean, new_var = ra_mean, ra_var
    scale = gamma * torch.rsqrt(var + eps)
    bias_bn = beta - mean * scale
    keep = 1.0
    if train and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        if bits is None:
            bits = random_bytes((B, T, F * Co), generator, x.device)
    else:
        bits = None
    scale_f = scale.repeat(F).float().contiguous()
    bias_f = bias_bn.repeat(F).float().contiguous()
    if grad:
        z = GluDropPool.apply(y, scale_f, bias_f, wg, bg, bits, tuple(pool), keep)
    else:
        z = glu_drop_pool(y, scale_f, bias_f, wg, bg, bits, pool=tuple(pool), keep_prob=keep)
    return z, new_mean, new_var
