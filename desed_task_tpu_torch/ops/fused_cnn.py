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
and its design. Each wrapper takes its plain PyTorch version (`*_plain`,
beside it) only for CPU tensors; for CUDA tensors it launches the kernel or
raises. Two `torch.autograd.Function`s tie each forward to its backward.
`fused_glu_block` keeps the contract of pallas_cnn.py:678-747, with the
BatchNorm scale and bias math in torch, so autograd carries the gradients
of the batch mean and variance back into conv_bn_stats_bwd as ds and dq.

Layouts follow the JAX package: x [B, T, F, Ci] (NHWC), w [3, 3, Ci, Co]
(HWIO), GLU weight wg [Co_in, Co_out] (flax Dense kernel), lane = f*Co + c.
"""

from __future__ import annotations

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


def conv_bn_stats_plain(x, w, bias):
    """y = conv3x3_same(x, w) + bias [B, T, F, Co]; s, q = per-lane sum and
    sum of squares of y over the B*T rows, each [F*Co]."""
    y = conv2d_nhwc(x, w, bias)
    B, T, F, Co = y.shape
    yl = y.reshape(B * T, F * Co)
    return y, yl.sum(0), (yl * yl).sum(0)


def glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits=None, *, pool, keep_prob=1.0):
    """z [B, T//pt, F//pf, Co] = avgpool(drop(GLU(y * scale_f + bias_f)))."""
    B, T, F, Co = y.shape
    pt, pf = pool
    ybn = y * scale_f.view(F, Co) + bias_f.view(F, Co)
    z = (torch.matmul(ybn, wg) + bg) * torch.sigmoid(ybn)
    if bits is not None:
        keep = bits.view(B, T, F, Co).to(torch.int32) < keep_threshold(keep_prob)
        z = torch.where(keep, z * (1.0 / keep_prob), torch.zeros_like(z))
    To, Fo = T // pt, F // pf
    z = z[:, : To * pt, : Fo * pf].reshape(B, To, pt, Fo, pf, Co)
    return z.mean(dim=(2, 4))


def conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx: bool = True):
    """Backward of conv_bn_stats: cotangents dy [B, T, F, Co] of y and ds, dq
    [F*Co] of the lane sums -> (dx [B, T, F, Ci] or None, dw [3, 3, Ci, Co],
    dbias [Co]), with dy_eff = dy + ds + 2 y dq (pallas_cnn.py:207)."""
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    dy_eff = dy + ds.view(F, Co) + 2.0 * y * dq.view(F, Co)
    dbias = dy_eff.sum(dim=(0, 1, 2))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    d2 = dy_eff.reshape(-1, Co)
    dw = torch.stack([
        torch.stack([xp[:, i : i + T, j : j + F].reshape(-1, Ci).t() @ d2 for j in range(3)])
        for i in range(3)])
    dx = None
    if need_dx:  # transposed conv: SAME conv with the flipped, transposed kernel
        dx = conv2d_nhwc(dy_eff, w.flip(0, 1).transpose(2, 3))
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
    (dy [B, T, F, Co], dscale_f [F*Co], dbias_f [F*Co], dwg [Co, Co], dbg [Co])."""
    B, T, F, Co = y.shape
    sc, bi = scale_f.view(F, Co), bias_f.view(F, Co)
    ybn = y * sc + bi
    lin = torch.matmul(ybn, wg) + bg
    s = torch.sigmoid(ybn)
    gu = _unpool(g, T, F, pool)
    if bits is not None:
        keep = bits.view(B, T, F, Co).to(torch.int32) < keep_threshold(keep_prob)
        gu = torch.where(keep, gu * (1.0 / keep_prob), torch.zeros_like(gu))
    dlin = gu * s
    dybn = torch.matmul(dlin, wg.t()) + gu * lin * s * (1.0 - s)
    dscale_f = (dybn * y).sum(dim=(0, 1)).reshape(-1)
    dbias_f = dybn.sum(dim=(0, 1)).reshape(-1)
    dwg = ybn.reshape(-1, Co).t() @ dlin.reshape(-1, Co)
    return dybn * sc, dscale_f, dbias_f, dwg, dlin.sum(dim=(0, 1, 2))


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_STATS_BLOCKS = 512  # target number of blocks in the stats partial pass


def conv_bn_stats(x, w, bias):
    """conv3x3 SAME + bias and the per-lane BN statistics.

    x [B, T, F, Ci], w [3, 3, Ci, Co], bias [Co] (float32) ->
    (y [B, T, F, Co], s [F*Co], q [F*Co]), s/q summed over all B*T rows.
    """
    if x.device.type == "cpu":
        return conv_bn_stats_plain(x, w, bias)
    _build.require_cuda_f32("conv_bn_stats", x, w, bias)
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    if tuple(w.shape) != (3, 3, Ci, Co) or tuple(bias.shape) != (Co,):
        raise ValueError(f"conv_bn_stats: w {tuple(w.shape)}, bias {tuple(bias.shape)}")
    L = F * Co
    n_chunks = max(1, min(B * T, _STATS_BLOCKS // -(-L // 256)))
    y = torch.empty((B, T, F, Co), device=x.device, dtype=torch.float32)
    part = torch.empty((2, n_chunks, L), device=x.device, dtype=torch.float32)
    s = torch.empty((L,), device=x.device, dtype=torch.float32)
    q = torch.empty((L,), device=x.device, dtype=torch.float32)
    fn = _build.function("fused_cnn", "conv_bn_stats",
                         [_build.P] * 8 + [_build.I] * 6 + [_build.P])
    err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
             part[0].data_ptr(), part[1].data_ptr(), s.data_ptr(), q.data_ptr(),
             B, T, F, Ci, Co, n_chunks, _build.stream_ptr(x))
    _build.check(err, "conv_bn_stats")
    _build.count_launch("conv_bn_stats")
    return y, s, q


def glu_drop_pool(y, scale_f, bias_f, wg, bg, bits=None, *, pool, keep_prob=1.0):
    """BN-apply + GLU + optional dropout + T/F avg-pool.

    y [B, T, F, Co]; scale_f, bias_f [F*Co] float32; wg [Co, Co]; bg [Co];
    bits uint8 [B, T, F*Co] or None. Returns z [B, T//pt, F//pf, Co].
    """
    if y.device.type == "cpu":
        return glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits,
                                   pool=pool, keep_prob=keep_prob)
    _build.require_cuda_f32("glu_drop_pool", y, scale_f, bias_f, wg, bg)
    B, T, F, Co = y.shape
    pt, pf = pool
    if scale_f.numel() != F * Co or bias_f.numel() != F * Co or tuple(wg.shape) != (Co, Co):
        raise ValueError("glu_drop_pool: scale_f/bias_f must be [F*Co], wg [Co, Co]")
    if bits is not None:
        if bits.dtype != torch.uint8 or bits.numel() != y.numel() or not bits.is_contiguous():
            raise ValueError("glu_drop_pool: bits must be contiguous uint8 like y")
        if bits.device != y.device:
            raise ValueError("glu_drop_pool: bits must be on y's device")
    z = torch.empty((B, T // pt, F // pf, Co), device=y.device, dtype=torch.float32)
    fn = _build.function("fused_cnn", "glu_drop_pool",
                         [_build.P] * 7 + [_build.I] * 7 + [_build.Fl, _build.P])
    err = fn(y.data_ptr(), scale_f.data_ptr(), bias_f.data_ptr(), wg.data_ptr(),
             bg.data_ptr(), None if bits is None else bits.data_ptr(), z.data_ptr(),
             B, T, F, Co, pt, pf, keep_threshold(keep_prob), 1.0 / keep_prob,
             _build.stream_ptr(y))
    _build.check(err, "glu_drop_pool")
    _build.count_launch("glu_drop_pool")
    return z


def conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx: bool = True):
    """Backward of conv_bn_stats (see `conv_bn_stats_bwd_plain`); dx is
    skipped when `need_dx` is false. Deterministic: per-chunk partial sums
    of dW and dbias, added in a fixed order."""
    if x.device.type == "cpu":
        return conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx)
    _build.require_cuda_f32("conv_bn_stats_bwd", x, w, y, dy, ds, dq)
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    if (tuple(w.shape) != (3, 3, Ci, Co) or tuple(y.shape) != (B, T, F, Co)
            or tuple(dy.shape) != (B, T, F, Co) or ds.numel() != F * Co
            or dq.numel() != F * Co):
        raise ValueError(f"conv_bn_stats_bwd: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"y {tuple(y.shape)}, dy {tuple(dy.shape)}")
    n_chunks = _build.function("fused_cnn", "conv_bn_stats_bwd_chunks",
                               [_build.I] * 5)(B, T, F, Ci, Co)
    dev = x.device
    wt = w.flip(0, 1).transpose(2, 3).contiguous() if need_dx else None
    dx = torch.empty_like(x) if need_dx else None
    part_w = torch.empty((n_chunks, 9 * Ci, Co), device=dev, dtype=torch.float32)
    part_b = torch.empty((n_chunks, Co), device=dev, dtype=torch.float32)
    dw = torch.empty((3, 3, Ci, Co), device=dev, dtype=torch.float32)
    dbias = torch.empty((Co,), device=dev, dtype=torch.float32)
    fn = _build.function("fused_cnn", "conv_bn_stats_bwd",
                         [_build.P] * 11 + [_build.I] * 6 + [_build.P])
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(x.data_ptr(), ptr(wt), y.data_ptr(), dy.data_ptr(), ds.data_ptr(),
             dq.data_ptr(), ptr(dx), part_w.data_ptr(), part_b.data_ptr(),
             dw.data_ptr(), dbias.data_ptr(), B, T, F, Ci, Co, n_chunks,
             _build.stream_ptr(x))
    _build.check(err, "conv_bn_stats_bwd")
    _build.count_launch("conv_bn_stats_bwd")
    return dx, dw, dbias


def glu_drop_pool_bwd(y, scale_f, bias_f, wg, bg, bits, g, *, pool, keep_prob=1.0):
    """Backward of glu_drop_pool (see `glu_drop_pool_bwd_plain`), one pass
    over y recomputing BN(y), the GLU product and the sigmoid. Needs
    Co <= 128. Deterministic: per-block partial sums in a fixed order."""
    if y.device.type == "cpu":
        return glu_drop_pool_bwd_plain(y, scale_f, bias_f, wg, bg, bits, g,
                                       pool=pool, keep_prob=keep_prob)
    _build.require_cuda_f32("glu_drop_pool_bwd", y, scale_f, bias_f, wg, bg, g)
    B, T, F, Co = y.shape
    pt, pf = pool
    if (scale_f.numel() != F * Co or bias_f.numel() != F * Co or tuple(wg.shape) != (Co, Co)
            or tuple(g.shape) != (B, T // pt, F // pf, Co)):
        raise ValueError("glu_drop_pool_bwd: scale_f/bias_f must be [F*Co], wg [Co, Co], "
                         "g [B, T//pt, F//pf, Co]")
    if bits is not None and (bits.dtype != torch.uint8 or bits.numel() != y.numel()
                             or not bits.is_contiguous() or bits.device != y.device):
        raise ValueError("glu_drop_pool_bwd: bits must be contiguous uint8 like y")
    n_blocks = _build.function("fused_cnn", "glu_drop_pool_bwd_blocks",
                               [_build.I] * 3)(B * T, F, Co)
    if n_blocks <= 0:
        raise ValueError(f"glu_drop_pool_bwd: F={F}, Co={Co} do not fit the kernel "
                         "(Co <= 128 and one frame of F*Co lanes in shared memory)")
    dev = y.device
    L = F * Co
    dy = torch.empty_like(y)
    part_l = torch.empty((n_blocks, 3, L), device=dev, dtype=torch.float32)
    part_w = torch.empty((n_blocks, Co * Co), device=dev, dtype=torch.float32)
    dscale_f = torch.empty((L,), device=dev, dtype=torch.float32)
    dbias_f = torch.empty((L,), device=dev, dtype=torch.float32)
    dwg = torch.empty((Co, Co), device=dev, dtype=torch.float32)
    dbg = torch.empty((Co,), device=dev, dtype=torch.float32)
    fn = _build.function("fused_cnn", "glu_drop_pool_bwd",
                         [_build.P] * 14 + [_build.I] * 8 + [_build.Fl, _build.P])
    err = fn(y.data_ptr(), scale_f.data_ptr(), bias_f.data_ptr(), wg.data_ptr(),
             bg.data_ptr(), None if bits is None else bits.data_ptr(), g.data_ptr(),
             dy.data_ptr(), part_l.data_ptr(), part_w.data_ptr(), dscale_f.data_ptr(),
             dbias_f.data_ptr(), dwg.data_ptr(), dbg.data_ptr(), B, T, F, Co, pt, pf,
             keep_threshold(keep_prob), n_blocks, 1.0 / keep_prob, _build.stream_ptr(y))
    _build.check(err, "glu_drop_pool_bwd")
    _build.count_launch("glu_drop_pool_bwd")
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
    """
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    w, bias, wg, bg = w.contiguous(), bias.contiguous(), wg.contiguous(), bg.contiguous()
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w, bias, gamma, beta, wg, bg))
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
