"""Fused CNN block: conv3x3 + BatchNorm + GLU + dropout + avg-pool.

Counterpart of desed_task_tpu/ops/pallas_cnn.py. Two hand-written CUDA
kernels (csrc/fused_cnn.cu) carry one block:

  conv_bn_stats   conv3x3 SAME + bias -> y, and the per-(f, c) sum and sum
                  of squares of y over all rows (the BatchNorm batch stats).
                  Replaces _conv_stats_kernel (pallas_cnn.py:147, :403).
  glu_drop_pool   BN as a per-lane affine, GLU = (ybn Wg + bg) sigmoid(ybn),
                  optional dropout from given uint8 bits, T- and F-avg-pool.
                  Replaces _epilogue_kernel (pallas_cnn.py:269, :589).

The source notes in csrc/fused_cnn.cu give each kernel's bound on the H100
and its design. Each wrapper takes its plain PyTorch version (`*_plain`,
beside it) only for CPU tensors; for CUDA tensors it launches the kernel or
raises. `fused_glu_block` keeps the contract of pallas_cnn.py:678-747, with
the BatchNorm scale and bias math in torch.

Layouts follow the JAX package: x [B, T, F, Ci] (NHWC), w [3, 3, Ci, Co]
(HWIO), GLU weight wg [Co_in, Co_out] (flax Dense kernel), lane = f*Co + c.
"""

from __future__ import annotations

import torch

from . import _build

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


def _keep_threshold(keep_prob: float) -> int:
    """uint8 keep threshold of pallas_cnn.py:573 (256 keeps every element)."""
    return min(int(round(keep_prob * 256)), 255) if keep_prob < 1.0 else 256


def glu_drop_pool_plain(y, scale_f, bias_f, wg, bg, bits=None, *, pool, keep_prob=1.0):
    """z [B, T//pt, F//pf, Co] = avgpool(drop(GLU(y * scale_f + bias_f)))."""
    B, T, F, Co = y.shape
    pt, pf = pool
    ybn = y * scale_f.view(F, Co) + bias_f.view(F, Co)
    z = (torch.matmul(ybn, wg) + bg) * torch.sigmoid(ybn)
    if bits is not None:
        keep = bits.view(B, T, F, Co).to(torch.int32) < _keep_threshold(keep_prob)
        z = torch.where(keep, z * (1.0 / keep_prob), torch.zeros_like(z))
    To, Fo = T // pt, F // pf
    z = z[:, : To * pt, : Fo * pf].reshape(B, To, pt, Fo, pf, Co)
    return z.mean(dim=(2, 4))


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
             B, T, F, Co, pt, pf, _keep_threshold(keep_prob), 1.0 / keep_prob,
             _build.stream_ptr(y))
    _build.check(err, "glu_drop_pool")
    _build.count_launch("glu_drop_pool")
    return z


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
    otherwise they are drawn from `generator`.
    """
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    y, s, q = conv_bn_stats(x, w.contiguous(), bias.contiguous())
    if train:
        n = B * T * F
        mean = s.view(F, Co).sum(0) / n
        var = q.view(F, Co).sum(0) / n - mean * mean
        new_mean = momentum * ra_mean + (1.0 - momentum) * mean
        new_var = momentum * ra_var + (1.0 - momentum) * var
    else:
        mean, var = ra_mean, ra_var
        new_mean, new_var = ra_mean, ra_var
    scale = gamma * torch.rsqrt(var + eps)
    bias_bn = beta - mean * scale
    keep = 1.0
    if train and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        if bits is None:
            bits = torch.randint(0, 256, (B, T, F * Co), dtype=torch.uint8,
                                 device=x.device, generator=generator)
    else:
        bits = None
    z = glu_drop_pool(y, scale.repeat(F).float().contiguous(),
                      bias_bn.repeat(F).float().contiguous(), wg.contiguous(),
                      bg.contiguous(), bits, pool=tuple(pool), keep_prob=keep)
    return z, new_mean, new_var
