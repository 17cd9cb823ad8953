"""Convolutional feature extractor (counterpart of desed_task_tpu/models/cnn.py).

A stack of [conv -> BatchNorm -> GLU -> avg-pool] blocks on NHWC activations
[B, T, F, C], the blocks of every DCASE 2021-2024 recipe, in two forms over
the same parameters:

  * fused (`fused_blocks=True`): each GLU + BatchNorm + 3x3/stride-1/pad-1
    block is one `ops.fused_cnn.fused_glu_block` call (two CUDA kernels on
    the card, and two backward kernels), as the JAX model selects its
    Pallas blocks (cnn.py:279-296), at any width;
  * unfused: the plain reference chain, conv (per-tap products), BatchNorm
    eps 1e-3, GLU, avg-pool with floor semantics.

`compute_dtype` (the JAX CNN's `dtype`, cnn.py:298-301): None runs in fp32;
bf16 casts the input to bf16 and runs the stack in bf16, the parameters and
BatchNorm statistics staying fp32. Fused, the kernels' bf16 mode; unfused,
the flax chain's rounding points: the conv of bf16 operands summed in fp32
and rounded, + bias in bf16 (cnn.py:168-172), BatchNorm in fp32 with a bf16
output (:316-323), the GLU's Dense in bf16 (product rounded, + bias
rounded), its sigmoid as jax.nn.sigmoid lowers it for bf16 (1 / (1 +
exp(-x)), each op rounded), the gate product rounded (:29-35), dropout in
bf16, and nn.avg_pool's bf16 sums in window order (each add rounded), then
the division by the window. Both forms train in bf16: the fused blocks
through the backward kernels' bf16 mode (the fp32 parameters receive the
bf16 gradients of their rounded copies, as JAX's astype VJP gives them),
the unfused chain through autograd.

GLU(x) = Linear(x) * sigmoid(x) (the gate is the raw input, cnn.py:29-35);
it is not torch.nn.GLU, which splits channels. The JAX module's other
activations (relu, leakyrelu, context gating) and its "layer" normalization
are not ported.

Train mode (flax BatchNorm and PackedDropout semantics, cnn.py:316-342):
BatchNorm normalizes with the biased batch statistics and updates its
running buffers in place (ra = 0.01 ra + 0.99 batch, under no_grad); conv
dropout keeps where a uniform byte < round(keep * 256), the bytes drawn as
uint8 [B, T, F*Co] from the caller's generator. Both forms draw the same
bytes in the same order, so they drop the same elements from generators in
the same state. The fused form's gradients come from the backward kernels
(`ops.fused_cnn`); the unfused chain is differentiated by autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.dropout import packed_keep_mask
from ..ops.fused_cnn import conv2d_nhwc, fused_glu_block

BN_MOMENTUM = 0.01  # flax convention (torch momentum 0.99), cnn.py:319
BN_EPS = 1e-3
BF16 = torch.bfloat16


def resolve_compute_dtype(dtype) -> torch.dtype | None:
    """The conv stack's compute dtype: None (fp32), or torch.bfloat16 for
    torch.bfloat16 / "bfloat16"."""
    if dtype is None or dtype in (torch.float32, "float32"):
        return None
    if dtype in (BF16, "bfloat16"):
        return BF16
    raise ValueError(f"compute_dtype {dtype!r}: None (fp32) or bfloat16")


def _bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16, in fp32 (the value a bf16 op of flax leaves)."""
    return t.to(BF16).float()


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid of a bf16 array: 1 / (1 + exp(-x)), each op's output
    rounded to bf16 (fp32 in, fp32 out)."""
    return _bf(1.0 / _bf(1.0 + _bf(torch.exp(-x))))


class Conv2d(nn.Module):
    """Parameters of one convolution in torch layout: weight [Co, Ci, k, k]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def hwio(self) -> torch.Tensor:
        """The weight as [k, k, Ci, Co] (the JAX package's layout)."""
        return self.weight.permute(2, 3, 1, 0).contiguous()


class BatchNorm(nn.Module):
    """Affine parameters and running statistics of one BatchNorm (eps 1e-3)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x, train: bool = False):
        """Normalize over all axes but the last; in train mode with the
        biased batch statistics, updating the running buffers."""
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = ((x * x).mean(dim=dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        return (x - mean) * scale + self.bias


class GLU(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.linear = nn.Linear(ch, ch)

    def forward(self, x):
        return self.linear(x) * torch.sigmoid(x)


def avg_pool_floor(x, pt: int, pf: int):
    """[B, T, F, C] -> [B, T//pt, F//pf, C] (torch AvgPool2d floor semantics)."""
    B, T, F, C = x.shape
    To, Fo = T // pt, F // pf
    return x[:, : To * pt, : Fo * pf].reshape(B, To, pt, Fo, pf, C).mean(dim=(2, 4))


def avg_pool_floor_bf16(x, pt: int, pf: int):
    """avg_pool_floor as flax's nn.avg_pool does it on bf16 values (fp32 in,
    fp32 out): the window's elements added in window order, each sum
    rounded to bf16, then divided by the window and rounded."""
    B, T, F, C = x.shape
    To, Fo = T // pt, F // pf
    xw = x[:, : To * pt, : Fo * pf].reshape(B, To, pt, Fo, pf, C)
    acc = None
    for i in range(pt):
        for j in range(pf):
            v = xw[:, :, i, :, j]
            acc = v if acc is None else _bf(acc + v)
    return _bf(acc / (pt * pf))


class CNN(nn.Module):
    """Input [B, T, F, n_in_channel] -> [B, T', F', nb_filters[-1]]."""

    def __init__(
        self,
        n_in_channel: int = 1,
        activation: str = "glu",
        conv_dropout: float = 0.0,
        kernel_size: Sequence[int] = (3, 3, 3),
        padding: Sequence[int] = (1, 1, 1),
        stride: Sequence[int] = (1, 1, 1),
        nb_filters: Sequence[int] = (64, 64, 64),
        pooling: Sequence[Sequence[int]] = ((1, 4), (1, 4), (1, 4)),
        normalization: str = "batch",
        fused_blocks: bool = True,
        compute_dtype=None,
    ):
        super().__init__()
        if activation.lower() != "glu" or normalization != "batch":
            raise NotImplementedError(
                f"activation {activation!r} / normalization {normalization!r}: "
                "only glu + batch is ported")
        self.conv_dropout = conv_dropout  # training only
        self.kernel_size = list(kernel_size)
        self.padding = list(padding)
        self.stride = list(stride)
        self.pooling = [tuple(p) for p in pooling]
        self.fused_blocks = fused_blocks
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        in_ch = n_in_channel
        for i, out_ch in enumerate(nb_filters):
            self.add_module(f"conv{i}", Conv2d(in_ch, out_ch, self.kernel_size[i]))
            self.add_module(f"batchnorm{i}", BatchNorm(out_ch))
            self.add_module(f"glu{i}", GLU(out_ch))
            in_ch = out_ch
        self.n_blocks = len(nb_filters)

    def out_freq(self, n_freq: int) -> int:
        """F' after the stack for an input of n_freq bins."""
        for i in range(self.n_blocks):
            k, s, p = self.kernel_size[i], self.stride[i], self.padding[i]
            n_freq = ((n_freq + 2 * p - k) // s + 1) // self.pooling[i][1]
        return n_freq

    def _is_fused(self, i: int) -> bool:
        """Block i takes the fused kernels: a 3x3, stride-1, pad-1 conv."""
        return bool(self.fused_blocks and self.kernel_size[i] == 3
                    and self.stride[i] == 1 and self.padding[i] == 1)

    def forward(self, x, train: bool | None = None, generator: torch.Generator | None = None):
        """x [B, T, F, C]; `train` defaults to self.training. Conv dropout in
        train mode draws from `generator` (on x's device). Returns the
        compute dtype's tensor (bf16 where `compute_dtype` is)."""
        train = self.training if train is None else train
        rate = self.conv_dropout if train else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("CNN: train-mode conv dropout needs a torch.Generator")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for i in range(self.n_blocks):
            conv = getattr(self, f"conv{i}")
            bn = getattr(self, f"batchnorm{i}")
            glu = getattr(self, f"glu{i}")
            if self._is_fused(i):
                x, new_mean, new_var = fused_glu_block(
                    x.contiguous(), conv.hwio(), conv.bias, bn.weight, bn.bias,
                    bn.running_mean, bn.running_var, glu.linear.weight.t(),
                    glu.linear.bias, pool=self.pooling[i], train=train,
                    dropout_rate=rate, generator=generator, eps=BN_EPS,
                    momentum=BN_MOMENTUM,
                )
                if train:
                    with torch.no_grad():
                        bn.running_mean.copy_(new_mean)
                        bn.running_var.copy_(new_var)
                continue
            if self.compute_dtype == BF16:
                x = self._unfused_bf16(i, x, train, rate, generator)
                continue
            x = conv2d_nhwc(x, conv.hwio(), conv.bias, self.stride[i], self.padding[i])
            x = glu(bn(x, train))
            if rate > 0.0:  # the fused block's bytes: uint8 [B, T, F*Co]
                B, T, F, Co = x.shape
                keep = packed_keep_mask((B, T, F * Co), 1.0 - rate, generator, x.device)
                x = torch.where(keep.view(x.shape), x * (1.0 / (1.0 - rate)), torch.zeros_like(x))
            x = avg_pool_floor(x, *self.pooling[i])
        return x

    def _unfused_bf16(self, i: int, x, train: bool, rate: float, generator):
        """Block i of the unfused chain in bf16 (bf16 in, bf16 out), rounding
        where the flax chain does (see the module's docstring)."""
        conv = getattr(self, f"conv{i}")
        bn = getattr(self, f"batchnorm{i}")
        lin = getattr(self, f"glu{i}").linear
        y = _bf(conv2d_nhwc(x.float(), _bf(conv.hwio()), None, self.stride[i], self.padding[i]))
        y = _bf(y + _bf(conv.bias))
        y = _bf(bn(y, train))
        z = _bf(_bf(torch.matmul(y, _bf(lin.weight.t()))) + _bf(lin.bias))
        z = _bf(z * sigmoid_bf16(y))
        if rate > 0.0:  # the fused block's bytes: uint8 [B, T, F*Co]
            B, T, F, Co = z.shape
            keep = packed_keep_mask((B, T, F * Co), 1.0 - rate, generator, z.device)
            scale = float(_bf(torch.tensor(1.0 / (1.0 - rate))))
            z = torch.where(keep.view(z.shape), _bf(z * scale), torch.zeros_like(z))
        return avg_pool_floor_bf16(z, *self.pooling[i]).to(BF16)
