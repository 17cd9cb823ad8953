"""Convolutional feature extractor (counterpart of desed_task_tpu/models/cnn.py).

A stack of [conv -> normalization -> activation -> dropout -> avg-pool]
blocks on NHWC activations [B, T, F, C], in two forms over the same
parameters:

  * fused (`fused_blocks=True`): each GLU + BatchNorm + 3x3/stride-1/pad-1
    block (the blocks of every DCASE 2021-2024 recipe) is one
    `ops.fused_cnn.fused_glu_block` call (two CUDA kernels on the card, and
    two backward kernels), as the JAX model selects its Pallas blocks
    (cnn.py:279-296), at any width;
  * unfused: the plain reference chain, conv (per-tap products), then
    BatchNorm eps 1e-3 ("batch"), GroupNorm(1) eps 1e-5 over (T, F, C) per
    example ("layer", module `layernorm{i}`) or nothing (any other string,
    as JAX's `if batch / elif layer`), then the activation, then avg-pool
    with floor semantics. Every block the fused form does not take runs it.

Activations (cnn.py:29-44, :325-336): GLU(x) = Linear(x) * sigmoid(x), the
gate the raw input (not torch.nn.GLU, which splits channels); relu;
leakyrelu with slope 0.2; cg, context gating, x * sigmoid(Linear(x)). GLU
and cg own a Linear (`glu{i}.linear`, `cg{i}.linear`); relu and leakyrelu
own nothing, so each block holds only the modules the JAX block creates.

`compute_dtype` (the JAX CNN's `dtype`, cnn.py:298-301): None runs in fp32;
bf16 casts the input to bf16 and runs the stack in bf16, the parameters and
normalization statistics staying fp32. Fused, the kernels' bf16 mode;
unfused, the flax chain's rounding points: the conv of bf16 operands summed
in fp32 and rounded, + bias in bf16 (cnn.py:168-172), BatchNorm in fp32
with a bf16 output (:316-323), the Dense of GLU and cg in bf16 (its input
rounded, product rounded, + bias rounded), sigmoid as jax.nn.sigmoid lowers
it for bf16 (1 / (1 + exp(-x)), each op rounded), the gate product rounded
(:29-44), leakyrelu's product with the slope rounded to bf16, dropout in
bf16, and nn.avg_pool's bf16 sums in window order (each add rounded), then
the division by the window. flax's GroupNorm has no dtype and fp32
parameters, so it returns fp32 on a bf16 input: a "layer" block runs the
rest of the block in fp32 (a bf16 Dense still rounds its operands and
output; their products with fp32 values are fp32), and the next conv casts
back to bf16. Both forms train in bf16: the fused blocks through the
backward kernels' bf16 mode (the fp32 parameters receive the bf16
gradients of their rounded copies, as JAX's astype VJP gives them), the
unfused chain through autograd.

Train mode (flax BatchNorm and PackedDropout semantics, cnn.py:316-342):
BatchNorm normalizes with the biased batch statistics and updates its
running buffers in place (ra = 0.01 ra + 0.99 batch, under no_grad); conv
dropout keeps where a uniform byte < round(keep * 256), the bytes drawn as
uint8 [B, T, F*Co] from the caller's generator. Both forms draw the same
bytes in the same order, so they drop the same elements from generators in
the same state. With `packed_dropout=False` the unfused chain draws a
Bernoulli(1 - rate) mask as nn.Dropout does (`ops.dropout.dropout`); the
fused blocks ignore the option, as JAX's do (cnn.py:345-368). The fused
form's gradients come from the backward kernels (`ops.fused_cnn`); the
unfused chain is differentiated by autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.dropout import packed_keep_mask
from ..ops.fused_cnn import conv2d_nhwc, fused_glu_block

BN_MOMENTUM = 0.01  # flax convention (torch momentum 0.99), cnn.py:319
BN_EPS = 1e-3
LN_EPS = 1e-5  # nn.GroupNorm(num_groups=1, epsilon=1e-5), cnn.py:324
LEAKY_SLOPE = 0.2  # nn.leaky_relu(x, negative_slope=0.2), cnn.py:329
ACTIVATIONS = ("glu", "relu", "leakyrelu", "cg")
BF16 = torch.bfloat16
LEAKY_SLOPE_BF16 = float(torch.tensor(LEAKY_SLOPE).to(BF16))  # 0.2001953125


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


class GroupNorm1(nn.Module):
    """flax nn.GroupNorm(num_groups=1): each example normalized over all its
    axes but the first, with one scale and bias a channel (eps 1e-5)."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        """x [B, ..., C] in any float dtype -> fp32 (flax's statistics and
        output are fp32 for fp32 parameters)."""
        x = x.float()
        dims = tuple(range(1, x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x * x).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


class GLU(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.linear = nn.Linear(ch, ch)

    def forward(self, x):
        return self.linear(x) * torch.sigmoid(x)


class ContextGating(nn.Module):
    """x * sigmoid(Linear(x)) (cnn.py:38-44)."""

    def __init__(self, ch: int):
        super().__init__()
        self.linear = nn.Linear(ch, ch)

    def forward(self, x):
        return x * torch.sigmoid(self.linear(x))


def leaky_relu(x, half: bool = False):
    """nn.leaky_relu(x, 0.2); `half`: x holds bf16 values and the product
    with the slope (a bf16 scalar there) is rounded."""
    if half:
        return torch.where(x >= 0, x, _bf(x * LEAKY_SLOPE_BF16))
    return torch.where(x >= 0, x, x * LEAKY_SLOPE)


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
        packed_dropout: bool = True,
    ):
        super().__init__()
        self.activation = activation.lower()
        if self.activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.normalization = normalization
        self.conv_dropout = conv_dropout  # training only
        self.packed_dropout = packed_dropout
        self.kernel_size = list(kernel_size)
        self.padding = list(padding)
        self.stride = list(stride)
        self.pooling = [tuple(p) for p in pooling]
        self.fused_blocks = fused_blocks
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        in_ch = n_in_channel
        for i, out_ch in enumerate(nb_filters):
            self.add_module(f"conv{i}", Conv2d(in_ch, out_ch, self.kernel_size[i]))
            if normalization == "batch":
                self.add_module(f"batchnorm{i}", BatchNorm(out_ch))
            elif normalization == "layer":
                self.add_module(f"layernorm{i}", GroupNorm1(out_ch))
            if self.activation == "glu":
                self.add_module(f"glu{i}", GLU(out_ch))
            elif self.activation == "cg":
                self.add_module(f"cg{i}", ContextGating(out_ch))
            in_ch = out_ch
        self.n_blocks = len(nb_filters)

    def out_freq(self, n_freq: int) -> int:
        """F' after the stack for an input of n_freq bins."""
        for i in range(self.n_blocks):
            k, s, p = self.kernel_size[i], self.stride[i], self.padding[i]
            n_freq = ((n_freq + 2 * p - k) // s + 1) // self.pooling[i][1]
        return n_freq

    def _is_fused(self, i: int) -> bool:
        """Block i takes the fused kernels: GLU + BatchNorm on a 3x3,
        stride-1, pad-1 conv (cnn.py:279-296)."""
        return bool(self.fused_blocks and self.activation == "glu"
                    and self.normalization == "batch" and self.kernel_size[i] == 3
                    and self.stride[i] == 1 and self.padding[i] == 1)

    def forward(self, x, train: bool | None = None, generator: torch.Generator | None = None):
        """x [B, T, F, C]; `train` defaults to self.training. Conv dropout in
        train mode draws from `generator` (on x's device). Returns the
        compute dtype's tensor (bf16 where `compute_dtype` is, unless the
        last block is a "layer" block, which returns fp32 as flax's does)."""
        train = self.training if train is None else train
        rate = self.conv_dropout if train else 0.0
        if rate > 0.0 and generator is None:
            raise ValueError("CNN: train-mode conv dropout needs a torch.Generator")
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        for i in range(self.n_blocks):
            if self._is_fused(i):
                conv = getattr(self, f"conv{i}")
                bn = getattr(self, f"batchnorm{i}")
                glu = getattr(self, f"glu{i}")
                x, new_mean, new_var = fused_glu_block(
                    x.contiguous(), conv.hwio(), conv.bias, bn.weight, bn.bias,
                    bn.running_mean, bn.running_var, glu.linear.weight.t(), glu.linear.bias,
                    pool=self.pooling[i], train=train, dropout_rate=rate,
                    generator=generator, eps=BN_EPS, momentum=BN_MOMENTUM,
                )
                if train:
                    with torch.no_grad():
                        bn.running_mean.copy_(new_mean)
                        bn.running_var.copy_(new_var)
            elif self.compute_dtype == BF16:
                x = self._unfused_bf16(i, x, train, rate, generator)
            else:
                x = self._unfused(i, x, train, rate, generator)
        return x

    def _drop(self, x, rate: float, generator, half: bool = False):
        """Train-mode conv dropout of the unfused chain: the fused block's
        bytes, uint8 [B, T, F*Co], kept elements times 1 / keep
        (PackedDropout), or with `packed_dropout=False` nn.Dropout's
        Bernoulli(keep) mask, kept elements divided by keep. `half`: x holds
        bf16 values, the factor is a bf16 scalar and the product rounded."""
        if rate <= 0.0:
            return x
        keep_prob = 1.0 - rate
        as_x = (lambda v: float(_bf(torch.tensor(v)))) if half else float
        if self.packed_dropout:
            B, T, F, Co = x.shape
            keep = packed_keep_mask((B, T, F * Co), keep_prob, generator, x.device).view(x.shape)
            kept = x * as_x(1.0 / keep_prob)
        else:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
            kept = x / as_x(keep_prob)
        return torch.where(keep, _bf(kept) if half else kept, torch.zeros_like(x))

    def _unfused(self, i: int, x, train: bool, rate: float, generator):
        """Block i of the unfused chain in fp32."""
        conv = getattr(self, f"conv{i}")
        x = conv2d_nhwc(x, conv.hwio(), conv.bias, self.stride[i], self.padding[i])
        if self.normalization == "batch":
            x = getattr(self, f"batchnorm{i}")(x, train)
        elif self.normalization == "layer":
            x = getattr(self, f"layernorm{i}")(x)
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "leakyrelu":
            x = leaky_relu(x)
        else:
            x = getattr(self, f"{self.activation}{i}")(x)
        return avg_pool_floor(self._drop(x, rate, generator), *self.pooling[i])

    def _unfused_bf16(self, i: int, x, train: bool, rate: float, generator):
        """Block i of the unfused chain in bf16, rounding where the flax
        chain does (see the module's docstring): bf16 in (or the fp32 out of
        a "layer" block, which the conv rounds); bf16 out, or fp32 out of a
        "layer" block."""
        conv = getattr(self, f"conv{i}")
        x = _bf(x.float())
        y = _bf(conv2d_nhwc(x, _bf(conv.hwio()), None, self.stride[i], self.padding[i]))
        y = _bf(y + _bf(conv.bias))
        half = True  # y holds bf16 values (flax's array is bf16)
        if self.normalization == "batch":
            y = _bf(getattr(self, f"batchnorm{i}")(y, train))
        elif self.normalization == "layer":
            y = getattr(self, f"layernorm{i}")(y)
            half = False
        if self.activation == "relu":
            z = torch.relu(y)
        elif self.activation == "leakyrelu":
            z = leaky_relu(y, half)
        else:
            lin = getattr(self, f"{self.activation}{i}").linear
            # flax Dense(dtype=bf16): operands rounded, product and sum rounded
            d = _bf(_bf(torch.matmul(_bf(y), _bf(lin.weight.t()))) + _bf(lin.bias))
            if self.activation == "glu":
                z = d * (sigmoid_bf16(y) if half else torch.sigmoid(y))
            else:
                z = y * sigmoid_bf16(d)
            if half:
                z = _bf(z)
        z = self._drop(z, rate, generator, half)
        if half:
            return avg_pool_floor_bf16(z, *self.pooling[i]).to(BF16)
        return avg_pool_floor(z, *self.pooling[i])
