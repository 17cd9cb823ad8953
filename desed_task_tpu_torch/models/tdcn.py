"""TDCN++ separation model (counterpart of desed_task_tpu/models/tdcn.py).

The trainable separator of the 2021 recipe: a learned conv encoder, the
TDCN++ masker and a learned transposed-conv decoder (Conv-TasNet style),
with mixture consistency (the sources sum to the input mixture):

  * stacked blocks of 1x1 conv, PReLU, feature LayerNorm, depthwise conv
    (kernel 3, dilation 2^b within each repeat), PReLU, LayerNorm, then
    residual and skip 1x1 convs;
  * a learned residual scale per block, initialised to 0.9^layer;
  * the skips summed into the mask head, one sigmoid mask per source.

Activations run as [B, L, C] (flax's layout): the 1x1 convs are linear
layers over C, the LayerNorms normalise C. The JAX module's convolutions
are XLA's, not Pallas kernels; here they are `F.conv1d` and
`F.conv_transpose1d`. Their flax conventions are kept:

  * `nn.Conv(padding="SAME")` pads (ceil(L/s) - 1) s + (k - 1) d + 1 - L in
    all, the lower half rounded down (`same_padding`);
  * `nn.ConvTranspose(padding="SAME")` (transpose_kernel=False) is a conv of
    the stride-dilated input with the kernel as stored, padded by
    `lax.conv_transpose`'s SAME rule: `F.conv_transpose1d` with the kernel
    flipped (models/convert.py flips it) gives the same output shifted by
    k - 1 - pad_lo (`_decoder_offset`), cropped to L s samples;
  * PReLU slopes start at 0.01, LayerNorm eps is 1e-6.

The products and convolutions are full fp32, as JAX's on the CPU are:
`device.fp32_math` keeps TF32 off around the forward (and the MixIT step's
backward), whatever the process allows; PyTorch lets cuDNN's convolutions
take TF32 by default.

Shapes: forward(audio [B, N]) -> sources [B, n_src, N], float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import fp32_math


def same_padding(length: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """(low, high) padding of lax's "SAME" for one spatial axis."""
    out = -(-length // stride)
    total = max((out - 1) * stride + (kernel - 1) * dilation + 1 - length, 0)
    return total // 2, total - total // 2


def _decoder_offset(kernel: int, stride: int) -> int:
    """Where lax.conv_transpose(padding="SAME") starts in the full output of
    F.conv_transpose1d with the flipped kernel."""
    pad_len = kernel + stride - 2
    pad_lo = kernel - 1 if stride > kernel - 1 else int(np.ceil(pad_len / 2))
    return kernel - 1 - pad_lo


class PReLU(nn.Module):
    """flax nn.PReLU: one slope, 0.01 at init; x where x >= 0."""

    def __init__(self, init: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(float(init)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope * x)


class FeatureLN(nn.LayerNorm):
    """LayerNorm over the feature axis (the last), eps 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)


class TDCNBlock(nn.Module):
    def __init__(self, bn_dim: int, h_dim: int, kernel: int, dilation: int,
                 scale_init: float):
        super().__init__()
        self.kernel, self.dilation = kernel, dilation
        self.in1x1 = nn.Linear(bn_dim, h_dim)
        self.prelu0 = PReLU()
        self.ln1 = FeatureLN(h_dim)
        self.dconv = nn.Conv1d(h_dim, h_dim, kernel, dilation=dilation, groups=h_dim)
        self.prelu1 = PReLU()
        self.ln2 = FeatureLN(h_dim)
        self.res1x1 = nn.Linear(h_dim, bn_dim)
        self.skip1x1 = nn.Linear(h_dim, bn_dim)
        self.res_scale = nn.Parameter(torch.full((1,), float(np.float32(scale_init))))

    def forward(self, x):  # [B, L, bn_dim] -> (residual out, skip)
        y = self.ln1(self.prelu0(self.in1x1(x)))
        lo, hi = same_padding(y.shape[1], self.kernel, 1, self.dilation)
        y = self.dconv(F.pad(y.transpose(1, 2), (lo, hi))).transpose(1, 2)
        y = self.ln2(self.prelu1(y))
        return x + self.res_scale * self.res1x1(y), self.skip1x1(y)


class TDCNPP(nn.Module):
    """Trainable TDCN++ separator with a learned conv basis."""

    def __init__(self, n_src: int = 4, enc_dim: int = 256, win: int = 40, bn_dim: int = 128,
                 h_dim: int = 512, n_blocks: int = 8, n_repeats: int = 4, kernel: int = 3,
                 mixture_consistency: bool = True):
        super().__init__()
        self.n_src, self.enc_dim, self.win = n_src, enc_dim, win
        self.stride = win // 2
        self.mixture_consistency = mixture_consistency
        self.encoder = nn.Conv1d(1, enc_dim, win, stride=self.stride)
        self.ln_in = FeatureLN(enc_dim)
        self.bottleneck = nn.Linear(enc_dim, bn_dim)
        self.blocks = nn.ModuleDict()
        layer = 0
        for r in range(n_repeats):
            for b in range(n_blocks):
                self.blocks[f"block_r{r}_b{b}"] = TDCNBlock(bn_dim, h_dim, kernel, 2 ** b,
                                                            0.9 ** layer)
                layer += 1
        self.prelu0 = PReLU()
        self.mask_head = nn.Linear(bn_dim, n_src * enc_dim)
        # weight [enc_dim, 1, win]: flax's decoder kernel, flipped
        self.decoder = nn.ConvTranspose1d(enc_dim, 1, win, stride=self.stride)
        init_tdcn(self, None)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:  # [B, N]
        with fp32_math():
            return self._separate(audio)

    def _separate(self, audio: torch.Tensor) -> torch.Tensor:
        B, N = audio.shape
        s = self.stride
        x = F.pad(audio, (0, (-N) % s))  # [B, Np]
        lo, hi = same_padding(x.shape[1], self.win, s)
        enc = F.relu(self.encoder(F.pad(x[:, None], (lo, hi)))).transpose(1, 2)  # [B, L, enc]
        y = self.bottleneck(self.ln_in(enc))
        skips = 0.0
        for block in self.blocks.values():
            y, skip = block(y)
            skips = skips + skip
        m = self.mask_head(self.prelu0(skips))
        L = m.shape[1]
        masks = torch.sigmoid(m.reshape(B, L, self.n_src, self.enc_dim))
        masked = masks * enc[:, :, None, :]  # [B, L, n_src, enc]
        # the sources fold into the batch axis for one transposed conv
        per_src = masked.permute(0, 2, 3, 1).reshape(B * self.n_src, self.enc_dim, L)
        off = _decoder_offset(self.win, s)
        dec = self.decoder(per_src)[:, 0, off : off + L * s]  # [B * n_src, Np]
        sources = dec.reshape(B, self.n_src, -1)[:, :, :N].float()
        if self.mixture_consistency:
            resid = audio - sources.sum(1)
            sources = sources + resid[:, None, :] / self.n_src
        return sources


def init_tdcn(model: TDCNPP, generator: torch.Generator | None) -> TDCNPP:
    """Random weights from `generator` (torch's global generator if None),
    with flax's init schemes: lecun_normal kernels (a normal truncated at
    +-2 std, variance 1/fan_in; the decoder's fan_in is enc_dim * win, as
    flax counts a ConvTranspose kernel [win, enc_dim, 1]), zero biases,
    unit LayerNorm scales; PReLU slopes and residual scales as constructed."""

    def lecun_(p: torch.Tensor, fan_in: int):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        v = torch.empty(p.shape)
        torch.nn.init.trunc_normal_(v, std=std, a=-2 * std, b=2 * std, generator=generator)
        p.copy_(v)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.ConvTranspose1d):
                lecun_(m.weight, m.weight.shape[0] * m.weight.shape[2])
                m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                lecun_(m.weight, m.weight[0].numel())
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_(m.weight, m.weight.shape[1])
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model
