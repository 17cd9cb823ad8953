"""AST, the Audio Spectrogram Transformer embedder (counterpart of
desed_task_tpu/models/ast.py).

The 2022 recipe's DeiT-style ViT with class and distillation tokens: a
Conv2d(1, D, 16x16) with strides (fstride, tstride) = (10, 10) over the
Kaldi fbank laid out [B, 1, F, T] (tokens frequency-major), the positional
embedding added, `depth` pre-LN blocks, a final LayerNorm.

forward(spec [B, T, F]) -> {"global": mlp_head((cls + dist) / 2) [B,
label_dim], "frame": every token's features [B, D, 2 + num_patches]}; at
the shipped config 2 + 12 x 101 = 1214 tokens.

As in the JAX module: LayerNorm epsilon 1e-6 (flax's default), the
attention divides the logits by sqrt(head dim) after the product, exact
GELU. `resize_pos_embed` resizes a [1, H*W, D] positional grid as
`jax.image.resize(..., "bilinear")` does: a triangle kernel on half-pixel
centres, widened by the shrink factor where an axis shrinks (antialias),
weights normalised over the input, computed in float32 as there (numpy;
`F.interpolate` is not used). Module names follow the flax tree
(`block_{i}` becomes `blocks.{i}`); the forward pins fp32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import fp32_math
from .beats import LN_EPS, dense, layer_norm


@dataclasses.dataclass(frozen=True)
class ASTConfig:
    label_dim: int = 527
    fstride: int = 10
    tstride: int = 10
    input_fdim: int = 128
    input_tdim: int = 1024
    patch_size: int = 16
    embed_dim: int = 768  # deit base
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0

    @property
    def f_dim(self) -> int:
        return (self.input_fdim - self.patch_size) // self.fstride + 1

    @property
    def t_dim(self) -> int:
        return (self.input_tdim - self.patch_size) // self.tstride + 1

    @property
    def num_patches(self) -> int:
        return self.f_dim * self.t_dim


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        B, T, D = x.shape
        hd = D // self.heads
        qkv = dense(self.qkv, layer_norm(self.norm1, x)).reshape(B, T, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [B, H, T, hd]
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, D)
        x = x + dense(self.proj, out)
        h = F.gelu(dense(self.fc1, layer_norm(self.norm2, x)))
        return x + dense(self.fc2, h)


class ASTModel(nn.Module):
    def __init__(self, cfg: ASTConfig = ASTConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_proj = nn.Conv2d(1, d, cfg.patch_size, stride=(cfg.fstride, cfg.tstride))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 2 + cfg.num_patches, d))
        self.blocks = nn.ModuleList(ViTBlock(d, cfg.num_heads, cfg.mlp_ratio)
                                    for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.head = nn.Linear(d, cfg.label_dim)

    def forward(self, spec):  # [B, T, F] kaldi fbank
        with fp32_math():
            B = spec.shape[0]
            x = self.patch_proj(spec.transpose(1, 2)[:, None])  # [B, D, f_dim, t_dim]
            x = x.flatten(2).transpose(1, 2)  # frequency-major tokens
            x = torch.cat([self.cls_token.expand(B, -1, -1),
                           self.dist_token.expand(B, -1, -1), x], dim=1) + self.pos_embed
            for block in self.blocks:
                x = block(x)
            x = layer_norm(self.norm, x)
            g = layer_norm(self.head_norm, (x[:, 0] + x[:, 1]) / 2.0)
            return {"global": dense(self.head, g), "frame": x.transpose(1, 2)}


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of jax.image.scale_and_translate's triangle
    kernel (translation 0, antialias on), computed in float32 as XLA's
    compiled `jax.image.resize` does, the sample position (i + 0.5) *
    inv_scale - 0.5 as one fused multiply-add: its float32 positions drift
    from the exact ones (by up to 6e-6 of the output at 24 -> 101), and the
    port follows them."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # a Python float in JAX, cast when used
    kernel_scale = max(inv_scale, f32(1.0))
    centres = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centres * np.float64(inv_scale) - 0.5).astype(f32)  # exact, rounded once
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0))


def resize_pos_embed(pos_2d, old_hw: tuple[int, int], new_hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of ViT positional embeddings [1, H*W, D] -> [1,
    H'*W', D], float32 (the DeiT 24x24 grid onto the audio patch grid)."""
    (oh, ow), (nh, nw) = old_hw, new_hw
    grid = np.asarray(pos_2d, np.float64).reshape(oh, ow, -1)
    out = np.einsum("hwd,hi,wj->ijd", grid, _resize_weights(oh, nh), _resize_weights(ow, nw))
    return out.reshape(1, nh * nw, -1).astype(np.float32)


@torch.no_grad()
def init_ast(model: ASTModel, generator: torch.Generator) -> ASTModel:
    """Seeded random weights from `generator` (CPU), in the order of
    `named_parameters`: Linear and conv weights normal with std
    1/sqrt(fan_in), biases 0, LayerNorm 1 and 0, the tokens and the
    positional embedding normal(0.02)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "dist_token", "pos_embed"):
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
    return model
