"""BEATs audio transformer encoder (counterpart of desed_task_tpu/models/beats.py).

The frozen embedder of the 2023 and 2024 recipes:

  * the Kaldi fbank front-end (ops/kaldi.beats_preprocess), a 16x16
    stride-16 patch conv (no bias) over [B, 1, T, F], so tokens run
    time-major, then frequency; LayerNorm(512), projection 512 -> 768;
  * the convolutional positional embedding: a weight-normed grouped
    Conv1d(768, 768, k=128, groups=16), SamePad (the last frame dropped),
    exact GELU, added residually; then LayerNorm (post-LN);
  * 12 post-LN layers with deep-norm residual scaling alpha = (2L)^(1/4)
    and a 3072-wide GELU FFN;
  * attention with the T5-style bucketed relative position bias (320
    buckets, max distance 800) of layer 0, shared by layers 1-11, the
    max-subtraction trick (q scaled by scaling / 32; the row max subtracted,
    then times 32), and the gated relative bias: per-head gates from
    grep_linear over the unscaled query.

Kept from the JAX module, as written there:
  * every LayerNorm has flax's default epsilon, 1e-6 (torch's is 1e-5);
  * the weight norm is sqrt(sum(v^2 over the output and input axes) +
    1e-12), computed here by hand (torch's weight_norm has no epsilon);
  * dtypes promote as flax's do: a Dense, conv or LayerNorm computes in
    the wider of its input's and its parameters' dtypes (LayerNorm
    statistics in fp32), the attention logits and the probabilities'
    product are fp32. With fp32 parameters all of it is fp32; the bf16
    mode of the pretraining step (training/beats_pretrain.py) hands the
    module bf16 parameters.

Module names follow the flax tree (`layer_{i}` becomes `layers.{i}`), so
models/convert.from_jax_embedder_params maps it leaf by leaf. The forward pins
fp32 (`device.fp32_math`): PyTorch lets cuDNN's convolutions take TF32.
Attention and projections are plain matmuls, as JAX computes them outside
any Pallas kernel.

BEATsModel(audio [B, N]) -> {"global": [B, 768], "frame": [B, 768, T_tokens]}:
a 10-s clip gives 998 fbank frames, 62 x 8 = 496 tokens.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import fp32_math
from ..ops.kaldi import beats_preprocess

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class BEATsConfig:
    input_patch_size: int = 16
    embed_dim: int = 512
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    deep_norm: bool = True
    conv_bias: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    dropout: float = 0.0  # inference only: dropouts inactive

    @property
    def deep_norm_alpha(self) -> float:
        return math.pow(2 * self.encoder_layers, 1 / 4) if self.deep_norm else 1.0


@functools.lru_cache(maxsize=8)
def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """T5 bidirectional relative position buckets [q_len, k_len], int64."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    buckets += np.where(rel < max_exact, rel, np.minimum(large, nb - 1))
    buckets.setflags(write=False)
    return buckets


@functools.lru_cache(maxsize=8)
def _bucket_index(T: int, num_buckets: int, max_distance: int, device: torch.device):
    """The bucket table as a long tensor on `device`, made once, and made
    outside inference mode (a gradient step may index with it later)."""
    with torch.inference_mode(False):
        return torch.tensor(relative_position_buckets(T, T, num_buckets, max_distance),
                            device=device)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense: the product in the wider of the input's and the weight's dtype."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """flax LayerNorm: statistics and the affine map in fp32, the result in
    the wider of the input's and the parameters' dtypes."""
    dt = torch.promote_types(x.dtype, ln.weight.dtype)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(dt)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


class WeightNormConvPos(nn.Module):
    """Weight-normalised grouped Conv1d positional encoder, parameters as
    torch's weight_norm(dim=2) stores them: weight_v [C, C / g, K],
    weight_g [1, 1, K], bias [C]."""

    def __init__(self, dim: int, kernel: int, groups: int):
        super().__init__()
        self.kernel, self.groups = kernel, groups
        self.weight_v = nn.Parameter(torch.zeros(dim, dim // groups, kernel))
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        v = self.weight_v
        dt = torch.promote_types(x.dtype, v.dtype)
        norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)
        w = v * (self.weight_g / norm)
        out = F.conv1d(x.transpose(1, 2).to(dt), w.to(dt), padding=self.kernel // 2,
                       groups=self.groups)
        out = out + self.bias.to(dt)[None, :, None]
        if self.kernel % 2 == 0:  # SamePad: drop the trailing frame
            out = out[..., :-1]
        return F.gelu(out.transpose(1, 2))


class BEATsSelfAttention(nn.Module):
    def __init__(self, cfg: BEATsConfig, has_relative_attention_bias: bool):
        super().__init__()
        d, h = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        self.cfg, self.heads, self.head_dim = cfg, h, d // h
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.relative_attention_bias = (
            nn.Parameter(torch.zeros(cfg.num_buckets, h)) if has_relative_attention_bias
            else None)
        if cfg.relative_position_embedding and cfg.gru_rel_pos:
            self.grep_a = nn.Parameter(torch.ones(1, h, 1, 1))
            self.grep_linear = nn.Linear(d // h, 8)

    def forward(self, x, pos_bias=None, padding_mask=None):
        cfg, H, hd = self.cfg, self.heads, self.head_dim
        B, T, _ = x.shape
        scaling = hd ** -0.5
        alpha = 32.0
        q = dense(self.q_proj, x) * (scaling / alpha)
        k, v = dense(self.k_proj, x), dense(self.v_proj, x)
        qh = q.reshape(B, T, H, hd).transpose(1, 2)  # [B, H, T, hd]
        kh = k.reshape(B, T, H, hd).transpose(1, 2)
        vh = v.reshape(B, T, H, hd).transpose(1, 2)
        attn = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        attn = (attn - attn.amax(-1, keepdim=True)) * alpha
        if self.relative_attention_bias is not None and pos_bias is None:
            buckets = _bucket_index(T, cfg.num_buckets, cfg.max_distance, x.device)
            pos_bias = self.relative_attention_bias[buckets].permute(2, 0, 1)  # [H, T, T]
        if pos_bias is not None:
            if cfg.gru_rel_pos:
                # gates from the unscaled query (alpha / scaling undoes the scaling)
                gates = dense(self.grep_linear, qh * (alpha / scaling))
                gates = torch.sigmoid(gates.reshape(B, H, T, 2, 4).sum(-1))  # [B, H, T, 2]
                gate_a, gate_b = gates[..., 0:1], gates[..., 1:2]
                gate_a_1 = gate_a * (gate_b * self.grep_a - 1.0) + 2.0
                attn = attn + gate_a_1 * pos_bias[None]
            else:
                attn = attn + pos_bias[None]
        if padding_mask is not None:
            attn = attn.masked_fill(padding_mask[:, None, None, :], -math.inf)
        probs = torch.softmax(attn, dim=-1)
        out = torch.matmul(probs, vh.float()).transpose(1, 2).reshape(B, T, H * hd)
        return self.project_out(out), pos_bias

    def project_out(self, out):
        """The output projection (parallel/tp.py's is row-parallel)."""
        return dense(self.out_proj, out)


class BEATsLayer(nn.Module):
    def __init__(self, cfg: BEATsConfig, has_relative_attention_bias: bool):
        super().__init__()
        if cfg.layer_norm_first:
            raise NotImplementedError("BEATs released checkpoints are post-LN")
        if cfg.activation_fn not in ("gelu", "relu"):
            raise NotImplementedError(cfg.activation_fn)
        d = cfg.encoder_embed_dim
        self.cfg = cfg
        self.self_attn = BEATsSelfAttention(cfg, has_relative_attention_bias)
        self.self_attn_layer_norm = _ln(d)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_embed_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_embed_dim, d)
        self.final_layer_norm = _ln(d)

    def forward(self, x, pos_bias=None, padding_mask=None):
        a = self.cfg.deep_norm_alpha
        attn_out, pos_bias = self.self_attn(x, pos_bias, padding_mask)
        x = layer_norm(self.self_attn_layer_norm, x * a + attn_out)
        h = dense(self.fc1, x)
        h = F.gelu(h) if self.cfg.activation_fn == "gelu" else F.relu(h)
        x = layer_norm(self.final_layer_norm, x * a + self.ffn_out(h))
        return x, pos_bias

    def ffn_out(self, h):
        """The FFN's second product (parallel/tp.py's is row-parallel)."""
        return dense(self.fc2, h)


class BEATsTransformer(nn.Module):
    """Conv positional embedding, post LayerNorm, then the layer stack with
    layer 0's relative position bias shared."""

    def __init__(self, cfg: BEATsConfig = BEATsConfig()):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.pos_conv = WeightNormConvPos(d, cfg.conv_pos, cfg.conv_pos_groups)
        self.layer_norm = _ln(d)
        self.layers = nn.ModuleList(
            BEATsLayer(cfg, cfg.relative_position_embedding and i == 0)
            for i in range(cfg.encoder_layers))

    def forward(self, x, padding_mask=None):
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[..., None], 0.0)
        x = layer_norm(self.layer_norm, x + self.pos_conv(x))
        pos_bias = None
        for layer in self.layers:
            x, pos_bias = layer(x, pos_bias, padding_mask)
        return x


class BEATsEncoder(nn.Module):
    """fbank [B, T_frames, 128] -> token features [B, T_tokens, 768].

    `mask_indices` ([B, T_tokens] bool) replaces the masked tokens'
    embeddings by the learned `mask_token` before the transformer: the seam
    of the masked-patch pretraining (training/beats_pretrain.py). The
    released checkpoint has no mask token; it exists when the encoder is
    built with `mask_token=True`."""

    def __init__(self, cfg: BEATsConfig = BEATsConfig(), mask_token: bool = False):
        super().__init__()
        self.cfg = cfg
        p = cfg.input_patch_size
        self.patch_embedding = nn.Conv2d(1, cfg.embed_dim, p, stride=p, bias=cfg.conv_bias)
        self.layer_norm = _ln(cfg.embed_dim)
        self.post_extract_proj = (nn.Linear(cfg.embed_dim, cfg.encoder_embed_dim)
                                  if cfg.embed_dim != cfg.encoder_embed_dim else None)
        self.mask_token = (nn.Parameter(torch.zeros(cfg.encoder_embed_dim)) if mask_token
                           else None)
        self.encoder = BEATsTransformer(cfg)

    def forward(self, fbank, padding_mask=None, mask_indices=None):
        with fp32_math():
            conv = self.patch_embedding
            x = fbank[:, None]  # [B, 1, T, F]
            dt = torch.promote_types(x.dtype, conv.weight.dtype)
            x = F.conv2d(x.to(dt), conv.weight.to(dt),
                         None if conv.bias is None else conv.bias.to(dt), stride=conv.stride)
            x = layer_norm(self.layer_norm, x.flatten(2).transpose(1, 2))  # time-major tokens
            if self.post_extract_proj is not None:
                x = dense(self.post_extract_proj, x)
            if mask_indices is not None:
                if self.mask_token is None:
                    raise ValueError("mask_indices needs an encoder built with mask_token=True")
                x = torch.where(mask_indices[..., None], self.mask_token, x)
            return self.encoder(x, padding_mask)


class BEATsModel(nn.Module):
    """Waveform wrapper: audio [B, N] in [-1, 1] -> {"global": mean over
    tokens [B, 768], "frame": [B, 768, T_tokens]}."""

    def __init__(self, cfg: BEATsConfig = BEATsConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = BEATsEncoder(cfg)

    def forward(self, audio):
        feats = self.encoder(beats_preprocess(audio))
        return {"global": feats.mean(dim=1), "frame": feats.transpose(1, 2)}


@torch.no_grad()
def init_beats(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the CPU from `generator` in the
    order of `named_parameters`: Linear and conv weights normal with std
    1/sqrt(fan_in) (lecun normal, as flax's default), biases 0, LayerNorm
    1 and 0, weight_v, the relative bias and the mask token normal(0.02),
    weight_g and grep_a 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("weight_v", "relative_attention_bias", "mask_token"):
            val = 0.02 * torch.randn(p.shape, generator=generator)
        elif leaf in ("weight_g", "grep_a"):
            val = torch.ones(p.shape)
        elif leaf == "bias":
            val = torch.zeros(p.shape)
        elif p.dim() == 1:  # LayerNorm scale
            val = torch.ones(p.shape)
        else:
            fan_in = p[0].numel()
            val = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        p.copy_(val)
    return model
