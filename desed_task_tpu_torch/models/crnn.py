"""CRNN sound-event-detection model (counterpart of desed_task_tpu/models/crnn.py).

log-mel [B, n_mels, T] -> (train: SpecAugment) -> NHWC -> CNN -> (f, c)
flatten -> optional fusion of pretrained embeddings (global / frame /
interpolate / pool1d aggregation, then train-mode dropstep and dropout, then
`cat_tf`) -> BiGRU -> (train: dropout) -> sigmoid strong head [B, C, T'] and
the attention-pooled weak head [B, C] (softmax over CLASSES, clipped at
1e-7, padded frames and invalid classes masked at -1e30).

The constructor takes the JAX model's configuration keys, so the recipe
dicts in `recipes_config` build either model. `compute_dtype` (None: fp32,
or bf16, crnn.py:88-90) is the conv stack's: the CNN runs in it and its
output is cast to fp32 before the RNN (crnn.py:151, :158); parameters, BN
statistics, the embeddings path, the RNN and the heads stay fp32. Train mode follows
crnn.py:114-215, drawing every mask from the `generator` passed to
`forward`; without embeddings, dropout runs only inside the dropstep branch
(crnn.py:193-202), as there. Unlike the lazily shaped flax module, this one
needs the number of mel bins (`n_mels`) to size the layers after the CNN.

`cnn_integration` (crnn.py:107-112, :134-165): the input is [B, nc, n_mels,
T] with nc = `n_in_channel`; the CNN runs on the B * nc single-channel
maps, and its output regroups the channels with JAX's order
(moveaxis(1, -1): feature c * nc + k for CNN channel c of input channel
k), so `cat_tf`, `shrink_emb_dense` and the GRU input are nc times wider.
Train-mode SpecAugment masks the 4-D input before the reshape, on its axes
1 and 2 (the channel and mel axes), as the JAX model does.

The JAX keys that only choose a TPU tiling or kernel (`fast_conv`,
`fused_fpool`, `rnn_pallas`) are not taken: `fused_blocks` and `rnn_kernel`
choose the port's kernels, and `packed_dropout` goes to the CNN.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Union

import numpy as np
import torch
from torch import nn

from ..obs.profiling import span
from ..ops.augment import specaugment, time_mask
from ..ops.dropout import dropout
from .cnn import CNN, BatchNorm, Conv2d, GroupNorm1
from .rnn import BidirectionalGRU, BidirectionalLSTM, BidirectionalLSTMCellMath, GRULayer

RECURRENT = (BidirectionalGRU, GRULayer, BidirectionalLSTM, BidirectionalLSTMCellMath)


def _adaptive_avg_pool_matrix(in_len: int, out_len: int) -> np.ndarray:
    """[in_len, out_len] averaging matrix == torch adaptive_avg_pool1d."""
    m = np.zeros((in_len, out_len))
    for i in range(out_len):
        a = (i * in_len) // out_len
        b = -((-(i + 1) * in_len) // out_len)  # ceil
        m[a:b, i] = 1.0 / (b - a)
    return m


def _nearest_exact_indices(in_len: int, out_len: int) -> np.ndarray:
    """Gather indices == torch F.interpolate(mode='nearest-exact')."""
    scale = in_len / out_len
    idx = np.floor((np.arange(out_len) + 0.5) * scale).astype(np.int64)
    return np.clip(idx, 0, in_len - 1)


@functools.lru_cache(maxsize=8)
def _pool_matrix(in_len: int, out_len: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(
        _adaptive_avg_pool_matrix(in_len, out_len), dtype=torch.float32, device=device
    )


class CRNN(nn.Module):
    def __init__(
        self,
        n_in_channel: int = 1,
        nclass: Union[int, Sequence[int]] = 10,
        attention: Union[bool, str] = True,
        activation: str = "glu",
        dropout: float = 0.5,
        rnn_type: str = "BGRU",
        n_RNN_cell: int = 128,
        n_layers_RNN: int = 2,
        rnn_layers: int | None = None,
        dropout_recurrent: float = 0.0,
        cnn_integration: bool = False,
        freeze_bn: bool = False,
        use_embeddings: bool = False,
        embedding_size: int = 527,
        embedding_type: str = "global",
        frame_emb_enc_dim: int = 512,
        aggregation_type: str = "global",
        specaugm_t_p: float = 0.2,
        specaugm_t_l: int = 5,
        specaugm_f_p: float = 0.2,
        specaugm_f_l: int = 10,
        specaugm_shared: bool = False,
        dropstep_recurrent: float = 0.0,
        dropstep_recurrent_len: int = 5,
        kernel_size: Sequence[int] = (3, 3, 3),
        padding: Sequence[int] = (1, 1, 1),
        stride: Sequence[int] = (1, 1, 1),
        nb_filters: Sequence[int] = (64, 64, 64),
        pooling: Sequence[Sequence[int]] = ((1, 4), (1, 4), (1, 4)),
        normalization: str = "batch",
        n_mels: int = 128,
        fused_blocks: bool = True,
        rnn_kernel: bool = True,
        compute_dtype=None,
        packed_dropout: bool = True,
    ):
        super().__init__()
        if rnn_type != "BGRU":
            raise NotImplementedError("Only BGRU supported for CRNN (as reference)")
        self.cnn_integration = cnn_integration
        self.n_in_channel = n_in_channel
        self.attention = attention
        self.dropout = dropout
        self.freeze_bn = freeze_bn
        self.specaugm = (specaugm_t_l, specaugm_t_p, specaugm_f_l, specaugm_f_p)
        self.specaugm_shared = specaugm_shared
        self.dropstep = (dropstep_recurrent, dropstep_recurrent_len)
        self.use_embeddings = use_embeddings
        self.aggregation_type = aggregation_type
        self.nclass = list(nclass) if isinstance(nclass, (list, tuple)) else [nclass]
        self.cnn = CNN(
            n_in_channel=1 if cnn_integration else n_in_channel, activation=activation,
            conv_dropout=dropout, kernel_size=kernel_size, padding=padding, stride=stride,
            nb_filters=nb_filters, pooling=pooling, normalization=normalization,
            fused_blocks=fused_blocks, compute_dtype=compute_dtype,
            packed_dropout=packed_dropout,
        )
        nb_in = nb_filters[-1] * (n_in_channel if cnn_integration else 1)
        cnn_out = self.cnn.out_freq(n_mels) * nb_in
        rnn_in = cnn_out
        if use_embeddings:
            if aggregation_type in ("global", "frame"):
                if aggregation_type == "frame":
                    self.frame_embs_encoder = BidirectionalGRU(
                        embedding_size, frame_emb_enc_dim, 1, kernel=rnn_kernel)
                    shrink_in = 2 * frame_emb_enc_dim
                else:
                    shrink_in = embedding_size
                self.shrink_emb_dense = nn.Linear(shrink_in, nb_in)
                self.shrink_emb_ln = nn.LayerNorm(nb_in, eps=1e-6)
                emb_dim = nb_in
            elif aggregation_type in ("interpolate", "pool1d"):
                emb_dim = embedding_size
            else:
                raise NotImplementedError(f"aggregation_type {aggregation_type!r}")
            self.cat_tf = nn.Linear(cnn_out + emb_dim, nb_in)
            rnn_in = nb_in
        n_layers = rnn_layers if rnn_layers is not None else n_layers_RNN
        self.rnn = BidirectionalGRU(rnn_in, n_RNN_cell, n_layers,
                                    dropout=dropout_recurrent, kernel=rnn_kernel)
        suffixes = [f"_{i}" for i in range(len(self.nclass))] if len(self.nclass) > 1 else [""]
        self._suffixes = suffixes
        for sfx, c in zip(suffixes, self.nclass):
            self.add_module(f"dense{sfx}", nn.Linear(2 * n_RNN_cell, c))
            if attention in (True, "legacy"):
                self.add_module(f"dense_softmax{sfx}", nn.Linear(2 * n_RNN_cell, c))
        init_weights(self, None)

    # --- embedding fusion ----------------------------------------------------
    def _aggregate_embeddings(self, embeddings, n_frames: int):
        if embeddings is None:
            raise ValueError("use_embeddings=True but no embeddings passed")
        # stores may hold float16; aggregate in fp32 (crnn.py:223)
        embeddings = embeddings.float()
        agg = self.aggregation_type
        if agg in ("global", "frame"):
            if agg == "frame":  # [B, E, F] -> BiGRU over frames, last step
                emb = self.frame_embs_encoder(embeddings.transpose(1, 2))[:, -1]
            else:
                emb = embeddings
            emb = self.shrink_emb_ln(self.shrink_emb_dense(emb))
            return emb[:, None, :].expand(-1, n_frames, -1)
        if agg == "interpolate":
            idx = torch.as_tensor(
                _nearest_exact_indices(embeddings.shape[-1], n_frames),
                device=embeddings.device)
            return embeddings.index_select(-1, idx).transpose(1, 2)
        m = _pool_matrix(embeddings.shape[-1], n_frames, embeddings.device)
        return torch.matmul(embeddings, m).transpose(1, 2)  # [B, T', E]

    # --- prediction heads ----------------------------------------------------
    def _head(self, x, pad_mask, classes_mask, sfx: str):
        strong = torch.sigmoid(getattr(self, f"dense{sfx}")(x))  # [B, T, C]
        invalid = None if classes_mask is None else ~classes_mask[:, None, :]
        if self.attention in (True, "legacy"):
            sof = getattr(self, f"dense_softmax{sfx}")(x)
            if pad_mask is not None:
                sof = sof.masked_fill(pad_mask[:, :, None], -1e30)
            if invalid is not None:
                sof = sof.masked_fill(invalid, -1e30)
            sof = torch.clamp(torch.softmax(sof, dim=-1), 1e-7, 1.0)
            weak = (strong * sof).sum(dim=1) / sof.sum(dim=1)
        else:
            weak = strong.mean(dim=1)
        if invalid is not None:
            strong = strong.masked_fill(invalid, 0.0)
            weak = weak.masked_fill(~classes_mask, 0.0)
        return strong.transpose(1, 2), weak

    def forward(self, x, pad_mask=None, embeddings=None, classes_mask=None,
                generator: torch.Generator | None = None):
        """x [B, n_mels, T] ([B, n_in_channel, n_mels, T] with
        cnn_integration) -> (strong [B, C, T'], weak [B, C]). In train mode
        (self.training) the random parts draw from `generator`, a
        torch.Generator on x's device."""
        train = self.training
        t_l, t_p, f_l, f_p = self.specaugm
        with span("crnn.cnn"):
            if train and (t_p > 0 or f_p > 0):
                x = specaugment(generator, x, t_l, t_p, f_l, f_p, shared=self.specaugm_shared)
            if self.cnn_integration:
                bs_in, nc_in = x.shape[0], x.shape[1]
                x = x.reshape(bs_in * nc_in, *x.shape[2:])
            x = x.transpose(-1, -2)[..., None].contiguous()  # [B, T, n_mels, 1]
            x = self.cnn(x, train=train and not self.freeze_bn, generator=generator).float()
            bs, frames, freq, chan = x.shape
            if self.cnn_integration:  # channel c of input k -> feature c * nc + k
                x = x.reshape(bs_in, nc_in, frames, freq, chan).movedim(1, -1)
                bs, chan = bs_in, chan * nc_in
            x = x.reshape(bs, frames, freq * chan)  # f-major (f, c) flatten
        p_step, len_step = self.dropstep
        dropstep = train and p_step > 0
        if self.use_embeddings:
            with span("crnn.embed"):
                emb = self._aggregate_embeddings(embeddings, frames)
                if dropstep:
                    x = time_mask(generator, x, len_step, p_step, axis=1)
                    emb = time_mask(generator, emb, len_step, p_step, axis=1)
                x = self.cat_tf(dropout(torch.cat([x, emb], dim=-1), self.dropout, generator,
                                        train))
        with span("crnn.rnn"):
            if not self.use_embeddings and dropstep:
                x = time_mask(generator, x, len_step, p_step, axis=1)
                x = dropout(x, self.dropout, generator, train)
            x = dropout(self.rnn(x, train=train, generator=generator), self.dropout, generator,
                        train)
        with span("crnn.heads"):
            strongs, weaks = [], []
            offset = 0
            for sfx, c in zip(self._suffixes, self.nclass):
                cm = None if classes_mask is None else classes_mask[:, offset : offset + c]
                offset += c
                s, w = self._head(x, pad_mask, cm, sfx)
                strongs.append(s)
                weaks.append(w)
            if len(strongs) == 1:
                return strongs[0], weaks[0]
            return torch.cat(strongs, dim=1), torch.cat(weaks, dim=1)


def init_weights(model: nn.Module, generator: torch.Generator | None) -> nn.Module:
    """Random weights from `generator` (torch's global generator if None),
    with the JAX package's init schemes:
    flax lecun_normal conv and dense kernels (a normal truncated at +-2
    std, std = 1/sqrt(fan_in)/0.8796 so that the result has variance
    1/fan_in) with zero biases, torch's uniform(+-1/sqrt(H)) GRU and LSTM
    weights, unit norm scales."""

    def lecun_(p: torch.Tensor, fan_in: int):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        v = torch.empty(p.shape)
        torch.nn.init.trunc_normal_(v, std=std, a=-2 * std, b=2 * std, generator=generator)
        p.copy_(v)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                lecun_(m.weight, m.weight[0].numel())
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                lecun_(m.weight, m.weight.shape[1])
                m.bias.zero_()
            elif isinstance(m, RECURRENT):  # its own weights; a Linear inside is lecun
                bound = 1.0 / math.sqrt(m.hidden)
                for p in m.parameters(recurse=False):
                    p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
            elif isinstance(m, (BatchNorm, GroupNorm1, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return model
