"""Tensor-parallel BEATs over a mesh's 'model' axis (counterpart of
desed_task_tpu/parallel/tp.py).

The Megatron layout of the JAX package's PartitionSpecs (tp.py:21-42): the
attention's q, k and v projections and the FFN's fc1 are column-parallel
(each rank holds H / m heads and ffn / m units of its model index r of m),
out_proj and fc2 are row-parallel (each rank holds the matching input
features). The JAX package lets XLA insert the sum of the row-parallel
products from the shardings; here it is one sum all-reduce over the model
axis's group after each of the two, and their bias is added once, after
it. Norms, the patch embedding and the convolutional positional encoder
stay whole on every rank.

Per-head state goes with the heads: layer 0's relative_attention_bias
[num_buckets, H], from which the shared position bias of every layer is
gathered, and each layer's gate scale grep_a [1, H, 1, 1], are sliced to
the rank's heads; grep_linear acts on one head's features and stays whole.
A padding mask broadcasts over the rank's heads as over all of them.

BEATs is frozen in every use (extraction, the train step's in-graph
embedder), so the sharded model is forward-only: its parameters take no
gradient, and the all-reduce has no backward. tools/embeddings.
frame_embedder takes it as it takes the full model.
"""

from __future__ import annotations

import copy

import torch
import torch.distributed as dist
from torch import nn

from ..models.beats import BEATsLayer, BEATsModel, BEATsSelfAttention, dense


def _linear(weight: torch.Tensor, bias: torch.Tensor | None) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, weight.shape[1], weight.shape[0],
                             bias=bias is not None, device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


def _column(lin: nn.Linear, rows: slice) -> nn.Linear:
    """The output features `rows` of `lin`, with their bias."""
    return _linear(lin.weight[rows], None if lin.bias is None else lin.bias[rows])


def _row(lin: nn.Linear, cols: slice) -> tuple[nn.Linear, nn.Parameter]:
    """The input features `cols` of `lin` without bias, and its whole bias."""
    return (_linear(lin.weight[:, cols], None),
            nn.Parameter(lin.bias.detach().clone(), requires_grad=False))


def _summed(partial: torch.Tensor, bias: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(partial, group=group)
    return partial + bias.to(partial.dtype)


class TPSelfAttention(BEATsSelfAttention):
    """Rank r's H / m heads of a full BEATsSelfAttention."""

    def __init__(self, full: BEATsSelfAttention, rank: int, m: int, group):
        nn.Module.__init__(self)  # the layers are slices of `full`'s, not new ones
        h, hd = full.heads // m, full.head_dim
        heads, feats = slice(rank * h, (rank + 1) * h), slice(rank * h * hd, (rank + 1) * h * hd)
        self.cfg, self.heads, self.head_dim, self.group = full.cfg, h, hd, group
        self.q_proj, self.k_proj, self.v_proj = (
            _column(lin, feats) for lin in (full.q_proj, full.k_proj, full.v_proj))
        self.out_proj, self.out_bias = _row(full.out_proj, feats)
        rel = full.relative_attention_bias
        self.relative_attention_bias = (None if rel is None else
                                        nn.Parameter(rel[:, heads].detach().clone()))
        if hasattr(full, "grep_a"):
            self.grep_a = nn.Parameter(full.grep_a[:, heads].detach().clone())
            self.grep_linear = full.grep_linear

    def project_out(self, out):
        return _summed(dense(self.out_proj, out), self.out_bias, self.group)


class TPLayer(BEATsLayer):
    """Rank r's slice of a full BEATsLayer: its heads and ffn / m units."""

    def __init__(self, full: BEATsLayer, rank: int, m: int, group):
        nn.Module.__init__(self)
        f = full.fc1.out_features // m
        units = slice(rank * f, (rank + 1) * f)
        self.cfg, self.group = full.cfg, group
        self.self_attn = TPSelfAttention(full.self_attn, rank, m, group)
        self.self_attn_layer_norm = full.self_attn_layer_norm
        self.fc1 = _column(full.fc1, units)
        self.fc2, self.fc2_bias = _row(full.fc2, units)
        self.final_layer_norm = full.final_layer_norm

    def ffn_out(self, h):
        return _summed(dense(self.fc2, h), self.fc2_bias, self.group)


def shard_beats(model: nn.Module, mesh, axis: str = "model") -> nn.Module:
    """A forward-only tensor-parallel copy of a full BEATsModel (or
    BEATsEncoder) for this rank of `mesh`'s `axis`: every layer's heads and
    FFN units split over the axis's m ranks (module docstring). The heads
    and the FFN width must be divisible by m. Collective in its forward:
    every rank of the axis's group runs it on the same input."""
    m, r, group = mesh.shape[axis], mesh.index[axis], mesh.groups[axis]
    cfg = model.cfg
    if cfg.encoder_attention_heads % m or cfg.encoder_ffn_embed_dim % m:
        raise ValueError(f"{cfg.encoder_attention_heads} heads and an FFN of "
                         f"{cfg.encoder_ffn_embed_dim} do not split over {m} ranks")
    tp = copy.deepcopy(model)
    layers = (tp.encoder if isinstance(tp, BEATsModel) else tp).encoder.layers
    for i, layer in enumerate(layers):
        layers[i] = TPLayer(layer, r, m, group)
    for p in tp.parameters():
        p.requires_grad_(False)
    return tp
