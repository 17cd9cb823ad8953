"""Bidirectional GRU (counterpart of desed_task_tpu/models/rnn.py).

Parameters carry torch.nn.GRU's names and layout (weight_ih_l{k} [3H, in],
weight_hh_l{k} [3H, H], bias_ih_l{k}, bias_hh_l{k}, and `_reverse` for the
backward direction), so reference checkpoints load as they are. The input
projection of all steps is one GEMM outside the recurrence; the recurrence
of both directions is one `ops.gru.bigru` call (a CUDA kernel on the card,
differentiated by `ops.gru.BiGRU` through the backward kernel), or its plain
version with `kernel=False` (differentiated by autograd). Layer l > 0
consumes the concatenated output of layer l-1; in train mode every layer's
output but the last goes through dropout (rnn.py:176-177).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.dropout import dropout
from ..ops.gru import BiGRU, bigru, bigru_plain


class BidirectionalGRU(nn.Module):
    """x [B, T, input_size] -> [B, T, 2 * hidden]."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0, kernel: bool = True):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.dropout = dropout  # between layers, train mode only
        self.kernel = kernel
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(
                    f"weight_ih_l{layer}{sfx}", nn.Parameter(torch.zeros(3 * hidden, in_dim)))
                self.register_parameter(
                    f"weight_hh_l{layer}{sfx}", nn.Parameter(torch.zeros(3 * hidden, hidden)))
                self.register_parameter(
                    f"bias_ih_l{layer}{sfx}", nn.Parameter(torch.zeros(3 * hidden)))
                self.register_parameter(
                    f"bias_hh_l{layer}{sfx}", nn.Parameter(torch.zeros(3 * hidden)))

    def forward(self, x, train: bool | None = None, generator: torch.Generator | None = None):
        """`train` defaults to self.training; inter-layer dropout draws from
        `generator`."""
        train = self.training if train is None else train
        if not self.kernel:
            run = bigru_plain
        elif torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            run = BiGRU.apply
        else:
            run = bigru
        for layer in range(self.num_layers):
            p = {n: getattr(self, f"{n}_l{layer}") for n in
                 ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
            r = {n: getattr(self, f"{n}_l{layer}_reverse") for n in p}
            xg_f = torch.nn.functional.linear(x, p["weight_ih"], p["bias_ih"])
            xg_b = torch.nn.functional.linear(x, r["weight_ih"], r["bias_ih"])
            fwd, bwd = run(xg_f, xg_b, p["weight_hh"], p["bias_hh"],
                           r["weight_hh"], r["bias_hh"])
            x = torch.cat([fwd, bwd], dim=-1)
            if layer < self.num_layers - 1:
                x = dropout(x, self.dropout, generator, train)
        return x
