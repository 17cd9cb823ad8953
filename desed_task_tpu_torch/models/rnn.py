"""Recurrent layers (counterpart of desed_task_tpu/models/rnn.py).

`BidirectionalGRU`: parameters carry torch.nn.GRU's names and layout
(weight_ih_l{k} [3H, in], weight_hh_l{k} [3H, H], bias_ih_l{k},
bias_hh_l{k}, and `_reverse` for the backward direction), so reference
checkpoints load as they are. The input projection of all steps is one GEMM
outside the recurrence; the recurrence of both directions is one
`ops.gru.bigru` call (a CUDA kernel on the card, differentiated by
`ops.gru.BiGRU` through the backward kernel), or its plain version with
`kernel=False` (differentiated by autograd). Layer l > 0 consumes the
concatenated output of layer l-1; in train mode every layer's output but the
last goes through dropout (rnn.py:176-177). `fused_directions=False` runs
the same parameters as two one-direction `gru_scan` loops (`bigru_plain`, as
`kernel=False`), as JAX runs two `GRULayer` scans there and never its Pallas
kernel (rnn.py:158-161).

`gru_scan` (ops/gru.py) is the plain one-direction recurrence and `GRULayer`
one direction's layer (parameters `weight_ih`, `weight_hh`, `bias_ih`,
`bias_hh`, the JAX layer's names). `BidirectionalLSTM` is the reference's
BiLSTM (RNN.py:33-53, JAX rnn.py:230-248): hidden // 2 units a direction,
torch's gate order i, f, g, o, train-mode dropout between layers, then a
Linear `linear` (flax `Dense_0`) to n_out; its parameters carry
torch.nn.LSTM's names (`weight_ih_l{k}[_reverse]`, [4h, in]).
`BidirectionalLSTMCellMath` is one direction's LSTM layer, as in JAX. These
have no kernel (JAX runs them as lax.scan): plain PyTorch on every device.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.dropout import dropout
from ..ops.gru import BiGRU, bigru, bigru_plain, gru_scan


def _uniform_params(module: nn.Module, names, shapes):
    for name, shape in zip(names, shapes):
        module.register_parameter(name, nn.Parameter(torch.zeros(shape)))


class GRULayer(nn.Module):
    """One direction of a GRU: x [B, T, input_size] -> [B, T, hidden]."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        _uniform_params(self, ("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                        ((3 * hidden, input_size), (3 * hidden, hidden), (3 * hidden,),
                         (3 * hidden,)))

    def forward(self, x):
        xg = torch.nn.functional.linear(x, self.weight_ih, self.bias_ih)
        h0 = x.new_zeros((x.shape[0], self.hidden))
        return gru_scan(xg, h0, self.weight_hh, self.bias_hh, self.reverse)


class BidirectionalGRU(nn.Module):
    """x [B, T, input_size] -> [B, T, 2 * hidden]."""

    def __init__(self, input_size: int, hidden: int, num_layers: int = 1,
                 dropout: float = 0.0, kernel: bool = True,
                 fused_directions: bool = True):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.dropout = dropout  # between layers, train mode only
        self.kernel = kernel
        self.fused_directions = fused_directions
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
        if not (self.fused_directions and self.kernel):
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


def lstm_scan(x_gates, w_hh, b_hh, reverse: bool = False):
    """The LSTM recurrence of one direction from zero state (torch gate
    order i, f, g, o): x_gates [B, T, 4h] (x W_ih^T + b_ih), w_hh [4h, h],
    b_hh [4h] -> hidden states [B, T, h] in the input's time order."""
    B, T, H4 = x_gates.shape
    H = H4 // 4
    h = x_gates.new_zeros((B, H))
    c = x_gates.new_zeros((B, H))
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        g = x_gates[:, t] + h @ w_hh.t() + b_hh
        i, f, gg, o = g.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys, dim=1)


class BidirectionalLSTMCellMath(nn.Module):
    """One direction of an LSTM (the JAX module's name): x [B, T, in] ->
    [B, T, hidden]."""

    def __init__(self, input_size: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.hidden = hidden
        self.reverse = reverse
        _uniform_params(self, ("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                        ((4 * hidden, input_size), (4 * hidden, hidden), (4 * hidden,),
                         (4 * hidden,)))

    def forward(self, x):
        xg = torch.nn.functional.linear(x, self.weight_ih, self.bias_ih)
        return lstm_scan(xg, self.weight_hh, self.bias_hh, self.reverse)


class BidirectionalLSTM(nn.Module):
    """x [B, T, input_size] -> [B, T, n_out]: `num_layers` bidirectional
    LSTM layers of hidden // 2 units a direction, then `linear`."""

    def __init__(self, input_size: int, hidden: int, n_out: int, num_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.hidden = hidden // 2
        self.num_layers = num_layers
        self.dropout = dropout  # between layers, train mode only
        h = self.hidden
        for layer in range(num_layers):
            in_dim = input_size if layer == 0 else 2 * h
            for sfx in ("", "_reverse"):
                _uniform_params(
                    self, [f"{n}_l{layer}{sfx}" for n in
                           ("weight_ih", "weight_hh", "bias_ih", "bias_hh")],
                    ((4 * h, in_dim), (4 * h, h), (4 * h,), (4 * h,)))
        self.linear = nn.Linear(2 * h, n_out)

    def forward(self, x, train: bool | None = None, generator: torch.Generator | None = None):
        """`train` defaults to self.training; inter-layer dropout draws from
        `generator`."""
        train = self.training if train is None else train
        for layer in range(self.num_layers):
            outs = []
            for sfx, reverse in (("", False), ("_reverse", True)):
                p = [getattr(self, f"{n}_l{layer}{sfx}") for n in
                     ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
                xg = torch.nn.functional.linear(x, p[0], p[2])
                outs.append(lstm_scan(xg, p[1], p[3], reverse))
            x = torch.cat(outs, dim=-1)
            if layer < self.num_layers - 1:
                x = dropout(x, self.dropout, generator, train)
        return self.linear(x)
