"""Bidirectional GRU recurrence (counterpart of desed_task_tpu/ops/pallas_gru.py).

`bigru` runs both directions of a GRU over T from precomputed input gates,
in one hand-written CUDA kernel (csrc/gru.cu) that replaces the Pallas
forward kernel _fwd_kernel (pallas_gru.py:38, launched at :146). The time
loop runs inside the kernel with the hidden state in shared memory; the
source note in csrc/gru.cu gives the kernel's bound on the H100 and its
design. The wrapper takes the plain PyTorch version (`bigru_plain`) only for
CPU tensors; for CUDA tensors it launches the kernel or raises.

Gate math is torch.nn.GRU's (r, z, n order):
    r = sigmoid(xr + h Wr^T + br), z = sigmoid(xz + h Wz^T + bz),
    n = tanh(xn + r * (h Wn^T + bn)), h' = (1 - z) n + z h.
"""

from __future__ import annotations

import torch

from . import _build


def bigru_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    """Both directions as a Python loop over time.

    xg_f/xg_b: [B, T, 3H] input gates (x W_ih^T + b_ih) in the ORIGINAL time
    order; w_hh_*: [3H, H] torch layout; b_hh_*: [3H].
    Returns (fwd [B, T, H], bwd [B, T, H]).
    """
    B, T, H3 = xg_f.shape
    H = H3 // 3
    outs = []
    for xg, w, b, steps in ((xg_f, w_hh_f, b_hh_f, range(T)),
                            (xg_b, w_hh_b, b_hh_b, range(T - 1, -1, -1))):
        h = xg.new_zeros((B, H))
        ys = [None] * T
        for t in steps:
            hg = h @ w.t() + b
            x = xg[:, t]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
            n = torch.tanh(x[:, 2 * H :] + r * hg[:, 2 * H :])
            h = (1.0 - z) * n + z * h
            ys[t] = h
        outs.append(torch.stack(ys, dim=1))
    return outs[0], outs[1]


def bigru(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    """Both GRU directions in one recurrence kernel; contract of
    pallas_gru.bigru_pallas (pallas_gru.py:224-266), see `bigru_plain`."""
    if xg_f.device.type == "cpu":
        return bigru_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b)
    B, T, H3 = xg_f.shape
    H = H3 // 3
    if tuple(xg_b.shape) != (B, T, H3) or tuple(w_hh_f.shape) != (H3, H):
        raise ValueError(f"bigru: gates {tuple(xg_b.shape)}, w_hh {tuple(w_hh_f.shape)}")
    xg_f, xg_b = xg_f.contiguous(), xg_b.contiguous()
    # W_hh^T per direction, [2, H, 3H]: neighbouring threads read
    # neighbouring gate columns
    wt = torch.stack([w_hh_f.t(), w_hh_b.t()]).contiguous()
    bhh = torch.stack([b_hh_f, b_hh_b]).contiguous()
    _build.require_cuda_f32("bigru", xg_f, xg_b, wt, bhh)
    out = torch.empty((2, B, T, H), device=xg_f.device, dtype=torch.float32)
    fn = _build.function("gru", "bigru_fwd",
                         [_build.P] * 6 + [_build.I] * 3 + [_build.P])
    err = fn(xg_f.data_ptr(), xg_b.data_ptr(), wt.data_ptr(), bhh.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), B, T, H, _build.stream_ptr(xg_f))
    _build.check(err, "bigru")
    _build.count_launch("bigru")
    return out[0], out[1]
