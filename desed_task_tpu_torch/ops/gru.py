"""Bidirectional GRU recurrence (counterpart of desed_task_tpu/ops/pallas_gru.py).

`bigru` runs both directions of a GRU over T from precomputed input gates,
in one hand-written CUDA kernel (csrc/gru.cu) that replaces the Pallas
forward kernel _fwd_kernel (pallas_gru.py:38, launched at :146). The time
loop runs inside the kernel with the hidden state in shared memory.
`bigru_bwd` is its backward (replaces _bwd_kernel, pallas_gru.py:58,
launched at :178): a reverse-time kernel that recomputes the gates from the
saved states and gives the input-gate gradients, then a second kernel that
sums dW_hh and db_hh in a fixed order. `BiGRU` ties the two together for
autograd. The source notes in csrc/gru.cu give each kernel's bound on the
H100 and its design. Each wrapper takes its plain PyTorch version
(`*_plain`) only for CPU tensors; for CUDA tensors it launches the kernel or
raises.

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


def bigru_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, fwd, bwd, dfwd, dbwd):
    """Backward of `bigru_plain` from its saved outputs: reverse-time BPTT
    that recomputes r, z, n from the previous hidden state (pallas_gru.py:75-120).

    Returns (dxg_f, dxg_b [B, T, 3H], dw_hh_f, dw_hh_b [3H, H], db_hh_f,
    db_hh_b [3H]) in the order of the forward's arguments: (dxg_f, dxg_b,
    dw_hh_f, db_hh_f, dw_hh_b, db_hh_b). The n-part of dxg is the pre-tanh
    gradient; the n-part of the hidden-side gradient is that times r.
    """
    B, T, H3 = xg_f.shape
    H = H3 // 3
    grads = []
    for xg, w, b, out, dout, steps, shift in (
            (xg_f, w_hh_f, b_hh_f, fwd, dfwd, range(T - 1, -1, -1), -1),
            (xg_b, w_hh_b, b_hh_b, bwd, dbwd, range(T), 1)):
        dxg = torch.empty_like(xg)
        dw = torch.zeros_like(w)
        db = torch.zeros_like(b)
        dh = xg.new_zeros((B, H))
        for t in steps:
            tp = t + shift
            h_prev = out[:, tp] if 0 <= tp < T else xg.new_zeros((B, H))
            hg = h_prev @ w.t() + b
            x = xg[:, t]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
            hn = hg[:, 2 * H :]
            n = torch.tanh(x[:, 2 * H :] + r * hn)
            dh_tot = dh + dout[:, t]
            dnin = dh_tot * (1.0 - z) * (1.0 - n * n)
            dzin = dh_tot * (h_prev - n) * z * (1.0 - z)
            drin = dnin * hn * r * (1.0 - r)
            dg = torch.cat([drin, dzin, dnin * r], dim=1)  # hidden-side gate grads
            dxg[:, t] = torch.cat([drin, dzin, dnin], dim=1)
            dw += dg.t() @ h_prev
            db += dg.sum(0)
            dh = dh_tot * z + dg @ w
        grads.append((dxg, dw, db))
    (dxg_f, dw_f, db_f), (dxg_b, dw_b, db_b) = grads
    return dxg_f, dxg_b, dw_f, db_f, dw_b, db_b


def bigru_bwd(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, fwd, bwd, dfwd, dbwd):
    """Backward of `bigru`; contract of `bigru_bwd_plain`."""
    if xg_f.device.type == "cpu":
        return bigru_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b,
                               fwd, bwd, dfwd, dbwd)
    B, T, H3 = xg_f.shape
    H = H3 // 3
    for name, t in (("xg_b", xg_b), ("fwd", fwd), ("bwd", bwd), ("dfwd", dfwd),
                    ("dbwd", dbwd), ("w_hh_f", w_hh_f), ("w_hh_b", w_hh_b)):
        want = {"xg_b": (B, T, H3), "w_hh_f": (H3, H), "w_hh_b": (H3, H)}.get(name, (B, T, H))
        if tuple(t.shape) != want:
            raise ValueError(f"bigru_bwd: {name} {tuple(t.shape)}, expected {want}")
    xg_f, xg_b = xg_f.contiguous(), xg_b.contiguous()
    fwd, bwd = fwd.contiguous(), bwd.contiguous()
    dfwd, dbwd = dfwd.contiguous(), dbwd.contiguous()
    w = torch.stack([w_hh_f, w_hh_b]).contiguous()    # [2, 3H, H]
    wt = w.transpose(1, 2).contiguous()                 # [2, H, 3H]
    bhh = torch.stack([b_hh_f, b_hh_b]).contiguous()
    _build.require_cuda_f32("bigru_bwd", xg_f, xg_b, w, wt, bhh, fwd, bwd, dfwd, dbwd)
    dev = xg_f.device
    dxg = torch.empty((2, B, T, H3), device=dev, dtype=torch.float32)
    dgh = torch.empty((2, B, T, H3), device=dev, dtype=torch.float32)
    dw = torch.empty((2, H3, H), device=dev, dtype=torch.float32)
    db = torch.empty((2, H3), device=dev, dtype=torch.float32)
    fn = _build.function("gru", "bigru_bwd", [_build.P] * 14 + [_build.I] * 3 + [_build.P])
    err = fn(xg_f.data_ptr(), xg_b.data_ptr(), wt.data_ptr(), w.data_ptr(), bhh.data_ptr(),
             fwd.data_ptr(), bwd.data_ptr(), dfwd.data_ptr(), dbwd.data_ptr(),
             dxg[0].data_ptr(), dxg[1].data_ptr(), dgh.data_ptr(), dw.data_ptr(),
             db.data_ptr(), B, T, H, _build.stream_ptr(xg_f))
    _build.check(err, "bigru_bwd")
    _build.count_launch("bigru_bwd")
    return dxg[0], dxg[1], dw[0], db[0], dw[1], db[1]


class BiGRU(torch.autograd.Function):
    """(fwd, bwd) = bigru(...) with bigru_bwd as its backward; it saves the
    inputs and the two output sequences, nothing else."""

    @staticmethod
    def forward(ctx, xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
        fwd, bwd = bigru(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b)
        ctx.save_for_backward(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, fwd, bwd)
        return fwd, bwd

    @staticmethod
    def backward(ctx, dfwd, dbwd):
        return bigru_bwd(*ctx.saved_tensors, dfwd, dbwd)
