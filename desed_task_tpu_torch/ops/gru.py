"""Bidirectional GRU recurrence (counterpart of desed_task_tpu/ops/pallas_gru.py).

`bigru` runs both directions of a GRU over T from precomputed input gates,
in hand-written CUDA kernels (csrc/gru.cu) that replace the Pallas forward
kernel _fwd_kernel (pallas_gru.py:38, launched at :146). `bigru_bwd` is its
backward (replaces _bwd_kernel, pallas_gru.py:58, launched at :178). `BiGRU`
ties the two together for autograd.

`bigru_plan(B, T, H)` chooses the kernels by shape alone:

- "cluster": one thread-block cluster of CLUSTER_SIZE CTAs per (direction,
  tile of CLUSTER_ROWS batch rows); each CTA keeps the W_hh rows of its ~H/C hidden units on
  chip, in its product threads' registers, for all T steps
  (`cluster_layout`, `pack_weights`), and the hidden state in the shared
  memory of every CTA of the cluster. The backward is a parallel pre-pass
  G = h_prev W_hh^T + b_hh, the serial cluster kernel, and dW_hh / db_hh
  over row chunks.
- "stream": for hidden sizes whose slices do not fit, one block per
  (direction, 8 batch rows) streams W_hh from L2 on every step.

The source notes in csrc/gru.cu give each kernel's bound on the H100 and its
design. Each wrapper takes its plain PyTorch version (`*_plain`) only for
CPU tensors; for CUDA tensors it launches the kernels or raises.

Gate math is torch.nn.GRU's (r, z, n order):
    r = sigmoid(xr + h Wr^T + br), z = sigmoid(xz + h Wz^T + bz),
    n = tanh(xn + r * (h Wn^T + bn)), h' = (1 - z) n + z h.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..obs.profiling import span
from . import _build

# CTAs per cluster. 6 measured fastest at H=192 on the H100 (PERF.md): 32
# units a CTA, so the forward's 96 gate columns fill three warps, and 16
# clusters of 6 are resident at once.
CLUSTER_SIZE = 6
CLUSTER_ROWS = 8  # batch rows per cluster (csrc/gru.cu BT)
FWD_SPLIT = 4  # depth blocks of the forward's gate product (one per warp group)
BWD_SPLIT = 2  # depth blocks of the backward's dg W_hh product
KC_MAX = 48  # csrc/gru.cu: a product thread's weights in registers, per depth block
MAX_THREADS = 512  # csrc/gru.cu: __launch_bounds__ of the cluster kernels
SMEM_BYTES = 232448  # shared memory one block may use on the H100 (227 KB)
NSLOT = 3  # cp.async ring slots of the cluster kernels
DW_ROWS = 1024  # rows per chunk of the dW_hh sum (at most 32 chunks)
ERR_NO_CLUSTER = 10001  # csrc/gru.cu: no cluster of this shape can be resident


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclass(frozen=True)
class ClusterLayout:
    """Layout of the cluster kernels for hidden size H, on C <= CLUSTER_SIZE
    CTAs of CLUSTER_ROWS batch rows.

    CTA c owns units [c*Uc, min(H, (c+1)*Uc)) (the last slice may be ragged)
    and keeps a weight block [KS*KC][NP] (depth by column, zero padding):
    forward (f_*): depth k < H, column j = gate*Uc + u, the entry W_hh[gate*H
    + c*Uc + u][k]; backward (b_*): depth k = gate*Uc + u, column v < H, the
    entry W_hh[gate*H + c*Uc + u][v]. Warp groups of NP threads take the KS
    depth blocks of KC <= KC_MAX rows, thread (ks, column) holding its KC
    weights in registers; NP is a multiple of 32, so a warp reads one operand
    row by broadcast.
    """

    H: int
    C: int
    Uc: int
    f_ks: int
    f_kc: int
    f_np: int
    b_ks: int
    b_kc: int
    b_np: int

    def units(self, c: int) -> range:
        return range(c * self.Uc, min(self.H, (c + 1) * self.Uc))

    @property
    def fwd_smem(self) -> int:
        ub = self.Uc * CLUSTER_ROWS
        depth = self.f_ks * self.f_kc
        floats = (2 * depth * CLUSTER_ROWS + self.f_ks * self.f_np * CLUSTER_ROWS
                  + NSLOT * 3 * ub + 3 * self.Uc)
        return 4 * floats

    @property
    def bwd_smem(self) -> int:
        ub = self.Uc * CLUSTER_ROWS
        depth = self.b_ks * self.b_kc
        floats = depth * CLUSTER_ROWS + 2 * self.C * self.b_ks * ub + 2 * ub + NSLOT * 6 * ub
        return 4 * floats

    @property
    def fwd_threads(self) -> int:
        return _round_up(max(self.f_ks * self.f_np, self.Uc * CLUSTER_ROWS), 32)

    @property
    def bwd_threads(self) -> int:
        return _round_up(max(self.b_ks * self.b_np, self.Uc * CLUSTER_ROWS), 32)

    @property
    def fits(self) -> bool:
        return (max(self.fwd_smem, self.bwd_smem) <= SMEM_BYTES
                and max(self.fwd_threads, self.bwd_threads) <= MAX_THREADS
                and max(self.f_kc, self.b_kc) <= KC_MAX)


@functools.lru_cache(maxsize=None)
def cluster_layout(H: int) -> ClusterLayout:
    """The layout for hidden size H (whether or not it `fits`)."""
    uc = -(-H // CLUSTER_SIZE)
    f_ks = max(FWD_SPLIT, -(-H // KC_MAX))  # no more than KC_MAX weights a thread
    b_ks = max(BWD_SPLIT, -(-3 * uc // KC_MAX))
    return ClusterLayout(
        H=H, C=-(-H // uc), Uc=uc,  # no CTA without units
        f_ks=f_ks, f_kc=-(-H // f_ks), f_np=_round_up(3 * uc, 32),
        b_ks=b_ks, b_kc=-(-3 * uc // b_ks), b_np=_round_up(H, 32))


def bigru_config(B: int, T: int, H: int) -> tuple[str, ClusterLayout | None]:
    """("cluster", layout) when the layout for H fits a CTA's threads,
    registers and shared memory, else ("stream", None); by shape alone."""
    lay = cluster_layout(H)
    return ("cluster", lay) if lay.fits else ("stream", None)


def bigru_plan(B: int, T: int, H: int) -> str:
    """"cluster" or "stream": which kernels `bigru` and `bigru_bwd` launch."""
    return bigru_config(B, T, H)[0]


@functools.lru_cache(maxsize=None)
def _pack_index(lay: ClusterLayout, kind: str) -> np.ndarray:
    """[C * KS*KC * NP] flat indices into W_hh [3H, H] (3H*H: a zero)."""
    H, Uc = lay.H, lay.Uc
    depth, npad = ((lay.f_ks * lay.f_kc, lay.f_np) if kind == "fwd"
                   else (lay.b_ks * lay.b_kc, lay.b_np))
    idx = np.full((lay.C, depth, npad), 3 * H * H, np.int64)
    k = np.arange(H)
    for c in range(lay.C):
        units = np.asarray(lay.units(c))
        lu = units - c * Uc
        for gate in range(3):
            rows = (gate * H + units) * H  # W_hh rows of this CTA and gate
            if kind == "fwd":
                idx[c, :H, gate * Uc + lu] = rows[:, None] + k[None]
            else:
                idx[c, gate * Uc + lu, :H] = rows[:, None] + k[None]
    return idx.reshape(-1)


_INDEX_ON_DEVICE: dict = {}


def pack_weights(w_hh_f, w_hh_b, lay: ClusterLayout, kind: str) -> torch.Tensor:
    """Both directions' W_hh [3H, H] in the cluster kernels' per-CTA weight
    blocks: [2, C, KS*KC, NP] ("fwd": f_*; "bwd": b_*)."""
    H3 = 3 * lay.H
    w = torch.stack([w_hh_f, w_hh_b]).reshape(2, H3 * lay.H)
    w = torch.cat([w, w.new_zeros((2, 1))], dim=1)
    key = (lay, kind, w.device)
    idx = _INDEX_ON_DEVICE.get(key)
    if idx is None:
        idx = torch.from_numpy(_pack_index(lay, kind)).to(w.device)
        _INDEX_ON_DEVICE[key] = idx
    return w[:, idx].reshape(2, lay.C, -1, lay.f_np if kind == "fwd" else lay.b_np)


def _check(err: int, what: str, lay: ClusterLayout | None = None) -> None:
    if err == ERR_NO_CLUSTER:
        raise RuntimeError(f"{what}: no cluster of {lay.C} CTAs with {CLUSTER_ROWS} rows at "
                           f"H={lay.H} can be resident on this card")
    _build.check(err, what)


def gru_scan(x_gates, h0, w_hh, b_hh, reverse: bool = False):
    """The recurrence of one direction as a Python loop over time
    (counterpart of desed_task_tpu/models/rnn.gru_scan).

    x_gates [B, T, 3H] (x W_ih^T + b_ih, in the input's time order), h0
    [B, H], w_hh [3H, H] (torch layout), b_hh [3H]; reverse runs from the
    last step to the first. Returns the hidden states [B, T, H] in the
    input's time order."""
    H = h0.shape[-1]
    T = x_gates.shape[1]
    h = h0
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hg = h @ w_hh.t() + b_hh
        x = x_gates[:, t]
        r = torch.sigmoid(x[:, :H] + hg[:, :H])
        z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
        n = torch.tanh(x[:, 2 * H :] + r * hg[:, 2 * H :])
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys, dim=1)


def bigru_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    """Both directions, each a `gru_scan` from zero state.

    xg_f/xg_b: [B, T, 3H] input gates (x W_ih^T + b_ih) in the ORIGINAL time
    order; w_hh_*: [3H, H] torch layout; b_hh_*: [3H].
    Returns (fwd [B, T, H], bwd [B, T, H]).
    """
    h0 = xg_f.new_zeros((xg_f.shape[0], w_hh_f.shape[1]))
    return (gru_scan(xg_f, h0, w_hh_f, b_hh_f),
            gru_scan(xg_b, h0, w_hh_b, b_hh_b, reverse=True))


def bigru(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    """Both GRU directions in one recurrence kernel; contract of
    pallas_gru.bigru_pallas (pallas_gru.py:224-266), see `bigru_plain`.
    The torch.library custom op desed_torch::bigru: the kernel for CUDA
    tensors, `bigru_plain` for CPU tensors, opaque to torch.export (its
    fake function gives the two [B, T, H] outputs)."""
    return _BIGRU_OP(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b)


def _bigru_cuda(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    B, T, H3 = xg_f.shape
    H = H3 // 3
    for name, t, want in (("xg_b", xg_b, (B, T, H3)), ("w_hh_f", w_hh_f, (H3, H)),
                          ("w_hh_b", w_hh_b, (H3, H)), ("b_hh_f", b_hh_f, (H3,)),
                          ("b_hh_b", b_hh_b, (H3,))):
        if H3 % 3 or tuple(t.shape) != want:
            raise ValueError(f"bigru: {name} {tuple(t.shape)}, expected {want}")
    xg_f, xg_b = xg_f.contiguous(), xg_b.contiguous()
    bhh = torch.stack([b_hh_f, b_hh_b]).contiguous()
    # two outputs of their own: a custom op's outputs may not alias
    out = [torch.empty((B, T, H), device=xg_f.device, dtype=xg_f.dtype) for _ in range(2)]
    plan, lay = bigru_config(B, T, H)
    if plan == "cluster":
        wpack = pack_weights(w_hh_f, w_hh_b, lay, "fwd")
        _build.require_cuda_f32("bigru", xg_f, xg_b, wpack, bhh, *out)
        fn = _build.function("gru", "bigru_fwd_cluster",
                             [_build.P] * 6 + [_build.I] * 10 + [_build.P])
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), wpack.data_ptr(), bhh.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), B, T, H, lay.C, lay.Uc,
                 lay.f_ks, lay.f_kc, lay.f_np, lay.fwd_threads, lay.fwd_smem,
                 _build.stream_ptr(xg_f))
    else:
        # W_hh^T per direction, [2, H, 3H]: neighbouring threads read
        # neighbouring gate columns
        wt = torch.stack([w_hh_f.t(), w_hh_b.t()]).contiguous()
        _build.require_cuda_f32("bigru", xg_f, xg_b, wt, bhh, *out)
        fn = _build.function("gru", "bigru_fwd",
                             [_build.P] * 6 + [_build.I] * 3 + [_build.P])
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), wt.data_ptr(), bhh.data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), B, T, H, _build.stream_ptr(xg_f))
    _check(err, "bigru", lay)
    _build.count_launch("bigru")
    return out[0], out[1]


def _bigru_fake(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
    B, T, H3 = xg_f.shape
    return xg_f.new_empty((B, T, H3 // 3)), xg_f.new_empty((B, T, H3 // 3))


_LIB = _build.op_library()  # the op's registrations live as long as this object
_build.define_op(_LIB, "bigru(Tensor xg_f, Tensor xg_b, Tensor w_hh_f, Tensor b_hh_f, "
                 "Tensor w_hh_b, Tensor b_hh_b) -> (Tensor, Tensor)",
                 _bigru_cuda, bigru_plain, _bigru_fake)
_BIGRU_OP = torch.ops.desed_torch.bigru.default  # the overload, called directly


def bigru_bwd_plain(xg_f, xg_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b, fwd, bwd, dfwd, dbwd):
    """Backward of `bigru_plain` from its saved outputs, in the kernels' three
    phases: G = h_prev W_hh^T + b_hh for all steps at once (h_prev is the
    saved output shifted by one step, zero at the sequence start), then
    reverse-time BPTT that forms r, z, n from G (pallas_gru.py:75-120), then
    dW_hh = dg^T h_prev and db_hh = sum of dg as single products.

    Returns (dxg_f, dxg_b [B, T, 3H], dw_hh_f, dw_hh_b [3H, H], db_hh_f,
    db_hh_b [3H]) in the order of the forward's arguments: (dxg_f, dxg_b,
    dw_hh_f, db_hh_f, dw_hh_b, db_hh_b). The n-part of dxg is the pre-tanh
    gradient; the n-part of the hidden-side gradient dg is that times r.
    """
    B, T, H3 = xg_f.shape
    H = H3 // 3
    grads = []
    for xg, w, b, out, dout, steps, shift in (
            (xg_f, w_hh_f, b_hh_f, fwd, dfwd, range(T - 1, -1, -1), -1),
            (xg_b, w_hh_b, b_hh_b, bwd, dbwd, range(T), 1)):
        zero = out.new_zeros((B, 1, H))
        h_prev = (torch.cat([zero, out[:, :-1]], dim=1) if shift < 0
                  else torch.cat([out[:, 1:], zero], dim=1))
        G = h_prev @ w.t() + b  # [B, T, 3H]
        dxg = torch.empty_like(xg)
        dg = torch.empty_like(xg)
        dh = xg.new_zeros((B, H))
        for t in steps:
            x, hg = xg[:, t], G[:, t]
            r = torch.sigmoid(x[:, :H] + hg[:, :H])
            z = torch.sigmoid(x[:, H : 2 * H] + hg[:, H : 2 * H])
            hn = hg[:, 2 * H :]
            n = torch.tanh(x[:, 2 * H :] + r * hn)
            dh_tot = dh + dout[:, t]
            dnin = dh_tot * (1.0 - z) * (1.0 - n * n)
            dzin = dh_tot * (h_prev[:, t] - n) * z * (1.0 - z)
            drin = dnin * hn * r * (1.0 - r)
            dg[:, t] = torch.cat([drin, dzin, dnin * r], dim=1)  # hidden-side gate grads
            dxg[:, t] = torch.cat([drin, dzin, dnin], dim=1)
            dh = dh_tot * z + dg[:, t] @ w
        dg2 = dg.reshape(B * T, H3)
        grads.append((dxg, dg2.t() @ h_prev.reshape(B * T, H), dg2.sum(0)))
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
                    ("dbwd", dbwd), ("w_hh_f", w_hh_f), ("w_hh_b", w_hh_b),
                    ("b_hh_f", b_hh_f), ("b_hh_b", b_hh_b)):
        want = {"xg_b": (B, T, H3), "w_hh_f": (H3, H), "w_hh_b": (H3, H),
                "b_hh_f": (H3,), "b_hh_b": (H3,)}.get(name, (B, T, H))
        if H3 % 3 or tuple(t.shape) != want:
            raise ValueError(f"bigru_bwd: {name} {tuple(t.shape)}, expected {want}")
    xg_f, xg_b = xg_f.contiguous(), xg_b.contiguous()
    fwd, bwd = fwd.contiguous(), bwd.contiguous()
    dfwd, dbwd = dfwd.contiguous(), dbwd.contiguous()
    w = torch.stack([w_hh_f, w_hh_b]).contiguous()    # [2, 3H, H]
    bhh = torch.stack([b_hh_f, b_hh_b]).contiguous()
    dev = xg_f.device
    f32 = dict(device=dev, dtype=xg_f.dtype)
    n_w = 2 * H3 * H + 2 * H3
    S = max(1, min(32, -(-B * T // DW_ROWS)))  # row chunks of the dW_hh sum
    dxg = torch.empty((2, B, T, H3), **f32)
    gd = torch.empty((2, B, T, H3), **f32)  # scratch: G (cluster) / dg
    part = torch.empty((S, n_w), **f32)
    dwdb = torch.empty(n_w, **f32)
    plan, lay = bigru_config(B, T, H)
    if plan == "cluster":
        wpack = pack_weights(w_hh_f, w_hh_b, lay, "bwd")
        _build.require_cuda_f32("bigru_bwd", xg_f, xg_b, w, bhh, wpack, fwd, bwd, dfwd,
                                dbwd, dxg)
        fn = _build.function("gru", "bigru_bwd_cluster",
                             [_build.P] * 14 + [_build.I] * 11 + [_build.P])
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), w.data_ptr(), bhh.data_ptr(),
                 wpack.data_ptr(), fwd.data_ptr(), bwd.data_ptr(), dfwd.data_ptr(),
                 dbwd.data_ptr(), dxg[0].data_ptr(), dxg[1].data_ptr(), gd.data_ptr(),
                 part.data_ptr(), dwdb.data_ptr(), B, T, H, lay.C, lay.Uc,
                 lay.b_ks, lay.b_kc, lay.b_np, lay.bwd_threads, lay.bwd_smem, S,
                 _build.stream_ptr(xg_f))
    else:
        wt = w.transpose(1, 2).contiguous()                 # [2, H, 3H]
        _build.require_cuda_f32("bigru_bwd", xg_f, xg_b, w, wt, bhh, fwd, bwd, dfwd, dbwd,
                                dxg)
        fn = _build.function("gru", "bigru_bwd",
                             [_build.P] * 14 + [_build.I] * 4 + [_build.P])
        err = fn(xg_f.data_ptr(), xg_b.data_ptr(), wt.data_ptr(), w.data_ptr(),
                 bhh.data_ptr(), fwd.data_ptr(), bwd.data_ptr(), dfwd.data_ptr(),
                 dbwd.data_ptr(), dxg[0].data_ptr(), dxg[1].data_ptr(), gd.data_ptr(),
                 part.data_ptr(), dwdb.data_ptr(), B, T, H, S, _build.stream_ptr(xg_f))
    _check(err, "bigru_bwd", lay)
    _build.count_launch("bigru_bwd")
    dw = dwdb[: 2 * H3 * H].view(2, H3, H)
    db = dwdb[2 * H3 * H :].view(2, H3)
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
        with span("rnn.bwd"):
            return bigru_bwd(*ctx.saved_tensors, dfwd, dbwd)
