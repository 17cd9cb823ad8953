"""Peaks of the card and the least time of the port's hand-written kernels.

One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W): 989 TFLOP/s
in bf16 and fp16 on the tensor cores, 495 in TF32, 67 in fp32 on the CUDA
cores, 3.35 TB/s of HBM3. Every roofline and MFU of a configuration uses
the peak of the configuration's compute dtype, whatever a kernel computes
in, so no later change of precision can read above 100 %.

A kernel's least time is max(bytes / 3.35 TB/s, FLOPs / peak), each input
byte read once and each output byte written once, and only the products
that the algorithm needs (a kernel that recomputes the forward's GLU
product in its backward is not credited for it).
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def peak_flops(config: dict) -> float:
    return PEAK_FLOPS[config["compute_dtype"]]


def bound_s(flops: float, nbytes: float, config: dict) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops(config))


def _act_bytes(config: dict) -> int:
    return 2 if config["compute_dtype"] in ("bfloat16", "float16") else 4


def frames(config: dict) -> int:
    d = config["data"]
    return int(d["audio_max_len"] * d["fs"]) // config["feats"]["hop_length"] + 1


def conv_blocks(config: dict, batch: int):
    """Per block: (B, T, F, Ci, Co, pt, pf) at the block's input."""
    net = config["net"]
    t, f, ci = frames(config), config["feats"]["n_mels"], net.get("n_in_channel", 1)
    out = []
    for i, co in enumerate(net["nb_filters"]):
        pt, pf = net["pooling"][i]
        out.append((batch, t, f, ci, co, pt, pf))
        t, f, ci = t // pt, f // pf, co
    return out


def conv_forward_bound_s(config: dict, batch: int, train: bool) -> float:
    """Rows 1 and 2 of every block (conv + BN statistics; BN + GLU + dropout
    + pool): the least seconds of one forward of `batch` clips."""
    a = _act_bytes(config)
    total = 0.0
    for B, T, F, Ci, Co, pt, pf in conv_blocks(config, batch):
        n = B * T * F
        # row 1: x, w, bias in; y, per-lane sums out
        f1 = 2 * n * Co * Ci * 9
        b1 = n * Ci * a + 9 * Ci * Co * a + Co * a + n * Co * a + 2 * F * Co * 4
        # row 2: y, dropout bytes (train), GLU weight in; pooled z out
        f2 = 2 * n * Co * Co
        b2 = n * Co * a + (n * Co if train else 0) + Co * Co * a + \
            B * (T // pt) * (F // pf) * Co * a
        total += bound_s(f1, b1, config) + bound_s(f2, b2, config)
    return total


def conv_backward_bound_s(config: dict, batch: int) -> float:
    """Rows 3 and 4 of every block: the least seconds of one backward."""
    a = _act_bytes(config)
    total = 0.0
    for i, (B, T, F, Ci, Co, pt, pf) in enumerate(conv_blocks(config, batch)):
        n = B * T * F
        need_dx = i > 0  # the features take no gradient
        # row 4: dz, y, dropout bytes, GLU weight in; dy out (lin backward: 2 GEMMs)
        f4 = 4 * n * Co * Co
        b4 = B * (T // pt) * (F // pf) * Co * a + n * Co * a + n * Co + Co * Co * a + n * Co * a
        # row 3: dy, y, x, w in; dx (blocks > 0) and dW out
        f3 = 2 * n * Co * Ci * 9 * (2 if need_dx else 1)
        b3 = 2 * n * Co * a + n * Ci * a + 9 * Ci * Co * a + (n * Ci * a if need_dx else 0) \
            + 9 * Ci * Co * 4
        total += bound_s(f3, b3, config) + bound_s(f4, b4, config)
    return total


def _gru_shape(config: dict) -> tuple[int, int, int]:
    """(layers, H, T') of the BiGRU: T' the frames after the CNN's time pooling."""
    net = config["net"]
    t = frames(config)
    for pt, _ in net["pooling"]:
        t //= pt
    return net.get("rnn_layers") or net.get("n_layers_RNN", 1), net["n_RNN_cell"], t


def gru_forward_bound_s(config: dict, batch: int) -> float:
    """The bigru recurrence kernel (both directions) of every layer, fp32:
    the gate inputs in, the hidden states out, h W_hh^T a step."""
    layers, H, T = _gru_shape(config)
    total = 0.0
    for _ in range(layers):
        flops = 2 * (2 * batch * T * 3 * H * H)
        nbytes = 2 * (batch * T * 3 * H * 4 + batch * T * H * 4 + 3 * H * H * 4 + 3 * H * 4)
        total += bound_s(flops, nbytes, config)
    return total


def gru_backward_bound_s(config: dict, batch: int) -> float:
    """The bigru backward of every layer: the hidden-state gradient's
    recurrence and dW_hh (two products a step a direction); gate inputs,
    outputs and their gradients in, gate gradients and dW_hh out."""
    layers, H, T = _gru_shape(config)
    total = 0.0
    for _ in range(layers):
        flops = 2 * (2 * 2 * batch * T * 3 * H * H)
        per_dir = (batch * T * 3 * H * 4  # xg in
                   + 2 * batch * T * H * 4  # outputs and their gradients in
                   + 3 * H * H * 4  # W_hh in
                   + batch * T * 3 * H * 4  # dxg out
                   + 3 * H * H * 4 + 3 * H * 4)  # dW_hh, db_hh out
        total += bound_s(flops, 2 * per_dir, config)
    return total


def clips(config: dict) -> int:
    return sum(s["size"] for s in config["slots"])


def eval_batches(config: dict, n_clips: int) -> int:
    return math.ceil(n_clips / config["training"]["batch_size_val"])


def conv_least_s(config: dict, kind: str, traffic: dict) -> float:
    """The conv blocks' least seconds a unit: a train step runs the
    student's forward and backward and the teacher's forward; an eval pass
    one forward a batch."""
    if kind == "train":
        b = clips(config)
        return 2 * conv_forward_bound_s(config, b, True) + conv_backward_bound_s(config, b)
    bs = config["training"]["batch_size_val"]
    return eval_batches(config, traffic["clips"]) * conv_forward_bound_s(config, bs, False)


def gru_least_s(config: dict, kind: str, traffic: dict) -> float:
    """The BiGRU kernels' least seconds a unit, as `conv_least_s`."""
    if kind == "train":
        b = clips(config)
        return 2 * gru_forward_bound_s(config, b) + gru_backward_bound_s(config, b)
    bs = config["training"]["batch_size_val"]
    return eval_batches(config, traffic["clips"]) * gru_forward_bound_s(config, bs)


def share_percent(ctx, kernels, least_s) -> float | None:
    """100 * least seconds / the device seconds a unit of the kernels whose
    names hold one of `kernels`; None when the trace has none of them."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    spent = ctx.trace.time_s(kernels) / ctx.trace.units
    return None if spent <= 0 else 100.0 * least_s / spent
