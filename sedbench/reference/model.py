"""Plain reference of the DCASE Task 4 CRNN and its log-mel front end.

Written from the baselines' published description (DCASE Task 4 2023 and
2024 baseline recipes: `CRNN.py`, `CNN.py`, `RNN.py`, the torchaudio
MelSpectrogram and AmplitudeToDB of their feature extractor) and from the
framework's documented choices that change the arithmetic: packed conv
dropout (keep where a uniform byte < round(keep * 256)), BatchNorm with
eps 1e-3 and running statistics kept as 0.01 old + 0.99 batch, torchaudio
TimeMasking with float mask lengths for SpecAugment and the recurrent
dropstep. Plain PyTorch only: `F.conv2d`, an explicit GRU loop, autograd.
It imports nothing of the program under test.

Every random draw comes from the caller's `torch.Generator`, in the order
in which the model consumes them: SpecAugment (frequency, then time mask),
each conv block's dropout bytes, the dropstep masks of the CNN output and
of the embeddings, the dropout before `cat_tf`, the dropout between GRU
layers, the dropout after the GRU.

Parameters are a dict keyed by the checkpoint names of the model (the
reference recipe's names: `cnn.conv{i}.weight`, `rnn.weight_ih_l0`, ...).

`q` is the precision of the values that the configuration computes in its
compute dtype (the DFT's inputs; each conv block's input and weights, its
conv output, the GLU's input and weights, the block's output; and the
gradients that flow back through them): `exact` for the reference itself,
`fp8` for the control that stands one precision below bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def fp32_math():
    """Full fp32 products on the card (no TF32 in cuBLAS or cuDNN)."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    prev = [f.allow_tf32 for f in flags]
    prec = torch.get_float32_matmul_precision()
    for f in flags:
        f.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p
        torch.set_float32_matmul_precision(prec)


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled_round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _RoundFp8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient that
    flows back, to float8 e5m2 under its own (the usual fp8 training
    recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _scaled_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: float8 e4m3 with a per-tensor scale."""
    return _RoundFp8.apply(x)


# ---------------------------------------------------------------- front end


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(feats: dict) -> np.ndarray:
    """torchaudio.functional.melscale_fbanks(norm=None, mel_scale="htk"):
    [n_fft // 2 + 1, n_mels], float64."""
    n_freqs = feats["n_window"] // 2 + 1
    freqs = np.linspace(0.0, feats["sample_rate"] / 2.0, n_freqs)
    m = np.linspace(_hz_to_mel(feats["f_min"]), _hz_to_mel(feats["f_max"]), feats["n_mels"] + 2)
    f_pts = _mel_to_hz(m)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def dft_basis(feats: dict) -> np.ndarray:
    """[n_fft, 2 * n_freqs]: the symmetric-Hamming-windowed cos | -sin of the
    real DFT (torch.stft with window=hamming_window(periodic=False))."""
    n_fft = feats["n_window"]
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    t = np.arange(n_fft, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * math.pi * t / (n_fft - 1))
    ang = 2.0 * math.pi * np.outer(t, k) / n_fft
    return np.concatenate([np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]], axis=1)


def mel_magnitude(audio: torch.Tensor, feats: dict, q=exact) -> torch.Tensor:
    """audio [B, N] float -> linear mel magnitude [B, n_mels, n_frames]
    (center=True, reflect padding, power 1)."""
    n_fft, hop = feats["n_window"], feats["hop_length"]
    a = F.pad(audio.float()[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = a.unfold(-1, n_fft, hop)  # [B, T, n_fft]
    basis = torch.as_tensor(dft_basis(feats), dtype=torch.float32, device=audio.device)
    spec = q(frames) @ q(basis)
    nf = n_fft // 2 + 1
    mag = torch.sqrt(spec[..., :nf] ** 2 + spec[..., nf:] ** 2)
    fb = torch.as_tensor(mel_filterbank(feats), dtype=torch.float32, device=audio.device)
    return (mag @ fb).transpose(1, 2)


def to_db(mel: torch.Tensor) -> torch.Tensor:
    """AmplitudeToDB(stype="amplitude", amin=1e-5), clamped to [-50, 80]."""
    return torch.clamp(20.0 * torch.log10(torch.clamp(mel, min=1e-5)), -50.0, 80.0)


def minmax_scale(x: torch.Tensor) -> torch.Tensor:
    """Instance min-max over (mels, frames) to [-1, 1]."""
    lo = x.amin(dim=(1, 2), keepdim=True)
    hi = x.amax(dim=(1, 2), keepdim=True)
    return (x - lo) / (hi - lo + 1e-8) * 2.0 - 1.0


# ---------------------------------------------------------------- random parts


def time_mask(gen, x, mask_param: int, p: float, axis: int):
    """torchaudio TimeMasking(iid_masks=True, p) with float lengths: per
    example a length U * min(mask_param, int(len * p)) and a start
    U' * (len - length); the positions in [start, start + length) are 0."""
    length = x.shape[axis]
    eff = mask_param if p >= 1.0 else min(mask_param, int(length * p))
    if eff <= 0:
        return x
    u = torch.rand((2, x.shape[0]), generator=gen, device=x.device)
    val = u[0] * eff
    start = u[1] * (length - val)
    idx = torch.arange(length, dtype=torch.float32, device=x.device)
    mask = (idx[None] >= start[:, None]) & (idx[None] < (start + val)[:, None])
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[axis] = length
    return x.masked_fill(mask.view(shape), 0.0)


def dropout(gen, x, rate: float):
    """Inverted dropout: keep with probability 1 - rate, kept values / keep."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    m = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(m, x / keep, torch.zeros_like(x))


def packed_dropout(gen, z, rate: float):
    """The conv blocks' dropout on z [B, C, T, F]: uniform bytes uint8
    [B, T, F * C] (channel fastest), keep where byte < round(keep * 256)."""
    if rate <= 0.0:
        return z
    keep = 1.0 - rate
    thr = min(int(round(keep * 256)), 255)
    B, C, T, Fq = z.shape
    bits = torch.randint(0, 256, (B, T, Fq * C), dtype=torch.uint8, generator=gen,
                         device=z.device)
    m = (bits.view(B, T, Fq, C).to(torch.int32) < thr).permute(0, 3, 1, 2)
    return torch.where(m, z * (1.0 / keep), torch.zeros_like(z))


# ---------------------------------------------------------------- model


def param_spec(net: dict, n_mels: int) -> list[tuple[str, tuple, str, int]]:
    """[(name, shape, init, fan)] of the CRNN's parameters and statistics:
    init "normal" (std 1 / sqrt(fan)), "uniform" (bound 1 / sqrt(fan)),
    "zeros", "ones", "stat_mean", "stat_var"."""
    out = []
    ci, nf = net.get("n_in_channel", 1), n_mels
    for i, co in enumerate(net["nb_filters"]):
        k = net["kernel_size"][i]
        out += [(f"cnn.conv{i}.weight", (co, ci, k, k), "normal", ci * k * k),
                (f"cnn.conv{i}.bias", (co,), "zeros", 0),
                (f"cnn.batchnorm{i}.weight", (co,), "ones", 0),
                (f"cnn.batchnorm{i}.bias", (co,), "zeros", 0),
                (f"cnn.batchnorm{i}.running_mean", (co,), "stat_mean", 0),
                (f"cnn.batchnorm{i}.running_var", (co,), "stat_var", 0),
                (f"cnn.glu{i}.linear.weight", (co, co), "normal", co),
                (f"cnn.glu{i}.linear.bias", (co,), "zeros", 0)]
        nf //= net["pooling"][i][1]
        ci = co
    rnn_in = nf * ci
    if net.get("use_embeddings"):
        if net.get("aggregation_type") != "pool1d":
            raise NotImplementedError("the reference fuses embeddings by pool1d only")
        cat_in = rnn_in + net["embedding_size"]
        out += [("cat_tf.weight", (ci, cat_in), "normal", cat_in),
                ("cat_tf.bias", (ci,), "zeros", 0)]
        rnn_in = ci
    h = net["n_RNN_cell"]
    layers = net.get("rnn_layers") or net.get("n_layers_RNN", 1)
    for layer in range(layers):
        d = rnn_in if layer == 0 else 2 * h
        for sfx in ("", "_reverse"):
            out += [(f"rnn.weight_ih_l{layer}{sfx}", (3 * h, d), "uniform", h),
                    (f"rnn.weight_hh_l{layer}{sfx}", (3 * h, h), "uniform", h),
                    (f"rnn.bias_ih_l{layer}{sfx}", (3 * h,), "uniform", h),
                    (f"rnn.bias_hh_l{layer}{sfx}", (3 * h,), "uniform", h)]
    c = net["nclass"]
    out += [("dense.weight", (c, 2 * h), "normal", 2 * h), ("dense.bias", (c,), "zeros", 0),
            ("dense_softmax.weight", (c, 2 * h), "normal", 2 * h),
            ("dense_softmax.bias", (c,), "zeros", 0)]
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def _gru_direction(xg, w_hh, b_hh, reverse: bool):
    """torch.nn.GRU's recurrence (gates r, z, n) over xg [B, T, 3H]."""
    H = w_hh.shape[1]
    h = xg.new_zeros((xg.shape[0], H))
    outs = [None] * xg.shape[1]
    steps = range(xg.shape[1] - 1, -1, -1) if reverse else range(xg.shape[1])
    for t in steps:
        hg = h @ w_hh.t() + b_hh
        x = xg[:, t]
        r = torch.sigmoid(x[:, :H] + hg[:, :H])
        z = torch.sigmoid(x[:, H:2 * H] + hg[:, H:2 * H])
        n = torch.tanh(x[:, 2 * H:] + r * hg[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        outs[t] = h
    return torch.stack(outs, dim=1)


def crnn_forward(p: dict, net: dict, x: torch.Tensor, emb, cmask, train: bool, gen,
                 q=exact):
    """x scaled log-mel [B, n_mels, T] -> (strong [B, C, T'], weak [B, C]).

    Train mode: batch statistics (the running ones in `p` are updated in
    place, under no_grad), SpecAugment, conv dropout, dropstep and dropout,
    each drawn from `gen`. Eval mode: running statistics, no draws."""
    rate = net["dropout"]
    if train and (net["specaugm_t_p"] > 0 or net["specaugm_f_p"] > 0):
        x = time_mask(gen, x, net["specaugm_f_l"], net["specaugm_f_p"], axis=1)
        x = time_mask(gen, x, net["specaugm_t_l"], net["specaugm_t_p"], axis=2)
    h = x.transpose(1, 2)[:, None]  # [B, 1, T, F]
    for i in range(len(net["nb_filters"])):
        pre = f"cnn.conv{i}."
        y = q(F.conv2d(q(h), q(p[pre + "weight"]), p[pre + "bias"], padding=net["padding"][i]))
        bn = f"cnn.batchnorm{i}."
        if train:
            mean = y.mean(dim=(0, 2, 3))
            var = ((y - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
            with torch.no_grad():
                p[bn + "running_mean"].mul_(0.01).add_(0.99 * mean)
                p[bn + "running_var"].mul_(0.01).add_(0.99 * var)
        else:
            mean, var = p[bn + "running_mean"], p[bn + "running_var"]
        inv = p[bn + "weight"] * torch.rsqrt(var + 1e-3)
        yn = (y - mean[None, :, None, None]) * inv[None, :, None, None] + \
            p[bn + "bias"][None, :, None, None]
        g = f"cnn.glu{i}.linear."
        lin = F.linear(q(yn.permute(0, 2, 3, 1)), q(p[g + "weight"]), p[g + "bias"])
        z = lin.permute(0, 3, 1, 2) * torch.sigmoid(yn)
        if train:
            z = packed_dropout(gen, z, rate)
        h = q(F.avg_pool2d(z, tuple(net["pooling"][i])))
    B, C, T, Fq = h.shape
    h = h.permute(0, 2, 3, 1).reshape(B, T, Fq * C)  # frequency-major (f, c) features
    p_step = net.get("dropstep_recurrent", 0.0)
    len_step = net.get("dropstep_recurrent_len", 5)
    dropstep = train and p_step > 0
    if net.get("use_embeddings"):
        e = F.adaptive_avg_pool1d(emb.float(), T).transpose(1, 2)
        if dropstep:
            h = time_mask(gen, h, len_step, p_step, axis=1)
            e = time_mask(gen, e, len_step, p_step, axis=1)
        c = torch.cat([h, e], dim=-1)
        if train:
            c = dropout(gen, c, rate)
        h = F.linear(c, p["cat_tf.weight"], p["cat_tf.bias"])
    elif dropstep:
        h = time_mask(gen, h, len_step, p_step, axis=1)
        if train:
            h = dropout(gen, h, rate)
    layers = net.get("rnn_layers") or net.get("n_layers_RNN", 1)
    for layer in range(layers):
        outs = []
        for sfx, rev in (("", False), ("_reverse", True)):
            w = lambda n: p[f"rnn.{n}_l{layer}{sfx}"]  # noqa: E731
            xg = F.linear(h, w("weight_ih"), w("bias_ih"))
            outs.append(_gru_direction(xg, w("weight_hh"), w("bias_hh"), rev))
        h = torch.cat(outs, dim=-1)
        if train and layer < layers - 1:
            h = dropout(gen, h, net.get("dropout_recurrent", 0.0))
    if train:
        h = dropout(gen, h, rate)
    strong = torch.sigmoid(F.linear(h, p["dense.weight"], p["dense.bias"]))  # [B, T, C]
    sof = F.linear(h, p["dense_softmax.weight"], p["dense_softmax.bias"])
    invalid = ~cmask[:, None, :]
    sof = torch.clamp(torch.softmax(sof.masked_fill(invalid, -1e30), dim=-1), 1e-7, 1.0)
    weak = (strong * sof).sum(dim=1) / sof.sum(dim=1)
    strong = strong.masked_fill(invalid, 0.0)
    weak = weak.masked_fill(~cmask, 0.0)
    return strong.transpose(1, 2), weak


def median_filter(scores: torch.Tensor, windows) -> torch.Tensor:
    """scipy.ndimage.median_filter(x, (k, 1)) per class on [B, C, T]
    ("reflect" boundary, which repeats the edge sample); for an even k the
    mean of the two middle values, as numpy's median."""
    out = scores.clone()
    T = scores.shape[-1]
    for c, k in enumerate(int(w) for w in windows):
        if k <= 1:
            continue
        left, right = k // 2, k - k // 2 - 1
        x = scores[:, c]
        padded = torch.cat([x[:, :left].flip(-1), x, x[:, T - right:].flip(-1)], dim=-1)
        srt = padded.unfold(-1, k, 1).sort(dim=-1).values
        out[:, c] = srt[..., k // 2] if k % 2 else 0.5 * (srt[..., k // 2 - 1] + srt[..., k // 2])
    return out
