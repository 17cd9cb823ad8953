"""Fused log-mel front-end: framing, windowed DFT, magnitude, mel, log-dB.

Counterpart of desed_task_tpu/ops/pallas_mel.py. A hand-written CUDA kernel
(csrc/fused_mel.cu) computes the whole power-1 chain that the GEMM
front-end (ops/frontend.py) materializes in device memory, and writes only
the log-mel [B, n_mels, n_frames]. It replaces the inner `kernel` of
`pallas_log_mel` (pallas_mel.py:96, called at :147). The source holds two
kernels, and `fused_log_mel_plan` there picks one per shape: fp32 FMAs on
the CUDA cores (plan 1), or, in bf16 mode with hop % 8 == 0 and at most 128
mels, `wgmma` on the tensor cores fed by a TMA ring, the frequency tiles
split between the two blocks of a cluster (plan 3); the wrapper lays the
constants out for it.

`MelConfig.compute_dtype` selects the mode, as it does for the TPU kernel
(pallas_mel.py:77): fp32, or "bfloat16", where the frame samples, the
windowed DFT basis, the magnitudes and the filterbank are rounded to bf16
and every product is summed in fp32. The magnitude and filterbank roundings
are the TPU kernel's (pallas_mel.py:85-87, :127-129); the GEMM front-end
keeps both in fp32, so the two differ in bf16 by up to a few hundredths of
a dB.

Nothing reroutes the serving or train paths here: they call
`log_mel_spectrogram`, as the JAX package's do. `fused_log_mel` takes its
plain PyTorch version (`fused_log_mel_plain`, beside it) only for CPU
tensors; for CUDA tensors it launches the kernel or raises. Launches count
as "fused_log_mel" in fp32 and "fused_log_mel.bf16" in bf16. Unlike the TPU
kernel it pads neither batch nor time and takes any frame count.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .frontend import (MelConfig, _constants, center_pad, compute_dtype, fp32_products,
                       settle_cpu_vector_math)

TF = 128  # frequencies per tile of the CUDA-core kernel's basis layout (fused_mel.cu)
BK = 32  # samples per staged basis slice, CUDA-core kernel (fused_mel.cu)
# the tensor-core kernel (fused_mel.cu WG_*): frames per cluster, samples per
# basis item, frequencies per tile, mels (rows) of the filterbank item, ring
# stages, and blocks per cluster (each a share of the frequency tiles)
WG_TT, WG_TK, WG_TF, WG_MELS, WG_STAGES, WG_SPLIT = 128, 64, 64, 128, 4, 2
LOG10E = math.log10(math.e)


def _refuse(cfg: MelConfig) -> None:
    if cfg.power != 1.0:
        raise ValueError("fused_log_mel implements the power=1 path (pallas_mel.py:55)")
    if not cfg.center:
        # pallas_mel.py:63-64 pads by n_fft//2 whatever cfg.center says but
        # counts frames without the padding (:59): its output is not the
        # center=False spectrogram
        raise ValueError("fused_log_mel takes center=True only")


def _db(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """20 * ln(max(mel, amin)) * log10(e) - shift, clamped (pallas_mel.py:141-144)."""
    shift = 20.0 * math.log10(max(cfg.amin, 1.0))
    db = 20.0 * (torch.log(torch.clamp(mel, min=cfg.amin)) * LOG10E) - shift
    if cfg.db_clamp_min is not None or cfg.db_clamp_max is not None:
        db = torch.clamp(db, cfg.db_clamp_min, cfg.db_clamp_max)
    return db


def fused_log_mel_plain(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] waveform -> [B, n_mels, n_frames] log-mel dB, step by step as
    the TPU kernel computes it, rounding to bf16 where it does."""
    _refuse(cfg)
    if audio.device.type == "cpu":
        settle_cpu_vector_math()
    cdt = compute_dtype(cfg)
    frames = center_pad(audio.float(), cfg).unfold(-1, cfg.n_fft, cfg.hop_length)
    basis, fb = _constants(cfg, audio.device, cdt)
    with fp32_products(audio.device):  # fp32 GEMMs whatever the process-wide setting
        reim = torch.matmul(frames.to(cdt).float(), basis.float())  # [B, T, 2 * n_freqs]
    re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs :]
    mag = torch.sqrt(re * re + im * im)
    with fp32_products(audio.device):
        mel = torch.matmul(mag.to(cdt).float(), fb.float())  # [B, T, n_mels]
    return _db(mel, cfg).transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=8)
def _kernel_constants(cfg: MelConfig, device: torch.device, dtype: torch.dtype, plan: int):
    """The basis and filterbank of `_constants`, laid out for the kernel that
    `plan` names (fused_mel.cu), for the frequencies f_lo..f_hi - 1 from the
    first to the last whose filterbank row is not all zero (the others add
    nothing to any mel; with f_min = 0 the DC row is zero), zero past n_fft,
    f_hi and n_mels.

    plan 1 (CUDA cores): basis [n_tiles, KP, 2, TF], one contiguous BK-row
    slice after another, cos then -sin of TF frequencies per row; filterbank
    [n_tiles * TF, MP]. plan 3 (tensor cores): one sequence of ring items
    [n_tiles, n_chunks + 1, 2 * WG_TF, WG_TK] (n_chunks = KP / WG_TK), per
    tile of WG_TF frequencies n_chunks basis items, row j cos and row
    WG_TF + j -sin of frequency j over WG_TK samples (K-major), then the
    filterbank item, row m holding fb[tile frequencies, m] for m < WG_MELS;
    its filterbank is a view of those items. Returns (basis, filterbank,
    slice depth, number of frequencies f_hi - f_lo)."""
    basis, fb = _constants(cfg, device, dtype)
    used = torch.nonzero(fb.ne(0).any(1)).flatten().tolist() or [0]
    f_lo, f_hi = used[0], used[-1] + 1
    n_fft, nf, nm = cfg.n_fft, f_hi - f_lo, cfg.n_mels
    tf, bk = (WG_TF, WG_TK) if plan == 3 else (TF, BK)
    n_tiles = -(-nf // tf)
    kp = -(-n_fft // bk) * bk
    kb = torch.zeros((kp, 2, n_tiles * tf), dtype=dtype, device=device)
    kb[:n_fft, 0, :nf] = basis[:, f_lo:f_hi]
    kb[:n_fft, 1, :nf] = basis[:, cfg.n_freqs + f_lo : cfg.n_freqs + f_hi]
    if plan == 3:
        n_chunks = kp // bk
        items = torch.zeros((n_tiles, n_chunks + 1, 2 * tf, bk), dtype=dtype, device=device)
        items[:, :n_chunks] = kb.view(n_chunks, bk, 2, n_tiles, tf).permute(3, 0, 2, 4, 1).reshape(
            n_tiles, n_chunks, 2 * tf, bk)
        fbp = torch.zeros((n_tiles * tf, WG_MELS), dtype=dtype, device=device)
        fbp[:nf, :nm] = fb[f_lo:f_hi]
        items[:, n_chunks] = fbp.view(n_tiles, tf, WG_MELS).transpose(1, 2)
        return items, items[:, n_chunks], bk, nf
    kb = kb.view(kp, 2, n_tiles, tf).permute(2, 0, 1, 3)
    kfb = torch.zeros((n_tiles * tf, -(-nm // 4) * 4), dtype=dtype, device=device)
    kfb[:nf, :nm] = fb[f_lo:f_hi]
    return kb.contiguous(), kfb.contiguous(), bk, nf


def fused_log_mel(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] waveform -> [B, n_mels, n_frames] log-mel dB (power 1).

    Refuses power != 1 and center=False. On the card the audio must be a
    contiguous float32 tensor; any B and N (with N > n_fft // 2, for the
    reflect padding) are taken.
    """
    if audio.device.type == "cpu":
        return fused_log_mel_plain(audio, cfg)
    _refuse(cfg)
    _build.require_cuda_f32("fused_log_mel", audio)
    if audio.dim() != 2:
        raise ValueError(f"fused_log_mel: audio must be [B, N], got {tuple(audio.shape)}")
    bf16 = cfg.compute_dtype == "bfloat16"
    plan = _build.function("fused_mel", "fused_log_mel_plan", [_build.I] * 4)(
        cfg.n_fft, cfg.hop_length, cfg.n_mels, int(bf16))
    if plan == 0:
        raise ValueError(f"fused_log_mel: n_fft={cfg.n_fft}, hop={cfg.hop_length}, "
                         f"n_mels={cfg.n_mels} do not fit the kernels' shared memory")
    cdt = compute_dtype(cfg)
    kb, kfb, bk, n_freqs = _kernel_constants(cfg, audio.device, cdt, plan)
    _build.require_cuda("fused_log_mel", cdt, kb, *([] if plan == 3 else [kfb]))
    x = center_pad(audio, cfg)
    B, n_pad = x.shape
    T = cfg.num_frames(audio.shape[1])
    out = torch.empty((B, cfg.n_mels, T), device=audio.device, dtype=torch.float32)
    lo = -math.inf if cfg.db_clamp_min is None else cfg.db_clamp_min
    hi = math.inf if cfg.db_clamp_max is None else cfg.db_clamp_max
    fn = _build.function("fused_mel", "fused_log_mel",
                         [_build.P] * 4 + [_build.I] * 10 + [_build.Fl] * 4 + [_build.P])
    err = fn(x.data_ptr(), kb.data_ptr(), kfb.data_ptr(), out.data_ptr(), B, n_pad, T,
             cfg.n_fft, cfg.hop_length, n_freqs, cfg.n_mels, int(bf16),
             WG_TF if plan == 3 else TF, bk,
             cfg.amin, 20.0 * math.log10(max(cfg.amin, 1.0)), lo, hi, _build.stream_ptr(x))
    _build.check(err, "fused_log_mel")
    _build.count_launch("fused_log_mel.bf16" if bf16 else "fused_log_mel")
    return out
