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

`fused_log_mel` is on no path: the serving and train paths call
`frontend.mel_spectrogram`, as the JAX package's do. It takes its plain
PyTorch version (`fused_log_mel_plain`, beside it) only for CPU tensors;
for CUDA tensors it launches the kernel or raises. Launches count as
"fused_log_mel" in fp32 and "fused_log_mel.bf16" in bf16. Unlike the TPU
kernel it pads neither batch nor time and takes any frame count.

The source's third kernel, `mel_linear_wg_kernel`, is on those paths:
`frontend.mel_spectrogram` hands it every input that `linear_mel_takes`
accepts (a CUDA tensor, the matmul backend in bf16, power 1, center with
reflect padding, a shape the kernel takes and a banded filterbank: the
recipes' front end). It keeps the GEMM front-end's numerics, the DFT of
bf16-rounded frames and basis summed in fp32, then the fp32 magnitude and
the fp32 mel product (with the filterbank as one band row a frequency,
`band_table`), and writes the linear mel; `amplitude_to_db` follows as on
the GEMM path. Only the order of the fp32 sums differs. It is the custom
op desed_torch::mel_linear (its plain version `mel_linear_plain` for CPU
tensors), so an exported serving program keeps it; launches count as
"mel_spectrogram.fused".
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .frontend import (MelConfig, _constants, center_pad, compute_dtype, fp32_products,
                       mel_filterbank, settle_cpu_vector_math)

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


# --------------------------------------------------------------------------
# The linear mel of the GEMM front-end in one kernel (mel_linear_wg_kernel)
# --------------------------------------------------------------------------


def band_table(fb) -> torch.Tensor | None:
    """A filterbank [n_freqs, n_mels] (a tensor or an array) as the linear
    mode reads it: float32 [n_freqs, 4], row f = {w0, w1, m0, 0} with m0's
    int32 bits in a float, where fb[f, m0] = w0, fb[f, m0 + 1] = w1 and the
    rest of row f is zero; m0 is nondecreasing in f and m0 + 1 < n_mels. A
    row with no nonzero keeps the previous m0 with zero weights; one with a
    single nonzero at m pairs it with mel m - 1 where that keeps m0
    nondecreasing, else with m + 1, the other weight zero. None when the
    filterbank is not so banded: fewer than two mels, a frequency in three
    filters, or in two that are not neighbours, or rows whose filters go
    back down."""
    fb = np.asarray(fb.detach().cpu() if isinstance(fb, torch.Tensor) else fb, np.float32)
    n_freqs, n_mels = fb.shape
    nz = fb != 0
    count = nz.sum(1)
    if n_mels < 2 or (count > 2).any():
        return None
    first = nz.argmax(1)  # the lowest nonzero mel of each row (0 for an empty row)
    last = n_mels - 1 - nz[:, ::-1].argmax(1)
    if (last[count == 2] != first[count == 2] + 1).any():
        return None
    # m0: a pair's lower mel; an empty row's is the last m0 before it; a lone
    # filter's the mel below it unless the m0 before it is higher
    m0 = np.maximum.accumulate(np.where(count == 1, first - 1, np.where(count, first, 0)).clip(0))
    m0 = np.where(count == 2, first, m0).astype(np.int32)
    if (np.diff(m0) < 0).any() or (m0[count == 1] > first[count == 1]).any():
        return None
    rows = np.arange(n_freqs)
    table = np.zeros((n_freqs, 4), np.float32)
    table[:, 0], table[:, 1] = fb[rows, m0], fb[rows, m0 + 1]
    table[:, 2] = m0.view(np.float32)
    return torch.from_numpy(table)


def band_dense(table: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The filterbank [n_freqs, n_mels] that a band table holds."""
    m0 = table[:, 2].contiguous().view(torch.int32).long()
    rows = torch.arange(table.shape[0], device=table.device)
    dense = torch.zeros((table.shape[0], n_mels), dtype=table.dtype, device=table.device)
    dense[rows, m0] = table[:, 0]
    dense[rows, m0 + 1] = table[:, 1]
    return dense


@functools.lru_cache(maxsize=16)
def _laid_out_band(cfg: MelConfig) -> torch.Tensor | None:
    """The band table of the fp32 filterbank (as `_constants` rounds it) over
    the frequencies that plan 3 lays out (`_kernel_constants`: from the
    first to the last nonzero row of the bf16 filterbank), on the CPU,
    padded with zero weights to whole tiles of WG_TF; None where the
    filterbank is not banded, or holds a value below fp32's normal range
    (which could round to zero in bf16 and move the laid-out range)."""
    fb = mel_filterbank(cfg).astype(np.float32)
    nonzero = fb != 0
    if (np.abs(fb[nonzero]) < np.finfo(np.float32).tiny).any():
        return None
    used = np.flatnonzero(nonzero.any(1))
    f_lo, f_hi = (int(used[0]), int(used[-1]) + 1) if len(used) else (0, 1)
    table = band_table(fb[f_lo:f_hi])
    if table is None:
        return None
    pad = table[-1:].repeat(-(-(f_hi - f_lo) // WG_TF) * WG_TF - (f_hi - f_lo), 1)
    pad[:, :2] = 0.0
    return torch.cat([table, pad])


def _shape_plan(n_fft: int, hop: int, n_mels: int) -> bool:
    """fused_mel.cu fused_mel_linear_plan: whether the kernel takes these
    shapes (hop % 8 == 0, 2 to 128 mels, the layout within one block's
    shared memory). It builds the library, so only CUDA inputs ask."""
    plan = _build.function("fused_mel", "fused_mel_linear_plan", [_build.I] * 3)
    return bool(plan(n_fft, hop, n_mels))


@functools.lru_cache(maxsize=16)
def linear_mel_plan(cfg: MelConfig) -> bool:
    """Whether `mel_linear_wg_kernel` computes this configuration's linear
    mel as the GEMM front-end does: bf16 DFT inputs, power 1, center with
    reflect padding, a banded filterbank (`band_table`), and shapes the
    kernel takes (`_shape_plan`)."""
    return (cfg.compute_dtype == "bfloat16" and cfg.power == 1.0 and cfg.center
            and cfg.pad_mode == "reflect" and _laid_out_band(cfg) is not None
            and _shape_plan(cfg.n_fft, cfg.hop_length, cfg.n_mels))


def linear_mel_takes(device: torch.device, cfg: MelConfig, backend: str | None = None,
                     ndim: int = 2, requires_grad: bool = False) -> bool:
    """Whether `frontend.mel_spectrogram` computes the mel of a waveform on
    `device` with `ndim` dimensions in `mel_linear_wg_kernel`: a CUDA tensor
    of one or two dimensions that needs no gradient, the matmul backend, and
    `linear_mel_plan`. Every other input takes the GEMM path."""
    return (device.type == "cuda" and ndim in (1, 2) and not requires_grad
            and (backend or cfg.backend) == "matmul" and linear_mel_plan(cfg))


@functools.lru_cache(maxsize=8)
def _linear_constants(cfg: MelConfig, device: torch.device):
    """(the plan-3 ring items, the laid-out band table) on `device`."""
    items = _kernel_constants(cfg, device, torch.bfloat16, 3)[0]
    return items, _laid_out_band(cfg).to(device)


def linear_mel(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] (or [N]) waveform -> linear mel [B, n_mels, n_frames] fp32, as
    the GEMM front-end computes it in bf16 (module docstring), in one launch
    of `mel_linear_wg_kernel` (after the reflection pad); for inputs that
    `linear_mel_takes` accepts. The result is the [B, n_mels, T] view of a
    [B, T, n_mels] tensor, the GEMM path's layout."""
    squeeze = audio.dim() == 1
    x = center_pad((audio[None] if squeeze else audio).float(), cfg)
    items, band = _linear_constants(cfg, audio.device)
    mel = _MEL_LINEAR_OP(x, items, band, cfg.num_frames(audio.shape[-1]), cfg.n_fft,
                         cfg.hop_length, cfg.n_mels).transpose(1, 2)
    return mel[0] if squeeze else mel


def mel_linear_plain(x: torch.Tensor, items: torch.Tensor, band: torch.Tensor, T: int,
                     n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """The op's plain version: center-padded audio [B, n_pad], the plan-3
    ring items and the band table -> [B, T, n_mels]: frames rounded to
    bf16 times the items' basis, fp32 products; the fp32 magnitudes; their
    fp32 product with the filterbank that the table holds."""
    if x.device.type == "cpu":
        settle_cpu_vector_math()
    n_tiles, n_items, rows, bk = items.shape
    n_chunks, tf = n_items - 1, rows // 2
    kp = n_chunks * bk
    basis = (items[:, :n_chunks].float().reshape(n_tiles, n_chunks, 2, tf, bk)
             .permute(1, 4, 2, 0, 3).reshape(kp, 2, n_tiles * tf))
    xb = x.to(torch.bfloat16).float()
    xb = F.pad(xb, (0, max(0, (T - 1) * hop + kp - xb.shape[1])))
    frames = xb.unfold(-1, kp, hop)[:, :T]
    with fp32_products(x.device):
        re, im = torch.matmul(frames, basis[:, 0]), torch.matmul(frames, basis[:, 1])
    mag = torch.sqrt(re * re + im * im)
    with fp32_products(x.device):
        return torch.matmul(mag, band_dense(band, n_mels))


def _mel_linear_cuda(x, items, band, T, n_fft, hop, n_mels):
    _build.require_cuda_f32("mel_linear", x, band)
    _build.require_cuda("mel_linear", torch.bfloat16, items)
    B, n_pad = x.shape
    out = torch.empty((B, T, n_mels), device=x.device, dtype=torch.float32)
    if B == 0:
        return out
    fn = _build.function("fused_mel", "fused_mel_linear", [_build.P] * 4 + [_build.I] * 9
                         + [_build.P])
    err = fn(x.data_ptr(), items.data_ptr(), band.data_ptr(), out.data_ptr(), B, n_pad, T,
             n_fft, hop, band.shape[0], n_mels, WG_TF, WG_TK, _build.stream_ptr(x))
    _build.check(err, "mel_linear")
    _build.count_launch("mel_spectrogram.fused")
    return out


def _mel_linear_fake(x, items, band, T, n_fft, hop, n_mels):
    return x.new_empty((x.shape[0], T, n_mels))


# The op's registration lives as long as this library object (ops/fused_cnn.py).
_LIB = _build.op_library()
_build.define_op(_LIB, "mel_linear(Tensor x, Tensor items, Tensor band, int T, int n_fft, "
                 "int hop, int n_mels) -> Tensor",
                 _mel_linear_cuda, mel_linear_plain, _mel_linear_fake)
_MEL_LINEAR_OP = torch.ops.desed_torch.mel_linear.default
