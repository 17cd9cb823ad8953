"""Log-mel front-end (counterpart of desed_task_tpu/ops/frontend.py).

    waveform [B, N] -> frames -> windowed DFT (power=1) -> mel -> dB -> clamp

The reference numerics are those of the JAX module: n_fft = win_length =
2048, hop 256, a symmetric hamming window, center=True with reflect padding,
128 HTK mels over [0, 8000] Hz with no filterbank norm, then
20*log10(max(x, 1e-5)) clamped to [-50, 80].

Only the `matmul` backend is ported: the DFT is one GEMM of the frames with
the windowed [cos | -sin] basis, then the magnitude and the mel GEMM. The
JAX package runs these products outside any Pallas kernel, so here they are
plain `torch.matmul`. The path is fp32 throughout (frontend.py:298-308):
a caller on the card keeps `torch.backends.cuda.matmul.allow_tf32 = False`
(PyTorch's default), which `InferencePipeline` sets.

Filterbank and basis constants are built on the host in float64 numpy and
cast to float32 once per (config, device).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Front-end configuration (defaults = DCASE Task 4 baseline feats)."""

    sample_rate: int = 16000
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 256
    f_min: float = 0.0
    f_max: float = 8000.0
    n_mels: int = 128
    power: float = 1.0
    window: str = "hamming"  # "hamming" | "hann"
    periodic_window: bool = False  # reference uses periodic=False (symmetric)
    center: bool = True
    pad_mode: str = "reflect"
    amin: float = 1e-5
    db_clamp_min: float | None = -50.0
    db_clamp_max: float | None = 80.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        if self.center:
            n_samples = n_samples + 2 * (self.n_fft // 2)
        return 1 + (n_samples - self.n_fft) // self.hop_length


def make_window(kind: str, win_length: int, periodic: bool) -> np.ndarray:
    """Window identical to torch.{hamming,hann}_window(periodic=...)."""
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * math.pi * t / n)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * math.pi * t / n)
    raise ValueError(f"unknown window {kind!r}")


def _hz_to_mel_htk(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels], norm=None
    (torchaudio.functional.melscale_fbanks defaults)."""
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_freqs)
    m_pts = np.linspace(
        _hz_to_mel_htk(cfg.f_min), _hz_to_mel_htk(cfg.f_max), cfg.n_mels + 2
    )
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    return np.maximum(0.0, np.minimum(down, up))


def frame_signal(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] -> [B, n_frames, n_fft] with torch.stft center/reflect padding."""
    if cfg.center:
        p = cfg.n_fft // 2
        audio = F.pad(audio[:, None, :], (p, p), mode=cfg.pad_mode)[:, 0]
    return audio.unfold(-1, cfg.n_fft, cfg.hop_length)


def _dft_basis(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis matrices [n_fft, n_freqs] (cos, -sin)."""
    k = np.arange(cfg.n_freqs, dtype=np.float64)
    t = np.arange(cfg.n_fft, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(t, k) / cfg.n_fft
    w = make_window(cfg.window, cfg.win_length, cfg.periodic_window)
    if cfg.win_length < cfg.n_fft:  # torch center-pads the window
        lpad = (cfg.n_fft - cfg.win_length) // 2
        w = np.pad(w, (lpad, cfg.n_fft - cfg.win_length - lpad))
    return np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]


@functools.lru_cache(maxsize=8)
def _constants(cfg: MelConfig, device: torch.device):
    cos_b, sin_b = _dft_basis(cfg)
    basis = torch.as_tensor(
        np.concatenate([cos_b, sin_b], axis=1), dtype=torch.float32, device=device
    )
    fb = torch.as_tensor(mel_filterbank(cfg), dtype=torch.float32, device=device)
    return basis, fb


def spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Magnitude (power=1) or power spectrogram: [B, N] -> [B, n_freqs, n_frames]."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    frames = frame_signal(audio.float(), cfg)  # [B, T, n_fft]
    basis, _ = _constants(cfg, audio.device)
    reim = torch.matmul(frames, basis)  # [B, T, 2 * n_freqs]
    re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs :]
    mag2 = re * re + im * im
    if cfg.power == 1.0:
        out = torch.sqrt(torch.clamp(mag2, min=0.0))
    elif cfg.power == 2.0:
        out = mag2
    else:
        out = torch.clamp(mag2, min=0.0) ** (cfg.power / 2.0)
    out = out.transpose(-1, -2)
    return out[0] if squeeze else out


def mel_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] -> mel spectrogram [B, n_mels, n_frames] (power=cfg.power)."""
    spec = spectrogram(audio, cfg)  # [..., n_freqs, T]
    _, fb = _constants(cfg, audio.device)
    return torch.matmul(spec.transpose(-1, -2), fb).transpose(-1, -2)


def amplitude_to_db(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """torchaudio AmplitudeToDB(stype='amplitude', amin=1e-5) + clamp [-50, 80]."""
    multiplier = 10.0 if cfg.power == 2.0 else 20.0
    db = multiplier * torch.log10(torch.clamp(mel, min=cfg.amin))
    db = db - multiplier * math.log10(max(cfg.amin, 1.0))
    if cfg.db_clamp_min is not None or cfg.db_clamp_max is not None:
        db = torch.clamp(db, cfg.db_clamp_min, cfg.db_clamp_max)
    return db


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Waveform [B, N] -> log-mel dB [B, n_mels, n_frames]."""
    return amplitude_to_db(mel_spectrogram(audio, cfg), cfg)
