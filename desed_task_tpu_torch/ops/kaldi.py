"""Kaldi-compatible log-mel filterbank features, for BEATs and AST
(counterpart of desed_task_tpu/ops/kaldi.py).

Replaces torchaudio.compliance.kaldi.fbank as the BEATs preprocessor uses it
(waveform * 2^15 -> fbank(128 bins, 25 ms frames, 10 ms shift) ->
(x - 15.41663) / (2 * 6.55582)) and as the AST dataloader does (DC removal,
hanning window, pad or cut to 1024 frames, AudioSet mean and std).

The steps, in the JAX module's order (torchaudio's kaldi defaults):
  * snip-edges framing: frames lie inside the signal,
    n = 1 + (N - 400) // 160 at 16 kHz;
  * per-frame DC removal;
  * pre-emphasis 0.97 with the first sample replicated;
  * the povey window ((0.5 - 0.5 cos)^0.85), hanning or hamming, built in
    float64 and cast to float32;
  * rfft at the next power of two (512), the power spectrum, the Nyquist
    bin dropped (Kaldi's mel banks skip it);
  * the mel product (mel scale 1127 ln(1 + f / 700), 20 Hz to Nyquist);
  * the natural log, floored at float64's epsilon; no dither.

`torch.fft.rfft` stands where JAX calls `jnp.fft.rfft` (no Pallas kernel).
The mel product is an fp32 product on both devices: `frontend.fp32_products`
on the CPU, TF32 off on the card (`device.fp32_math`).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..device import fp32_math
from .frontend import fp32_products, settle_cpu_vector_math

EPSILON = sys.float_info.epsilon


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def povey_window(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * t / (n - 1))) ** 0.85


def kaldi_window(n: int, window_type: str = "povey") -> np.ndarray:
    t = np.arange(n, dtype=np.float64)
    if window_type == "povey":
        return povey_window(n)
    if window_type == "hanning":
        return 0.5 - 0.5 * np.cos(2.0 * math.pi * t / (n - 1))
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * math.pi * t / (n - 1))
    raise ValueError(f"unknown kaldi window {window_type!r}")


def kaldi_mel_banks(num_bins: int, fft_len: int, sample_rate: float,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """[n_fft // 2, num_bins] triangular weights, Kaldi-style (no Nyquist bin)."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    freqs = np.arange(fft_len // 2) * sample_rate / fft_len
    m = mel(freqs)
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (m[None, :] - left) / mel_delta
    down = (right - m[None, :]) / mel_delta
    return np.maximum(0.0, np.minimum(up, down)).T


def kaldi_fbank(waveform: torch.Tensor, num_mel_bins: int = 128, sample_frequency: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemphasis_coefficient: float = 0.97, remove_dc_offset: bool = True,
                use_power: bool = True, window_type: str = "povey") -> torch.Tensor:
    """[B, N] or [N] (int16 full-scale units, x * 2^15) -> [B, n_frames,
    num_mel_bins] log-mel (natural log)."""
    squeeze = waveform.dim() == 1
    x = waveform[None] if squeeze else waveform
    x = x.float()
    win = int(sample_frequency * frame_length_ms / 1000)
    hop = int(sample_frequency * frame_shift_ms / 1000)
    n_fft = _next_pow2(win)
    frames = x.unfold(-1, win, hop)  # [B, 1 + (N - win) // hop, win]
    if remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    if preemphasis_coefficient != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis_coefficient * prev
    dev = x.device
    frames = frames * torch.as_tensor(kaldi_window(win, window_type), dtype=torch.float32,
                                      device=dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    if dev.type == "cpu":
        settle_cpu_vector_math()
    if not use_power:
        power = torch.sqrt(power)
    power = power[..., : n_fft // 2]
    mel_w = torch.as_tensor(kaldi_mel_banks(num_mel_bins, n_fft, float(sample_frequency)),
                            dtype=torch.float32, device=dev)
    with fp32_math(), fp32_products(dev):
        mel = power @ mel_w
    out = torch.log(torch.clamp_min(mel, EPSILON))
    return out[0] if squeeze else out


def beats_preprocess(audio: torch.Tensor, fbank_mean: float = 15.41663,
                     fbank_std: float = 6.55582) -> torch.Tensor:
    """BEATs front-end: int16 scaling, fbank, normalisation. [B, N] in
    [-1, 1] -> [B, n_frames, 128]."""
    fbank = kaldi_fbank(audio * (2.0 ** 15))
    return (fbank - fbank_mean) / (2.0 * fbank_std)


def ast_preprocess(audio: torch.Tensor, target_length: int = 1024,
                   audioset_mean: float = -4.2677393,
                   audioset_std: float = 4.5689974) -> torch.Tensor:
    """AST front-end: DC removal, hanning fbank (128 bins, 10 ms shift),
    zero-padded or cut to `target_length` frames, AudioSet normalisation.
    Returns [B, target_length, 128]."""
    audio = audio - audio.mean(-1, keepdim=True)
    fbank = kaldi_fbank(audio, window_type="hanning")
    t = fbank.shape[-2]
    if t < target_length:
        fbank = torch.nn.functional.pad(fbank, (0, 0, 0, target_length - t))
    else:
        fbank = fbank[:, :target_length]
    return (fbank - audioset_mean) / (audioset_std * 2.0)
