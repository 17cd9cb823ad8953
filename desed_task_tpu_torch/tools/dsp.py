"""Host-side DSP for soundscape synthesis: pitch shift and LUFS loudness
(own copy of desed_task_tpu/tools/dsp.py, numpy and scipy).

The reference's scaper pipeline applies uniform ±3-semitone pitch shifts
(via rubberband) and LUFS-based loudness normalization
(generate_dcase_task4_2021.py:539-541, scaper internals). Neither tool is
a dependency of the project, so both are implemented from their definitions:

  * pitch_shift — resample by the frequency ratio (changes pitch AND
    duration), then restore the duration with a phase-vocoder time-stretch
    (STFT, per-bin phase accumulation, overlap-add ISTFT).
  * lufs — ITU-R BS.1770-4 integrated loudness: K-weighting (high-shelf +
    high-pass biquads designed at the signal's sample rate) -> 400 ms
    blocks with 75% overlap -> absolute (-70 LUFS) and relative (-10 LU)
    gating.
"""

from __future__ import annotations

import math

import numpy as np

from ..data.audio_io import resample


# ---------------------------------------------------------------------------
# phase-vocoder pitch shift
# ---------------------------------------------------------------------------

def _stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    window = np.hanning(n_fft).astype(np.float64)
    n_frames = 1 + max(0, (len(x) - n_fft)) // hop
    frames = np.lib.stride_tricks.as_strided(
        x,
        shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop, x.strides[0]),
    )
    return np.fft.rfft(frames * window, axis=1)


def time_stretch(x: np.ndarray, rate: float, n_fft: int = 1024) -> np.ndarray:
    """Phase-vocoder time stretch: output duration = len(x) / rate."""
    if rate == 1.0:
        return np.asarray(x, np.float32)
    hop = n_fft // 4
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    if len(x) < n_fft:
        x = np.pad(x, (0, n_fft - len(x)))
    spec = _stft(x, n_fft, hop)  # [n_frames, n_bins]
    n_frames = spec.shape[0]
    # fractional analysis positions for each synthesis frame
    t = np.arange(0, n_frames - 1, rate)
    omega = 2.0 * np.pi * hop * np.arange(spec.shape[1]) / n_fft
    phase = np.angle(spec[0])
    out_spec = np.empty((len(t), spec.shape[1]), np.complex128)
    for i, ti in enumerate(t):
        k = int(ti)
        frac = ti - k
        mag = (1 - frac) * np.abs(spec[k]) + frac * np.abs(spec[k + 1])
        out_spec[i] = mag * np.exp(1j * phase)
        # phase advance between consecutive analysis frames, unwrapped
        dphi = np.angle(spec[k + 1]) - np.angle(spec[k]) - omega
        dphi -= 2.0 * np.pi * np.round(dphi / (2.0 * np.pi))
        phase = phase + omega + dphi
    # overlap-add ISTFT
    window = np.hanning(n_fft)
    out_len = n_fft + (len(t) - 1) * hop
    out = np.zeros(out_len)
    norm = np.zeros(out_len)
    frames = np.fft.irfft(out_spec, n=n_fft, axis=1)
    for i in range(len(t)):
        s = i * hop
        out[s : s + n_fft] += frames[i] * window
        norm[s : s + n_fft] += window**2
    out /= np.maximum(norm, 1e-8)
    return out.astype(np.float32)


def pitch_shift(x: np.ndarray, semitones: float, fs: int) -> np.ndarray:
    """Pitch shift preserving duration (rubberband-equivalent semantics).

    Resampling by the frequency ratio r = 2^(semitones/12) raises the pitch
    by r while shortening the signal by r; a phase-vocoder stretch restores
    the original duration. Output length == input length.
    """
    if abs(semitones) < 1e-6:
        return np.asarray(x, np.float32)
    n = len(x)
    r = 2.0 ** (semitones / 12.0)
    # resample to fs/r samples-per-second worth of samples, played at fs
    inter = resample(np.asarray(x, np.float32), int(round(fs * r)), fs)
    out = time_stretch(inter, rate=len(inter) / n)
    if len(out) >= n:
        return out[:n]
    return np.pad(out, (0, n - len(out)))


# ---------------------------------------------------------------------------
# ITU-R BS.1770-4 loudness
# ---------------------------------------------------------------------------

def _biquad(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    from scipy.signal import lfilter

    return lfilter(b, a, x)


def _k_weighting_coeffs(fs: int):
    """Stage-1 high-shelf + stage-2 high-pass biquads at sample rate fs
    (BS.1770 defines them at 48 kHz; re-designed here from the analog
    prototypes so any fs works — the pyloudnorm-documented parameters)."""
    # stage 1: high shelf, f0=1681.97 Hz, gain +3.9998 dB, Q=0.7072
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554196
    K = math.tan(math.pi * f0 / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    shelf_b = np.array([
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0,
    ])
    shelf_a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    # stage 2: high pass, f0=38.135 Hz, Q=0.5003
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / fs)
    a0 = 1.0 + K / Q + K * K
    hp_b = np.array([1.0, -2.0, 1.0]) / a0
    hp_a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return (shelf_b, shelf_a), (hp_b, hp_a)


def lufs(x: np.ndarray, fs: int) -> float:
    """Integrated loudness (mono) in LUFS with BS.1770-4 gating."""
    x = np.asarray(x, np.float64)
    (sb, sa), (hb, ha) = _k_weighting_coeffs(fs)
    y = _biquad(_biquad(x, sb, sa), hb, ha)
    block = int(0.400 * fs)
    hop = int(0.100 * fs)
    if len(y) < block:
        y = np.pad(y, (0, block - len(y)))
    n_blocks = 1 + (len(y) - block) // hop
    idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
    ms = np.mean(y[idx] ** 2, axis=1)
    lk = -0.691 + 10.0 * np.log10(ms + 1e-12)
    keep = lk > -70.0  # absolute gate
    if not keep.any():
        return -70.0
    rel_gate = -0.691 + 10.0 * np.log10(np.mean(ms[keep]) + 1e-12) - 10.0
    keep &= lk > rel_gate
    if not keep.any():
        return -70.0
    return float(-0.691 + 10.0 * np.log10(np.mean(ms[keep]) + 1e-12))


def scale_to_lufs(x: np.ndarray, target_lufs: float, fs: int) -> np.ndarray:
    gain = 10.0 ** ((target_lufs - lufs(x, fs)) / 20.0)
    return (np.asarray(x, np.float32) * gain).astype(np.float32)
