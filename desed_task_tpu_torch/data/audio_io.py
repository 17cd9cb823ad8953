"""Host-side audio I/O (counterpart of desed_task_tpu/data/audio_io.py):
the pure-Python RIFF reader, the polyphase resampler, and `read_audio`,
which decodes through the native C++ loader (data/native.py) where JAX's
does (a mean downmix: neither multisrc nor random_channel), falling back to
the Python reader where the C++ parser rejects a file.

PCM 8/16/24/32-bit and IEEE float WAVE files are decoded to float32 scaled
to [-1, 1) by the type's full scale, as torchaudio.load does.
"""

from __future__ import annotations

import math
import random
import struct

import numpy as np


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 array [samples] or [channels, samples], rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_ch, rate, _, block_align, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: decide by bit layout
        audio_format = 3 if bits == 32 and block_align == 4 * n_ch else 1
    if audio_format == 1:
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            i = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i = np.where(i >= 1 << 23, i - (1 << 24), i)
            x = i.astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_format == 3:
        if bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise ValueError(f"{path}: unsupported float bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format {audio_format}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).T  # [C, N]
    return x, rate


def write_wav(path, audio: np.ndarray, rate: int):
    """Write float32 [N] or [C, N] as 16-bit PCM."""
    audio = np.asarray(audio, np.float32)
    n_ch = 1 if audio.ndim == 1 else audio.shape[0]
    if audio.ndim == 2:
        audio = audio.T.reshape(-1)  # interleave
    pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(
            b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_ch, rate, rate * 2 * n_ch, 2 * n_ch, 16)
        )
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def to_mono(x: np.ndarray, random_channel: bool = False) -> np.ndarray:
    """Downmix [C, N] -> [N]; mean by default, or a random channel."""
    if x.ndim > 1:
        if random_channel and x.shape[0] > 1:
            return x[np.random.randint(0, x.shape[0] - 1)]
        return x.mean(0)
    return x


def pad_audio(audio: np.ndarray, target_len: int, fs: int, test: bool = False, rng=None):
    """Zero-pad short clips; random-crop (train) / left-crop (test) long ones.

    Returns (audio, onset_s, offset_s, padded_ratio)."""
    n = audio.shape[-1]
    if n < target_len:
        audio = np.pad(audio, (0, target_len - n))
        onset_s = 0.0
        padded = target_len / n
    elif n > target_len:
        start = 0 if test else (rng or random).randint(0, n - target_len)
        audio = audio[start : start + target_len]
        onset_s = round(start / fs, 3)
        padded = 1.0
    else:
        onset_s = 0.0
        padded = 1.0
    offset_s = round(onset_s + target_len / fs, 3)
    return audio.astype(np.float32), onset_s, offset_s, padded


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling on the last axis (scipy's resample_poly in
    float64, up and down by the rates' reduced ratio) -> float32."""
    if orig_sr == target_sr:
        return np.asarray(audio, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(audio, np.float64), target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)


def read_audio(path, multisrc: bool = False, random_channel: bool = False,
               pad_to: int | None = None, test: bool = False, target_fs: int | None = None):
    """decode -> (mono) -> (resample to target_fs) -> pad/crop. Returns
    (audio, onset_s, offset_s, padded). The native decoder's mean downmix
    sums in double precision: within 1e-7 of the Python path's float32
    mean (equal for mono files)."""
    from . import native

    audio = None
    if not multisrc and not random_channel and native.available():
        try:
            audio, fs = native.decode(path)
        except (ValueError, RuntimeError):
            pass
    if audio is None:
        audio, fs = read_wav(path)
        if not multisrc:
            audio = to_mono(audio, random_channel)
    if target_fs is not None and fs != target_fs:
        audio = resample(audio, fs, target_fs)
        fs = target_fs
    if pad_to is not None:
        audio, onset_s, offset_s, padded = pad_audio(audio, pad_to, fs, test=test)
    else:
        onset_s, offset_s, padded = None, None, 1.0
    return audio.astype(np.float32), onset_s, offset_s, padded
