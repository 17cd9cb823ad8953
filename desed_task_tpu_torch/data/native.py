"""ctypes bindings of the native WAVE decoder (counterpart of
desed_task_tpu/data/native.py; the port's own copy of the source is
csrc/wavio.cpp).

The library is built at first use with

    g++ -O3 -march=native -shared -fPIC -std=c++17 -o <build>/wavio-<hash>.so \
        csrc/wavio.cpp -lpthread

into `desed_task_tpu_torch/_kernels_build/` (listed in .gitignore), named
and written as `ops/_build` names and writes the CUDA libraries (a hash of
the source and the flags in the name; a temporary file renamed into place).
A machine without g++ has no
loader: `available()` is False there and says so once, on one line. A build
that fails where g++ exists raises.

    decode(path, max_frames)              -> (float32 [n], rate), mean downmix
    decode_batch(paths, target_len, ...)  -> (float32 [B, target_len],
                                              onsets [B] in samples)

The batch call releases the GIL for the whole decode, downmix and pad/crop
of a batch (threads in C++). In train mode each long file's crop onset comes
from std::mt19937_64 seeded with seed + i, as in the JAX package. A file
the parser rejects (not RIFF/WAVE, or a sample format other than PCM
8/16/24/32-bit and 32-bit float) raises ValueError; callers fall back to
`audio_io.read_wav` there. `COUNTS["decode_batch"]` counts the batches
decoded (host calls, kept apart from `_build.LAUNCHES`, which counts the
card's kernels).
"""

from __future__ import annotations

import ctypes
import shutil
import sys
import threading
from pathlib import Path

import numpy as np

from ..ops import _build

SRC = _build.PACKAGE / "csrc" / "wavio.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

COUNTS = {"decode_batch": 0}
_lock = threading.Lock()
_lib = None
_no_compiler = False


def reset_counts() -> None:
    with _lock:
        COUNTS["decode_batch"] = 0


def library_path() -> Path:
    return _build.library_path(SRC, FLAGS)


def _load():
    global _lib, _no_compiler
    with _lock:
        if _lib is not None or _no_compiler:
            return _lib
        out = library_path()
        if not out.is_file():
            gxx = shutil.which("g++")
            if gxx is None:
                _no_compiler = True
                print("native wav loader: no g++ on this machine; decoding in Python",
                      file=sys.stderr)
                return None
            err = _build.finish_compile(
                _build.start_compile(gxx, FLAGS, SRC, out, libs=("-lpthread",)))
            if err is not None:
                raise RuntimeError(err)
        lib = ctypes.CDLL(str(out))
        lib.wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
        lib.wav_info.restype = ctypes.c_int
        lib.wav_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
        lib.wav_decode.restype = ctypes.c_long
        lib.wav_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long, ctypes.c_int,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int]
        lib.wav_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """The loader is built (building it on first use); False only where no
    g++ exists."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav loader unavailable (no g++)")
    return lib


def info(path) -> tuple[int, int, int]:
    """(rate, channels, frames) of a WAVE file."""
    lib = _require()
    rate, ch, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    if lib.wav_info(str(path).encode(), ctypes.byref(rate), ctypes.byref(ch),
                    ctypes.byref(frames)) != 0:
        raise ValueError(f"cannot parse wav {path}")
    return rate.value, ch.value, frames.value


def decode(path, max_frames: int | None = None) -> tuple[np.ndarray, int]:
    """Mono float32 decode (the mean over channels) of at most max_frames
    frames (default: all)."""
    lib = _require()
    if max_frames is None:
        _, _, max_frames = info(path)
    out = np.zeros(max_frames, np.float32)
    rate, ch = ctypes.c_int(), ctypes.c_int()
    n = lib.wav_decode(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       max_frames, ctypes.byref(rate), ctypes.byref(ch))
    if n < 0:
        raise ValueError(f"cannot decode wav {path}")
    return out[:n], rate.value


def decode_batch(paths: list, target_len: int, test_mode: bool = False, seed: int = 0,
                 n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Parallel decode of a batch: ([B, target_len] mono float32, crop
    onsets [B] in samples). Short files are zero-padded; long ones cropped
    at 0 (test mode) or at a seeded onset. n_threads 0: one a core."""
    lib = _require()
    n = len(paths)
    out = np.zeros((n, target_len), np.float32)
    onsets = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.wav_decode_batch(
        arr, n, target_len, 1 if test_mode else 0, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        onsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads)
    if failures:
        raise ValueError(f"{failures} files failed to decode in batch")
    with _lock:
        COUNTS["decode_batch"] += 1
    return out, onsets
