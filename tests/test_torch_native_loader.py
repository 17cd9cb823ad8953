"""The port's native WAVE loader (data/native.py, csrc/wavio.cpp) against
the JAX package's (data/native.py, native/wavio.cpp) and against the port's
Python reader, on the CPU (g++ builds both libraries here).

  * decode of PCM 8/16/24/32-bit and 32-bit float files, mono and stereo:
    bitwise JAX's, and within 1e-7 of `read_wav` + the mean downmix (the
    C++ sums channels in double precision);
  * decode_batch: padding, left crops in test mode, and in train mode the
    onsets JAX draws (std::mt19937_64 from seed + i), bitwise;
  * `read_audio` and `InferencePipeline._load_batch` against JAX's on the
    same files, and their fallback to the Python reader where the parser
    rejects a file;
  * a 64-bit float file, which JAX's parser accepts and decodes as zeros
    (a caveat of the reference): the port's parser rejects it, so
    `read_audio` reads it in Python;
  * the build: into `_kernels_build/` under a hashed name; no g++ means no
    loader, said on one line; a build that fails where g++ exists raises.
"""

import struct
from types import SimpleNamespace

import numpy as np
import pytest

from desed_task_tpu.data import audio_io as jaudio
from desed_task_tpu.data import native as jnative
from desed_task_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from desed_task_tpu_torch.data import audio_io, native
from desed_task_tpu_torch.inference.pipeline import InferencePipeline

RATE = 16000
FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32)]


def write_wave(path, x, fmt: int, bits: int, rate: int = RATE):
    """x float [C, N] in [-1, 1) -> a WAVE file of that sample format."""
    x = np.atleast_2d(x)
    n_ch = x.shape[0]
    inter = x.T.reshape(-1)
    if fmt == 3:
        data = inter.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        data = np.clip(np.round(inter * 128 + 128), 0, 255).astype("u1").tobytes()
    elif bits == 24:
        v = np.clip(np.round(inter * 2 ** 23), -2 ** 23, 2 ** 23 - 1).astype("<i4")
        data = v.view("u1").reshape(-1, 4)[:, :3].tobytes()
    else:
        full = 2.0 ** (bits - 1)
        v = np.clip(np.round(inter * full), -full, full - 1)
        data = v.astype("<i2" if bits == 16 else "<i4").tobytes()
    block = n_ch * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, fmt, n_ch, rate, rate * block, block, bits))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    return path


def _signal(n, n_ch, seed):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (n_ch, n))


def test_library_builds_into_the_kernels_folder():
    assert native.available()
    lib = native.library_path()
    assert lib.parent.name == "_kernels_build" and lib.is_file()
    assert lib.name.startswith("wavio-") and len(lib.stem) == len("wavio-") + 16
    assert native.SRC.parent.name == "csrc" and native.SRC.parent.parent.name == \
        "desed_task_tpu_torch"


@pytest.mark.parametrize("n_ch", [1, 2])
@pytest.mark.parametrize("fmt,bits", FORMATS, ids=[f"{'pcm' if f == 1 else 'float'}{b}"
                                                   for f, b in FORMATS])
def test_decode_matches_jax_and_python(tmp_path, fmt, bits, n_ch):
    path = write_wave(tmp_path / "a.wav", _signal(3001, n_ch, bits + n_ch), fmt, bits)
    assert native.info(path) == jnative.info(path) == (RATE, n_ch, 3001)
    got, rate = native.decode(path)
    want, jrate = jnative.decode(path)
    assert rate == jrate == RATE and got.dtype == np.float32
    assert np.array_equal(got, want)
    py, _ = audio_io.read_wav(path)
    py = audio_io.to_mono(py)
    assert float(np.abs(got - py).max()) <= 1e-7
    if n_ch == 1 or bits in (8, 16, 24):  # exact sums: bitwise
        assert np.array_equal(got, py)
    part, _ = native.decode(path, max_frames=1000)
    assert np.array_equal(part, got[:1000])


def _files(tmp_path):
    """Shorter than, as long as and longer than 1000 samples; PCM16 and
    float, mono and stereo."""
    spec = [(700, 1, 1, 16), (1000, 2, 1, 16), (2500, 1, 3, 32), (4001, 2, 1, 24),
            (1300, 2, 3, 32)]
    return [write_wave(tmp_path / f"f{i}.wav", _signal(n, ch, i), fmt, bits)
            for i, (n, ch, fmt, bits) in enumerate(spec)]


@pytest.mark.parametrize("test_mode,seed", [(True, 0), (False, 0), (False, 12345)])
def test_decode_batch_matches_jax(tmp_path, test_mode, seed):
    paths = _files(tmp_path)
    got, onsets = native.decode_batch(paths, 1000, test_mode=test_mode, seed=seed, n_threads=3)
    want, jonsets = jnative.decode_batch(paths, 1000, test_mode=test_mode, seed=seed)
    assert got.shape == (5, 1000) and onsets.dtype == np.int64
    assert np.array_equal(got, want) and np.array_equal(onsets, jonsets)
    assert onsets[0] == onsets[1] == 0  # padded or exact
    if test_mode:
        assert not onsets.any()
    else:
        assert onsets[2:].any()
    for row, path, start in zip(got, paths, onsets):
        py = audio_io.to_mono(audio_io.read_wav(path)[0])[start : start + 1000]
        assert float(np.abs(row[: len(py)] - py).max()) <= 1e-7
        assert not row[len(py):].any()


@pytest.mark.parametrize("pad_to", [None, 1000])
def test_read_audio_matches_jax(tmp_path, pad_to):
    for path in _files(tmp_path):
        got = audio_io.read_audio(path, pad_to=pad_to, test=True)
        want = jaudio.read_audio(path, pad_to=pad_to, test=True)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        multi = audio_io.read_audio(path, multisrc=True)[0]  # the Python reader, no downmix
        assert np.array_equal(multi, jaudio.read_audio(path, multisrc=True)[0])


def test_load_batch_matches_jax_and_counts(tmp_path):
    paths = [str(p) for p in _files(tmp_path)]
    ns = SimpleNamespace(pad_to=1000, num_workers=2)
    native.reset_counts()
    got = InferencePipeline._load_batch(ns, paths)
    assert native.COUNTS == {"decode_batch": 1}
    assert np.array_equal(got, JaxPipeline._load_batch(ns, paths))


def test_float64_files_fall_back_to_python(tmp_path):
    """JAX's parser takes a 64-bit float file and decodes zeros
    (jnative.decode); the port's parser rejects it, and read_audio and
    _load_batch read it with the Python reader."""
    x = _signal(1200, 2, 9)
    path = write_wave(tmp_path / "f64.wav", x, 3, 64)
    py = audio_io.to_mono(audio_io.read_wav(path)[0])
    assert np.abs(py).max() > 0.1
    assert not jnative.decode(path)[0].any()  # the reference's zeros
    with pytest.raises(ValueError):
        native.decode(path)
    got = audio_io.read_audio(path, pad_to=1000, test=True)[0]
    assert np.array_equal(got, py[:1000])
    paths = [str(path), str(_files(tmp_path)[0])]
    ns = SimpleNamespace(pad_to=1000, num_workers=2)
    native.reset_counts()
    rows = InferencePipeline._load_batch(ns, paths)
    assert native.COUNTS["decode_batch"] == 0  # the batch call raised, rows read per file
    assert np.array_equal(rows[0], py[:1000])
    assert np.array_equal(rows[1], audio_io.read_audio(paths[1], pad_to=1000, test=True)[0])


def test_not_a_wave_file_raises(tmp_path):
    path = tmp_path / "bad.wav"
    path.write_bytes(b"not a wave file at all" * 4)
    for fn in (native.decode, native.info):
        with pytest.raises(ValueError):
            fn(path)
    with pytest.raises(ValueError):
        native.decode_batch([path], 100)
    with pytest.raises(ValueError):
        audio_io.read_audio(path)


def test_no_compiler_means_no_loader(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available() and not native.available()
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "no g++" in err
    with pytest.raises(RuntimeError, match="unavailable"):
        native.decode(tmp_path / "x.wav")
    path = write_wave(tmp_path / "a.wav", _signal(500, 2, 1), 1, 16)
    got = audio_io.read_audio(path)[0]  # the Python reader
    assert np.array_equal(got, audio_io.to_mono(audio_io.read_wav(path)[0]))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wavio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native._build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ wavio.cpp failed"):
        native.available()
    assert not list((tmp_path / "build").iterdir())  # no half-built library left
