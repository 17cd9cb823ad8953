"""The port's resampler against desed_task_tpu.data.audio_io on seeded
signals (within 1e-6): `resample` at 44.1 -> 16 kHz and 22.05 -> 16 kHz,
`read_audio(target_fs=)`, the MixIT segment pool on a 44.1 kHz folder, and
the resample_folder entry point."""

import numpy as np
import pytest

from desed_task_tpu.data.audio_io import read_audio as jax_read_audio
from desed_task_tpu.data.audio_io import resample as jax_resample
from desed_task_tpu.training.separation_pretrain import _SegmentPool as JaxPool
from desed_task_tpu_torch.data.audio_io import read_audio, read_wav, resample, write_wav
from desed_task_tpu_torch.recipes import resample_folder as cli
from desed_task_tpu_torch.training.separation_pretrain import _SegmentPool

TOL = 1e-6
RATES = [44100, 22050]


@pytest.mark.parametrize("orig", RATES)
@pytest.mark.parametrize("shape", [(8820,), (2, 4410)])
def test_resample_matches_jax(orig, shape):
    x = (np.random.default_rng(orig).standard_normal(shape) * 0.3).astype(np.float32)
    ours, theirs = resample(x, orig, 16000), jax_resample(x, orig, 16000)
    assert ours.dtype == np.float32 and ours.shape == theirs.shape
    assert ours.shape[-1] == -(-shape[-1] * 16000 // orig)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)


def test_resample_same_rate_is_identity():
    x = np.arange(10, dtype=np.float64)
    out = resample(x, 16000, 16000)
    assert out.dtype == np.float32 and np.array_equal(out, x.astype(np.float32))


@pytest.mark.parametrize("orig", RATES)
@pytest.mark.parametrize("pad_to", [None, 16000])
def test_read_audio_target_fs_matches_jax(tmp_path, orig, pad_to):
    x = (np.random.default_rng(1).standard_normal((2, orig // 2)) * 0.2).astype(np.float32)
    path = tmp_path / "stereo.wav"
    write_wav(path, x, orig)
    ours = read_audio(path, target_fs=16000, pad_to=pad_to, test=True)
    theirs = jax_read_audio(path, target_fs=16000, pad_to=pad_to, test=True)
    assert ours[0].shape == theirs[0].shape == ((8000,) if pad_to is None else (16000,))
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0, atol=TOL)
    assert ours[1:] == theirs[1:]


def _folder(root, rate, n=3):
    rng = np.random.default_rng(rate)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        secs = 0.5 + 0.4 * i
        write_wav(root / f"c{i}.wav",
                  (rng.standard_normal(int(rate * secs)) * 0.2).astype(np.float32), rate)
    return root


def test_segment_pool_on_a_44k_folder_matches_jax(tmp_path):
    folder = _folder(tmp_path / "wavs44", 44100)
    ours, theirs = _SegmentPool([folder], 12000), JaxPool([folder], 12000)
    assert len(ours.clips) == len(theirs.clips) == 3
    for a, b in zip(ours.clips, theirs.clips):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    sa = ours.sample(5, np.random.default_rng(4))
    sb = theirs.sample(5, np.random.default_rng(4))
    np.testing.assert_allclose(sa, sb, rtol=0, atol=TOL)


def test_resample_folder_cli(tmp_path):
    src = _folder(tmp_path / "in", 44100)
    out = tmp_path / "out"
    n = cli.main(["--in_dir", str(src), "--out_dir", str(out)], workers=2)
    assert n == 3
    for w in sorted(src.glob("*.wav")):
        audio, fs = read_wav(out / w.name)
        ref = jax_resample(read_wav(w)[0], 44100, 16000)
        assert fs == 16000 and audio.shape == ref.shape
        # the output is PCM16: one quantization step
        np.testing.assert_allclose(audio, ref, rtol=0, atol=1.0 / 32768)
    # the folder is done: a second run writes nothing
    assert cli.main(["--in_dir", str(src), "--out_dir", str(out)], workers=2) == 0
