"""The port's Kaldi fbank (ops/kaldi.py) against desed_task_tpu/ops/kaldi.py
on the CPU, on seeded noise.

Tolerances: the log-mel within 1e-4 absolute in natural-log units (fp32 FFT
and mel sums in another order: the features are ~10-25 for int16-scaled
noise) at 99.9 % of the elements at least. The rest are the lowest mel
bins of some frames, where DC removal and pre-emphasis leave ~1e-3 of the
frame's energy and an fp32 FFT of either library errs by up to ~1e-3 in
log units (the port's and JAX's errors there differ in size, either way):
every element is held to a float64 computation of the same steps (numpy)
by the fp32 FFT's own conditioning, its mel energy within 1e-6 of the
frame's total mel energy (both sides measure ~1.5e-7). The window and
mel-bank arrays (float64 numpy on both sides) exactly; the normalised BEATs and AST features the same way, scaled by
1 / (2 std).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.ops import kaldi as jk
from desed_task_tpu_torch.ops import kaldi as tk

TOL_LOG = 1e-4
SHARE = 0.999  # of the elements within TOL_LOG of JAX


def _fbank64(x, window="povey", use_power=True, num_mel_bins=128, preemph=0.97, dc=True):
    """The same steps in float64 numpy."""
    x = np.asarray(x, np.float64)
    n = 1 + (x.shape[-1] - 400) // 160
    frames = x[..., np.arange(n)[:, None] * 160 + np.arange(400)[None, :]]
    if dc:
        frames = frames - frames.mean(-1, keepdims=True)
    if preemph:
        frames = frames - preemph * np.concatenate([frames[..., :1], frames[..., :-1]], -1)
    spec = np.fft.rfft(frames * tk.kaldi_window(400, window), n=512, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    if not use_power:
        power = np.sqrt(power)
    mel = power[..., :256] @ tk.kaldi_mel_banks(num_mel_bins, 512, 16000.0)
    return np.log(np.maximum(mel, np.finfo(np.float64).eps))


TOL_ENERGY = 1e-6  # of the frame's total mel energy, against float64


def _hold(got, want, ref, tol=TOL_LOG, scale=1.0, shift=0.0):
    """At least SHARE of the elements within tol of JAX, and every element's
    mel energy within TOL_ENERGY of its frame's total in float64. `scale`
    and `shift` undo a normalisation: log-mel = features * scale + shift."""
    assert got.shape == want.shape == ref.shape
    within = np.abs(got - want) <= tol
    assert within.mean() >= SHARE, (within.mean(), np.abs(got - want).max())
    energy = lambda a: np.exp(np.asarray(a, np.float64) * scale + shift)
    total = energy(ref).sum(-1, keepdims=True)
    err = (np.abs(energy(got) - energy(ref)) / total).max()
    assert err <= TOL_ENERGY, err


def _noise(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kind", ["povey", "hanning", "hamming"])
def test_windows_equal(kind):
    np.testing.assert_array_equal(tk.kaldi_window(400, kind), jk.kaldi_window(400, kind))


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="kaldi window"):
        tk.kaldi_window(400, "blackman")


@pytest.mark.parametrize("bins,fft,high", [(128, 512, 0.0), (64, 512, -400.0), (23, 1024, 6000.0)])
def test_mel_banks_equal(bins, fft, high):
    np.testing.assert_array_equal(tk.kaldi_mel_banks(bins, fft, 16000.0, high_freq=high),
                                  jk.kaldi_mel_banks(bins, fft, 16000.0, high_freq=high))


@pytest.mark.parametrize("window", ["povey", "hanning", "hamming"])
@pytest.mark.parametrize("use_power", [True, False])
def test_fbank_matches_jax(window, use_power):
    x = _noise((2, 16000)) * 2 ** 15
    got = tk.kaldi_fbank(torch.from_numpy(x), window_type=window, use_power=use_power).numpy()
    want = np.asarray(jk.kaldi_fbank(jnp.asarray(x), window_type=window, use_power=use_power))
    assert got.shape == (2, 1 + (16000 - 400) // 160, 128)
    _hold(got, want, _fbank64(x, window, use_power))


def test_fbank_one_dimensional_and_options():
    x = _noise(7000, seed=1) * 2 ** 15
    kw = dict(num_mel_bins=40, preemphasis_coefficient=0.0, remove_dc_offset=False)
    got = tk.kaldi_fbank(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jk.kaldi_fbank(jnp.asarray(x), **kw))
    assert got.shape == (1 + (7000 - 400) // 160, 40)
    _hold(got, want, _fbank64(x, num_mel_bins=40, preemph=0.0, dc=False))


def test_fbank_floors_silence_at_epsilon():
    got = tk.kaldi_fbank(torch.zeros(1, 4000)).numpy()
    np.testing.assert_allclose(got, np.log(np.finfo(np.float64).eps), rtol=1e-7)


def test_beats_preprocess_matches_jax():
    x = _noise((2, 32000), seed=2)
    got = tk.beats_preprocess(torch.from_numpy(x)).numpy()
    want = np.asarray(jk.beats_preprocess(jnp.asarray(x)))
    assert got.shape == (2, 198, 128)
    ref = (_fbank64(x * 2 ** 15) - 15.41663) / (2 * 6.55582)
    _hold(got, want, ref, TOL_LOG / (2 * 6.55582), 2 * 6.55582, 15.41663)


def _ast64(x, target):
    x = np.asarray(x, np.float64)
    fb = _fbank64(x - x.mean(-1, keepdims=True), "hanning")[:, :target]
    fb = np.pad(fb, ((0, 0), (0, target - fb.shape[1]), (0, 0)))
    return (fb + 4.2677393) / (2 * 4.5689974)


@pytest.mark.parametrize("n,target", [(16000, 128), (32000, 64)])  # pad / cut
def test_ast_preprocess_matches_jax(n, target):
    x = _noise((2, n), seed=3) + 0.05  # a DC offset, removed first
    got = tk.ast_preprocess(torch.from_numpy(x), target_length=target).numpy()
    want = np.asarray(jk.ast_preprocess(jnp.asarray(x), target_length=target))
    assert got.shape == (2, target, 128)
    _hold(got, want, _ast64(x, target), TOL_LOG / (2 * 4.5689974), 2 * 4.5689974, -4.2677393)


def test_ast_preprocess_pads_and_cuts_to_1024():
    x = _noise((1, 160000), seed=4)
    got = tk.ast_preprocess(torch.from_numpy(x)).numpy()
    want = np.asarray(jk.ast_preprocess(jnp.asarray(x)))
    assert got.shape == (1, 1024, 128)
    _hold(got, want, _ast64(x, 1024), TOL_LOG / (2 * 4.5689974), 2 * 4.5689974, -4.2677393)
    # 998 frames: the last 26 rows are the normalised zero padding
    np.testing.assert_allclose(got[0, 998:], 4.2677393 / (2 * 4.5689974), rtol=1e-7)
