"""Port front-end and scaler against the JAX package on the same audio (CPU, fp32)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.ops import frontend as jfe
from desed_task_tpu.ops import scaler as jsc
from desed_task_tpu_torch.ops import frontend as tfe
from desed_task_tpu_torch.ops import scaler as tsc


def _audio(seed=0, b=2, n=16000):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"n_fft": 1024, "win_length": 1024, "n_mels": 64}])
def test_log_mel_matches_jax(kw):
    audio = _audio()
    j = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(audio), jfe.MelConfig(**kw)))
    t = tfe.log_mel_spectrogram(torch.from_numpy(audio), tfe.MelConfig(**kw)).numpy()
    assert t.shape == j.shape
    # dB of fp32 DFT/mel GEMMs summed in another order (measured 2.2e-5 dB)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_filterbank_and_basis_match_jax():
    jc, tc = jfe.MelConfig(n_fft=1024, win_length=1024, n_mels=64), tfe.MelConfig(
        n_fft=1024, win_length=1024, n_mels=64)
    np.testing.assert_array_equal(tfe.mel_filterbank(tc), jfe.mel_filterbank(jc))
    for a, b in zip(tfe._dft_basis(tc), jfe._dft_basis(jc)):
        np.testing.assert_array_equal(a, b)
    frames_j = np.asarray(jfe.frame_signal(jnp.asarray(_audio(1)), jc))
    frames_t = tfe.frame_signal(torch.from_numpy(_audio(1)), tc).numpy()
    np.testing.assert_array_equal(frames_t, frames_j)


@pytest.mark.parametrize("normtype", ["minmax", "mean", "standard"])
def test_instance_scaler_matches_jax(normtype):
    r = np.random.default_rng(3)
    x = r.standard_normal((3, 16, 20)).astype(np.float32) * 10
    x[2] = 0.0  # a zero-padded clip: minmax gives -1, not NaN
    jc, tc = jsc.ScalerConfig(normtype=normtype), tsc.ScalerConfig(normtype=normtype)
    j = np.asarray(jsc.apply_scaler(jnp.asarray(x), jc))
    t = tsc.apply_scaler(torch.from_numpy(x), tc).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("normtype", ["mean", "standard"])
def test_dataset_scaler_matches_jax(normtype):
    r = np.random.default_rng(4)
    batches = [r.standard_normal((2, 8, 10)).astype(np.float32) + i for i in range(3)]
    jc = jsc.ScalerConfig(statistic="dataset", normtype=normtype, dims=(0, 2))
    tc = tsc.ScalerConfig(statistic="dataset", normtype=normtype, dims=(0, 2))
    jstate = jsc.fit_scaler(jc, batches)
    tstate = tsc.fit_scaler(tc, batches)
    np.testing.assert_allclose(tstate.mean.numpy(), np.asarray(jstate.mean), rtol=1e-6)
    x = batches[1]
    j = np.asarray(jsc.apply_scaler(jnp.asarray(x), jc, jstate))
    t = tsc.apply_scaler(torch.from_numpy(x), tc, tstate).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
