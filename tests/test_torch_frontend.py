"""Port front-end and scaler against the JAX package on the same audio (CPU)."""

import dataclasses

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


def _log_mel_f64(audio, cfg):
    """The GEMM front-end's log-mel in float64 numpy, from the same fp32-rounded
    DFT basis and filterbank: only the arithmetic's rounding differs."""
    basis, fb = (c.double().numpy() for c in tfe._constants(cfg, torch.device("cpu"),
                                                             torch.float32))
    reim = tfe.frame_signal(torch.from_numpy(audio).double(), cfg).numpy() @ basis
    re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs :]
    mel = np.swapaxes(np.sqrt(re * re + im * im) @ fb, -1, -2)
    db = 20.0 * np.log10(np.maximum(mel, cfg.amin))
    return np.clip(db, cfg.db_clamp_min, cfg.db_clamp_max)


# Each side's log-mel against float64, in dB. An fp32 GEMM of depth K rounds
# a sum to about sqrt(K) u of the sum of its terms' magnitudes (u = 2^-24):
# 2.7e-6 relative at the DFT's depth 2048, and a mel band (a positive sum)
# keeps that, so 20 log10(1 + 2.7e-6) = 2.4e-5 dB. Measured alone: the port
# 1.0e-5 dB at 1 to 8 threads, JAX 2.1e-5 dB. The bound leaves 4x over that
# and fails anything coarser than fp32 (one TF32 rounding, 2^-11, is 4e-3 dB).
TOL_F64_DB = 1e-4


def _gemm_state():
    mm = getattr(getattr(torch.backends, "mkldnn", None), "matmul", None)
    return (f"matmul precision {torch.get_float32_matmul_precision()}, oneDNN fp32 "
            f"{getattr(mm, 'fp32_precision', 'n/a')}, {torch.get_num_threads()} threads")


def _cpu_state():
    """The CPU kernels' dispatch level and the OpenMP and MKL thread counts."""
    counts = [ln.strip() for ln in torch.__config__.parallel_info().splitlines()
              if "max_threads" in ln]
    return f"cpu capability {torch.backends.cpu.get_cpu_capability()}, " + ", ".join(counts)


def _stage_report(audio, cfg, t):
    """Each stage of the port's CPU log-mel (the `matmul` backend) against
    float64 of the same stage from the port's own fp32 input to it,
    recomputed at once in this process, the worst dB element of the port's
    result `t`, the CPU state, and whether a recompute still fails: a
    failure then names the stage and the state it came from."""
    x = torch.from_numpy(audio)
    basis, fb = tfe._constants(cfg, torch.device("cpu"), torch.float32)
    frames = tfe.frame_signal(x, cfg)
    frames64 = tfe.frame_signal(x.double(), cfg)
    with tfe.fp32_products(x.device):
        reim = torch.matmul(frames, basis)
    scale = frames64.abs() @ basis.double().abs()  # each output's sum of |terms|
    dft = ((reim.double() - frames64 @ basis.double()) / scale.clamp(min=1e-30)).abs().max()
    n = cfg.n_freqs
    re, im = reim[..., :n], reim[..., n:]
    mag = torch.sqrt(torch.clamp(re * re + im * im, min=0.0))
    re64, im64 = re.double(), im.double()
    mag64 = torch.sqrt(re64 * re64 + im64 * im64)
    mag_err = ((mag.double() - mag64) / mag64.clamp(min=1e-30)).abs().max()
    with tfe.fp32_products(x.device):
        mel = torch.matmul(mag, fb)
    mel64 = mag.double() @ fb.double()
    mel_err = ((mel.double() - mel64) / mel64.clamp(min=1e-30)).abs().max()
    db = tfe.amplitude_to_db(mel.transpose(-1, -2), cfg)
    db64 = tfe.amplitude_to_db(mel.double().transpose(-1, -2), cfg)
    db_err = (db.double() - db64).abs().max()
    want = _log_mel_f64(audio, cfg)
    diff = np.abs(t - want)
    worst = np.unravel_index(int(np.argmax(diff)), diff.shape)
    again = tfe.log_mel_spectrogram(x, cfg).numpy()
    err_again = float(np.abs(again - want).max())
    return (f"stages against float64 of the same stage: frames "
            f"{float((frames.double() - frames64).abs().max()):.3e}, DFT re/im "
            f"{float(dft):.3e} of the row's sum of |terms|, magnitude {float(mag_err):.3e}, "
            f"mel GEMM {float(mel_err):.3e} relative, dB {float(db_err):.3e} dB; worst "
            f"element {tuple(int(i) for i in worst)}: port {float(t[worst]):.6f}, float64 "
            f"{float(want[worst]):.6f} dB; recomputed now: {err_again:.3e} dB "
            f"({'still fails' if err_again > TOL_F64_DB else 'passes'}); {_cpu_state()}")


@pytest.mark.parametrize("kw", [{}, {"n_fft": 1024, "win_length": 1024, "n_mels": 64}])
def test_log_mel_matches_jax(kw):
    audio = _audio()
    want = _log_mel_f64(audio, tfe.MelConfig(**kw))
    j = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(audio), jfe.MelConfig(**kw)))
    t = tfe.log_mel_spectrogram(torch.from_numpy(audio), tfe.MelConfig(**kw)).numpy()
    assert t.shape == j.shape == want.shape
    err_t, err_j = float(np.abs(t - want).max()), float(np.abs(j - want).max())
    # each side's error, their gap and the CPU GEMM's settings, so that a
    # failure names its side (a float64 reference at fault moves both)
    state = (f"(port {err_t:.3e}, JAX {err_j:.3e}, gap {float(np.abs(t - j).max()):.3e} dB; "
             f"{_gemm_state()})")
    assert err_t <= TOL_F64_DB, (f"the port is {err_t:.3e} dB from float64 {state}; "
                                 f"{_stage_report(audio, tfe.MelConfig(**kw), t)}")
    assert err_j <= TOL_F64_DB, f"JAX is {err_j:.3e} dB from float64 {state}"
    # so the two sides are within both bounds of each other
    np.testing.assert_allclose(t, j, rtol=0, atol=2 * TOL_F64_DB)


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_log_mel_keeps_fp32_products_under_reduced_matmul_precision(precision):
    """With the process-wide fp32 matmul precision lowered (as a caller or
    an earlier test in the same process may leave it), the port's CPU
    log-mel still meets TOL_F64_DB: `frontend.fp32_products` pins its GEMMs
    to fp32 (unpinned, "medium" lets oneDNN round the operands to bf16,
    0.16 dB on a CPU with AVX512-BF16), and the setting is left as it was."""
    audio = _audio()
    cfg = tfe.MelConfig()
    want = _log_mel_f64(audio, cfg)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        t = tfe.log_mel_spectrogram(torch.from_numpy(audio), cfg).numpy()
        spec = tfe.spectrogram(torch.from_numpy(audio), cfg)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)
    err = float(np.abs(t - want).max())
    assert err <= TOL_F64_DB, f"the port is {err:.3e} dB from float64 ({_gemm_state()})"
    assert torch.equal(spec, tfe.spectrogram(torch.from_numpy(audio), cfg))


def test_filterbank_and_basis_match_jax():
    jc, tc = jfe.MelConfig(n_fft=1024, win_length=1024, n_mels=64), tfe.MelConfig(
        n_fft=1024, win_length=1024, n_mels=64)
    np.testing.assert_array_equal(tfe.mel_filterbank(tc), jfe.mel_filterbank(jc))
    for a, b in zip(tfe._dft_basis(tc), jfe._dft_basis(jc)):
        np.testing.assert_array_equal(a, b)
    frames_j = np.asarray(jfe.frame_signal(jnp.asarray(_audio(1)), jc))
    frames_t = tfe.frame_signal(torch.from_numpy(_audio(1)), tc).numpy()
    np.testing.assert_array_equal(frames_t, frames_j)


def test_mel_config_fields_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(tfe.MelConfig) == fields(jfe.MelConfig)


def _pair(audio, kw, backend):
    """(port, JAX) spectrogram and log-mel of the same audio."""
    jc, tc = jfe.MelConfig(**kw), tfe.MelConfig(**kw)
    x = torch.from_numpy(audio)
    return ((tfe.spectrogram(x, tc, backend).numpy(),
             np.asarray(jfe.spectrogram(jnp.asarray(audio), jc, backend))),
            (tfe.log_mel_spectrogram(x, tc, backend).numpy(),
             np.asarray(jfe.log_mel_spectrogram(jnp.asarray(audio), jc, backend))))


@pytest.mark.parametrize("power", [1.0, 2.0])
@pytest.mark.parametrize("window", ["hamming", "hann"])
@pytest.mark.parametrize("backend", ["fft", "chunked"])
def test_fft_and_chunked_backends_match_jax(backend, window, power):
    audio = _audio(5, n=15999)  # a length that is not a multiple of the hop
    (ts, js), (tl, jl) = _pair(audio, dict(window=window, power=power), backend)
    assert ts.shape == js.shape and tl.shape == jl.shape
    # fp32 sums in another order: spectra measured within 5.2e-7 of their
    # max, log-mel within 1.1e-5 dB
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-4)


@pytest.mark.parametrize("backend", ["matmul", "chunked"])
def test_bf16_backends_match_jax(backend):
    audio = _audio(6, n=15999)
    (ts, js), (tl, jl) = _pair(audio, dict(compute_dtype="bfloat16"), backend)
    # both round the DFT inputs to bf16 and sum exact products in fp32:
    # only the order differs (measured 7.6e-6 dB)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-4)
    # and bf16 is a different result from fp32
    assert np.abs(tl - tfe.log_mel_spectrogram(torch.from_numpy(audio),
                                               tfe.MelConfig()).numpy()).max() > 1e-3


@pytest.mark.parametrize("mel_scale,mel_norm", [("slaney", "slaney"), ("slaney", None),
                                                ("htk", "slaney")])
def test_slaney_filterbank_matches_jax(mel_scale, mel_norm):
    kw = dict(mel_scale=mel_scale, mel_norm=mel_norm, n_mels=64)
    np.testing.assert_array_equal(tfe.mel_filterbank(tfe.MelConfig(**kw)),
                                  jfe.mel_filterbank(jfe.MelConfig(**kw)))
    _, (tl, jl) = _pair(_audio(8), kw, None)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-4)


def test_backend_choice_and_refusals():
    audio = torch.from_numpy(_audio(9, b=1, n=8000))
    cfg = tfe.MelConfig(backend="fft")
    assert torch.equal(tfe.spectrogram(audio, cfg), tfe.spectrogram(audio, cfg, "fft"))
    with pytest.raises(ValueError, match="unknown backend"):
        tfe.spectrogram(audio, cfg, "dct")
    with pytest.raises(ValueError, match="hop"):
        tfe.spectrogram(audio, tfe.MelConfig(hop_length=300), "chunked")
    with pytest.raises(ValueError, match="win_length"):
        tfe.spectrogram(audio, tfe.MelConfig(win_length=1024), "chunked")


def test_default_config_is_the_fp32_gemm_path():
    """MelConfig() stays matmul / fp32 / htk: the serving and train features
    are the frames times the fp32 [cos | -sin] basis, bit for bit."""
    audio = torch.from_numpy(_audio(10))
    cfg = tfe.MelConfig()
    assert (cfg.backend, cfg.compute_dtype, cfg.mel_scale, cfg.mel_norm) == (
        "matmul", "float32", "htk", None)
    cos_b, sin_b = tfe._dft_basis(cfg)
    basis = torch.as_tensor(np.concatenate([cos_b, sin_b], 1), dtype=torch.float32)
    reim = torch.matmul(tfe.frame_signal(audio, cfg), basis)
    re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs :]
    want = torch.sqrt(torch.clamp(re * re + im * im, min=0.0)).transpose(-1, -2)
    assert torch.equal(tfe.spectrogram(audio, cfg), want)


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
