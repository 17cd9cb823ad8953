"""The port's fused log-mel (its plain version, on the CPU) against the JAX
Pallas kernel in interpret mode, on the same audio."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.ops.frontend import MelConfig as JMelConfig
from desed_task_tpu.ops.frontend import log_mel_spectrogram as jlog_mel
from desed_task_tpu.ops.pallas_mel import pallas_log_mel
from desed_task_tpu_torch.ops import frontend as tfe
from desed_task_tpu_torch.ops.fused_mel import fused_log_mel, fused_log_mel_plain

# fp32: the same products summed in another order (measured 1.3e-5 dB).
TOL_FP32_DB = 2e-4
# bf16: both round the magnitudes to bf16 after fp32 sums taken in another
# order, so a magnitude near a rounding boundary can land one bf16 step
# (at most 2^-7 relative) away; a mel band is a weighted sum of magnitudes,
# so it moves by at most 2^-7 relative: 20 log10(1 + 2^-7) = 0.068 dB
# (measured up to 0.021 dB over six seeds).
TOL_BF16_DB = 0.07

CONFIGS = {"2024": {}, "nfft1024": dict(n_fft=1024, win_length=1024, n_mels=64)}


def _audio(seed, b, n):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("B", [1, 3])
def test_fused_log_mel_matches_pallas(config, dtype, B):
    kw = dict(CONFIGS[config], compute_dtype=dtype)
    audio = _audio(B, B, 16000)  # 63 frames: not a multiple of the TPU's tile of 64
    want = np.asarray(pallas_log_mel(jnp.asarray(audio), JMelConfig(**kw), interpret=True))
    got = fused_log_mel(torch.from_numpy(audio), tfe.MelConfig(**kw))
    assert got.shape == want.shape == (B, kw.get("n_mels", 128), tfe.MelConfig(**kw).num_frames(16000))
    assert got.is_contiguous()
    tol = TOL_FP32_DB if dtype == "float32" else TOL_BF16_DB
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_fused_log_mel_matches_gemm_front_end_in_fp32():
    audio = torch.from_numpy(_audio(7, 2, 23456))
    cfg = tfe.MelConfig()
    np.testing.assert_allclose(fused_log_mel(audio, cfg).numpy(),
                               tfe.log_mel_spectrogram(audio, cfg).numpy(),
                               rtol=0, atol=TOL_FP32_DB)


def test_reference_gaps_the_port_logs():
    """The two behaviours of the JAX kernel that ROADMAP.md section 3 logs.
    With center=False it still pads by n_fft//2 (pallas_mel.py:63-64), so it
    is many dB away from the GEMM front-end, which is why the port refuses
    center=False; in bf16 it rounds magnitudes and filterbank where the GEMM
    front-end does not, a gap inside the 0.07 dB bound, which the port keeps
    on each side."""
    audio = _audio(11, 3, 16000)
    gaps = {}
    for name, kw in (("center=False", dict(center=False)), ("bf16", dict(compute_dtype="bfloat16"))):
        cfg = JMelConfig(**kw)
        gemm = np.asarray(jlog_mel(jnp.asarray(audio), cfg, backend="matmul"))
        gaps[name] = np.abs(np.asarray(pallas_log_mel(jnp.asarray(audio), cfg, interpret=True))
                            - gemm).max()
    print(f"JAX pallas_log_mel against log_mel_spectrogram: {gaps}")
    assert gaps["center=False"] > 1.0
    assert 1e-3 < gaps["bf16"] < TOL_BF16_DB
    # the port keeps the same two results apart in bf16
    t = torch.from_numpy(audio)
    cfg = tfe.MelConfig(compute_dtype="bfloat16")
    port_gap = float((fused_log_mel(t, cfg) - tfe.log_mel_spectrogram(t, cfg)).abs().max())
    assert 1e-3 < port_gap < TOL_BF16_DB


def test_fused_log_mel_refuses_what_the_kernel_does_not_compute():
    audio = torch.zeros(1, 4000)
    with pytest.raises(ValueError, match="power=1"):
        fused_log_mel(audio, tfe.MelConfig(power=2.0))
    with pytest.raises(ValueError, match="center=True"):
        fused_log_mel(audio, tfe.MelConfig(center=False))
    with pytest.raises(ValueError, match="center=True"):
        fused_log_mel_plain(audio, tfe.MelConfig(center=False))


@pytest.mark.parametrize("plan", [1, 2])
def test_kernel_constant_layouts(plan):
    """The basis and filterbank as the CUDA kernels read them (fused_mel.cu),
    element for element against frontend._constants."""
    from desed_task_tpu_torch.ops import fused_mel

    cfg = tfe.MelConfig(n_fft=400, win_length=400, hop_length=160, n_mels=40,
                        compute_dtype="bfloat16" if plan == 2 else "float32")
    dev, dt = torch.device("cpu"), tfe.compute_dtype(cfg)
    basis, fb = tfe._constants(cfg, dev, dt)
    kb, kfb, bk, nf = fused_mel._kernel_constants(cfg, dev, dt, plan)
    # f_min = 0: the DC row of the filterbank is all zero and is left out;
    # 200 frequencies are laid out, two tiles, the last ragged
    assert not fb[0].any() and fb[1:].any(1).all() and nf == 200
    tf, n_freqs = fused_mel.TF, cfg.n_freqs
    kp = -(-cfg.n_fft // bk) * bk
    if plan == 1:  # [tile][k][cos | -sin][f], filterbank [f][m]
        flat = kb.permute(1, 2, 0, 3).reshape(kp, 2, -1)
        want_fb = torch.zeros(kfb.shape, dtype=dt)
        want_fb[:nf, : cfg.n_mels] = fb[1:]
    else:  # [tile][k slice][cos | -sin][f][k], filterbank [tile][m][f]
        flat = kb.permute(1, 4, 2, 0, 3).reshape(kp, 2, -1)
        want_fb = torch.zeros((kfb.shape[0] * tf, fused_mel.TC_MELS), dtype=dt)
        want_fb[:nf, : cfg.n_mels] = fb[1:]
        want_fb = want_fb.view(-1, tf, fused_mel.TC_MELS).transpose(1, 2)
    assert kb.is_contiguous() and kfb.is_contiguous() and kb.dtype == kfb.dtype == dt
    want = torch.zeros((kp, 2, flat.shape[2]), dtype=dt)
    want[: cfg.n_fft, 0, :nf] = basis[:, 1:n_freqs]
    want[: cfg.n_fft, 1, :nf] = basis[:, n_freqs + 1 :]
    assert torch.equal(flat, want)
    assert torch.equal(kfb, want_fb)
