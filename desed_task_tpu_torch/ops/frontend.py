"""Log-mel front-end (counterpart of desed_task_tpu/ops/frontend.py).

    waveform [B, N] -> frames -> windowed DFT (power=1) -> mel -> dB -> clamp

The reference numerics are those of the JAX module: n_fft = win_length =
2048, hop 256, a symmetric hamming window, center=True with reflect padding,
128 HTK mels over [0, 8000] Hz with no filterbank norm, then
20*log10(max(x, 1e-5)) clamped to [-50, 80]. `mel_scale="slaney"` with
`mel_norm="slaney"` gives librosa's filterbank instead (the PANNs front-end).

Three backends, chosen by `MelConfig.backend` or the `backend` argument, as
in the JAX module (frontend.py:267-360):
  * "matmul": the DFT is one GEMM of the frames with the windowed
    [cos | -sin] basis, then the magnitude and the mel GEMM (the default).
  * "fft":    torch.fft.rfft of the windowed frames.
  * "chunked": hop-sized chunk DFTs shared by the overlapping frames, the
    periodic window applied as a 3-tap frequency-domain stencil.
The JAX package runs all of them outside any Pallas kernel, so here they are
plain torch ops (`gemm_mel_spectrogram` for the linear mel). With
`compute_dtype="bfloat16"` the DFT products take bf16-rounded inputs and sum
in fp32, like JAX's `preferred_element_type=float32`: written as fp32
products of rounded values, since a bf16 matmul on the CPU rounds its output
too. The default is fp32 throughout: a caller on the card keeps
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default), which
`InferencePipeline` sets.

On the card, "matmul" in bf16 with power 1, center and reflect padding (the
recipes' front end) runs as one hand-written kernel instead: `mel_spectrogram`
hands every input that `fused_mel.linear_mel_takes` accepts to
`fused_mel.linear_mel`, which frames, runs the DFT on the tensor cores and
takes the same fp32 magnitude and fp32 mel product (only the order of the
fp32 sums differs). The CPU, fp32, power 2 (the PANNs front end), "fft" and
"chunked" keep the torch ops. Launches count as "mel_spectrogram.fused" and,
for the GEMM path on a CUDA tensor, "mel_spectrogram.gemm".

Filterbank and basis constants are built on the host in float64 numpy and
cast once per (config, device, dtype).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..obs.profiling import span
from . import _build


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Front-end configuration (defaults = DCASE Task 4 baseline feats)."""

    sample_rate: int = 16000
    n_fft: int = 2048
    win_length: int = 2048
    hop_length: int = 256
    f_min: float = 0.0
    f_max: float = 8000.0
    n_mels: int = 128
    power: float = 1.0
    window: str = "hamming"  # "hamming" | "hann"
    periodic_window: bool = False  # reference uses periodic=False (symmetric)
    center: bool = True
    pad_mode: str = "reflect"
    mel_scale: str = "htk"  # "htk" (torchaudio default) | "slaney" (librosa)
    mel_norm: str | None = None  # None | "slaney" (area normalization)
    amin: float = 1e-5
    db_clamp_min: float | None = -50.0
    db_clamp_max: float | None = 80.0
    backend: str = "matmul"  # "matmul" | "fft" | "chunked"
    compute_dtype: str = "float32"  # "float32" | "bfloat16" (DFT inputs)

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        if self.center:
            n_samples = n_samples + 2 * (self.n_fft // 2)
        return 1 + (n_samples - self.n_fft) // self.hop_length


def compute_dtype(cfg: MelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def make_window(kind: str, win_length: int, periodic: bool) -> np.ndarray:
    """Window identical to torch.{hamming,hann}_window(periodic=...)."""
    n = win_length if periodic else win_length - 1
    t = np.arange(win_length, dtype=np.float64)
    if kind == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * math.pi * t / n)
    if kind == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * math.pi * t / n)
    raise ValueError(f"unknown window {kind!r}")


def _hz_to_mel_htk(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _hz_to_mel_slaney(f) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # log(0) in the branch np.where drops
        log_part = min_log_mel + np.log(f / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_part, f / (200.0 / 3.0))


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * (200.0 / 3.0))


def mel_filterbank(cfg: MelConfig) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels].

    mel_scale="htk", norm=None matches torchaudio.functional.melscale_fbanks
    defaults; mel_scale="slaney" with norm="slaney" matches
    librosa.filters.mel defaults.
    """
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_freqs)
    if cfg.mel_scale == "htk":
        hz2mel, mel2hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif cfg.mel_scale == "slaney":
        hz2mel, mel2hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel_scale {cfg.mel_scale!r}")
    m_pts = np.linspace(hz2mel(cfg.f_min), hz2mel(cfg.f_max), cfg.n_mels + 2)
    f_pts = mel2hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if cfg.mel_norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:] - f_pts[:-2]))[None, :]
    return fb


def center_pad(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] -> [B, N + 2 * (n_fft // 2)], torch.stft's center padding."""
    p = cfg.n_fft // 2
    return F.pad(audio[:, None, :], (p, p), mode=cfg.pad_mode)[:, 0]


def frame_signal(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """[B, N] -> [B, n_frames, n_fft] with torch.stft center/reflect padding."""
    if cfg.center:
        audio = center_pad(audio, cfg)
    return audio.unfold(-1, cfg.n_fft, cfg.hop_length)


def _dft_basis(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis matrices [n_fft, n_freqs] (cos, -sin)."""
    k = np.arange(cfg.n_freqs, dtype=np.float64)
    t = np.arange(cfg.n_fft, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(t, k) / cfg.n_fft
    w = make_window(cfg.window, cfg.win_length, cfg.periodic_window)
    if cfg.win_length < cfg.n_fft:  # torch center-pads the window
        lpad = (cfg.n_fft - cfg.win_length) // 2
        w = np.pad(w, (lpad, cfg.n_fft - cfg.win_length - lpad))
    return np.cos(ang) * w[:, None], -np.sin(ang) * w[:, None]


@functools.lru_cache(maxsize=16)
def _constants(cfg: MelConfig, device: torch.device, dtype: torch.dtype):
    """(basis [n_fft, 2 * n_freqs] = [cos | -sin], filterbank [n_freqs, n_mels]),
    both rounded to `dtype`, on `device`."""
    cos_b, sin_b = _dft_basis(cfg)
    basis = torch.as_tensor(np.concatenate([cos_b, sin_b], axis=1), dtype=torch.float32,
                            device=device).to(dtype)
    fb = torch.as_tensor(mel_filterbank(cfg), dtype=torch.float32, device=device).to(dtype)
    return basis, fb


def _window_stencil(kind: str) -> tuple[float, float]:
    """(a0, a1) of the generalized-cosine window w[n] = a0 - a1 cos(2pi n/N)."""
    if kind == "hamming":
        return 0.54, 0.46
    if kind == "hann":
        return 0.5, 0.5
    raise ValueError(f"no frequency-domain stencil for window {kind!r}")


@functools.lru_cache(maxsize=16)
def _chunk_constants(cfg: MelConfig, device: torch.device, dtype: torch.dtype):
    """(chunk DFT basis [hop, 2 * n_freqs] = [cos | -sin] on the 1/n_fft grid,
    rounded to `dtype`; twiddles w_re, w_im [n_fft // hop, n_freqs] fp32)."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    k = np.arange(cfg.n_freqs, dtype=np.float64)
    ang = 2.0 * math.pi * np.outer(np.arange(hop, dtype=np.float64), k) / n_fft
    basis = torch.as_tensor(np.concatenate([np.cos(ang), -np.sin(ang)], axis=1),
                            dtype=torch.float32, device=device).to(dtype)
    jk = 2.0 * math.pi * np.outer(np.arange(n_fft // hop), k) * hop / n_fft
    w_re = torch.as_tensor(np.cos(jk), dtype=torch.float32, device=device)
    w_im = torch.as_tensor(-np.sin(jk), dtype=torch.float32, device=device)
    return basis, w_re, w_im


def _chunk_dft_spectrogram(audio: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Power spectrum via hop-sized chunk DFTs (frontend.py:201-264).

    (1) one unwindowed DFT of each hop-length chunk on the 1/n_fft grid;
    (2) each frame's spectrum is the twiddled sum of its n_fft/hop chunk
    spectra; (3) the PERIODIC generalized-cosine window applied exactly as a
    3-tap frequency-domain stencil, using conjugate symmetry at the k=0 and
    Nyquist edges. For periodic_window=False this substitutes the periodic
    window (at most ~1.4e-3 relative for n_fft=2048), as the JAX module does.
    """
    if cfg.n_fft % cfg.hop_length != 0:
        raise ValueError("chunked backend needs hop | n_fft")
    if cfg.win_length != cfg.n_fft:
        raise ValueError("chunked backend needs win_length == n_fft")
    a0, a1 = _window_stencil(cfg.window)
    hop, n_fft, n_freqs = cfg.hop_length, cfg.n_fft, cfg.n_freqs
    if cfg.center:
        audio = center_pad(audio, cfg)
    n = audio.shape[-1]
    n_frames = 1 + (n - n_fft) // hop
    n_chunks = n // hop
    chunks = audio[:, : n_chunks * hop].reshape(-1, n_chunks, hop)
    cdt = compute_dtype(cfg)
    basis, w_re, w_im = _chunk_constants(cfg, audio.device, cdt)
    c = torch.matmul(chunks.to(cdt).float(), basis.float())
    c_re, c_im = c[..., :n_freqs], c[..., n_freqs:]

    x_re = torch.zeros((chunks.shape[0], n_frames, n_freqs), device=audio.device)
    x_im = torch.zeros_like(x_re)
    for j in range(n_fft // hop):
        cr = c_re[:, j : j + n_frames]
        ci = c_im[:, j : j + n_frames]
        x_re = x_re + w_re[j] * cr - w_im[j] * ci
        x_im = x_im + w_re[j] * ci + w_im[j] * cr

    # Xw(k) = a0 X(k) - a1/2 [X(k-1) + X(k+1)],
    # X(-1) = conj(X(1)), X(n_freqs) = conj(X(n_freqs - 2))
    m1_re = torch.cat([x_re[..., 1:2], x_re[..., :-1]], -1)
    m1_im = torch.cat([-x_im[..., 1:2], x_im[..., :-1]], -1)
    p1_re = torch.cat([x_re[..., 1:], x_re[..., -2:-1]], -1)
    p1_im = torch.cat([x_im[..., 1:], -x_im[..., -2:-1]], -1)
    xw_re = a0 * x_re - 0.5 * a1 * (m1_re + p1_re)
    xw_im = a0 * x_im - 0.5 * a1 * (m1_im + p1_im)
    return xw_re * xw_re + xw_im * xw_im


@contextlib.contextmanager
def fp32_products(device: torch.device):
    """Full fp32 GEMMs on the CPU whatever the process-wide setting says:
    after torch.set_float32_matmul_precision("medium") oneDNN rounds fp32
    GEMM operands to bf16 on a CPU with AVX512-BF16 (0.16 dB of log-mel),
    and "high" allows TF32. The front-end's products are fp32, as JAX's on
    the CPU are; the setting is restored on exit. On the card the caller
    keeps TF32 off (module docstring)."""
    mm = getattr(torch.backends.mkldnn, "matmul", None)
    prev = getattr(mm, "fp32_precision", None)
    if device.type != "cpu" or prev in (None, "ieee"):
        yield
        return
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = prev


@functools.lru_cache(maxsize=1)
def settle_cpu_vector_math() -> None:
    """Make the process's first calls of torch's CPU sqrt, log and log10 on
    one thread. On the CPU these go through MKL's vector math library, whose
    first call in a process, made by several OpenMP threads at once on a
    large tensor, has computed some threads' shares of the elements to about
    12 bits (up to 3.2e-4 relative: 1.6e-3 dB of log-mel, eight times the CPU
    parity tests' bound) in a few percent of processes started together;
    later calls are exact (scripts/probe_cpu_vector_math.py). A call on a
    one-element tensor runs on the calling thread alone."""
    for dt in (torch.float32, torch.float64):
        x = torch.ones(1, dtype=dt)
        torch.sqrt(x), torch.log(x), torch.log10(x)


def spectrogram(audio: torch.Tensor, cfg: MelConfig, backend: str | None = None) -> torch.Tensor:
    """Magnitude (power=1) or power spectrogram: [B, N] -> [B, n_freqs, n_frames]."""
    if audio.device.type == "cpu":
        settle_cpu_vector_math()
    with fp32_products(audio.device):
        return _spectrogram(audio, cfg, backend)


def _spectrogram(audio: torch.Tensor, cfg: MelConfig, backend: str | None) -> torch.Tensor:
    backend = backend or cfg.backend
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    audio = audio.float()
    if backend == "chunked":
        mag2 = _chunk_dft_spectrogram(audio, cfg)
    else:
        frames = frame_signal(audio, cfg)  # [B, T, n_fft]
        if backend == "fft":
            w = torch.as_tensor(make_window(cfg.window, cfg.win_length, cfg.periodic_window),
                                dtype=torch.float32, device=audio.device)
            spec = torch.fft.rfft(frames * w, n=cfg.n_fft, dim=-1)
            mag2 = spec.real ** 2 + spec.imag ** 2
        elif backend == "matmul":
            cdt = compute_dtype(cfg)
            basis, _ = _constants(cfg, audio.device, cdt)
            reim = torch.matmul(frames.to(cdt).float(), basis.float())  # [B, T, 2 * n_freqs]
            re, im = reim[..., : cfg.n_freqs], reim[..., cfg.n_freqs :]
            mag2 = re * re + im * im
        else:
            raise ValueError(f"unknown backend {backend!r}")
    if cfg.power == 1.0:
        out = torch.sqrt(torch.clamp(mag2, min=0.0))
    elif cfg.power == 2.0:
        out = mag2
    else:
        out = torch.clamp(mag2, min=0.0) ** (cfg.power / 2.0)
    out = out.transpose(-1, -2)
    return out[0] if squeeze else out


def mel_spectrogram(audio: torch.Tensor, cfg: MelConfig,
                    backend: str | None = None) -> torch.Tensor:
    """[B, N] -> mel spectrogram [B, n_mels, n_frames] (power=cfg.power): in
    the fused kernel where `fused_mel.linear_mel_takes` accepts the input
    (module docstring), else by `gemm_mel_spectrogram`."""
    from . import fused_mel  # which imports this module

    with span("frontend.mel"):
        if fused_mel.linear_mel_takes(audio.device, cfg, backend, audio.dim(),
                                      audio.requires_grad):
            return fused_mel.linear_mel(audio, cfg)
        if audio.device.type == "cuda":
            _build.count_launch("mel_spectrogram.gemm")
        return gemm_mel_spectrogram(audio, cfg, backend)


def gemm_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig,
                         backend: str | None = None) -> torch.Tensor:
    """[B, N] -> mel spectrogram [B, n_mels, n_frames] by torch ops: the
    spectrogram of `backend`, then the mel product, fp32 in either compute
    dtype (frontend.py:327)."""
    spec = spectrogram(audio, cfg, backend)  # [..., n_freqs, T]
    _, fb = _constants(cfg, audio.device, torch.float32)
    with fp32_products(audio.device):
        return torch.matmul(spec.transpose(-1, -2), fb).transpose(-1, -2)


def amplitude_to_db(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """torchaudio AmplitudeToDB(stype='amplitude', amin=1e-5) + clamp [-50, 80]."""
    if mel.device.type == "cpu":
        settle_cpu_vector_math()
    with span("frontend.db"):
        multiplier = 10.0 if cfg.power == 2.0 else 20.0
        db = multiplier * torch.log10(torch.clamp(mel, min=cfg.amin))
        db = db - multiplier * math.log10(max(cfg.amin, 1.0))
        if cfg.db_clamp_min is not None or cfg.db_clamp_max is not None:
            db = torch.clamp(db, cfg.db_clamp_min, cfg.db_clamp_max)
        return db


def log_mel_spectrogram(audio: torch.Tensor, cfg: MelConfig,
                        backend: str | None = None) -> torch.Tensor:
    """Waveform [B, N] -> log-mel dB [B, n_mels, n_frames]."""
    return amplitude_to_db(mel_spectrogram(audio, cfg, backend), cfg)
