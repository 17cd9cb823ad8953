"""The port's fused log-mel (its plain version, on the CPU) against the JAX
Pallas kernel in interpret mode, on the same audio; the front end's
linear-mel kernel on the CPU: which inputs `mel_spectrogram` hands it, its
band table of the filterbank, and its epilogue emulated lane by lane against
the GEMM path."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from desed_task_tpu.ops.frontend import MelConfig as JMelConfig
from desed_task_tpu.ops.frontend import log_mel_spectrogram as jlog_mel
from desed_task_tpu.ops.pallas_mel import pallas_log_mel
from desed_task_tpu_torch.ops import frontend as tfe
from desed_task_tpu_torch.ops import fused_mel as fm
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


def _log_mel_f64(audio, cfg):
    """The plain version's chain in float64 numpy."""
    frames = np.asarray(tfe.center_pad(torch.from_numpy(audio).double(), cfg)
                        .unfold(-1, cfg.n_fft, cfg.hop_length))
    reim = frames @ np.concatenate(tfe._dft_basis(cfg), axis=1)
    n = cfg.n_freqs
    mel = np.sqrt(reim[..., :n] ** 2 + reim[..., n:] ** 2) @ tfe.mel_filterbank(cfg)
    db = 20.0 * np.log10(np.maximum(mel, cfg.amin))
    return np.clip(db, cfg.db_clamp_min, cfg.db_clamp_max).transpose(0, 2, 1)


@pytest.mark.parametrize("precision", ["medium", "high"])
def test_fused_log_mel_plain_keeps_fp32_products_under_reduced_matmul_precision(precision):
    """With the process-wide fp32 matmul precision lowered (as a caller or an
    earlier test in the same process may leave it), the plain version's two
    GEMMs stay fp32 (`frontend.fp32_products`): within TOL_FP32_DB of float64,
    and the setting is left as it was."""
    audio = _audio(5, 2, 16000)
    cfg = tfe.MelConfig()
    want = _log_mel_f64(audio, cfg)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        got = fused_log_mel_plain(torch.from_numpy(audio), cfg).numpy()
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FP32_DB)


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


@pytest.mark.parametrize("plan", [1, 3])
def test_kernel_constant_layouts(plan):
    """The basis and filterbank as the CUDA kernels read them (fused_mel.cu),
    element for element against frontend._constants."""
    cfg = tfe.MelConfig(n_fft=400, win_length=400, hop_length=160, n_mels=40,
                        compute_dtype="bfloat16" if plan == 3 else "float32")
    dev, dt = torch.device("cpu"), tfe.compute_dtype(cfg)
    basis, fb = tfe._constants(cfg, dev, dt)
    kb, kfb, bk, nf = fm._kernel_constants(cfg, dev, dt, plan)
    # f_min = 0: the DC row of the filterbank is all zero and is left out;
    # 200 frequencies are laid out, the last tile ragged
    assert not fb[0].any() and fb[1:].any(1).all() and nf == 200
    n_freqs = cfg.n_freqs
    kp = -(-cfg.n_fft // bk) * bk
    if plan == 1:  # [tile][k][cos | -sin][f], filterbank [f][m]
        tf = fm.TF
        flat = kb.permute(1, 2, 0, 3).reshape(kp, 2, -1)
        want_fb = torch.zeros(kfb.shape, dtype=dt)
        want_fb[:nf, : cfg.n_mels] = fb[1:]
        assert kfb.is_contiguous()
    else:  # ring items [tile][chunk][cos | -sin][f][k], then [tile][m][f]
        tf, n_chunks = fm.WG_TF, kp // bk
        assert kb.shape == (-(-nf // tf), n_chunks + 1, 2 * tf, bk) and bk == fm.WG_TK
        flat = kb[:, :n_chunks].reshape(-1, n_chunks, 2, tf, bk).permute(1, 4, 2, 0, 3).reshape(kp, 2, -1)
        want_fb = torch.zeros((kb.shape[0] * tf, fm.WG_MELS), dtype=dt)
        want_fb[:nf, : cfg.n_mels] = fb[1:]
        want_fb = want_fb.view(-1, tf, fm.WG_MELS).transpose(1, 2)
        assert torch.equal(kb[:, n_chunks], kfb)
    assert kb.is_contiguous() and kb.dtype == kfb.dtype == dt
    want = torch.zeros((kp, 2, flat.shape[2]), dtype=dt)
    want[: cfg.n_fft, 0, :nf] = basis[:, 1:n_freqs]
    want[: cfg.n_fft, 1, :nf] = basis[:, n_freqs + 1 :]
    assert torch.equal(flat, want)
    assert torch.equal(kfb, want_fb)


# ---------------------------------------------------------------------------
# fused_log_mel_wg_kernel (plan 3), emulated lane by lane on the CPU: the TMA
# ring's 128-byte swizzle, the wgmma descriptor reads, every lane's ldmatrix
# address into the span, the accumulator layout, the magnitudes' repack into
# A fragments, the epilogue's stores and the frame-tile schedule. A faulty
# index map fails here, before a chip call.
# ---------------------------------------------------------------------------

CU = Path(fm.__file__).resolve().parents[1] / "csrc" / "fused_mel.cu"


def test_wg_constants_match_the_source():
    src = CU.read_text()
    want = dict(WG_TT=fm.WG_TT, WG_TK=fm.WG_TK, WG_TF=fm.WG_TF, WG_MELS=fm.WG_MELS,
                WG_STAGES=fm.WG_STAGES, WG_SPLIT=fm.WG_SPLIT)
    want.update(WG_MAG_F=WG_MAG_F, WG_MAG_LD=WG_MAG_LD)  # the linear emulation's
    for name, value in want.items():
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == value, name
    assert "constexpr int WG_MS = WG_MELS + 4;" in src


WG_MS = fm.WG_MELS + 4  # row stride of the kernel's fp32 mel sums
# mel_linear_wg_kernel: frequencies a warp stages at once, and the row
# stride of its staged magnitudes
WG_MAG_F, WG_MAG_LD = 32, 20
SMEM_LIMIT = 232448  # 227 KB, the shared memory one H100 block may use


def _wg_smem(n_fft, hop):
    """fused_mel.cu WgLayout.bytes: ring, span, sums, barriers, alignment."""
    span_rows = fm.WG_TT - 1 + -(-(-(-n_fft // fm.WG_TK) * fm.WG_TK) // hop)
    span = span_rows * (hop + 8) * 2
    sums_off = -(-(fm.WG_STAGES * 16384 + span) // 16) * 16
    return sums_off + fm.WG_TT * WG_MS * 4 + 2 * fm.WG_STAGES * 8 + 1024


def test_wg_shared_memory():
    """The 2024 config and the card tests' plan-3 shapes fit one block; a hop
    of 512 at n_fft 2048 does not (128 frames' span, 135 KB, beside the ring
    and the sums), and goes to the CUDA-core kernel."""
    for n_fft, hop in [(2048, 256), (1024, 256), (1024, 200), (512, 128), (400, 160), (2048, 320)]:
        assert _wg_smem(n_fft, hop) <= SMEM_LIMIT, (n_fft, hop)
    assert _wg_smem(2048, 512) > SMEM_LIMIT


def _swz(off):
    """The 128-byte swizzle of a byte offset from a 1024-byte aligned base:
    bits 4-6 (the 16-byte chunk) xor bits 7-9 (the row in the 1024-byte atom)."""
    return off ^ (((off >> 7) & 7) << 4)


def _tma_stage(item):
    """A 16 KB ring stage as the TMA copy leaves it: the [128][64] item (one
    box of 128 rows of 128 bytes) at a 1024-byte aligned offset, swizzled.
    Returns the stage by 2-byte slot and how many times each slot was
    written."""
    stage, hits = np.full(8192, np.nan), np.zeros(8192, int)
    n, k = np.arange(128)[:, None], np.arange(fm.WG_TK)[None, :]
    slot = _swz(n * 128 + 2 * k) // 2
    stage[slot] = item[n, k]
    np.add.at(hits, slot.ravel(), 1)
    return stage, hits


def _desc(addr):
    """fused_mel.cu wg_desc: K-major, 128-byte swizzle, 1024 B between 8-row groups."""
    return ((addr & 0x3FFFF) >> 4) | (1 << 16) | ((1024 >> 4) << 32) | (1 << 62)


def _wgmma_b(stage, desc):
    """The [16 k][128 n] B operand that wgmma reads from the stage by `desc`
    (K-major rows of 128 bytes in 8-row groups SBO apart, swizzled)."""
    assert desc >> 62 == 1  # 128-byte swizzle
    start, sbo = (desc & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    k, n = np.arange(16)[:, None], np.arange(128)[None, :]
    return stage[_swz(start + (n // 8) * sbo + (n % 8) * 128 + 2 * k) // 2]


@pytest.mark.parametrize("stage_index", [0, 1, fm.WG_STAGES - 1])
def test_wg_swizzled_stage_matches_descriptor_reads(stage_index):
    """What the TMA copy writes is what the descriptor reads: each k16 step
    of the stage is the item's 16 samples, for all 128 rows; a stage's base
    is stage_index * 16 KB from the ring's 1024-byte aligned base (the
    swizzle only sees the offset within the 1024-byte atom)."""
    item = np.arange(128 * 64, dtype=np.float64).reshape(128, 64)
    stage, hits = _tma_stage(item)
    assert (hits == 1).all()  # the copy fills the stage
    off = np.arange(16384)
    assert (_swz(stage_index * 16384 + off) - stage_index * 16384 == _swz(off)).all()
    for kk in range(4):  # a k16 step is +32 bytes on the descriptor: + 2
        b = _wgmma_b(stage, _desc(0) + 2 * kk)
        np.testing.assert_array_equal(b, item[:, 16 * kk: 16 * kk + 16].T)


def _d_coords(lane, i, warp=np.arange(4)[:, None, None]):
    """(row, column) of register i of a lane of warp w in a wgmma m64nN fp32
    accumulator: rows 16w + lane/4 (+8), columns 8 (i/4) + 2 (lane%4) (+1)."""
    g, c = lane // 4, lane % 4
    return 16 * warp + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * c + (i & 1)


def _a_coords(lane, q, v):
    """(row, k) of half v of register q of a lane in the m16 x k16 A fragment
    (mma.sync's, and each warp's 16 rows of wgmma's A from registers)."""
    g, c = lane // 4, lane % 4
    return g + 8 * (q & 1), 2 * c + 8 * (q >> 1) + v


LANES, REGS = np.arange(32)[None, :, None], np.arange(64)[None, None, :]
LT, LQ, LV = np.arange(32)[:, None, None], np.arange(4)[None, :, None], np.arange(2)[None, None, :]


def test_wg_accumulator_map():
    """Each of the 64 x 128 accumulator entries of a warpgroup in one
    register of one thread; re[f] (column f) and im[f] (column 64 + f) in the
    same thread, registers i and i + 32."""
    row, col = _d_coords(LANES, REGS)
    row, col = np.broadcast_arrays(row, col)
    counts = np.zeros((64, 128), int)
    np.add.at(counts, (row.ravel(), col.ravel()), 1)
    assert (counts == 1).all()
    assert (row[..., :32] == row[..., 32:]).all() and (col[..., :32] + 64 == col[..., 32:]).all()
    assert (col[..., :32] < 64).all()


def _repack(mag_regs):
    """fused_mel.cu: k-step s's A fragment from the magnitude registers
    (i < 32): register 2h + p of a lane holds registers 4 (2s + h) + 2p and
    + 1. Returns [s][warp][lane][q][v]."""
    ma = np.empty((4,) + mag_regs.shape[:2] + (4, 2), mag_regs.dtype)
    for s in range(4):
        for h in range(2):
            for p in range(2):
                i = 4 * (2 * s + h) + 2 * p
                ma[s, :, :, 2 * h + p] = mag_regs[:, :, i: i + 2]
    return ma


def _a_matrix(frags):
    """[warp][lane][q][v] A fragments -> the [64][16] A operand of wgmma."""
    lane, q, v = np.arange(32)[:, None, None], np.arange(4)[None, :, None], np.arange(2)[None, None, :]
    r, k = _a_coords(lane, q, v)
    a = np.empty((64, 16), frags.dtype)
    for w in range(frags.shape[0]):
        a[16 * w + r, k] = frags[w]
    return a


def test_wg_repack_is_the_a_fragment():
    """The magnitudes of accumulator columns 16s..16s+15, repacked, are k-step
    s's A fragment: the mel wgmma multiplies mag[t][16s + j] by fb row j."""
    mags = np.arange(64 * 64, dtype=np.float64).reshape(64, 64)  # [frame][frequency]
    row, col = np.broadcast_arrays(*_d_coords(LANES, REGS[..., :32]))
    ma = _repack(mags[row, col])
    for s in range(4):
        np.testing.assert_array_equal(_a_matrix(ma[s]), mags[:, 16 * s: 16 * s + 16])


def _wg_units(B, T, n_tiles):
    """fused_mel.cu launch_wg and the kernel's block map: per block, (clip,
    first frame of the cluster's tile, rank, first and last + 1 frequency
    tile). Rank r writes frames 64r .. 64r + 63 of the tile."""
    n_tt = -(-T // fm.WG_TT)
    k = np.arange(fm.WG_SPLIT * B * n_tt)
    u, rank = k // fm.WG_SPLIT, k % fm.WG_SPLIT
    b = u // n_tt
    return (b, (u - b * n_tt) * fm.WG_TT, rank, n_tiles * rank // fm.WG_SPLIT,
            n_tiles * (rank + 1) // fm.WG_SPLIT)


@pytest.mark.parametrize("T", [1, 63, 626, 640])
@pytest.mark.parametrize("B", [1, 3, 60, 64])
def test_wg_schedule_covers_each_frame_once(B, T):
    """Each (clip, frame) is written by one block, and each frequency tile of
    a frame tile is summed by one block of its cluster (16 tiles at the 2024
    config, 7 at n_fft 400, and 1)."""
    for n_tiles in (16, 7, 1):
        b, t0, rank, lo, hi = _wg_units(B, T, n_tiles)
        t = t0[:, None] + 64 * rank[:, None] + np.arange(64)[None, :]
        keep = t < T  # log_db_out: t0 + 64 rank + t < T
        counts = np.zeros((B, T), int)
        np.add.at(counts, (np.broadcast_to(b[:, None], t.shape)[keep], t[keep]), 1)
        assert (counts == 1).all()
        tiles = np.zeros((len(b) // fm.WG_SPLIT, n_tiles), int)
        for k in range(len(b)):
            tiles[k // fm.WG_SPLIT, lo[k]: hi[k]] += 1
        assert (tiles == 1).all()


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _fma32(a, b, c):
    """fmaf in float32: the exact product plus c, rounded once (through
    float64, which holds the product exactly)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _emulate_wg(audio, cfg, lane_bits=(3, 4), linear=False, mag_bf16=False):
    """fused_log_mel_wg_kernel, block by block, in numpy: the span staging,
    each lane's ldmatrix address (the incremental kq/ke walk), the ring items
    of the block's frequency tiles through _tma_stage and _wgmma_b, the DFT
    and mel products on the operands that the lane maps build, the
    magnitudes in registers i and i + 32, the repack, each thread's adds into
    the sums (its srow address), the cluster's sum of its two blocks' sums
    by frame half, and log_db_out. `lane_bits` names the two bits of the
    lane id as the kernel's A addresses read them (a mutation test swaps
    them).

    linear: mel_linear_wg_kernel's epilogue instead (`_linear_tile`): the
    fp32 magnitudes staged and walked through the band table, the running
    sums stored once a mel, the same cross-cluster sum, then the linear mel
    [B, n_mels, T]. mag_bf16 rounds its magnitudes to bf16 (a mutation)."""
    x = tfe.center_pad(torch.from_numpy(audio), cfg).numpy()
    B, n_pad = x.shape
    T, hop = cfg.num_frames(audio.shape[1]), cfg.hop_length
    items, _, bk, nf = fm._kernel_constants(cfg, torch.device("cpu"), torch.bfloat16, 3)
    items = items.float().numpy()
    n_tiles, n_chunks = items.shape[0], items.shape[1] - 1
    bops = [[[_wgmma_b(_tma_stage(items[tl, ch])[0], _desc(0) + 2 * kk)
              for kk in range(4)] for ch in range(n_chunks + 1)] for tl in range(n_tiles)]
    span_ld = hop + 8
    span_rows = fm.WG_TT - 1 + -(-(-(-cfg.n_fft // bk) * bk) // hop)
    lane = np.arange(32)
    b3, b4 = lane_bits
    lid = (lane & ~((1 << 3) | (1 << 4))) | (((lane >> b3) & 1) << 3) | (((lane >> b4) & 1) << 4)
    rows = (np.arange(8)[:, None] * 16 + (lid & 15)[None, :])  # [warp][lane]: frame row
    koff = (lid >> 4) * 8
    bs, t0s, ranks, los, his = _wg_units(B, T, n_tiles)
    out = np.full((B, cfg.n_mels, T), np.nan, np.float32)
    shift = 20.0 * np.log10(max(cfg.amin, 1.0))
    i = np.arange(span_rows * hop)
    # each thread's sums: srow = row (16 wi + g) * WG_MS + 2c; register 4j + 2h + v
    # at srow + 8h * WG_MS + 8j + v
    wgi, wi, ln, reg = (np.arange(2)[:, None, None, None], np.arange(4)[None, :, None, None],
                        np.arange(32)[None, None, :, None], np.arange(64)[None, None, None, :])
    j, h, v = reg >> 2, (reg >> 1) & 1, reg & 1
    sidx = ((64 * wgi + 16 * wi + ln // 4) * WG_MS + 2 * (ln % 4)) + 8 * h * WG_MS + 8 * j + v
    row, col = np.broadcast_arrays(*_d_coords(LANES, REGS))
    band = fm._laid_out_band(cfg).numpy() if linear else None
    sums = {}
    for k in range(len(bs)):  # block k: rank ranks[k] of the cluster on tile k // WG_SPLIT
        b, t0 = bs[k], t0s[k]
        walk = _LinearWalk() if linear else None
        gi = t0 * hop + i
        span = np.zeros(span_rows * span_ld, np.float32)
        span[(i // hop) * span_ld + i % hop] = _bf16(np.where(gi < n_pad, x[b, np.minimum(gi, n_pad - 1)], 0))
        s = np.zeros(fm.WG_TT * WG_MS, np.float32)
        for tl in range(los[k], his[k]):
            kq, ke = koff // hop, koff - (koff // hop) * hop  # each lane's walk
            kq, ke = np.broadcast_to(kq, (8, 32)).copy(), np.broadcast_to(ke, (8, 32)).copy()
            d = np.zeros((2, 64, 128), np.float32)
            for ch in range(n_chunks):
                for kk in range(4):
                    addr = (rows + kq) * span_ld + ke  # element index each lane supplies
                    mats = span[addr[:, :, None] + np.arange(8)]  # [warp][lane][8]: the rows
                    # ldmatrix.x4: matrix q from the rows lanes 8q..8q+7 supply;
                    # lane t gets row t/4, elements 2 (t%4), +1 of it as register q
                    frag = mats[:, 8 * LQ + LT // 4, 2 * (LT % 4) + LV]  # [warp][lane][q][v]
                    for wg in range(2):
                        d[wg] += _a_matrix(frag[4 * wg: 4 * wg + 4]) @ bops[tl][ch][kk]
                    ke = ke + 16
                    while (ke >= hop).any():
                        kq, ke = np.where(ke >= hop, kq + 1, kq), np.where(ke >= hop, ke - hop, ke)
            acc = d[:, row, col]  # [warpgroup][warp][lane][register]
            re, im = acc[..., :32], acc[..., 32:]
            if linear:
                walk.tile(re * re + im * im, band[tl * fm.WG_TF: (tl + 1) * fm.WG_TF], s, mag_bf16)
                continue
            mag = _bf16(np.sqrt(re * re + im * im))
            tile = np.empty_like(acc)
            for wg in range(2):
                ma = _repack(mag[wg])
                tile[wg] = sum(_a_matrix(ma[q]) @ bops[tl][n_chunks][q] for q in range(4))[row, col]
            np.add.at(s, sidx, tile)
        if linear:
            walk.flush(s)
        sums[k] = s.reshape(fm.WG_TT, WG_MS)
    for k in range(len(bs)):  # frames 64 r .. of the tile: block 0's sums + block 1's
        r, c0 = ranks[k], k - ranks[k]
        total = (sums[c0] + sums[c0 + 1])[64 * r: 64 * r + 64]
        t0 = t0s[k] + 64 * r
        n = min(64, T - t0)
        if n <= 0:
            continue
        if linear:  # mel_out: the linear mel, no log
            out[bs[k], :, t0: t0 + n] = total[:n, : cfg.n_mels].T
            continue
        vals = np.maximum(total[:n, : cfg.n_mels], cfg.amin)
        out[bs[k], :, t0: t0 + n] = (20.0 * (np.log(vals) * np.float32(fm.LOG10E)) - shift).T
    return out


class _LinearWalk:
    """mel_linear_wg_kernel's epilogue for one block, in numpy: per tile the
    fp32 magnitudes (registers i < 32 of each thread), staged half a tile at
    a time into each warp's rows by the kernel's store address (each slot
    written once), then each lane (frame l % 16, mel parity l // 16) walking
    the 32 staged frequencies through the band table in order: its running
    sum an fmaf chain, stored into the block's sums (row WG_MS) when its mel
    changes, and at the block's end (`flush`)."""

    def __init__(self):
        shape = (2, 4, 32)  # [warpgroup][warp][lane]
        self.cur = np.full(shape, -1)
        self.run = np.zeros(shape, np.float32)
        lane = np.arange(32)
        self.mt, self.mp = lane & 15, lane >> 4
        wg, wi = np.arange(2)[:, None, None], np.arange(4)[None, :, None]
        self.srow = (64 * wg + 16 * wi + self.mt) * WG_MS  # this lane's row of the sums
        # the kernel's staging store: thread (g, c) puts register 4 (4hh + jj) + 2h + v
        # at row 8jj + 2c + v, column g + 8h of its warp's [WG_MAG_F][WG_MAG_LD] rows
        ln, reg = np.arange(32)[:, None], np.arange(16)[None, :]
        jj, h, v = reg >> 2, (reg >> 1) & 1, reg & 1
        self.slot = (8 * jj + 2 * (ln % 4) + v) * WG_MAG_LD + ln // 4 + 8 * h

    def _store(self, s, where):
        idx = (self.srow + self.cur)[where]
        assert (self.cur[where] >= 0).all()
        s[idx] = self.run[where]

    def tile(self, mag2, band, s, mag_bf16):
        mag = np.sqrt(mag2.astype(np.float32))  # [wg][warp][lane][32]: re^2 + im^2 in fp32
        if mag_bf16:
            mag = _bf16(mag)
        for hh in range(2):
            staged = np.full((2, 4, WG_MAG_F * WG_MAG_LD), np.nan, np.float32)
            hits = np.zeros(WG_MAG_F * WG_MAG_LD, int)
            np.add.at(hits, self.slot.ravel(), 1)
            assert hits.max() == 1 and (hits[:WG_MAG_F * WG_MAG_LD].reshape(
                WG_MAG_F, WG_MAG_LD)[:, :16] == 1).all()
            staged[:, :, self.slot] = mag[:, :, :, 16 * hh: 16 * hh + 16]
            for kk in range(WG_MAG_F):
                w0, w1, bits, _ = band[WG_MAG_F * hh + kk]
                m0 = int(np.float32(bits).view(np.int32))
                odd = (m0 ^ self.mp) & 1
                mel = np.broadcast_to(m0 + odd, self.cur.shape)
                change = mel != self.cur
                self._store(s, change & (self.cur >= 0))
                self.run = np.where(change, np.float32(0), self.run)
                self.cur = mel.copy()
                m = staged[:, :, kk * WG_MAG_LD + self.mt]
                self.run = _fma32(m, np.where(odd == 1, w1, w0).astype(np.float32), self.run)

    def flush(self, s):
        self._store(s, self.cur >= 0)


WG_CASES = {  # (config, B, N): one tile of the 2024 config; n_fft 400 / hop 160 at
    # 2 x 2 ragged tiles (251 frames), kq/ke walks that wrap mid-step
    "2024": (dict(), 1, 16000),
    "nfft400": (dict(n_fft=400, win_length=400, hop_length=160, n_mels=40), 2, 40000),
    "nfft1024": (dict(n_fft=1024, win_length=1024, n_mels=64), 3, 8000),
}


@pytest.mark.parametrize("case", sorted(WG_CASES))
def test_wg_emulation_matches_plain(case):
    kw, B, N = WG_CASES[case]
    cfg = tfe.MelConfig(**kw, compute_dtype="bfloat16")
    audio = _audio(B + 40, B, N)
    got = _emulate_wg(audio, cfg)
    want = fused_log_mel_plain(torch.from_numpy(audio), cfg).numpy()
    assert not np.isnan(got).any()
    err = np.abs(got - want)
    # the same roundings; only the fp32 sums' order differs, which can flip a
    # magnitude's bf16 rounding (TOL_BF16_DB) but leaves almost every band
    assert err.max() <= TOL_BF16_DB and np.median(err) < 1e-4


def test_wg_emulation_fails_a_swapped_lane_bit():
    kw, B, N = WG_CASES["nfft400"]
    cfg = tfe.MelConfig(**kw, compute_dtype="bfloat16")
    audio = _audio(41, 1, 16000)
    want = fused_log_mel_plain(torch.from_numpy(audio), cfg).numpy()
    got = _emulate_wg(audio, cfg, lane_bits=(4, 3))
    assert np.abs(got - want).max() > 1.0


# ---------------------------------------------------------------------------
# The front end's linear-mel kernel (mel_linear_wg_kernel): which inputs
# mel_spectrogram hands it, the band table, the epilogue emulated
# ---------------------------------------------------------------------------

# the emulated linear mel against the GEMM path: fp32 sums in another order
TOL_LINEAR_REL = 1e-5

RECIPE_BF16 = tfe.MelConfig(compute_dtype="bfloat16")  # the 2023 and 2024 recipes' front end
CUDA = torch.device("cuda")  # a device can be named without a card


def _panns_mel():
    from desed_task_tpu_torch.models.panns import PANNS_MEL

    return PANNS_MEL


DISPATCH = {  # name: (config, backend, device, ndim, requires_grad, takes the kernel)
    "recipe_bf16": (RECIPE_BF16, None, CUDA, 2, False, True),
    "recipe_bf16_one_clip": (RECIPE_BF16, None, CUDA, 1, False, True),
    "recipe_bf16_matmul_named": (RECIPE_BF16, "matmul", CUDA, 2, False, True),
    "slaney_bf16": (tfe.MelConfig(compute_dtype="bfloat16", mel_scale="slaney",
                                  mel_norm="slaney"), None, CUDA, 2, False, True),
    "fp32": (tfe.MelConfig(), None, CUDA, 2, False, False),
    "panns": (None, None, CUDA, 2, False, False),
    "center_false": (tfe.MelConfig(compute_dtype="bfloat16", center=False), None, CUDA, 2,
                     False, False),
    "constant_pad": (tfe.MelConfig(compute_dtype="bfloat16", pad_mode="constant"), None, CUDA, 2,
                     False, False),
    "fft": (RECIPE_BF16, "fft", CUDA, 2, False, False),
    "chunked": (RECIPE_BF16, "chunked", CUDA, 2, False, False),
    "cpu": (RECIPE_BF16, None, torch.device("cpu"), 2, False, False),
    "hop_300": (tfe.MelConfig(compute_dtype="bfloat16", hop_length=300), None, CUDA, 2, False,
                False),
    "mels_160": (tfe.MelConfig(compute_dtype="bfloat16", n_mels=160), None, CUDA, 2, False, False),
    "hop_512_smem": (tfe.MelConfig(compute_dtype="bfloat16", hop_length=512), None, CUDA, 2,
                     False, False),
    "three_dims": (RECIPE_BF16, None, CUDA, 3, False, False),
    "needs_grad": (RECIPE_BF16, None, CUDA, 2, True, False),
}


# the shapes fused_mel.cu's plan refuses (hop % 8, more than 128 mels, a span
# beyond shared memory); tests/test_torch_kernels_cuda.py holds the plan
# itself to them on the card
SHAPE_REFUSED = {"hop_300", "mels_160", "hop_512_smem"}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_linear_mel_dispatch(name, monkeypatch):
    """The predicate with the C shape plan stood in for (it needs the built
    library): it asks the plan for the config's shapes, and takes its no."""
    cfg, backend, device, ndim, grad, takes = DISPATCH[name]
    cfg = cfg or _panns_mel()
    asked = []

    def plan(n_fft, hop, n_mels):
        asked.append((n_fft, hop, n_mels))
        return name not in SHAPE_REFUSED

    fm.linear_mel_plan.cache_clear()
    monkeypatch.setattr(fm, "_shape_plan", plan)
    try:
        assert fm.linear_mel_takes(device, cfg, backend, ndim, grad) is takes
    finally:
        fm.linear_mel_plan.cache_clear()
    if takes or name in SHAPE_REFUSED:
        assert asked == [(cfg.n_fft, cfg.hop_length, cfg.n_mels)]


@pytest.fixture
def three_filter_bank(monkeypatch):
    """frontend.mel_filterbank with one frequency in three filters, the
    caches of what is built from it cleared before and after."""
    real = tfe.mel_filterbank

    def bank(cfg):
        fb = real(cfg)
        f = int(np.flatnonzero(fb[:, 10])[0])
        fb[f] = 0.0
        fb[f, 10:13] = 0.5
        return fb

    def clear():
        for fn in (tfe._constants, fm._laid_out_band, fm.linear_mel_plan):
            fn.cache_clear()

    clear()
    monkeypatch.setattr(tfe, "mel_filterbank", bank)
    monkeypatch.setattr(fm, "mel_filterbank", bank)
    yield
    monkeypatch.undo()
    clear()


def test_linear_mel_dispatch_refuses_a_frequency_in_three_filters(three_filter_bank):
    fb = tfe._constants(RECIPE_BF16, torch.device("cpu"), torch.float32)[1]
    assert int(fb.ne(0).sum(1).max()) == 3
    assert fm.band_table(fb) is None
    assert not fm.linear_mel_takes(CUDA, RECIPE_BF16)


def _bank(n_freqs, n_mels, rows):
    fb = torch.zeros((n_freqs, n_mels))
    for f, m, w in rows:
        fb[f, m] = w
    return fb


@pytest.mark.parametrize("name", ["recipe_bf16", "slaney_bf16", "panns", "nfft400"])
def test_band_table_holds_the_fp32_filterbank(name):
    """Expanded, the band table is the fp32 filterbank exactly; m0 ascends and
    m0 + 1 names a mel."""
    cfg = (DISPATCH[name][0] if name in DISPATCH else
           tfe.MelConfig(n_fft=400, win_length=400, hop_length=160, n_mels=40)) or _panns_mel()
    fb = tfe._constants(cfg, torch.device("cpu"), torch.float32)[1]
    table = fm.band_table(fb)
    assert table is not None and table.shape == (cfg.n_freqs, 4) and table.dtype == torch.float32
    m0 = table[:, 2].contiguous().view(torch.int32)
    assert bool((m0[1:] >= m0[:-1]).all()) and int(m0.min()) >= 0
    assert int(m0.max()) + 1 < cfg.n_mels and not table[:, 3].any()
    assert torch.equal(fm.band_dense(table, cfg.n_mels), fb)


def test_band_table_of_the_laid_out_frequencies():
    """The kernel's table: the fp32 rows of the frequencies plan 3 lays out
    (the first to the last nonzero row: the DC row left out), padded with
    zero weights to whole tiles, the last m0 kept."""
    fb = tfe._constants(RECIPE_BF16, torch.device("cpu"), torch.float32)[1]
    band = fm._laid_out_band(RECIPE_BF16)
    n = RECIPE_BF16.n_freqs - 1
    assert band.shape == (-(-n // fm.WG_TF) * fm.WG_TF, 4)
    assert torch.equal(fm.band_dense(band[:n], RECIPE_BF16.n_mels), fb[1:])
    assert not band[n:, :2].any() and torch.equal(band[n:, 2], band[n - 1:n, 2].expand(len(band) - n))


@pytest.mark.parametrize("name,rows", [
    ("three filters", [(0, 0, 1.0), (0, 1, 0.5), (0, 2, 0.5)]),
    ("two apart", [(0, 0, 1.0), (0, 2, 0.5)]),
    ("descending", [(0, 3, 1.0), (0, 4, 1.0), (1, 0, 1.0), (1, 1, 1.0)]),
])
def test_band_table_refuses_what_is_not_banded(name, rows):
    assert fm.band_table(_bank(4, 6, rows)) is None
    assert fm.band_table(torch.ones((4, 1))) is None  # one mel


def test_band_table_pairs_a_lone_filter_with_a_neighbour():
    """Rows with one nonzero: paired with the mel below where m0 then still
    ascends, else with the one above; empty rows keep the last m0."""
    fb = _bank(5, 4, [(0, 0, 0.25), (1, 0, 0.5), (1, 1, 0.5), (2, 1, 1.0), (4, 3, 0.75)])
    table = fm.band_table(fb)
    assert table[:, 2].contiguous().view(torch.int32).tolist() == [0, 0, 0, 0, 2]
    assert torch.equal(fm.band_dense(table, 4), fb)


@pytest.mark.parametrize("name", ["recipe_bf16", "fp32", "panns"])
def test_mel_spectrogram_on_the_cpu_is_the_gemm_path(name):
    """On the CPU every config keeps the GEMM path, bitwise, and counts no
    launch."""
    from desed_task_tpu_torch.ops import _build

    cfg = DISPATCH[name][0] or _panns_mel()
    audio = torch.from_numpy(_audio(50, 2, 16000))
    before = dict(_build.LAUNCHES)
    got = tfe.mel_spectrogram(audio, cfg)
    assert torch.equal(got, tfe.gemm_mel_spectrogram(audio, cfg))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("case", sorted(WG_CASES))
def test_mel_linear_plain_matches_the_gemm_path(case):
    """The op's plain version, from the ring items and the band table, is the
    GEMM path's linear mel up to the order of its fp32 sums."""
    kw, B, N = WG_CASES[case]
    cfg = tfe.MelConfig(**kw, compute_dtype="bfloat16")
    audio = torch.from_numpy(_audio(B + 60, B, N))
    items, band = fm._linear_constants(cfg, torch.device("cpu"))
    got = fm.mel_linear_plain(tfe.center_pad(audio, cfg), items, band, cfg.num_frames(N),
                              cfg.n_fft, cfg.hop_length, cfg.n_mels).transpose(1, 2)
    want = tfe.mel_spectrogram(audio, cfg)
    assert _linear_gap(got.numpy(), want.numpy()) <= TOL_LINEAR_REL


def _linear_gap(got, want):
    """The worst clip's max |got - want| over its max |want|."""
    return float((np.abs(got - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))).max())


@pytest.mark.parametrize("case", sorted(WG_CASES))
def test_wg_linear_emulation_matches_the_gemm_path(case):
    """mel_linear_wg_kernel emulated lane by lane (the shared mainloop, then
    its epilogue) against mel_spectrogram's GEMM path on the CPU: within
    fp32 reordering."""
    kw, B, N = WG_CASES[case]
    cfg = tfe.MelConfig(**kw, compute_dtype="bfloat16")
    assert fm._laid_out_band(cfg) is not None
    audio = _audio(B + 40, B, N)
    got = _emulate_wg(audio, cfg, linear=True)
    want = tfe.mel_spectrogram(torch.from_numpy(audio), cfg).numpy()
    assert not np.isnan(got).any()
    assert _linear_gap(got, want) <= TOL_LINEAR_REL


def test_wg_linear_emulation_fails_bf16_magnitudes():
    """Row 7b's rounding of the magnitudes to bf16, in the linear epilogue,
    lies outside the bound: the test tells the two apart."""
    kw, B, N = WG_CASES["nfft400"]
    cfg = tfe.MelConfig(**kw, compute_dtype="bfloat16")
    audio = _audio(B + 40, B, N)
    want = tfe.mel_spectrogram(torch.from_numpy(audio), cfg).numpy()
    assert _linear_gap(_emulate_wg(audio, cfg, linear=True, mag_bf16=True), want) > 10 * TOL_LINEAR_REL
