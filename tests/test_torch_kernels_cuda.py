"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (sm_90a) and skip elsewhere:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

They cover the edges the 2024 shapes in chip_smoke.py do not: ragged tiles
(rows, channels and batch not multiples of the tile), pools of 3, dropout
bits, and bad inputs; for the BiGRU the 2024 shapes, H=128, ragged unit
slices (H=100), B=1, the stream path (H=350, 512) and bitwise reruns; for
the backward kernels also B=1 and B=60, Ci=1, pool remainders in T and F, bitwise
repeatability and the autograd path of the fused block; for the forward
kernels Co > 128 and bitwise reruns, and a CNN with a 256-channel block
in eval and train mode (the GLU backward's wide kernel: Co = 192, 200 and
256, and F * Co lane sums kept in device memory); the bf16 modes of the
forward kernels at edge shapes (Ci = 1, 3, 5, 12 and 24, Co not a multiple
of 8 or 16, Co = 256, F * Co not a multiple of 8, T and F not multiples of
the row tile, pools (1, 1), (2, 2), (1, 2) and others, dropout bits; the
bf16 GLU's two kernels at GLU_BF16_ODD_GEOMS) and a bf16 CRNN forward; the bf16 modes of the backward kernels at edge shapes
(BF16_BWD_GEOMS; the GLU backward's tensor-core kernel also at
BWD_FRAG_GEOMS) and the bf16 block's autograd path; for the fused
log-mel B=1, 2, 3 and 64, 1-s to 10-s clips, n_fft 400 to 2048, 40 to 160
mels, hops that do not divide n_fft, ragged frame tiles, both compute dtypes,
the plan each shape takes (the wgmma kernel in bf16 wherever it fits) and
bitwise reruns; the eval path's cache loop on a narrow CRNN (launches per
batch and pass, fp32 and bf16, scores equal to the host-dataset branch's).
"""

import numpy as np
import pytest
import torch

from desed_task_tpu_torch.ops import fused_cnn, fused_mel, gru
from desed_task_tpu_torch.ops.frontend import MelConfig

pytestmark = pytest.mark.cuda

TOL = 1e-4  # relative to max(1, max |plain|): fp32 sums in another order
# bf16 outputs (y, z): one bf16 step of the plain value, 2^-7 |plain|, above
# a floor for fp32 sums in another order where they cancel, 1e-5 of the
# largest |plain|; at most 1 % of the elements differ at all
BF16_STEP, BF16_FLOOR, BF16_FRAC = 2.0 ** -7, 1e-5, 0.01


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    err = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
    assert err <= TOL, err


def _close_bf16(a, b):
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
    a, b = a.float(), b.float()
    d = (a - b).abs()
    lim = BF16_STEP * b.abs() + BF16_FLOOR * float(b.abs().max())
    assert bool((d <= lim).all()), float((d - lim).max())
    assert float((a != b).float().mean()) <= BF16_FRAC


def _close_bf16_sum(a, b):
    """A per-channel bf16 sum (dbias, dbg: Co entries) against its plain
    version: as _close_bf16, except that one element may differ where that
    is more than BF16_FRAC of them (an fp32 total in another order can round
    the other way)."""
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
    a, b = a.float(), b.float()
    lim = BF16_STEP * b.abs() + BF16_FLOOR * float(b.abs().max())
    assert bool(((a - b).abs() <= lim).all())
    assert int((a != b).sum()) <= max(BF16_FRAC * a.numel(), 1)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


GEOMS = [  # (B, T, F, Ci, Co, pool)
    (3, 13, 16, 1, 8, (2, 2)),
    (5, 9, 6, 24, 40, (3, 2)),
    (2, 7, 5, 128, 128, (1, 2)),
    (1, 1, 1, 3, 70, (1, 1)),
    (2, 11, 4, 64, 200, (2, 4)),
    # wider than 128 channels (two channel tiles), Ci=1 with Co > 128
    (2, 9, 8, 256, 256, (1, 2)),
    (4, 12, 10, 1, 130, (1, 1)),
]


@pytest.mark.parametrize("geom", GEOMS)
def test_conv_bn_stats_kernel(dev, geom):
    B, T, F, Ci, Co, _ = geom
    g = torch.Generator().manual_seed(0)
    x = _rand(g, B, T, F, Ci).to(dev)
    w = _rand(g, 3, 3, Ci, Co, scale=1 / np.sqrt(9 * Ci)).to(dev)
    b = _rand(g, Co, scale=0.1).to(dev)
    got = fused_cnn.conv_bn_stats(x, w, b)
    for a, want in zip(got, fused_cnn.conv_bn_stats_plain(x, w, b)):
        _close(a, want)
    assert all(torch.equal(a, c) for a, c in zip(got, fused_cnn.conv_bn_stats(x, w, b)))


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("keep", [None, 1.0, 0.5, 0.9])
def test_glu_drop_pool_kernel(dev, geom, keep):
    B, T, F, _, Co, pool = geom
    g = torch.Generator().manual_seed(1)
    y = _rand(g, B, T, F, Co).to(dev)
    sf = (1 + _rand(g, F * Co, scale=0.1)).to(dev)
    bf = _rand(g, F * Co, scale=0.1).to(dev)
    wg = _rand(g, Co, Co, scale=1 / np.sqrt(Co)).to(dev)
    bg = _rand(g, Co, scale=0.1).to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    z = fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool, keep_prob=kp)
    _close(z, fused_cnn.glu_drop_pool_plain(y, sf, bf, wg, bg, bits, pool=pool, keep_prob=kp))
    assert torch.equal(z, fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool,
                                                  keep_prob=kp))


# (B, T, H): the 2024 serving and train batches, the 2023 width, ragged unit
# slices (H=100), B=1, tiny H, and the stream path (H=350, 512)
GRU_SHAPES = [(1, 5, 8), (9, 17, 192), (3, 4, 350), (64, 156, 192), (60, 156, 192),
              (4, 20, 128), (5, 11, 100), (1, 9, 192), (2, 6, 512)]


def _gru_args(g, B, T, H, dev):
    s = 1 / np.sqrt(H)
    args = [_rand(g, B, T, 3 * H, scale=0.5), _rand(g, B, T, 3 * H, scale=0.5),
            _rand(g, 3 * H, H, scale=s), _rand(g, 3 * H, scale=s),
            _rand(g, 3 * H, H, scale=s), _rand(g, 3 * H, scale=s)]
    return [a.to(dev) for a in args]


@pytest.mark.parametrize("B,T,H", GRU_SHAPES)
def test_bigru_kernel(dev, B, T, H):
    g = torch.Generator().manual_seed(2)
    args = _gru_args(g, B, T, H, dev)
    got = gru.bigru(*args)
    for a, b in zip(got, gru.bigru_plain(*args)):
        _close(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got, gru.bigru(*args)))


def test_bigru_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    g = torch.Generator().manual_seed(12)
    for H in (192, 512):  # cluster and stream
        args = _gru_args(g, 2, 3, H, dev)
        with pytest.raises(TypeError):
            gru.bigru(*[a.double() for a in args])
        with pytest.raises(ValueError):
            gru.bigru(args[0], args[1][:, :, :-3], *args[2:])
        with pytest.raises(ValueError):
            gru.bigru(*args[:2], args[2][:, :-1], *args[3:])
        with pytest.raises((ValueError, RuntimeError)):
            gru.bigru(*args[:2], args[2].cpu(), *args[3:])
        fwd, bwd = gru.bigru(*args)
        with pytest.raises(ValueError):
            gru.bigru_bwd(*args, fwd, bwd, fwd[:, :-1], bwd)
        with pytest.raises(TypeError):
            gru.bigru_bwd(*[a.double() for a in args], fwd.double(), bwd.double(),
                          fwd.double(), bwd.double())


def test_fused_glu_block_train_mode(dev):
    B, T, F, Ci, Co = 4, 10, 8, 16, 32
    g = torch.Generator().manual_seed(3)
    args = [_rand(g, B, T, F, Ci), _rand(g, 3, 3, Ci, Co, scale=0.1), _rand(g, Co),
            1 + _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1),
            1 + _rand(g, Co, scale=0.1).abs(), _rand(g, Co, Co, scale=0.2), _rand(g, Co)]
    bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8)
    kw = dict(pool=(2, 2), train=True, dropout_rate=0.5)
    want = fused_cnn.fused_glu_block(*args, bits=bits, **kw)  # CPU: plain versions
    got = fused_cnn.fused_glu_block(*[a.to(dev) for a in args], bits=bits.to(dev), **kw)
    for a, b in zip(got, want):
        _close(a.cpu(), b)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev)
    w = torch.zeros(3, 3, 2, 8, device=dev)
    with pytest.raises(TypeError):
        fused_cnn.conv_bn_stats(x.double(), w.double(), torch.zeros(8, device=dev).double())
    with pytest.raises(ValueError):
        fused_cnn.conv_bn_stats(x, w[:, :, :1], torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        fused_cnn.conv_bn_stats(x.transpose(1, 2), w, torch.zeros(8, device=dev))


def test_crnn_kernel_forward_matches_plain(dev):
    from desed_task_tpu_torch.models.crnn import CRNN, init_weights

    net = dict(nclass=5, n_RNN_cell=16, n_layers_RNN=2, kernel_size=[3, 3, 3],
               padding=[1, 1, 1], stride=[1, 1, 1], nb_filters=[8, 16, 32],
               pooling=[[2, 2], [2, 2], [1, 2]], n_mels=32)
    g = torch.Generator().manual_seed(4)
    fused = init_weights(CRNN(**net), g).to(dev).eval()
    plain = CRNN(**net, fused_blocks=False, rnn_kernel=False).to(dev).eval()
    plain.load_state_dict(fused.state_dict())
    x = _rand(g, 3, 32, 40).to(dev)
    with torch.no_grad():
        for a, b in zip(fused(x), plain(x)):
            _close(a, b)


@pytest.mark.parametrize("train", [False, True])
def test_wide_cnn_runs_on_the_card(dev, train):
    """A 2-block CNN with a 256-channel block: both blocks take the fused
    kernels, in train mode with a backward too (the GLU backward's wide
    kernel), and outputs, running statistics and gradients match the
    unfused CNN."""
    from desed_task_tpu_torch.models.cnn import CNN
    from desed_task_tpu_torch.ops import _build

    net = dict(n_in_channel=1, activation="glu", conv_dropout=0.5 if train else 0.0,
               kernel_size=(3, 3), padding=(1, 1), stride=(1, 1), nb_filters=(16, 256),
               pooling=((2, 2), (1, 2)))
    g = torch.Generator().manual_seed(11)
    fused, plain = CNN(**net).to(dev), CNN(**net, fused_blocks=False).to(dev)
    with torch.no_grad():
        for p in fused.parameters():
            p.copy_(_rand(g, *p.shape, scale=0.2))
        fused.batchnorm0.weight.add_(1.0)
        fused.batchnorm1.weight.add_(1.0)
    plain.load_state_dict(fused.state_dict())
    x = _rand(g, 3, 20, 16, 1).to(dev)
    outs = []
    for m in (fused, plain):
        _build.reset_launches()
        if train:
            z = m(x, train=True, generator=torch.Generator(device=dev).manual_seed(5))
            z.square().sum().backward()
        else:
            with torch.no_grad():
                z = m(x, train=False)
        torch.cuda.synchronize()
        outs.append((z.detach(), dict(_build.LAUNCHES)))
    want = {"conv_bn_stats": 2, "glu_drop_pool": 2}
    if train:
        want.update(conv_bn_stats_bwd=2, glu_drop_pool_bwd=2)
    assert outs[0][1] == want and outs[1][1] == {}
    _close(outs[0][0], outs[1][0])
    for (name, a), b in zip(fused.state_dict().items(), plain.state_dict().values()):
        _close(a, b)
    if train:
        # the conv biases' exact gradient is 0 under train-mode BatchNorm (both
        # sides give fp32 noise), so each gradient is held relative to its own
        # largest entry or 1e-3 of the model's largest, whichever is larger
        floor = 1e-3 * max(float(p.grad.abs().max()) for p in plain.parameters())
        for (name, a), b in zip(fused.named_parameters(), plain.parameters()):
            err = float((a.grad - b.grad).abs().max()) / max(float(b.grad.abs().max()), floor)
            assert err <= 2e-3, (name, err)


BWD_GEOMS = [  # (B, T, F, Ci, Co, pool): B=1 / B=60, Ci=1, T and F pool remainders
    (1, 13, 16, 1, 8, (2, 2)),
    (60, 11, 6, 24, 40, (3, 4)),
    (3, 7, 5, 128, 128, (1, 2)),
    (2, 17, 3, 64, 16, (2, 1)),
    (1, 1, 1, 3, 70, (1, 1)),
    # the seven crnn_2024() blocks at B=2 (chip_smoke.py runs them at B=60)
    (2, 626, 128, 1, 16, (2, 2)),
    (2, 313, 64, 16, 32, (2, 2)),
    (2, 156, 32, 32, 64, (1, 2)),
    (2, 156, 16, 64, 128, (1, 2)),
    (2, 156, 8, 128, 128, (1, 2)),
    (2, 156, 4, 128, 128, (1, 2)),
    (2, 156, 2, 128, 128, (1, 2)),
    # ragged row tiles (T and F not multiples of the dx and dW tiles), the
    # streaming Ci=1 path with idle threads (Co=24), scalar copies (Ci, Co % 4)
    (3, 37, 70, 16, 32, (2, 2)),
    (2, 19, 9, 128, 128, (2, 2)),
    (2, 23, 3, 12, 20, (1, 1)),
    (1, 5, 130, 1, 24, (1, 2)),
    (2, 9, 7, 5, 6, (1, 1)),
    # ragged depth (576 of 640) and channel (96 of 128) tiles of dW
    (2, 13, 8, 64, 96, (1, 2)),
    # the GLU backward's wide kernel (Wg in slices, dWg in passes): 256
    # channels, 192, and 200 (not a multiple of 8); F * Co lane sums in
    # device memory (512 x 16 beside a tile, 64 x 128)
    (2, 9, 8, 256, 256, (1, 2)),
    (3, 7, 5, 64, 192, (1, 2)),
    (2, 6, 4, 16, 200, (2, 2)),
    (1, 3, 512, 8, 128, (1, 2)),
    (2, 5, 64, 16, 128, (2, 2)),
]


def _glu_args(g, B, T, F, Co, pool):
    pt, pf = pool
    return [_rand(g, B, T, F, Co), 1 + _rand(g, F * Co, scale=0.1), _rand(g, F * Co, scale=0.1),
            _rand(g, Co, Co, scale=1 / np.sqrt(Co)), _rand(g, Co, scale=0.1)], \
        _rand(g, B, T // pt, F // pf, Co)


@pytest.mark.parametrize("geom", BWD_GEOMS)
def test_conv_bn_stats_bwd_kernel(dev, geom):
    B, T, F, Ci, Co, _ = geom
    g = torch.Generator().manual_seed(5)
    x = _rand(g, B, T, F, Ci).to(dev)
    w = _rand(g, 3, 3, Ci, Co, scale=1 / np.sqrt(9 * Ci)).to(dev)
    y = _rand(g, B, T, F, Co).to(dev)
    dy = _rand(g, B, T, F, Co).to(dev)
    ds, dq = _rand(g, F * Co).to(dev), _rand(g, F * Co, scale=0.1).to(dev)
    for need_dx in (True, False):
        got = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)
        want = fused_cnn.conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx)
        assert (got[0] is None) == (not need_dx)
        for a, b in zip(got, want):
            if b is not None:
                _close(a, b)
    again = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))


@pytest.mark.parametrize("geom", BWD_GEOMS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_drop_pool_bwd_kernel(dev, geom, keep):
    B, T, F, _, Co, pool = geom
    g = torch.Generator().manual_seed(6)
    args, gz = _glu_args(g, B, T, F, Co, pool)
    args, gz = [a.to(dev) for a in args], gz.to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    got = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    want = fused_cnn.glu_drop_pool_bwd_plain(*args, bits, gz, pool=pool, keep_prob=kp)
    for a, b in zip(got, want):
        _close(a, b)
    again = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,T,H", [(1, 5, 8), (60, 17, 192), (9, 4, 350)] + GRU_SHAPES[3:])
def test_bigru_bwd_kernel(dev, B, T, H):
    g = torch.Generator().manual_seed(7)
    args = _gru_args(g, B, T, H, dev)
    fwd, bwd = gru.bigru(*args)
    dfwd, dbwd = _rand(g, B, T, H).to(dev), _rand(g, B, T, H).to(dev)
    got = gru.bigru_bwd(*args, fwd, bwd, dfwd, dbwd)
    want = gru.bigru_bwd_plain(*args, fwd, bwd, dfwd, dbwd)
    for a, b in zip(got, want):
        _close(a, b)
    again = gru.bigru_bwd(*args, fwd, bwd, dfwd, dbwd)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_glu_block_gradients(dev):
    """The autograd path on the card against the plain versions on the CPU."""
    B, T, F, Ci, Co = 4, 11, 8, 16, 32
    g = torch.Generator().manual_seed(8)
    args = [_rand(g, B, T, F, Ci), _rand(g, 3, 3, Ci, Co, scale=0.1), _rand(g, Co),
            1 + _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1),
            1 + _rand(g, Co, scale=0.1).abs(), _rand(g, Co, Co, scale=0.2), _rand(g, Co)]
    bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8)
    gz = _rand(g, B, T // 2, F // 2, Co)
    grads = []
    for device in ("cpu", dev):
        leaves = [a.to(device).requires_grad_(i not in (5, 6)) for i, a in enumerate(args)]
        z, _, _ = fused_cnn.fused_glu_block(*leaves, bits=bits.to(device), pool=(2, 2),
                                            train=True, dropout_rate=0.5)
        grads.append(torch.autograd.grad((z * gz.to(device)).sum(),
                                         [a for a in leaves if a.requires_grad]))
    for a, b in zip(grads[1], grads[0]):
        _close(a.cpu(), b)


MEL_CASES = [  # (B, N, n_fft, hop, n_mels)
    (1, 16000, 2048, 256, 128),
    (3, 160000, 2048, 256, 128),
    (3, 16000, 1024, 256, 64),
    (1, 160000, 1024, 256, 128),
    (3, 16000, 2048, 300, 128),  # hop does not divide n_fft, nor is it a multiple of 4
    (2, 16000, 1024, 200, 64),  # hop does not divide n_fft
    (2, 20000, 512, 128, 42),  # 257 frequencies: a ragged last tile; 42 mels
    (1, 16000, 2048, 256, 160),  # over 128 mels: bf16 on the CUDA cores too
    (64, 160000, 2048, 256, 128),  # the 2024 config at B=64: 320 frame tiles of 128
    (2, 40000, 2048, 256, 128),  # 157 frames: a ragged last frame tile of 29
    (2, 16000, 400, 160, 40),  # n_fft 400 (7 items of 64 samples), hop 160, 40 mels
]
# bf16: one bf16 step of a magnitude (2^-7 relative) at most, 0.068 dB
TOL_MEL_BF16_DB = 0.07


@pytest.mark.parametrize("case", MEL_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_log_mel_kernel(dev, case, dtype):
    B, N, n_fft, hop, n_mels = case
    cfg = MelConfig(n_fft=n_fft, win_length=n_fft, hop_length=hop, n_mels=n_mels,
                    compute_dtype=dtype)
    g = torch.Generator().manual_seed(9)
    audio = _rand(g, B, N, scale=0.1).to(dev)
    got = fused_mel.fused_log_mel(audio, cfg)
    want = fused_mel.fused_log_mel_plain(audio, cfg)
    assert got.shape == want.shape == (B, n_mels, cfg.num_frames(N))
    if dtype == "float32":
        _close(got, want)
    else:
        assert float((got - want).abs().max()) <= TOL_MEL_BF16_DB
    assert torch.equal(got, fused_mel.fused_log_mel(audio, cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_log_mel_kernel_band_limited(dev, dtype):
    """f_min > 0 and f_max below Nyquist: the kernels run only the frequencies
    from the first to the last with a nonzero filterbank row."""
    cfg = MelConfig(n_fft=1024, win_length=1024, f_min=300.0, f_max=5000.0, n_mels=64,
                    compute_dtype=dtype)
    g = torch.Generator().manual_seed(10)
    audio = _rand(g, 3, 16000, scale=0.1).to(dev)
    got = fused_mel.fused_log_mel(audio, cfg)
    want = fused_mel.fused_log_mel_plain(audio, cfg)
    if dtype == "float32":
        _close(got, want)
    else:
        assert float((got - want).abs().max()) <= TOL_MEL_BF16_DB


def test_fused_log_mel_plans(dev):
    """bf16 with hop % 8 == 0 and at most 128 mels takes the wgmma kernel
    (plan 3), the 2024 config among them; fp32 and the other bf16 shapes take
    the CUDA-core kernel (plan 1)."""
    from desed_task_tpu_torch.ops import _build

    plan = _build.function("fused_mel", "fused_log_mel_plan", [_build.I] * 4)
    for n_fft, hop, n_mels in [(2048, 256, 128), (1024, 256, 64), (1024, 200, 64),
                               (512, 128, 42), (400, 160, 40), (2048, 320, 128)]:
        assert plan(n_fft, hop, n_mels, 1) == 3, (n_fft, hop, n_mels)
        assert plan(n_fft, hop, n_mels, 0) == 1, (n_fft, hop, n_mels)
    assert plan(2048, 256, 160, 1) == 1  # over 128 mels
    assert plan(2048, 300, 128, 1) == 1  # hop not a multiple of 8
    assert plan(2048, 512, 128, 1) == 1  # 128 frames' span does not fit beside the ring


def test_fused_log_mel_raises_on_inputs_the_kernel_does_not_take(dev):
    audio = torch.zeros(2, 8000, device=dev)
    with pytest.raises(TypeError):
        fused_mel.fused_log_mel(audio.double(), MelConfig())
    with pytest.raises(ValueError):
        fused_mel.fused_log_mel(torch.zeros(8000, 2, device=dev).t(), MelConfig())
    with pytest.raises(ValueError):
        fused_mel.fused_log_mel(audio, MelConfig(power=2.0))
    with pytest.raises(ValueError):
        fused_mel.fused_log_mel(audio, MelConfig(center=False))


# bf16 modes of rows 1 and 2: (B, T, F, Ci, Co, pool)
BF16_GEOMS = [
    (3, 13, 16, 1, 8, (2, 2)),      # Ci = 1: the streaming kernel
    (4, 12, 10, 1, 130, (1, 1)),    # Ci = 1, Co > 128 and not a multiple of 4
    (5, 9, 6, 24, 40, (3, 2)),      # Ci % 16 != 0, Co % 16 != 0, window of 6
    (2, 7, 5, 128, 128, (1, 2)),
    (1, 1, 1, 3, 70, (1, 1)),       # Ci = 3 (element copies), Co % 8 != 0
    (2, 11, 4, 64, 200, (2, 4)),    # two channel tiles, Co % 8 == 0, window of 8
    (2, 9, 8, 256, 256, (1, 2)),    # Co = 256: two channel tiles of 128
    (2, 37, 70, 16, 32, (2, 2)),    # F past the row tile, T ragged
    (2, 19, 9, 12, 20, (1, 1)),     # F * Co = 180, not a multiple of 8
    (3, 23, 3, 5, 6, (1, 2)),       # Ci, Co odd-sized; F * Co = 18
    (2, 156, 2, 128, 128, (1, 2)),  # the last 2024 block, T not a multiple of its tile
    (2, 313, 64, 16, 32, (2, 2)),   # the second 2024 block
    # the other 2024 blocks at B = 2 (conv_c1_bf16_kernel at the first,
    # conv3x3_bf16_fwd_kernel at the rest)
    (2, 626, 128, 1, 16, (2, 2)),
    (2, 156, 32, 32, 64, (2, 2)),
    (2, 156, 16, 64, 128, (1, 2)),
    (2, 156, 8, 128, 128, (1, 2)),
    (2, 156, 4, 128, 128, (1, 2)),
    # conv3x3_bf16_fwd_kernel at a Ci that is not a power of two
    # (16-channel stages, never resident weights)
    (2, 9, 8, 48, 64, (1, 2)),
    (2, 9, 8, 96, 64, (1, 2)),
]


def _bf16(t):
    return t.to(torch.bfloat16)


@pytest.mark.parametrize("geom", BF16_GEOMS)
def test_conv_bn_stats_bf16_kernel(dev, geom):
    B, T, F, Ci, Co, _ = geom
    g = torch.Generator().manual_seed(20)
    x = _bf16(_rand(g, B, T, F, Ci)).to(dev)
    w = _bf16(_rand(g, 3, 3, Ci, Co, scale=1 / np.sqrt(9 * Ci))).to(dev)
    b = _bf16(_rand(g, Co, scale=0.1)).to(dev)
    from desed_task_tpu_torch.ops import _build

    _build.reset_launches()
    y, s, q = fused_cnn.conv_bn_stats(x, w, b)
    assert _build.LAUNCHES == {"conv_bn_stats.bf16": 1}
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    _close_conv_bf16((y, s, q), fused_cnn.conv_bn_stats_plain(x, w, b))
    assert all(torch.equal(a, c) for a, c in zip((y, s, q), fused_cnn.conv_bn_stats(x, w, b)))


def _close_conv_bf16(got, plain):
    """y within one bf16 step of the plain version's; s and q the sums of
    the kernel's own rounded y, and within the plain version's sums plus
    what the flipped roundings move."""
    (y, s, q), (yp, sp, qp) = got, plain
    B, T, F, Co = y.shape
    _close_bf16(y, yp)
    # s and q are the sums of the kernel's own rounded y (fp32 sums in
    # another order); against the plain version's they may also differ by
    # the elements whose rounding flipped, sum |y - y_plain| (and of y^2)
    yl, ypl = y.float().reshape(B * T, F * Co), yp.float().reshape(B * T, F * Co)
    _close(s, yl.sum(0))
    _close(q, (yl * yl).sum(0))
    tol_s = TOL * max(1.0, float(sp.abs().max()))
    tol_q = TOL * max(1.0, float(qp.abs().max()))
    assert bool(((s - sp).abs() <= (yl - ypl).abs().sum(0) + tol_s).all())
    assert bool(((q - qp).abs() <= (yl * yl - ypl * ypl).abs().sum(0) + tol_q).all())


def _geoms_2024(B):
    T, F, ci, out = 626, 128, 1, []
    for co, pool in zip([16, 32, 64, 128, 128, 128, 128], [(2, 2), (2, 2)] + [(1, 2)] * 5):
        out.append((B, T, F, ci, co))
        T, F, ci = T // pool[0], F // pool[1], co
    return out


@pytest.mark.parametrize("geom", _geoms_2024(16) + [(16, 156, 8, 128, 256)],
                         ids=lambda g: f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}")
def test_conv_bn_stats_bf16_persistent_kernels_rerun_bitwise(dev, geom):
    """The persistent kernels at the 2024 blocks (B = 16: several tiles or
    frames a CTA) and at a 256-channel block: the plan picks them, y, s
    and q are bitwise equal over three reruns, y is within one bf16 step of
    the plain version, and s and q (summed over each CTA's run) are held
    to the plain version's as in test_conv_bn_stats_bf16_kernel."""
    B, T, F, Ci, Co = geom
    plan = fused_cnn.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert fused_cnn.FWD_KERNELS[plan.kernel] == (
        "conv_c1_bf16_kernel" if Ci == 1 else "conv3x3_bf16_fwd_kernel")
    g = torch.Generator().manual_seed(21)
    x = _bf16(_rand(g, B, T, F, Ci)).to(dev)
    w = _bf16(_rand(g, 3, 3, Ci, Co, scale=1 / np.sqrt(9 * Ci))).to(dev)
    b = _bf16(_rand(g, Co, scale=0.1)).to(dev)
    first = fused_cnn.conv_bn_stats(x, w, b)
    for _ in range(3):
        assert all(torch.equal(a, c) for a, c in zip(first, fused_cnn.conv_bn_stats(x, w, b)))
    _close_conv_bf16(first, fused_cnn.conv_bn_stats_plain(x, w, b))


@pytest.mark.parametrize("geom", BF16_GEOMS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_drop_pool_bf16_kernel(dev, geom, keep):
    B, T, F, _, Co, pool = geom
    g = torch.Generator().manual_seed(21)
    y = _bf16(_rand(g, B, T, F, Co)).to(dev)
    sf = (1 + _rand(g, F * Co, scale=0.1)).to(dev)
    bf = _rand(g, F * Co, scale=0.1).to(dev)
    wg = _bf16(_rand(g, Co, Co, scale=1 / np.sqrt(Co))).to(dev)
    bg = _bf16(_rand(g, Co, scale=0.1)).to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    z = fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool, keep_prob=kp)
    _close_bf16(z, fused_cnn.glu_drop_pool_plain(y, sf, bf, wg, bg, bits, pool=pool,
                                                 keep_prob=kp))
    assert torch.equal(z, fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool,
                                                  keep_prob=kp))


# the bf16 GLU's two kernels at odd shapes. The ring kernel
# (glu_fwd_ring_kernel): odd T, F % pf != 0, Co = 8, 24, 40, 136 and 256,
# F * Co not a multiple of 8 (the element-load path: Co 5 and 6), pools
# (1, 1), (1, 2), (2, 1), (2, 2) and (3, 2), one frequency, frames too wide
# for one stage (F = 300). The register kernel (glu_fwd_frag_kernel, Co 16,
# 32, 64 and 128): odd T (a last frame pair of one frame), F % pf != 0, a
# ragged frequency tile, pools (1, 1), (1, 2), (2, 1) and (2, 2), whole
# frames of 1, 2 or 4 frequencies in consecutive rows, the first and fourth
# 2024 blocks at B = 2 and 3
GLU_BF16_ODD_GEOMS = [  # (B, T, F, Co, pool)
    (2, 13, 8, 8, (2, 2)), (2, 9, 7, 24, (1, 2)), (3, 11, 5, 40, (2, 1)),
    (2, 7, 6, 136, (2, 2)), (1, 5, 4, 256, (1, 1)), (2, 9, 5, 5, (1, 2)),
    (2, 10, 3, 6, (2, 1)), (1, 3, 1, 70, (1, 1)), (1, 300, 2, 12, (1, 1)),
    (2, 9, 300, 128, (2, 2)), (2, 19, 9, 20, (2, 2)), (1, 15, 11, 48, (3, 2)),
    (3, 313, 64, 32, (2, 2)), (2, 7, 16, 16, (2, 2)), (2, 9, 24, 32, (1, 2)),
    (1, 5, 16, 64, (2, 1)), (2, 6, 41, 16, (1, 2)), (1, 4, 8, 32, (1, 1)),
    (2, 5, 32, 64, (1, 2)), (2, 626, 128, 16, (2, 2)), (2, 4, 8, 128, (1, 1)),
    (2, 5, 4, 128, (1, 2)), (1, 9, 2, 128, (1, 2)), (1, 6, 3, 64, (1, 2)),
    (2, 7, 1, 16, (1, 1)), (3, 156, 16, 128, (1, 2)),
]


@pytest.mark.parametrize("geom", GLU_BF16_ODD_GEOMS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_drop_pool_bf16_odd_shapes(dev, geom, keep):
    """One launch of the kernel its plan names (`frag`: the register kernel,
    else the ring kernel), within one bf16 step of the plain version (at
    most 1 % of z differing), bitwise equal on a rerun."""
    from desed_task_tpu_torch.ops import _build

    B, T, F, Co, pool = geom
    g = torch.Generator().manual_seed(22)
    y = _bf16(_rand(g, B, T, F, Co)).to(dev)
    sf = (1 + _rand(g, F * Co, scale=0.1)).to(dev)
    bf = _rand(g, F * Co, scale=0.1).to(dev)
    wg = _bf16(_rand(g, Co, Co, scale=1 / np.sqrt(Co))).to(dev)
    bg = _bf16(_rand(g, Co, scale=0.1)).to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    _build.reset_launches()
    z = fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool, keep_prob=kp)
    assert _build.LAUNCHES == {"glu_drop_pool.bf16": 1}
    torch.cuda.synchronize()
    _close_bf16(z, fused_cnn.glu_drop_pool_plain(y, sf, bf, wg, bg, bits, pool=pool,
                                                 keep_prob=kp))
    assert torch.equal(z, fused_cnn.glu_drop_pool(y, sf, bf, wg, bg, bits, pool=pool,
                                                  keep_prob=kp))


def test_bf16_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 2, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # mixed dtypes
        fused_cnn.conv_bn_stats(x, w.float(), torch.zeros(8, device=dev))
    y = torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.bfloat16)
    sf = torch.ones(32, device=dev)
    with pytest.raises(TypeError):  # the BN affine stays fp32
        fused_cnn.glu_drop_pool(y, sf.bfloat16(), sf.bfloat16(),
                                torch.zeros(8, 8, device=dev, dtype=torch.bfloat16),
                                torch.zeros(8, device=dev, dtype=torch.bfloat16), pool=(1, 2))


# the bf16 modes of the backward kernels (rows 3 and 4): the streaming Ci = 1
# dW kernel (with and without dx), the CUDA-core dW from bf16 stages (Ci 5,
# 8, 12 and 24: Ci and Co odd, element staging, scalar dy_eff, Ci % 16 != 0),
# the tensor-core dW (ragged row, depth and channel tiles), dx in two
# channel tiles (Ci = 256), the GLU backward's wide kernel, lane sums in
# device memory, pool remainders, and two 2024 blocks
BF16_BWD_GEOMS = [
    (1, 13, 16, 1, 8, (2, 2)),
    (1, 5, 130, 1, 24, (1, 2)),
    (2, 9, 7, 5, 6, (1, 1)),
    (2, 23, 3, 12, 20, (1, 1)),
    (60, 11, 6, 24, 40, (3, 4)),
    (3, 7, 5, 128, 128, (1, 2)),
    (2, 13, 8, 64, 96, (1, 2)),
    (3, 37, 70, 16, 32, (2, 2)),
    (2, 9, 8, 256, 256, (1, 2)),
    (1, 3, 512, 8, 128, (1, 2)),
    (2, 313, 64, 16, 32, (2, 2)),
    (2, 156, 2, 128, 128, (1, 2)),
    # the tensor-core dW: frames of 3 positions (ldmatrix rows across frame
    # ends), a depth tile over taps (Ci = 192 staged whole), Co = 8 (half a
    # dW channel tile)
    (2, 19, 3, 32, 64, (1, 1)),
    (2, 5, 4, 192, 64, (1, 2)),
    (2, 6, 10, 16, 8, (1, 1)),
    # the nine-tap dW: Ci = 48 (16 channels a block), two channel tiles of
    # 128 with a ragged one (Co = 136, 200), F = 1 and frames of 5 and 9
    # positions (ldmatrix rows across frame ends), two frequency tiles
    # (F = 130); the bf16 Ci = 1 kernel: Co = 40 (ragged 8-channel groups),
    # Co = 12 (scalar y, dy, ds and dq loads), F = 1, 5 and 6 (scalar x
    # rows), blocks of frames across clip ends
    (2, 23, 5, 48, 24, (1, 1)),
    (4, 11, 2, 48, 136, (1, 2)),
    (2, 5, 9, 32, 200, (1, 1)),
    (1, 3, 1, 64, 128, (1, 1)),
    (1, 7, 130, 16, 64, (1, 2)),
    (3, 7, 1, 1, 40, (1, 1)),
    (2, 7, 6, 1, 12, (1, 2)),
    (2, 9, 5, 1, 16, (1, 1)),
    (7, 300, 3, 1, 16, (2, 1)),
]


@pytest.mark.parametrize("geom", BF16_BWD_GEOMS)
def test_conv_bn_stats_bwd_bf16_kernel(dev, geom):
    from desed_task_tpu_torch.ops import _build

    B, T, F, Ci, Co, _ = geom
    g = torch.Generator().manual_seed(23)
    x = _bf16(_rand(g, B, T, F, Ci)).to(dev)
    w = _bf16(_rand(g, 3, 3, Ci, Co, scale=1 / np.sqrt(9 * Ci))).to(dev)
    y = _bf16(_rand(g, B, T, F, Co)).to(dev)
    dy = _bf16(_rand(g, B, T, F, Co)).to(dev)
    ds, dq = _rand(g, F * Co).to(dev), _rand(g, F * Co, scale=0.1).to(dev)
    for need_dx in (True, False):
        _build.reset_launches()
        got = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq, need_dx)
        assert _build.LAUNCHES == {"conv_bn_stats_bwd.bf16": 1}
        want = fused_cnn.conv_bn_stats_bwd_plain(x, w, y, dy, ds, dq, need_dx)
        assert (got[0] is None) == (not need_dx)
        for a, b, check in zip(got, want, (_close_bf16, _close_bf16, _close_bf16_sum)):
            if b is not None:
                check(a, b)
    again = fused_cnn.conv_bn_stats_bwd(x, w, y, dy, ds, dq)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))


@pytest.mark.parametrize("geom", BF16_BWD_GEOMS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_drop_pool_bwd_bf16_kernel(dev, geom, keep):
    from desed_task_tpu_torch.ops import _build

    B, T, F, _, Co, pool = geom
    g = torch.Generator().manual_seed(24)
    args, gz = _glu_args(g, B, T, F, Co, pool)
    args = [_bf16(args[0]), args[1], args[2], _bf16(args[3]), _bf16(args[4])]
    args, gz = [a.to(dev) for a in args], _bf16(gz).to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    _build.reset_launches()
    got = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    assert _build.LAUNCHES == {"glu_drop_pool_bwd.bf16": 1}
    want = fused_cnn.glu_drop_pool_bwd_plain(*args, bits, gz, pool=pool, keep_prob=kp)
    assert [a.dtype for a in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    for j, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.bfloat16:
            (_close_bf16_sum if j == 4 else _close_bf16)(a, b)  # dbg: a per-channel sum
        else:
            _close(a, b)
    again = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# glu_bwd_frag_kernel (Co = 16, 32, 64, 128): small shapes with a ragged
# last tile, odd T and F % pf != 0, and the 2024 blocks 0 and 3 at B = 60
BWD_FRAG_GEOMS = [(2, 9, 8, 16, (2, 2)), (1, 7, 6, 32, (2, 2)), (2, 5, 4, 64, (1, 2)),
                  (1, 11, 3, 128, (1, 2)), (3, 5, 7, 16, (3, 4)),
                  (60, 626, 128, 16, (2, 2)), (60, 156, 16, 128, (1, 2))]


@pytest.mark.parametrize("geom", BWD_FRAG_GEOMS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_drop_pool_bwd_bf16_frag_kernel(dev, geom, keep):
    """The bf16 GLU backward's tensor-core kernel (the plan's frag) against
    the bf16 plain version: dy, dwg within one bf16 step, dbg one entry
    aside, dscale_f and dbias_f within TOL; bitwise reruns."""
    from desed_task_tpu_torch.ops import _build

    B, T, F, Co, pool = geom
    assert fused_cnn.glu_bwd_plan(B, T, F, Co, bf16=True).frag == 1
    g = torch.Generator().manual_seed(25)
    args, gz = _glu_args(g, B, T, F, Co, pool)
    args = [_bf16(args[0]), args[1], args[2], _bf16(args[3]), _bf16(args[4])]
    args, gz = [a.to(dev) for a in args], _bf16(gz).to(dev)
    bits = None
    if keep is not None:
        bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8).to(dev)
    kp = 1.0 if keep is None else keep
    _build.reset_launches()
    got = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    assert _build.LAUNCHES == {"glu_drop_pool_bwd.bf16": 1}
    want = fused_cnn.glu_drop_pool_bwd_plain(*args, bits, gz, pool=pool, keep_prob=kp)
    for j, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.bfloat16:
            (_close_bf16_sum if j == 4 else _close_bf16)(a, b)
        else:
            _close(a, b)
    again = fused_cnn.glu_drop_pool_bwd(*args, bits, gz, pool=pool, keep_prob=kp)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_glu_block_bf16_gradients(dev):
    """The bf16 block's autograd path on the card against the plain versions
    on the CPU: the bf16 gradients (x, and the bf16 values in the fp32
    grads of w, wg and bg) within one bf16 step, gamma and beta (fp32 sums)
    within TOL; the conv bias's gradient is the noise of dy rounded to bf16
    (its exact value is 0), held within 5e-5 of the largest gradient."""
    B, T, F, Ci, Co = 4, 11, 8, 16, 32
    g = torch.Generator().manual_seed(25)
    args = [_bf16(_rand(g, B, T, F, Ci)), _rand(g, 3, 3, Ci, Co, scale=0.1), _rand(g, Co),
            1 + _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1), _rand(g, Co, scale=0.1),
            1 + _rand(g, Co, scale=0.1).abs(), _rand(g, Co, Co, scale=0.2), _rand(g, Co)]
    bits = torch.randint(0, 256, (B, T, F * Co), generator=g, dtype=torch.uint8)
    gz = _bf16(_rand(g, B, T // 2, F // 2, Co))
    grads = []
    for device in ("cpu", dev):
        leaves = [a.to(device).requires_grad_(i not in (5, 6)) for i, a in enumerate(args)]
        z, _, _ = fused_cnn.fused_glu_block(*leaves, bits=bits.to(device), pool=(2, 2),
                                            train=True, dropout_rate=0.5)
        assert z.dtype == torch.bfloat16
        grads.append([t.cpu() for t in torch.autograd.grad(
            (z.float() * gz.to(device).float()).sum(), [a for a in leaves if a.requires_grad])])
    scale = max(float(t.abs().max()) for t in grads[0])
    for name, a, b in zip(("x", "w", "bias", "gamma", "beta", "wg", "bg"), grads[1], grads[0]):
        if name == "bias":
            assert float((a - b).abs().max()) <= 5e-5 * scale
        elif name in ("gamma", "beta"):
            _close(a, b)
        else:
            check = _close_bf16_sum if name == "bg" else _close_bf16
            check(a.to(torch.bfloat16), b.to(torch.bfloat16))


def test_bf16_bwd_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 4, 4, 2, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 2, 8, device=dev, dtype=torch.bfloat16)
    y = torch.zeros(1, 4, 4, 8, device=dev, dtype=torch.bfloat16)
    sf = torch.ones(32, device=dev)
    with pytest.raises(TypeError):  # mixed dtypes
        fused_cnn.conv_bn_stats_bwd(x, w, y, y.float(), sf, sf)
    with pytest.raises(TypeError):  # the statistics' cotangents stay fp32
        fused_cnn.conv_bn_stats_bwd(x, w, y, y, sf.bfloat16(), sf.bfloat16())
    wg = torch.zeros(8, 8, device=dev, dtype=torch.bfloat16)
    bg = torch.zeros(8, device=dev, dtype=torch.bfloat16)
    gz = torch.zeros(1, 4, 2, 8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # the BN affine stays fp32
        fused_cnn.glu_drop_pool_bwd(y, sf.bfloat16(), sf.bfloat16(), wg, bg, None, gz,
                                    pool=(1, 2))
    with pytest.raises(TypeError):  # mixed dtypes
        fused_cnn.glu_drop_pool_bwd(y, sf, sf, wg, bg, None, gz.float(), pool=(1, 2))


def test_crnn_bf16_forward_on_the_card(dev):
    """A narrow CRNN with compute_dtype=bf16: on the card through the bf16
    kernels (counted under their own keys), against the same model's plain
    versions on the CPU, well inside the bf16-vs-fp32 gap."""
    from desed_task_tpu_torch.models.crnn import CRNN, init_weights
    from desed_task_tpu_torch.ops import _build

    net = dict(nclass=5, n_RNN_cell=16, n_layers_RNN=2, kernel_size=[3, 3, 3],
               padding=[1, 1, 1], stride=[1, 1, 1], nb_filters=[8, 16, 32],
               pooling=[[2, 2], [2, 2], [1, 2]], n_mels=32)
    g = torch.Generator().manual_seed(22)
    fp32 = init_weights(CRNN(**net), g).eval()
    bf16 = CRNN(**net, compute_dtype=torch.bfloat16).eval()
    bf16.load_state_dict(fp32.state_dict())
    x = _rand(g, 3, 32, 40, scale=4.0)
    with torch.no_grad():
        want = bf16(x)
        ref32 = fp32(x)
        bf16.to(dev)
        _build.reset_launches()
        got = bf16(x.to(dev))
        torch.cuda.synchronize()
    assert _build.LAUNCHES == {"conv_bn_stats.bf16": 3, "glu_drop_pool.bf16": 3, "bigru": 2}
    for a, b, c in zip(got, want, ref32):
        assert float((a.cpu() - b).abs().max()) <= float((b - c).abs().max()) / 8


EVAL_NET = dict(nclass=4, n_RNN_cell=16, n_layers_RNN=1, kernel_size=[3, 3, 3],
                padding=[1, 1, 1], stride=[1, 1, 1], nb_filters=[8, 16, 32],
                pooling=[[2, 2], [2, 2], [1, 2]], n_mels=32)


def _eval_world(dtype):
    """A narrow CRNN (3 blocks, one BiGRU layer), 10 one-second clips with
    int16-valued audio, their ground truth, and the model's eval pieces."""
    from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
    from desed_task_tpu_torch.models.crnn import CRNN, init_weights
    from desed_task_tpu_torch.training.mean_teacher import MeanTeacherState, make_predict_step

    classes = ["A", "B", "C", "D"]
    enc = ManyHotEncoder(classes, 1.0, 512, 256, 4, 16000)
    r = np.random.default_rng(5)
    items, rows = [], []
    for i in range(10):
        on = float(r.uniform(0, 0.5))
        ev = [(classes[i % 4], on, on + 0.4)]
        rows.append((f"c{i}.wav", on, on + 0.4, classes[i % 4]))
        items.append({"audio": (np.round(r.standard_normal(16000) * 3000) / 32768).astype(np.float32),
                      "labels": enc.encode_strong(ev).T.astype(np.float32),
                      "filename": f"c{i}.wav"})
    gt = {k: np.asarray([row[j] for row in rows], object if k in ("filename", "event_label") else None)
          for j, k in enumerate(("filename", "onset", "offset", "event_label"))}
    dur = {"filename": gt["filename"], "duration": np.ones(10)}
    g = torch.Generator().manual_seed(6)
    kw = {} if dtype == "float32" else dict(compute_dtype=torch.bfloat16)
    model = init_weights(CRNN(**EVAL_NET, **kw), g).to("cuda").eval()
    plain = CRNN(**EVAL_NET, **kw, fused_blocks=False, rnn_kernel=False).to("cuda").eval()
    plain.load_state_dict(model.state_dict())
    mel = MelConfig(n_fft=512, win_length=512, hop_length=256, n_mels=32,
                    compute_dtype=dtype)
    state = MeanTeacherState(step=0, student=model, teacher=model, opt_state={})
    return dict(enc=enc, items=items, gt=gt, dur=dur, model=model, plain=plain, state=state,
                predict=make_predict_step(mel))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_cache_loop_on_the_card(dev, dtype):
    """predict_dataset over a DeviceEvalCache on the card: 3/3/1 launches per
    batch (the .bf16 modes in bf16), the same scores as the host-dataset
    branch, fp32 within TOL of the plain model's; then SEDValidator (weak
    and synth, student and teacher: 4 passes) and run_test (1 pass)."""
    from desed_task_tpu_torch.data.device_cache import DeviceEvalCache
    from desed_task_tpu_torch.ops import _build
    from desed_task_tpu_torch.training.evaluate import SEDValidator, predict_dataset, run_test

    w = _eval_world(dtype)
    cache = DeviceEvalCache(w["items"], 4)
    cache.upload()
    assert cache.stores["audio"].is_cuda and cache.n_pad == 12
    suffix = "" if dtype == "float32" else ".bf16"
    per_pass = {f"conv_bn_stats{suffix}": 9, f"glu_drop_pool{suffix}": 9, "bigru": 3}
    kw = dict(median_filter=[3, 5, 1, 7], as_arrays=True, thresholds=(0.5,))
    _build.reset_launches()
    c = predict_dataset(w["predict"], w["model"], cache, w["enc"], 4, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == per_pass
    h = predict_dataset(w["predict"], w["model"], w["items"], w["enc"], 4, **kw)
    _build.reset_launches()
    p = predict_dataset(w["predict"], w["plain"], cache, w["enc"], 4, **kw)
    assert _build.LAUNCHES == {}
    for k in (0, 1):
        for name in c[k]:
            np.testing.assert_array_equal(c[k][name].values, h[k][name].values)
            if dtype == "float32":
                np.testing.assert_allclose(c[k][name].values, p[k][name].values, rtol=0, atol=TOL)
    np.testing.assert_array_equal(c[3], h[3])
    _build.reset_launches()
    SEDValidator(w["predict"], w["enc"], weak_set=cache, synth_set=cache, synth_gt=w["gt"],
                 synth_dur=w["dur"], batch_size=4, median_filter=[3, 5, 1, 7])(w["state"], 0)
    res = run_test(w["predict"], w["state"], cache, w["enc"], w["gt"], w["dur"], batch_size=4,
                   median_filter=[3, 5, 1, 7])
    assert _build.LAUNCHES == {k: 5 * v for k, v in per_pass.items()}
    assert all(np.isfinite(v) and 0 <= v <= 1 for k, v in res.items()
               if k not in ("scores_postprocessed", "prediction_dfs"))
