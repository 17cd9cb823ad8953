"""The custom ops and the serving export on the card (needs an NVIDIA GPU
with nvcc, sm_90a; skips elsewhere):

    python -m pytest tests/test_torch_export_cuda.py -m cuda --noconftest

`torch.library.opcheck` of desed_torch::conv_bn_stats, glu_drop_pool,
bigru and mel_linear on CUDA tensors (the kernels against their fake
functions: shapes, dtypes, schema, AOT dispatch), and a narrow CRNN pipeline
exported, saved, loaded and run on the card: the program launches one kernel
a block, one BiGRU a batch and, in bf16, the front end's kernel, and its
outputs are bitwise the eager pipeline's.
"""

import tempfile

import numpy as np
import pytest
import torch

from desed_task_tpu_torch.ops import _build, fused_cnn, fused_mel, gru  # noqa: F401  (registers the ops)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(*shape, gen, dev, dtype=torch.float32):
    return torch.randn(*shape, generator=gen).to(device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_conv_bn_stats_on_the_card(dev, dtype):
    g = torch.Generator().manual_seed(1)
    args = (_randn(2, 12, 16, 8, gen=g, dev=dev, dtype=dtype),
            _randn(3, 3, 8, 16, gen=g, dev=dev, dtype=dtype),
            _randn(16, gen=g, dev=dev, dtype=dtype))
    torch.library.opcheck(torch.ops.desed_torch.conv_bn_stats.default, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [False, True])
def test_opcheck_glu_drop_pool_on_the_card(dev, dtype, bits):
    g = torch.Generator().manual_seed(2)
    B, T, F, Co = 2, 12, 16, 16
    args = (_randn(B, T, F, Co, gen=g, dev=dev, dtype=dtype),
            (torch.rand(F * Co, generator=g) + 0.5).to(dev), _randn(F * Co, gen=g, dev=dev),
            _randn(Co, Co, gen=g, dev=dev, dtype=dtype), _randn(Co, gen=g, dev=dev, dtype=dtype),
            torch.randint(0, 256, (B, T, F * Co), dtype=torch.uint8, generator=g).to(dev)
            if bits else None, 2, 2, 0.75 if bits else 1.0)
    torch.library.opcheck(torch.ops.desed_torch.glu_drop_pool.default, args)


@pytest.mark.parametrize("H", [16, 128])
def test_opcheck_bigru_on_the_card(dev, H):
    g = torch.Generator().manual_seed(3)
    B, T = 3, 20
    args = (_randn(B, T, 3 * H, gen=g, dev=dev), _randn(B, T, 3 * H, gen=g, dev=dev),
            _randn(3 * H, H, gen=g, dev=dev) * 0.1, _randn(3 * H, gen=g, dev=dev),
            _randn(3 * H, H, gen=g, dev=dev) * 0.1, _randn(3 * H, gen=g, dev=dev))
    torch.library.opcheck(torch.ops.desed_torch.bigru.default, args)


def test_mel_linear_opcheck(dev):
    from desed_task_tpu_torch.ops.frontend import MelConfig, center_pad

    cfg = MelConfig(n_fft=1024, win_length=1024, n_mels=64, compute_dtype="bfloat16")
    items, band = fused_mel._linear_constants(cfg, dev)
    x = center_pad(_randn(2, 8000, gen=torch.Generator().manual_seed(4), dev=dev) * 0.1, cfg)
    torch.library.opcheck(torch.ops.desed_torch.mel_linear.default,
                          (x, items, band, cfg.num_frames(8000), cfg.n_fft, cfg.hop_length,
                           cfg.n_mels))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exported_pipeline_on_the_card(dev, dtype):
    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels import ManyHotEncoder
    from desed_task_tpu_torch.models.crnn import CRNN
    from desed_task_tpu_torch.ops.frontend import MelConfig
    from desed_task_tpu_torch.tools.export import export_pipeline, load_pipeline

    torch.manual_seed(0)
    net = dict(nclass=3, n_RNN_cell=16, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
               stride=[1, 1], nb_filters=[16, 16], pooling=[[2, 4], [2, 4]], dropout=0.0)
    if dtype == "bfloat16":
        net["compute_dtype"] = torch.bfloat16
    mel = MelConfig(n_fft=1024, win_length=1024, n_mels=64, compute_dtype=dtype)
    pipe = InferencePipeline(CRNN(n_mels=64, **net), None,
                             ManyHotEncoder(["A", "B", "C"], 2, 1024, 256, 4, 16000),
                             mel_cfg=mel, median_filter=[3, 5, 3], thresholds=(0.3, 0.5),
                             batch_size=4, device=dev)
    audio = torch.as_tensor(np.random.default_rng(0).standard_normal((4, pipe.pad_to))
                            .astype(np.float32) * 0.1, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        fwd, meta = load_pipeline(export_pipeline(pipe, tmp))
    assert meta["device"].startswith("cuda") and meta["device_name"] == torch.cuda.get_device_name()
    eager = pipe.forward(audio)
    _build.reset_launches()
    out = fwd(audio)
    torch.cuda.synchronize()
    sfx = ".bf16" if dtype == "bfloat16" else ""
    # in bf16 the program calls the front end's kernel (desed_torch::mel_linear)
    front = {"mel_spectrogram.fused": 1} if dtype == "bfloat16" else {}
    assert dict(_build.LAUNCHES) == {f"conv_bn_stats{sfx}": 2, f"glu_drop_pool{sfx}": 2,
                                     "bigru": 1, **front}
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(out, eager))
