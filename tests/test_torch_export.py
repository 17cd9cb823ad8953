"""The serving export through custom ops, on the CPU.

`torch.library.opcheck` on the three custom ops (desed_torch::conv_bn_stats,
glu_drop_pool, bigru: schema, fake functions, autograd registration, AOT
dispatch) at fp32 and bf16 samples; then a small CRNN pipeline, without
and with frame embeddings, exported with tools/export.py, saved, loaded
and run: bitwise equal to the port's eager pipeline, and within 1e-4 (the
serving limit) of the JAX package's exported pipeline (tools/export.py of
desed_task_tpu) on the weights that from_jax_params carries across; the
saved graph calls the three ops, once a block and once a GRU layer."""

import json

import jax
import numpy as np
import pytest
import torch

from desed_task_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from desed_task_tpu.labels import ManyHotEncoder as JaxEncoder
from desed_task_tpu.models import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.tools.export import export_pipeline as jax_export
from desed_task_tpu.tools.export import load_pipeline as jax_load
from desed_task_tpu_torch.inference.pipeline import InferencePipeline
from desed_task_tpu_torch.labels import ManyHotEncoder
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops import fused_cnn, gru  # noqa: F401  (registers the ops)
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.tools.export import ARTIFACT, META, OPS, export_pipeline, graph_ops
from desed_task_tpu_torch.tools.export import load_pipeline

TOL_SERVING = 1e-4
NET = dict(nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
           stride=[1, 1], nb_filters=[8, 8], pooling=[[2, 8], [2, 8]], dropout=0.0)
E, TE = 12, 10
BATCH = 4


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


def _conv_args(dtype):
    g = _g(1)
    return tuple(t.to(dtype) for t in (torch.randn(2, 8, 16, 4, generator=g),
                                       torch.randn(3, 3, 4, 8, generator=g),
                                       torch.randn(8, generator=g)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_conv_bn_stats(dtype):
    torch.library.opcheck(torch.ops.desed_torch.conv_bn_stats.default, _conv_args(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits,keep", [(False, 1.0), (True, 0.75)])
@pytest.mark.parametrize("pool", [(2, 2), (1, 2)])
def test_opcheck_glu_drop_pool(dtype, bits, keep, pool):
    g = _g(2)
    B, T, F, Co = 2, 8, 16, 8
    args = (torch.randn(B, T, F, Co, generator=g).to(dtype),
            torch.rand(F * Co, generator=g) + 0.5, torch.randn(F * Co, generator=g),
            torch.randn(Co, Co, generator=g).to(dtype), torch.randn(Co, generator=g).to(dtype),
            torch.randint(0, 256, (B, T, F * Co), dtype=torch.uint8, generator=g)
            if bits else None, pool[0], pool[1], keep)
    torch.library.opcheck(torch.ops.desed_torch.glu_drop_pool.default, args)


@pytest.mark.parametrize("B,T,H", [(2, 5, 4), (3, 7, 8)])
def test_opcheck_bigru(B, T, H):
    g = _g(3)
    args = (torch.randn(B, T, 3 * H, generator=g), torch.randn(B, T, 3 * H, generator=g),
            torch.randn(3 * H, H, generator=g) * 0.3, torch.randn(3 * H, generator=g),
            torch.randn(3 * H, H, generator=g) * 0.3, torch.randn(3 * H, generator=g))
    torch.library.opcheck(torch.ops.desed_torch.bigru.default, args)


def test_wrappers_are_the_ops_on_the_cpu():
    """The public wrappers and the ops give the plain versions' results."""
    x, w, b = _conv_args(torch.float32)
    for a, r in zip(fused_cnn.conv_bn_stats(x, w, b), fused_cnn.conv_bn_stats_plain(x, w, b)):
        assert torch.equal(a, r)
    g = _g(4)
    xs = [torch.randn(2, 5, 12, generator=g) for _ in range(2)]
    ws = [torch.randn(12, 4, generator=g) * 0.3, torch.randn(12, generator=g)] * 2
    for a, r in zip(gru.bigru(*xs, *ws), gru.bigru_plain(*xs, *ws)):
        assert torch.equal(a, r)


def test_mixed_dtypes_raise_before_the_op():
    x, w, b = _conv_args(torch.float32)
    with pytest.raises(TypeError, match="mixed dtypes"):
        fused_cnn.conv_bn_stats(x.bfloat16(), w, b)


def _encoders():
    return (JaxEncoder(["A", "B", "C"], 2, 1024, 256, 4, 16000),
            ManyHotEncoder(["A", "B", "C"], 2, 1024, 256, 4, 16000))


@pytest.fixture(scope="module", params=["audio", "embeddings"])
def exported(request, tmp_path_factory):
    emb = request.param == "embeddings"
    net = dict(NET, use_embeddings=True, embedding_size=E, aggregation_type="pool1d") \
        if emb else NET
    r = np.random.default_rng(7)
    jm = JaxCRNN(**net)
    init = dict(embeddings=np.zeros((1, E, TE), np.float32)) if emb else {}
    variables = jm.init({"params": jax.random.key(0)}, np.zeros((1, 64, 126), np.float32),
                        **init)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.2 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables))
    common = dict(median_filter=[3, 5, 3], thresholds=(0.3, 0.5, 0.7), batch_size=BATCH)
    jenc, tenc = _encoders()
    jpipe = JaxPipeline(jm, variables, jenc,
                        mel_cfg=JaxMel(n_fft=1024, win_length=1024, n_mels=64), **common)
    tpipe = InferencePipeline(CRNN(n_mels=64, **net),
                              from_jax_params(variables["params"], variables["batch_stats"]),
                              tenc, mel_cfg=MelConfig(n_fft=1024, win_length=1024, n_mels=64),
                              device="cpu", **common)
    shape = (E, TE) if emb else None
    root = tmp_path_factory.mktemp(f"export_{request.param}")
    out = export_pipeline(tpipe, root / "torch", embeddings_shape=shape)
    jout = jax_export(jpipe, root / "jax", embeddings_shape=shape)
    audio = (r.standard_normal((BATCH, tpipe.pad_to)) * 0.1).astype(np.float32)
    args = [audio] + ([r.standard_normal((BATCH, E, TE)).astype(np.float32)] if emb else [])
    return dict(out=out, jout=jout, tpipe=tpipe, args=args, emb=emb)


def test_export_writes_the_program_and_meta(exported):
    out = exported["out"]
    assert (out / ARTIFACT).is_file() and (out / META).is_file()
    meta = json.loads((out / META).read_text())
    jmeta = json.loads((exported["jout"] / "meta.json").read_text())
    same = set(jmeta) - {"platforms", "calling_convention_version"}
    assert {k: meta[k] for k in same} == {k: jmeta[k] for k in same}
    assert meta["device"] == "cpu" and meta["device_name"] == "cpu"
    assert meta["batch_size"] == BATCH and meta["pad_to"] == exported["tpipe"].pad_to


def test_saved_graph_calls_the_three_ops(exported):
    program = torch.export.load(str(exported["out"] / ARTIFACT))
    ops = graph_ops(program)
    assert ops == ["desed_torch::conv_bn_stats", "desed_torch::glu_drop_pool"] * 2 + [
        "desed_torch::bigru"]
    assert set(ops) == set(OPS)
    assert json.loads((exported["out"] / META).read_text())["ops"] == ops


def test_loaded_program_is_bitwise_the_eager_pipeline(exported):
    fwd, meta = load_pipeline(exported["out"])
    args = [torch.from_numpy(a) for a in exported["args"]]
    ours = fwd(*args)
    eager = exported["tpipe"].forward(*args)
    assert len(ours) == 3
    for a, b in zip(ours, eager):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    assert ours[2].dtype == torch.bool and ours[2].shape[:3] == (3, BATCH, 3)


def test_loaded_program_matches_the_jax_export(exported):
    fwd, _ = load_pipeline(exported["out"])
    jfwd, _ = jax_load(exported["jout"])
    ours = fwd(*[torch.from_numpy(a) for a in exported["args"]])
    theirs = jfwd(*exported["args"])
    for a, b in zip(ours[:2], theirs[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL_SERVING)
    # activity agrees wherever the score is not within the limit of a threshold
    strong = np.asarray(theirs[0])
    near = np.zeros(ours[2].shape, bool)
    for i, th in enumerate((0.3, 0.5, 0.7)):
        near[i] = np.abs(strong - th) <= TOL_SERVING
    assert np.array_equal(ours[2].numpy()[~near], np.asarray(theirs[2])[~near])
