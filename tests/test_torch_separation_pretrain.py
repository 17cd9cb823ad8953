"""The port's MixIT pretraining (training/separation_pretrain.py) and its
separation tool (tools/separation.py) against the JAX package's, on the CPU
at a narrow width (enc 16, h 32, bn 8, 2 x 1 blocks, win 16).

* `_SegmentPool`: the same clips, tiles and crops as JAX's for a seed
  (numpy draws on both sides), and the same fixed validation pairs;
* two MixIT steps from the same weights against JAX's jitted step: loss
  within 1e-5 dB, global gradient norm within 1e-5 relative, weights within
  5e-7 absolute (a twentieth of the learning rate), except the decoder bias,
  whose exact gradient is 0 (mixture consistency): Adam turns each side's
  noise into a step of either sign, so it moves by at most the learning
  rate a step;
* `pretrain_separator` end to end on a tiny folder: the metrics.csv names of
  JAX's run, step by step, finite losses, a best checkpoint that
  `TorchSeparationModel` loads;
* `TorchSeparationModel` against `JaxSeparationModel` on converted weights,
  at clip lengths inside, at and across the power-of-two buckets (1e-5
  absolute), and `separate_folder` writing the same files;
* the TF1 backend raising FileNotFoundError without its metagraph.
"""

import csv
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.tdcn import TDCNPP as JaxTDCN
from desed_task_tpu.tools import separation as jtools
from desed_task_tpu.training import separation_pretrain as jsp
from desed_task_tpu_torch.data.audio_io import read_wav, write_wav
from desed_task_tpu_torch.models.convert import from_jax_tdcn_params
from desed_task_tpu_torch.models.tdcn import TDCNPP
from desed_task_tpu_torch.tools import separation as ttools
from desed_task_tpu_torch.training import separation_pretrain as tsp

KW = dict(enc_dim=16, win=16, bn_dim=8, h_dim=32, n_blocks=2, n_repeats=1)
LR = 1e-3


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixit")
    rng = np.random.default_rng(0)
    for split, lengths in (("train", [1500, 4000, 5000, 2500]), ("val", [3000, 4200])):
        (root / split).mkdir()
        for i, n in enumerate(lengths):
            t = np.arange(n) / 16000.0
            sig = 0.2 * np.sin(2 * np.pi * rng.uniform(200, 2000) * t)
            sig += 0.05 * rng.standard_normal(n)
            write_wav(root / split / f"{split}{i}.wav", sig.astype(np.float32), 16000)
    return root


def test_segment_pool_matches_jax(folders):
    tp = tsp._SegmentPool([folders / "train"], 2000)
    jp = jsp._SegmentPool([folders / "train"], 2000)
    assert len(tp.clips) == len(jp.clips) == 4
    for a, b in zip(tp.clips, jp.clips):
        np.testing.assert_array_equal(a, b)
    got = tp.sample(6, np.random.default_rng(5))
    np.testing.assert_array_equal(got, jp.sample(6, np.random.default_rng(5)))
    np.testing.assert_array_equal(tp.fixed_pairs(3, 1), jp.fixed_pairs(3, 1))
    assert len(tsp._SegmentPool([folders / "train"], 2000, limit=2).clips) == 2
    with pytest.raises(FileNotFoundError):
        tsp._SegmentPool([folders / "missing"], 2000)


def test_two_mixit_steps_match_jax(folders):
    cfg = jsp.MixITPretrainConfig(n_src=4, segment_len=1600, batch_mixtures=4, lr=LR)
    tcfg = tsp.MixITPretrainConfig(**vars(cfg))
    model = JaxTDCN(n_src=4, **KW)
    params = model.init(jax.random.key(0), jnp.zeros((1, 1600), jnp.float32))
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip), optax.adam(cfg.lr))
    opt = tx.init(params)
    port = TDCNPP(n_src=4, **KW)
    port.load_state_dict(from_jax_tdcn_params(jax.device_get(params)))
    ttx = tsp.make_optimizer(tcfg)
    topt = ttx.init(list(port.parameters()))
    jstep = jsp.make_mixit_train_step(model, cfg, tx)
    tstep = tsp.make_mixit_train_step(tcfg, ttx)
    pool = tsp._SegmentPool([folders / "train"], 1600)
    rng = np.random.default_rng(3)
    for _ in range(2):
        audio = pool.sample(4, rng)
        params, opt, jm = jstep(params, opt, jnp.asarray(audio))
        tm = tstep(port, topt, torch.from_numpy(audio))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    want = from_jax_tdcn_params(jax.device_get(params))
    for name, p in port.state_dict().items():
        tol = 2 * LR if name == "decoder.bias" else 5e-7
        err = float((p - want[name]).abs().max())
        assert err <= tol, (name, err)


def _csv_names(path):
    with open(path) as f:
        return [(r["step"], r["name"]) for r in csv.DictReader(f)]


def test_pretrain_separator_end_to_end(folders, tmp_path):
    cfg = dict(n_src=3, segment_len=2000, batch_mixtures=4, steps_per_epoch=2, n_epochs=2,
               val_pairs=2, lr=LR)
    kw = dict(enc_dim=16, win=16, bn_dim=8, h_dim=16, n_blocks=2, n_repeats=1)
    model, best = tsp.pretrain_separator([folders / "train"], [folders / "val"],
                                         tmp_path / "port", tsp.MixITPretrainConfig(**cfg),
                                         model_kwargs=kw, device="cpu")
    jsp.pretrain_separator([folders / "train"], [folders / "val"], tmp_path / "jax",
                           jsp.MixITPretrainConfig(**cfg), model_kwargs=kw)
    assert best == tmp_path / "port" / "tdcn_mixit_best.pt" and best.exists()
    names = _csv_names(tmp_path / "port" / "metrics.csv")
    assert names == _csv_names(tmp_path / "jax" / "metrics.csv")
    with open(tmp_path / "port" / "metrics.csv") as f:
        losses = [float(r["value"]) for r in csv.DictReader(f) if r["name"] == "train/mixit_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    sep = ttools.TorchSeparationModel(str(best), device="cpu")
    assert isinstance(sep.model, TDCNPP) and sep.model.n_src == 3
    out = sep.separate(np.random.default_rng(1).standard_normal(3000).astype(np.float32))
    assert out.shape == (3, 3000) and np.isfinite(out).all()


@pytest.mark.parametrize("n", [1600, 16000, 16001, 20000])
def test_separation_model_matches_jax(n):
    jsep = jtools.JaxSeparationModel(None, n_src=2, **KW)
    tsep = ttools.TorchSeparationModel(None, n_src=2, device="cpu", **KW)
    tsep.model.load_state_dict(from_jax_tdcn_params(jax.device_get(jsep.variables)))
    x = (np.random.default_rng(n).standard_normal(n) * 0.1).astype(np.float32)
    got, want = tsep.separate(x), jsep.separate(x)
    assert got.shape == want.shape == (2, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the bucket is semantics: without its padding the sources differ
    with torch.no_grad():
        unpadded = tsep.model(torch.from_numpy(x)[None])[0].numpy()
    assert n == 16000 or np.abs(unpadded - got).max() > 1e-4


def test_separate_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "in").mkdir()
    for i, n in enumerate((3200, 17000)):
        write_wav(tmp_path / "in" / f"m{i}.wav",
                  (rng.standard_normal(n) * 0.1).astype(np.float32), 16000)
    jsep = jtools.JaxSeparationModel(None, n_src=2, **KW)
    tsep = ttools.TorchSeparationModel(None, n_src=2, device="cpu", **KW)
    tsep.model.load_state_dict(from_jax_tdcn_params(jax.device_get(jsep.variables)))
    assert tsep.separate_folder(tmp_path / "in", tmp_path / "t") == 2
    assert jsep.separate_folder(tmp_path / "in", tmp_path / "j") == 2
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "m0_src0.wav", "m0_src1.wav", "m1_src0.wav", "m1_src1.wav"]
    for name in names:
        a, fa = read_wav(tmp_path / "t" / name)
        b, fb = read_wav(tmp_path / "j" / name)
        assert fa == fb == 16000
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_tf1_backend_needs_its_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="metagraph"):
        ttools.SeparationModel(str(tmp_path / "ckpt"), str(tmp_path / "inference.meta"))
    assert "tensorflow" not in sys.modules
