"""The port's 2021-2023 recipes against the JAX package's, on the CPU:

* `crnn_2023` against JAX `crnn_2023` (XLA chain): the configuration, the
  eval forward at full width (128 mels, 7 blocks, the 2-layer BiGRU of 128
  cells; 2 clips of 160 frames) within 2e-5 on the scores, and one
  mean-teacher train step at full width with dropout and SpecAugment at 0
  (3 slots of one half-second clip): metrics 2e-5 relative, gradients 2e-4
  of each tensor's largest entry (the conv biases, whose exact gradient is
  0 under train-mode BatchNorm: noise below 2e-5 of the largest gradient on
  both sides; JAX's XLA chain on 3 clips gives up to 8e-6 of it);
* the five year SED entry points: flags equal to the JAX train CLI's with
  the same `strong_real`, and the default conf and log dir of their JAX
  twins (recipes/dcase202{1,2,3}_task4_baseline/train_*.py); the three 2021
  separation CLIs: the flags of their JAX twins, and each runs end to end
  on the CPU through its library call;
* `single_run` on the 2022 embedding confs' layouts, AST-style frame
  embeddings through the frame BiGRU (`aggregation_type: frame`) and
  PANNs-style pool1d, on tests/_torch_recipe_corpus.py's corpus with small
  seeded HDF5 stores: the same metrics.csv rows and test-battery keys as
  JAX's `single_run`, metrics in [0, 1];
* chip_smoke.py's phase-12 confs equal to the year yaml files in every
  key but data.* .
"""

import ast
import contextlib
import csv
import io
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from desed_task_tpu import recipes_config as jrc
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu.training import single_run as jsr
from desed_task_tpu.utils import cli as jcli
from desed_task_tpu_torch import recipes_config as trc
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.recipes import (
    dcase2021_finetune_on_separated, dcase2021_pretrain_separation, dcase2021_run_separation,
    dcase2021_train_sed, dcase2022_train_pretrained, dcase2022_train_sed,
    dcase2023_train_pretrained, dcase2023_train_sed)
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, create_state, make_optimizer, make_train_step)
from desed_task_tpu_torch.training import single_run as tsr

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))
from _torch_recipe_corpus import make_config, write_corpus, write_embeddings  # noqa: E402

YEAR_CLIS = {
    dcase2021_train_sed: "dcase2021_task4_baseline/train_sed.py",
    dcase2022_train_sed: "dcase2022_task4_baseline/train_sed.py",
    dcase2022_train_pretrained: "dcase2022_task4_baseline/train_pretrained.py",
    dcase2023_train_sed: "dcase2023_task4_baseline/train_sed.py",
    dcase2023_train_pretrained: "dcase2023_task4_baseline/train_pretrained.py",
}
SEP_CLIS = {
    dcase2021_pretrain_separation: "dcase2021_task4_baseline/pretrain_separation.py",
    dcase2021_run_separation: "dcase2021_task4_baseline/run_separation.py",
    dcase2021_finetune_on_separated: "dcase2021_task4_baseline/finetune_on_separated.py",
}


def test_crnn_2023_config_matches_jax():
    assert trc.CRNN_2023_NET == jrc.CRNN_2023_NET
    conf = yaml.safe_load((ROOT / "recipes/dcase2023_task4_baseline/confs/default.yaml")
                          .read_text())["net"]
    for k, v in trc.CRNN_2023_NET.items():
        assert conf[k] == v, k
    m = trc.crnn_2023(dropout=0.0)
    assert m.dropout == 0.0 and len(m.nclass) == 1 and m.nclass[0] == 10


def _jax_2023(**over):
    return jrc.crnn_2023(fused_blocks=False, rnn_pallas=False, **over)


def _perturbed(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.05 * r.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(tree))


def test_crnn_2023_eval_forward_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 128, 160)).astype(np.float32)
    jm = _jax_2023()
    v = jm.init({"params": jax.random.key(0)}, jnp.asarray(x))
    params = _perturbed(v["params"], 1)
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, _perturbed(v["batch_stats"], 2))
    js, jw = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    tm = trc.crnn_2023()
    tm.load_state_dict(from_jax_params(params, stats), strict=True)
    with torch.no_grad():
        s, w = tm.eval()(torch.from_numpy(x))
    assert s.shape == (2, 10, 40)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=2e-5)


def _keep_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def test_crnn_2023_train_step_matches_jax():
    over = dict(dropout=0.0, specaugm_t_p=0.0, specaugm_f_p=0.0)
    slots = (("synth", 1, "strong"), ("weak", 1, "weak"), ("unlabeled", 1, "unlabeled"))
    r = np.random.default_rng(3)
    batch = {n: {"audio": (r.standard_normal((1, 8000)) * 0.1).astype(np.float32),
                 "labels": (r.random((1, 10, 8)) > 0.7).astype(np.float32)}
             for n, _, _ in slots}
    cfg_j = jmt.MeanTeacherConfig(slots=tuple(jmt.SlotSpec(*s) for s in slots), mixup=None,
                                  rampup_steps=10)
    tx, sched = jmt.make_optimizer(1e-3, 10)
    tx = optax.chain(_keep_grads(), tx)
    jm = _jax_2023(**over)
    state = jmt.create_state(jm, cfg_j, tx, jax.random.key(0), batch, mel_cfg=JaxMel())
    params = _perturbed(state.student_params, 4)
    stats = jax.device_get(state.student_stats)
    state = state.replace(student_params=params, teacher_params=params,
                          opt_state=tx.init(params))
    state, jmetrics = jax.jit(jmt.make_train_step(jm, cfg_j, tx, sched, mel_cfg=JaxMel()))(
        state, batch, jax.random.key(1))
    jgrads = from_jax_params(jax.device_get(state.opt_state[0]))

    tm = trc.crnn_2023(**over)
    tm.load_state_dict(from_jax_params(params, stats), strict=True)
    cfg = MeanTeacherConfig(slots=tuple(SlotSpec(*s) for s in slots), mixup=None,
                            rampup_steps=10)
    opt, sched_t = make_optimizer(1e-3, 10)
    st = create_state(tm, cfg, opt, device="cpu")
    metrics = make_train_step(cfg, opt, sched_t, mel_cfg=MelConfig())(
        st, batch, torch.Generator().manual_seed(1))
    for k, v in jmetrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=2e-5, abs=1e-9), k
    assert "rnn.weight_hh_l1_reverse" in jgrads  # the second layer
    top = max(float(g.abs().max()) for g in jgrads.values())
    for name, p in st.student.named_parameters():
        w = jgrads[name]
        if name.startswith("cnn.conv") and name.endswith(".bias"):
            # exactly 0 under train-mode BatchNorm: both sides give noise
            assert max(float(p.grad.abs().max()), float(w.abs().max())) <= 2e-5 * top, name
            continue
        scale = max(float(w.abs().max()), 1e-12)
        assert float((p.grad - w).abs().max()) <= 2e-4 * scale, name


def _help_flags(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        fn(["--help"])
    assert e.value.code == 0
    return sorted(set(re.findall(r"(--\w+)", out.getvalue())) - {"--help"})


def _jax_twin(rel):
    """default_conf, default_log_dir and strong_real of a JAX recipe script."""
    tree = ast.parse((ROOT / "recipes" / rel).read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "train_cli")
    return {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}


@pytest.mark.parametrize("module", list(YEAR_CLIS), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_year_cli_flags_and_defaults(module, monkeypatch):
    twin = _jax_twin(YEAR_CLIS[module])
    strong = twin.get("strong_real", False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        jcli.train_cli("x", "conf.yaml", "exp", argv=["--help"], strong_real=strong)
    jflags = sorted(set(re.findall(r"(--\w+)", out.getvalue())) - {"--help"})
    assert _help_flags(module.main) == jflags
    conf = ROOT / "recipes" / Path(YEAR_CLIS[module]).parent / twin["default_conf"]
    assert module.DEFAULT_CONF == conf.resolve() and conf.is_file()
    seen = {}
    monkeypatch.setattr(module, "train_cli", lambda *a, **kw: seen.update(kw))
    module.main([])
    assert seen["default_log_dir"] == twin["default_log_dir"]
    assert seen.get("strong_real", False) == strong
    assert seen["default_conf"] == str(module.DEFAULT_CONF)


@pytest.mark.parametrize("module", list(SEP_CLIS), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_separation_cli_flags_match_the_jax_scripts(module):
    src = (ROOT / "recipes" / SEP_CLIS[module]).read_text()
    assert _help_flags(module.main) == sorted(set(re.findall(r'"(--\w+)"', src)))


def test_separation_clis_run(tmp_path):
    from desed_task_tpu_torch.data.audio_io import write_wav

    rng = np.random.default_rng(0)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        for i in range(3):
            write_wav(tmp_path / d / f"{d}{i}.wav",
                      (rng.standard_normal(2400) * 0.1).astype(np.float32), 16000)
    from desed_task_tpu_torch.models import tdcn
    from desed_task_tpu_torch.tools import separation

    # the CLIs run on the card; here the same calls on the CPU at a small width
    kw = dict(enc_dim=8, win=16, bn_dim=8, h_dim=8, n_blocks=1, n_repeats=1)
    from desed_task_tpu_torch.training.separation_pretrain import (
        MixITPretrainConfig, pretrain_separator)

    _, best = pretrain_separator([tmp_path / "a"], [tmp_path / "b"], tmp_path / "log",
                                 MixITPretrainConfig(n_src=2, segment_len=1600,
                                                     batch_mixtures=2, steps_per_epoch=1,
                                                     n_epochs=1, val_pairs=1),
                                 model_kwargs=kw, device="cpu")
    sep = separation.TorchSeparationModel(str(best), device="cpu")
    assert isinstance(sep.model, tdcn.TDCNPP)
    assert sep.separate_folder(tmp_path / "a", tmp_path / "a_separated") == 3
    assert len(list((tmp_path / "a_separated").glob("a*_src*.wav"))) == 6
    with pytest.raises(SystemExit):  # tf1 without its files
        dcase2021_run_separation.main(["--backend", "tf1", "--folders", str(tmp_path / "a")])
    for backend in ([], ["--backend", "torch"]):  # the default, torch, asks for the card
        with pytest.raises(RuntimeError, match="CUDA"):
            dcase2021_run_separation.main(backend + ["--checkpoint", str(best),
                                                     "--folders", str(tmp_path / "a")])


EMB = {"ast": dict(aggregation_type="frame", frame_emb_enc_dim=16),
       "panns": dict(aggregation_type="pool1d")}


def _emb_config(root, model):
    config = write_embeddings(root, make_config(root), dim=6, frames=5)
    shutil.move(str(root / "embeddings" / "beats"), str(root / "embeddings" / model))
    config["pretrained"]["model"] = model
    config["net"].update(EMB[model])
    return config


def _rows(log):
    with open(Path(log) / "metrics.csv") as f:
        return [(r["step"], r["name"]) for r in csv.DictReader(f)]


@pytest.mark.parametrize("model", list(EMB))
def test_single_run_on_the_2022_embedding_layouts_matches_jax(model, tmp_path):
    root = write_corpus(tmp_path / "corpus")
    config = _emb_config(root, model)
    _, tres = tsr.single_run(config, str(tmp_path / "port"), fast_dev_run=True, fast=False,
                             device="cpu")
    _, jres = jsr.single_run(config, str(tmp_path / "jax"), fast_dev_run=True, fast=False)
    assert _rows(tmp_path / "port") == _rows(tmp_path / "jax")
    assert tres.keys() == jres.keys()
    for k in ("psds1", "psds2", "intersection_f1_macro", "event_f1_macro"):
        assert 0.0 <= tres[k] <= 1.0, k
    if model == "ast":
        assert tsr.build_model(config).frame_embs_encoder.hidden == 16


def test_chip_smoke_year_confs_equal_the_yaml(tmp_path):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    for rel in ("dcase2023_task4_baseline/confs/default.yaml",
                "dcase2022_task4_baseline/confs/pretrained_ast.yaml",
                "dcase2021_task4_baseline/confs/sep+sed.yaml"):
        path = ROOT / "recipes" / rel
        want = yaml.safe_load(path.read_text())
        got = chip_smoke.year_config(path, tmp_path)
        assert got.keys() == want.keys()
        for section in want:
            if section == "data":
                for k in ("audio_max_len", "fs", "net_subsample"):
                    assert got["data"][k] == want["data"][k], k
            elif section == "pretrained":
                drop = lambda d: {k: v for k, v in d.items() if k != "extracted_embeddings_dir"}
                assert drop(got[section]) == drop(want[section])
            else:
                assert got[section] == want[section], section
