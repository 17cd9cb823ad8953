"""The port's 2021 separation-ensemble fine-tune (training/sepsed_run.py)
against the JAX package's `sepsed_single_run`, on the CPU, on the corpus
layout of tests/test_sepsed_run.py (2-s clips with 2 separated sources
each, 3 slots of 2, a narrow CRNN), fast_dev_run:

* the same separated datasets (slots, weak split, items bitwise) and
  steps per epoch as JAX's run builds;
* the same metrics.csv rows (step and name) as JAX's run, and the same
  test battery keys, every metric in [0, 1];
* the multisrc branch seeded from the monaural checkpoint, the monaural
  branch outside the state, `best` and `last` written;
* `test_from_checkpoint` giving the run's own test results again;
* a missing checkpoint and a bad `sed_model` raising.
The two runs' random draws differ (PRNG streams), so their values are not
compared; the step itself is held to JAX's in tests/test_torch_sepsed.py.
"""

import csv
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from desed_task_tpu.data import MultiSourceBatcher as JaxBatcher
from desed_task_tpu.data import StronglyAnnotatedSet as JStrong
from desed_task_tpu.data import UnlabeledSet as JUnlabeled
from desed_task_tpu.data import WeakSet as JWeak
from desed_task_tpu.data.datasets import SeparatedSet as JSeparated
from desed_task_tpu.obs.checkpoint import CheckpointManager as JaxCkpt
from desed_task_tpu.training import MeanTeacherConfig as JCfg
from desed_task_tpu.training import SlotSpec as JSlot
from desed_task_tpu.training import create_state as jcreate_state
from desed_task_tpu.training import make_optimizer as jmake_optimizer
from desed_task_tpu.training import sepsed_run as jrun
from desed_task_tpu.training import single_run as jsr
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
from desed_task_tpu_torch.training import create_state, make_optimizer
from desed_task_tpu_torch.training import sepsed_run as trun
from desed_task_tpu_torch.training import single_run as tsr

sys.path.insert(0, str(Path(__file__).parent))
from _torch_recipe_corpus import write_tsv  # noqa: E402

CLASSES = ["Speech", "Dog", "Cat"]
N_SRC, SECS = 2, 2


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_sepsed_run.py's corpus, written without pandas."""
    root = tmp_path_factory.mktemp("sep_corpus")
    rng = np.random.default_rng(11)
    for sub, n in [("synth", 4), ("weak", 4), ("unlab", 4), ("synth_val", 2), ("test", 2)]:
        (root / sub).mkdir()
        sep = root / f"{sub}_separated"
        sep.mkdir()
        for i in range(n):
            x = (rng.standard_normal(SECS * 16000) * 0.1).astype(np.float32)
            write_wav(root / sub / f"{sub}_{i}.wav", x, 16000)
            for s in range(N_SRC):
                write_wav(sep / f"{sub}_{i}_src{s}.wav",
                          (x / N_SRC + rng.standard_normal(len(x)) * 0.01).astype(np.float32),
                          16000)
    meta = root / "meta"
    meta.mkdir()
    head = ["filename", "onset", "offset", "event_label"]
    strong = lambda sub, n: [(f"{sub}_{i}.wav", 0.2, 1.5, CLASSES[i % 3]) for i in range(n)]
    write_tsv(meta / "synth.tsv", head, strong("synth", 4))
    write_tsv(meta / "weak.tsv", ["filename", "event_labels"],
              [(f"weak_{i}.wav", CLASSES[i % 3]) for i in range(4)])
    write_tsv(meta / "synth_val.tsv", head, strong("synth_val", 2))
    write_tsv(meta / "test.tsv", head, strong("test", 2))
    for name in ("synth_val", "test"):
        write_tsv(meta / f"{name}_dur.tsv", ["filename", "duration"],
                  [(f"{name}_{i}.wav", float(SECS)) for i in range(2)])
    return root


def make_config(root):
    """tests/test_sepsed_run.py's make_config."""
    return {
        "training": {
            "batch_size": [2, 2, 2], "batch_size_val": 2, "const_max": 2,
            "n_epochs_warmup": 1, "num_workers": 1, "n_epochs": 2, "gradient_clip": 5.0,
            "n_test_thresholds": 3, "ema_factor": 0.999, "self_sup_loss": "mse",
            "validation_interval": 1, "weak_split": 0.75, "seed": 42,
            "obj_metric_synth_type": "intersection",
        },
        "scaler": {"statistic": "instance", "normtype": "minmax", "dims": [1, 2]},
        "data": {
            "synth_folder": str(root / "synth"), "synth_tsv": str(root / "meta/synth.tsv"),
            "weak_folder": str(root / "weak"), "weak_tsv": str(root / "meta/weak.tsv"),
            "unlabeled_folder": str(root / "unlab"),
            "synth_val_folder": str(root / "synth_val"),
            "synth_val_tsv": str(root / "meta/synth_val.tsv"),
            "synth_val_dur": str(root / "meta/synth_val_dur.tsv"),
            "test_folder": str(root / "test"), "test_tsv": str(root / "meta/test.tsv"),
            "test_dur": str(root / "meta/test_dur.tsv"),
            "audio_max_len": SECS, "fs": 16000, "net_subsample": 4,
        },
        "opt": {"lr": 0.001},
        "feats": {"n_mels": 64, "n_filters": 1024, "hop_length": 256, "n_window": 1024,
                  "sample_rate": 16000, "f_min": 0, "f_max": 8000},
        "net": {
            "dropout": 0.2, "n_layers_RNN": 1, "n_in_channel": 1, "nclass": 10,
            "attention": True, "n_RNN_cell": 16, "activation": "glu", "rnn_type": "BGRU",
            "kernel_size": [3, 3], "padding": [1, 1], "stride": [1, 1], "nb_filters": [8, 8],
            "pooling": [[2, 8], [2, 8]], "median_filter": 3,
        },
    }


def _slots(size=2):
    return [("synth", size, "strong"), ("weak", size, "weak"), ("unlabeled", size, "unlabeled")]


def _jax_checkpoint(config, path):
    """A monaural SED checkpoint as JAX's train_sed writes it."""
    cfg = JCfg(slots=tuple(JSlot(*s) for s in _slots()), mixup=None, rampup_steps=10)
    rng = np.random.default_rng(0)
    batch = {name: {"audio": rng.standard_normal((2, SECS * 16000)).astype(np.float32) * 0.1,
                    "labels": np.zeros((2, 10, 31), np.float32)} for name, _, _ in _slots()}
    tx, _ = jmake_optimizer(lr=1e-3, rampup_steps=10)
    state = jcreate_state(jsr.build_model(config), cfg, tx, jax.random.key(3), batch,
                          mel_cfg=jsr.mel_config(config))
    JaxCkpt(path).save(state, {"epoch": 0}, name="best")
    return str(path)


def _port_checkpoint(config, path):
    """A monaural SED checkpoint as the port's single_run writes it."""
    tx, _ = make_optimizer(1e-3, 10)
    torch.manual_seed(3)
    state = create_state(tsr.build_model(config), None, tx, device="cpu")
    CheckpointManager(path).save(state, {"epoch": 0}, name="best")
    return str(path), state


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    config = make_config(corpus)
    tmp = tmp_path_factory.mktemp("sepsed_runs")
    jax_ckpt = _jax_checkpoint(config, tmp / "jax_sed")
    jstate, jres = jrun.sepsed_single_run(config, str(tmp / "jax"), sed_checkpoint=jax_ckpt,
                                          n_src=N_SRC, fast_dev_run=True)
    port_ckpt, mono_state = _port_checkpoint(config, tmp / "port_sed")
    info = {}
    tstate, tres = trun.sepsed_single_run(config, str(tmp / "port"), sed_checkpoint=port_ckpt,
                                          n_src=N_SRC, fast_dev_run=True, device="cpu",
                                          run_info=info)
    return dict(config=config, tmp=tmp, jres=jres, tstate=tstate, tres=tres, info=info,
                port_ckpt=port_ckpt, mono_state=mono_state)


def _rows(log):
    with open(Path(log) / "metrics.csv") as f:
        return [(r["step"], r["name"]) for r in csv.DictReader(f)]


def test_separated_datasets_match_jax(corpus, runs):
    config = make_config(corpus)
    data, t = config["data"], config["training"]
    enc = jsr.build_encoder(config)
    common = dict(pad_to=SECS, fs=16000)
    import pandas as pd

    weak_tsv = pd.read_csv(data["weak_tsv"], sep="\t")
    perm = np.random.default_rng(42).permutation(len(weak_tsv))
    n_train = int(len(weak_tsv) * t["weak_split"])
    sep = lambda base, key: JSeparated(jrun._sep_folder(data, key), base, n_src=N_SRC,
                                       sources_as_audio=True)
    jsets = {
        "synth": sep(JStrong(data["synth_folder"], pd.read_csv(data["synth_tsv"], sep="\t"),
                             enc, **common), "synth_folder"),
        "weak": sep(JWeak(data["weak_folder"], weak_tsv.iloc[perm[:n_train]], enc, **common),
                    "weak_folder"),
        "unlabeled": sep(JUnlabeled(data["unlabeled_folder"], enc, **common),
                         "unlabeled_folder"),
    }
    batcher = runs["info"]["batcher"]
    assert list(batcher.datasets) == list(jsets)
    assert batcher.batch_sizes == {"synth": 2, "weak": 2, "unlabeled": 2}
    for name, jset in jsets.items():
        tset = batcher.datasets[name]
        assert tset.examples_list == jset.examples_list, name
        a, b = tset[0], jset[0]
        assert a.keys() == b.keys(), name
        for k in ("audio", "sources", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}/{k}")
        assert a["audio"].shape == (N_SRC, SECS * 16000)
    assert batcher.steps_per_epoch == JaxBatcher(jsets, batcher.batch_sizes).steps_per_epoch
    assert sum(h["steps"] for h in runs["info"]["loop"].history) == 2 * batcher.steps_per_epoch


def test_metrics_and_test_battery_match_jax(runs):
    tmp = runs["tmp"]
    assert _rows(tmp / "port") == _rows(tmp / "jax")
    assert "val/obj_metric" in {n for _, n in _rows(tmp / "port")}
    tres, jres = runs["tres"], runs["jres"]
    assert tres.keys() == jres.keys()
    for k in ("psds1", "psds2", "intersection_f1_macro", "event_f1_macro"):
        assert 0.0 <= tres[k] <= 1.0, k
    for name in ("best", "last"):
        assert (tmp / "port" / "checkpoints" / name).exists()


def test_multisrc_seeded_from_the_monaural_checkpoint(runs):
    st = runs["tstate"]
    mono = runs["mono_state"].student.state_dict()
    assert all(torch.equal(st.student.monaural.state_dict()[k], v) for k, v in mono.items())
    sd = st.student.state_dict()
    assert set(sd) == {f"multisrc_crnn.{k}" for k in mono} | {"q_logit"}
    # frozen BatchNorm: the running statistics are the checkpoint's
    for k, v in mono.items():
        if "running" in k:
            assert torch.equal(sd[f"multisrc_crnn.{k}"], v), k
    assert st.student.multisrc_crnn.freeze_bn
    # the run ends on its best checkpoint
    best = CheckpointManager(runs["tmp"] / "port" / "checkpoints").load("best")
    assert st.step == best["step"] >= 1


def test_from_checkpoint_repeats_the_results(runs):
    tmp = runs["tmp"]
    _, res = trun.sepsed_single_run(runs["config"], str(tmp / "port_test"),
                                    sed_checkpoint=runs["port_ckpt"], n_src=N_SRC,
                                    fast_dev_run=True, device="cpu",
                                    test_from_checkpoint=str(tmp / "port" / "checkpoints"))
    for k, v in runs["tres"].items():
        if isinstance(v, float):
            assert res[k] == v, k
    assert not (tmp / "port_test" / "checkpoints" / "last").exists()


def test_bad_arguments_raise(runs, tmp_path):
    with pytest.raises(FileNotFoundError):
        trun.sepsed_single_run(runs["config"], str(tmp_path / "x"),
                               sed_checkpoint=str(tmp_path / "none"), device="cpu")
    with pytest.raises(ValueError, match="sed_model"):
        trun.sepsed_single_run(runs["config"], str(tmp_path / "y"),
                               sed_checkpoint=runs["port_ckpt"], sed_model="both",
                               device="cpu")


def test_sep_folder():
    data = {"synth_folder": "/d/synth/", "weak_folder": "/d/weak", "weak_folder_sep": "/e/w"}
    assert trun._sep_folder(data, "synth_folder") == "/d/synth_separated"
    assert trun._sep_folder(data, "weak_folder") == "/e/w"
    assert all(trun._sep_folder(data, k) == jrun._sep_folder(data, k) for k in
               ("synth_folder", "weak_folder"))
