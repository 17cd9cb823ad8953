"""The port's recipe engine (training/single_run.py, utils/cli.py, the recipe
entry point) on the CPU, against the JAX package on the corpus of
tests/test_single_run.py (3 slots, and the 5-slot 2024 layout with
MAESTRO), fast_dev_run, fp32:

* the same slot specs, batch sizes, weak split, MAESTRO split and
  steps_per_epoch as JAX's `build_train_datasets` and batcher;
* the same metrics.csv names, step by step, as JAX's `single_run` on the
  2024 layout (the 3-slot run: the same names without MAESTRO's);
* `best` and `last` written, the device train store switched on,
  `test_from_checkpoint` giving the run's own results again, the
  evaluation score dump's layout, `--strong_real` composition;
* train_cli's flags equal to JAX's; chip_smoke.py's recipe config equal to
  confs/pretrained.yaml in every key but data.*;
* a subprocess in which pandas, matplotlib, yaml, h5py and tensorboardX
  cannot be imported runs the port's single_run to its end and says that
  the PSD-ROC plots were not written.
"""

import contextlib
import csv
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from desed_task_tpu.training import single_run as jsr
from desed_task_tpu.utils import cli as jcli
from desed_task_tpu_torch.data.audio_io import write_wav
from desed_task_tpu_torch.data.batcher import MultiSourceBatcher
from desed_task_tpu_torch.recipes import dcase2024_train_pretrained as recipe
from desed_task_tpu_torch.training import single_run as tsr
from desed_task_tpu_torch.utils import cli as tcli
from desed_task_tpu_torch.utils import table as tbl

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))
from _torch_recipe_corpus import config_2024, make_config, write_corpus  # noqa: E402

LAYOUTS = {"3slot": make_config, "2024": config_2024}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = write_corpus(tmp_path_factory.mktemp("recipe_corpus"))
    rng = np.random.default_rng(11)
    (root / "eval").mkdir()
    for i in range(3):
        write_wav(root / "eval" / f"e{i}.wav",
                  (rng.standard_normal(32000) * 0.1).astype(np.float32), 16000)
    return root


@pytest.fixture(scope="module")
def port_runs(corpus, tmp_path_factory):
    out = {}
    for name, make in LAYOUTS.items():
        log = tmp_path_factory.mktemp(f"port_{name}")
        info = {}
        state, results = tsr.single_run(make(corpus), str(log), fast_dev_run=True, fast=False,
                                        device="cpu", run_info=info)
        out[name] = dict(log=log, state=state, results=results, info=info)
    return out


@pytest.fixture(scope="module")
def jax_run_2024(corpus, tmp_path_factory):
    log = tmp_path_factory.mktemp("jax_2024")
    jsr.single_run(config_2024(corpus), str(log), fast_dev_run=True, fast=False)
    return log


def _csv_rows(log):
    with open(Path(log) / "metrics.csv") as f:
        rows = list(csv.reader(f))
    return rows[0], [(r[1], r[2]) for r in rows[1:]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slots_splits_and_steps_match_jax(corpus, layout):
    config = LAYOUTS[layout](corpus)
    tj, tt = jsr.build_encoder(config), tsr.build_encoder(config)
    assert tt.labels == tj.labels
    dj, bj, sj = jsr.build_train_datasets(config, tj)
    dt, bt, st = tsr.build_train_datasets(config, tt)
    assert [(s.name, s.size, s.role) for s in st] == [(s.name, s.size, s.role) for s in sj]
    assert bt == bj
    assert dt.keys() == dj.keys()
    for k in dj:
        if k == "_maestro_val_tsv":  # the MAESTRO validation rows
            assert list(dt[k]["filename"]) == list(dj[k]["filename"])
            np.testing.assert_array_equal(dt[k]["onset"], dj[k]["onset"].to_numpy())
            continue
        assert dt[k].examples_list == dj[k].examples_list, k  # weak split, MAESTRO split
        assert (dt[k].class_mask == dj[k].class_mask).all(), k
    if layout == "2024":
        assert len(dt["maestro"].examples_list) < 12 and tbl.n_rows(dt["_maestro_val_tsv"])
        # aliased MAESTRO events are duplicated under their DESED names
        assert any(ev[0] == "Speech" for ex in dt["maestro"].examples.values()
                   for ev in ex["events"])
    train = {k: v for k, v in dt.items() if not k.startswith("_")}
    steps = MultiSourceBatcher(train, bt).steps_per_epoch
    from desed_task_tpu.data import MultiSourceBatcher as JBatcher

    assert steps == JBatcher({k: v for k, v in dj.items() if not k.startswith("_")},
                             bj).steps_per_epoch


def test_metrics_csv_names_match_jax(port_runs, jax_run_2024):
    head_j, rows_j = _csv_rows(jax_run_2024)
    head_t, rows_t = _csv_rows(port_runs["2024"]["log"])
    assert head_t == head_j == ["time", "step", "name", "value"]
    assert rows_t == rows_j
    _, rows3 = _csv_rows(port_runs["3slot"]["log"])
    assert rows3 == [r for r in rows_j if "maestro" not in r[1]]
    # the list chip_smoke.py's phase 11 holds the card's run to
    assert list(dict.fromkeys(n for _, n in rows_j)) == _chip_smoke().RECIPE_NAMES
    assert json.loads((port_runs["2024"]["log"] / "hparams.json").read_text()) == json.loads(
        (jax_run_2024 / "hparams.json").read_text())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_run_writes_best_last_and_uses_the_device_store(port_runs, layout):
    run = port_runs[layout]
    log, results = run["log"], run["results"]
    for name in ("best", "last", "best.meta.json", "last.meta.json", "manager.json"):
        assert (log / "checkpoints" / name).exists(), name
    assert json.loads((log / "checkpoints" / "last.meta.json").read_text())["epoch"] == 1
    assert run["info"]["cache"] is not None  # every clip fits: the store is on
    loop = run["info"]["loop"]
    assert [h["steps"] for h in loop.history] == [run["info"]["batcher"].steps_per_epoch] * 2
    best = json.loads((log / "checkpoints" / "best.meta.json").read_text())
    assert run["state"].step == (best["epoch"] + 1) * loop.history[0]["steps"]  # best restored
    rep = json.loads((log / "energy_train.json").read_text())
    assert rep["device_watts"] == 50.0 and rep["busy_s"] > 0
    figs = log / "figures"
    assert (figs / "PSDS_scenario1_roc.png").exists()  # matplotlib is here
    assert len(list((figs / "predictions_dtc0.7_gtc0.7_cttc0.3").glob("*.tsv"))) == 2
    for k in ("psds1", "psds2", "intersection_f1_macro", "event_f1_macro"):
        assert 0.0 <= results[k] <= 1.0


def test_test_from_checkpoint_and_the_eval_dump(corpus, port_runs, tmp_path):
    run = port_runs["3slot"]
    config = make_config(corpus)
    _, again = tsr.single_run(config, str(tmp_path / "test"), fast_dev_run=True, fast=False,
                              test_from_checkpoint=str(run["log"] / "checkpoints"),
                              device="cpu")
    for k, v in run["results"].items():
        if isinstance(v, float):
            assert again[k] == v or (np.isnan(v) and np.isnan(again[k])), k
    assert not (tmp_path / "test" / "checkpoints" / "last").exists()
    config["data"]["eval_folder"] = str(corpus / "eval")
    _, none = tsr.single_run(config, str(tmp_path / "eval"), fast_dev_run=True, fast=False,
                             test_from_checkpoint=str(run["log"] / "checkpoints"),
                             evaluation=True, device="cpu")
    assert none is None
    for kind in ("raw", "postprocessed"):
        files = sorted((tmp_path / "eval" / "eval_scores" / "student" / kind).glob("*.tsv"))
        assert [f.name for f in files] == ["e0.tsv", "e1.tsv", "e2.tsv"]
        with open(files[0]) as f:
            rows = list(csv.reader(f, delimiter="\t"))
        enc = tsr.build_encoder(config)
        assert rows[0] == ["onset", "offset", *enc.labels]
        assert len(rows) - 1 == enc.n_frames


def test_strong_real_composition_matches_jax(corpus):
    config = make_config(corpus)
    config["data"]["strong_folder"] = str(corpus / "synth")
    config["data"]["strong_tsv"] = str(corpus / "meta" / "synth.tsv")
    for batch, strong_real in (([2, 2, 2], False), ([2, 2, 2], True), ([2, 2, 2, 2], False)):
        config["training"]["batch_size"] = batch
        dj, _, sj = jsr.build_train_datasets(config, jsr.build_encoder(config), strong_real)
        dt, _, st = tsr.build_train_datasets(config, tsr.build_encoder(config), strong_real)
        assert [s.name for s in st] == [s.name for s in sj]
        assert {k: len(v) for k, v in dt.items() if not k.startswith("_m")} == {
            k: len(v) for k, v in dj.items() if not k.startswith("_m")}
        assert type(dt["synth"]).__name__ == type(dj["synth"]).__name__


def _flags(cli, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        cli.train_cli("x", "conf.yaml", "exp", argv=["--help"], **kw)
    return sorted(w for w in out.getvalue().split() if w.startswith("--"))


@pytest.mark.parametrize("strong_real", [False, True])
def test_train_cli_flags_match_jax(strong_real):
    assert _flags(tcli, strong_real=strong_real) == _flags(jcli, strong_real=strong_real)


def test_recipe_entry_point_defaults_to_the_2024_conf():
    assert recipe.DEFAULT_CONF.is_file()
    assert recipe.DEFAULT_CONF == ROOT / "recipes/dcase2024_task4_baseline/confs/pretrained.yaml"
    with pytest.raises(SystemExit) as e:
        recipe.main(["--help"])
    assert e.value.code == 0


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_recipe_config_equals_the_yaml(tmp_path):
    want = yaml.safe_load(recipe.DEFAULT_CONF.read_text())
    got = _chip_smoke().year_config(recipe.DEFAULT_CONF, tmp_path)
    assert got.keys() == want.keys()
    for section in want:
        if section == "data":
            assert got["data"].keys() <= want["data"].keys() | {"real_maestro_val_dur"}
            for k in ("audio_max_len", "fs", "net_subsample"):
                assert got["data"][k] == want["data"][k], k
            continue
        if section == "pretrained":
            assert {k: v for k, v in got[section].items()
                    if k != "extracted_embeddings_dir"} == {
                k: v for k, v in want[section].items() if k != "extracted_embeddings_dir"}
            continue
        assert got[section] == want[section], section


BLOCKED = ("pandas", "matplotlib", "yaml", "h5py", "tensorboardX")


def test_single_run_without_pandas_matplotlib_yaml_h5py_tensorboardx(corpus, tmp_path):
    config = config_2024(corpus)
    (tmp_path / "config.json").write_text(json.dumps(config))
    code = (
        "import json, sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "from desed_task_tpu_torch.training.single_run import single_run\n"
        f"config = json.load(open({str(tmp_path / 'config.json')!r}))\n"
        f"state, res = single_run(config, {str(tmp_path / 'exp')!r}, fast_dev_run=True,"
        " fast=False, device='cpu')\n"
        "print('psds1', res['psds1'])\n"
        f"bad = [m for m in {BLOCKED!r} if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "run_test: the two PSD-ROC plots were not written" in proc.stdout
    assert "psds1" in proc.stdout
    figs = tmp_path / "exp" / "figures"
    assert not (figs / "PSDS_scenario1_roc.png").exists()
    assert len(list((figs / "predictions_dtc0.1_gtc0.1_cttc0.3").glob("*.tsv"))) == 2
    assert (tmp_path / "exp" / "checkpoints" / "best").exists()
