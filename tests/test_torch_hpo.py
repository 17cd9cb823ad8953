"""The port's HPO harness against desed_task_tpu.tools.hpo: the seeded
random search gives JAX's trial parameters and records (train and eval
spaces), a resumed study runs only the missing trials, two spawned CPU
workers claim disjoint trials (each trial's parameters those of its index,
as JAX's workers draw them) and are pinned through CUDA_VISIBLE_DEVICES
alone, a failing worker fails the study, the optuna branch through a fake
optuna (the fixture idea of tests/test_optional_deps.py, copied), and the
2024 optuna entry point on the recipe's test corpus on the CPU."""

import json
import random
import sys
import types

import numpy as np
import pytest

from desed_task_tpu.tools import hpo as jhpo
from desed_task_tpu_torch.tools import hpo

CONFIG = {
    "training": {"gradient_clip": 5.0, "n_epochs_warmup": 50},
    "opt": {"lr": 1e-3},
    "net": {"dropout": 0.5, "dropstep_recurrent": 0.0, "dropstep_recurrent_len": 5,
            "n_RNN_cell": 128, "rnn_layers": 2, "median_filter": [7, 7, 7]},
}


def toy_objective(cfg):
    return -abs(cfg["opt"]["lr"] - 0.002) - 0.01 * cfg["net"]["dropout"]


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines() if line]


@pytest.mark.parametrize("seed", [0, 42, 1234])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_random_search_matches_jax(tmp_path, seed, mode):
    obj = toy_objective if mode == "train" else (lambda c: -sum(c["net"]["median_filter"]))
    ours = hpo.run_study(CONFIG, obj, 6, tmp_path / "a", mode=mode, seed=seed)
    theirs = jhpo.run_study(CONFIG, obj, 6, tmp_path / "b", mode=mode, seed=seed)
    assert ours == theirs
    assert (_records(tmp_path / "a" / f"study_{mode}.jsonl")
            == _records(tmp_path / "b" / f"study_{mode}.jsonl"))
    assert (json.loads((tmp_path / "a" / f"best_{mode}.json").read_text())
            == json.loads((tmp_path / "b" / f"best_{mode}.json").read_text()))


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("seed", [3, 77])
def test_samplers_match_jax(mode, seed):
    fn, jfn = ((hpo.sample_params_train, jhpo.sample_params_train) if mode == "train"
               else (hpo.sample_params_eval, jhpo.sample_params_eval))
    a, b = hpo._RandomSuggest(random.Random(seed)), jhpo._RandomSuggest(random.Random(seed))
    assert fn(CONFIG, a) == jfn(CONFIG, b) and a.params == b.params
    assert CONFIG["opt"]["lr"] == 1e-3  # the base config is not changed


def test_resumed_study_runs_only_missing_trials(tmp_path):
    calls = []

    def obj(cfg):
        calls.append(cfg)
        return toy_objective(cfg)

    hpo.run_study(CONFIG, obj, 3, tmp_path, seed=5)
    best = hpo.run_study(CONFIG, obj, 5, tmp_path, seed=5)
    jbest = jhpo.run_study(CONFIG, toy_objective, 3, tmp_path / "j", seed=5)
    jbest = jhpo.run_study(CONFIG, toy_objective, 5, tmp_path / "j", seed=5)
    assert len(calls) == 5 and len(_records(tmp_path / "study_train.jsonl")) == 5
    assert best == jbest


WORKER_OBJECTIVE = '''
import json, os
from pathlib import Path

def objective(cfg):
    out = Path(os.environ["HPO_TEST_OUT"])
    name = "worker%s_%d.json" % (os.environ["HPO_WORKER_INDEX"], os.getpid())
    env = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES", "TPU_VISIBLE_DEVICES")}
    (out / name).write_text(json.dumps(env))
    return -abs(cfg["opt"]["lr"] - 0.002)

def failing(cfg):
    raise RuntimeError("no card in this worker")
'''


@pytest.fixture
def objective_module(tmp_path, monkeypatch):
    (tmp_path / "mod").mkdir()
    (tmp_path / "mod" / "hpo_torch_obj.py").write_text(WORKER_OBJECTIVE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path / "mod"))
    monkeypatch.setenv("HPO_TEST_OUT", str(tmp_path))
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return tmp_path


def test_two_workers_claim_disjoint_trials(objective_module):
    tmp = objective_module
    best = hpo.run_study(CONFIG, None, 6, tmp / "study", n_workers=2, seed=11,
                         objective_spec="hpo_torch_obj:objective")
    recs = _records(tmp / "study" / "study_train.jsonl")
    assert sorted(r["trial"] for r in recs) == list(range(6))
    assert {r["worker"] for r in recs} <= {"0", "1"}
    for r in recs:  # each trial drawn from its index's seed, as JAX's workers draw it
        s = jhpo._RandomSuggest(random.Random(11 + r["trial"]))
        jhpo.sample_params_train(CONFIG, s)
        assert r["params"] == s.params
    assert best == max(recs, key=lambda r: r["value"])
    envs = [json.loads(p.read_text()) for p in tmp.glob("worker*.json")]
    assert envs and all(e["TPU_VISIBLE_DEVICES"] is None for e in envs)
    pins = {p.name.split("_")[0]: json.loads(p.read_text())["CUDA_VISIBLE_DEVICES"]
            for p in tmp.glob("worker*.json")}
    assert all(pins[f"worker{i}"] == str(i) for i in (0, 1) if f"worker{i}" in pins)


def test_worker_envs_pin_both_workers_to_one_card(objective_module):
    tmp = objective_module
    hpo.run_study(CONFIG, None, 2, tmp / "study", n_workers=2,
                  objective_spec="hpo_torch_obj:objective",
                  worker_envs=[{"CUDA_VISIBLE_DEVICES": "0"}] * 2)
    envs = [json.loads(p.read_text()) for p in tmp.glob("worker*.json")]
    assert envs and all(e["CUDA_VISIBLE_DEVICES"] == "0" for e in envs)


def test_a_failing_worker_fails_the_study(objective_module):
    tmp = objective_module
    with pytest.raises(RuntimeError, match="HPO workers failed"):
        hpo.run_study(CONFIG, None, 2, tmp / "study", n_workers=2,
                      objective_spec="hpo_torch_obj:failing")


def test_sharded_study_needs_an_objective_spec(tmp_path):
    with pytest.raises(ValueError, match="objective_spec"):
        hpo.run_study(CONFIG, toy_objective, 2, tmp_path, n_workers=2)


@pytest.fixture
def fake_optuna(monkeypatch):
    """Minimal optuna: create_study/load_if_exists + Trial suggest API."""
    optuna = types.ModuleType("optuna")
    calls = {"created": [], "optimized": []}

    class _Trial:
        def __init__(self, rng):
            self.params = {}
            self._rng = rng

        def suggest_float(self, name, low, high, step=None):
            v = float(self._rng.uniform(low, high))
            if step:
                v = low + round((v - low) / step) * step
            self.params[name] = v
            return v

        def suggest_int(self, name, low, high, step=1):
            v = int(self._rng.integers(low, high + 1))
            self.params[name] = v
            return v

        def suggest_categorical(self, name, choices):
            v = choices[int(self._rng.integers(0, len(choices)))]
            self.params[name] = v
            return v

    class _Study:
        def optimize(self, fn, n_trials=0):
            rng = np.random.default_rng(0)
            for _ in range(n_trials):
                calls["optimized"].append(fn(_Trial(rng)))

    def create_study(direction, storage=None, study_name=None, load_if_exists=False):
        calls["created"].append({"direction": direction, "storage": storage,
                                 "name": study_name, "load": load_if_exists})
        return _Study()

    optuna.create_study = create_study
    monkeypatch.setitem(sys.modules, "optuna", optuna)
    return calls


@pytest.mark.parametrize("done", [0, 1])
def test_optuna_branch_matches_jax(fake_optuna, tmp_path, done):
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        if done:
            (tmp_path / d / "study_train.jsonl").write_text(
                json.dumps({"params": {"lr": 1e-3}, "value": 0.5}) + "\n")
    ours = hpo.run_study(CONFIG, toy_objective, 3, tmp_path / "a")
    n_ours = len(fake_optuna["optimized"])
    theirs = jhpo.run_study(CONFIG, toy_objective, 3, tmp_path / "b")
    assert n_ours == 3 - done and len(fake_optuna["optimized"]) == 2 * n_ours
    assert ours == theirs
    assert fake_optuna["created"][0]["direction"] == "maximize"
    assert fake_optuna["created"][0]["storage"].endswith("optuna-sed.db")
    assert (_records(tmp_path / "a" / "study_train.jsonl")
            == _records(tmp_path / "b" / "study_train.jsonl"))


@pytest.fixture(scope="module")
def conf_file(tmp_path_factory):
    import yaml

    from _torch_recipe_corpus import make_config, write_corpus

    root = write_corpus(tmp_path_factory.mktemp("hpo_corpus"))
    path = root / "conf.yaml"
    config = make_config(root)
    config["net"]["median_filter"] = [3] * 10  # the eval space draws a window per class
    path.write_text(yaml.safe_dump(config))
    return path


def test_optuna_cli_on_the_cpu(conf_file, tmp_path, monkeypatch):
    from desed_task_tpu_torch.recipes import dcase2024_optuna_pretrained as cli
    from desed_task_tpu_torch.training import single_run as sr

    seen = []
    run = sr.single_run

    def spy(config, log_dir, **kw):
        state, results = run(config, log_dir, **kw)
        seen.append((log_dir, kw["device"], results))
        return state, results

    monkeypatch.setattr(sr, "single_run", spy)
    best = cli.main(["--conf_file", str(conf_file), "--log_dir", str(tmp_path / "hpo"),
                     "--n_trials", "1", "--mode", "eval", "--fast_dev_run"], device="cpu")
    (log_dir, device, results), = seen
    assert log_dir.endswith("trial_1") and device == "cpu"
    assert best["value"] == results["psds1"] + results["intersection_f1_macro"]
    assert len(best["params"]) == 10  # one median window per class


def test_optuna_cli_raises_without_a_card(conf_file, tmp_path, monkeypatch):
    import torch

    from desed_task_tpu_torch.recipes import dcase2024_optuna_pretrained as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--conf_file", str(conf_file), "--log_dir", str(tmp_path / "hpo"),
                  "--n_trials", "1", "--fast_dev_run"])
