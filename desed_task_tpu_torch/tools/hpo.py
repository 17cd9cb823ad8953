"""Hyperparameter optimization harness (counterpart of
desed_task_tpu/tools/hpo.py).

Replaces the reference's Optuna study (recipes/dcase2024_task4_baseline/
optuna_pretrained.py:70-213). Optuna is used when importable; otherwise a
seeded random-search fallback samples the same spaces. The two reference
search modes are reproduced:

  "train": gradient_clip / lr / dropout / dropstep / RNN size / layers /
           warmup (optuna_pretrained.py:70-96)
  "eval":  per-class median-filter window lengths 1..20 step 2
           (optuna_pretrained.py:99-109)

Results are appended to a jsonl study log so interrupted studies resume.

Study sharding (reference runs one Optuna worker process per visible GPU,
optuna_pretrained.py:179-204): `run_study(..., n_workers=N,
objective_spec="pkg.module:fn")` spawns N worker processes, each pinned to
one card through CUDA_VISIBLE_DEVICES (the worker's index by default;
`worker_envs` may pin several workers to one card). A worker trains where
its objective puts it: the recipe's objective (recipes/
dcase2024_optuna_pretrained.py) runs single_run on the card and raises in
a worker that sees none, which fails the study. Workers coordinate
through the shared study directory: trial indices are claimed atomically
(O_EXCL lock + counter), each trial's sampler is seeded by its claimed
index, so the union of trials is deterministic regardless of which worker
ran which trial. Workers always draw with the seeded random sampler (as
JAX's do); optuna drives the single-process study where it imports.
"""

from __future__ import annotations

import copy
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable


def sample_params_train(config: dict, suggest) -> dict:
    config = copy.deepcopy(config)
    config["training"]["gradient_clip"] = suggest.categorical(
        "gradient_clip", [0.0, 1.0, 5.0, 0.5]
    )
    config["opt"]["lr"] = suggest.float("lr", 0.0001, 0.005, step=0.0005)
    config["net"]["dropout"] = suggest.float("dropout", 0.1, 0.5, step=0.1)
    config["net"]["dropstep_recurrent"] = suggest.float(
        "dropout_recurrent", 0.0, 0.5, step=0.1
    )
    config["net"]["dropstep_recurrent_len"] = suggest.int(
        "dropstep_recurrent_len", 1, 20, step=3
    )
    config["net"]["n_RNN_cell"] = suggest.categorical("n_RNN_cell", [128, 192, 256])
    config["net"]["rnn_layers"] = suggest.categorical("rnn_layers", [1, 2])
    config["training"]["n_epochs_warmup"] = suggest.categorical(
        "n_epochs_warmup", [50, 100]
    )
    return config


def sample_params_eval(config: dict, suggest) -> dict:
    config = copy.deepcopy(config)
    n = len(config["net"]["median_filter"])
    config["net"]["median_filter"] = [
        suggest.int(f"median_filt_cls_{i}", 1, 20, step=2) for i in range(n)
    ]
    return config


class _RandomSuggest:
    """Random sampler with the optuna.Trial suggest API shape."""

    def __init__(self, rng: random.Random):
        self.rng = rng
        self.params: dict = {}

    def categorical(self, name, choices):
        v = self.rng.choice(choices)
        self.params[name] = v
        return v

    def float(self, name, low, high, step=None):
        if step:
            n = int(round((high - low) / step))
            v = low + self.rng.randint(0, n) * step
        else:
            v = self.rng.uniform(low, high)
        self.params[name] = v
        return v

    def int(self, name, low, high, step=1):
        v = self.rng.randrange(low, high + 1, step)
        self.params[name] = v
        return v


class _OptunaSuggest:
    def __init__(self, trial):
        self.trial = trial
        self.params = {}

    def categorical(self, name, choices):
        v = self.trial.suggest_categorical(name, choices)
        self.params[name] = v
        return v

    def float(self, name, low, high, step=None):
        v = self.trial.suggest_float(name, low, high, step=step)
        self.params[name] = v
        return v

    def int(self, name, low, high, step=1):
        v = self.trial.suggest_int(name, low, high, step=step)
        self.params[name] = v
        return v


class _StudyLock:
    """Cross-process mutex via an O_CREAT|O_EXCL lock file."""

    def __init__(self, path: Path):
        self.path = path

    def __enter__(self):
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
                return self
            except FileExistsError:
                time.sleep(0.01)

    def __exit__(self, *exc):
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def _claim_trial(log_path: Path, mode: str, n_trials: int) -> int | None:
    """Atomically claim the next trial index; None when the study is full."""
    counter = log_path / f"counter_{mode}"
    with _StudyLock(log_path / f".lock_{mode}"):
        idx = int(counter.read_text()) if counter.exists() else 0
        if idx >= n_trials:
            return None
        counter.write_text(str(idx + 1))
        return idx


def _append_record(log_path: Path, mode: str, rec: dict) -> None:
    with _StudyLock(log_path / f".lock_{mode}"):
        with open(log_path / f"study_{mode}.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")


def _resolve_objective(spec: str) -> Callable[[dict], float]:
    """Import "pkg.module:fn" -> callable (worker processes re-import it)."""
    import importlib

    module, _, fn = spec.partition(":")
    return getattr(importlib.import_module(module), fn)


def run_worker(
    config: dict,
    objective_fn: Callable[[dict], float],
    n_trials: int,
    log_dir: str,
    mode: str = "train",
    seed: int = 42,
) -> None:
    """One study worker: claim trial indices until the study is full."""
    sampler_fn = sample_params_train if mode == "train" else sample_params_eval
    log_path = Path(log_dir)
    log_path.mkdir(parents=True, exist_ok=True)
    while True:
        idx = _claim_trial(log_path, mode, n_trials)
        if idx is None:
            return
        suggest = _RandomSuggest(random.Random(seed + idx))
        trial_config = sampler_fn(config, suggest)
        value = float(objective_fn(trial_config))
        _append_record(
            log_path, mode,
            {"trial": idx, "params": suggest.params, "value": value,
             "worker": os.environ.get("HPO_WORKER_INDEX", "0")},
        )


def _spawn_workers(
    config: dict, objective_spec: str, n_trials: int, log_dir: str,
    mode: str, seed: int, n_workers: int, worker_envs: list | None,
) -> None:
    """One process per card, reference optuna_pretrained.py:179-204.

    Default pinning exposes card i to worker i (CUDA_VISIBLE_DEVICES); pass
    explicit `worker_envs` dicts to pin otherwise (several workers to one
    card, say).
    """
    cfg_file = Path(log_dir) / "hpo_config.json"
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    cfg_file.write_text(json.dumps(config))
    code = (
        "import json,sys;"
        "from desed_task_tpu_torch.tools.hpo import run_worker,_resolve_objective;"
        "cfg=json.load(open(sys.argv[1]));"
        "run_worker(cfg,_resolve_objective(sys.argv[2]),int(sys.argv[3]),"
        "sys.argv[4],sys.argv[5],int(sys.argv[6]))"
    )
    # the workers import this package from the tree it was imported from
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for i in range(n_workers):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        env["HPO_WORKER_INDEX"] = str(i)
        env.setdefault("CUDA_VISIBLE_DEVICES", str(i))
        if worker_envs is not None:
            env.update(worker_envs[i])
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(cfg_file), objective_spec,
             str(n_trials), str(log_dir), mode, str(seed)],
            env=env,
        ))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"HPO workers failed with return codes {rcs}")


def run_study(
    config: dict,
    objective_fn: Callable[[dict], float] | None,
    n_trials: int,
    log_dir: str,
    mode: str = "train",
    seed: int = 42,
    n_workers: int = 1,
    objective_spec: str | None = None,
    worker_envs: list | None = None,
) -> dict:
    """Maximize objective_fn(config). Returns the best trial record.

    n_workers > 1 shards the study over worker processes (one card
    each); the objective must then be importable via `objective_spec`
    ("pkg.module:fn") since it runs in fresh processes."""
    log_path = Path(log_dir)
    if n_workers > 1:
        if objective_spec is None:
            raise ValueError("sharded studies need objective_spec='module:fn'")
        _spawn_workers(config, objective_spec, n_trials, log_dir, mode, seed,
                       n_workers, worker_envs)
        records = [
            json.loads(l)
            for l in (log_path / f"study_{mode}.jsonl").read_text().splitlines()
            if l
        ]
        best = max(records, key=lambda r: r["value"]) if records else None
        if best:
            (log_path / f"best_{mode}.json").write_text(json.dumps(best, indent=2))
        return best
    return _run_study_local(config, objective_fn, n_trials, log_dir, mode, seed)


def _run_study_local(
    config: dict,
    objective_fn: Callable[[dict], float],
    n_trials: int,
    log_dir: str,
    mode: str = "train",
    seed: int = 42,
) -> dict:
    """Single-process study (optuna when importable, else random search)."""
    sampler_fn = sample_params_train if mode == "train" else sample_params_eval
    log_path = Path(log_dir)
    log_path.mkdir(parents=True, exist_ok=True)
    study_log = log_path / f"study_{mode}.jsonl"
    done = []
    if study_log.exists():
        done = [json.loads(l) for l in study_log.read_text().splitlines() if l]

    try:
        import optuna  # noqa

        have_optuna = True
    except ImportError:
        have_optuna = False

    records = list(done)

    def run_one(suggest) -> float:
        trial_config = sampler_fn(config, suggest)
        value = float(objective_fn(trial_config))
        rec = {"params": suggest.params, "value": value}
        records.append(rec)
        with open(study_log, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return value

    if have_optuna:
        import optuna

        study = optuna.create_study(
            direction="maximize",
            storage=f"sqlite:///{log_path}/optuna-sed.db",
            study_name=f"sed-{mode}",
            load_if_exists=True,
        )
        study.optimize(
            lambda t: run_one(_OptunaSuggest(t)),
            n_trials=max(0, n_trials - len(done)),
        )
    else:
        rng = random.Random(seed + len(done))
        for _ in range(max(0, n_trials - len(done))):
            run_one(_RandomSuggest(rng))

    best = max(records, key=lambda r: r["value"]) if records else None
    if best:
        (log_path / f"best_{mode}.json").write_text(json.dumps(best, indent=2))
    return best
