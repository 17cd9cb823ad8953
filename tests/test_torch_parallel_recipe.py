"""The 2024 recipe's engine (`single_run`) on two gloo ranks on the CPU,
over the 3-slot corpus of tests/test_torch_single_run.py (slots [2, 2, 2]:
one clip of each a rank), fast_dev_run in fp32, both ranks in one log
directory: the group the launcher joined becomes a data mesh of two, the
step is make_train_step_sharded, validation and test run from eval caches
row-sharded over the two ranks.

Checked: both replicas bitwise equal at the end; rank 0 alone logs (one
row a scalar a step in metrics.csv), bills the energy of 2 devices, writes
the checkpoints and gets the test results; the last checkpoint holds both
ranks' generator states and reloads bitwise; a second run resumes from it
on both ranks, each with its own generator state; with the eval sets left
on the host (device_cache_eval: false) every rank scores the test set but
rank 0 alone writes its figures and gets its results; a slot size that the
two ranks do not divide raises.
"""

import csv
import json
from pathlib import Path

import pytest
import torch

from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
from desed_task_tpu_torch.parallel.launch import spawn_ranks

import _torch_parallel_ranks as ranks
from _torch_recipe_corpus import make_config, write_corpus

DEADLINE = 120


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("parallel_corpus"))


@pytest.fixture(scope="module")
def run(corpus, tmp_path_factory):
    log = tmp_path_factory.mktemp("parallel_run")
    out = spawn_ranks(ranks.recipe_rank, 2, args=(make_config(corpus), str(log), True),
                      timeout_s=DEADLINE)
    return log, out


def test_replicas_are_bitwise_equal(run):
    _, ((a, _), (b, _)) = run
    assert a["mesh_shape"] == {"data": 2} and a["step"] == b["step"] > 0  # the best's step
    for key in ("student", "teacher"):
        assert all(torch.equal(v, b[key][k]) for k, v in a[key].items()), key
    assert all(torch.equal(x, y) for x, y in zip(a["moments"], b["moments"]))
    assert a["epochs"] == b["epochs"] == [0, 1]


def test_first_rank_alone_logs_bills_and_tests(run):
    log, ((a, _), (b, _)) = run
    assert a["logs"] and not b["logs"]
    assert a["n_devices"] == 2 and b["n_devices"] is None
    assert json.loads((log / "energy_train.json").read_text())["n_devices"] == 2
    assert b["results"] is None and a["results"] is not None
    assert all(0.0 <= a["results"][k] <= 1.0 for k in ("psds1", "psds2"))
    with open(log / "metrics.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["time", "step", "name", "value"]
    epochs = [r for r in rows[1:] if r[2] == "train/epoch"]
    # the first run's 2 epochs and none from the resumed run, once each
    assert [r[3] for r in epochs] == ["0.0", "1.0"]
    assert sorted(p.name for p in (log / "checkpoints").iterdir()) == [
        "best", "best.meta.json", "last", "last.meta.json", "manager.json"]


def test_checkpoint_holds_each_rank_and_reloads_bitwise(run):
    log, ((a, resumed_a), (b, resumed_b)) = run
    mgr = CheckpointManager(Path(log) / "checkpoints")
    last = mgr.load("last")
    gens = last["rank_generators"]
    assert len(gens) == 2 and not torch.equal(gens[0], gens[1])
    assert torch.equal(gens[0], a["generator"]) and torch.equal(gens[1], b["generator"])
    best = mgr.load("best")  # single_run ends on the best checkpoint's weights
    assert all(torch.equal(v, a["student"][k]) for k, v in best["student"].items())
    assert all(torch.equal(v, a["teacher"][k]) for k, v in best["teacher"].items())
    # the resumed run: every rank restored its own generator and trained no epoch
    assert resumed_a["start_epoch"] == resumed_b["start_epoch"] == 2
    assert resumed_a["epochs"] == resumed_b["epochs"] == []
    assert torch.equal(resumed_a["generator"], gens[0])
    assert torch.equal(resumed_b["generator"], gens[1])
    assert all(torch.equal(v, resumed_b["student"][k]) for k, v in a["student"].items())


def test_unsharded_test_set_is_written_by_the_first_rank_alone(corpus, tmp_path):
    config = make_config(corpus)
    config["training"]["device_cache_eval"] = False
    log = tmp_path / "unsharded"
    a, b = spawn_ranks(ranks.unsharded_test_rank, 2, args=(config, str(log)),
                       timeout_s=DEADLINE)
    assert a["save_dirs"] == [str(log / "figures")] and b["save_dirs"] == [None]
    assert b["results"] is None and a["results"] is not None
    assert all(0.0 <= a["results"][k] <= 1.0 for k in ("psds1", "psds2"))


def test_slot_not_divisible_by_the_ranks_raises(corpus, tmp_path):
    config = make_config(corpus)
    config["training"]["batch_size"] = [2, 3, 2]
    with pytest.raises(RuntimeError, match=r"ValueError: slot sizes \{'weak': 3\}"):
        spawn_ranks(ranks.recipe_rank, 2, args=(config, str(tmp_path / "odd")),
                    timeout_s=DEADLINE)


def test_save_and_resume_on_a_mesh_with_a_model_axis(tmp_path):
    """{"data": 2, "model": 2}: the checkpoint holds all four ranks' generator
    states in global rank order, and every rank gets its own back."""
    out = spawn_ranks(ranks.save_resume_rank, 4, args=(str(tmp_path / "ckpt"),),
                      timeout_s=DEADLINE)
    assert [o["index"] for o in out] == [{"data": d, "model": m}
                                         for d in (0, 1) for m in (0, 1)]
    for o in out:
        assert o["resumed"] and o["start_epoch"] == 1 and o["n_states"] == 4
        assert torch.equal(o["restored"], o["saved"])
    assert all(not torch.equal(a["saved"], b["saved"])
               for i, a in enumerate(out) for b in out[i + 1:])
