"""The port's TrainLoop (training/loop.py) against JAX's.

* Two epochs of the real step over the same batcher streams and initial
  weights, randomness at 0 (the narrow CRNN and 3 slots of
  tests/test_torch_train_step.py): the final student and teacher within
  the train step's tolerances (parameters 5e-7, BN statistics 2e-5).
* With stub steps: the same checkpoint cadence (which epochs write `last`
  and `best`), early stopping at the same epoch, the same metrics.csv
  names.
* The port alone, with dropout and mixup on: two epochs straight bitwise
  equal to one epoch, `resume` from `last` into a fresh state and
  generator, then one more epoch; the generator's state is what is tested.
* The watchdog with a stub probe, as tests/test_watchdog.py.
"""

import csv
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.obs.logging import MetricsLogger as JLogger
from desed_task_tpu.ops import pallas_gru
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu.training.loop import TrainLoop as JLoop
from desed_task_tpu_torch.data.batcher import MultiSourceBatcher
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
from desed_task_tpu_torch.obs.logging import MetricsLogger
from desed_task_tpu_torch.obs.watchdog import StallWatchdog
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, create_state, make_optimizer, make_train_step)
from desed_task_tpu_torch.training.loop import TrainLoop
from test_torch_train_step import (
    CFG, E, LR, N_CLASS, N_MELS, N_SAMPLES, NET, RAMPUP, TE, _is_conv_bias, _perturbed)

N_ITEMS = 2  # per slot: 1 step an epoch at 2 a slot, 2 steps in all, as the step test


class _Items:
    """A seeded in-memory slot: the item layout of data/datasets.py."""

    def __init__(self, seed):
        r = np.random.default_rng(seed)
        self.items = []
        for i in range(N_ITEMS):
            cm = np.ones(N_CLASS, bool)
            cm[(seed + i) % N_CLASS] = i % 2 == 0
            self.items.append({
                "audio": (r.standard_normal(N_SAMPLES) * 0.1).astype(np.float32),
                "labels": (r.random((N_CLASS, 8)) > 0.6).astype(np.float32),
                "embeddings": r.standard_normal((E, TE)).astype(np.float32),
                "class_mask": cm,
            })

    def __len__(self):
        return N_ITEMS

    def __getitem__(self, i):
        return self.items[i]


def _batcher(seed=11):
    ds = {s.name: _Items(i) for i, s in enumerate(CFG["slots"])}
    return MultiSourceBatcher(ds, {s.name: s.size for s in CFG["slots"]}, seed=seed,
                              num_workers=1)


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop_jax")
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    try:
        cfg_j = jmt.MeanTeacherConfig(**{**CFG, "slots": tuple(
            jmt.SlotSpec(s.name, s.size, s.role) for s in CFG["slots"])})
        model_j = JaxCRNN(**NET, fused_blocks="interpret", rnn_pallas=True)
        tx, sched = jmt.make_optimizer(LR, RAMPUP)
        mel_j = JaxMel(n_mels=N_MELS)
        sample = next(iter(_batcher().epoch(steps=1)))
        state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), sample, mel_cfg=mel_j)
        params = _perturbed(state.student_params, 1)
        stats = jax.device_get(state.student_stats)
        state = state.replace(student_params=params, teacher_params=params,
                              student_stats=stats, teacher_stats=stats,
                              opt_state=tx.init(params))
        step_j = jax.jit(jmt.make_train_step(model_j, cfg_j, tx, sched, mel_cfg=mel_j))
        loop_j = JLoop(step_j, state, _batcher(), n_epochs=2, logger=JLogger(tmp / "j"),
                       rng=jax.random.key(3))
        final = loop_j.run()
        jax_sd = {"student": from_jax_params(jax.device_get(final.student_params),
                                             jax.device_get(final.student_stats)),
                  "teacher": from_jax_params(jax.device_get(final.teacher_params),
                                             jax.device_get(final.teacher_stats))}
    finally:
        pallas_gru.INTERPRET = old

    model = CRNN(n_mels=N_MELS, **NET)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched_t = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched_t,
                           mel_cfg=MelConfig(n_mels=N_MELS))
    TrainLoop(step, st, _batcher(), n_epochs=2, logger=MetricsLogger(tmp / "t"),
              rng=torch.Generator().manual_seed(3)).run()
    return jax_sd, st, init


@pytest.mark.parametrize("who", ["student", "teacher"])
def test_two_epochs_match_jax(two_epochs, who):
    jax_sd, st, init = two_epochs
    assert st.step == 2
    want_sd, got_sd = jax_sd[who], getattr(st, who).state_dict()
    assert set(got_sd) == set(want_sd)
    lr0 = LR * np.exp(-5.0)  # schedule(0)
    for name, want in want_sd.items():
        got = got_sd[name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=name)
        elif _is_conv_bias(name):
            # noise gradients: each Adam step moves a bias by at most its lr
            assert float((got - init[name]).abs().max()) <= 4 * lr0 * 2, name
            assert float((want - init[name]).abs().max()) <= 4 * lr0 * 2, name
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=5e-7, msg=name)


# --- the loop's control flow, with stub steps --------------------------------

class _Record:
    """A checkpoint manager that records which epochs write what."""

    def __init__(self):
        self.events, self.best = [], None

    def save(self, state, metadata=None, name="last", **_):
        self.events.append((name, metadata["epoch"]))

    def save_if_best(self, state, score, metadata=None, **_):
        if self.best is None or score > self.best:
            self.best = score
            self.events.append(("best", metadata["epoch"]))
            return True
        return False

    def exists(self, name="last"):
        return False


class _Steps:
    steps_per_epoch = 3

    def epoch(self):
        for _ in range(3):
            yield {"x": np.zeros(2, np.float32)}


def _jax_step(state, batch, rng):
    return state, {"loss": jnp.float32(0.5), "lr": jnp.float32(1e-3)}


def _torch_step(state, batch, generator):
    return {"loss": torch.tensor(0.5), "lr": torch.tensor(1e-3)}


def _objectives(values):
    it = iter(values)
    return lambda state, epoch: (next(it), {"val/x": 1.0})


CADENCES = [
    dict(n_epochs=6, validation_interval=1, checkpoint_interval=None, patience=None,
         objs=[0.1, 0.3, 0.2, 0.4, 0.4, 0.1]),
    dict(n_epochs=7, validation_interval=2, checkpoint_interval=3, patience=None,
         objs=[0.5, 0.2, 0.6]),
    dict(n_epochs=9, validation_interval=1, checkpoint_interval=4, patience=2,
         objs=[0.5, 0.6, 0.55, 0.58, 0.7, 0.1, 0.1, 0.1, 0.1]),
    dict(n_epochs=4, validation_interval=1, checkpoint_interval=None, patience=None,
         objs=None),
]


@pytest.mark.parametrize("case", range(len(CADENCES)))
def test_checkpoint_cadence_early_stop_and_csv_names_match_jax(tmp_path, case):
    c = CADENCES[case]
    runs = {}
    for side in ("jax", "torch"):
        rec = _Record()
        logger = (JLogger if side == "jax" else MetricsLogger)(tmp_path / side)
        kw = dict(n_epochs=c["n_epochs"], logger=logger, ckpt=rec,
                  validate_fn=None if c["objs"] is None else _objectives(c["objs"]),
                  validation_interval=c["validation_interval"],
                  early_stop_patience=c["patience"], log_every=2,
                  checkpoint_interval=c["checkpoint_interval"])
        if side == "jax":
            JLoop(_jax_step, None, _Steps(), rng=jax.random.key(0), **kw).run()
        else:
            TrainLoop(_torch_step, None, _Steps(), rng=torch.Generator(), **kw).run()
        logger.close()
        with open(tmp_path / side / "metrics.csv") as f:
            rows = list(csv.reader(f))
        runs[side] = (rec.events, rows[0], [(r[1], r[2]) for r in rows[1:]])
    assert runs["torch"] == runs["jax"]


# --- resume ------------------------------------------------------------------

NET_RANDOM = {**NET, "dropout": 0.5, "dropstep_recurrent": 0.3, "dropstep_recurrent_len": 2}
CFG_RANDOM = {**CFG, "mixup": "soft", "mixup_prob": 1.0,
              "mixup_groups": (("weak",), ("strong",))}


def _port_run(tmp, n_epochs, batcher, seed, resume=False, init_seed=0):
    torch.manual_seed(init_seed)
    model = CRNN(n_mels=N_MELS, **NET_RANDOM)
    cfg = MeanTeacherConfig(**CFG_RANDOM)
    opt, sched = make_optimizer(LR, RAMPUP)
    st = create_state(model, cfg, opt, device="cpu")
    step = make_train_step(cfg, opt, sched, mel_cfg=MelConfig(n_mels=N_MELS))
    loop = TrainLoop(step, st, batcher, n_epochs=n_epochs, logger=MetricsLogger(tmp / "log"),
                     ckpt=CheckpointManager(tmp / "ckpt"), checkpoint_interval=1,
                     rng=torch.Generator().manual_seed(seed))
    if resume:
        assert loop.resume("last") and loop.start_epoch == 1
    loop.run()
    return st, loop.rng


def test_resume_equals_an_uninterrupted_run(tmp_path):
    straight, g_straight = _port_run(tmp_path / "a", 2, _batcher(), seed=5)
    batcher = _batcher()  # the data order carries on in the same batcher
    _port_run(tmp_path / "b", 1, batcher, seed=5)
    resumed, g_resumed = _port_run(tmp_path / "b", 2, batcher, seed=99, resume=True,
                                   init_seed=1)
    assert resumed.step == straight.step == 2
    for who in ("student", "teacher"):
        a, b = getattr(straight, who).state_dict(), getattr(resumed, who).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (who, k)
    for k in ("mu", "nu"):
        for x, y in zip(straight.opt_state[k], resumed.opt_state[k]):
            assert torch.equal(x, y), k
    assert straight.opt_state["count"] == resumed.opt_state["count"]
    assert torch.equal(g_straight.get_state(), g_resumed.get_state())
    # without the generator's state the resumed run differs
    lost, _ = _port_run(tmp_path / "c", 1, (b2 := _batcher()), seed=5)
    ckpt = CheckpointManager(tmp_path / "c" / "ckpt")
    torch.manual_seed(1)
    model = CRNN(n_mels=N_MELS, **NET_RANDOM)
    cfg = MeanTeacherConfig(**CFG_RANDOM)
    opt, sched = make_optimizer(LR, RAMPUP)
    st = ckpt.restore("last", create_state(model, cfg, opt, device="cpu"))
    loop = TrainLoop(make_train_step(cfg, opt, sched, mel_cfg=MelConfig(n_mels=N_MELS)), st, b2,
                     n_epochs=2, logger=MetricsLogger(tmp_path / "c" / "log2"),
                     rng=torch.Generator().manual_seed(5))
    loop.start_epoch = 1
    loop.run()
    assert not all(torch.equal(x, y) for x, y in zip(straight.student.state_dict().values(),
                                                      st.student.state_dict().values()))


# --- watchdog ----------------------------------------------------------------

def _stub_probe(tmp_path):
    marker = tmp_path / "probe_ran"
    return marker, [sys.executable, "-c", f"open({str(marker)!r}, 'a').write('x')"]


def _wait_for(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


def test_watchdog_stall_detected_and_probe_launched(tmp_path):
    marker, cmd = _stub_probe(tmp_path)
    wd = StallWatchdog(timeout_s=0.15, probe_interval_s=0.1, check_interval_s=0.03,
                       probe_cmd=cmd, enabled=True)
    wd.start()
    wd.arm()
    try:
        assert _wait_for(lambda: wd.stalls >= 1 and marker.exists())
        assert wd.probes_launched >= 1
        wd.beat()
        assert wd.stats()["stalled_seconds"] > 0
    finally:
        wd.stop()


def test_watchdog_quiet_while_beating_or_disarmed(tmp_path):
    marker, cmd = _stub_probe(tmp_path)
    wd = StallWatchdog(timeout_s=0.3, check_interval_s=0.03, probe_cmd=cmd, enabled=True)
    wd.start()
    wd.arm()
    try:
        for _ in range(10):
            time.sleep(0.05)
            wd.beat()
        wd.disarm()
        time.sleep(0.4)
        assert wd.stalls == 0 and not marker.exists()
    finally:
        wd.stop()
    off = StallWatchdog(enabled=False, timeout_s=0.01)
    off.start()
    assert off._thread is None
    assert StallWatchdog().enabled == torch.cuda.is_available()
    assert "cuda" in " ".join(StallWatchdog().probe_cmd) and "jax" not in " ".join(
        StallWatchdog().probe_cmd)


def test_train_loop_reports_watchdog_stats(tmp_path):
    marker, cmd = _stub_probe(tmp_path)
    wd = StallWatchdog(timeout_s=0.1, probe_interval_s=0.05, check_interval_s=0.02,
                       probe_cmd=cmd, enabled=True)

    def slow_step(state, batch, generator):
        time.sleep(0.3)  # a heartbeat gap longer than the timeout each step
        return {"loss": torch.tensor(0.5)}

    logger = MetricsLogger(tmp_path / "log")
    TrainLoop(slow_step, None, _Steps(), n_epochs=1, logger=logger, rng=torch.Generator(),
              watchdog=wd).run()
    assert wd.stalls >= 1
    assert _wait_for(marker.exists, timeout=10.0)
    assert "train/watchdog_stalls" in (tmp_path / "log" / "metrics.csv").read_text()
