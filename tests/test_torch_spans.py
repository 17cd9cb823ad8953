"""The program's spans (obs/profiling.span) on the CPU: a small train step
through the device store and an eval pass over a DeviceEvalCache, under
torch.profiler, record every span, each inside the one it belongs to; with
no profiler `span()` is one shared no-op; and the step's metrics and
state, and the pass's scores, are bitwise the same with the profiler on
and off."""

import contextlib
import json

import numpy as np
import pytest
import torch

from desed_task_tpu_torch.data.device_cache import DeviceEvalCache, DeviceResidentData
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.obs.profiling import SPAN_PREFIX, span
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, create_state, make_optimizer, make_train_step)
from desed_task_tpu_torch.training.evaluate import _predict_cache_all
from desed_task_tpu_torch.training.mean_teacher import make_predict_step

N_MELS, N_CLASS, E, TE, N_SAMPLES, FRAMES = 32, 3, 12, 17, 8000, 8
NET = dict(
    nclass=N_CLASS, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 2]], dropout=0.5,
    dropstep_recurrent=0.0, specaugm_t_p=0.0, specaugm_f_p=0.0, use_embeddings=True,
    embedding_size=E, aggregation_type="pool1d",
)
SLOTS = (SlotSpec("strong", 2, "strong"), SlotSpec("weak", 2, "weak"),
         SlotSpec("unlabeled", 2, "unlabeled"))
CFG = MeanTeacherConfig(slots=SLOTS, mixup="soft", mixup_prob=1.0,
                        mixup_groups=(("weak", "unlabeled"),), consistency_start_slot=1,
                        rampup_steps=10)
STEPS = 2
# every span of a train step -> the span it runs inside
TRAIN_PARENT = {
    "step.augment": "step", "frontend.mel": "step", "frontend.db": "step",
    "step.teacher": "step", "step.student": "step", "step.loss": "step",
    "step.backward": "step", "step.optimizer": "step", "step.ema": "step",
    "frontend.scaler": ("step.teacher", "step.student"),
    "crnn.cnn": ("step.teacher", "step.student"),
    "crnn.embed": ("step.teacher", "step.student"),
    "crnn.rnn": ("step.teacher", "step.student"),
    "crnn.heads": ("step.teacher", "step.student"),
    "cnn.bwd": "step.backward", "rnn.bwd": "step.backward",
}
EVAL_PARENT = {
    "frontend.mel": "eval", "frontend.db": "eval", "frontend.scaler": "eval",
    "crnn.cnn": "eval", "crnn.embed": "eval", "crnn.rnn": "eval", "crnn.heads": "eval",
    "eval.median": "eval", "eval.copy": "eval",
}


def _model():
    torch.manual_seed(0)
    return CRNN(n_mels=N_MELS, **NET)


def _store():
    r = np.random.default_rng(0)
    rows = {s.name: 4 for s in SLOTS}
    n = sum(rows.values())
    host = {"audio": (r.standard_normal((n, N_SAMPLES)) * 3000).astype(np.int16),
            "labels": (r.random((n, N_CLASS, FRAMES)) > 0.6).astype(np.float32),
            "embeddings": r.standard_normal((n, E, TE)).astype(np.float32)}
    offsets = {"strong": 0, "weak": 4, "unlabeled": 8}
    masks = {s.name: np.ones(N_CLASS, bool) for s in SLOTS}
    store = DeviceResidentData([s.name for s in SLOTS], rows, host, offsets, masks, True,
                               "cpu")
    store.upload(verbose=False)
    return store


@contextlib.contextmanager
def _profiled(on: bool, path):
    """A CPU profiler over the block when `on`; the list it yields receives
    the trace's program spans (none when off)."""
    got = []
    if not on:
        yield got
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        yield got
    prof.export_chrome_trace(str(path))
    got.extend(e for e in json.loads(path.read_text())["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and e["name"].startswith(SPAN_PREFIX))


def _train(tmp_path, on: bool):
    opt, sched = make_optimizer(1e-3, 10)
    state = create_state(_model(), CFG, opt, device="cpu")
    step = make_train_step(CFG, opt, sched, mel_cfg=MelConfig(n_mels=N_MELS))
    store = _store()
    build = store.batch_builder({s.name: s.size for s in SLOTS})
    gen = torch.Generator().manual_seed(3)
    metrics = []
    with _profiled(on, tmp_path / "train.json") as events:
        for i in range(STEPS):
            rows = {s.name: np.array([i, i + 2]) for s in SLOTS}
            batch = build(store.stores, store.index_to_device(store.flat_index(rows)))
            metrics.append({k: v.detach().clone() for k, v in
                            step(state, batch, gen).items() if torch.is_tensor(v)})
    leaves = {**{f"s.{k}": v.clone() for k, v in state.student.state_dict().items()},
              **{f"t.{k}": v.clone() for k, v in state.teacher.state_dict().items()}}
    return metrics, leaves, events


def _eval(tmp_path, on: bool):
    r = np.random.default_rng(1)
    items = [{"audio": (r.standard_normal(N_SAMPLES) * 0.1).astype(np.float32),
              "embeddings": r.standard_normal((E, TE)).astype(np.float32),
              "labels": np.zeros((N_CLASS, FRAMES), np.float32)} for _ in range(6)]
    cache = DeviceEvalCache(items, 4, num_workers=1, device="cpu")
    cache.upload()
    model = _model().eval()
    with _profiled(on, tmp_path / "eval.json") as events:
        got = _predict_cache_all(make_predict_step(MelConfig(n_mels=N_MELS)), model, cache,
                                 None, [3] * N_CLASS, want_raw=False)
    return got, events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    return {"train": (_train(tmp, True), _train(tmp, False)),
            "eval": (_eval(tmp, True), _eval(tmp, False))}


def _holds(outer: dict, inner: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _check_nesting(events, name, parents) -> list:
    """The spans `name`, each held by a span of `parents`."""
    parents = (parents,) if isinstance(parents, str) else parents
    mine = [e for e in events if e["name"] == SPAN_PREFIX + name]
    assert mine, f"no {SPAN_PREFIX}{name} span"
    outer = [e for e in events if e["name"] in {SPAN_PREFIX + p for p in parents}]
    for e in mine:
        assert any(_holds(o, e) for o in outer), f"{e['name']} outside {parents}"
    return mine


def test_span_with_no_profiler_is_one_shared_noop():
    a, b = span("step"), span("frontend.mel")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a as got:
        assert got is None


def test_span_under_a_profiler_is_a_record_function():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s = span("step")
        assert isinstance(s, torch.profiler.record_function)
        assert s.name == "desed.step"
    assert isinstance(span("step"), contextlib.nullcontext)


@pytest.mark.parametrize("name", sorted(TRAIN_PARENT))
def test_train_step_records_the_span_inside_its_parent(runs, name):
    events = runs["train"][0][2]
    mine = _check_nesting(events, name, TRAIN_PARENT[name])
    steps = [e for e in events if e["name"] == "desed.step"]
    assert len(steps) == STEPS
    assert all(any(_holds(s, e) for s in steps) for e in mine)


def test_train_step_spans_per_step(runs):
    events = runs["train"][0][2]
    count = {n: sum(e["name"] == SPAN_PREFIX + n for e in events) / STEPS
             for n in (*TRAIN_PARENT, "store.gather", "step")}
    # the teacher and the student run the forward's spans once each; the two
    # conv blocks run two backward Functions each, the one BiGRU layer one
    assert count["crnn.cnn"] == count["frontend.scaler"] == 2
    assert count["cnn.bwd"] == 4 and count["rnn.bwd"] == 1
    assert count["store.gather"] == 2  # index_to_device and the batch's build
    assert all(count[n] == 1 for n in ("step", "step.augment", "frontend.mel",
                                       "step.optimizer", "step.ema"))


def test_store_gather_runs_outside_the_step(runs):
    events = runs["train"][0][2]
    steps = [e for e in events if e["name"] == "desed.step"]
    gathers = [e for e in events if e["name"] == "desed.store.gather"]
    assert len(gathers) == 2 * STEPS
    assert not any(_holds(s, g) for s in steps for g in gathers)


@pytest.mark.parametrize("name", sorted(EVAL_PARENT))
def test_eval_pass_records_the_span_inside_it(runs, name):
    events = runs["eval"][0][1]
    _check_nesting(events, name, EVAL_PARENT[name])
    assert sum(e["name"] == "desed.eval" for e in events) == 1


def test_train_step_is_bitwise_the_same_with_the_profiler_on(runs):
    (m_on, leaves_on, _), (m_off, leaves_off, events_off) = runs["train"]
    assert events_off == []
    for a, b in zip(m_on, m_off):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a), a
    assert leaves_on.keys() == leaves_off.keys()
    assert all(torch.equal(leaves_on[k], leaves_off[k]) for k in leaves_on)


def test_eval_pass_is_bitwise_the_same_with_the_profiler_on(runs):
    (on, _), (off, _) = runs["eval"]
    assert on[0] is None and off[0] is None
    for a, b in zip(on[1:], off[1:]):
        assert np.array_equal(a, b)
