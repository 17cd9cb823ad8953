"""The port's eval path end to end on a narrow CRNN against the JAX package:
`predict_dataset` over a list of item dicts and over a `DeviceEvalCache` (on
the CPU), `SEDValidator` and `run_test`, the JAX side through its
`make_predict_step` with `fused_blocks=False, rnn_pallas=False`, the port
through its own `make_predict_step` and its fused blocks (their plain
versions on the CPU), weights carried by `models.convert.from_jax_params`.

Scores agree within the CRNN tests' 2e-6. Fed JAX's scores, the port's
metrics equal JAX's (1e-12). From the port's own scores they are equal too
unless a score lies within that 2e-6 of a threshold on the other side of it
(or two scores of a class swap order, for the threshold-free PSDS); the
tests count such frames and print the count."""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.data.device_cache import DeviceEvalCache as JCache
from desed_task_tpu.labels.encoder import ManyHotEncoder as JEncoder
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JMelConfig
from desed_task_tpu.training import evaluate as jev
from desed_task_tpu.training.mean_teacher import make_predict_step as jmake_predict_step
from desed_task_tpu_torch.data.device_cache import DeviceEvalCache, build_eval_caches
from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import evaluate as tev
from desed_task_tpu_torch.training.mean_teacher import MeanTeacherState, make_predict_step

ROOT = Path(__file__).resolve().parents[1]
TOL_SCORES = 2e-6  # the CRNN tests' tolerance (tests/test_torch_crnn.py)
TOL_METRIC = 1e-12
CLASSES = ["Alarm_bell_ringing", "Blender", "Cat", "Dog"]
N_MELS, E, TE, FS = 32, 12, 17, 16000
MEL = dict(n_fft=512, win_length=512, hop_length=256, n_mels=N_MELS)
ENC = (CLASSES, 1.0, 512, 256, 4, FS)  # 1-s clips: 63 frames, 15 after pooling
NET = dict(nclass=len(CLASSES), n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3],
           padding=[1, 1], stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 4]],
           dropout=0.0, use_embeddings=True, embedding_size=E, aggregation_type="pool1d")
BATCH, N_CLIPS = 4, 10  # two whole batches and a padded one
MEDIAN = [3, 1, 5, 4]


def _jax_variables(seed):
    model = JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False)
    x = np.zeros((1, N_MELS, 63), np.float32)
    variables = model.init(jax.random.key(seed), jnp.asarray(x),
                           embeddings=jnp.zeros((1, E, TE)))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.3 * r.standard_normal(a.shape)).astype(np.float32)
        * (1.0 if a.ndim else 0.0), jax.device_get(variables))


def _port_model(variables):
    model = CRNN(n_mels=N_MELS, **NET).eval()
    model.load_state_dict(from_jax_params(variables["params"], variables.get("batch_stats")))
    return model


def _items(seed, prefix="clip", n=N_CLIPS):
    """Item dicts: int16-representable audio (the cache stores int16, so the
    two branches see the same samples), strong labels and embeddings."""
    r = np.random.default_rng(seed)
    enc = JEncoder(*ENC)
    items, rows = [], []
    for i in range(n):
        name = f"{prefix}_{i}.wav" if prefix != "maestro" else f"mfile{i // 3}-{(i % 3) * 50}-{(i % 3) * 50 + 100}.wav"
        audio = np.round(r.standard_normal(FS) * 3000).clip(-32768, 32767) / 32768.0
        events = []
        for _ in range(r.integers(0, 3)):
            on = round(float(r.uniform(0, 0.8)), 3)
            events.append((CLASSES[r.integers(len(CLASSES))], on,
                           round(min(1.0, on + float(r.uniform(0.1, 0.6))), 3)))
        rows += [(name, on, off, lab) for lab, on, off in events] or [(name, np.nan, np.nan, np.nan)]
        items.append({"audio": audio.astype(np.float32),
                      "labels": enc.encode_strong(events).T.astype(np.float32),
                      "embeddings": r.standard_normal((E, TE)).astype(np.float32),
                      "filename": name})
    gt = pd.DataFrame(rows, columns=["filename", "onset", "offset", "event_label"])
    dur = pd.DataFrame({"filename": [it["filename"] for it in items], "duration": [1.0] * n})
    return items, gt, dur


def _maestro_gt(items, gt):
    out = {}
    for it in items:
        stem = it["filename"][:-4]
        sel = gt[gt["filename"] == it["filename"]].dropna()
        out[stem] = [(float(a), float(b), c) for a, b, c in
                     zip(sel["onset"], sel["offset"], sel["event_label"])]
    return out


@pytest.fixture(scope="module")
def world():
    jv_s, jv_t = _jax_variables(0), _jax_variables(1)
    jmodel = JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False)
    jpredict = jmake_predict_step(jmodel, JMelConfig(**MEL))
    jstate = types.SimpleNamespace(
        student_params=jv_s["params"], student_stats=jv_s["batch_stats"],
        teacher_params=jv_t["params"], teacher_stats=jv_t["batch_stats"], scaler=None)
    student, teacher = _port_model(jv_s), _port_model(jv_t)
    state = MeanTeacherState(step=0, student=student, teacher=teacher, opt_state={}, scaler=None)
    predict = make_predict_step(MelConfig(**MEL))
    by_model = {id(student): jv_s, id(teacher): jv_t}

    def jax_scores(model, audio, embeddings=None, scaler=None):
        """The port's predict_fn signature, JAX's scores."""
        v = by_model[id(model)]
        s, w = jpredict(v["params"], v["batch_stats"], jnp.asarray(audio.numpy()),
                        embeddings=jnp.asarray(embeddings.numpy()), scaler=scaler)
        return torch.from_numpy(np.array(s)), torch.from_numpy(np.array(w))

    items, gt, dur = _items(2)
    m_items, m_gt_df, _ = _items(3, prefix="maestro", n=6)
    # one JAX cache per set, so that its compiled scans are reused
    jcaches = {}
    for name, its in (("items", items), ("m_items", m_items)):
        # copies: the JAX cache scales a float32 item's audio in place
        jcaches[name] = JCache([dict(it, audio=it["audio"].copy()) for it in its], BATCH)
        jcaches[name].upload()
    return dict(jpredict=jpredict, jstate=jstate, state=state, predict=predict,
                jax_scores=jax_scores, items=items, gt=gt, dur=dur, m_items=m_items,
                m_gt=_maestro_gt(m_items, m_gt_df), jcaches=jcaches)


def _cache(items):
    return build_eval_caches({"x": items}, BATCH, verbose=False, device="cpu")["x"]


def _flips(s_t, s_j, thresholds):
    """Frames whose activity at some threshold differs between the two score
    sets, and whether each lies within TOL_SCORES of that threshold."""
    n, near = 0, True
    for th in thresholds:
        d = (s_t > th) != (s_j > th)
        n += int(d.sum())
        near &= bool((np.abs(s_j[d] - th) <= TOL_SCORES).all())
    return n, near


def _order_flips(s_t, s_j):
    """Pairs of scores of one class whose order differs between the two sets."""
    n = 0
    for c in range(s_t.shape[-2]):
        a, b = s_t[:, c].ravel(), s_j[:, c].ravel()
        n += int((np.sign(a[:, None] - a[None, :]) != np.sign(b[:, None] - b[None, :])).sum()) // 2
    return n


def _stack(curves, names):
    return np.stack([curves[Path(f).stem].values.T for f in names])


def test_predict_dataset_matches_jax_on_both_branches(world):
    items = world["items"]
    names = [it["filename"] for it in items]
    kw = dict(thresholds=(0.3, 0.5), median_filter=MEDIAN)
    j = jev.predict_dataset(world["jpredict"], world["jstate"].student_params,
                            world["jstate"].student_stats, items, JEncoder(*ENC), BATCH, **kw)
    j_c = jev.predict_dataset(world["jpredict"], world["jstate"].student_params,
                              world["jstate"].student_stats, world["jcaches"]["items"],
                              JEncoder(*ENC), BATCH, **kw)
    enc = ManyHotEncoder(*ENC)
    student = world["state"].student
    t = tev.predict_dataset(world["predict"], student, items, enc, BATCH, as_arrays=True, **kw)
    cache = _cache(items)
    assert isinstance(cache, DeviceEvalCache) and cache.n_pad == 12
    t_c = tev.predict_dataset(world["predict"], student, cache, enc, BATCH, as_arrays=True, **kw)
    for jj in (j, j_c):
        for k in (0, 1):  # raw and median-filtered scores
            s_j = np.stack([jj[k][Path(f).stem][CLASSES].to_numpy().T for f in names])
            np.testing.assert_allclose(_stack(t[k], names), s_j, rtol=0, atol=TOL_SCORES)
        np.testing.assert_allclose(t[3], jj[3], rtol=0, atol=TOL_SCORES)
        np.testing.assert_array_equal(t[4], jj[4])
    # the cache's loop gives the host branch's scores and events exactly
    for k in (0, 1):
        np.testing.assert_array_equal(_stack(t_c[k], names), _stack(t[k], names))
    np.testing.assert_array_equal(t_c[3], t[3])
    np.testing.assert_array_equal(t_c[4], t[4])
    for th in kw["thresholds"]:
        for c in ("event_label", "onset", "offset", "filename"):
            assert list(t_c[2][th][c]) == list(t[2][th][c])
    # events: the same rows as JAX's but where a frame sits within the
    # tolerance of the threshold
    s_j = np.stack([j[1][Path(f).stem][CLASSES].to_numpy().T for f in names])
    n, near = _flips(_stack(t[1], names), s_j, kw["thresholds"])
    print(f"frames whose activity differs from JAX's: {n}")
    assert near
    if n == 0:
        for th in kw["thresholds"]:
            for c in ("event_label", "onset", "offset", "filename"):
                assert list(t[2][th][c]) == list(j[2][th][c])


def test_predict_dataset_gates_and_callable_median(world):
    items = world["items"][:5]
    enc = ManyHotEncoder(*ENC)
    student = world["state"].student
    cache = _cache(items)
    gated = tev.predict_dataset(world["predict"], student, cache, enc, BATCH, want_raw=False,
                                want_post=False, want_events=False)
    assert gated[0] == gated[1] == {} and all(len(v["onset"]) == 0 for v in gated[2].values())
    from desed_task_tpu_torch.ops.median import ClassWiseMedianFilter

    a = tev.predict_dataset(world["predict"], student, cache, enc, BATCH, as_arrays=True,
                            median_filter=ClassWiseMedianFilter(MEDIAN))
    b = tev.predict_dataset(world["predict"], student, cache, enc, BATCH, as_arrays=True,
                            median_filter=MEDIAN)
    for k in b[1]:
        np.testing.assert_array_equal(a[1][k].values, b[1][k].values)
        np.testing.assert_array_equal(a[0][k].values, b[0][k].values)


def _validators(world, predict_fn, jax_side):
    items, m_items = world["items"], world["m_items"]
    if jax_side:
        synth, maestro = world["jcaches"]["items"], world["jcaches"]["m_items"]
    else:
        synth, maestro = _cache(items), _cache(m_items)
    kw = dict(weak_set=items, synth_set=synth, synth_gt=world["gt"],
              synth_dur=world["dur"], maestro_set=maestro, maestro_gt=world["m_gt"],
              batch_size=BATCH, median_filter=MEDIAN, trajectory_psds=10)
    enc = JEncoder(*ENC) if jax_side else ManyHotEncoder(*ENC)
    mod = jev if jax_side else tev
    return {(synth, maestro): mod.SEDValidator(predict_fn, enc, obj_metric_synth_type=synth,
                                               obj_metric_maestro_type=maestro, **kw)
            for synth, maestro in (("intersection", "fmo"), ("collar", "mauc"))}


def _same_metrics(got, want, tol=TOL_METRIC):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_validator_matches_jax(world):
    jvals = _validators(world, world["jpredict"], True)
    fed = _validators(world, world["jax_scores"], False)
    own = _validators(world, world["predict"], False)
    # the frames near a threshold, student and teacher, synth set
    names = [it["filename"] for it in world["items"]]
    ths = tuple(np.arange(1 / 20, 1, 1 / 10)) + (0.5,)
    n_flips = n_order = 0
    for model in (world["state"].student, world["state"].teacher):
        post = [tev.predict_dataset(fn, model, world["items"], ManyHotEncoder(*ENC), BATCH,
                                    median_filter=MEDIAN, as_arrays=True, want_events=False)[1]
                for fn in (world["predict"], world["jax_scores"])]
        a, b = _stack(post[0], names), _stack(post[1], names)
        n, near = _flips(a, b, ths)
        assert near
        n_flips += n
        n_order += _order_flips(a, b)
    print(f"frames whose activity differs from JAX's: {n_flips}; order swaps: {n_order}")
    for key, jv in jvals.items():
        j_obj, j_sc = jv(world["jstate"], 0)
        assert len(j_sc) >= 6  # every metric in [0, 1]; the obj metrics are sums of them
        assert all(0 <= v <= 1 for k, v in j_sc.items() if not k.endswith("obj_metric"))
        f_obj, f_sc = fed[key](world["state"], 0)
        _same_metrics(f_sc, j_sc)
        assert abs(f_obj - j_obj) <= TOL_METRIC
        o_obj, o_sc = own[key](world["state"], 0)
        if n_flips == 0:
            _same_metrics(o_sc, j_sc)
        else:
            assert set(o_sc) == set(j_sc)


@pytest.mark.parametrize("use_teacher", [False, True])
def test_run_test_matches_jax(world, use_teacher, tmp_path):
    items, m_items = world["items"], world["m_items"]
    kw = dict(batch_size=BATCH, n_thresholds=50, median_filter=MEDIAN, use_teacher=use_teacher,
              maestro_gt=world["m_gt"])
    j = jev.run_test(world["jpredict"], world["jstate"], world["jcaches"]["items"],
                     JEncoder(*ENC), world["gt"], world["dur"],
                     maestro_set=world["jcaches"]["m_items"],
                     save_dir=tmp_path / "j", **kw)
    enc = ManyHotEncoder(*ENC)
    f = tev.run_test(world["jax_scores"], world["state"], _cache(items), enc, world["gt"],
                     world["dur"], maestro_set=_cache(m_items), save_dir=tmp_path / "t", **kw)
    o = tev.run_test(world["predict"], world["state"], items, enc, world["gt"], world["dur"],
                     maestro_set=m_items, **kw)
    numbers = [k for k in j if k not in ("scores_postprocessed", "prediction_dfs")]
    assert len(numbers) == 9 and all(0 <= j[k] <= 1 for k in numbers)
    _same_metrics({k: f[k] for k in numbers}, {k: j[k] for k in numbers})
    names = [it["filename"] for it in items]
    s_j = np.stack([j["scores_postprocessed"][Path(n).stem][CLASSES].to_numpy().T for n in names])
    s_o = _stack(o["scores_postprocessed"], names)
    np.testing.assert_allclose(s_o, s_j, rtol=0, atol=TOL_SCORES)
    n, near = _flips(s_o, s_j, list(j["prediction_dfs"]))
    n_order = _order_flips(s_o, s_j)
    print(f"frames whose activity differs from JAX's: {n}; order swaps: {n_order}")
    assert near
    if n == 0 and n_order == 0:
        _same_metrics({k: o[k] for k in numbers}, {k: j[k] for k in numbers})
    # the dumps: the same prediction files; both PSD-ROC plots
    for sub in ("predictions_dtc0.7_gtc0.7_cttc0.3", "predictions_dtc0.1_gtc0.1_cttc0.3"):
        files = sorted(p.name for p in (tmp_path / "j" / sub).iterdir())
        assert len(files) == 50
        assert files == sorted(p.name for p in (tmp_path / "t" / sub).iterdir())
        for name in files:
            assert ((tmp_path / "t" / sub / name).read_text()
                    == (tmp_path / "j" / sub / name).read_text())
    for png in ("PSDS_scenario1_roc.png", "PSDS_scenario2_roc.png"):
        assert (tmp_path / "t" / png).stat().st_size > 5000


def test_eval_cache_refuses_meshes_and_keeps_odd_sets_on_the_host(world):
    from desed_task_tpu_torch.data.device_cache import _to_int16
    from desed_task_tpu_torch.parallel import Mesh

    items = world["items"]
    # data index 1 of a 2-rank data axis (upload reads the mesh's shape and index)
    mesh = Mesh(shape={"data": 2}, index={"data": 1}, groups={}, cpu_groups={})
    with pytest.raises(ValueError, match="n_shards=2"):  # n_pad 12: not 2 x whole batches
        DeviceEvalCache(items, BATCH, device="cpu").upload(mesh=mesh)
    sharded = DeviceEvalCache(items, BATCH, n_shards=2, device="cpu")
    assert sharded.n_pad == 16
    sharded.upload(mesh=mesh)
    assert sharded.rows == 8 and sharded.stores["audio"].shape == (8, FS)
    np.testing.assert_array_equal(sharded.stores["audio"][:2].numpy(),
                                  np.stack([_to_int16(it["audio"]) for it in items[8:]]))
    assert not sharded.stores["audio"][2:].any()
    with pytest.raises(RuntimeError, match="sharded"):
        next(sharded.batches())
    stereo = [dict(it, audio=np.stack([it["audio"]] * 2)) for it in items[:2]]
    out = build_eval_caches({"stereo": stereo, "none": None, "empty": [], "big": items}, BATCH,
                            max_bytes=1000, verbose=False, device="cpu")
    assert out["stereo"] is stereo and out["none"] is None and out["empty"] == []
    assert out["big"] is items  # over max_bytes: stays host-side
    before = [it["audio"].copy() for it in items]
    cache = DeviceEvalCache(items, BATCH, device="cpu")
    for it, a in zip(items, before):  # the items are left as they were
        np.testing.assert_array_equal(it["audio"], a)
    with pytest.raises(RuntimeError, match="upload"):
        next(cache.batches())
    cache.upload()
    got = list(cache.batches())
    assert [b[2] for b in got] == [4, 4, 2]
    np.testing.assert_array_equal(got[2][0][:2].numpy(), np.stack([it["audio"] for it in items[8:]]))
    assert got[2][0].shape == (BATCH, FS) and got[2][3] == [it["filename"] for it in items[8:]]


def test_eval_cache_without_cuda_raises(monkeypatch, world):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceEvalCache(world["items"][:2], BATCH)


NO_PANDAS = r"""
import sys
sys.modules["pandas"] = None
sys.modules["matplotlib"] = None
import numpy as np, torch
from desed_task_tpu_torch.data.device_cache import build_eval_caches
from desed_task_tpu_torch.labels.encoder import ManyHotEncoder
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training.evaluate import SEDValidator, predict_dataset, run_test
from desed_task_tpu_torch.training.mean_teacher import MeanTeacherState, make_predict_step

classes = ["A", "B", "C"]
enc = ManyHotEncoder(classes, 1.0, 512, 256, 4, 16000)
net = dict(nclass=3, n_RNN_cell=4, n_layers_RNN=1, kernel_size=[3], padding=[1], stride=[1],
           nb_filters=[4], pooling=[[4, 4]], n_mels=16)
torch.manual_seed(0)
model = CRNN(**net).eval()
state = MeanTeacherState(step=0, student=model, teacher=model, opt_state={})
r = np.random.default_rng(0)
items = [{"audio": r.standard_normal(16000).astype(np.float32) * 0.1,
          "labels": np.zeros((3, 15), np.float32), "filename": f"c{i}.wav"} for i in range(5)]
gt = {"filename": np.array([f"c{i}.wav" for i in range(5)], object),
      "onset": np.array([0.1, 0.2, 0.0, 0.5, 0.3]), "offset": np.array([0.6, 0.9, 1.0, 0.7, 0.4]),
      "event_label": np.array(["A", "B", "C", "A", None], object)}
dur = {"filename": gt["filename"], "duration": np.ones(5)}
predict = make_predict_step(MelConfig(n_fft=512, win_length=512, hop_length=256, n_mels=16))
cache = build_eval_caches({"x": items}, 2, verbose=False, device="cpu")["x"]
out = predict_dataset(predict, model, cache, enc, 2, median_filter=[3, 3, 3], as_arrays=True)
assert len(out[2][0.5]["onset"]) >= 0 and out[3].shape == (5, 3)
res = run_test(predict, state, cache, enc, gt, dur, batch_size=2, median_filter=[3, 3, 3])
val = SEDValidator(predict, enc, weak_set=items, synth_set=cache, synth_gt=gt, synth_dur=dur,
                   batch_size=2, median_filter=[3, 3, 3], trajectory_psds=5)(state, 0)
nums = [v for k, v in res.items() if k not in ("scores_postprocessed", "prediction_dfs")]
assert all(np.isfinite(v) for v in nums + list(val[1].values()))
bad = [m for m in sys.modules if m.split(".")[0] in ("pandas", "matplotlib", "jax")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", len(nums), len(val[1]))
"""


def test_eval_path_runs_without_pandas_and_matplotlib():
    proc = subprocess.run([sys.executable, "-c", NO_PANDAS], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split()[:2] == ["ok", "6"]
