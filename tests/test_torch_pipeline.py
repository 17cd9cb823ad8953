"""Port InferencePipeline against the JAX InferencePipeline on the same 7 wavs
(odd count: the final batch is zero-padded), converted weights, CPU."""

import numpy as np
import pytest

import jax

from desed_task_tpu.data import write_wav
from desed_task_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from desed_task_tpu.labels import ManyHotEncoder as JaxEncoder
from desed_task_tpu.models import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu_torch.inference.pipeline import (
    EVENT_COLUMNS, InferencePipeline, events_to_dataframes)
from desed_task_tpu_torch.labels import ManyHotEncoder
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig

NET = dict(
    nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 8], pooling=[[2, 8], [2, 8]], dropout=0.0,
)
THS = (0.3, 0.48, 0.5, 0.7)
TOL = 1e-5  # fp32 front-end + CRNN in another summation order


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wavs")
    r = np.random.default_rng(7)
    wavs = []
    for i in range(7):
        p = tmp / f"clip_{i}.wav"
        write_wav(p, (r.standard_normal(32000) * 0.1).astype(np.float32), 16000)
        wavs.append(p)
    jm = JaxCRNN(**NET)
    variables = jm.init({"params": jax.random.key(0)}, np.zeros((1, 64, 126), np.float32))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.2 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables))
    common = dict(median_filter=[3, 3, 3], thresholds=THS, batch_size=4)
    jpipe = JaxPipeline(jm, variables, JaxEncoder(["A", "B", "C"], 2, 1024, 256, 4, 16000),
                        mel_cfg=JaxMel(n_fft=1024, win_length=1024, n_mels=64), **common)
    tm = CRNN(n_mels=64, **NET)
    state = from_jax_params(variables["params"], variables["batch_stats"])
    tpipe = InferencePipeline(tm, state, ManyHotEncoder(["A", "B", "C"], 2, 1024, 256, 4, 16000),
                              mel_cfg=MelConfig(n_fft=1024, win_length=1024, n_mels=64),
                              device="cpu", **common)
    return jpipe.run(wavs), tpipe.run(wavs)


def test_scores_match(runs):
    (sj, wj, _), (st, wt, _) = runs
    assert sorted(st) == sorted(sj) and len(st) == 7
    for k in sj:
        assert st[k].shape == (3, 31)
        np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=TOL)
        np.testing.assert_allclose(wt[k], wj[k], rtol=0, atol=TOL)


def test_event_tables_match_away_from_thresholds(runs):
    """Identical events for every (clip, class) none of whose frames scores
    within TOL of the threshold."""
    (sj, _, dfs), (_, _, events) = runs
    labels = ["A", "B", "C"]
    assert set(events) == set(THS)
    n_compared = 0
    for th in THS:
        near = {(k + ".wav", labels[c]) for k, s in sj.items() for c in range(3)
                if (np.abs(s[c] - th) <= TOL).any()}
        ours = [row for row in events[th] if (row[3], row[0]) not in near]
        theirs = [tuple(row) for row in dfs[th][list(EVENT_COLUMNS)].itertuples(index=False)
                  if (row[3], row[0]) not in near]
        assert ours == theirs
        n_compared += len(theirs)
    assert n_compared > 0


def test_events_to_dataframes(runs):
    (_, _, dfs), (_, _, events) = runs
    ours = events_to_dataframes(events)
    for th in THS:
        assert list(ours[th].columns) == list(dfs[th].columns)
        assert len(ours[th]) == len(events[th])
