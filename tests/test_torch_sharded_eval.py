"""The row-sharded eval cache on two gloo ranks on the CPU: the port's
`DeviceEvalCache(..., n_shards=2).upload(mesh=...)` scanned by
training/evaluate.py's loop, each rank over its own block of whole batches,
the scores gathered to rank 0 in global row order. The counterpart of
tests/test_device_cache.py's sharded-scan test.

The narrow CRNN and the ten 1-s clips of tests/test_torch_eval_e2e.py
(weights from JAX through `from_jax_params`), batches of 4: sixteen rows
after padding, two batches a rank. The gathered raw, median-filtered and
weak scores are bitwise equal to the single-device cache's scan of the same
items (each rank computes on one thread, so a batch's arithmetic is the
same on either rank), and within the CRNN tests' 2e-6 of JAX's sharded scan
on a 2-device mesh (`fused_blocks=False, rnn_pallas=False`). Only rank 0
receives scores; predict_dataset gives None on rank 1.
"""

import numpy as np
import pytest

import jax

from desed_task_tpu.data.device_cache import DeviceEvalCache as JCache
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JMelConfig
from desed_task_tpu.parallel import make_mesh as jax_make_mesh
from desed_task_tpu.training import evaluate as jev
from desed_task_tpu.training.mean_teacher import make_predict_step as jmake_predict_step
from desed_task_tpu_torch.parallel.launch import spawn_ranks

import _torch_parallel_ranks as ranks
from test_torch_eval_e2e import BATCH, ENC, MEDIAN, MEL, N_MELS, NET, _items, _jax_variables, \
    _port_model

TOL_SCORES = 2e-6
DEADLINE = 120


@pytest.fixture(scope="module")
def runs():
    jv = _jax_variables(0)
    items = _items(2)[0]
    spec = dict(net=NET, n_mels=N_MELS, init=_port_model(jv).state_dict(), items=items,
                batch_size=BATCH, median=MEDIAN, mel=MEL, encoder=ENC)
    port = spawn_ranks(ranks.sharded_eval_rank, 2, args=(spec,), timeout_s=DEADLINE)
    jpredict = jmake_predict_step(JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False),
                                  JMelConfig(**MEL))
    # copies: the JAX cache scales a float32 item's audio in place
    jcache = JCache([dict(it, audio=it["audio"].copy()) for it in items], BATCH, n_shards=2)
    jcache.upload(mesh=jax_make_mesh({"data": 2}, devices=jax.devices()[:2]))
    jax_scores = jev._predict_cache_all(jpredict, jv["params"], jv["batch_stats"], jcache, None,
                                        MEDIAN, want_raw=True)
    return port, jax_scores, items


def test_sharded_scan_is_the_single_device_scan_bitwise(runs):
    (r0, _), _, items = runs
    assert r0["rows"] == 8  # 10 clips padded to 16 rows, two batches of 4 a rank
    for got, want, name in zip(r0["sharded"], r0["single"], ("raw", "post", "weak")):
        assert got.shape[0] == len(items), name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_sharded_scan_matches_jax_sharded_scan(runs):
    (r0, _), jax_scores, _ = runs
    for got, want, name in zip(r0["sharded"], jax_scores, ("raw", "post", "weak")):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCORES, err_msg=name)


def test_only_the_first_rank_gets_the_scores(runs):
    (r0, r1), _, items = runs
    assert r1["sharded"] is None and r1["decoded"] is None and r1["rows"] == 8
    names, weak = r0["decoded"]
    assert names == sorted(it["filename"][:-4] for it in items)
    np.testing.assert_array_equal(weak, r0["sharded"][2])
