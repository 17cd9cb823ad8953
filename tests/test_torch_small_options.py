"""Small options no recipe uses, against the JAX package on the CPU:
`CheckpointManager(mode="min")` (which saves it takes and skips, the
manager's record, a resumed manager), the unshuffled samplers (JAX's index
stream, no draw from the generator), and `scores_to_table` against JAX's
`scores_to_dataframe`, column by column."""

import json

import numpy as np
import pytest
import torch

from desed_task_tpu.data.batcher import MultiSourceBatcher as JaxBatcher
from desed_task_tpu.data.batcher import SlotSampler as JaxSampler
from desed_task_tpu.metrics.segments import scores_to_dataframe
from desed_task_tpu.obs.checkpoint import CheckpointManager as JaxManager
from desed_task_tpu_torch.data.batcher import MultiSourceBatcher, SlotSampler
from desed_task_tpu_torch.metrics.segments import scores_to_table
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.obs.checkpoint import CheckpointManager
from desed_task_tpu_torch.training import MeanTeacherConfig, SlotSpec, create_state
from desed_task_tpu_torch.training import make_optimizer

NET = dict(nclass=3, n_RNN_cell=4, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
           stride=[1, 1], nb_filters=[4, 8], pooling=[[2, 2], [2, 2]], n_mels=16)
SCORES = [0.5, 0.7, 0.3, 0.3, 0.1, 0.2]


def _state(seed):
    torch.manual_seed(seed)
    opt, _ = make_optimizer(1e-3, 10)
    return create_state(CRNN(**NET), MeanTeacherConfig(slots=(SlotSpec("a", 2, "strong"),)),
                        opt, device="cpu")


@pytest.mark.parametrize("mode", ["min", "max"])
def test_checkpoint_mode_saves_as_jax(tmp_path, mode):
    """The same scores through both managers: the same saves taken and
    skipped, the same manager.json, the same decisions after a resume, and
    the best checkpoint holds the state saved with the best score."""
    mine = CheckpointManager(tmp_path / "port", mode=mode)
    jax_mgr = JaxManager(tmp_path / "jax", top_k=3, mode=mode)
    assert mine.mode == jax_mgr.mode
    states = [_state(i) for i in range(len(SCORES))]
    got = [mine.save_if_best(st, s, {"i": i}) for i, (st, s) in enumerate(zip(states, SCORES))]
    want = [jax_mgr.save_if_best({"w": np.full(2, i, np.float32)}, s)
            for i, s in enumerate(SCORES)]
    assert got == want == ([True, False, True, False, True, False] if mode == "min"
                           else [True, True, False, False, False, False])
    for name in ("port", "jax"):
        best = json.loads((tmp_path / name / "manager.json").read_text())
        assert best == {"scores": {"best": min(SCORES) if mode == "min" else max(SCORES)}}
    i_best = max(i for i, saved in enumerate(got) if saved)
    restored = mine.restore("best", _state(99))
    for k, v in states[i_best].student.state_dict().items():
        assert torch.equal(restored.student.state_dict()[k], v), k
    assert mine.metadata("best")["i"] == i_best
    # a manager resumed from the same directory keeps comparing in its mode
    again = CheckpointManager(tmp_path / "port", mode=mode)
    jagain = JaxManager(tmp_path / "jax", mode=mode)
    for s in (0.15, 0.05, 0.75):
        assert again.save_if_best(states[0], s) == jagain.save_if_best({"w": np.zeros(2)}, s)


def test_checkpoint_default_is_top_one_by_max(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert mgr.mode == "max"
    assert mgr.save_if_best(_state(0), 0.2) and not mgr.save_if_best(_state(0), 0.1)
    # JAX's top_k changes nothing there (the single best is kept), so the
    # port does not take it
    with pytest.raises(TypeError):
        CheckpointManager(tmp_path, top_k=3)


@pytest.mark.parametrize("shards", [(0, 1), (1, 3)])
def test_unshuffled_sampler_matches_jax(shards):
    mine = SlotSampler(10, seed=4, shard_index=shards[0], num_shards=shards[1], shuffle=False)
    jax_s = JaxSampler(10, seed=4, shard_index=shards[0], num_shards=shards[1], shuffle=False)
    state = mine.rng.bit_generator.state
    stream = [mine.take(3) for _ in range(6)]
    assert stream == [jax_s.take(3) for _ in range(6)]
    assert sum(stream, []) == (list(range(10))[shards[0]::shards[1]] * 18)[:18]
    assert mine.rng.bit_generator.state == state  # nothing drawn
    assert mine.shard_len == jax_s.shard_len


class _Set:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"audio": np.full(3, i, np.float32)}


@pytest.mark.parametrize("shuffle", [False, True])
def test_batcher_index_stream_matches_jax(shuffle):
    sets = {"a": _Set(7), "b": _Set(12)}
    sizes = {"a": 2, "b": 3}
    mine = MultiSourceBatcher(sets, sizes, seed=5, num_workers=1, shuffle=shuffle)
    jax_b = JaxBatcher(sets, sizes, seed=5, num_workers=1, shuffle=shuffle)
    for got, want in zip(mine.epoch_indices(6), jax_b.epoch_indices(6)):
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(got[k], want[k])
    batches = list(MultiSourceBatcher(sets, sizes, seed=5, num_workers=1,
                                      shuffle=shuffle).epoch(2))
    first = np.asarray(batches[0]["a"]["audio"][:, 0], np.int64)
    if not shuffle:
        assert first.tolist() == [0, 1]


def test_scores_to_table_matches_jax_dataframe():
    r = np.random.default_rng(0)
    scores = r.random((4, 9)).astype(np.float32)
    classes = ["Speech", "Dog", "Cat", "Blender"]
    to_time = lambda idx: np.asarray(idx) * 0.064 + 0.032
    table = scores_to_table(scores, classes, to_time)
    df = scores_to_dataframe(scores, classes, to_time)
    assert list(table) == list(df.columns)
    for col in df.columns:
        assert table[col].dtype == df[col].to_numpy().dtype, col
        assert np.array_equal(table[col], df[col].to_numpy()), col
