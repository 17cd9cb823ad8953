"""The port's mesh (desed_task_tpu_torch/parallel) on four gloo ranks on the
CPU, against the JAX package's mesh on four of the eight virtual CPU
devices: shard_batch gives each rank exactly the rows that JAX's
NamedSharding(P("data")) places on the device at the same mesh position,
on batch axes 0 and 1; the groups of a (data=2, model=2) mesh hold the
ranks JAX's mesh lines up; replicate broadcasts from rank 0,
all_reduce_mean averages over the group. Then the launcher's deadlines: a
rank that raises and a rank that hangs each fail the call within its
deadline instead of hanging, a collective on a mesh group that one rank
skips fails at the collective timeout that the group inherits, and
the dry run of four ranks prints its ok lines.

Ranks are spawned with a rendezvous file (no TCP port); every call joins
its children within 120 s.
"""

import numpy as np
import pytest
import torch

import jax

from desed_task_tpu.parallel import make_mesh as jax_make_mesh
from desed_task_tpu.parallel import shard_batch as jax_shard_batch
from desed_task_tpu_torch.parallel import Mesh, rank_seed, shard_batch
from desed_task_tpu_torch.parallel.launch import spawn_ranks

import _torch_parallel_ranks as ranks

DEADLINE = 120


def _batch():
    r = np.random.default_rng(0)
    return {"weak": {"audio": r.standard_normal((2, 4, 6)).astype(np.float32),
                     "labels": (r.random((2, 4, 3)) > 0.5).astype(np.float32)},
            "unlabeled": {"audio": r.standard_normal((2, 8, 6)).astype(np.float32)},
            "scale": np.float32(3.0)}


@pytest.fixture(scope="module")
def port():
    return spawn_ranks(ranks.mesh_rank, 4, args=(_batch(),), timeout_s=DEADLINE)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])


@pytest.mark.parametrize("batch_axis", [0, 1])
def test_shard_batch_rows_are_jax_shards(port, jax_mesh, batch_axis):
    batch = _batch()
    placed = jax_shard_batch(batch, jax_mesh, batch_axis=batch_axis)
    grid = jax_mesh.devices
    for slot in ("weak", "unlabeled"):
        for key, arr in placed[slot].items():
            by_device = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
            for d in range(2):
                for m in range(2):
                    got = port[2 * d + m]["shards"][batch_axis][slot][key]
                    np.testing.assert_array_equal(got, by_device[grid[d, m]],
                                                  err_msg=f"{slot}/{key} at ({d}, {m})")
    for res in port:  # a 0-d leaf is kept whole
        assert res["shards"][batch_axis]["scale"] == batch["scale"]


def test_mesh_groups_follow_the_jax_layout(port, jax_mesh):
    ids = np.vectorize(lambda dev: jax.devices().index(dev))(jax_mesh.devices)
    for rank, res in enumerate(port):
        d, m = divmod(rank, 2)
        assert res["shape"] == {"data": 2, "model": 2} and res["size"] == 4
        assert res["index"] == {"data": d, "model": m}
        assert res["data_ranks"] == sorted(ids[:, m].tolist())
        assert res["model_ranks"] == sorted(ids[d, :].tolist())
        assert res["cpu_data_ranks"] == res["data_ranks"]  # gloo: the same groups


def test_replicate_and_mean_over_groups(port):
    for rank, res in enumerate(port):
        d, m = divmod(rank, 2)
        assert torch.equal(res["replicated"], torch.zeros(3))  # from rank 0
        data_ranks = np.array([m, 2 + m], np.float32)
        assert torch.equal(res["data_mean"], torch.tensor([data_ranks.mean(),
                                                           2 * data_ranks.mean()]))
        want = torch.arange(8.0).reshape(4, 2)[2 * d:2 * d + 2]
        assert torch.equal(res["tensor_shard"], want)


def test_shard_batch_refuses_uneven_rows_and_rank_seed():
    mesh = Mesh(shape={"data": 3}, index={"data": 0}, groups={}, cpu_groups={})
    with pytest.raises(ValueError, match="3 equal blocks"):
        shard_batch({"a": np.zeros((4, 2))}, mesh)
    assert rank_seed(5, 0, 1) == 5
    seeds = {rank_seed(5, r, 4) for r in range(4)}
    assert len(seeds) == 4 and all(0 <= s < 2 ** 63 for s in seeds)


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(ranks.failing_rank, 2, timeout_s=DEADLINE, collective_timeout_s=20)


def test_a_hanging_rank_is_killed_at_the_deadline():
    with pytest.raises(TimeoutError, match=r"ranks \[1\]"):
        spawn_ranks(ranks.sleeping_rank, 2, timeout_s=30)


def test_a_skipped_collective_fails_instead_of_hanging():
    # rank 0's all-reduce on the data group fails after 5 s, well before the
    # call's 20 s deadline: make_mesh's groups take the launcher's timeout
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        spawn_ranks(ranks.skipped_collective_rank, 2, timeout_s=20, collective_timeout_s=5)


def test_dryrun_multichip_four_ranks(capsys):
    from desed_task_tpu_torch.parallel.dryrun import dryrun_multichip

    results = dryrun_multichip(4, timeout_s=DEADLINE)
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): ok on mesh (data=2, model=2)" in out
    assert "dryrun_multichip(4): ok make_train_step_sharded on (data=4)" in out
    assert "ok sharded eval" in out
    for res in results:
        assert res["e2e"][1] == 1 and res["flagship"][1] == 1
        assert np.isfinite(res["e2e"][0]) and np.isfinite(res["flagship"][0])
    # ranks of one data shard compute the same replica: equal losses
    assert results[0]["e2e"][0] == results[1]["e2e"][0]
    assert len({r["flagship"][0] for r in results}) == 1  # losses mean-all-reduced
