"""The port's data-parallel mean-teacher step (`make_train_step_sharded`) on
two gloo ranks on the CPU against JAX's `make_train_step_sharded` on a
2-device mesh of the virtual CPU devices, over two steps, with and without
gradient accumulation (accumulate=2: the micro-batch axis leads, the
example axis 1 is sharded).

A narrow 2-block pool1d CRNN (32 mels, half-second clips, embeddings 12
wide), slots of 4 clips (2 a rank), dropout, dropstep and mixup off so both
steps are deterministic. JAX runs its XLA chain (`fused_blocks=False,
rnn_pallas=False`); its optimizer is chained behind an identity transform
that keeps the (rank-averaged) gradients it sees. Tolerances are
tests/test_torch_train_step.py's: metrics 2e-5 relative (1e-9 absolute);
gradients 2e-4 of each tensor's largest entry (the conv biases' exact
gradient is 0 under train-mode BatchNorm: the port's below 1e-6 of the
largest gradient, the XLA chain's below 1e-5, as in
tests/test_torch_e2e_embedder.py); updated student and teacher 5e-7 absolute (a conv bias
moves by at most 4 learning rates a step); BatchNorm statistics 2e-5.

Also: the two ranks' replicas (student, teacher, BN statistics, Adam
moments, gradients) bitwise equal after every step; a data axis of one
rank bitwise equal to `make_train_step` from the same state; a slot that
the data axis does not divide raises.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.parallel import make_mesh as jax_make_mesh
from desed_task_tpu.parallel import replicate as jax_replicate
from desed_task_tpu.parallel import shard_batch as jax_shard_batch
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.parallel import Mesh
from desed_task_tpu_torch.parallel.launch import spawn_ranks
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, make_optimizer, make_train_step_sharded)

import _torch_parallel_ranks as ranks

N_MELS, N_CLASS, E, TE, N_SAMPLES, SLOT = 32, 3, 12, 17, 8000, 4
NET = dict(
    nclass=N_CLASS, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 2]], dropout=0.0,
    dropstep_recurrent=0.0, specaugm_t_p=0.0, specaugm_f_p=0.0, use_embeddings=True,
    embedding_size=E, aggregation_type="pool1d",
)
LR, RAMPUP, STEPS, DEADLINE = 1e-3, 10, 2, 120
SLOTS = (("strong", SLOT, "strong"), ("weak", SLOT, "weak"), ("unlabeled", SLOT, "unlabeled"))
CFG = dict(mixup=None, consistency_start_slot=1, rampup_steps=RAMPUP, decay_steps=1)


def _batch(micro=None):
    r = np.random.default_rng(0)
    lead = (SLOT,) if micro is None else (micro, SLOT)
    batch = {}
    for i, name in enumerate(("strong", "weak", "unlabeled")):
        cm = np.ones((*lead, N_CLASS), bool)
        cm[..., i % 2, (i + 1) % N_CLASS] = False
        batch[name] = {
            "audio": (r.standard_normal((*lead, N_SAMPLES)) * 0.1).astype(np.float32),
            "labels": (r.random((*lead, N_CLASS, 8)) > 0.6).astype(np.float32),
            "embeddings": r.standard_normal((*lead, E, TE)).astype(np.float32),
            "class_mask": cm,
        }
    return batch


def _keep_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _perturbed(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _jax_init():
    cfg_j = jmt.MeanTeacherConfig(slots=tuple(jmt.SlotSpec(*s) for s in SLOTS), **CFG)
    model_j = JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False)
    mel_j = JaxMel(n_mels=N_MELS)
    tx, sched = jmt.make_optimizer(LR, RAMPUP)
    tx = optax.chain(_keep_grads(), tx)
    state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), _batch(), mel_cfg=mel_j)
    params = _perturbed(state.student_params, 1)
    stats = jax.device_get(state.student_stats)
    state = state.replace(student_params=params, teacher_params=params, student_stats=stats,
                          teacher_stats=stats, opt_state=tx.init(params))
    return model_j, cfg_j, mel_j, tx, sched, state, from_jax_params(params, stats)


def _spec(init, batch, accumulate=1, steps=STEPS):
    return dict(net=NET, n_mels=N_MELS, init=init, batch=batch, lr=LR, rampup=RAMPUP,
                cfg=dict(CFG, slots=SLOTS), accumulate=accumulate, steps=steps)


@pytest.fixture(scope="module", params=[1, 2], ids=["accumulate1", "accumulate2"])
def runs(request):
    acc = request.param
    batch = _batch(None if acc == 1 else acc)
    model_j, cfg_j, mel_j, tx, sched, state, init = _jax_init()
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    state = jax.device_put(state, jax_replicate(mesh))
    step_j = jmt.make_train_step_sharded(model_j, cfg_j, tx, sched, mesh, batch, mel_cfg=mel_j,
                                         accumulate=acc)
    sbatch = jax_shard_batch(batch, mesh, batch_axis=0 if acc == 1 else 1)
    jax_runs = []
    for _ in range(STEPS):
        state, metrics = step_j(state, sbatch, jax.random.key(1))
        jax_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=from_jax_params(jax.device_get(state.opt_state[0])),
            student=from_jax_params(jax.device_get(state.student_params),
                                    jax.device_get(state.student_stats)),
            teacher=from_jax_params(jax.device_get(state.teacher_params),
                                    jax.device_get(state.teacher_stats))))
    port_runs = spawn_ranks(ranks.sharded_step_rank, 2, args=(_spec(init, batch, acc),),
                            timeout_s=DEADLINE)
    return jax_runs, port_runs, init


def _is_conv_bias(name):
    return name.startswith("cnn.conv") and name.endswith(".bias")


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match_jax(runs, i):
    jr, (pr, _), _ = runs
    mj, mt = jr[i]["metrics"], pr[i]["metrics"]
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=2e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients_match_jax(runs, i):
    jr, (pr, _), _ = runs
    gj, gt = jr[i]["grads"], pr[i]["grads"]
    assert set(gt) == set(gj)
    scale = max(float(g.abs().max()) for g in gj.values())
    for name, want in gj.items():
        got = gt[name]
        if _is_conv_bias(name):
            assert float(got.abs().max()) <= 1e-6 * scale, name
            assert float(want.abs().max()) <= 1e-5 * scale, name
            continue
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * float(want.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_weights_and_bn_stats_match_jax(runs, i, who):
    jr, (pr, _), init = runs
    want_sd, got_sd = jr[i][who], pr[i][who]
    assert set(got_sd) == set(want_sd)
    lr0 = LR * np.exp(-5.0)  # schedule(0)
    for name, want in want_sd.items():
        got = got_sd[name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=name)
        elif _is_conv_bias(name):
            assert float((got - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
            assert float((want - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=5e-7, msg=name)


@pytest.mark.parametrize("i", range(STEPS))
def test_replicas_bitwise_equal_across_ranks(runs, i):
    _, (r0, r1), _ = runs
    assert r0[i]["metrics"] == r1[i]["metrics"]
    for key in ("student", "teacher", "grads"):
        for name, t in r0[i][key].items():
            assert torch.equal(t, r1[i][key][name]), f"{key} {name}"
    assert all(torch.equal(a, b) for a, b in zip(r0[i]["moments"], r1[i]["moments"]))


def test_world_size_one_is_make_train_step_bitwise():
    _, _, _, _, _, _, init = _jax_init()
    (plain, sharded), = spawn_ranks(ranks.world_one_rank, 1, args=(_spec(init, _batch()),),
                                    timeout_s=DEADLINE)
    for (m0, g0, s0, t0, o0), (m1, g1, s1, t1, o1) in zip(plain, sharded):
        assert set(m0) == set(m1)
        for k in m0:
            assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))
        for a, b in ((s0, s1), (t0, t1)):
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(a, b) for a, b in zip(o0, o1))


def test_slot_not_divisible_by_the_data_axis_raises():
    cfg = MeanTeacherConfig(slots=(SlotSpec("strong", 4, "strong"), SlotSpec("weak", 3, "weak")),
                            mixup=None)
    opt, sched = make_optimizer(LR, RAMPUP)
    mesh = Mesh(shape={"data": 2}, index={"data": 0}, groups={"data": None}, cpu_groups={})
    with pytest.raises(ValueError, match=r"\{'weak': 3\}.*2 ranks"):
        make_train_step_sharded(cfg, opt, sched, mesh, {})
