"""The tensor-parallel BEATs (`parallel.tp.shard_beats`) on two gloo ranks
on the CPU, over a (data=1, model=2) mesh.

The tiny BEATs of the dry run (2 layers, 64 wide, 4 heads: 2 a rank, FFN
128: 64 units a rank; weights from JAX through `from_jax_embedder_params`)
on half-second clips: its frame embeddings within 1e-5 of max(1, max |full|)
of the port's full BEATs and of JAX's, full and tensor-parallel
(`parallel.tp.shard_params` on a (data=1, model=2) mesh of the virtual
devices). Then the e2e mean-teacher step with the tensor-parallel BEATs in
it (`make_train_step_sharded` on the data axis of one rank) against JAX's
jit `make_train_step` with the embedder, over two steps: the setup and the
tolerances of tests/test_torch_e2e_embedder.py (metrics 2e-5 relative,
gradients 2e-4 of each tensor's largest entry, the conv biases' below 1e-6
of the largest gradient on the port's side and 1e-5 on JAX's XLA chain,
weights 5e-7, BatchNorm statistics 2e-5). The sharded BEATs keeps its
weights bitwise, takes no gradient, and both ranks' replicas are bitwise
equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.beats import BEATsConfig as JaxBEATsConfig
from desed_task_tpu.models.beats import BEATsModel as JaxBEATs
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.parallel import make_mesh as jax_make_mesh
from desed_task_tpu.parallel.tp import shard_params
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel
from desed_task_tpu_torch.models.convert import from_jax_embedder_params, from_jax_params
from desed_task_tpu_torch.parallel.launch import spawn_ranks

import _torch_parallel_ranks as ranks
from test_torch_e2e_embedder import (CFG, LR, N_MELS, N_SAMPLES, NET, RAMPUP, STEPS, TINY,
                                     _batch, _keep_grads, _perturbed)

TOL_EMB = 1e-5
DEADLINE = 120


def _bound(ref):
    return TOL_EMB * max(1.0, float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def runs():
    import optax

    jb = JaxBEATs(JaxBEATsConfig(**TINY))
    jvars = {"params": _perturbed(
        jb.init(jax.random.key(3), jnp.zeros((1, N_SAMPLES)))["params"], 4, 0.05)}
    audio = (np.random.default_rng(9).standard_normal((3, N_SAMPLES)) * 0.1).astype(np.float32)
    jax_full = np.asarray(jb.apply(jvars, jnp.asarray(audio))["frame"])
    mesh = jax_make_mesh({"data": 1, "model": 2}, devices=jax.devices()[:2])
    tp_vars = {"params": shard_params(jvars["params"], mesh)}
    jax_tp = np.asarray(jax.jit(jb.apply)(tp_vars, jnp.asarray(audio))["frame"])

    batch = _batch()
    cfg_j = jmt.MeanTeacherConfig(**{**CFG, "slots": tuple(
        jmt.SlotSpec(s.name, s.size, s.role) for s in CFG["slots"])})
    model_j = JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False)
    tx, sched = jmt.make_optimizer(LR, RAMPUP)
    tx = optax.chain(_keep_grads(), tx)
    mel_j = JaxMel(n_mels=N_MELS)
    state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), _batch(True), mel_cfg=mel_j)
    params = _perturbed(state.student_params, 1)
    stats = jax.device_get(state.student_stats)
    state = state.replace(student_params=params, teacher_params=params,
                          student_stats=stats, teacher_stats=stats, opt_state=tx.init(params))
    step_j = jax.jit(jmt.make_train_step(model_j, cfg_j, tx, sched, mel_cfg=mel_j,
                                         embedder=(jb.apply, jvars)))
    jax_runs = []
    for _ in range(STEPS):
        state, metrics = step_j(state, batch, jax.random.key(1))
        jax_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=from_jax_params(jax.device_get(state.opt_state[0])),
            student=from_jax_params(jax.device_get(state.student_params),
                                    jax.device_get(state.student_stats)),
            teacher=from_jax_params(jax.device_get(state.teacher_params),
                                    jax.device_get(state.teacher_stats))))

    init = from_jax_params(params, stats)
    spec = dict(beats_cfg=TINY, beats=from_jax_embedder_params(jvars["params"]), audio=audio,
                net=NET, n_mels=N_MELS, init=init, batch=batch, lr=LR, rampup=RAMPUP,
                steps=STEPS, cfg=dict(CFG, slots=tuple((s.name, s.size, s.role)
                                                       for s in CFG["slots"])))
    port = spawn_ranks(ranks.tp_beats_rank, 2, args=(spec,), timeout_s=DEADLINE)
    port_full = BEATsModel(BEATsConfig(**TINY))
    port_full.load_state_dict(spec["beats"], strict=True)
    with torch.no_grad():
        port_full = port_full(torch.as_tensor(audio))["frame"].numpy()
    return dict(port=port, jax_full=jax_full, jax_tp=jax_tp, port_full=port_full,
                jax_runs=jax_runs, init=init)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("ref", ["port_full", "rank_full", "jax_full", "jax_tp"])
def test_tp_beats_matches_the_full_beats(runs, rank, ref):
    res = runs["port"][rank]
    assert res["local_heads"] == TINY["encoder_attention_heads"] // 2
    want = res["full"].numpy() if ref == "rank_full" else runs[ref]
    got = res["tp"].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=_bound(want), err_msg=ref)


def test_tp_beats_is_frozen_and_ranks_agree(runs):
    r0, r1 = runs["port"]
    assert r0["beats_unchanged"] and r1["beats_unchanged"]
    assert r0["grad_free"] and r1["grad_free"]
    assert torch.equal(r0["tp"], r1["tp"])  # the sums' all-reduce gives both the same bits
    for i in range(STEPS):
        assert r0["runs"][i]["metrics"] == r1["runs"][i]["metrics"]
        for key in ("student", "teacher", "grads"):
            for name, t in r0["runs"][i][key].items():
                assert torch.equal(t, r1["runs"][i][key][name]), f"{key} {name}"


def _is_conv_bias(name):
    return name.startswith("cnn.conv") and name.endswith(".bias")


@pytest.mark.parametrize("i", range(STEPS))
def test_e2e_step_metrics_match_jax(runs, i):
    mj, mt = runs["jax_runs"][i]["metrics"], runs["port"][0]["runs"][i]["metrics"]
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=2e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_e2e_step_gradients_match_jax(runs, i):
    gj, gt = runs["jax_runs"][i]["grads"], runs["port"][0]["runs"][i]["grads"]
    assert set(gt) == set(gj)
    scale = max(float(g.abs().max()) for g in gj.values())
    assert float(gj["cat_tf.weight"].abs().max()) > 0  # the embeddings reach the loss
    for name, want in gj.items():
        got = gt[name]
        if _is_conv_bias(name):
            assert float(got.abs().max()) <= 1e-6 * scale, name
            assert float(want.abs().max()) <= 1e-5 * scale, name  # JAX's XLA chain
            continue
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * float(want.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_e2e_step_weights_and_bn_stats_match_jax(runs, i, who):
    jr, pr, init = runs["jax_runs"][i][who], runs["port"][0]["runs"][i][who], runs["init"]
    assert set(pr) == set(jr)
    lr0 = LR * np.exp(-5.0)
    for name, want in jr.items():
        got = pr[name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=name)
        elif _is_conv_bias(name):
            assert float((got - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
            assert float((want - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=5e-7, msg=name)
