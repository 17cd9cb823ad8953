"""Gradient accumulation: two steps of the port's make_train_step(...,
accumulate=2) against JAX's on the same two micro-batches a step, with
mixup, dropout and dropstep at 0 (the narrow CRNN and 3 slots of
tests/test_torch_train_step.py). Compared: metrics (losses averaged over
the micro-batches), the averaged gradients before clip + Adam, the updated
student and teacher, and both models' BatchNorm running statistics chained
through the micro-batches. Tolerances of tests/test_torch_train_step.py:
metrics 2e-5 relative, gradients 2e-4 of each tensor's largest entry,
parameters 5e-7, BN statistics 2e-5."""

import numpy as np
import optax
import pytest
import torch

import jax

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops import pallas_gru
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, create_state, make_optimizer, make_train_step)
from test_torch_train_step import (
    CFG, E, LR, N_CLASS, N_MELS, N_SAMPLES, NET, RAMPUP, TE, _is_conv_bias, _keep_grads,
    _perturbed)

ACC, STEPS = 2, 2


def _micro(seed):
    r = np.random.default_rng(seed)
    out = {}
    for i, name in enumerate(("strong", "weak", "unlabeled")):
        cm = np.ones((2, N_CLASS), bool)
        cm[(i + seed) % 2, (i + 1) % N_CLASS] = False
        out[name] = {
            "audio": (r.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32),
            "labels": (r.random((2, N_CLASS, 8)) > 0.6).astype(np.float32),
            "embeddings": r.standard_normal((2, E, TE)).astype(np.float32),
            "class_mask": cm,
        }
    return out


def _batch(step):
    """One accumulated batch: every leaf [ACC, ...], micro-batches differ."""
    micros = [_micro(10 * step + i) for i in range(ACC)]
    return {s: {k: np.stack([m[s][k] for m in micros]) for k in micros[0][s]}
            for s in micros[0]}


@pytest.fixture(scope="module")
def runs():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    try:
        cfg_j = jmt.MeanTeacherConfig(**{**CFG, "slots": tuple(
            jmt.SlotSpec(s.name, s.size, s.role) for s in CFG["slots"])})
        model_j = JaxCRNN(**NET, fused_blocks="interpret", rnn_pallas=True)
        tx, sched = jmt.make_optimizer(LR, RAMPUP)
        tx = optax.chain(_keep_grads(), tx)
        mel_j = JaxMel(n_mels=N_MELS)
        state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), _micro(0),
                                 mel_cfg=mel_j)
        params = _perturbed(state.student_params, 1)
        stats = jax.device_get(state.student_stats)
        state = state.replace(student_params=params, teacher_params=params,
                              student_stats=stats, teacher_stats=stats,
                              opt_state=tx.init(params))
        step_j = jax.jit(jmt.make_train_step(model_j, cfg_j, tx, sched, mel_cfg=mel_j,
                                             accumulate=ACC))
        jax_runs = []
        for i in range(STEPS):
            state, metrics = step_j(state, _batch(i), jax.random.key(1))
            jax_runs.append(dict(
                metrics={k: float(v) for k, v in metrics.items()},
                grads=from_jax_params(jax.device_get(state.opt_state[0])),
                student=from_jax_params(jax.device_get(state.student_params),
                                        jax.device_get(state.student_stats)),
                teacher=from_jax_params(jax.device_get(state.teacher_params),
                                        jax.device_get(state.teacher_stats))))
    finally:
        pallas_gru.INTERPRET = old

    model = CRNN(n_mels=N_MELS, **NET)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched_t = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched_t,
                           mel_cfg=MelConfig(n_mels=N_MELS), accumulate=ACC)
    port_runs = []
    for i in range(STEPS):
        metrics = step(st, _batch(i), torch.Generator().manual_seed(1))
        port_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in st.student.named_parameters()},
            student={k: v.clone() for k, v in st.student.state_dict().items()},
            teacher={k: v.clone() for k, v in st.teacher.state_dict().items()}))
    return jax_runs, port_runs, init, st


@pytest.mark.parametrize("i", range(STEPS))
def test_accumulated_metrics_match(runs, i):
    jr, pr, _, _ = runs
    mj, mt = jr[i]["metrics"], pr[i]["metrics"]
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=2e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_averaged_gradients_match(runs, i):
    jr, pr, _, _ = runs
    gj, gt = jr[i]["grads"], pr[i]["grads"]
    assert set(gt) == set(gj)
    scale = max(float(g.abs().max()) for g in gj.values())
    for name, want in gj.items():
        got = gt[name]
        if _is_conv_bias(name):
            assert float(got.abs().max()) <= 1e-6 * scale, name
            assert float(want.abs().max()) <= 1e-6 * scale, name
            continue
        torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * float(want.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_accumulated_weights_and_chained_bn_stats_match(runs, i, who):
    jr, pr, init, _ = runs
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


def test_one_optimizer_step_per_accumulated_batch(runs):
    _, _, _, st = runs
    assert st.step == STEPS
    assert st.opt_state["count"] == STEPS
    opt, sched = make_optimizer(LR, RAMPUP)
    with pytest.raises(ValueError):
        make_train_step(MeanTeacherConfig(**CFG), opt, sched, accumulate=0)
