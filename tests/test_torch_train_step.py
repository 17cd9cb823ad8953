"""One and two steps of the port's mean-teacher train step against JAX
`make_train_step`, on a narrow 2-block pool1d CRNN (F' = 8 > 1), 32 mels,
half-second clips and 3 slots, with dropout, dropstep and mixup at 0 so
both steps are deterministic. JAX runs its fused Pallas blocks and its
Pallas GRU in interpret mode; the port runs its fused blocks and its GRU
Function (plain versions on the CPU). The JAX optimizer is chained behind
an identity transform that keeps the gradients it sees in its state, so the
gradients before clipping and Adam are compared directly.

Tolerances (fp32 end to end, sums in another order):
  * metrics: 2e-5 relative; 1e-9 absolute for the consistency losses,
    which at step 2 are squares of nearly equal outputs (~2e-9);
  * gradients: 2e-4 of each tensor's largest entry; the conv biases' exact
    gradient is 0 under train-mode BatchNorm, both sides give noise below
    1e-6 of the largest gradient;
  * updated student and teacher: 5e-7 absolute, a twentieth of the first
    step's learning rate (6.7e-6), except that a conv bias moves by at most
    the learning rate (Adam turns its noise gradient into a step of either
    sign);
  * BatchNorm running statistics: 2e-5 absolute.
Also: bce at p in {0, 1}, mse and ExponentialWarmup against the JAX module.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops import pallas_gru
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.training import losses as jlosses
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu.training.schedulers import ExponentialWarmup as JaxWarmup
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import (
    ExponentialWarmup, MeanTeacherConfig, SlotSpec, create_state, make_optimizer,
    make_train_step)
from desed_task_tpu_torch.training.losses import bce, mse

N_MELS, N_CLASS, E, TE, N_SAMPLES = 32, 3, 12, 17, 8000
NET = dict(
    nclass=N_CLASS, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 2]], dropout=0.0,
    dropstep_recurrent=0.0, specaugm_t_p=0.0, specaugm_f_p=0.0, use_embeddings=True,
    embedding_size=E, aggregation_type="pool1d",
)
LR, RAMPUP = 1e-3, 10
CFG = dict(
    slots=(SlotSpec("strong", 2, "strong"), SlotSpec("weak", 2, "weak"),
           SlotSpec("unlabeled", 2, "unlabeled")),
    mixup=None, consistency_start_slot=1, rampup_steps=RAMPUP, decay_steps=1,
)
STEPS = 2


def _batch():
    r = np.random.default_rng(0)
    batch = {}
    for i, name in enumerate(("strong", "weak", "unlabeled")):
        cm = np.ones((2, N_CLASS), bool)
        cm[i % 2, (i + 1) % N_CLASS] = False
        batch[name] = {
            "audio": (r.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32),
            "labels": (r.random((2, N_CLASS, 8)) > 0.6).astype(np.float32),
            "embeddings": r.standard_normal((2, E, TE)).astype(np.float32),
            "class_mask": cm,
        }
    return batch


def _keep_grads():
    """An identity transform whose state is the last gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _perturbed(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


@pytest.fixture(scope="module")
def runs():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    try:
        batch = _batch()
        cfg_j = jmt.MeanTeacherConfig(**{**CFG, "slots": tuple(
            jmt.SlotSpec(s.name, s.size, s.role) for s in CFG["slots"])})
        model_j = JaxCRNN(**NET, fused_blocks="interpret", rnn_pallas=True)
        tx, sched = jmt.make_optimizer(LR, RAMPUP)
        tx = optax.chain(_keep_grads(), tx)
        mel_j = JaxMel(n_mels=N_MELS)
        state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), batch, mel_cfg=mel_j)
        params = _perturbed(state.student_params, 1)
        stats = jax.device_get(state.student_stats)
        state = state.replace(student_params=params, teacher_params=params,
                              student_stats=stats, teacher_stats=stats,
                              opt_state=tx.init(params))
        step_j = jax.jit(jmt.make_train_step(model_j, cfg_j, tx, sched, mel_cfg=mel_j))
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
    finally:
        pallas_gru.INTERPRET = old

    model = CRNN(n_mels=N_MELS, **NET)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched_t = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched_t,
                           mel_cfg=MelConfig(n_mels=N_MELS))
    port_runs = []
    for _ in range(STEPS):
        metrics = step(st, batch, torch.Generator().manual_seed(1))
        port_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in st.student.named_parameters()},
            student={k: v.clone() for k, v in st.student.state_dict().items()},
            teacher={k: v.clone() for k, v in st.teacher.state_dict().items()}))
    return jax_runs, port_runs, init, st


def _is_conv_bias(name):
    return name.startswith("cnn.conv") and name.endswith(".bias")


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match(runs, i):
    jr, pr, _, _ = runs
    mj, mt = jr[i]["metrics"], pr[i]["metrics"]
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=2e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients_match(runs, i):
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
def test_updated_weights_and_bn_stats_match(runs, i, who):
    jr, pr, init, _ = runs
    want_sd, got_sd = jr[i][who], pr[i][who]
    assert set(got_sd) == set(want_sd)
    lr0 = LR * np.exp(-5.0)  # schedule(0)
    for name, want in want_sd.items():
        got = got_sd[name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=name)
        elif _is_conv_bias(name):
            # each Adam step moves a parameter by at most its learning rate
            # (1.7e-5 at step 1); the teacher follows by EMA
            assert float((got - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
            assert float((want - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=5e-7, msg=name)


def test_state_step_and_teacher_copy(runs):
    _, _, init, st = runs
    assert st.step == STEPS
    assert all(not p.requires_grad for p in st.teacher.parameters())
    for (n, s), (_, t) in zip(st.student.named_parameters(), st.teacher.named_parameters()):
        assert s.data_ptr() != t.data_ptr(), n


@pytest.mark.parametrize("p", [0.0, 1.0, 0.3])
def test_bce_matches_jax(p):
    probs = np.array([p, p, 0.5, p], np.float32)
    target = np.array([0.0, 1.0, 1.0, 0.7], np.float32)
    got = float(bce(torch.from_numpy(probs), torch.from_numpy(target)))
    want = float(jlosses.bce(jnp.asarray(probs), jnp.asarray(target)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mse_matches_jax():
    r = np.random.default_rng(5)
    a, b = r.standard_normal((2, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(float(mse(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jlosses.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


@pytest.mark.parametrize("anneal", [False, True])
def test_exponential_warmup_matches_jax(anneal):
    kw = dict(start_annealing=200, max_steps=400) if anneal else {}
    sj, st = JaxWarmup(1e-3, 100, **kw), ExponentialWarmup(1e-3, 100, **kw)
    for s in [0, 1, 10, 50, 99, 100, 150, 200, 250, 399, 400]:
        np.testing.assert_allclose(float(st(s)), float(sj(s)), rtol=1e-6, err_msg=str(s))
        np.testing.assert_allclose(float(st.scaling_factor(torch.tensor(s))),
                                   float(sj.scaling_factor(s)), rtol=1e-6)
    assert float(ExponentialWarmup(1e-3, 0)(5)) == pytest.approx(1e-3)


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_adam_matches_optax(max_norm):
    """Three updates of clip-by-global-norm + Adam with the warmup schedule,
    clipping active (0.5) and not (50), against optax on the same gradients."""
    r = np.random.default_rng(7)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [r.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[r.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    tx, _ = jmt.make_optimizer(1e-2, 5, max_grad_norm=max_norm)
    pj = [jnp.asarray(p) for p in params]
    sj = tx.init(pj)
    opt, _ = make_optimizer(1e-2, 5, max_grad_norm=max_norm)
    pt = [torch.from_numpy(p.copy()) for p in params]
    st = opt.init(pt)
    for g in grads:
        uj, sj = tx.update([jnp.asarray(x) for x in g], sj, pj)
        pj = optax.apply_updates(pj, uj)
        norm = opt.step(pt, [torch.from_numpy(x) for x in g], st)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=1e-6)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def test_kernel_and_plain_forms_draw_the_same_masks():
    """With every random part on (conv dropout, dropstep, SpecAugment, RNN
    and inter-layer dropout, mixup), the fused/Function form and the plain
    form consume a generator alike: same metrics and gradients over two
    steps. On the CPU both run plain arithmetic, so only sum order differs:
    gradients within 1e-4 of each tensor's largest entry (the attention
    softmax bias, whose gradient cancels over classes, differs by 1.1e-5)."""
    from desed_task_tpu_torch.models.crnn import init_weights
    from desed_task_tpu_torch.recipes_config import mean_teacher_2021

    net = dict(NET, dropout=0.5, dropstep_recurrent=0.3, dropstep_recurrent_len=4,
               specaugm_t_p=0.2, specaugm_f_p=0.2, n_layers_RNN=2, dropout_recurrent=0.2)
    cfg = mean_teacher_2021(batch_sizes=(2, 2, 2), steps_per_epoch=2)
    r = np.random.default_rng(3)
    batch = {s.name: {"audio": (r.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32),
                      "labels": (r.random((2, N_CLASS, 8)) > 0.6).astype(np.float32),
                      "embeddings": r.standard_normal((2, E, TE)).astype(np.float32)}
             for s in cfg.slots}
    runs = []
    for kernels in (True, False):
        model = init_weights(CRNN(n_mels=N_MELS, fused_blocks=kernels, rnn_kernel=kernels, **net),
                             torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(LR, RAMPUP)
        st = create_state(model, cfg, opt, device="cpu")
        step = make_train_step(cfg, opt, sched, mel_cfg=MelConfig(n_mels=N_MELS))
        gen = torch.Generator().manual_seed(4)
        metrics = [step(st, batch, gen) for _ in range(2)]
        runs.append((metrics, {n: p.grad for n, p in st.student.named_parameters()}))
    (mk, gk), (mp, gp) = runs
    for a, b in zip(mk, mp):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-9, msg=k)
    scale = max(float(b.abs().max()) for b in gp.values())
    for n, b in gp.items():  # conv biases: noise around 0, held to the global scale
        ref = scale if _is_conv_bias(n) else float(b.abs().max())
        err = float((gk[n] - b).abs().max()) / ref
        assert err <= 1e-4, (n, err)


def test_optional_branches_run():
    """frame_shift, add_noise, hard mixup and 2021-style weak targets
    (weak_labels_post_mixup=False): the step runs, counts, keeps the batch
    unchanged and its losses finite."""
    import dataclasses

    from desed_task_tpu_torch.recipes_config import mean_teacher_2021

    cfg = dataclasses.replace(mean_teacher_2021(batch_sizes=(2, 2, 2), steps_per_epoch=2),
                              mixup="hard", mixup_prob=1.0, frame_shift_std=9.0,
                              add_noise_snrs=(6.0, 30.0), net_pooling=4)
    r = np.random.default_rng(5)
    batch = {s.name: {"audio": (r.standard_normal((2, N_SAMPLES)) * 0.1).astype(np.float32),
                      "labels": (r.random((2, N_CLASS, 8)) > 0.6).astype(np.float32),
                      "embeddings": r.standard_normal((2, E, TE)).astype(np.float32)}
             for s in cfg.slots}
    before = {k: {n: a.copy() for n, a in v.items()} for k, v in batch.items()}
    opt, sched = make_optimizer(LR, RAMPUP)
    st = create_state(CRNN(n_mels=N_MELS, **NET), cfg, opt, device="cpu")
    step = make_train_step(cfg, opt, sched, mel_cfg=MelConfig(n_mels=N_MELS))
    gen = torch.Generator().manual_seed(6)
    for _ in range(2):
        metrics = step(st, batch, gen)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert st.step == 2 and st.opt_state["count"] == 2
    for k, v in batch.items():
        for n, a in v.items():
            np.testing.assert_array_equal(a, before[k][n])
