"""Two steps of the port's bf16 mean-teacher train step against JAX's, on
the narrow CRNN of tests/test_torch_train_step.py (32 mels, 2 blocks of 8
and 16 channels, half-second clips, 3 slots; dropout, dropstep and mixup at
0, so both steps are deterministic).

The bf16 step is `bench.py`'s: the CRNN with compute_dtype bf16 (the conv
stack in bf16 through the four conv-block kernels' bf16 mode; the BiGRU and
heads in fp32) and MelConfig(compute_dtype="bfloat16"). JAX runs its fused
Pallas blocks and its Pallas GRU in interpret mode; the port runs its fused
blocks and its GRU Function (the plain versions on the CPU). Gradients are
kept before clipping and Adam (an identity optax transform in front).

The port's bf16 step is held to JAX's bf16 step against JAX's own
bf16-vs-fp32 gap (a missing rounding point would put the port near the
fp32 step), per tensor, over both steps:
  * gradients kept in fp32 (BatchNorm, BiGRU, heads): max |port - JAX bf16|
    at most a quarter of max |JAX fp32 - JAX bf16| (measured <= 0.19);
  * bf16-valued gradients (conv and GLU Dense kernels, GLU Dense biases):
    the mean |gap| at most a quarter of the mean bf16-vs-fp32 gap (measured
    <= 0.23), and no entry further than one bf16 step at the tensor's scale
    (measured 0.88 of it). Not the max against the max: JAX's own
    bf16-vs-fp32 gap there is 1-1.7 % of the tensor's max, one or two bf16
    steps, and a single rounding that flips because an fp32 sum ran in
    another order (the cotangent reaches the CNN rounded to bf16) is one
    step: 31-62 % of that gap on the largest entry;
  * the conv biases: their exact gradient is 0 under train-mode BatchNorm;
    in bf16 it is the noise of dy rounded to bf16 (up to 1.2e-3 of the
    step's largest gradient, both sides), held to JAX's within 1e-3 of that
    scale (measured 3.0e-4);
  * metrics: the losses and the gradient norm within 1e-3 relative
    (measured 1.7e-4), the consistency losses (squares of nearly equal
    outputs at step 2) within a quarter of their bf16-vs-fp32 gap (measured
    0.025); the supervised losses nearer JAX's bf16 step than a quarter of
    its fp32 step's distance;
  * updated student and teacher, BatchNorm statistics included: within a
    quarter of their bf16-vs-fp32 gap or 5e-7 (measured <= 0.036), except
    the conv biases, which move by at most the learning rate a step (Adam
    turns their noise gradient into a step of either sign).
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
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, create_state, make_optimizer, make_train_step)

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
BF16_STEP = 2.0 ** -7
# the conv biases' gradients: noise below CONV_BIAS_NOISE of the step's
# largest gradient on both sides, within CONV_BIAS_TOL of it of each other
CONV_BIAS_NOISE, CONV_BIAS_TOL = 3e-3, 1e-3
SELF_SUP = ("strong_self_sup_loss", "weak_self_sup_loss", "tot_self_loss")


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


def _jax_runs(batch, params, stats, dtype):
    kw = {} if dtype is None else {"compute_dtype": jnp.bfloat16}
    cfg_j = jmt.MeanTeacherConfig(**{**CFG, "slots": tuple(
        jmt.SlotSpec(s.name, s.size, s.role) for s in CFG["slots"])})
    model_j = JaxCRNN(**NET, fused_blocks="interpret", rnn_pallas=True, **kw)
    tx, sched = jmt.make_optimizer(LR, RAMPUP)
    tx = optax.chain(_keep_grads(), tx)
    mel_j = JaxMel(n_mels=N_MELS, **({} if dtype is None else {"compute_dtype": "bfloat16"}))
    state = jmt.create_state(model_j, cfg_j, tx, jax.random.key(0), batch, mel_cfg=mel_j)
    if params is None:
        r = np.random.default_rng(1)
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32),
            jax.device_get(state.student_params))
        stats = jax.device_get(state.student_stats)
    state = state.replace(student_params=params, teacher_params=params, student_stats=stats,
                          teacher_stats=stats, opt_state=tx.init(params))
    step = jax.jit(jmt.make_train_step(model_j, cfg_j, tx, sched, mel_cfg=mel_j))
    runs = []
    for _ in range(STEPS):
        state, metrics = step(state, batch, jax.random.key(1))
        runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=from_jax_params(jax.device_get(state.opt_state[0])),
            student=from_jax_params(jax.device_get(state.student_params),
                                    jax.device_get(state.student_stats)),
            teacher=from_jax_params(jax.device_get(state.teacher_params),
                                    jax.device_get(state.teacher_stats))))
    return runs, params, stats


@pytest.fixture(scope="module")
def runs():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    try:
        batch = _batch()
        jax16, params, stats = _jax_runs(batch, None, None, jnp.bfloat16)
        jax32, _, _ = _jax_runs(batch, params, stats, None)
    finally:
        pallas_gru.INTERPRET = old

    model = CRNN(n_mels=N_MELS, **NET, compute_dtype=torch.bfloat16)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched,
                           mel_cfg=MelConfig(n_mels=N_MELS, compute_dtype="bfloat16"))
    port = []
    for _ in range(STEPS):
        metrics = step(st, batch, torch.Generator().manual_seed(1))
        port.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in st.student.named_parameters()},
            student={k: v.clone() for k, v in st.student.state_dict().items()},
            teacher={k: v.clone() for k, v in st.teacher.state_dict().items()}))
    return jax16, jax32, port, init


def _is_conv_bias(name):
    return name.startswith("cnn.conv") and name.endswith(".bias")


@pytest.mark.parametrize("i", range(STEPS))
def test_bf16_metrics_match(runs, i):
    j16, j32, pr, _ = runs
    mj, mf, mt = j16[i]["metrics"], j32[i]["metrics"], pr[i]["metrics"]
    assert set(mt) == set(mj)
    for k in mj:
        gap = abs(mt[k] - mj[k])
        if k in SELF_SUP:
            assert gap <= max(1e-3 * abs(mj[k]), abs(mf[k] - mj[k]) / 4), k
        else:
            np.testing.assert_allclose(mt[k], mj[k], rtol=1e-3, atol=0, err_msg=k)
    for k in ("loss_strong", "loss_weak"):
        assert abs(mt[k] - mj[k]) <= abs(mf[k] - mj[k]) / 4, k


@pytest.mark.parametrize("i", range(STEPS))
def test_bf16_gradients_match(runs, i):
    j16, j32, pr, _ = runs
    g16, g32, gt = j16[i]["grads"], j32[i]["grads"], pr[i]["grads"]
    assert set(gt) == set(g16)
    scale = max(float(g.abs().max()) for g in g16.values())
    for name, want in g16.items():
        got, fp32 = gt[name], g32[name]
        if _is_conv_bias(name):
            assert float(want.abs().max()) <= CONV_BIAS_NOISE * scale, name
            assert float(got.abs().max()) <= CONV_BIAS_NOISE * scale, name
            assert float((got - want).abs().max()) <= CONV_BIAS_TOL * scale, name
            continue
        if torch.equal(want, want.to(torch.bfloat16).float()):  # a bf16-valued gradient
            gap, precision_gap = (float((a - want).abs().mean()) for a in (got, fp32))
            assert float((got - want).abs().max()) <= BF16_STEP * float(want.abs().max()), name
        else:
            gap, precision_gap = (float((a - want).abs().max()) for a in (got, fp32))
        assert precision_gap > 0, name
        assert gap <= precision_gap / 4, (name, gap / precision_gap)


def test_bf16_conv_gradients_are_bf16_values(runs):
    """The conv kernels, conv biases, GLU Dense kernels and biases get bf16
    gradients (as bf16 values in their fp32 .grad), on both sides."""
    j16, _, pr, _ = runs
    for name, g in pr[0]["grads"].items():
        if name.startswith("cnn.conv") or name.startswith("cnn.glu"):
            assert torch.equal(g, g.to(torch.bfloat16).float()), name
            want = j16[0]["grads"][name]
            assert torch.equal(want, want.to(torch.bfloat16).float()), name


@pytest.mark.parametrize("i", range(STEPS))
@pytest.mark.parametrize("who", ["student", "teacher"])
def test_bf16_updated_weights_and_bn_stats_match(runs, i, who):
    j16, j32, pr, init = runs
    want_sd, got_sd = j16[i][who], pr[i][who]
    assert set(got_sd) == set(want_sd)
    lr0 = LR * np.exp(-5.0)  # schedule(0)
    for name, want in want_sd.items():
        got = got_sd[name]
        if _is_conv_bias(name):
            for v in (got, want):
                assert float((v - init[name]).abs().max()) <= 4 * lr0 * (i + 1), name
            continue
        gap = float((got - want).abs().max())
        precision_gap = float((j32[i][who][name] - want).abs().max())
        assert gap <= max(5e-7, precision_gap / 4), (name, gap, precision_gap)


def test_float_cast_rounds_the_cotangent():
    """The CRNN's .float() after the bf16 CNN hands the CNN its cotangent
    rounded to bf16 (JAX's astype VJP, desed_task_tpu/models/crnn.py:158)."""
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    x.requires_grad_()
    g = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    (x.float() * g).sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.equal(x.grad, g.to(torch.bfloat16))
