"""The port's separation ensemble (models/ensemble.py) and its mean-teacher
step (training/sepsed.py) against the JAX package's, on the CPU: a narrow
CRNN (2 blocks of 8 channels, a 2-layer BiGRU of 8 cells, 4 classes),
32 mels, half-second clips of 3 separated sources, 3 slots of 2 clips.
JAX runs its XLA chain (`fused_blocks=False`, `rnn_pallas=False`); the port
its fused blocks and GRU Function (their plain versions on the CPU), so
the multisrc branch goes through the conv block's Functions in eval-mode
BatchNorm with gradients, as on the card.

Tolerances (fp32, sums in another order):
  * features: sources and mixture within 2e-5 (min-max scaled to [0, 1]);
  * ensemble forward (eval): strong and weak within 1e-5;
  * two train steps with dropout and SpecAugment at 0 (the PRNG streams
    differ): metrics 2e-5 relative; gradients 2e-4 of each tensor's largest
    entry, q_logit's included; the updated student and teacher, and
    q_logit, 5e-7 absolute (a twentieth of the first step's learning rate).
    The multisrc CRNN's strong-head bias is lowered by HEAD_SHIFT so that
    the sums over the sources stay below the ensemble's clamp at 1 (a
    clamped sum passes no gradient); the largest gradient of its conv stack
    and of its BiGRU is checked to be above 1e-3 of the largest of all on
    both sides before the comparison;
  * the monaural branch's weights bitwise unchanged, outside the state.
"""

import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import CRNN as JaxCRNN
from desed_task_tpu.models import EnsembleModel as JaxEnsemble
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.ops.scaler import ScalerConfig as JaxScaler
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu.training import sepsed as jsepsed
from desed_task_tpu_torch.models import ensemble as tens
from desed_task_tpu_torch.models.convert import from_jax_ensemble_params, from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.ops.scaler import ScalerConfig
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, create_state, make_optimizer)
from desed_task_tpu_torch.training import sepsed as tsepsed

N_MELS, N_CLASS, N_SRC, N = 32, 4, 3, 8000
NET = dict(nclass=N_CLASS, n_RNN_cell=8, n_layers_RNN=2, kernel_size=[3, 3], padding=[1, 1],
           stride=[1, 1], nb_filters=[8, 8], pooling=[[2, 4], [2, 4]], dropout=0.0,
           specaugm_t_p=0.0, specaugm_f_p=0.0)
MEL = dict(n_fft=1024, win_length=1024, n_mels=N_MELS)
LR, RAMPUP = 1e-3, 10
SLOTS = (("synth", 2, "strong"), ("weak", 2, "weak"), ("unlabeled", 2, "unlabeled"))
T_LAB = (N // 256 + 1) // 4
# near init each source's sigmoid is about 0.5: lowered by 3, the sum of
# N_SRC of them stays well below the clamp at 1
HEAD_SHIFT = 3.0


def _jax_crnn(**kw):
    return JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False, **kw)


def _perturbed(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(np.shape(a))).astype(np.float32),
        jax.device_get(tree))


def _batch():
    r = np.random.default_rng(0)
    return {name: {
        "audio": (r.standard_normal((size, N_SRC, N)) * 0.1).astype(np.float32),
        "labels": (r.random((size, N_CLASS, T_LAB)) > 0.7).astype(np.float32),
    } for name, size, _ in SLOTS}


def _keep_grads():
    """An identity transform whose state is the last gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def weights():
    """Monaural variables and ensemble params + stats, perturbed from init."""
    mono = _jax_crnn()
    mono_vars = mono.init({"params": jax.random.key(9)}, jnp.zeros((1, N_MELS, 32)))
    mono_vars = {"params": _perturbed(mono_vars["params"], 1),
                 "batch_stats": jax.tree_util.tree_map(
                     lambda a: np.abs(a) + 0.5, _perturbed(mono_vars["batch_stats"], 2))}
    ens = JaxEnsemble(_jax_crnn(freeze_bn=True), mono)
    v = ens.init({"params": jax.random.key(0), "dropout": jax.random.key(1),
                  "augment": jax.random.key(2)}, jnp.zeros((1, N_SRC, N_MELS, 32)),
                 jnp.zeros((1, N_MELS, 32)), monaural_variables=mono_vars, train=True)
    params = _perturbed(v["params"], 3)
    params["multisrc_crnn"]["dense"]["bias"] -= HEAD_SHIFT
    stats = jax.tree_util.tree_map(lambda a: np.abs(a) + 0.5, _perturbed(v["batch_stats"], 4))
    return mono, mono_vars, ens, params, stats


def _port_ensemble(mono_vars, params, stats):
    monaural = CRNN(n_mels=N_MELS, **NET)
    monaural.load_state_dict(from_jax_params(mono_vars["params"], mono_vars["batch_stats"]))
    model = tens.EnsembleModel(CRNN(n_mels=N_MELS, **NET, freeze_bn=True), monaural)
    model.load_state_dict(from_jax_ensemble_params(params, stats), strict=True)
    return model


def test_featurize_matches_jax():
    audio = _batch()["synth"]["audio"]
    s, m = tsepsed.sepsed_featurize(torch.from_numpy(audio), None, MelConfig(**MEL),
                                    ScalerConfig())
    js, jm = jsepsed.sepsed_featurize(jnp.asarray(audio), None, JaxMel(**MEL), JaxScaler())
    assert s.shape == js.shape == (2, N_SRC, N_MELS, N // 256 + 1)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=2e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=2e-5)
    # the mixture branch is the log of the summed linear mels, not the mel
    # of the summed audio
    mix_audio, _ = tsepsed.sepsed_featurize(
        torch.from_numpy(audio.sum(1, keepdims=True)), None, MelConfig(**MEL), ScalerConfig())
    assert float((mix_audio[:, 0] - m).abs().max()) > 1e-3


def test_flatten_and_clamp():
    x = np.random.default_rng(1).random((2, 3, 4, 5)).astype(np.float32)
    flat = tens.flatten_sources(torch.from_numpy(x))
    assert flat.shape == (6, 4, 5)
    s, w = tens.unflatten_sum_clamp(flat, flat[:, :, 0], 3)
    np.testing.assert_array_equal(s.numpy(), np.clip(x.sum(1), 0, 1))
    np.testing.assert_array_equal(w.numpy(), np.clip(x[:, :, :, 0].sum(1), 0, 1))


@pytest.mark.parametrize("with_monaural", [True, False])
def test_ensemble_forward_matches_jax(weights, with_monaural):
    mono, mono_vars, ens, params, stats = weights
    r = np.random.default_rng(5)
    src = r.standard_normal((2, N_SRC, N_MELS, 32)).astype(np.float32)
    mix = r.standard_normal((2, N_MELS, 32)).astype(np.float32)
    js, jw = ens.apply({"params": params, "batch_stats": stats}, jnp.asarray(src),
                       jnp.asarray(mix), monaural_variables=mono_vars if with_monaural else None,
                       train=False)
    model = _port_ensemble(mono_vars, params, stats)
    if not with_monaural:
        model._monaural = None
    with torch.no_grad():
        s, w = model.eval()(torch.from_numpy(src), torch.from_numpy(mix))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-5)


def test_ensemble_keeps_the_monaural_branch_out_of_its_state(weights):
    _, mono_vars, _, params, stats = weights
    model = _port_ensemble(mono_vars, params, stats)
    assert all(k.startswith("multisrc_crnn.") or k == "q_logit" for k in model.state_dict())
    assert not any(p.requires_grad for p in model.monaural.parameters())
    teacher = copy.deepcopy(model)
    assert teacher.monaural is model.monaural  # shared, not copied
    assert teacher.multisrc_crnn is not model.multisrc_crnn
    model.train()
    assert model.multisrc_crnn.training and not model.monaural.training


@pytest.fixture(scope="module")
def runs(weights):
    mono, mono_vars, ens, params, stats = weights
    batch = _batch()
    cfg_j = jmt.MeanTeacherConfig(slots=tuple(jmt.SlotSpec(*s) for s in SLOTS), mixup=None,
                                  rampup_steps=RAMPUP)
    tx, sched = jmt.make_optimizer(LR, RAMPUP)
    tx = optax.chain(_keep_grads(), tx)
    mel_j = JaxMel(**MEL)
    state = jsepsed.create_sepsed_state(ens, mono_vars, cfg_j, tx, jax.random.key(0), batch,
                                        mel_j)
    state = state.replace(student_params=params, teacher_params=params, student_stats=stats,
                          teacher_stats=stats, opt_state=tx.init(params))
    step_j = jax.jit(jsepsed.make_sepsed_train_step(ens, mono_vars, cfg_j, tx, sched, mel_j))
    jax_runs = []
    for _ in range(2):
        state, metrics = step_j(state, batch, jax.random.key(1))
        get = jax.device_get
        jax_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=from_jax_ensemble_params(get(state.opt_state[0])),
            student=from_jax_ensemble_params(get(state.student_params),
                                             get(state.student_stats)),
            teacher=from_jax_ensemble_params(get(state.teacher_params),
                                             get(state.teacher_stats))))

    model = _port_ensemble(mono_vars, params, stats)
    mono_before = {k: v.clone() for k, v in model.monaural.state_dict().items()}
    cfg = MeanTeacherConfig(slots=tuple(SlotSpec(*s) for s in SLOTS), mixup=None,
                            rampup_steps=RAMPUP)
    opt, sched_t = make_optimizer(LR, RAMPUP)
    st = create_state(model, cfg, opt, device="cpu")
    step = tsepsed.make_sepsed_train_step(cfg, opt, sched_t, mel_cfg=MelConfig(**MEL))
    port_runs = []
    for _ in range(2):
        metrics = step(st, batch, torch.Generator().manual_seed(1))
        port_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in st.student.named_parameters()},
            student={k: v.clone() for k, v in st.student.state_dict().items()},
            teacher={k: v.clone() for k, v in st.teacher.state_dict().items()}))
    return jax_runs, port_runs, st, mono_before


@pytest.mark.parametrize("i", [0, 1])
def test_train_steps_match_jax(runs, i):
    jax_runs, port_runs, _, _ = runs
    j, t = jax_runs[i], port_runs[i]
    assert list(t["metrics"]) == list(j["metrics"])
    for k, v in j["metrics"].items():
        assert t["metrics"][k] == pytest.approx(v, rel=2e-5, abs=1e-9), k
    assert t["grads"].keys() == j["grads"].keys()
    assert "q_logit" in t["grads"]
    for grads in (t["grads"], j["grads"]):
        top = max(float(g.abs().max()) for g in grads.values())
        for part in ("multisrc_crnn.cnn.", "multisrc_crnn.rnn."):
            got = max(float(g.abs().max()) for n, g in grads.items() if n.startswith(part))
            assert got > 1e-3 * top, (part, got, top)
    for name, g in t["grads"].items():
        w = j["grads"][name]
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 2e-4 * scale, name
    for part in ("student", "teacher"):
        assert t[part].keys() == j[part].keys()
        for name, v in t[part].items():
            assert float((v - j[part][name]).abs().max()) <= 5e-7, (part, name)


def test_monaural_branch_unchanged(runs):
    _, _, st, mono_before = runs
    assert st.step == 2
    after = st.student.monaural.state_dict()
    assert all(torch.equal(after[k], v) for k, v in mono_before.items())
    assert st.teacher.monaural is st.student.monaural
    assert len(st.opt_state["mu"]) == len(list(st.student.parameters()))


def test_predict_step_restores_mode(weights):
    _, mono_vars, ens, params, stats = weights
    model = _port_ensemble(mono_vars, params, stats).train()
    audio = _batch()["weak"]["audio"]
    predict = tsepsed.make_sepsed_predict_step(MelConfig(**MEL))
    s, w = predict(model, torch.from_numpy(audio))
    assert model.training
    jpredict = jsepsed.make_sepsed_predict_step(ens, mono_vars, JaxMel(**MEL))
    js, jw = jpredict(params, stats, jnp.asarray(audio))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
