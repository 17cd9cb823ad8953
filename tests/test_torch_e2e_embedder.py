"""BEATs inside the train step and the serving forward: the port's
`make_train_step(..., embedder=frame_embedder(beats))` and
`InferencePipeline(..., embedder=...)` against JAX's step with
`embedder=(apply, variables)` and JAX's `_forward_impl`, on the CPU.

A narrow 2-block pool1d CRNN (32 mels, embeddings 64 wide) and a tiny BEATs
(2 layers, 64 wide; 24 tokens for half-second clips), 3 slots, dropout,
dropstep and mixup off, so both steps are deterministic; the batch carries
no embeddings, so each step computes them from the batch audio. JAX runs
its XLA chain (`fused_blocks=False, rnn_pallas=False`); its optimizer is
chained behind an identity transform that keeps the gradients it sees.

Tolerances, as tests/test_torch_train_step.py's (fp32 end to end, sums in
another order): metrics 2e-5 relative (1e-9 absolute for the consistency
losses); gradients 2e-4 of each tensor's largest entry (the conv biases'
exact gradient is 0: the port's below 1e-6 of the largest gradient, the
XLA chain's below 1e-5, where it measures up to 3.4e-6);
updated student and teacher 5e-7 absolute (a conv bias moves by at most 4
times the step's learning rate); BatchNorm statistics 2e-5. The embedder's
weights are bitwise unchanged and hold no gradient. Serving: scores within
1e-5 absolute.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.inference.pipeline import InferencePipeline as JaxPipeline
from desed_task_tpu.labels import ManyHotEncoder as JaxEncoder
from desed_task_tpu.models.beats import BEATsConfig as JaxBEATsConfig
from desed_task_tpu.models.beats import BEATsModel as JaxBEATs
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops.frontend import MelConfig as JaxMel
from desed_task_tpu.training import mean_teacher as jmt
from desed_task_tpu_torch.inference.pipeline import InferencePipeline
from desed_task_tpu_torch.labels import ManyHotEncoder
from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel
from desed_task_tpu_torch.models.convert import from_jax_embedder_params, from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops.frontend import MelConfig
from desed_task_tpu_torch.tools.embeddings import frame_embedder
from desed_task_tpu_torch.training import (
    MeanTeacherConfig, SlotSpec, create_state, make_optimizer, make_train_step)

N_MELS, N_CLASS, E, TE, N_SAMPLES = 32, 3, 64, 24, 8000
TINY = dict(embed_dim=32, encoder_layers=2, encoder_embed_dim=E, encoder_ffn_embed_dim=128,
            encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4, num_buckets=32,
            max_distance=64)
NET = dict(
    nclass=N_CLASS, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 2]], dropout=0.0,
    dropstep_recurrent=0.0, specaugm_t_p=0.0, specaugm_f_p=0.0, use_embeddings=True,
    embedding_size=E, aggregation_type="pool1d",
)
LR, RAMPUP, STEPS = 1e-3, 10, 2
CFG = dict(
    slots=(SlotSpec("strong", 2, "strong"), SlotSpec("weak", 2, "weak"),
           SlotSpec("unlabeled", 2, "unlabeled")),
    mixup=None, consistency_start_slot=1, rampup_steps=RAMPUP, decay_steps=1,
)


def _batch(with_embeddings=False, micro=None):
    r = np.random.default_rng(0)
    batch = {}
    for i, name in enumerate(("strong", "weak", "unlabeled")):
        lead = (2,) if micro is None else (micro, 2)
        cm = np.ones((*lead, N_CLASS), bool)
        cm[..., i % 2, (i + 1) % N_CLASS] = False
        batch[name] = {
            "audio": (r.standard_normal((*lead, N_SAMPLES)) * 0.1).astype(np.float32),
            "labels": (r.random((*lead, N_CLASS, 8)) > 0.6).astype(np.float32),
            "class_mask": cm,
        }
        if with_embeddings:
            batch[name]["embeddings"] = r.standard_normal((*lead, E, TE)).astype(np.float32)
    return batch


def _perturbed(tree, seed, scale=0.1):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (scale * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def _keep_grads():
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def beats_pair():
    jb = JaxBEATs(JaxBEATsConfig(**TINY))
    variables = {"params": _perturbed(
        jb.init(jax.random.key(3), jnp.zeros((1, N_SAMPLES)))["params"], 4, 0.05)}
    port = BEATsModel(BEATsConfig(**TINY))
    port.load_state_dict(from_jax_embedder_params(variables["params"]), strict=True)
    for p in port.parameters():
        p.requires_grad_(False)
    return jb, variables, port.eval()


@pytest.fixture(scope="module")
def runs(beats_pair):
    jb, jvars, port_beats = beats_pair
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

    model = CRNN(n_mels=N_MELS, **NET)
    model.load_state_dict(from_jax_params(params, stats), strict=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    beats_before = {k: v.clone() for k, v in port_beats.state_dict().items()}
    opt, sched_t = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched_t,
                           mel_cfg=MelConfig(n_mels=N_MELS), embedder=frame_embedder(port_beats))
    port_runs = []
    for _ in range(STEPS):
        metrics = step(st, batch, torch.Generator().manual_seed(1))
        port_runs.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.clone() for n, p in st.student.named_parameters()},
            student={k: v.clone() for k, v in st.student.state_dict().items()},
            teacher={k: v.clone() for k, v in st.teacher.state_dict().items()}))
    return jax_runs, port_runs, init, st, beats_before


def _is_conv_bias(name):
    return name.startswith("cnn.conv") and name.endswith(".bias")


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_match(runs, i):
    jr, pr = runs[0][i]["metrics"], runs[1][i]["metrics"]
    assert set(pr) == set(jr)
    for k in jr:
        np.testing.assert_allclose(pr[k], jr[k], rtol=2e-5, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("i", range(STEPS))
def test_gradients_match(runs, i):
    gj, gt = runs[0][i]["grads"], runs[1][i]["grads"]
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
def test_updated_weights_and_bn_stats_match(runs, i, who):
    jr, pr, init = runs[0][i][who], runs[1][i][who], runs[2]
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


def test_embedder_stays_frozen_and_outside_the_state(runs, beats_pair):
    port_beats = beats_pair[2]
    _, _, _, st, before = runs
    for k, v in port_beats.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in port_beats.parameters())
    n_student = sum(1 for _ in st.student.parameters())
    assert len(st.opt_state["mu"]) == n_student
    assert not any(k.startswith("encoder.") for k in st.student.state_dict())


def test_accumulate_two_builds_and_runs(beats_pair):
    port_beats = beats_pair[2]
    calls = []
    emb = frame_embedder(port_beats)

    def counting(audio):
        calls.append(audio.shape[0])
        return emb(audio)

    model = CRNN(n_mels=N_MELS, **NET)
    opt, sched = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")
    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched,
                           mel_cfg=MelConfig(n_mels=N_MELS), embedder=counting, accumulate=2)
    metrics = step(st, _batch(micro=2), torch.Generator().manual_seed(2))
    assert calls == [6, 6] and st.step == 1
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_batch_embeddings_bypass_the_embedder(beats_pair):
    model = CRNN(n_mels=N_MELS, **NET)
    opt, sched = make_optimizer(LR, RAMPUP)
    st = create_state(model, MeanTeacherConfig(**CFG), opt, device="cpu")

    def refuse(audio):
        raise AssertionError("called although the batch carries embeddings")

    step = make_train_step(MeanTeacherConfig(**CFG), opt, sched,
                           mel_cfg=MelConfig(n_mels=N_MELS), embedder=refuse)
    step(st, _batch(True), torch.Generator().manual_seed(2))


def test_serving_forward_with_beats_matches_jax(beats_pair):
    jb, jvars, port_beats = beats_pair
    net = {**NET, "pooling": [[2, 4], [2, 4]]}
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    r = np.random.default_rng(9)
    variables = jm.init({"params": jax.random.key(0)}, np.zeros((1, N_MELS, 32), np.float32),
                        embeddings=np.zeros((1, E, TE), np.float32))
    variables = _perturbed(variables, 10, 0.2)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    audio = (r.standard_normal((3, N_SAMPLES)) * 0.1).astype(np.float32)
    common = dict(median_filter=[3, 3, 3], thresholds=(0.5,), batch_size=3)
    jpipe = JaxPipeline(jm, variables, JaxEncoder(["A", "B", "C"], 0.5, 2048, 256, 4, 16000),
                        mel_cfg=JaxMel(n_mels=N_MELS), embedder=(jb.apply, jvars), **common)
    tm = CRNN(n_mels=N_MELS, **net)
    tpipe = InferencePipeline(
        tm, from_jax_params(variables["params"], variables["batch_stats"]),
        ManyHotEncoder(["A", "B", "C"], 0.5, 2048, 256, 4, 16000),
        mel_cfg=MelConfig(n_mels=N_MELS), embedder=frame_embedder(port_beats), device="cpu",
        **common)
    sj, wj, _ = jpipe._forward(jnp.asarray(audio))  # jax.jit(_forward_impl)
    st, wt, _ = tpipe.forward(torch.from_numpy(audio))
    assert st.shape == sj.shape == (3, N_CLASS, 8)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-5)
    # the embeddings move the scores: zero embeddings give others
    s0, _, _ = tpipe.forward(torch.from_numpy(audio), torch.zeros(3, E, TE))
    assert float((s0 - st).abs().max()) > 1e-3
