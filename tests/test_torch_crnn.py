"""Port CRNN eval forward against the JAX CRNN on converted weights.

The main case is a narrow 2-block pool1d model with F' > 1 (so the (f, c)
flatten order matters), the JAX side running its fused Pallas blocks and its
Pallas GRU in interpret mode and the port its fused blocks (plain versions on
the CPU). The other aggregation types and a multi-head model with masks run
the JAX XLA chain against the port's unfused chain."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops import pallas_gru
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN

N_MELS, T, E, TE = 32, 20, 12, 17
NET = dict(
    nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3, 3], padding=[1, 1],
    stride=[1, 1], nb_filters=[8, 16], pooling=[[2, 2], [2, 4]], dropout=0.0,
)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    yield
    pallas_gru.INTERPRET = old


def _jax_variables(model, x, emb, seed=0):
    """init, then every leaf (BN statistics included) perturbed from a seed."""
    variables = model.init(jax.random.key(seed), jnp.asarray(x),
                           embeddings=None if emb is None else jnp.asarray(emb))
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        * (1.0 if a.ndim else 0.0), jax.device_get(variables))


def _port(variables, **net):
    model = CRNN(n_mels=N_MELS, **net).eval()
    state = from_jax_params(variables["params"], variables.get("batch_stats"))
    model.load_state_dict(state, strict=True)
    return model


def _inputs(seed=1, b=2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, N_MELS, T)).astype(np.float32)
    emb = r.standard_normal((b, E, TE)).astype(np.float32)
    return x, emb


def test_pool1d_crnn_matches_jax_fused():
    net = dict(NET, use_embeddings=True, embedding_size=E, aggregation_type="pool1d")
    x, emb = _inputs()
    jm = JaxCRNN(**net, fused_blocks="interpret", rnn_pallas=True)
    variables = _jax_variables(jm, x, emb)
    sj, wj = jm.apply(variables, jnp.asarray(x), embeddings=jnp.asarray(emb))
    tm = _port(variables, **net)
    assert tm.cnn.out_freq(N_MELS) == 4  # F' > 1
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    assert s.shape == (2, 3, 5) and w.shape == (2, 3)
    # fp32 end to end; sigmoid / attention-pooled outputs in [0, 1]
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=2e-6)


@pytest.mark.parametrize("agg", ["interpolate", "global", "frame", None])
def test_other_configs_match_jax_unfused(agg):
    net = dict(NET)
    if agg is not None:
        net.update(use_embeddings=True, embedding_size=E, aggregation_type=agg,
                   frame_emb_enc_dim=6)
    x, emb = _inputs(seed=2)
    if agg == "global":  # clip-level embeddings [B, E]
        emb = np.ascontiguousarray(emb[:, :, 0])
    if agg is None:  # multi-head, attention, padded frames and class masks
        net.update(nclass=[2, 3])
        emb = None
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    variables = _jax_variables(jm, x, emb, seed=3)
    pad = np.zeros((2, 5), bool)
    pad[1, 3:] = True
    cm = np.ones((2, 5), bool)
    cm[0, 1] = cm[1, 4] = False
    kw_j, kw_t = {}, {}
    if emb is not None:
        kw_j["embeddings"], kw_t["embeddings"] = jnp.asarray(emb), torch.from_numpy(emb)
    else:
        kw_j.update(pad_mask=jnp.asarray(pad), classes_mask=jnp.asarray(cm))
        kw_t.update(pad_mask=torch.from_numpy(pad), classes_mask=torch.from_numpy(cm))
    sj, wj = jm.apply(variables, jnp.asarray(x), **kw_j)
    tm = _port(variables, **net, fused_blocks=False, rnn_kernel=False)
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), **kw_t)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=2e-6)


def test_from_jax_params_uses_every_leaf():
    net = dict(NET, use_embeddings=True, embedding_size=E, aggregation_type="pool1d")
    x, emb = _inputs()
    variables = _jax_variables(JaxCRNN(**net, fused_blocks=False), x, emb)
    state = from_jax_params(variables["params"], variables["batch_stats"])
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(state) == n_leaves
    assert set(state) == set(CRNN(n_mels=N_MELS, **net).state_dict())
    params = dict(variables["params"], extra={"kernel_scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="no rule"):
        from_jax_params(params, variables["batch_stats"])
