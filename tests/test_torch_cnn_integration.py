"""The CRNN's `cnn_integration` against the JAX package on the CPU.

The input [B, nc, n_mels, T] runs through the CNN as B * nc
single-channel maps and the CNN's output regroups the channels as JAX
does (feature c * nc + k), so the layers after the CNN are nc times wider.
nc = 2 and 3, without embeddings and with pool1d and global embeddings:
the eval forward in fp32 within 1e-5 of max(1, max |JAX|), the train
forward (dropout and SpecAugment zeroed) likewise and its gradients within
1e-4 of the largest JAX gradient; `forward_macs` against a count by hand;
SpecAugment on the 4-D input masks axes 1 and 2 (channel and mel), as
JAX's does, from the same uniforms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops import augment as jaugment
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.obs.macs import forward_macs
from desed_task_tpu_torch.ops import augment

N_MELS, T_FR, E, TE = 32, 20, 12, 17
NET = dict(nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3] * 2, padding=[1] * 2,
           stride=[1] * 2, nb_filters=[8, 16], pooling=[[2, 2], [2, 4]], dropout=0.0,
           cnn_integration=True, specaugm_t_p=0.0, specaugm_f_p=0.0)
EMB = {None: {}, "pool1d": dict(use_embeddings=True, embedding_size=E, aggregation_type="pool1d"),
       "global": dict(use_embeddings=True, embedding_size=E, aggregation_type="global")}
CASES = [(nc, agg) for nc in (2, 3) for agg in EMB]
IDS = [f"nc{nc}-{agg}" for nc, agg in CASES]


def _case(nc, agg, seed=0):
    r = np.random.default_rng(seed)
    x = (4.0 * r.standard_normal((2, nc, N_MELS, T_FR))).astype(np.float32)
    emb = None
    if agg == "pool1d":
        emb = r.standard_normal((2, E, TE)).astype(np.float32)
    elif agg == "global":
        emb = r.standard_normal((2, E)).astype(np.float32)
    net = dict(NET, n_in_channel=nc, **EMB[agg])
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    v = jm.init(jax.random.key(seed), jnp.asarray(x),
                embeddings=None if emb is None else jnp.asarray(emb))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        * (1.0 if a.ndim else 0.0), jax.device_get(v))
    v["batch_stats"] = jax.tree_util.tree_map(np.abs, v["batch_stats"])
    return jm, net, x, emb, v


def _port(net, v):
    tm = CRNN(n_mels=N_MELS, **net, rnn_kernel=False)
    tm.load_state_dict(from_jax_params(v["params"], v["batch_stats"]), strict=True)
    return tm


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("nc,agg", CASES, ids=IDS)
def test_eval_forward_matches_jax(nc, agg):
    jm, net, x, emb, v = _case(nc, agg)
    sj, wj = jm.apply(v, jnp.asarray(x), embeddings=_j(emb))
    tm = _port(net, v).eval()
    assert tm.rnn.weight_ih_l0.shape[1] == (16 * nc if agg else 4 * 16 * nc)
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=_t(emb))
    assert s.shape == (2, 3, 5)
    _close(s.numpy(), sj, 1e-5)
    _close(w.numpy(), wj, 1e-5)


@pytest.mark.parametrize("nc,agg", CASES, ids=IDS)
def test_train_forward_and_gradients_match_jax(nc, agg):
    jm, net, x, emb, v = _case(nc, agg, seed=2)
    r = np.random.default_rng(7)
    cs = r.standard_normal((2, 3, 5)).astype(np.float32)
    cw = r.standard_normal((2, 3)).astype(np.float32)

    def loss(params):
        (s, w), upd = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), embeddings=_j(emb), train=True,
                               mutable=["batch_stats"], rngs={"dropout": jax.random.key(1),
                                                              "augment": jax.random.key(2)})
        return jnp.sum(s * cs) + jnp.sum(w * cw), (s, w, upd)

    (_, (sj, wj, upd)), gj = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, v["params"]))
    tm = _port(net, v).train()
    s, w = tm(torch.from_numpy(x), embeddings=_t(emb))
    _close(s.detach().numpy(), sj, 1e-5)
    _close(w.detach().numpy(), wj, 1e-5)
    ((s * torch.from_numpy(cs)).sum() + (w * torch.from_numpy(cw)).sum()).backward()
    want = from_jax_params(jax.device_get(gj))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        assert float((got[name].grad - g).abs().max()) <= 1e-4 * scale, name
    buffers = dict(tm.named_buffers())
    for name, val in from_jax_params({}, jax.device_get(upd["batch_stats"])).items():
        _close(buffers[name].numpy(), val.numpy(), 1e-5)


@pytest.mark.parametrize("nc,agg", CASES, ids=IDS)
def test_forward_macs_by_hand(nc, agg):
    """The CNN once for each input map; cat_tf, shrink_emb and the GRU nc
    times wider."""
    tm = CRNN(n_mels=N_MELS, **dict(NET, n_in_channel=nc, **EMB[agg]))
    by = forward_macs(tm, T_FR, N_MELS, TE)["by_layer"]
    want = {"conv0": nc * 20 * 32 * 8 * 1 * 9, "glu0": nc * 20 * 32 * 8 * 8,
            "conv1": nc * 10 * 16 * 16 * 8 * 9, "glu1": nc * 10 * 16 * 16 * 16}
    t, nb, cnn_out = 5, 16 * nc, 4 * 16 * nc  # after pools (2, 2), (2, 4): T 5, F 4
    rnn_in = cnn_out
    if agg == "pool1d":
        want["pool1d"] = E * TE * t
        want["cat_tf"] = t * (cnn_out + E) * nb
        rnn_in = nb
    elif agg == "global":
        want["shrink_emb"] = E * nb
        want["cat_tf"] = t * (cnn_out + nb) * nb
        rnn_in = nb
    want["rnn"] = 2 * t * 3 * 8 * (rnn_in + 8)
    want["dense"] = want["dense_softmax"] = t * 16 * 3
    assert by == want


def test_forward_macs_activations():
    """cg counts its Linear as GLU does; relu and leakyrelu have none."""
    for act in ("cg", "relu", "leakyrelu"):
        tm = CRNN(n_mels=N_MELS, **dict(NET, activation=act, n_in_channel=2))
        by = forward_macs(tm, T_FR, N_MELS)["by_layer"]
        linears = {k for k in by if k.startswith(("glu", "cg"))}
        assert linears == ({"cg0", "cg1"} if act == "cg" else set())
        if act == "cg":
            assert by["cg1"] == 2 * 10 * 16 * 16 * 16


@pytest.mark.parametrize("shared", [False, True])
def test_specaugment_masks_the_4d_axes_as_jax(shared):
    """JAX masks the 4-D input before the reshape (crnn.py:123-132), so its
    'frequency' mask lands on the channel axis and its 'time' mask on the
    mel axis; the port does the same from the same uniforms."""
    r = np.random.default_rng(3)
    x = r.standard_normal((4, 3, N_MELS, T_FR)).astype(np.float32)
    key = jax.random.key(5)
    want = jaugment.specaugment(key, jnp.asarray(x), 5, 1.0, 10, 1.0, shared=shared)
    b = 1 if shared else 4
    u = []
    for k in jax.random.split(key):  # time_mask: split, then a uniform for val and start
        k1, k2 = jax.random.split(k)
        u.append(torch.from_numpy(np.stack([np.asarray(jax.random.uniform(k1, (b,))),
                                            np.asarray(jax.random.uniform(k2, (b,)))])))
    got = augment.specaugment(None, torch.from_numpy(x), 5, 1.0, 10, 1.0, shared=shared, u=u)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), x)  # some mask landed
