"""The recurrent layers no recipe uses, against the JAX package on the CPU:
`gru_scan`, `GRULayer`, `BidirectionalGRU(fused_directions=False)` (two
one-direction scans over the same parameters), `BidirectionalLSTM` (1 and 2
layers) and `BidirectionalLSTMCellMath`, and the reference checkpoints'
context-gating and layer-norm CRNNs through the reference-layout
converters. Forwards within 1e-5 of max(1, max |JAX|), gradients within
1e-4 of the largest JAX gradient. Weights come from the flax trees through
`from_jax_params`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models import rnn as jrnn
from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.models.torch_convert import convert_crnn_state_dict as jax_convert
from desed_task_tpu.models.torch_convert import convert_gru_state_dict as jax_convert_gru
from desed_task_tpu_torch.models.convert import (
    convert_crnn_state_dict, convert_gru_state_dict, from_jax_params)
from desed_task_tpu_torch.models.crnn import CRNN, init_weights
from desed_task_tpu_torch.models.rnn import (
    BidirectionalGRU, BidirectionalLSTM, BidirectionalLSTMCellMath, GRULayer, gru_scan)

B, T, D, H = 3, 9, 6, 5


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)


def _load(module, variables):
    module.load_state_dict(from_jax_params(jax.device_get(variables["params"])), strict=True)
    return module


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


def _grads_match(port, loss_t, jax_loss, params, tol=1e-4):
    gj = from_jax_params(jax.device_get(jax.grad(jax_loss)(params)))
    loss_t.backward()
    got = dict(port.named_parameters())
    assert set(gj) == set(got)
    scale = max(float(g.abs().max()) for g in gj.values())
    for name, g in gj.items():
        assert float((got[name].grad - g).abs().max()) <= tol * scale, name


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    r = np.random.default_rng(1)
    xg = r.standard_normal((B, T, 3 * H)).astype(np.float32)
    h0 = r.standard_normal((B, H)).astype(np.float32)
    w = (r.standard_normal((3 * H, H)) / np.sqrt(H)).astype(np.float32)
    b = r.standard_normal(3 * H).astype(np.float32) * 0.1
    want = jrnn.gru_scan(*(jnp.asarray(a) for a in (xg, h0, w, b)), reverse=reverse)
    got = gru_scan(*(torch.from_numpy(a) for a in (xg, h0, w, b)), reverse=reverse)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_layer_matches_jax(reverse):
    x = _x()
    jm = jrnn.GRULayer(H, reverse=reverse)
    v = jm.init(jax.random.key(0), jnp.asarray(x))
    tm = _load(GRULayer(D, H, reverse=reverse), v)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    _close(out.detach().numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)
    c = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    _grads_match(tm, (out * torch.from_numpy(c)).sum(),
                 lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * c), v["params"])


@pytest.mark.parametrize("layers", [1, 2])
def test_unfused_directions_match_jax_and_fused_port(layers):
    """JAX's fused_directions=False (two GRULayer scans, never its Pallas
    kernel) against the port's; and the port's two scans against its own
    fused form (the kernel wrapper, plain version on the CPU) on the same
    parameters."""
    x = _x(3)
    jm = jrnn.BidirectionalGRU(hidden=H, num_layers=layers, fused_directions=False,
                               pallas_recurrence=False)
    v = jm.init(jax.random.key(1), jnp.asarray(x))
    tm = _load(BidirectionalGRU(D, H, layers, fused_directions=False), v).eval()
    fused = _load(BidirectionalGRU(D, H, layers), v).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        _close(got.numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)
        _close(got.numpy(), fused(torch.from_numpy(x)).numpy(), 1e-5)
    c = np.random.default_rng(4).standard_normal(got.shape).astype(np.float32)
    out = tm(torch.from_numpy(x))
    _grads_match(tm, (out * torch.from_numpy(c)).sum(),
                 lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * c), v["params"])


def test_unfused_directions_never_take_the_kernel(monkeypatch):
    from desed_task_tpu_torch.models import rnn

    def boom(*a):
        raise AssertionError("the kernel wrapper ran")

    monkeypatch.setattr(rnn, "bigru", boom)
    monkeypatch.setattr(rnn.BiGRU, "apply", boom)
    m = BidirectionalGRU(D, H, 1, kernel=True, fused_directions=False)
    assert m(torch.from_numpy(_x())).shape == (B, T, 2 * H)
    with pytest.raises(TypeError):  # JAX's scan unroll factor is not taken
        BidirectionalGRU(D, H, 1, fused_directions=False, unroll=2)


@pytest.mark.parametrize("layers", [1, 2])
def test_bilstm_matches_jax(layers):
    x = _x(5)
    jm = jrnn.BidirectionalLSTM(hidden=2 * H, n_out=4, num_layers=layers)
    v = jm.init(jax.random.key(2), jnp.asarray(x))
    tm = _load(BidirectionalLSTM(D, 2 * H, 4, layers), v).eval()
    assert tm.weight_ih_l0.shape == (4 * H, D) and tm.linear.weight.shape == (4, 2 * H)
    out = tm(torch.from_numpy(x))
    _close(out.detach().numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)
    c = np.random.default_rng(6).standard_normal(out.shape).astype(np.float32)
    _grads_match(tm, (out * torch.from_numpy(c)).sum(),
                 lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * c), v["params"])


def test_bilstm_dropout_between_layers():
    """Train mode drops the first layer's output (keep 1 - rate, scaled),
    drawing from the generator; eval mode and one layer draw nothing."""
    m = init_weights(BidirectionalLSTM(D, 2 * H, 4, num_layers=2, dropout=0.5),
                     torch.Generator().manual_seed(3)).train()
    x = torch.from_numpy(_x())
    a = m(x, generator=torch.Generator().manual_seed(0))
    b = m(x, generator=torch.Generator().manual_seed(0))
    c = m(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with torch.no_grad():
        assert torch.equal(m.eval()(x), m(x))
    with pytest.raises(ValueError, match="Generator"):
        m.train()(x)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_cell_math_matches_jax(reverse):
    x = _x(7)
    jm = jrnn.BidirectionalLSTMCellMath(H, reverse=reverse)
    v = jm.init(jax.random.key(3), jnp.asarray(x))
    tm = _load(BidirectionalLSTMCellMath(D, H, reverse=reverse), v)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)).numpy(), jm.apply(v, jnp.asarray(x)), 1e-5)


N_MELS = 16
REF_NET = dict(nclass=3, n_RNN_cell=4, n_layers_RNN=2, kernel_size=[3, 3], padding=[1, 1],
               stride=[1, 1], nb_filters=[4, 8], pooling=[[2, 2], [2, 2]], dropout=0.0)


def _reference_state(act, norm, seed=0):
    """A reference DESED_task CRNN state_dict (cnn.cnn.<module><i>.*,
    rnn.rnn.*, dense.*, dense_softmax.*) with seeded values."""
    g = torch.Generator().manual_seed(seed)
    sd, ci = {}, 1
    for i, co in enumerate(REF_NET["nb_filters"]):
        sd[f"cnn.cnn.conv{i}.weight"] = torch.randn(co, ci, 3, 3, generator=g) * 0.3
        sd[f"cnn.cnn.conv{i}.bias"] = torch.randn(co, generator=g) * 0.1
        if norm == "batch":
            for leaf in ("weight", "bias", "running_mean"):
                sd[f"cnn.cnn.batchnorm{i}.{leaf}"] = torch.randn(co, generator=g) * 0.1
            sd[f"cnn.cnn.batchnorm{i}.running_var"] = 1 + torch.rand(co, generator=g)
            sd[f"cnn.cnn.batchnorm{i}.num_batches_tracked"] = torch.tensor(5)
        else:
            sd[f"cnn.cnn.layernorm{i}.weight"] = 1 + torch.randn(co, generator=g) * 0.1
            sd[f"cnn.cnn.layernorm{i}.bias"] = torch.randn(co, generator=g) * 0.1
        sd[f"cnn.cnn.{act}{i}.linear.weight"] = torch.randn(co, co, generator=g) * 0.3
        sd[f"cnn.cnn.{act}{i}.linear.bias"] = torch.randn(co, generator=g) * 0.1
        ci = co
    gru = torch.nn.GRU(8 * 4, 4, num_layers=2, bidirectional=True, batch_first=True)
    for k, val in gru.state_dict().items():
        sd[f"rnn.rnn.{k}"] = torch.randn(val.shape, generator=g) * 0.3
    for head in ("dense", "dense_softmax"):
        sd[f"{head}.weight"] = torch.randn(3, 8, generator=g) * 0.3
        sd[f"{head}.bias"] = torch.randn(3, generator=g) * 0.1
    return sd


@pytest.mark.parametrize("act,norm", [("cg", "batch"), ("glu", "layer"), ("cg", "layer")])
def test_reference_layouts_convert_as_jax(act, norm):
    """The reference's context-gating and layer-norm CRNN checkpoints: the
    port's converter gives the state_dict that JAX's converter followed by
    from_jax_params gives, and both models score alike."""
    sd = _reference_state(act, norm)
    mine = convert_crnn_state_dict(sd)
    tree = jax_convert(sd)
    via_jax = from_jax_params(tree["params"], tree.get("batch_stats"))
    assert set(mine) == set(via_jax)
    for k in mine:
        assert torch.equal(mine[k], via_jax[k]), k
    net = dict(REF_NET, activation=act, normalization=norm)
    tm = CRNN(n_mels=N_MELS, **net, rnn_kernel=False).eval()
    tm.load_state_dict(mine, strict=True)
    x = np.random.default_rng(0).standard_normal((2, N_MELS, 12)).astype(np.float32)
    jm = JaxCRNN(**net, fused_blocks=False, rnn_pallas=False)
    sj, wj = jm.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x))
    _close(s.numpy(), sj, 1e-5)
    _close(w.numpy(), wj, 1e-5)


def test_gru_state_dict_converts_as_jax():
    gru = torch.nn.GRU(D, H, num_layers=2, bidirectional=True, batch_first=True)
    sd = {f"enc.{k}": v for k, v in gru.state_dict().items()}
    mine = convert_gru_state_dict(sd, prefix="enc.")
    via_jax = from_jax_params(jax_convert_gru(sd, prefix="enc."))
    assert set(mine) == set(via_jax)
    for k in mine:
        assert torch.equal(mine[k], via_jax[k]), k
    tm = BidirectionalGRU(D, H, 2, fused_directions=False).eval()
    tm.load_state_dict(mine, strict=True)
    with torch.no_grad():
        want, _ = gru(torch.from_numpy(_x()))
        _close(tm(torch.from_numpy(_x())).numpy(), want.numpy(), 1e-5)
