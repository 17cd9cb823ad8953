"""A CNN wider than 128 channels: the port against the JAX CNN on the CPU.

The JAX fused block takes Co > 128 (its GLU lane group is max(1, 128 // Co),
pallas_cnn.py:89). The port's kernels take any Co, the backward ones too,
so every 3x3 block of `CNN` takes the fused kernels, with or without
gradients. Here a 2-block CNN at Co = 256 runs against the JAX CNN with its
Pallas blocks in interpret mode (F * Co a multiple of 128, as the JAX
epilogue needs), on the same weights through `from_jax_params`: outputs,
running statistics and gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.cnn import CNN as JaxCNN
from desed_task_tpu_torch.models import cnn as port_cnn
from desed_task_tpu_torch.models.convert import from_jax_params

B, T, F = 2, 8, 8
NET = dict(n_in_channel=1, activation="glu", conv_dropout=0.0, kernel_size=(3, 3),
           padding=(1, 1), stride=(1, 1), nb_filters=(256, 256), pooling=((2, 2), (1, 2)))


@pytest.fixture(scope="module")
def models():
    x = np.random.default_rng(0).standard_normal((B, T, F, 1)).astype(np.float32)
    jm = JaxCNN(**NET, fused_blocks="interpret")
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x)))
    r = np.random.default_rng(1)
    variables = jax.tree_util.tree_map(   # every leaf moved off its init value
        lambda a: np.asarray(a) + (0.05 * r.standard_normal(a.shape)).astype(np.float32),
        variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    tm = port_cnn.CNN(**NET)
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]),
                       strict=True)
    return jm, variables, tm, x


def _count_fused(monkeypatch):
    calls = []
    real = port_cnn.fused_glu_block

    def spy(*args, **kw):
        calls.append(args[1].shape[-1])
        return real(*args, **kw)

    monkeypatch.setattr(port_cnn, "fused_glu_block", spy)
    return calls


def test_wide_cnn_eval_matches_jax_fused(models, monkeypatch):
    jm, variables, tm, x = models
    zj = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    calls = _count_fused(monkeypatch)
    with torch.no_grad():
        z = tm(torch.from_numpy(x), train=False)
    assert calls == [256, 256]  # no gradient needed: both blocks fused
    assert z.shape == zj.shape == (B, T // 2, F // 4, 256)
    np.testing.assert_allclose(z.numpy(), zj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grad", [False, True])
def test_wide_cnn_train_matches_jax_fused(models, monkeypatch, grad):
    """Train mode: batch statistics and the running-statistics update. With
    gradients on or off, both blocks (Co = 256) take the fused kernels."""
    jm, variables, _, x = models
    tm = port_cnn.CNN(**NET)
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    zj, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    calls = _count_fused(monkeypatch)
    with torch.set_grad_enabled(grad):
        z = tm(torch.from_numpy(x), train=True)
    assert calls == [256, 256]
    assert z.requires_grad == grad
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    for i in range(2):
        bn = getattr(tm, f"batchnorm{i}")
        js = upd["batch_stats"][f"batchnorm{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(js["mean"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(js["var"]),
                                   rtol=1e-5, atol=1e-6)
    if grad:
        z.square().sum().backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tm.parameters())


def test_wide_cnn_gradients_match_jax_fused(models, monkeypatch):
    """Train mode with gradients: both 256-channel blocks go through
    fused_glu_block (the GLU backward kernel's wide path on the card), and
    the gradients of sum(z^2) match the JAX fused CNN's. Tolerance as
    tests/test_torch_fused_cnn_grad.py: 1e-4 of each gradient's largest
    entry; the conv biases' exact gradient is 0 (train-mode BatchNorm), both
    sides' noise held to 1e-5 of the largest gradient."""
    jm, variables, _, x = models
    tm = port_cnn.CNN(**NET)
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))

    def loss(params):
        z, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(z * z)

    gj = from_jax_params(jax.device_get(jax.grad(loss)(variables["params"])),
                         variables["batch_stats"])
    calls = _count_fused(monkeypatch)
    z = tm(torch.from_numpy(x), train=True)
    z.square().sum().backward()
    assert calls == [256, 256]
    scale = max(float(np.abs(np.asarray(g)).max()) for g in gj.values())
    for name, p in tm.named_parameters():
        got, want = p.grad.numpy(), np.asarray(gj[name])
        if name.startswith("conv") and name.endswith("bias"):
            assert np.abs(got).max() <= 1e-5 * scale and np.abs(want).max() <= 1e-5 * scale
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
