"""Gradients of the port's BiGRU (plain backward on the CPU) against the JAX
Pallas recurrence's custom VJP in interpret mode, at a batch that is not a
multiple of the card kernels' 8-row tile and at a hidden size that is not a
multiple of the cluster size (ragged unit slices); and gradcheck of the
autograd Function in float64.

Tolerance: fp32 BPTT over 9 steps, summed in another order: 1e-5 of each
gradient's largest entry.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.ops import pallas_gru
from desed_task_tpu_torch.models.rnn import BidirectionalGRU
from desed_task_tpu_torch.ops import gru


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    yield
    pallas_gru.INTERPRET = old


def _args(B, T, H, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    f = lambda *s: (r.standard_normal(s) * 0.4).astype(dtype)
    return (f(B, T, 3 * H), f(B, T, 3 * H), f(3 * H, H), f(3 * H), f(3 * H, H), f(3 * H))


@pytest.mark.parametrize("B,T,H", [(10, 9, 8), (10, 9, 12)])
def test_bigru_gradients_match_pallas_vjp(B, T, H):
    args = _args(B, T, H, seed=0)
    r = np.random.default_rng(1)
    dfwd = r.standard_normal((B, T, H)).astype(np.float32)
    dbwd = r.standard_normal((B, T, H)).astype(np.float32)
    (fj, bj), vjp = jax.vjp(pallas_gru.bigru_pallas, *map(jnp.asarray, args))
    gj = vjp((jnp.asarray(dfwd), jnp.asarray(dbwd)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    f, b = gru.BiGRU.apply(*leaves)
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(fj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(bj), rtol=0, atol=2e-6)
    g = torch.autograd.grad((f * torch.from_numpy(dfwd)).sum() + (b * torch.from_numpy(dbwd)).sum(),
                            leaves)
    names = ("xg_f", "xg_b", "w_hh_f", "b_hh_f", "w_hh_b", "b_hh_b")
    for name, got, want in zip(names, g, gj):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_bigru_wrappers_take_plain_version_on_cpu():
    B, T, H = 3, 4, 5
    args = [torch.from_numpy(a) for a in _args(B, T, H, seed=2)]
    f, b = gru.bigru(*args)
    d = [torch.ones_like(f), torch.ones_like(b)]
    for got, want in zip(gru.bigru_bwd(*args, f, b, *d), gru.bigru_bwd_plain(*args, f, b, *d)):
        assert torch.equal(got, want)


def test_bigru_gradcheck():
    args = [torch.from_numpy(a).requires_grad_() for a in _args(3, 4, 3, seed=3, dtype=np.float64)]
    assert torch.autograd.gradcheck(gru.BiGRU.apply, args)


def test_module_gradients_kernel_form_match_plain_form():
    """The module's kernel form (autograd Function) and plain form (autograd
    through the loop) give the same gradients, two layers."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 6, 7)).astype(np.float32))
    grads = []
    for kernel in (True, False):
        m = BidirectionalGRU(7, 4, num_layers=2, kernel=kernel)
        torch.manual_seed(0)
        for p in m.parameters():
            torch.nn.init.uniform_(p, -0.5, 0.5)
        m(x.requires_grad_()).square().sum().backward()
        grads.append([x.grad.clone()] + [p.grad for p in m.parameters()])
        x.grad = None
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
