"""Port BiGRU (plain version on the CPU) against the JAX Pallas recurrence in
interpret mode, and the module with converted weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.rnn import BidirectionalGRU as JaxBiGRU
from desed_task_tpu.ops import pallas_gru
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.rnn import BidirectionalGRU
from desed_task_tpu_torch.ops import gru


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = pallas_gru.INTERPRET
    pallas_gru.INTERPRET = True
    yield
    pallas_gru.INTERPRET = old


def test_bigru_plain_matches_pallas():
    B, T, H = 3, 7, 8
    r = np.random.default_rng(0)
    f32 = lambda *s: (r.standard_normal(s) * 0.4).astype(np.float32)
    args = (f32(B, T, 3 * H), f32(B, T, 3 * H), f32(3 * H, H), f32(3 * H),
            f32(3 * H, H), f32(3 * H))
    fj, bj = pallas_gru.bigru_pallas(*map(jnp.asarray, args))
    f, b = gru.bigru_plain(*map(torch.from_numpy, args))
    # fp32 gate math; 7 recurrent steps
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=0, atol=2e-6)
    f2, b2 = gru.bigru(*map(torch.from_numpy, args))  # CPU tensors: plain version
    assert torch.equal(f2, f) and torch.equal(b2, b)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_module_with_converted_weights(num_layers):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 6, 10)).astype(np.float32)
    jm = JaxBiGRU(hidden=8, num_layers=num_layers, pallas_recurrence=True)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    yj = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = BidirectionalGRU(10, 8, num_layers).eval()
    tm.load_state_dict(from_jax_params(variables["params"]), strict=True)
    with torch.no_grad():
        y = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, yj, rtol=0, atol=2e-6)
