"""The flagship crnn_2024() at full width (7 blocks 16-128, 128 mels, 768-d
frame embeddings by pool1d, BiGRU H=192, 27 classes) against the JAX model
on converted weights; time is cut to 64 frames to keep the test short."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.recipes_config import crnn_2024 as jax_crnn_2024
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.recipes_config import crnn_2024


def test_crnn_2024_full_width_matches_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 128, 64)).astype(np.float32)
    emb = r.standard_normal((2, 768, 50)).astype(np.float32)
    jm = jax_crnn_2024(fused_blocks=False, rnn_pallas=False)
    variables = jm.init(jax.random.key(0), jnp.asarray(x), embeddings=jnp.asarray(emb))
    variables = jax.tree_util.tree_map(  # non-trivial biases and BN statistics
        lambda a: np.asarray(a) + (0.05 * r.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(variables))
    sj, wj = jm.apply(variables, jnp.asarray(x), embeddings=jnp.asarray(emb))
    tm = crnn_2024().eval()
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    assert s.shape == (2, 27, 16) and w.shape == (2, 27)
    # fp32 through 7 blocks and 16 GRU steps (measured 2.7e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=0, atol=2e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=2e-6)
