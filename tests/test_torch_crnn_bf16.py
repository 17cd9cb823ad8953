"""The port's bf16 conv stack against the JAX package's, on the CPU.

The JAX CRNN's `compute_dtype=jnp.bfloat16` runs its conv stack in bf16:
fused (the Pallas kernels' bf16 mode, here in interpret mode) or unfused
(the flax chain, `fused_blocks=False`). The port's `compute_dtype` does the
same with the plain versions of its kernels (CPU tensors) or its unfused
chain. Inputs and weights come from numpy seeds; weights go across through
`from_jax_params`. Narrow models: F * Co of every block a multiple of the
JAX epilogue's 128-lane group (ROADMAP.md section 3).

Per block, the port's fused_glu_block in bf16 is held to JAX's at the
rounding points: at least 99 % of z bitwise equal, and no element further
than one bf16 step at the block's scale (2^-7 of max |z|). A flipped
rounding of y (its fp32 sums taken in another order) or of BN(y) (XLA's
rsqrt and torch's differ in the last fp32 bit) moves the GLU's product by
one bf16 step of its operands, which can be several steps of a small z.
End to end, the port's bf16 scores lie much closer to JAX's bf16 scores than
JAX's bf16 scores lie to its fp32 scores: a missing rounding point would put
the port near the fp32 model instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.models.crnn import CRNN as JaxCRNN
from desed_task_tpu.ops import pallas_cnn
from desed_task_tpu_torch.models import cnn as port_cnn
from desed_task_tpu_torch.models.convert import from_jax_params
from desed_task_tpu_torch.models.crnn import CRNN
from desed_task_tpu_torch.ops import fused_cnn

BF16_STEP = 2.0 ** -7  # one bf16 step, relative
KEYS = ("x", "w", "bias", "gamma", "beta", "ra_mean", "ra_var", "wg", "bg")


def _block_inputs(B, T, F, Ci, Co, seed):
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x=f32(r.standard_normal((B, T, F, Ci))),
        w=f32(r.standard_normal((3, 3, Ci, Co)) / np.sqrt(9 * Ci)),
        bias=f32(r.standard_normal(Co) * 0.1),
        gamma=f32(1.0 + 0.1 * r.standard_normal(Co)),
        beta=f32(0.1 * r.standard_normal(Co)),
        ra_mean=f32(0.05 * r.standard_normal(Co)),
        ra_var=f32(1.0 + 0.1 * r.random(Co)),
        wg=f32(r.standard_normal((Co, Co)) / np.sqrt(Co)),
        bg=f32(r.standard_normal(Co) * 0.1),
    )


# (B, T, F, Ci, Co, pool): the first 2024 block's Ci = 1 and pool, T not a
# multiple of 8 (the JAX kernels' row padding), and two Ci > 1 blocks
BLOCKS = [(2, 13, 16, 1, 8, (2, 2)), (2, 10, 8, 8, 16, (1, 2)), (2, 9, 8, 16, 32, (1, 2))]


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("geom", BLOCKS, ids=[f"{g[3]}to{g[4]}" for g in BLOCKS])
def test_fused_block_bf16_matches_jax(geom, train, seed):
    """In train mode without gradients the block takes the batch statistics:
    s and q, hence mean and var, come from the rounded y on both sides."""
    B, T, F, Ci, Co, pool = geom
    a = _block_inputs(B, T, F, Ci, Co, seed)
    ja = [jnp.asarray(a[k]) for k in KEYS]
    ja[0] = ja[0].astype(jnp.bfloat16)
    zj, mj, vj = pallas_cnn.fused_glu_block(*ja, pool=pool, train=train, interpret=True,
                                            fpool_in_kernel=True)  # as the JAX CNN runs it
    ta = [torch.from_numpy(a[k]) for k in KEYS]
    ta[0] = ta[0].to(torch.bfloat16)
    with torch.no_grad():
        z, m, v = fused_cnn.fused_glu_block(*ta, pool=pool, train=train)
    assert z.dtype == torch.bfloat16 and m.dtype == v.dtype == torch.float32
    zj = np.asarray(zj.astype(jnp.float32))
    zt = z.float().numpy()
    assert zt.shape == zj.shape == (B, T // pool[0], F // pool[1], Co)
    assert np.mean(zt == zj) >= 0.99
    assert np.abs(zt - zj).max() <= BF16_STEP * np.abs(zj).max()
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("geom", BLOCKS[:2], ids=[f"{g[3]}to{g[4]}" for g in BLOCKS[:2]])
def test_conv_bn_stats_bf16_matches_jax(geom):
    """Row 1's bf16 mode alone: y rounded once after the bias, s and q of
    the rounded y."""
    B, T, F, Ci, Co, pool = geom
    a = _block_inputs(B, T, F, Ci, Co, 1)
    dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool)
    xb = jnp.asarray(a["x"]).astype(jnp.bfloat16).reshape(B, T, F * Ci)
    xpad = jnp.pad(xb, ((0, 0), (1, 1 + dims.Tp - T), (Ci, Ci)))
    yj, sj, qj = pallas_cnn.conv_bn_stats(xpad, jnp.asarray(a["w"]).astype(jnp.bfloat16),
                                          jnp.asarray(a["bias"]).astype(jnp.bfloat16), dims, True)
    y, s, q = fused_cnn.conv_bn_stats_plain(
        *(torch.from_numpy(a[k]).to(torch.bfloat16) for k in ("x", "w", "bias")))
    assert y.dtype == torch.bfloat16 and s.dtype == q.dtype == torch.float32
    yj = np.asarray(yj.astype(jnp.float32))[:, :T].reshape(B, T, F, Co)
    assert np.mean(y.float().numpy() == yj) >= 0.99
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=1e-5, atol=1e-5)


def test_wrappers_refuse_mixed_dtypes():
    a = {k: torch.from_numpy(v) for k, v in _block_inputs(1, 4, 4, 2, 8, 0).items()}
    with pytest.raises(TypeError):
        fused_cnn.conv_bn_stats(a["x"].bfloat16(), a["w"], a["bias"])
    y = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16)
    sf = torch.ones(32)
    with pytest.raises(TypeError):
        fused_cnn.glu_drop_pool(y, sf, sf, a["wg"], a["bg"].bfloat16(), pool=(1, 2))


GRAD_NAMES = ("x", "w", "bias", "gamma", "beta", "wg", "bg")


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("geom", BLOCKS, ids=[f"{g[3]}to{g[4]}" for g in BLOCKS])
def test_fused_bf16_block_gradients_match_jax(geom, rate):
    """The bf16 block with gradients (rows 3 and 4 in their bf16 mode, plain
    versions) against jax.vjp of the JAX block in bf16, train mode, the same
    dropout bits (jax.random.bits(key, (B, Tp, F*Co)), the first T rows to
    the port) and the same bf16 cotangent. x, w, bias, wg and bg receive
    bf16 values on both sides (x bf16; the fp32 parameters through the
    cast's VJP): at least 99 % bitwise equal, and within one bf16 step at
    the tensor's scale. gamma and beta (fp32 sums) within 1e-5 of the
    tensor's scale (measured: 2e-7). The conv bias's exact gradient is 0
    under train-mode BatchNorm, but dy reaches row 3 rounded to bf16, so
    the sum no longer cancels: both sides give noise up to 1.2e-3 of the
    other gradients' scale, each under 2e-3 of it, and they agree within
    2e-5 of it (measured: 5.1e-6; 75-94 % of the entries bitwise)."""
    B, T, F, Ci, Co, pool = geom
    a = _block_inputs(B, T, F, Ci, Co, 4)
    gz = np.random.default_rng(5).standard_normal(
        (B, T // pool[0], F // pool[1], Co)).astype(np.float32)
    gz = np.asarray(jnp.asarray(gz).astype(jnp.bfloat16).astype(jnp.float32))
    key = jax.random.key(9) if rate else None

    def f(x, w, bias, gamma, beta, wg, bg):
        return pallas_cnn.fused_glu_block(
            x, w, bias, gamma, beta, jnp.asarray(a["ra_mean"]), jnp.asarray(a["ra_var"]),
            wg, bg, pool=pool, train=True, dropout_rate=rate, dropout_key=key,
            interpret=True, fpool_in_kernel=True)

    primals = [jnp.asarray(a[k]) for k in GRAD_NAMES]
    primals[0] = primals[0].astype(jnp.bfloat16)
    (zj, mj, vj), vjp = jax.vjp(f, *primals)
    gj = vjp((jnp.asarray(gz).astype(jnp.bfloat16), jnp.zeros_like(mj), jnp.zeros_like(vj)))
    gj = [np.asarray(g.astype(jnp.float32)) for g in gj]
    bits = None
    if rate:
        dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool)
        bits = torch.from_numpy(np.array(
            jax.random.bits(key, (B, dims.Tp, dims.Lout), jnp.uint8))[:, :T])
    leaves = {k: torch.from_numpy(a[k]).requires_grad_() for k in GRAD_NAMES}
    leaves["x"] = torch.from_numpy(a["x"]).to(torch.bfloat16).requires_grad_()
    z, m, v = fused_cnn.fused_glu_block(
        *(leaves[k] for k in ("x", "w", "bias", "gamma", "beta")),
        torch.from_numpy(a["ra_mean"]), torch.from_numpy(a["ra_var"]), leaves["wg"],
        leaves["bg"], pool=pool, train=True, dropout_rate=rate, bits=bits)
    assert z.dtype == torch.bfloat16
    assert np.mean(z.float().detach().numpy() == np.asarray(zj.astype(jnp.float32))) >= 0.99
    gt = torch.autograd.grad((z.float() * torch.from_numpy(gz.copy())).sum(),
                             [leaves[k] for k in GRAD_NAMES])
    assert gt[0].dtype == torch.bfloat16
    gt = [g.float().numpy() for g in gt]
    scale = max(float(np.abs(g).max()) for g in gj)
    for name, got, want in zip(GRAD_NAMES, gt, gj):
        assert got.shape == want.shape, name
        if name in ("x", "w", "bias", "wg", "bg"):  # bf16 values on both sides
            for arr in (got, want):
                assert np.array_equal(arr, np.asarray(
                    jnp.asarray(arr).astype(jnp.bfloat16).astype(jnp.float32))), name
        if name == "bias":
            assert np.abs(got).max() <= 2e-3 * scale and np.abs(want).max() <= 2e-3 * scale
            assert np.abs(got - want).max() <= 2e-5 * scale
            continue
        if name in ("gamma", "beta"):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
            continue
        assert np.mean(got == want) >= 0.99, (name, np.mean(got == want))
        assert np.abs(got - want).max() <= BF16_STEP * np.abs(want).max(), name


# --------------------------------------------------------------------------
# the CRNN end to end
# --------------------------------------------------------------------------

N_MELS, T_FR, E, TE = 32, 20, 12, 17
NET = dict(nclass=3, n_RNN_cell=8, n_layers_RNN=1, kernel_size=[3] * 3, padding=[1] * 3,
           stride=[1] * 3, nb_filters=[8, 16, 16], pooling=[[2, 2], [2, 2], [1, 2]],
           dropout=0.0, use_embeddings=True, embedding_size=E, aggregation_type="pool1d")


@pytest.fixture(scope="module")
def crnn_case():
    r = np.random.default_rng(5)
    x = (4.0 * r.standard_normal((2, N_MELS, T_FR))).astype(np.float32)
    emb = r.standard_normal((2, E, TE)).astype(np.float32)
    jm = JaxCRNN(**NET, fused_blocks=False, rnn_pallas=False)
    variables = jax.device_get(jm.init(jax.random.key(0), jnp.asarray(x),
                                       embeddings=jnp.asarray(emb)))
    variables = jax.tree_util.tree_map(  # every leaf off its init value
        lambda a: np.asarray(a) + (0.1 * r.standard_normal(a.shape)).astype(np.float32)
        * (1.0 if a.ndim else 0.0), variables)
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    return x, emb, variables


def _jax_scores(case, fused, dtype):
    x, emb, variables = case
    kw = {} if dtype is None else {"compute_dtype": dtype}
    jm = JaxCRNN(**NET, fused_blocks="interpret" if fused else False, rnn_pallas=False, **kw)
    s, w = jm.apply(variables, jnp.asarray(x), embeddings=jnp.asarray(emb))
    return np.asarray(s), np.asarray(w)


def _port_scores(case, fused, dtype):
    x, emb, variables = case
    tm = CRNN(n_mels=N_MELS, **NET, fused_blocks=fused, rnn_kernel=False,
              compute_dtype=dtype).eval()
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]),
                       strict=True)
    with torch.no_grad():
        s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb))
    assert s.dtype == w.dtype == torch.float32  # the RNN and heads stay fp32
    return s.numpy(), w.numpy()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_crnn_bf16_matches_jax_bf16(crnn_case, fused):
    """gap(port bf16, JAX bf16) <= gap(JAX bf16, JAX fp32) / 4, strong and
    weak scores, max abs. Measured ratios (strong / weak): fused 7.5e-5 /
    4.1e-4, unfused 6.1e-5 / 1.7e-4. Without the rounding of the GLU
    product's operand (fused) they were 0.57 / 1.05; with the unfused
    chain's sigmoid rounded once instead of at each op, 1.04 / 0.91."""
    sj, wj = _jax_scores(crnn_case, fused, jnp.bfloat16)
    sf, wf = _jax_scores(crnn_case, fused, None)
    st, wt = _port_scores(crnn_case, fused, torch.bfloat16)
    assert st.shape == sj.shape and wt.shape == wj.shape
    for port, ref, fp32 in ((st, sj, sf), (wt, wj, wf)):
        precision_gap = float(np.abs(ref - fp32).max())
        assert precision_gap > 1e-4  # the bf16 model is not the fp32 one
        assert float(np.abs(port - ref).max()) <= precision_gap / 4


def test_crnn_bf16_accepts_the_dtype_by_name(crnn_case):
    """"bfloat16" is taken as torch.bfloat16; the fp32 default is unchanged."""
    assert CRNN(n_mels=N_MELS, **NET, compute_dtype="bfloat16").cnn.compute_dtype is torch.bfloat16
    assert CRNN(n_mels=N_MELS, **NET).cnn.compute_dtype is None
    with pytest.raises(ValueError):
        CRNN(n_mels=N_MELS, **NET, compute_dtype="float16")
    s1, w1 = _port_scores(crnn_case, True, "bfloat16")
    s2, w2 = _port_scores(crnn_case, True, torch.bfloat16)
    assert np.array_equal(s1, s2) and np.array_equal(w1, w2)


def test_unfused_bf16_chain_trains(crnn_case):
    """The unfused chain in bf16 carries gradients through autograd to the
    fp32 parameters; the running statistics update in fp32."""
    x, emb, variables = crnn_case
    tm = CRNN(n_mels=N_MELS, **NET, fused_blocks=False, rnn_kernel=False,
              compute_dtype=torch.bfloat16).train()
    tm.load_state_dict(from_jax_params(variables["params"], variables["batch_stats"]))
    before = tm.cnn.batchnorm0.running_mean.clone()
    s, w = tm(torch.from_numpy(x), embeddings=torch.from_numpy(emb),
              generator=torch.Generator().manual_seed(0))
    (s.sum() + w.sum()).backward()
    conv_grad = tm.cnn.conv0.weight.grad
    assert conv_grad is not None and conv_grad.dtype == torch.float32
    assert bool(torch.isfinite(conv_grad).all()) and float(conv_grad.abs().max()) > 0
    assert tm.cnn.batchnorm0.running_mean.dtype == torch.float32
    assert not torch.equal(before, tm.cnn.batchnorm0.running_mean)
