"""The bf16 modes of the conv block's backward (rows 3 and 4) against the
JAX package's, on the CPU.

`conv_bn_stats_bwd_plain` and `glu_drop_pool_bwd_plain` with bf16
activations are held to `jax.vjp` of `pallas_cnn.conv_bn_stats` and
`pallas_cnn.glu_drop_pool` in bf16 (the Pallas kernels in interpret mode),
on the same numpy inputs and the same uint8 dropout bits. Narrow shapes
with F * Co a multiple of the JAX epilogue's 128-lane group.

Tolerances: bf16 outputs (dx, dy, dw, dbias, dwg, dbg) at least 99 %
bitwise equal and no element further than one bf16 step at the tensor's
scale (2^-7 of max |JAX|): the fp32 sums run in another order, which can
flip a rounding. fp32 outputs (dscale_f, dbias_f): 1e-5 of max |JAX|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from desed_task_tpu.ops import pallas_cnn
from desed_task_tpu_torch.ops import fused_cnn

BF16_STEP = 2.0 ** -7
BF = torch.bfloat16

# (B, T, F, Ci, Co, pool): the first 2024 block's Ci = 1 and pool, T not a
# multiple of 8 (the JAX kernels' row padding), no pool, and a pooled
# 16 -> 32 block
GEOMS = [(2, 13, 16, 1, 8, (2, 2)), (2, 10, 8, 8, 16, (1, 1)), (2, 9, 8, 16, 32, (1, 2)),
         (3, 6, 8, 16, 16, (2, 2))]
IDS = [f"{g[3]}to{g[4]}-pool{g[5][0]}x{g[5][1]}" for g in GEOMS]


def _bf(a):
    """numpy fp32 rounded to bf16, as fp32."""
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_bf16_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.mean(got == want) >= 0.99, (what, np.mean(got == want))
    assert np.abs(got - want).max() <= BF16_STEP * np.abs(want).max(), what


def _is_bf16_valued(a):
    a = np.asarray(a, np.float32)
    return np.array_equal(a, _bf(a))


def _conv_case(geom, seed):
    B, T, F, Ci, Co, pool = geom
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        x=_bf(r.standard_normal((B, T, F, Ci))),
        w=_bf(r.standard_normal((3, 3, Ci, Co)) / np.sqrt(9 * Ci)),
        bias=_bf(r.standard_normal(Co) * 0.1),
        dy=_bf(r.standard_normal((B, T, F, Co))),
        ds=f32(r.standard_normal(F * Co)),
        dq=f32(r.standard_normal(F * Co) * 0.1),
    )


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_conv_bn_stats_bwd_bf16_matches_jax(geom):
    """Row 3: dx, dw and dbias (bf16) from jax.vjp of conv_bn_stats in bf16;
    y from the JAX forward, so that both sides read the same rounded y."""
    B, T, F, Ci, Co, pool = geom
    a = _conv_case(geom, 0)
    dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, *pool)
    xpad = jnp.pad(jnp.asarray(a["x"]).astype(jnp.bfloat16).reshape(B, T, F * Ci),
                   ((0, 0), (1, 1 + dims.Tp - T), (Ci, Ci)))
    f = lambda xp, w, b: pallas_cnn.conv_bn_stats(xp, w, b, dims, True)
    (yj, _, _), vjp = jax.vjp(f, xpad, jnp.asarray(a["w"]).astype(jnp.bfloat16),
                              jnp.asarray(a["bias"]).astype(jnp.bfloat16))
    dyj = np.zeros((B, dims.Tp, F * Co), np.float32)
    dyj[:, :T] = a["dy"].reshape(B, T, F * Co)
    dxpad, dwj, dbj = vjp((jnp.asarray(dyj).astype(jnp.bfloat16), jnp.asarray(a["ds"]),
                           jnp.asarray(a["dq"])))
    assert dxpad.dtype == dwj.dtype == dbj.dtype == jnp.bfloat16
    dxj = np.asarray(dxpad.astype(jnp.float32))[:, 1:T + 1, Ci:(F + 1) * Ci].reshape(B, T, F, Ci)
    y = torch.from_numpy(np.array(yj.astype(jnp.float32))[:, :T].reshape(B, T, F, Co)).to(BF)
    t = lambda k: torch.from_numpy(a[k])
    for need_dx in (True, False):
        dx, dw, db = fused_cnn.conv_bn_stats_bwd_plain(
            t("x").to(BF), t("w").to(BF), y, t("dy").to(BF), t("ds"), t("dq"), need_dx)
        assert dw.dtype == db.dtype == BF and (dx is None) == (not need_dx)
        _assert_bf16_close(dw.float(), np.asarray(dwj.astype(jnp.float32)), "dw")
        _assert_bf16_close(db.float(), np.asarray(dbj.astype(jnp.float32)), "dbias")
        if need_dx:
            assert dx.dtype == BF
            _assert_bf16_close(dx.float(), dxj, "dx")


def _glu_case(geom, seed):
    B, T, F, Ci, Co, pool = geom
    r = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    pt, pf = pool
    return dict(
        y=_bf(r.standard_normal((B, T, F, Co))),
        scale_f=f32(1.0 + 0.1 * r.standard_normal(F * Co)),
        bias_f=f32(0.1 * r.standard_normal(F * Co)),
        wg=_bf(r.standard_normal((Co, Co)) / np.sqrt(Co)),
        bg=_bf(r.standard_normal(Co) * 0.1),
        bits=r.integers(0, 256, (B, T, F * Co), dtype=np.uint8),
        g=_bf(r.standard_normal((B, T // pt, F // pf, Co))),
    )


def _jax_glu_bwd(geom, a, keep):
    """jax.vjp of glu_drop_pool in bf16 (F-pool in the kernel, as the JAX CNN
    runs it), on rows padded to Tp: zeros past T."""
    B, T, F, Ci, Co, pool = geom
    pt, pf = pool
    dims = pallas_cnn.BlockDims(B, T, F, Ci, Co, pt, pf)
    pad = lambda v: np.concatenate(
        [v, np.zeros((B, dims.Tp - T) + v.shape[2:], v.dtype)], axis=1)
    y = jnp.asarray(pad(a["y"].reshape(B, T, F * Co))).astype(jnp.bfloat16)
    bits = None if keep == 1.0 else jnp.asarray(pad(a["bits"]))
    fpool = pf > 1
    f = lambda y_, sc, bi, wg, bg: pallas_cnn.glu_drop_pool(
        y_, sc, bi, wg, bg, bits, dims, keep, True, fpool)
    z, vjp = jax.vjp(f, y, jnp.asarray(a["scale_f"][None]), jnp.asarray(a["bias_f"][None]),
                     jnp.asarray(a["wg"]).astype(jnp.bfloat16),
                     jnp.asarray(a["bg"]).astype(jnp.bfloat16))
    g = np.zeros((B, dims.Tpout, F // pf * Co), np.float32)
    g[:, :T // pt] = a["g"].reshape(B, T // pt, F // pf * Co)
    dy, dsc, dbi, dwg, dbg = vjp(jnp.asarray(g).astype(z.dtype))
    assert dy.dtype == dwg.dtype == dbg.dtype == jnp.bfloat16
    f32 = lambda v: np.asarray(jnp.asarray(v).astype(jnp.float32))
    return (f32(dy)[:, :T].reshape(B, T, F, Co), f32(dsc)[0], f32(dbi)[0], f32(dwg), f32(dbg))


@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_glu_drop_pool_bwd_bf16_matches_jax(geom, keep):
    """Row 4: dy, dwg, dbg (bf16) and dscale_f, dbias_f (fp32) from jax.vjp
    of glu_drop_pool in bf16, the same bits on both sides."""
    a = _glu_case(geom, 1)
    want = _jax_glu_bwd(geom, a, keep)
    t = lambda k: torch.from_numpy(a[k])
    got = fused_cnn.glu_drop_pool_bwd_plain(
        t("y").to(BF), t("scale_f"), t("bias_f"), t("wg").to(BF), t("bg").to(BF),
        None if keep == 1.0 else t("bits"), t("g").to(BF), pool=geom[5], keep_prob=keep)
    assert [v.dtype for v in got] == [BF, torch.float32, torch.float32, BF, BF]
    for name, u, v in zip(("dy", "dscale_f", "dbias_f", "dwg", "dbg"), got, want):
        if u.dtype == BF:
            _assert_bf16_close(u.float(), v, name)
        else:
            np.testing.assert_allclose(u.numpy(), v, rtol=0, atol=1e-5 * np.abs(v).max(),
                                       err_msg=name)


def test_dwg_takes_fp32_dlin():
    """dWg's right operand is dlin in fp32 (pallas_cnn.py:346-350, an fp32 x
    bf16 dot): JAX's dwg is the bf16 rounding of that product on (nearly)
    every entry, and not of the product with dlin rounded to bf16, which
    the test above would then refuse."""
    geom = (3, 16, 8, 16, 32, (1, 2))
    a = _glu_case(geom, 2)
    dwg_jax = _jax_glu_bwd(geom, a, 1.0)[3]
    B, T, F, _, Co, (pt, pf) = geom
    y = torch.from_numpy(a["y"])
    ybn = y * torch.from_numpy(a["scale_f"]).view(F, Co) + torch.from_numpy(a["bias_f"]).view(F, Co)
    gu = fused_cnn._unpool(torch.from_numpy(a["g"]), T, F, (pt, pf))
    dlin = (gu * torch.sigmoid(ybn)).reshape(-1, Co)
    lhs = ybn.to(BF).float().reshape(-1, Co).t()
    fp32_dlin = (lhs @ dlin).to(BF).float().numpy()
    bf16_dlin = (lhs @ dlin.to(BF).float()).to(BF).float().numpy()
    assert np.mean(fp32_dlin == dwg_jax) >= 0.99
    assert np.mean(bf16_dlin == dwg_jax) < 0.99


@pytest.mark.parametrize("geom", GEOMS[:3], ids=IDS[:3])
def test_bf16_gradients_are_bf16_values_in_fp32_parameters(geom):
    """Through fused_glu_block, the fp32 parameters of the conv and the GLU
    Dense receive the bf16 gradients exactly (the VJP of the cast, as JAX's
    astype), and the Functions return them as bf16 tensors."""
    B, T, F, Ci, Co, pool = geom
    r = np.random.default_rng(3)
    x = torch.from_numpy(_bf(r.standard_normal((B, T, F, Ci)))).to(BF).requires_grad_()
    leaves = [torch.from_numpy(np.asarray(v, np.float32)).requires_grad_() for v in (
        r.standard_normal((3, 3, Ci, Co)) / np.sqrt(9 * Ci), r.standard_normal(Co) * 0.1,
        1.0 + 0.1 * r.standard_normal(Co), 0.1 * r.standard_normal(Co),
        r.standard_normal((Co, Co)) / np.sqrt(Co), r.standard_normal(Co) * 0.1)]
    w, bias, gamma, beta, wg, bg = leaves
    ra = torch.zeros(Co), torch.ones(Co)
    z, _, _ = fused_cnn.fused_glu_block(x, w, bias, gamma, beta, *ra, wg, bg, pool=pool,
                                        train=True)
    assert z.dtype == BF
    gz = torch.from_numpy(_bf(r.standard_normal(tuple(z.shape)))).to(BF)
    grads = torch.autograd.grad((z.float() * gz.float()).sum(), [x, *leaves])
    assert grads[0].dtype == BF
    for name, g in zip(("w", "bias", "gamma", "beta", "wg", "bg"), grads[1:]):
        assert g.dtype == torch.float32, name
        if name in ("w", "bias", "wg", "bg"):
            assert _is_bf16_valued(g.numpy()), name
