"""The cluster kernels' W_hh layout (ops/gru.py cluster_layout, pack_weights)
and the shape-only plan, on the CPU.

The packed weights must rebuild W_hh exactly, with zeros in every padding
entry, for ragged unit slices too; and the products taken through the
layout's depth blocks (as csrc/gru.cu takes them) must equal the plain ones.
"""

import numpy as np
import pytest
import torch

from desed_task_tpu_torch.ops import gru

# hidden sizes: even slices on 6 CTAs (192, 12), ragged last slices (128,
# 100, 7, 350: the last too large to fit), fewer units than CTAs (5)
SHAPES = [192, 128, 100, 12, 7, 5, 350]


def _weights(H, seed):
    r = np.random.default_rng(seed)
    # no zero entries, so a zero in the pack is padding
    return [torch.from_numpy((r.random((3 * H, H)) + 0.5).astype(np.float32)) for _ in range(2)]


@pytest.mark.parametrize("H", SHAPES)
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_packed_weights_rebuild_w_hh(H, kind):
    lay = gru.cluster_layout(H)
    assert lay.C <= gru.CLUSTER_SIZE and (lay.C - 1) * lay.Uc < H <= lay.C * lay.Uc
    wf, wb = _weights(H, seed=H)
    packed = gru.pack_weights(wf, wb, lay, kind)
    depth, npad = ((lay.f_ks * lay.f_kc, lay.f_np) if kind == "fwd"
                   else (lay.b_ks * lay.b_kc, lay.b_np))
    assert packed.shape == (2, lay.C, depth, npad)
    rebuilt = torch.zeros(2, 3 * H, H)
    seen = torch.zeros(lay.C, depth, npad, dtype=torch.bool)
    for c in range(lay.C):
        for gate in range(3):
            for u in lay.units(c):
                col = gate * lay.Uc + u - c * lay.Uc  # the CTA's gate column
                if kind == "fwd":  # [depth k][column]
                    block, where = packed[:, c, :H, col], (c, slice(0, H), col)
                else:  # [depth column][unit v]
                    block, where = packed[:, c, col, :H], (c, col, slice(0, H))
                assert not seen[where].any(), "two weights share one slot"
                seen[where] = True
                rebuilt[:, gate * H + u] = block
    assert torch.equal(rebuilt[0], wf) and torch.equal(rebuilt[1], wb)
    assert int(seen.sum()) == 3 * H * H
    assert torch.count_nonzero(packed[:, ~seen]) == 0  # padding is zero


@pytest.mark.parametrize("H", [192, 100, 12])
def test_products_through_the_layout(H):
    """One forward step's gate columns and one backward step's dg W_hh,
    summed over the depth blocks in order as the kernels sum them, per CTA,
    against the plain products."""
    BT = gru.CLUSTER_ROWS
    lay = gru.cluster_layout(H)
    r = np.random.default_rng(1)
    wf, wb = _weights(H, seed=2)
    h = torch.from_numpy(r.standard_normal((BT, H)).astype(np.float32))
    dg = torch.from_numpy(r.standard_normal((BT, 3 * H)).astype(np.float32))
    fw = gru.pack_weights(wf, wb, lay, "fwd")[0]
    bw = gru.pack_weights(wf, wb, lay, "bwd")[0]
    # h^T as the forward keeps it: [depth][BT], zero past H
    ha = torch.zeros(lay.f_ks * lay.f_kc, BT)
    ha[:H] = h.t()
    g_want = h @ wf.t()
    p_sum = torch.zeros(BT, H)
    for c in range(lay.C):
        units = list(lay.units(c))
        g = sum(ha[ks * lay.f_kc:][:lay.f_kc].t() @ fw[c, ks * lay.f_kc:][:lay.f_kc]
                for ks in range(lay.f_ks))  # [BT, NP]
        for j in range(lay.f_np):
            gate, lu = divmod(j, lay.Uc)
            if gate < 3 and lu < len(units):
                torch.testing.assert_close(g[:, j], g_want[:, gate * H + units[lu]],
                                           rtol=1e-5, atol=1e-5)
            else:
                assert torch.count_nonzero(g[:, j]) == 0
        # this CTA's dg as the backward keeps it: [depth gate*Uc + u][BT]
        da = torch.zeros(lay.b_ks * lay.b_kc, BT)
        for gate in range(3):
            for u in units:
                da[gate * lay.Uc + u - c * lay.Uc] = dg[:, gate * H + u]
        for ks in range(lay.b_ks):
            p_sum += da[ks * lay.b_kc:][:lay.b_kc].t() @ bw[c, ks * lay.b_kc:][:lay.b_kc, :H]
    torch.testing.assert_close(p_sum, dg @ wf, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H", SHAPES)
def test_layout_widths_fill_warps(H):
    BT = gru.CLUSTER_ROWS
    lay = gru.cluster_layout(H)
    assert lay.f_np % 32 == 0 and lay.b_np % 32 == 0  # one depth block per warp
    assert lay.f_np >= 3 * lay.Uc and lay.b_np >= H
    assert lay.f_ks * lay.f_kc >= H and lay.b_ks * lay.b_kc >= 3 * lay.Uc
    assert max(lay.f_kc, lay.b_kc) <= gru.KC_MAX  # weights a thread holds
    assert lay.fwd_threads >= max(lay.f_ks * lay.f_np, lay.Uc * BT)
    assert lay.bwd_threads >= max(lay.b_ks * lay.b_np, lay.Uc * BT)


@pytest.mark.parametrize("B,T,H,plan", [
    (64, 156, 192, "cluster"),  # 2024 serving batch
    (60, 156, 192, "cluster"),  # 2024 train batch
    (64, 156, 128, "cluster"),  # 2023 width
    (5, 11, 100, "cluster"),
    (1, 7, 192, "cluster"),
    (2, 6, 512, "stream"),
    (3, 4, 350, "stream"),
])
def test_bigru_plan_by_shape(B, T, H, plan):
    assert gru.bigru_plan(B, T, H) == plan
    p, lay = gru.bigru_config(B, T, H)
    if p == "cluster":
        assert lay.fits and lay.C <= gru.CLUSTER_SIZE
        assert max(lay.fwd_smem, lay.bwd_smem) <= gru.SMEM_BYTES
    else:
        assert lay is None and not gru.cluster_layout(H).fits


def test_2024_layout_sizes():
    """H=192 on 6 CTAs: 32 units each, a 192 x 96 slice of W_hh per CTA
    without padding, four depth blocks of 48 in the forward (384 threads)
    and two of 48 in the backward (2 x 192 threads); H=128 (the 2023 width):
    22 units each, 66 gate columns padded to 96."""
    plan, lay = gru.bigru_config(64, 156, 192)
    assert plan == "cluster" and (lay.C, lay.Uc, lay.f_np, lay.b_np) == (6, 32, 96, 192)
    assert (lay.f_ks, lay.f_kc, lay.b_ks, lay.b_kc) == (4, 48, 2, 48)
    assert (lay.fwd_threads, lay.bwd_threads) == (384, 384)
    assert lay.fwd_smem < 110_000 and lay.bwd_smem < 110_000
    lay = gru.cluster_layout(128)
    assert (lay.C, lay.Uc, lay.f_np, lay.b_np) == (6, 22, 96, 128)
