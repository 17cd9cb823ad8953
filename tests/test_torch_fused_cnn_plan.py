"""The conv block's kernels' plans (ops/fused_cnn.py conv_fwd_plan,
glu_fwd_plan, conv_bwd_plan, glu_bwd_plan), on the CPU.

A plan is a pure function of the shape. Walked through the index maps that
csrc/fused_cnn.cu applies to it, every row, depth index and channel must be
covered exactly once, shared memory must fit the card, and the order in
which partial sums are added must follow from the shape alone. The forward
plans are walked in both modes (fp32 and bf16: the tensor-core conv's warp
tiles and ldmatrix rows; the bf16 GLU's register and ring kernels, whose
tile walks are also emulated in numpy against the plain version); the GLU
backward plan also at widths past 128 channels and at F * Co lane sums past
shared memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from desed_task_tpu_torch.ops import fused_cnn as fc

SMEM_LIMIT = 227 * 1024  # shared memory one H100 block may use


def _geoms_2024(B):
    """(B, T, F, Ci, Co, pool) of the seven crnn_2024() blocks, 10-s clips."""
    T, F, ci, out = 626, 128, 1, []
    for co, pool in zip([16, 32, 64, 128, 128, 128, 128],
                        [(2, 2), (2, 2)] + [(1, 2)] * 5):
        out.append((B, T, F, ci, co, pool))
        T, F, ci = T // pool[0], F // pool[1], co
    return out


# tests/test_torch_kernels_cuda.py BWD_GEOMS beside the 2024 blocks: B=1 /
# B=60, Ci=1, Ci=3, Co=70, F=1, pool remainders, ragged row tiles, scalar
# copies, ragged depth and channel tiles
BWD_GEOMS = [(1, 13, 16, 1, 8, (2, 2)), (60, 11, 6, 24, 40, (3, 4)),
             (3, 7, 5, 128, 128, (1, 2)), (2, 17, 3, 64, 16, (2, 1)),
             (1, 1, 1, 3, 70, (1, 1)), (3, 37, 70, 16, 32, (2, 2)),
             (2, 19, 9, 128, 128, (2, 2)), (2, 23, 3, 12, 20, (1, 1)),
             (1, 5, 130, 1, 24, (1, 2)), (2, 9, 7, 5, 6, (1, 1)),
             (2, 13, 8, 64, 96, (1, 2))]
GEOMS = _geoms_2024(60) + _geoms_2024(64) + BWD_GEOMS
IDS = [f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}" for g in GEOMS]
# the forward kernels also take blocks wider than 128 channels, and pools
# whose window does not divide 4 (tests/test_torch_kernels_cuda.py GEOMS)
WIDE = [(64, 156, 8, 128, 256, (1, 2)), (60, 156, 8, 128, 256, (1, 2)),
        (2, 8, 8, 1, 256, (2, 2)), (2, 8, 4, 256, 256, (1, 2)), (5, 9, 6, 24, 40, (3, 2)),
        (2, 11, 4, 64, 200, (2, 4)), (3, 13, 16, 1, 8, (2, 2))]
FWD_GEOMS = GEOMS + WIDE
FWD_IDS = IDS + [f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}-pool{g[5][0]}x{g[5][1]}" for g in WIDE]


def _once(counts, what):
    assert counts.min() == 1 and counts.max() == 1, f"{what}: not covered exactly once"


def _tile_rows(B, T, F, tt, ff, tiles):
    """Row index m of each (tile, row of the tile) that lies in the tensor
    (csrc `row_tile`: f-tiles fastest, then t-tiles, then b), -1 elsewhere."""
    i = np.arange(tiles)[:, None]
    nf, nt = -(-F // ff), -(-T // tt)
    b, t0, f0 = i // nf // nt, (i // nf) % nt * tt, i % nf * ff
    r = np.arange(tt * ff)[None, :]
    t, f = t0 + r // ff, f0 + r % ff
    ok = (t < T) & (f < F) & (b < B)
    return np.where(ok, (b * T + t) * F + f, -1)


def _rows_once(B, T, F, tt, ff, tiles):
    assert tiles == B * -(-T // tt) * -(-F // ff)
    m = _tile_rows(B, T, F, tt, ff, tiles)
    _once(np.bincount(m[m >= 0], minlength=B * T * F), "rows")


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_conv_bwd_plan_covers_dx(geom):
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_bwd_plan(B, T, F, Ci, Co)
    assert p.dx_smem == fc.dx_smem(p.dx_tt, p.dx_ff, p.dx_bn) <= fc.SMEM_HALF
    # 256 threads as NX column groups x NY row slots, 8 x 8 outputs each:
    # rows ty + NY i, or (segments, FF % 8 == 0 and dx_bn >= 64) ty * 8 + i
    nx = p.dx_bn // 8
    ny = 256 // nx
    if p.dx_ff % 8 == 0 and p.dx_bn >= 64:
        rows = (np.arange(ny)[:, None] * 8 + np.arange(8)[None, :]).ravel()
    else:
        rows = (np.arange(ny)[:, None] + ny * np.arange(8)[None, :]).ravel()
    assert p.dx_tt * p.dx_ff <= rows.size and np.array_equal(np.sort(rows), np.arange(rows.size))
    _rows_once(B, T, F, p.dx_tt, p.dx_ff, B * -(-T // p.dx_tt) * -(-F // p.dx_ff))
    n0 = np.arange(-(-Ci // p.dx_bn))[:, None, None] * p.dx_bn
    j = np.arange(8)[None, None, :]
    cols = n0 + np.arange(nx)[None, :, None] * 4 + (j // 4) * (p.dx_bn // 2) + j % 4
    _once(np.bincount(cols[cols < Ci].ravel(), minlength=Ci), "dx channels")


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_conv_bwd_plan_covers_dw(geom):
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_bwd_plan(B, T, F, Ci, Co)
    M, K = B * T * F, 9 * Ci
    assert p.stream == int(Ci == 1 and Co <= 128)
    if p.stream:  # blocks of rows_per_block rows; 256 threads as RS row slots x G groups
        starts = np.arange(p.chunks) * p.rows_per_block
        assert starts[-1] < M <= starts[-1] + p.rows_per_block
        g = -(-Co // 4)
        assert 256 // g >= 1 and 4 * g >= Co
        return
    R = p.dw_tt * p.dw_ff
    assert p.dw_smem == fc.dw_smem(p.dw_tt, p.dw_ff, Ci, p.dw_bko, p.dw_bno) <= fc.SMEM_HALF
    tm, tn, nty, ntx, rg = fc.dw_threads(p.dw_bko, p.dw_bno)
    assert (tm, nty * tm, ntx * tn) == (8, p.dw_bko, p.dw_bno) and nty * ntx * rg == 256
    # a stage holds whole frames, up to max(128, 8 rg) rows (one frame at
    # least, 256 rows at most); row group g takes rows g, g + rg, ...
    rows = min(fc.DW_MAX_ROWS, max(128, 8 * rg))
    assert R <= min(fc.DW_MAX_ROWS, max(rows, p.dw_ff))
    r = np.arange(rg)[:, None] + rg * np.arange(-(-R // rg))[None, :]
    _once(np.bincount(r[r < R], minlength=R), "stage rows")
    # depth and channel tiles: nty x ntx threads a row group, tm x tn outputs each
    k = (np.arange(-(-K // p.dw_bko))[:, None] * p.dw_bko
         + (np.arange(nty)[:, None] * tm + np.arange(tm)[None, :]).ravel()[None, :])
    _once(np.bincount(k[k < K], minlength=K), "depth")
    j = np.arange(tn)
    co = (np.arange(ntx)[:, None] * 4 + (j // 4) * (p.dw_bno // 2) + j % 4)
    co = (np.arange(-(-Co // p.dw_bno))[:, None] * p.dw_bno + co.ravel()[None, :]).ravel()
    _once(np.bincount(co[co < Co], minlength=Co), "dW channels")
    # chunks of dw_tpc row tiles, in order, cover every tile once
    tiles = np.concatenate([np.arange(c * p.dw_tpc, min(p.dw_tiles, (c + 1) * p.dw_tpc))
                            for c in range(p.chunks)])
    assert np.array_equal(tiles, np.arange(p.dw_tiles))
    _rows_once(B, T, F, p.dw_tt, p.dw_ff, p.dw_tiles)
    # about four blocks per SM in all, each with work
    blocks = -(-K // p.dw_bko) * -(-Co // p.dw_bno) * p.chunks
    assert blocks <= fc.DW_BLOCKS or p.chunks == 1
    assert (p.chunks - 1) * p.dw_tpc < p.dw_tiles


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_glu_bwd_plan_covers_positions(geom):
    B, T, F, _, Co, _ = geom
    p = fc.glu_bwd_plan(B, T, F, Co)
    assert (p.ks, p.lanes, p.passes) == (0, 1, 1)  # Wg whole, lane sums on chip
    assert p.smem == fc.glu_smem(F, Co, p.cp, p.p) <= SMEM_LIMIT
    assert Co <= p.cp and p.cp % 4 == 0 and p.p % (4 * p.pg) == 0
    assert p.p * p.cp <= 16 * fc.GLU_THREADS
    # tiles of p positions, tpb per block, cover every position once
    pos = (np.arange(p.n_tiles)[:, None] * p.p + np.arange(p.p)[None, :]).ravel()
    _once(np.bincount(pos[pos < B * T * F], minlength=B * T * F), "positions")
    blocks = [range(b * p.tpb, min(p.n_tiles, (b + 1) * p.tpb)) for b in range(p.n_blocks)]
    assert [t for r in blocks for t in r] == list(range(p.n_tiles)) and all(blocks)
    # product threads: cp/4 channel groups x p/4 position groups, 4 x 4 each,
    # as csrc maps thread tid (warps of 8 x 4 groups where the shape allows)
    n_cg = p.cp // 4
    tid = np.arange(n_cg * (p.p // 4))
    assert tid.size <= fc.GLU_THREADS
    if n_cg % 8 == 0 and (p.p // 4) % 4 == 0:
        cg = (tid // 32) % (n_cg // 8) * 8 + tid % 8
        pg = (tid // 32) // (n_cg // 8) * 4 + (tid % 32) // 8
    else:
        cg, pg = tid % n_cg, tid // n_cg
    owner = ((pg * 4)[..., None, None] + np.arange(4)[:, None]) * p.cp \
        + (cg * 4)[..., None, None] + np.arange(4)[None, :]
    _once(np.bincount(owner.ravel(), minlength=p.p * p.cp), "(position, channel)")
    # dWg threads: 4 x ct entries of [cp, cp] each, pg groups of p / pg positions
    nk, nc = p.cp // 4, p.cp // p.ct
    assert nk * nc * p.pg <= fc.GLU_THREADS
    # the block adds its position groups' dWg in the tile buffers, yt and dt
    assert p.pg * Co * Co <= 2 * p.cp * (p.p + 4)
    wk, wc = np.meshgrid(np.arange(nk), np.arange(nc), indexing="ij")
    ent = ((wk[..., None, None] + nk * np.arange(4)[:, None]) * p.cp
           + wc[..., None, None] + nc * np.arange(p.ct)[None, :])
    _once(np.bincount(ent.ravel(), minlength=p.cp * p.cp), "dWg entries")


@pytest.mark.parametrize("geom", _geoms_2024(60), ids=IDS[:7])
def test_plans_depend_on_the_shape_alone(geom):
    """Equal shapes give equal plans, hence the same tiles, chunks and order
    of partial sums; the 2024 train shapes keep two dx / dW blocks and at
    least 12 warps of glu_drop_pool_bwd resident per SM."""
    B, T, F, Ci, Co, _ = geom
    a, b = fc.conv_bwd_plan(B, T, F, Ci, Co), fc.conv_bwd_plan(*geom[:5])
    assert a == b and a.ints() == b.ints() and all(isinstance(v, int) for v in a.ints())
    g1, g2 = fc.glu_bwd_plan(B, T, F, Co), fc.glu_bwd_plan(B, T, F, Co)
    assert g1 == g2 and all(isinstance(v, int) for v in g1.ints())
    assert 2 * max(a.dx_smem, a.dw_smem) <= SMEM_LIMIT * 1.0 + 1024
    assert fc.GLU_THREADS // 32 >= 12 and g1.n_blocks <= fc.SM_COUNT


# (B, T, F, Co): 192 and 256 channels (the wide kernel: Wg in slices, dWg
# in passes), the 256-channel block of chip_smoke.py at B=60, and F * Co lane
# sums past shared memory (512 x 128; 64 x 128 beside the whole Wg)
WIDE_BWD = [(2, 8, 8, 192), (60, 156, 8, 256), (2, 9, 8, 256), (2, 4, 512, 128),
            (3, 5, 64, 128), (2, 3, 7, 200)]


@pytest.mark.parametrize("geom", WIDE_BWD, ids=[f"F{g[2]}-Co{g[3]}" for g in WIDE_BWD])
def test_glu_bwd_plan_wide_and_large_lanes(geom):
    """Walked through the kernel's maps: every position once (tiles of p, tpb
    a block), every (position, channel) of a tile once among the product
    threads, every depth row of Wg and Wg^T once over the slices, every dWg
    entry once over the passes, and every lane of a tile once among the lane
    passes' threads; shared memory within the card's limit."""
    B, T, F, Co = geom
    p = fc.glu_bwd_plan(B, T, F, Co)
    wide = Co > 128
    assert (p.passes > 1) == wide and (p.ks > 0) == wide and p.pg >= 1
    assert p.smem == fc.glu_smem(F, Co, p.cp, p.p, p.ks, p.lanes) <= SMEM_LIMIT
    # the lane sums stay on chip wherever they fit beside the least tile
    # (the wide kernel: beside its full tile and a slice of 4 rows)
    least = fc.glu_smem(F, Co, p.cp, p.p if wide else 4 * p.pg, 4 if wide else 0, 1)
    assert p.lanes == int(least <= SMEM_LIMIT)
    assert p.lanes == int(F * Co < 64 * 128)  # these shapes: 512 x 128 and 64 x 128 do not
    pos = (np.arange(p.n_tiles)[:, None] * p.p + np.arange(p.p)[None, :]).ravel()
    _once(np.bincount(pos[pos < B * T * F], minlength=B * T * F), "positions")
    blocks = [range(b * p.tpb, min(p.n_tiles, (b + 1) * p.tpb)) for b in range(p.n_blocks)]
    assert [t for r in blocks for t in r] == list(range(p.n_tiles)) and all(blocks)
    # product threads: cp/4 channel groups x p/4 position groups
    n_cg = p.cp // 4
    tid = np.arange(n_cg * (p.p // 4))
    assert tid.size <= fc.GLU_THREADS and Co <= p.cp
    if n_cg % 8 == 0 and (p.p // 4) % 4 == 0:
        cg = (tid // 32) % (n_cg // 8) * 8 + tid % 8
        pg = (tid // 32) // (n_cg // 8) * 4 + (tid % 32) // 8
    else:
        cg, pg = tid % n_cg, tid // n_cg
    owner = ((pg * 4)[..., None, None] + np.arange(4)[:, None]) * p.cp \
        + (cg * 4)[..., None, None] + np.arange(4)[None, :]
    _once(np.bincount(owner.ravel(), minlength=p.p * p.cp), "(position, channel)")
    if wide:  # slices k0 = 0, ks, ... of min(ks, Co - k0) rows
        rows = np.concatenate([np.arange(k0, min(Co, k0 + p.ks)) for k0 in range(0, Co, p.ks)])
        _once(np.bincount(rows, minlength=Co), "Wg rows over the slices")
        nk, nc = p.cp // 4, p.cp // p.ct
        ids = np.arange(p.passes * fc.GLU_THREADS)
        ids = ids[ids < nk * nc]
        wk, wc = ids // nc, ids % nc
        ent = ((wk[:, None, None] + nk * np.arange(4)[:, None]) * p.cp
               + wc[:, None, None] + nc * np.arange(p.ct)[None, :])
        _once(np.bincount(ent.ravel(), minlength=p.cp * p.cp), "dWg entries over the passes")
        assert p.passes == -(-nk * nc // fc.GLU_THREADS)
    # the lane passes: entry e < min(p, F) * Co is lane ((f_first + e // Co) % F, e % Co),
    # adding the tile's positions e // Co, + F, ...: each lane with a position once
    for tile in {0, 1, p.n_tiles - 1}:
        m0 = tile * p.p
        e = np.arange(min(p.p, F) * Co)
        j, c = e // Co, e % Co
        lane = ((m0 % F + j) % F) * Co + c
        assert np.unique(lane).size == lane.size
        touched = np.unique((np.arange(m0, min(m0 + p.p, B * T * F)) % F)[:, None] * Co
                            + np.arange(Co)[None, :])
        assert set(touched) <= set(lane)


def test_glu_bwd_plan_takes_every_width():
    """Every Co up to GLU_MAX_CP and every F plan within shared memory (the
    wide kernel past 128 channels, the lane sums in device memory where they
    do not fit); past 32-bit position counts or GLU_MAX_CP it raises."""
    for Co in list(range(1, 300, 7)) + [384, 512, 1000, fc.GLU_MAX_CP]:
        for F in (1, 2, 8, 33, 128, 512, 2000):
            p = fc.glu_bwd_plan(2, 5, F, Co)
            assert p.smem <= SMEM_LIMIT and (p.passes > 1) == (Co > 128)
    with pytest.raises(ValueError):
        fc.glu_bwd_plan(2, 4, 4, fc.GLU_MAX_CP + 1)
    with pytest.raises(ValueError):
        fc.glu_bwd_plan(2**16, 2**8, 2**7, 16)  # 2^31 positions



def _swz(row, chunk):
    """csrc swz: element offset of (row, 8-channel chunk) in a [rows][16] bf16 array."""
    return row * fc.BF16_BK + ((chunk ^ (row >> 2)) & 1) * 8


def _walk_bf16_conv(p, B, T, F, Ci, Co):
    """conv3x3_bf16_kernel's maps: 8 warps as WM x WN, each MI m16 tiles of
    rows x NI n8 tiles of channels; ldmatrix rows; bank groups."""
    assert p.smem == fc.fwd_bf16_smem(p.tt, p.ff, p.bn) <= fc.SMEM_HALF
    assert p.vec == int(Ci % 8 == 0) and p.seg == 0
    wn = 2 if p.bn >= 64 else 1
    wm, ni, mi = 8 // wn, p.bn // (8 * wn), 2 if p.bn == 128 else 4
    mt = wm * 16 * mi
    assert mt == fc.bf16_rows(p.bn) and p.tt * p.ff <= mt and 4 * mi * ni <= 64
    lane = np.arange(32)
    # accumulators: warp (wm, wn), lane, m16 tile mi, n8 tile ni, element e
    # -> row wm*16*mi + mi*16 + g + 8 (e // 2), column wn*ni*8 + ni*8 + 2 tq + e % 2
    W_m, W_n, L_, M_i, N_i, E_ = np.meshgrid(np.arange(wm), np.arange(wn), lane, np.arange(mi),
                                              np.arange(ni), np.arange(4), indexing="ij")
    rows = W_m * 16 * mi + M_i * 16 + L_ // 4 + 8 * (E_ // 2)
    cols = W_n * ni * 8 + N_i * 8 + 2 * (L_ % 4) + E_ % 2
    _once(np.bincount((rows * p.bn + cols).ravel(), minlength=mt * p.bn),
          "(row, column) of the block tile")
    # ldmatrix: A lane l names row l % 16 and chunk l // 16 of an m16 tile;
    # B (x4) names row (l // 16) * 8 + l % 8 of an n8 pair and chunk (l // 8) % 2
    a = (lane % 16) * 2 + lane // 16
    _once(np.bincount(a, minlength=32), "A fragment rows and chunks")
    if ni >= 2:
        b = ((lane // 16) * 8 + lane % 8) * 2 + (lane // 8) % 2
        _once(np.bincount(b, minlength=32), "B fragment rows and chunks")
    # any 8 consecutive rows of one chunk fall in 8 distinct 16-byte bank groups
    for r0 in range(0, 24):
        for ch in (0, 1):
            groups = {(2 * _swz(r, ch)) // 16 % 8 for r in range(r0, r0 + 8)}
            assert len(groups) == 8


@pytest.mark.parametrize("geom", FWD_GEOMS, ids=FWD_IDS)
def test_conv_fwd_plan_covers_outputs_and_lanes(geom):
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co)
    L, R = F * Co, B * T
    assert p.stream == int(Ci == 1) and p.vec == int(Co % 4 == 0)
    if p.stream:
        # blocks (lane block, part): thread (f, g) makes channels 4g .. 4g+3 of
        # its frequency over rows part * rows_per_part ..., the run in order
        starts = np.arange(p.n_parts) * p.rows_per_part
        rows = np.concatenate([np.arange(a, min(R, a + p.rows_per_part)) for a in starts])
        assert np.array_equal(rows, np.arange(R)) and starts[-1] < R
        g = -(-Co // 4)
        lg = np.arange(-(-F * g // 256) * 256)
        lg = lg[lg < F * g]
        lanes = (lg // g * Co + lg % g * 4)[:, None] + np.arange(4)[None, :]
        lanes = lanes[(lg % g * 4)[:, None] + np.arange(4)[None, :] < Co]
        _once(np.bincount(lanes, minlength=L), "lanes")
        assert p.n_parts * -(-F * g // 256) <= fc.C1_BLOCKS or p.n_parts == 1
    else:
        assert p.smem == fc.fwd_smem(p.tt, p.ff, p.bn) <= fc.SMEM_HALF
        assert p.seg == int(p.ff % 8 == 0 and p.bn >= 64)
        # conv3x3_kernel's rows and channels, as the dx walker reads them
        nx = p.bn // 8
        ny = 256 // nx
        if p.seg:
            rows = (np.arange(ny)[:, None] * 8 + np.arange(8)[None, :]).ravel()
        else:
            rows = (np.arange(ny)[:, None] + ny * np.arange(8)[None, :]).ravel()
        assert p.tt * p.ff <= rows.size and np.array_equal(np.sort(rows), np.arange(rows.size))
        nt, nf = -(-T // p.tt), -(-F // p.ff)
        tiles = B * nt * nf
        _rows_once(B, T, F, p.tt, p.ff, tiles)
        n0 = np.arange(-(-Co // p.bn))[:, None, None] * p.bn
        j = np.arange(8)[None, None, :]
        cols = n0 + np.arange(nx)[None, :, None] * 4 + (j // 4) * (p.bn // 2) + j % 4
        _once(np.bincount(cols[cols < Co].ravel(), minlength=Co), "output channels")
        # the STATS epilogue: tile i writes partial row i // nf for the lanes
        # of its frequencies; each (partial row, lane) once, and each partial
        # row holds the frames of one (clip, frame tile)
        assert p.n_parts == B * nt
        i = np.arange(tiles)
        prow, f0 = i // nf, i % nf * p.ff
        f = f0[:, None] + np.arange(p.ff)[None, :]
        ok = f < F
        writes = (prow[:, None, None] * L + (f * Co)[:, :, None]
                  + np.arange(Co)[None, None, :])[ok]
        _once(np.bincount(writes.ravel(), minlength=p.n_parts * L), "lane partials")
        b, t = np.arange(R) // T, np.arange(R) % T
        frames = np.minimum(p.tt, T - np.arange(p.n_parts) % nt * p.tt)
        assert np.array_equal(np.bincount(b * nt + t // p.tt, minlength=p.n_parts), frames)
    # the final pass: runs of consecutive partial rows, added in run order
    per = -(-p.n_parts // fc.STATS_RUNS)
    runs = np.concatenate([np.arange(g * per, min(p.n_parts, (g + 1) * per))
                           for g in range(fc.STATS_RUNS)])
    assert np.array_equal(runs, np.arange(p.n_parts))


def _ring_tiles(p, B, T, F, pool):
    """(b, t0, f0, tv, fv) of each tile of glu_fwd_ring_kernel (csrc
    `glu_tile`: f-tiles fastest, then t-tiles, then clips; frames below
    To*pt, frequencies below Fo*pf)."""
    pt, pf = pool
    Ts, Fs = T // pt * pt, F // pf * pf
    nf, nt = -(-Fs // p.ff), -(-Ts // p.tt)
    i = np.arange(p.n_tiles)
    f0, t0, b = i % nf * p.ff, i // nf % nt * p.tt, i // nf // nt
    return b, t0, f0, np.minimum(p.tt, Ts - t0), np.minimum(p.ff, Fs - f0)


def _ring_copies(p, g, T, F, Co):
    """The copies of one tile's stage as the kernel issues them: (source
    element of y and of the bits, stage element, elements read); with vec,
    16-byte chunks (8 elements) of each frame's run, the last one partial."""
    b, t0, f0, tv, fv = g
    run = fv * Co
    per = -(-run // 8) if p.vec else run
    i = np.arange(tv * per)
    j, k = i // per, i % per * (8 if p.vec else 1)
    n = np.minimum(8, run - k) if p.vec else np.ones_like(k)
    src = ((b * T + t0 + j) * F + f0) * Co + k
    return src, j * p.ff * Co + k, n


def _walk_glu_ring(p, B, T, F, Co, pool):
    """glu_fwd_ring_kernel's plan: channel tiles and warps, shared memory
    layout (every part and stage on 16 bytes, within the card's limit, the
    occupancy it claims), tiles of whole windows below the pooled extent,
    every pooled output once, every staged frame inside its clip and below
    To*pt, every copy aligned; the fragments' rows and columns once a pass."""
    pt, pf = pool
    To, Fo = T // pt, F // pf
    assert p.ct in (16, 32, 64, 128) and p.ct == fc._pow2_tile(Co, 16, 128)
    assert p.grid_y == -(-Co // p.ct) and p.kp == -(-Co // 16) * 16
    assert p.tt % pt == 0 and p.ff % pf == 0 and 2 <= p.stages <= 4
    assert p.ff <= max(Fo * pf, pf)
    rows = p.tt * p.ff
    assert not p.frag
    lay = fc.glu_ring_layout(Co, p.ct, rows, p.stages)
    offs = [lay["bs"], lay["As"], lay["gt"], lay["ring"]] + [
        lay["ring"] + s * lay["stage"] + part for s in range(p.stages)
        for part in (0, lay["ybytes"])] + [lay["end"]]
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert lay["As"] == 2 * p.ct * (p.kp + 8) and lay["ybytes"] >= 2 * rows * Co
    assert lay["stage"] - lay["ybytes"] >= rows * Co
    assert p.smem == lay["end"] <= SMEM_LIMIT
    assert p.per_sm * (p.smem + 1024) <= fc.SMEM_SM
    assert p.vec == int(F * Co % 8 == 0 and p.ff * Co % 8 == 0)
    if To == 0 or Fo == 0:
        assert p.n_tiles == 0
        return
    assert p.n_tiles == B * -(-To * pt // p.tt) * -(-Fo * pf // p.ff)
    assert 1 <= p.grid_x <= p.n_tiles
    b, t0, f0, tv, fv = _ring_tiles(p, B, T, F, pool)
    assert (tv % pt == 0).all() and (fv % pf == 0).all() and (tv > 0).all() and (fv > 0).all()
    # pooled outputs: tile (jo, fo) -> z row, each once
    jo, fo = np.meshgrid(np.arange(p.tt // pt), np.arange(p.ff // pf), indexing="ij")
    ok = (jo[None] * pt < tv[:, None, None]) & (fo[None] * pf < fv[:, None, None])
    q = ((b[:, None, None] * To + t0[:, None, None] // pt + jo[None]) * Fo
         + f0[:, None, None] // pf + fo[None])
    _once(np.bincount(q[ok], minlength=B * To * Fo), "pooled outputs")
    # each tile's copies: inside its clip, below To*pt and Fo*pf, each staged
    # element once, every chunk on 16 bytes (y) and 8 (bits)
    for i in sorted({0, p.n_tiles // 2, p.n_tiles - 1}):
        g = (b[i], t0[i], f0[i], tv[i], fv[i])
        src, dst, n = _ring_copies(p, g, T, F, Co)
        e = np.arange(8)[None, :]
        live = e < n[:, None]
        s_el, d_el = (src[:, None] + e)[live], (dst[:, None] + e)[live]
        t, f = s_el // Co // F % T, s_el // Co % F
        assert (s_el // Co // F // T == b[i]).all() and (t < To * pt).all() and (f < Fo * pf).all()
        assert (t >= t0[i]).all() and (t < t0[i] + tv[i]).all()
        assert (f >= f0[i]).all() and (f < f0[i] + fv[i]).all()
        assert np.unique(s_el).size == s_el.size == tv[i] * fv[i] * Co
        assert np.array_equal((t - t0[i]) * p.ff * Co + (f - f0[i]) * Co + s_el % Co, d_el)
        if p.vec:
            assert (src % 8 == 0).all() and (dst % 8 == 0).all()
            assert (dst + 8 <= rows * Co).all()  # a zero-filled tail stays in the stage
    # fragments: warp (wm, wn), pass, m16 tile mt = pass + wm + WM mi, n8 tile
    # ni, lane, element -> each (row, column) of the padded tile once
    wn_, ni_, wm_, mi_ = fc.glu_ring_warps(p.ct)
    assert wn_ * ni_ * 8 == p.ct and wm_ * wn_ == 8 and mi_ * ni_ == 8
    rm = -(-rows // 16)
    Pa, Wm, Wn, M_i, N_i, L_, E_ = np.meshgrid(
        np.arange(0, rm, wm_ * mi_), np.arange(wm_), np.arange(wn_), np.arange(mi_),
        np.arange(ni_), np.arange(32), np.arange(4), indexing="ij")
    mt = Pa + Wm + wm_ * M_i
    live = mt < rm
    r = (mt * 16 + L_ // 4 + 8 * (E_ // 2))[live]
    c = (Wn * ni_ * 8 + N_i * 8 + 2 * (L_ % 4) + E_ % 2)[live]
    _once(np.bincount(r * p.ct + c, minlength=rm * 16 * p.ct), "(row, column)")
    chans = (np.arange(p.grid_y)[:, None] * p.ct + np.arange(p.ct)[None, :]).ravel()
    _once(np.bincount(chans[chans < Co], minlength=Co), "output channels")


def _frag_tiles(p, B, T, F, pool):
    """(b, t0, f0, tv, fv) of each warp tile of glu_fwd_frag_kernel (csrc
    `decode`: f-tiles fastest, then t-tiles, then clips)."""
    pt, pf = pool
    Ts, Fs = T // pt * pt, F // pf * pf
    nf, nt = -(-Fs // p.ff), -(-Ts // p.tt)
    i = np.arange(p.n_tiles)
    fi, r = i % nf, i // nf
    b = r // nt
    t0 = (r - b * nt) * p.tt
    return b, t0, fi * p.ff, np.minimum(p.tt, Ts - t0), np.minimum(p.ff, Fs - fi * p.ff)


def _frag_copies(p, g, T, F, Co):
    """A warp tile's 16-byte copies as the kernel issues them: (source
    element, stage element of y (rows of Co + 8), stage byte of the bits)."""
    b, t0, f0, tv, fv = g
    ni = Co // 8
    per = fv * ni
    i = np.arange(tv * per)
    j, q = i // per, i % per
    f, c = q // ni, q % ni * 8
    src = (((b * T + t0 + j) * F + f0 + f) * Co + c)
    return src, (j * p.ff + f) * (Co + 8) + c, (j * p.ff + f) * Co + c


def _frag_rows(p, mt, gq):
    """Each lane's rows g and g + 8 of m16 tile mt: (stage row of the tile's
    first row, frequency fl in the tile, frames j0 and j1)."""
    if p.frag == 2:  # 16 consecutive rows of whole frames of ff frequencies
        r0 = 16 * mt + gq
        return 16 * mt, r0 % p.ff, r0 // p.ff, r0 // p.ff + 8 // p.ff
    return 8 * mt, 8 * mt + gq, np.zeros_like(gq), np.ones_like(gq)


def _walk_glu_frag(p, B, T, F, Co, pool):
    """glu_fwd_frag_kernel's plan: the shapes it takes, its shared memory
    (16-byte parts, within the card's limit and the occupancy it claims),
    every warp tile once over the blocks' warps, every pooled output once
    (by the lanes that store them), every copy inside its clip, below To*pt
    and Fo*pf, aligned and staged once."""
    pt, pf = pool
    To, Fo = T // pt, F // pf
    Fs = Fo * pf
    assert fc.glu_frag_takes(T, F, Co, pool) and p.frag in (1, 2)
    assert p.ct == p.kp == Co and p.grid_y == 1 and p.vec == 1 and 2 <= p.stages <= 4
    if p.frag == 1:
        assert p.tt == 2 and p.ff % 8 == 0 and p.ff <= Fs and Fs % 8 == 0
    else:
        assert pt == 1 and p.ff == Fs and 8 % Fs == 0 and p.tt * p.ff % 16 == 0
    lay = fc.glu_frag_layout(Co, Fs, p.tt, p.ff, p.stages)
    offs = [lay["bs"], lay["sb"], lay["ring"]] + [
        lay["ring"] + (w * p.stages + s) * lay["stage"] + part for w in range(fc.GLU_FRAG_WARPS)
        for s in range(p.stages) for part in (0, lay["ybytes"])] + [lay["end"]]
    assert all(o % 16 == 0 for o in offs) and offs == sorted(offs)
    assert p.smem == lay["end"] <= SMEM_LIMIT and p.per_sm * (p.smem + 1024) <= fc.SMEM_SM
    assert p.per_sm <= fc.GLU_FRAG_PER_SM[Co]
    # ldmatrix's 8 rows of y and of Bs (pitch Co + 8) in 8 distinct bank groups
    assert len({(r * (Co + 8) * 2 // 16) % 8 for r in range(8)}) == 8
    nw = p.grid_x * fc.GLU_FRAG_WARPS
    assert p.n_tiles == B * -(-To * pt // p.tt) * -(-Fs // p.ff)
    assert nw - fc.GLU_FRAG_WARPS < p.n_tiles
    owned = np.concatenate([np.arange(w, p.n_tiles, nw) for w in range(nw)])
    _once(np.bincount(owned, minlength=p.n_tiles), "warp tiles")
    b, t0, f0, tv, fv = _frag_tiles(p, B, T, F, pool)
    assert (t0 % pt == 0).all() and (fv > 0).all() and (tv > 0).all()
    assert (tv == p.tt).all() or pt == 1
    # pooled outputs as the kernel's lanes store them: each lane's rows (frame
    # j, frequency fl) of each m16 tile, a store where the window starts
    gq = np.arange(8)  # the lane rows g (each with 4 lanes tq of 2 channels)
    n_m = -(-(tv * p.ff) // 16) if p.frag == 2 else fv // 8
    q_all = []
    for mt in range(int(n_m.max())):
        _, fl, j0, j1 = _frag_rows(p, mt, gq)
        for j in ([j0] if pt == 2 else [j0, j1]):
            live = (mt < n_m)[:, None] & (j < tv[:, None]) & ((gq & 1) == 0 if pf == 2 else True)
            to = (t0[:, None] + j) // pt
            q = (b[:, None] * To + to) * Fo + (f0[:, None] + fl) // pf
            q_all.append(q[live])
    _once(np.bincount(np.concatenate(q_all), minlength=B * To * Fo), "pooled outputs")
    for i in sorted({0, p.n_tiles // 2, p.n_tiles - 1}):
        g = (b[i], t0[i], f0[i], tv[i], fv[i])
        src, ydst, bdst = _frag_copies(p, g, T, F, Co)
        assert (src % 8 == 0).all() and (ydst % 8 == 0).all() and (bdst % 8 == 0).all()
        s_el = (src[:, None] + np.arange(8)[None, :]).ravel()
        t, ff_ = s_el // Co // F % T, s_el // Co % F
        assert (s_el // Co // F // T == b[i]).all() and (t < To * pt).all() and (ff_ < Fs).all()
        assert ((t - t0[i] < tv[i]) & (t >= t0[i]) & (ff_ >= f0[i]) & (ff_ - f0[i] < fv[i])).all()
        assert np.unique(s_el).size == s_el.size == tv[i] * fv[i] * Co
        assert np.unique(ydst).size == ydst.size and (ydst + 8 <= p.tt * p.ff * (Co + 8)).all()


def _emulate_glu_frag(p, y, sf, bfv, wg, bg, bits, pool, keep):
    """z of glu_fwd_frag_kernel from its plan, lane by lane, in fp32 without
    the bf16 roundings: each warp tile's stage from its copies; per m16
    tile each lane's A fragment registers from ldmatrix's row addresses
    (matrix i's row r named by lane 8 i + r), BN(y) from sb, the B
    fragments from Bs by ldmatrix.trans (lane 8 i + 2 tq + h names the row
    of the h-th element); the product from the fragments in the m16n8k16
    layout; the GLU with each accumulator's gate taken from the A fragment
    the kernel takes it from; dropout from the staged bits; the pool through
    lane ^ 4 and rows g, g + 8; each pooled output once."""
    B, T, F, Co = y.shape
    pt, pf = pool
    To, Fo, Fs = T // pt, F // pf, F // pf * pf
    ni_, ks_, yp, sp = Co // 8, Co // 16, Co + 8, Co // 2 + 4
    yf, bits_f = y.reshape(-1), None if bits is None else bits.reshape(-1)
    thresh = fc.keep_threshold(keep)
    sb = np.zeros((Fs, sp, 4), np.float32)
    pr = np.arange(Co // 2)
    for f in range(Fs):
        lane_ = f * Co + 2 * pr
        sb[f, : Co // 2] = np.stack([sf[lane_], sf[lane_ + 1], bfv[lane_], bfv[lane_ + 1]], 1)
    sb = sb.reshape(-1, 4)
    bs = np.zeros((Co, yp), np.float32)  # Wg as it is: [k][n]
    bs[:, :Co] = wg
    bs = bs.reshape(-1)
    lanes = np.arange(32)
    gq, tq = lanes >> 2, lanes & 3
    a_row = (lanes & 15) if p.frag == 2 else ((lanes >> 3) & 1) * p.ff + (lanes & 7)
    a_chunk = (lanes >> 4) * 8
    b_off = (((lanes >> 3) & 1) * 8 + (lanes & 7)) * yp + (lanes >> 4) * 8
    z = np.full((B * To * Fo, Co), np.nan, np.float32)
    tiles = _frag_tiles(p, B, T, F, pool)
    for i in range(p.n_tiles):
        b, t0, f0, tv, fv = (int(a[i]) for a in tiles)
        ys = np.full(p.tt * p.ff * yp, np.nan, np.float32)
        bst = np.full(p.tt * p.ff * Co, -1, np.int64)
        src, ydst, bdst = _frag_copies(p, (b, t0, f0, tv, fv), T, F, Co)
        e8 = np.arange(8)
        ys[(ydst[:, None] + e8).ravel()] = yf[(src[:, None] + e8).ravel()]
        if bits_f is not None:
            bst[(bdst[:, None] + e8).ravel()] = bits_f[(src[:, None] + e8).ravel()]
        n_m = -(-(tv * p.ff) // 16) if p.frag == 2 else fv // 8
        for mt in range(n_m):
            row0, fl, j0, j1 = _frag_rows(p, mt, gq)
            fg = f0 + fl
            amat = np.full((16, Co), np.nan, np.float32)
            gates = np.zeros((ks_, 8, 32), np.float32)  # gv[ks][0..7] of each lane
            for ks in range(ks_):
                for r in range(4):  # register r from matrix r: rows named by lanes 8 r + g
                    addr = (a_row[8 * r + gq] + row0) * yp + ks * 16 + a_chunk[8 * r + gq] \
                        + 2 * tq
                    sbv = sb[fg * sp + ks * 8 + (4 if r >= 2 else 0) + tq]
                    lo = ys[addr] * sbv[:, 0] + sbv[:, 2]
                    hi = ys[addr + 1] * sbv[:, 1] + sbv[:, 3]
                    gates[ks, 2 * r], gates[ks, 2 * r + 1] = lo, hi
                    row = gq + 8 * (r & 1)
                    k = ks * 16 + 8 * (r >> 1) + 2 * tq
                    amat[row, k], amat[row, k + 1] = lo, hi
            bmat = np.full((Co, Co), np.nan, np.float32)  # [k][n]
            for ks in range(ks_):
                for n2 in range(0, ni_, 2):
                    for r in range(4):
                        for h in range(2):  # .trans: lane 8 r + 2 tq + h names the row
                            addr = ks * 16 * yp + n2 * 8 + b_off[8 * r + 2 * tq + h] + gq
                            k = ks * 16 + 8 * (r & 1) + 2 * tq + h
                            bmat[k, (n2 + (r >> 1)) * 8 + gq] = bs[addr]
            cmat = amat @ bmat
            acc = np.zeros((ni_, 4, 32), np.float32)
            for ni in range(ni_):
                for e in range(4):
                    row, n = gq + 8 * (e >> 1), ni * 8 + 2 * tq + (e & 1)
                    gate = gates[ni >> 1, 4 * (ni & 1) + e]
                    v = (cmat[row, n] + bg[n]) / (1.0 + np.exp(-gate))
                    if bits_f is not None:
                        kb = bst[((j1 if e >= 2 else j0) * p.ff + fl) * Co + n]
                        v = np.where(kb < thresh, v / keep, 0.0)
                    acc[ni, e] = v
            part = acc[:, :, lanes ^ 4]  # __shfl_xor_sync(..., 4)
            lead = (gq & 1) == 0 if pf == 2 else np.ones(32, bool)
            for ni in range(ni_):
                c = ni * 8 + 2 * tq
                outs = []
                if pt == 2:
                    o = [acc[ni, 0], acc[ni, 1]]
                    if pf == 2:
                        o = [o[0] + part[ni, 0], o[1] + part[ni, 1]]
                    o = [o[0] + acc[ni, 2], o[1] + acc[ni, 3]]
                    if pf == 2:
                        o = [o[0] + part[ni, 2], o[1] + part[ni, 3]]
                    outs.append((t0 // 2, lead, o))
                else:
                    for hh, j in enumerate((j0, j1)):
                        o = [acc[ni, 2 * hh], acc[ni, 2 * hh + 1]]
                        if pf == 2:
                            o = [o[0] + part[ni, 2 * hh], o[1] + part[ni, 2 * hh + 1]]
                        outs.append((t0 + j, lead & (j < tv), o))
                for to, sel, o in outs:
                    q = (b * To + to) * Fo + fg // pf
                    for h in range(2):
                        assert np.isnan(z[q[sel], c[sel] + h]).all(), "a pooled output written twice"
                        z[q[sel], c[sel] + h] = o[h][sel] / (pt * pf)
    return z.reshape(B, To, Fo, Co)


def _emulate_glu_ring(p, y, sf, bfv, wg, bg, bits, pool, keep):
    """z of glu_fwd_ring_kernel from its plan, in fp32 without the bf16
    roundings: each tile's stage from the copies, BN(y) of its rows into As
    and gt by the A items (8 channels, the thread's cached lane), the
    product, the GLU, then dropout and each window's sum in window order
    from the staged bits; every pooled output written once (else NaN)."""
    B, T, F, Co = y.shape
    pt, pf = pool
    To, Fo = T // pt, F // pf
    yf, bits_f = y.reshape(-1), None if bits is None else bits.reshape(-1)
    thresh = fc.keep_threshold(keep)
    z = np.full((B * To * Fo, Co), np.nan, np.float32)
    rows, nch = p.tt * p.ff, p.kp // 8
    tiles = _ring_tiles(p, B, T, F, pool)
    for ty in range(p.grid_y):
        n0 = ty * p.ct
        bs = np.zeros((p.ct, p.kp), np.float32)  # Wg^T of the channel tile
        n_hi = min(Co, n0 + p.ct)
        bs[: n_hi - n0, :Co] = wg[:, n0:n_hi].T
        bgt = np.zeros(p.ct, np.float32)
        bgt[: n_hi - n0] = bg[n0:n_hi]
        for i in range(p.n_tiles):
            g = tuple(int(a[i]) for a in tiles)
            b, t0, f0, tv, fv = g
            ys = np.full(rows * Co + 8, np.nan, np.float32)
            st = np.full(rows * Co + 8, -1, np.int64)
            src, dst, n = _ring_copies(p, g, T, F, Co)
            for s_, d_, n_ in zip(src, dst, n):
                ys[d_: d_ + n_] = yf[s_: s_ + n_]
                if bits_f is not None:
                    st[d_: d_ + n_] = bits_f[s_: s_ + n_]
            # A: items (row, 8 channels)
            it = np.arange(rows * nch)
            r, c = it // nch, it % nch * 8
            j, fl = r // p.ff, r % p.ff
            cc = c[:, None] + np.arange(8)[None, :]
            valid = ((j < tv) & (fl < fv))[:, None] & (cc < Co)
            lane = (f0 + fl)[:, None] * Co + cc
            yv = ys[np.where(valid, r[:, None] * Co + cc, rows * Co)]
            v = np.where(valid, yv * sf[np.where(valid, lane, 0)] + bfv[np.where(valid, lane, 0)],
                         0.0).astype(np.float32)
            assert not np.isnan(v).any(), "an item read an element no copy staged"
            a_tile = np.zeros((rows, p.kp), np.float32)
            a_tile[r[:, None], cc] = v
            gt = a_tile[:, n0: n0 + p.ct] if n0 + p.ct <= p.kp else np.pad(
                a_tile[:, n0:], ((0, 0), (0, n0 + p.ct - p.kp)))
            glu = (a_tile @ bs.T + bgt) / (1.0 + np.exp(-gt))
            # D: pooled output (jo, fo), its window in order wi = dt pf + df
            for jo in range(tv // pt):
                for fo in range(fv // pf):
                    s = np.zeros(p.ct, np.float32)
                    for dt in range(pt):
                        for df in range(pf):
                            rr = (jo * pt + dt) * p.ff + fo * pf + df
                            gv = glu[rr]
                            if bits_f is not None:
                                kb = st[rr * Co + n0: rr * Co + n0 + p.ct]
                                kb = np.pad(kb, (0, p.ct - kb.size), constant_values=-1)
                                gv = np.where(kb[: p.ct] < thresh, gv / keep, 0.0)
                            s = s + gv.astype(np.float32)
                    q = (b * To + t0 // pt + jo) * Fo + f0 // pf + fo
                    assert np.isnan(z[q, n0:n_hi]).all(), "a pooled output written twice"
                    z[q, n0:n_hi] = (s / (pt * pf))[: n_hi - n0]
    return z.reshape(B, To, Fo, Co)


@pytest.mark.parametrize("geom", FWD_GEOMS, ids=FWD_IDS)
def test_glu_fwd_plan_covers_pooled_outputs(geom):
    B, T, F, _, Co, pool = geom
    p = fc.glu_fwd_plan(B, T, F, Co, pool)
    pt, pf = pool
    W, To, Fo = pt * pf, T // pt, F // pf
    Q = B * To * Fo
    cg = p.ct // 4
    assert p.ct in (4, 8, 16, 32, 64, 128) and cg * (p.p // 4) == fc.GLU_FWD_THREADS
    assert p.smem == fc.glu_fwd_smem(Co, p.ct, p.p, p.ks, p.nq) <= fc.SMEM_HALF
    assert p.ks >= Co or (p.ks % 4 == 0 and p.ks >= 4)
    assert p.nq == p.p // W and p.n_tiles == -(-Q // p.nq) and 1 <= p.grid_x <= p.n_tiles
    assert p.grid_y == -(-Co // p.ct)
    # tile k, position p: pooled output k * nq + p // W, window element p % W
    k = np.arange(p.n_tiles)[:, None]
    pos = np.arange(p.p)[None, :]
    qq, wi = pos // W, pos % W
    q = k * p.nq + qq
    valid = (qq < p.nq) & (q < Q)
    _once(np.bincount((q * W + wi)[valid], minlength=Q * W), "(pooled output, window element)")
    # the positions' rows of y: distinct, inside the pooled extent
    b, to, fo = q // (To * Fo), q // Fo % To, q % Fo
    t, f = to * pt + wi // pf, fo * pf + wi % pf
    assert (t[valid] < To * pt).all() and (f[valid] < Fo * pf).all()
    m = ((b * T + t) * F + f)[valid]
    assert np.unique(m).size == m.size
    # product threads as csrc maps them; a thread's 4 positions pg*4 + i
    tid = np.arange(fc.GLU_FWD_THREADS)
    if cg % 8 == 0 and (p.p // 4) % 4 == 0:
        c, g = (tid // 32) % (cg // 8) * 8 + tid % 8, (tid // 32) // (cg // 8) * 4 + (tid % 32) // 8
    else:
        c, g = tid % cg, tid // cg
    owner = ((g * 4)[:, None, None] + np.arange(4)[:, None]) * p.ct \
        + (c * 4)[:, None, None] + np.arange(4)[None, :]
    _once(np.bincount(owner.ravel(), minlength=p.p * p.ct), "(position, channel)")
    chans = (np.arange(p.grid_y)[:, None] * p.ct + np.arange(p.ct)[None, :]).ravel()
    _once(np.bincount(chans[chans < Co], minlength=Co), "output channels")
    if 4 % W == 0:  # every window whole in one thread, the pool in registers
        first, last = (np.arange(p.nq) * W) // 4, (np.arange(p.nq) * W + W - 1) // 4
        assert np.array_equal(first, last)


@pytest.mark.parametrize("geom", _geoms_2024(60) + _geoms_2024(64) + WIDE[:2],
                         ids=IDS[:14] + FWD_IDS[len(GEOMS):len(GEOMS) + 2])
def test_fwd_plans_depend_on_the_shape_alone(geom):
    """Equal shapes give equal plans; the 2024 shapes at B = 60 and 64 and the
    Co = 256 block keep two blocks of each forward kernel on an SM."""
    B, T, F, Ci, Co, pool = geom
    a, b = fc.conv_fwd_plan(B, T, F, Ci, Co), fc.conv_fwd_plan(B, T, F, Ci, Co)
    assert a == b and all(isinstance(v, int) for v in a.ints())
    g1, g2 = fc.glu_fwd_plan(B, T, F, Co, pool), fc.glu_fwd_plan(B, T, F, Co, pool)
    assert g1 == g2 and all(isinstance(v, int) for v in g1.ints())
    assert 2 * (a.smem + 1024) <= fc.SMEM_SM and 2 * (g1.smem + 1024) <= fc.SMEM_SM
    if Co <= 128:
        assert g1.ks >= Co  # Wg staged once


@pytest.mark.parametrize("geom", FWD_GEOMS, ids=FWD_IDS)
def test_conv_fwd_plan_bf16_covers_outputs_and_lanes(geom):
    """The bf16 plan. conv_c1_bf16_kernel (Ci = 1 where it takes the
    shape): runs of frames that cover the B T rows once, one partial row
    per CTA; other Ci = 1 shapes the fp32 streaming plan
    (conv_c1_kernel<bf16>, kernel 3).
    conv3x3_bf16_fwd_kernel: the CTAs' runs cover the tiles once, in
    order, each tile's rows and each channel tile once, one partial row
    per CTA and lane, at most 2 SM_COUNT of them. Else the tensor-core
    kernel's warp tiles and ldmatrix rows (_walk_bf16_conv), every row and
    channel once, and each (clip, frame tile) one lane partial row, as the
    fp32 STATS epilogue writes them."""
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    if p.kernel == 2:
        fpc = p.rows_per_part
        r = np.arange(p.n_parts)[:, None] * fpc + np.arange(fpc)[None, :]
        _once(np.bincount(r[r < B * T], minlength=B * T), "frames")
        assert p.n_parts == -(-B * T // fpc) and p.smem == fc.c1_fwd_smem(fpc, F)
        return
    if Ci == 1:
        assert p.kernel == 3 and dataclasses.replace(p, kernel=0) == fc.conv_fwd_plan(
            B, T, F, Ci, Co)
        return
    if p.kernel == 1:
        nt = -(-T // p.tt)
        runs = [(k0, k1) for _, k0, k1 in _fwd16_walk(p, B, T)]
        assert runs[0][0] == 0 and runs[-1][1] == B * nt and p.n_parts <= 2 * fc.SM_COUNT
        assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(runs, runs[1:] + [(B * nt, 0)]))
        assert p.ff == F and p.tt * F == fc.FWD16_ROWS and Co % p.bn == 0
        _rows_once(B, T, F, p.tt, F, B * nt)
        assert fc.fwd16_smem(bool(p.res), Ci, F, p.tt, p.bn, fc.FWD16_STAGES) == p.smem
        assert p.smem <= fc.SMEM_LIMIT
        return
    _walk_bf16_conv(p, B, T, F, Ci, Co)
    nt, nf = -(-T // p.tt), -(-F // p.ff)
    _rows_once(B, T, F, p.tt, p.ff, B * nt * nf)
    chans = (np.arange(-(-Co // p.bn))[:, None] * p.bn + np.arange(p.bn)[None, :]).ravel()
    _once(np.bincount(chans[chans < Co], minlength=Co), "output channels")
    assert p.n_parts == B * nt
    i = np.arange(B * nt * nf)
    f = (i % nf * p.ff)[:, None] + np.arange(p.ff)[None, :]
    L = F * Co
    writes = ((i // nf)[:, None, None] * L + (f * Co)[:, :, None]
              + np.arange(Co)[None, None, :])[f < F]
    _once(np.bincount(writes.ravel(), minlength=p.n_parts * L), "lane partials")


def _swz_rows(row, c, cg):
    """csrc swz_rows: element offset of 16-byte chunk c of a row of cg chunks."""
    sw = (row & 7) if cg >= 8 else (row // (8 // cg)) & (cg - 1)
    return (row * cg + (c ^ sw)) * 8


def _swz_halo(row, key, c, cg):
    """csrc swz_halo: element offset of chunk c of halo row `row` (cg = 2 or
    4 chunks), XORed by the position's key."""
    sw = (key >> 1) & 3 if cg == 4 else (key >> 2) & 1
    return (row * cg + (c ^ sw)) * 8


def _fast_div(n, d):
    """csrc FastDiv: n * ceil(2^32 / d) >> 32."""
    return (np.asarray(n, dtype=np.uint64) * np.uint64(((1 << 32) + d - 1) // d)) >> np.uint64(32)


def _walk_dw_taps(p, B, T, F, Ci, Co):
    """conv_dw_taps_kernel's maps: the blocks' [9 taps x CS] x BNO tiles
    cover [9 Ci, Co] once; 8 warps as WK x WN x WR, NI n8 tiles each, cover a
    block tile once per row group, and the WR groups split the m16 steps;
    the chunks cover the row tiles; shared memory fits one block an SM."""
    K = 9 * Ci
    assert fc.dw_taps_takes(Ci, Co) and not p.stream
    cs, bno = fc.dw_taps_tile(Ci, Co)
    assert (p.dw_bko, p.dw_bno, p.dw_cs) == (9 * cs, bno, cs) and Ci % cs == 0
    wk, wn, ni, wr = fc.dw_taps_warps(cs, bno)
    assert (16 * wk, 8 * wn * ni, wk * wn * wr) == (cs, bno, 8) and ni % 2 == 0
    # accumulator e of (tap, ni) in warp (wk, wn): row tap cs + 16 wk + g + 8 (e // 2),
    # column (wn ni + ni) 8 + 2 tq + e % 2 of the block tile
    W_k, W_n, L_, Tap, N_i, E_ = np.meshgrid(np.arange(wk), np.arange(wn), np.arange(32),
                                             np.arange(9), np.arange(ni), np.arange(4),
                                             indexing="ij")
    rows = Tap * cs + 16 * W_k + L_ // 4 + 8 * (E_ // 2)
    cols = (W_n * ni + N_i) * 8 + 2 * (L_ % 4) + E_ % 2
    _once(np.bincount((rows * bno + cols).ravel(), minlength=9 * cs * bno), "block tile")
    # the grid's (channel group, column tile) blocks: k = tap Ci + kg cs + c
    kg, nt, tap, c = np.meshgrid(np.arange(Ci // cs), np.arange(-(-Co // bno)), np.arange(9),
                                 np.arange(cs), indexing="ij")
    k = (tap * Ci + kg * cs + c).ravel()
    _once(np.bincount(k, minlength=K) // -(-Co // bno), "depth")
    n = (np.arange(-(-Co // bno))[:, None] * bno + np.arange(bno)[None, :]).ravel()
    _once(np.bincount(n[n < Co], minlength=Co), "dW channels")
    R = p.dw_tt * p.dw_ff
    r16 = -(-R // 16)
    steps = np.concatenate([np.arange(g, r16, wr) for g in range(wr)])
    _once(np.bincount(steps, minlength=r16), "m16 steps of a stage")
    assert R <= fc.DWT_MAX_ROWS
    assert p.dw_smem == fc.dw_taps_smem(p.dw_tt, p.dw_ff, cs, bno) <= fc.DWT_SMEM
    assert fc.DWT_SMEM + 8 * fc.DWT_MAX_ROWS <= SMEM_LIMIT
    _rows_once(B, T, F, p.dw_tt, p.dw_ff, p.dw_tiles)
    tiles = np.concatenate([np.arange(c * p.dw_tpc, min(p.dw_tiles, (c + 1) * p.dw_tpc))
                            for c in range(p.chunks)])
    assert np.array_equal(tiles, np.arange(p.dw_tiles))
    blocks = Ci // cs * -(-Co // bno) * p.chunks
    assert blocks <= fc.SM_COUNT or p.chunks == 1


def _walk_dw_taps_fragments(p, B, T, F, Ci, Co, tiles, kg=0, nt=0):
    """conv_dw_taps_kernel's stages and ldmatrix reads, emulated for some row
    tiles of block (kg, nt): the copies put every halo position and dy_eff
    row through the swizzles once; each lane's ldmatrix address at every m16
    step and tap finds the x of its row's position + the tap's offset
    (zero past the clip) and the dy_eff of its row; the 8 rows of one
    matrix lie in 8 bank groups, across frame ends too."""
    def clip(b, C):  # one clip of x or dy_eff: distinct values per clip
        return np.random.default_rng([b, C]).integers(1, 1000, (T, F, C)).astype(np.float64)

    cs, bno = p.dw_cs, p.dw_bno
    wk_n, wn_n, ni_n, wr_n = fc.dw_taps_warps(cs, bno)
    cg, cgd, tt, ff = cs // 8, bno // 8, p.dw_tt, p.dw_ff
    W, WP = ff + 2, fc.dw_halo_pitch(ff, cs)
    R = tt * ff
    r16 = -(-R // 16) * 16
    cs0, n0 = kg * cs, nt * bno
    nf, ntt = -(-F // ff), -(-T // tt)
    lane = np.arange(32)
    for tile in tiles:
        b0, t0, f0 = tile // nf // ntt, (tile // nf) % ntt * tt, tile % nf * ff
        xc, dc = clip(b0, Ci), clip(b0, Co)
        sm = np.full(((tt + 2) * WP * cs + r16 * bno,), np.nan)
        hits = np.zeros(sm.shape, dtype=int)
        # the halo copies: pos = i / cg (a = pos / W by FastDiv), chunk c
        pos = np.arange((tt + 2) * W)
        a = _fast_div(pos, W).astype(int)
        assert np.array_equal(a, pos // W)
        b = pos - a * W
        t, f = t0 + a - 1, f0 + b - 1
        ok = (t >= 0) & (t < T) & (f >= 0) & (f < F)
        for c in range(cg):
            dst = _swz_halo(a * WP + b, a * ff + b, c, cg)
            val = np.where(ok[:, None], xc[np.clip(t, 0, T - 1), np.clip(f, 0, F - 1),
                                           cs0 + 8 * c: cs0 + 8 * c + 8], 0.0)
            idx = dst[:, None] + np.arange(8)
            sm[idx] = val
            np.add.at(hits, idx.ravel(), 1)
        # the dy_eff copies: row r (jt = r / FF by FastDiv), chunk c
        r = np.arange(r16)
        jt = _fast_div(r, ff).astype(int)
        assert np.array_equal(jt, r // ff)
        t, f = t0 + jt, f0 + r - jt * ff
        for c in range(cgd):
            ok = (r < R) & (t < T) & (f < F) & (n0 + 8 * c < Co)
            dst = (tt + 2) * WP * cs + _swz_rows(r, c, cgd)
            ch = min(n0 + 8 * c, Co - 8)
            val = np.where(ok[:, None], dc[np.clip(t, 0, T - 1), np.clip(f, 0, F - 1),
                                           ch: ch + 8], 0.0)
            idx = dst[:, None] + np.arange(8)
            sm[idx] = val
            np.add.at(hits, idx.ravel(), 1)
        assert hits.max() == 1, "a stage element written twice"
        # the row table: (halo row, key) of row r at the centre tap
        q = np.where(r < R, r, 0)
        rho, kap = (q // ff + 1) * WP + q % ff + 1, q + ff + 1
        arow = ((lane >> 4) << 3) + (lane & 7)
        brow = (((lane >> 3) & 1) << 3) + (lane & 7)
        for wk in range(wk_n):
            ach = 2 * wk + ((lane >> 3) & 1)
            for m0 in range(0, r16, 16):
                m = m0 + arow
                for tap in range(9):
                    dt, df = tap // 3 - 1, tap % 3 - 1
                    addr = _swz_halo(rho[m] + dt * WP + df, kap[m] + dt * ff + df, ach, cg)
                    got = sm[addr[:, None] + np.arange(8)]
                    jt, jf = m // ff, m % ff
                    t, f = t0 + jt + dt, f0 + jf + df
                    ok = (t >= 0) & (t < T) & (f >= 0) & (f < F)
                    want = np.where(ok[:, None], xc[np.clip(t, 0, T - 1), np.clip(f, 0, F - 1)][
                        np.arange(32)[:, None], cs0 + 8 * ach[:, None] + np.arange(8)], 0.0)
                    real = m < R
                    assert np.array_equal(got[real], want[real]), (tile, wk, m0, tap)
                    assert not np.isnan(got).any()
                    groups = (2 * addr // 16) % 8
                    for mat in range(4):
                        lm = slice(8 * mat, 8 * mat + 8)
                        if real[lm].all():
                            assert len(set(groups[lm])) == 8, (tile, m0, tap, mat)
        for wn in range(wn_n):
            for m0 in range(0, r16, 16):
                m = m0 + brow
                for ni in range(0, ni_n, 2):
                    ch = wn * ni_n + (lane >> 4) + ni
                    addr = (tt + 2) * WP * cs + _swz_rows(m, ch, cgd)
                    got = sm[addr[:, None] + np.arange(8)]
                    jt, jf = m // ff, m % ff
                    t, f = t0 + jt, f0 + jf
                    co = n0 + 8 * ch[:, None] + np.arange(8)
                    ok = ((m < R) & (t < T) & (f < F))[:, None] & (co < Co)
                    want = np.where(ok, dc[np.clip(t, 0, T - 1), np.clip(f, 0, F - 1)][
                        np.arange(32)[:, None], np.clip(co, 0, Co - 1)], 0.0)
                    assert np.array_equal(got, want), (tile, wn, m0, ni)
                    groups = (2 * addr // 16) % 8
                    for mat in range(4):
                        assert len(set(groups[8 * mat: 8 * mat + 8])) == 8


def _walk_dw_c1_bf16(p, B, T, F, Co):
    """conv_dw_c1_bf16_kernel's maps: blocks of dw_tt whole frames cover the
    rows once; the threads' row slots, stepped without a division, find each
    row of a block once with its frame, frequency and time; the x tile and
    the warps' sums fit in shared memory for two blocks an SM."""
    NF = B * T
    fpb = p.dw_tt
    assert p.stream and (p.dw_ff, p.rows_per_block) == (F, fpb * F)
    assert (p.chunks - 1) * fpb < NF <= p.chunks * fpb and p.chunks <= max(
        fc.C1_BF16_BLOCKS, -(-NF // fpb))
    assert p.dw_smem == fc.c1_bf16_smem(fpb, F, Co) <= fc.SMEM_HALF
    gp = fc.c1_bf16_groups(Co)
    assert gp <= 16 and 8 * gp >= Co and gp & (gp - 1) == 0
    rs_n = 256 // gp
    seen = np.zeros(NF * F, dtype=int)
    for blk in range(p.chunks):
        fr0 = blk * fpb
        nfr = min(NF, fr0 + fpb) - fr0
        dj, dfr = rs_n // F, rs_n % F
        djt = dj % T
        for rs in range(rs_n):
            j, f = rs // F, rs % F
            t = (fr0 + j) % T
            for i in range(rs, nfr * F, rs_n):
                assert (j, f, t) == (i // F, i % F, (fr0 + i // F) % T)
                seen[(fr0 + j) * F + f] += 1
                f, j, t = f + dfr, j + dj, t + djt
                if f >= F:
                    f, j, t = f - F, j + 1, t + 1
                if t >= T:
                    t -= T
    _once(seen, "rows of the Ci = 1 kernel")


@pytest.mark.parametrize("geom", GEOMS, ids=IDS)
def test_conv_bwd_plan_bf16_covers_dx_dw_and_dbias(geom):
    """The bf16 backward plan: dx on the tensor-core conv (its warp tiles and
    ldmatrix rows, _walk_bf16_conv, with Co channels in and Ci out; every
    row and dx channel once); dW on the tensor cores where dw_taps_takes
    (_walk_dw_taps), at Ci = 1 in whole frames (_walk_dw_c1_bf16), else on
    the fp32 plan's tiles and chunks with bf16 stages; the dy_eff pass's blocks of eff_rows rows cover every row once,
    and its threads (8 channels each, EFF row slots) every channel."""
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_bwd_plan(B, T, F, Ci, Co, bf16=True)
    q = fc.conv_bwd_plan(B, T, F, Ci, Co)
    assert (q.dx_vec, q.eff_blocks, q.eff_rows) == (0, 0, 0)
    dx = fc.ConvFwdPlan(0, p.dx_vec, p.dx_bn, p.dx_tt, p.dx_ff, 0, p.dx_smem, 0, 0)
    _walk_bf16_conv(dx, B, T, F, Co, Ci)
    _rows_once(B, T, F, p.dx_tt, p.dx_ff, B * -(-T // p.dx_tt) * -(-F // p.dx_ff))
    chans = (np.arange(-(-Ci // p.dx_bn))[:, None] * p.dx_bn + np.arange(p.dx_bn)).ravel()
    _once(np.bincount(chans[chans < Ci], minlength=Ci), "dx channels")
    assert (p.stream, p.vec) == (q.stream, q.vec)
    if p.dw_cs:  # the tensor-core dW
        _walk_dw_taps(p, B, T, F, Ci, Co)
    elif p.stream:  # the bf16 streaming kernel at Ci = 1
        _walk_dw_c1_bf16(p, B, T, F, Co)
    else:  # the CUDA-core kernel on the fp32 tiles
        same = ("dw_bko", "dw_bno", "dw_tt", "dw_ff", "dw_tiles", "dw_tpc", "chunks",
                "rows_per_block")
        assert all(getattr(p, k) == getattr(q, k) for k in same)
        assert not fc.dw_taps_takes(Ci, Co)
        assert p.dw_smem == fc.dw_smem(p.dw_tt, p.dw_ff, Ci, p.dw_bko, p.dw_bno, 2)
        assert p.dw_smem <= q.dw_smem <= fc.SMEM_HALF
    M = B * T * F
    assert (p.eff_blocks - 1) * p.eff_rows < M <= p.eff_blocks * p.eff_rows
    assert p.eff_blocks <= fc.DW_BLOCKS
    groups = -(-Co // 8)
    assert 256 // groups >= 1
    c = (np.arange(groups)[:, None] * 8 + np.arange(8)[None, :]).ravel()
    _once(np.bincount(c[c < Co], minlength=Co), "dy_eff channels")


# the bf16 GLU's tiles beside FWD_GEOMS (the ring kernel): odd T, F % pf != 0, Co = 8, 24,
# 40, 136 and 256, F * Co not a multiple of 8 (element loads: Co 5, 6, 70),
# pools (1, 1), (1, 2), (2, 1) and (2, 2), one frequency, frames too wide
# for shared memory (F = 300 at 128 channels: tiles of part of a frame)
GLU_BF16_EXTRA = [(2, 13, 8, 16, 8, (2, 2)), (2, 9, 7, 16, 24, (1, 2)),
                  (3, 11, 5, 16, 40, (2, 1)), (2, 7, 6, 16, 136, (2, 2)),
                  (1, 5, 4, 16, 256, (1, 1)), (2, 9, 5, 16, 5, (1, 2)),
                  (2, 10, 3, 16, 6, (2, 1)), (1, 3, 1, 16, 70, (1, 1)),
                  (1, 300, 2, 16, 12, (1, 1)), (1, 4, 300, 16, 128, (2, 2)),
                  (2, 19, 9, 16, 20, (2, 2)), (1, 15, 11, 16, 48, (3, 2)),
                  # the register kernel: odd T (a last frame pair of one frame
                  # at pt = 1), F % pf != 0, a ragged frequency tile, pools
                  # (1, 1), (1, 2), (2, 1) and (2, 2), Co = 16, 32, 64, 128
                  (2, 7, 16, 16, 16, (2, 2)), (2, 9, 24, 16, 32, (1, 2)),
                  (1, 5, 16, 16, 64, (2, 1)), (2, 6, 41, 16, 16, (1, 2)),
                  (1, 4, 8, 16, 32, (1, 1)), (2, 5, 32, 16, 64, (1, 2)),
                  (3, 313, 64, 16, 32, (2, 2)), (2, 4, 8, 16, 128, (1, 1)),
                  # ... and its consecutive rows (pt = 1, Fo*pf = 1, 2, 4)
                  (2, 5, 4, 16, 128, (1, 2)), (1, 9, 2, 16, 128, (1, 2)),
                  (1, 6, 3, 16, 64, (1, 2)), (2, 7, 1, 16, 16, (1, 1))]
GLU_BF16_GEOMS = FWD_GEOMS + GLU_BF16_EXTRA
GLU_BF16_IDS = FWD_IDS + [f"B{g[0]}-T{g[1]}-F{g[2]}-Co{g[4]}-pool{g[5][0]}x{g[5][1]}"
                          for g in GLU_BF16_EXTRA]


@pytest.mark.parametrize("geom", GLU_BF16_GEOMS, ids=GLU_BF16_IDS)
def test_glu_fwd_plan_bf16_covers_pooled_outputs(geom):
    """The register kernel's plan where `glu_frag_takes` the shape (and its
    shared memory fits), else the ring kernel's; either walked through its
    index maps."""
    B, T, F, _, Co, pool = geom
    p = fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    assert p.frag or not fc.glu_frag_takes(T, F, Co, pool) or fc._glu_frag_plan(
        B, T, F, Co, pool) is None
    (_walk_glu_frag if p.frag else _walk_glu_ring)(p, B, T, F, Co, pool)


# small enough for the emulation (and for the plain version on the CPU)
EMU_GEOMS = [g for g in GLU_BF16_GEOMS if g[0] * g[1] * g[2] * g[4] <= 400_000]


@pytest.mark.parametrize("geom", EMU_GEOMS,
                         ids=[i for g, i in zip(GLU_BF16_GEOMS, GLU_BF16_IDS) if g in EMU_GEOMS])
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_bf16_emulation_matches_plain(geom, keep):
    """The bf16 kernel's tile walk in numpy (_emulate_glu_frag, lane by lane,
    or _emulate_glu_ring: the copies, the A items, the pool's windows in
    kernel order) against glu_drop_pool_plain in fp32: an index fault of the
    plan or the kernel's maps shows here before a card runs it."""
    import torch

    B, T, F, _, Co, pool = geom
    rng = np.random.default_rng(7)
    y = rng.standard_normal((B, T, F, Co)).astype(np.float32)
    sf = (1 + 0.1 * rng.standard_normal(F * Co)).astype(np.float32)
    bfv = (0.1 * rng.standard_normal(F * Co)).astype(np.float32)
    wg = (rng.standard_normal((Co, Co)) / np.sqrt(Co)).astype(np.float32)
    bg = (0.1 * rng.standard_normal(Co)).astype(np.float32)
    bits = None if keep is None else rng.integers(0, 256, (B, T, F * Co), dtype=np.uint8)
    kp = 1.0 if keep is None else keep
    p = fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    got = (_emulate_glu_frag if p.frag else _emulate_glu_ring)(p, y, sf, bfv, wg, bg, bits,
                                                                pool, kp)
    want = fc.glu_drop_pool_plain(
        torch.from_numpy(y), torch.from_numpy(sf), torch.from_numpy(bfv), torch.from_numpy(wg),
        torch.from_numpy(bg), None if bits is None else torch.from_numpy(bits), pool=pool,
        keep_prob=kp).numpy()
    assert got.shape == want.shape and not np.isnan(got).any()
    assert float(np.abs(got - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("geom", _geoms_2024(60) + _geoms_2024(64) + WIDE[:2],
                         ids=IDS[:14] + FWD_IDS[len(GEOMS):len(GEOMS) + 2])
def test_fwd_plans_bf16_depend_on_the_shape_alone(geom):
    """Equal shapes give equal bf16 plans; the 2024 shapes fit the bf16
    conv's CTAs an SM in shared memory (two of conv_c1_bf16_kernel, and of
    conv3x3_bf16_fwd_kernel where registers and shared memory allow, else
    one), and take the GLU's register kernel with >= 32
    KB of copies an SM in flight behind the tiles its warps work on (two
    blocks an SM at Co <= 64, one at Co = 128); the 256-channel block takes
    the ring kernel at two blocks an SM."""
    B, T, F, Ci, Co, pool = geom
    a = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    g = fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    assert a == fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert g == fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    assert all(isinstance(v, int) for v in a.ints() + g.ints())
    per_sm = 2 if a.kernel == 2 or (a.smem <= fc.SMEM_HALF
                                    and fc.fwd16_per_sm(a.bn) == 2) else 1
    assert per_sm * (a.smem + 1024) <= fc.SMEM_SM
    assert bool(g.frag) == (Co <= 128) and g.vec == 1
    assert g.per_sm == (1 if g.frag and Co == 128 else 2)
    assert g.per_sm * (g.smem + 1024) <= fc.SMEM_SM
    if g.frag:
        lay = fc.glu_frag_layout(Co, F // pool[1] * pool[1], g.tt, g.ff, g.stages)
        assert g.per_sm * fc.GLU_FRAG_WARPS * (g.stages - 1) * lay["stage"] >= 32 * 1024


# the bf16 dW kernels at the 2024 blocks (B=60) and at odd shapes: the
# tensor-core kernel at Ci 16, 32, 48, 64, 128 and 256 (CS 16 and 32), Co 8
# to 256 (one or two channel tiles, a ragged one, WR 1 to 8 row groups), F 1
# to 130 (frames shorter than the 8 rows of an ldmatrix, two frequency
# tiles), T not a multiple of the row tile; the Ci = 1 kernel at Co 8 to 128
# (ragged 8-channel groups, Co % 8 != 0), F 1 to 130 (F % 8 != 0), a block
# past B * T
DW_BF16_GEOMS = [g[:5] for g in _geoms_2024(60)] + [
    (2, 19, 3, 16, 8), (3, 37, 1, 32, 16), (2, 23, 5, 48, 24), (1, 50, 7, 64, 40),
    (2, 9, 64, 128, 96), (2, 13, 6, 256, 256), (4, 11, 2, 48, 136), (1, 7, 130, 16, 64),
    (2, 5, 9, 32, 200), (1, 3, 1, 64, 128),
    (1, 13, 16, 1, 8), (1, 5, 130, 1, 24), (2, 8, 8, 1, 128), (3, 7, 1, 1, 40), (2, 7, 6, 1, 12),
    (2, 9, 5, 1, 16), (1, 1, 1, 1, 8), (7, 300, 3, 1, 16)]
DW_BF16_IDS = [f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}" for g in DW_BF16_GEOMS]


@pytest.mark.parametrize("geom", DW_BF16_GEOMS, ids=DW_BF16_IDS)
def test_dw_bf16_plans_cover_dw(geom):
    """The bf16 dW plans: the tensor-core kernel's blocks, warps, m16 steps,
    chunks and shared memory (_walk_dw_taps), or the Ci = 1 kernel's
    frames and row slots (_walk_dw_c1_bf16); equal shapes, equal plans."""
    B, T, F, Ci, Co = geom
    p = fc.conv_bwd_plan(B, T, F, Ci, Co, bf16=True)
    assert p == fc.conv_bwd_plan(B, T, F, Ci, Co, bf16=True)
    assert all(isinstance(v, int) for v in p.ints())
    if Ci == 1:
        _walk_dw_c1_bf16(p, B, T, F, Co)
    else:
        assert p.dw_cs and fc.dw_taps_takes(Ci, Co)
        _walk_dw_taps(p, B, T, F, Ci, Co)


@pytest.mark.parametrize("geom", [g for g in DW_BF16_GEOMS if g[3] > 1],
                         ids=[i for g, i in zip(DW_BF16_GEOMS, DW_BF16_IDS) if g[3] > 1])
def test_dw_taps_stages_and_fragments(geom):
    """conv_dw_taps_kernel's copies and ldmatrix reads, emulated for the first,
    a middle and the last row tile of the first and the last block of a
    chunk (_walk_dw_taps_fragments)."""
    B, T, F, Ci, Co = geom
    p = fc.conv_bwd_plan(B, T, F, Ci, Co, bf16=True)
    tiles = sorted({0, p.dw_tiles // 2, p.dw_tiles - 1})
    _walk_dw_taps_fragments(p, B, T, F, Ci, Co, tiles)
    _walk_dw_taps_fragments(p, B, T, F, Ci, Co, tiles[-1:], kg=Ci // p.dw_cs - 1,
                            nt=-(-Co // p.dw_bno) - 1)


def test_fast_div_is_exact():
    """csrc FastDiv, n * ceil(2^32 / d) >> 32, is n // d wherever the dW
    kernel takes it: n < 2^16 (halo positions, stage rows), d < 2^16."""
    n = np.arange(1 << 16)
    for d in list(range(1, 1100)) + [4097, 65535]:
        assert np.array_equal(_fast_div(n, d).astype(np.int64), n // d), d



def test_dw_taps_takes_every_shape_of_the_first_design():
    """Every (Ci, Co) that the first tensor-core dW took (Ci 16, 32 or a
    multiple of 64; Co % 8 == 0) goes to conv_dw_taps_kernel, and so do Ci
    = 48, 80, ...; other shapes keep the CUDA-core dW from bf16 stages."""
    for ci in range(2, 400):
        for co in range(1, 300):
            first = co % 8 == 0 and (ci in (16, 32) or ci % 64 == 0)
            assert fc.dw_taps_takes(ci, co) == (co % 8 == 0 and ci % 16 == 0)
            assert fc.dw_taps_takes(ci, co) or not first
    for ci, co in [(16, 8), (48, 24), (80, 8), (5, 6), (24, 40), (16, 20)]:
        p = fc.conv_bwd_plan(2, 9, 7, ci, co, bf16=True)
        assert bool(p.dw_cs) == fc.dw_taps_takes(ci, co)


# glu_bwd_frag_kernel (the bf16 GLU backward's phases A and B on mma.sync),
# emulated lane by lane: (B, T, F, Co, pool) at Co = 16, 32, 64 and 128, a
# ragged last tile, odd T, F % pf != 0, pools 1 x 1, 1 x 2, 2 x 2 and 3 x 4
BWD_FRAG_GEOMS = [(2, 9, 8, 16, (2, 2)), (1, 7, 6, 32, (2, 2)), (2, 5, 4, 64, (1, 2)),
                  (1, 11, 3, 128, (1, 2)), (2, 6, 16, 128, (2, 2)), (3, 5, 7, 16, (3, 4)),
                  (1, 3, 5, 32, (1, 1)), (1, 40, 16, 32, (2, 2))]
BWD_FRAG_IDS = [f"B{g[0]}-T{g[1]}-F{g[2]}-Co{g[3]}-pool{g[4][0]}x{g[4][1]}"
                for g in BWD_FRAG_GEOMS]


def _bf16(x):
    """x rounded to bf16 (to nearest, ties to even), back in fp32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


LANES = np.arange(32)


def _emulate_glu_bwd_frag(p, y, sf, bfv, wg, bg, g, bits, pool, keep, map_lanes=LANES,
                          store_lanes=LANES):
    """yt, dt and t2 [M, Co] of glu_bwd_frag_kernel's phases A and B from its
    plan, lane by lane: each tile's stages from their 16-byte copies (y in
    rows of Co + 8 bf16, the bits in rows of Co + 16 bytes, zeros past the
    last row); per unit (warp w: w, w + 16) and k16 step each lane's A
    fragment registers from ldmatrix's row addresses (matrix r's row named
    by lane 8 r + gq), BN(y) per element from scale_f and bias_f at its
    row's frequency (a multiply, then an add, in fp32), rounded to bf16 for
    the product, the unit's own k16 steps kept as the gates; the B fragments
    by ldmatrix from Wg^T [n][k] (bf16 rows of Co + 8) the same way; lin
    from the fragments in the m16n8k16 layout; gu from pooled g and the
    staged bits; then the store of each accumulator into [c][p] (stride p +
    4), each (position, channel) once, each store's 32 words at most 2 to a
    bank. map_lanes and store_lanes stand for the lane
    ids from which csrc computes its ldmatrix row offsets (a_off, b_off) and
    its stores' (gq, tq) (a test swaps their bits)."""
    B, T, F, Co = y.shape
    pt, pf = pool
    To, Fo = T // pt, F // pf
    ni_, kt, yp, P, PS = Co // 8, Co // 16, Co + 8, p.p, p.p + 4
    wn, mu = fc.glu_bwd_frag_units(Co)
    ng = ni_ // wn
    M = B * T * F
    assert p.frag == 1 and p.cp == Co and P % 16 == 0
    assert P // 16 * ng <= mu * fc.GLU_THREADS // 32  # every unit of a tile has a warp
    bp = Co + 16
    yf = _bf16(y).reshape(-1)
    gf = _bf16(g).reshape(-1)
    bitsf = None if bits is None else bits.reshape(-1)
    thresh = fc.keep_threshold(keep)
    gq, tq = LANES >> 2, LANES & 3  # fragment coordinates of each lane
    a_off = (map_lanes & 15) * yp + (map_lanes >> 4) * 8
    b_off = ((map_lanes >> 4) * 8 + (map_lanes & 7)) * yp + ((map_lanes >> 3) & 1) * 8
    sq, st = store_lanes >> 2, store_lanes & 3
    wt = np.zeros((Co, yp), np.float32)  # Wg^T [n][k] in bf16
    wt[:, :Co] = _bf16(wg).T
    wt = wt.reshape(-1)
    out = {k: np.full((M, Co), np.nan, np.float32) for k in ("yt", "dt", "t2")}
    for tile in range(p.n_tiles):
        m0 = tile * P
        stage = np.full(P * yp, np.nan, np.float32)
        q = np.arange(P * ni_)
        r, c = q // ni_, q % ni_ * 8
        assert np.unique(r * yp + c).size == q.size  # every 16-byte chunk once
        for e in range(8):
            src = (m0 + r) * Co + c + e
            stage[r * yp + c + e] = np.where(m0 + r < M, yf[np.minimum(src, yf.size - 1)], 0.0)
        bstage = np.full(P * bp, -1, np.int64)
        if bitsf is not None:
            q = np.arange(P * (ni_ // 2))
            r, c = q // (ni_ // 2), q % (ni_ // 2) * 16
            assert np.unique(r * bp + c).size == q.size and (c + 16 <= Co).all()
            for e in range(16):
                src = np.minimum((m0 + r) * Co + c + e, bitsf.size - 1)
                bstage[r * bp + c + e] = np.where(m0 + r < M, bitsf[src], 0)
        buf = {k: np.full(Co * PS, np.nan, np.float32) for k in out}
        for u in range(P // 16 * ng):
            mt, n0 = u // ng, (u % ng) * wn * 8
            m = m0 + 16 * mt + gq[None, :] + 8 * np.arange(2)[:, None]  # [h][lane]
            ok = m < M
            mm = np.where(ok, m, 0)
            f, t, b = mm % F, mm // F % T, mm // F // T
            pooled = ok & (t < To * pt) & (f < Fo * pf)
            gi = np.where(pooled, ((b * To + t // pt) * Fo + f // pf) * Co, 0)
            amat = np.full((16, Co), np.nan, np.float64)
            gv = np.full((wn // 2, 8, 32), np.nan, np.float32)
            for ks in range(kt):
                v = np.zeros((8, 32), np.float32)
                for rr in range(4):  # register rr from matrix rr: rows named by lanes 8 rr + gq
                    src_lane = 8 * rr + gq
                    addr = 16 * mt * yp + ks * 16 + a_off[src_lane] + 2 * tq
                    lane_l = f[rr & 1] * Co + ks * 16 + 8 * (rr >> 1) + 2 * tq
                    for h in range(2):
                        val = (stage[addr + h] * sf[lane_l + h]).astype(np.float32) \
                            + bfv[lane_l + h]
                        v[2 * rr + h] = val
                        row = gq + 8 * (rr & 1)
                        k = ks * 16 + 8 * (rr >> 1) + 2 * tq + h
                        assert np.isnan(amat[row, k]).all(), "an A element loaded twice"
                        amat[row, k] = _bf16(val)
                if ks // (wn // 2) == n0 // (8 * wn):
                    gv[ks % (wn // 2)] = v
            bmat = np.full((Co, Co), np.nan, np.float64)  # [k][n], the unit's columns
            for ks in range(kt):
                for n2 in range(0, wn, 2):
                    for rr in range(4):  # register rr from matrix rr: rows named by lanes 8 rr + gq
                        addr = (n0 + n2 * 8) * yp + ks * 16 + b_off[8 * rr + gq] + 2 * tq
                        for h in range(2):
                            k = ks * 16 + 8 * (rr & 1) + 2 * tq + h
                            n = n0 + (n2 + (rr >> 1)) * 8 + gq
                            assert np.isnan(bmat[k, n]).all(), "a B element loaded twice"
                            bmat[k, n] = wt[addr + h]
            cmat = amat @ bmat
            for ni in range(wn):
                for e in range(4):
                    h = e >> 1
                    c = n0 + ni * 8 + 2 * tq + (e & 1)
                    gate = gv[ni >> 1, 4 * (ni & 1) + e]
                    assert not np.isnan(gate).any(), "a gate of another unit"
                    s = 1.0 / (1.0 + np.exp(-gate.astype(np.float64)))
                    lin = cmat[gq + 8 * h, c] + _bf16(bg)[c]
                    gj = np.where(pooled[h], gf[gi[h] + c] / (pt * pf), 0.0)
                    if bitsf is not None:
                        kb = bstage[(16 * mt + gq + 8 * h) * bp + c]
                        assert (kb >= 0).all(), "bits not staged"
                        gj = np.where(kb < thresh, gj / keep, 0.0)
                    i = (n0 + ni * 8 + 2 * st + (e & 1)) * PS + 16 * mt + sq + 8 * h  # one store
                    words = np.unique(i)
                    assert words.size == 32, "two lanes store one word"
                    assert np.bincount(words % 32, minlength=32).max() <= 2, "bank conflict"
                    for k_, val in (("yt", np.where(ok[h], _bf16(gate), 0.0)),
                                    ("dt", gj * s), ("t2", gj * lin * s * (1 - s))):
                        assert np.isnan(buf[k_][i]).all(), "a (position, channel) written twice"
                        buf[k_][i] = val
        rows = np.arange(P)
        live = m0 + rows < M
        for k_ in out:
            tb = buf[k_].reshape(Co, PS)[:, :P].T  # [p][c]
            assert not np.isnan(tb).any(), "a (position, channel) of the tile not written"
            out[k_][m0 + rows[live]] = tb[live]
    return out


def _bwd_frag_inputs(B, T, F, Co, pool, keep, seed=11):
    rng = np.random.default_rng(seed)
    pt, pf = pool
    y = _bf16(rng.standard_normal((B, T, F, Co)))
    sf = (1 + 0.1 * rng.standard_normal(F * Co)).astype(np.float32)
    bfv = (0.1 * rng.standard_normal(F * Co)).astype(np.float32)
    wg = _bf16(rng.standard_normal((Co, Co)) / np.sqrt(Co))
    bg = _bf16(0.1 * rng.standard_normal(Co))
    g = _bf16(rng.standard_normal((B, T // pt, F // pf, Co)))
    bits = None if keep is None else rng.integers(0, 256, (B, T, F * Co), dtype=np.uint8)
    return y, sf, bfv, wg, bg, g, bits


@pytest.mark.parametrize("geom", BWD_FRAG_GEOMS, ids=BWD_FRAG_IDS)
@pytest.mark.parametrize("keep", [None, 0.5])
def test_glu_bwd_frag_emulation_matches_plain(geom, keep):
    """glu_bwd_frag_kernel's copies, fragments and scatter emulated in numpy:
    yt is bf16(BN(y)) bit for bit (0 past the last row), dt and t2 are dlin
    and gu lin s (1 - s) within fp32 rounding; and the unchanged phases C, D
    and E run on them give glu_drop_pool_bwd_plain's bf16 results within one
    bf16 step (dy, dwg, dbg) and 1e-5 (dscale_f, dbias_f)."""
    import torch

    B, T, F, Co, pool = geom
    kp = 1.0 if keep is None else keep
    args = _bwd_frag_inputs(B, T, F, Co, pool, keep)
    p = fc.glu_bwd_plan(B, T, F, Co, bf16=True)
    _check_bwd_frag(_emulate_glu_bwd_frag(p, *args, pool, kp), *args, pool, kp)


def _check_bwd_frag(got, y, sf, bfv, wg, bg, g, bits, pool, kp):
    import torch

    B, T, F, Co = y.shape
    pt, pf = pool
    # the phases' values from their definitions (pallas_cnn.py:312-350)
    sc, bi = sf.reshape(F, Co), bfv.reshape(F, Co)
    ybn = (y * sc).astype(np.float32) + bi
    lin = _bf16(ybn).astype(np.float64) @ wg + bg
    s = 1.0 / (1.0 + np.exp(-ybn.astype(np.float64)))
    gu = np.zeros_like(y)
    gu[:, : T // pt * pt, : F // pf * pf] = np.repeat(np.repeat(g, pt, 1), pf, 2) / (pt * pf)
    if bits is not None:
        gu = np.where(bits.reshape(y.shape) < fc.keep_threshold(kp), gu / kp, 0.0)
    M = B * T * F
    assert not any(np.isnan(v).any() for v in got.values())
    np.testing.assert_array_equal(got["yt"], _bf16(ybn).reshape(M, Co))
    np.testing.assert_allclose(got["dt"], (gu * s).reshape(M, Co), rtol=1e-6, atol=1e-7)
    scale = float(np.abs(gu).max() * np.abs(lin).max()) + 1e-30
    np.testing.assert_allclose(got["t2"], (gu * lin * s * (1 - s)).reshape(M, Co), rtol=0,
                               atol=1e-6 * scale)
    # C, D and E as the kernel runs them, from the emulated yt, dt, t2
    yt, dt, t2 = (got[k].astype(np.float64) for k in ("yt", "dt", "t2"))
    dybn = dt @ wg.T.astype(np.float64) + t2
    yr = y.reshape(M, Co).astype(np.float64)
    dy = (dybn.reshape(B, T, F, Co) * sc).reshape(M, Co)
    dscale = (dybn * yr).reshape(-1, F * Co).sum(0)
    dbias = dybn.reshape(-1, F * Co).sum(0)
    dwg, dbg = yt.T @ dt, dt.sum(0)
    T_ = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    want = fc.glu_drop_pool_bwd_plain(
        T_(y), torch.from_numpy(sf), torch.from_numpy(bfv), T_(wg), T_(bg),
        None if bits is None else torch.from_numpy(bits), T_(g), pool=pool, keep_prob=kp)
    for name, a, w in (("dy", dy, want[0]), ("dwg", dwg, want[3]), ("dbg", dbg, want[4])):
        w = w.float().numpy().reshape(a.shape)
        lim = 2.0 ** -7 * np.abs(w) + 1e-5 * float(np.abs(w).max())
        assert (np.abs(a - w) <= lim).mean() >= 0.99, name
        assert float(np.abs(a - w).max()) <= 2.0 ** -6 * float(np.abs(w).max()) + 1e-6, name
    for name, a, w in (("dscale_f", dscale, want[1]), ("dbias_f", dbias, want[2])):
        w = w.numpy().astype(np.float64)
        assert float(np.abs(a - w).max()) <= 1e-5 * max(1.0, float(np.abs(w).max())), name


def _swap_bits(lanes, i, j):
    bi, bj = (lanes >> i) & 1, (lanes >> j) & 1
    return lanes & ~((1 << i) | (1 << j)) | bi << j | bj << i


@pytest.mark.parametrize("where", ["ldmatrix", "store"])
@pytest.mark.parametrize("swap", [(0, 1), (2, 3), (3, 4), (1, 4), (0, 4)],
                         ids=lambda s: f"bits{s[0]}-{s[1]}")
def test_glu_bwd_frag_emulation_fails_a_swapped_lane_bit(where, swap):
    """The emulation test fails where csrc would compute a lane's ldmatrix
    row offsets, or its stores' (gq, tq), from a lane id with two bits
    swapped: the fault shows on the CPU, before a card runs it."""
    B, T, F, Co, pool = 1, 7, 6, 32, (2, 2)
    args = _bwd_frag_inputs(B, T, F, Co, pool, 0.5)
    p = fc.glu_bwd_plan(B, T, F, Co, bf16=True)
    bad = _swap_bits(LANES, *swap)
    kw = {"map_lanes" if where == "ldmatrix" else "store_lanes": bad}
    with pytest.raises(AssertionError):
        _check_bwd_frag(_emulate_glu_bwd_frag(p, *args, pool, 0.5, **kw), *args, pool, 0.5)


@pytest.mark.parametrize("geom", _geoms_2024(60) + _geoms_2024(64) + BWD_GEOMS, ids=IDS)
def test_glu_bwd_plan_bf16_takes_the_frag_kernel(geom):
    """The bf16 GLU backward takes glu_bwd_frag_kernel at Co = 16, 32, 64 and
    128 (every 2024 block, B 60 and 64): the fp32 plan's threads and tiles
    (so test_glu_bwd_plan_covers_positions walks it too), every warp's
    units filled, the dWg groups' sums inside yt, dt and t2, 16-byte parts
    (cp.async destinations and ldmatrix rows), shared memory within the
    card's limit and the lane sums on chip at the 2024 shapes. Other widths
    keep glu_bwd_kernel's plan as it is."""
    B, T, F, _, Co, _ = geom
    p, q = fc.glu_bwd_plan(B, T, F, Co, bf16=True), fc.glu_bwd_plan(B, T, F, Co)
    assert q.frag == 0 and fc.glu_bwd_plan(B, T, F, Co, bf16=True) is p
    if not fc.glu_bwd_frag_takes(Co):
        assert p == q
        return
    assert p.frag == 1 and p.cp == Co and (p.ks, p.passes) == (0, 1)
    assert (p.cp, p.ct, p.pg) == (q.cp, q.ct, q.pg)
    if q.lanes:
        assert (p.p, p.n_tiles, p.tpb, p.n_blocks) == (q.p, q.n_tiles, q.tpb, q.n_blocks)
    wn, mu = fc.glu_bwd_frag_units(Co)
    assert wn % 2 == 0 and (Co // 8) % wn == 0
    assert p.p % 16 == 0 and p.p % (4 * p.pg) == 0
    assert p.p // 16 * (Co // 8 // wn) == mu * fc.GLU_THREADS // 32  # every warp mu units
    assert p.pg * Co * Co <= 3 * Co * (p.p + 4)  # the dWg groups inside yt, dt and t2
    assert p.smem == fc.glu_bwd_frag_smem(F, Co, p.p, p.lanes) <= SMEM_LIMIT
    # Wg^T, yt / dt / t2, the y stages and the bits stages, and their rows
    parts = [2 * Co * (Co + 8), 4 * Co * (p.p + 4), 2 * p.p * (Co + 8), p.p * (Co + 16),
             2 * (Co + 8), Co + 16]
    assert all(x % 16 == 0 for x in parts)
    if geom in _geoms_2024(60) + _geoms_2024(64):
        assert p.lanes == 1 and p.n_blocks <= fc.SM_COUNT
    # ldmatrix's 8 rows of the stage and of Bs (pitch Co + 8) in 8 bank groups
    assert len({(r * (Co + 8) * 2 // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("Co", [8, 24, 40, 48, 70, 96, 136, 192, 256])
def test_glu_bwd_plan_bf16_other_widths_keep_the_cuda_core_kernel(Co):
    """Widths other than 16, 32, 64 and 128 (odd, wide) keep glu_bwd_kernel:
    the bf16 plan is the fp32 plan, frag 0."""
    for B, T, F in ((60, 156, 8), (2, 9, 5)):
        p = fc.glu_bwd_plan(B, T, F, Co, bf16=True)
        assert p == fc.glu_bwd_plan(B, T, F, Co) and p.frag == 0


def _fast_div32(n, d):
    """csrc FastDiv32: s = ceil(log2 d), m = 2^32 (2^s - d) // d + 1,
    (umulhi(m, n) + n) >> s, in 32-bit unsigned arithmetic."""
    s = 0
    while (1 << s) < d:
        s += 1
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    assert 0 <= m < 1 << 32
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(m)) >> np.uint64(32)
    assert (t + n < np.uint64(1 << 32)).all()
    return (t + n) >> np.uint64(s)


def test_fast_div32_is_exact():
    """csrc FastDiv32 is n // d for 0 <= n < 2^31 and 1 <= d < 2^31, as
    glu_bwd_frag_kernel takes it for a position's (b, t, f) and pooled
    indices: every n below 2^20 and the largest ones, at divisors small
    and large, powers of two and their neighbours."""
    rng = np.random.default_rng(3)
    n = np.concatenate([np.arange(1 << 20), (1 << 31) - 1 - np.arange(4096),
                        rng.integers(0, 1 << 31, 1 << 16)])
    ds = list(range(1, 300)) + [626, 313, 156, 1023, 1025, 4095, 4097, 65535, 65537,
                                 (1 << 30) - 1, 1 << 30, (1 << 30) + 1, (1 << 31) - 1]
    ds += [int(x) for x in rng.integers(2, 1 << 31, 40)]
    for d in ds:
        assert np.array_equal(_fast_div32(n, d).astype(np.int64), n // d), d


# --------------------------------------------------------------------------
# conv_bn_stats in bf16 since the persistent kernels: conv3x3_bf16_fwd_kernel
# (blocks 1-6) and conv_c1_bf16_kernel (block 0), emulated in numpy from
# their plans, copy by copy and lane by lane
# --------------------------------------------------------------------------


def _fwd16_walk(p, B, T):
    """(channel tile, CTA, first tile, end tile) of conv3x3_bf16_fwd_kernel's
    persistent grid: CTA g of each channel tile walks [g n / G, (g + 1) n /
    G) of the n = B ceil(T / tt) tiles."""
    n_tiles, G = B * -(-T // p.tt), p.n_parts
    for g in range(G):
        yield g, g * n_tiles // G, (g + 1) * n_tiles // G


def _row_swz(row, c, cg):
    """csrc RowSwz, conv3x3_bf16_fwd_kernel's address rule for its halo and
    weight rows, by the kernel's own shifts: cg_shift = __ffs(cg) - 1 (the
    lowest set bit, so it equals _swz_rows only where cg is a power of
    two)."""
    cg_shift = (cg & -cg).bit_length() - 1
    sh, msk = (0, 7) if cg_shift >= 3 else (3 - cg_shift, (1 << cg_shift) - 1)
    return ((row << cg_shift) + (c ^ ((row >> sh) & msk))) << 3


def _emulate_fwd16(p, x, w, bias, a_lanes=LANES, b_lanes=LANES):
    """y, s, q of conv3x3_bf16_fwd_kernel from its plan (fp32 values, so the
    result is held to the fp32 plain version): the resident weights' and
    each stage's 16-byte copies (halo rows of kc channels and weight rows of
    bn channels, chunks XORed as csrc RowSwz: _row_swz), each stage in ring slot u %
    S, written only over the stage S before it; per warp and k16 step each
    lane's ldmatrix A row (the halo position of its row plus the tap's
    offset) and ldmatrix.trans B row ([tap kc + k][n] weight rows), every B
    matrix's 8 rows in 8 bank groups (one wavefront), the fragments as
    m16n8k16 takes them; the epilogue's bf16 tile (each element once); then
    thread f bn / 8 + ch writes y's 16-byte piece (f, 8 ch ..) of each
    frame and adds it into its 8 lanes' sums, frames in increasing row
    order over the CTA's run; y once, one partial row per CTA. a_lanes, b_lanes: the lane ids from
    which csrc computes its ldmatrix A and B rows (a test swaps their bits)."""
    B, T, F, Ci = x.shape
    Co = w.shape[-1]
    assert p.kernel == 1 and p.ff == F and fc.fwd16_takes(F, Ci, Co)
    bn, R, tt, S, res = p.bn, fc.FWD16_ROWS, p.tt, fc.FWD16_STAGES, p.res
    mi_, ni_ = fc.fwd16_warps(bn)
    wm_, wn_ = 8, 1  # 8 warps of 32 rows, each every channel of the tile
    assert mi_ == 2 and ni_ % 2 == 0 and R == tt * F == 32 * wm_ == fc.FWD16_ROWS
    kc = Ci if res else 16
    cg, ns, cgw = kc // 8, Ci // kc, bn // 8
    Wd, NP = F + 2, (tt + 2) * (F + 2)
    halo = NP * kc
    stg = halo + (0 if res else 9 * 16 * bn)
    wres = 9 * Ci * bn if res else 0
    yp = bn + 8
    assert 2 * (wres + S * stg + R * yp) == p.smem <= fc.SMEM_LIMIT and S in (2, 3)
    assert p.n_parts <= 2 * fc.SM_COUNT and Co % bn == 0 and F * bn <= fc.FWD16_LANES
    nt = -(-T // tt)
    L = F * Co
    M = B * T * F
    xf, wf = x.reshape(-1), w.reshape(9 * Ci, Co)
    y = np.full((M, Co), np.nan)
    ycount = np.zeros((M, Co), np.int64)
    part_s, part_q = np.full((p.n_parts, L), np.nan), np.full((p.n_parts, L), np.nan)
    pcount = np.zeros((p.n_parts, L), np.int64)
    gq, tq = LANES >> 2, LANES & 3
    warps = np.arange(8)
    wm, wn = warps % wm_, warps // wm_
    a_row, achunk = a_lanes & 15, a_lanes >> 4
    brow = ((b_lanes >> 3) & 1) * 8 + (b_lanes & 7)
    bchunk = wn[:, None] * ni_ + (b_lanes >> 4)[None, :]
    r_a = wm[:, None, None] * 32 + np.arange(mi_)[None, :, None] * 16 + a_row[None, None, :]
    apos = (r_a // F + 1) * Wd + r_a % F + 1  # [warp][mi][lane]
    tid = np.arange(256)
    for cy in range(Co // bn):
        n0 = cy * bn
        for g, k0, k1 in _fwd16_walk(p, B, T):
            U = (k1 - k0) * ns
            sm = np.full(wres + S * stg, np.nan)
            if res:
                rows, ch = np.meshgrid(np.arange(9 * Ci), np.arange(cgw), indexing="ij")
                dst = _row_swz(rows, ch, cgw)
                assert np.unique(dst).size == dst.size
                for e in range(8):
                    sm[dst + e] = wf[rows, n0 + ch * 8 + e]
            slot_of = [-1] * S

            def issue(u):
                if u >= U:
                    return
                kt, j = divmod(u, ns)
                b, jt0 = divmod(k0 + kt, nt)
                t0, c0, slot = jt0 * tt, j * kc, u % S
                assert slot_of[slot] == (u - S if u >= S else -1), "a slot still in use"
                slot_of[slot] = u
                base = wres + slot * stg
                e = np.arange(NP * cg)
                cg_shift = (cg & -cg).bit_length() - 1  # csrc __ffs(CG) - 1
                pos, ch = e >> cg_shift, e & (cg - 1)
                _once(np.bincount(pos * cg + ch, minlength=NP * cg), "halo chunks")
                jt = _fast_div(pos, Wd).astype(np.int64)
                t, f = t0 + jt - 1, pos - jt * Wd - 1
                ok = (t >= 0) & (t < T) & (f >= 0) & (f < F)
                dst = base + _row_swz(pos, ch, cg)
                assert np.unique(dst).size == dst.size
                src = np.where(ok, ((b * T + t) * F + f) * Ci + c0 + ch * 8, 0)
                for e8 in range(8):
                    sm[dst + e8] = np.where(ok, xf[src + e8], 0.0)
                if not res:
                    rows, ch = np.meshgrid(np.arange(9 * 16), np.arange(cgw), indexing="ij")
                    dst = base + halo + _row_swz(rows, ch, cgw)
                    assert np.unique(dst).size == dst.size
                    for e8 in range(8):
                        sm[dst + e8] = wf[(rows >> 4) * Ci + c0 + (rows & 15), n0 + ch * 8 + e8]

            for s in range(S - 1):
                issue(s)
            acc = np.zeros((8, mi_, ni_, 32, 4))
            # thread tid < F bn / 8: lanes (tid // cgw, 8 (tid % cgw) + j), j < 8
            owner = tid[tid < F * cgw]
            fl, c = (owner // cgw)[:, None], (owner % cgw * 8)[:, None] + np.arange(8)[None, :]
            ls, lq = np.zeros(c.shape), np.zeros(c.shape)
            last = -1
            for u in range(U):
                issue(u + S - 1)
                assert slot_of[u % S] == u
                kt, j = divmod(u, ns)
                hs = wres + (u % S) * stg
                ws = 0 if res else hs + halo
                wk = Ci if res else 16
                for tap in range(9):
                    off = (tap // 3 - 1) * Wd + tap % 3 - 1
                    for kk in range(kc // 16):
                        amat = np.full((8, mi_, 16, 16), np.nan)
                        for mi in range(mi_):
                            addr = hs + _row_swz(apos[:, mi, :] + off,
                                                 2 * kk + achunk[None, :], cg)
                            for q in range(4):  # register q: matrix q, rows named by lanes 8 q + gq
                                for h in range(2):
                                    amat[:, mi, gq + 8 * (q & 1), 2 * tq + h + 8 * (q >> 1)] = \
                                        sm[addr[:, 8 * q + gq] + 2 * tq + h]
                        for ni in range(0, ni_, 2):
                            addr = ws + _row_swz(tap * wk + kk * 16 + brow[None, :],
                                                 bchunk + ni, cgw)
                            for q in range(4):
                                groups = (2 * addr[:, 8 * q: 8 * q + 8] // 16) % 8
                                assert all(np.unique(gr).size == 8 for gr in groups), \
                                    "a B matrix in more than one wavefront"
                            bmat = np.full((8, 16, 16), np.nan)
                            for q in range(4):  # .trans: lane's k pair of column gq
                                for h in range(2):
                                    bmat[:, 2 * tq + h + 8 * (q & 1), 8 * (q >> 1) + gq] = \
                                        sm[addr[:, 8 * q + 2 * tq + h] + gq]
                            cm = np.einsum("wmrk,wkn->wmrn", amat, bmat)
                            assert not np.isnan(cm).any(), "a fragment read an unwritten element"
                            for h2 in range(2):
                                for e in range(4):
                                    acc[:, :, ni + h2, :, e] += \
                                        cm[:, :, gq + 8 * (e >> 1), 8 * h2 + 2 * tq + (e & 1)]
                if j != ns - 1:
                    continue
                b, jt0 = divmod(k0 + kt, nt)
                t0 = jt0 * tt
                ys = np.full(R * yp, np.nan)
                cnt = np.zeros(R * yp, np.int64)
                for mi in range(mi_):
                    for ni in range(ni_):
                        for e in range(4):
                            r = wm[:, None] * 32 + mi * 16 + gq[None, :] + 8 * (e >> 1)
                            col = wn[:, None] * ni_ * 8 + ni * 8 + 2 * tq[None, :] + (e & 1)
                            ys[r * yp + col] = acc[:, mi, ni, :, e] + bias[n0 + col]
                            np.add.at(cnt, r * yp + col, 1)
                assert cnt.reshape(R, yp)[:, :bn].min() == 1 and cnt.max() == 1
                acc[:] = 0
                frames = min(tt, T - t0)
                for jt in range(frames):  # each owner: one 16-byte piece a frame, in order
                    row = b * T + t0 + jt
                    assert last < row, "a lane's frames out of order"
                    last = row
                    v = ys[(jt * F + fl) * yp + c]
                    y[row * F + fl, n0 + c] = v
                    np.add.at(ycount, (row * F + fl, n0 + c), 1)
                    ls += v
                    lq += v * v
            col = fl * Co + n0 + c
            part_s[g, col] = ls
            part_q[g, col] = lq
            np.add.at(pcount, (g, col), 1)
    _once(ycount.ravel(), "y (row, channel)")
    _once(pcount.ravel(), "lane partials")
    return y.reshape(B, T, F, Co), part_s.sum(0), part_q.sum(0)


def _emulate_c1_bf16(p, x, w, bias):
    """y, s, q of conv_c1_bf16_kernel from its plan (fp32 values): CTA g
    stages frames r0 - 1 .. r1 of the B T (16-byte copies, each slot once)
    and thread (f, c0) = (tid / (Co / 8), 8 (tid % (Co / 8))) computes 8
    channels of position f in its frames in order, the SAME padding from t
    = r % T; each y element once, each lane's partial once per CTA."""
    B, T, F, _ = x.shape
    Co = w.shape[-1]
    assert p.kernel == 2 and fc.c1_bf16_takes(F, Co)
    fpc, Rn = p.rows_per_part, B * T
    assert p.n_parts == -(-Rn // fpc) and p.smem == fc.c1_fwd_smem(fpc, F) <= fc.SMEM_HALF
    xf, wf = x.reshape(Rn, F), w.reshape(9, Co)
    G = Co // 8
    tid = np.arange(256)
    f, c0 = tid // G, (tid % G) * 8
    live = f < F
    f, c0 = f[live], c0[live]
    assert np.unique(f * Co + c0).size == f.size == F * G  # every (position, 8 channels) once
    y = np.full((Rn, F, Co), np.nan)
    ycount = np.zeros((Rn, F, Co), np.int64)
    part_s, part_q = np.full((p.n_parts, F * Co), np.nan), np.full((p.n_parts, F * Co), np.nan)
    pcount = np.zeros((p.n_parts, F * Co), np.int64)
    for g in range(p.n_parts):
        r0, r1 = g * fpc, min(Rn, g * fpc + fpc)
        g0, g1 = max(r0 - 1, 0), min(Rn, r1 + 1)
        xs = np.full(((fpc + 2) * F), np.nan)
        e = np.arange((g1 - g0) * F // 8)
        dst = (g0 - r0 + 1) * F + e * 8
        assert dst.min() >= 0 and dst.max() + 8 <= xs.size
        for e8 in range(8):
            xs[dst + e8] = xf.reshape(-1)[g0 * F + e * 8 + e8]
        s = np.zeros((f.size, 8))
        q = np.zeros((f.size, 8))
        for r in range(r0, r1):
            t = r % T
            o = np.zeros((f.size, 8)) + bias[c0[:, None] + np.arange(8)]
            for tap in range(9):
                dt, df = tap // 3 - 1, tap % 3 - 1
                ok = (t + dt >= 0) & (t + dt < T) & (f + df >= 0) & (f + df < F)
                xv = np.where(ok, xs[np.where(ok, (r - r0 + 1 + dt) * F + f + df, 0)], 0.0)
                assert not np.isnan(xv).any(), "x read outside the staged frames"
                o += xv[:, None] * wf[tap, c0[:, None] + np.arange(8)]
            for j in range(8):
                y[r, f, c0 + j] = o[:, j]
                np.add.at(ycount, (r, f, c0 + j), 1)
            s += o
            q += o * o
        for j in range(8):
            part_s[g, f * Co + c0 + j] = s[:, j]
            part_q[g, f * Co + c0 + j] = q[:, j]
            np.add.at(pcount, (g, f * Co + c0 + j), 1)
    _once(ycount.ravel(), "y (row, channel)")
    _once(pcount.ravel(), "lane partials")
    return y.reshape(B, T, F, Co), part_s.sum(0), part_q.sum(0)


# small shapes of both kernels: resident weights (Ci 16, 32, 64; bn 32, 64),
# 16-channel stages with their weight slices (Ci 128: bn 128, rows 128 and
# 256; Ci 48 and 96, not powers of two), two channel tiles, ragged last
# tiles, F 2 to 16, several tiles a CTA; Ci = 1 at Co 8 to 24, runs across
# clips
EMU_FWD_GEOMS = [(2, 5, 16, 16, 32), (1, 40, 8, 32, 64), (2, 3, 4, 64, 128), (1, 35, 8, 128, 128),
                 (1, 2, 2, 128, 128), (1, 3, 8, 64, 96), (2, 9, 8, 48, 64), (2, 9, 8, 96, 64)]
EMU_C1_GEOMS = [(2, 9, 16, 1, 16), (3, 5, 8, 1, 24), (1, 40, 8, 1, 8)]


def _fwd_inputs(B, T, F, Ci, Co, seed=5):
    rng = np.random.default_rng(seed)
    return (_bf16(rng.standard_normal((B, T, F, Ci))).astype(np.float32),
            _bf16(rng.standard_normal((3, 3, Ci, Co)) / np.sqrt(9 * Ci)).astype(np.float32),
            _bf16(rng.standard_normal(Co) * 0.1).astype(np.float32))


def _fewer_ctas(p, B, T, F):
    """The plan on fewer CTAs, so that small shapes walk several tiles (or
    frames) a CTA, as the 2024 blocks do: a third of the tiles, or runs of 7
    frames."""
    if p.kernel == 1:
        return dataclasses.replace(p, n_parts=max(1, B * -(-T // p.tt) // 3))
    return dataclasses.replace(p, rows_per_part=7, n_parts=-(-B * T // 7),
                               smem=fc.c1_fwd_smem(7, F))


def _check_fwd_emulation(got, x, w, bias):
    want = fc.conv_bn_stats_plain(*(torch.from_numpy(a) for a in (x, w, bias)))
    for name, a, b in zip(("y", "s", "q"), got, want):
        b = b.numpy().astype(np.float64)
        err = float(np.abs(a - b).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(b).max())), f"{name}: {err:.3e}"


@pytest.mark.parametrize("geom", EMU_FWD_GEOMS + EMU_C1_GEOMS,
                         ids=[f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}"
                              for g in EMU_FWD_GEOMS + EMU_C1_GEOMS])
def test_fwd_bf16_emulation_matches_plain(geom):
    """conv3x3_bf16_fwd_kernel (_emulate_fwd16) and conv_c1_bf16_kernel
    (_emulate_c1_bf16), run from their plans in numpy, give
    conv_bn_stats_plain's y, s and q (fp32), on the plan's grid and on
    fewer CTAs (several tiles a CTA: the ring across tiles, the lane sums
    over a run)."""
    B, T, F, Ci, Co = geom
    args = _fwd_inputs(B, T, F, Ci, Co)
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    for plan in (p, _fewer_ctas(p, B, T, F)):
        got = _emulate_c1_bf16(plan, *args) if Ci == 1 else _emulate_fwd16(plan, *args)
        _check_fwd_emulation(got, *args)


@pytest.mark.parametrize("where", ["A", "B"])
@pytest.mark.parametrize("swap", [(0, 1), (2, 3), (3, 4), (1, 4), (0, 4)],
                         ids=lambda s: f"bits{s[0]}-{s[1]}")
def test_fwd16_emulation_fails_a_swapped_lane_bit(where, swap):
    """The emulation fails where csrc would compute a lane's ldmatrix A row
    (halo position, chunk) or ldmatrix.trans B row (weight row, chunk) from a
    lane id with two bits swapped: the fault shows on the CPU."""
    B, T, F, Ci, Co = 1, 3, 8, 32, 64
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    args = _fwd_inputs(B, T, F, Ci, Co)
    bad = _swap_bits(LANES, *swap)
    kw = {"a_lanes" if where == "A" else "b_lanes": bad}
    with pytest.raises(AssertionError):
        _check_fwd_emulation(_emulate_fwd16(p, *args, **kw), *args)


def test_fwd16_emulation_fails_resident_weights_at_a_ci_not_a_power_of_two():
    """The emulation computes the halo's copies with the kernel's shifts
    (RowSwz, cg_shift = __ffs(CG) - 1): resident weights at Ci = 48 (6
    chunks a halo row, which the plan never picks) leave chunks uncopied,
    and the emulation says so."""
    B, T, F, Ci, Co = 2, 9, 8, 48, 64
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert p.kernel == 1 and not p.res
    forced = dataclasses.replace(p, res=1, smem=fc.fwd16_smem(True, Ci, F, p.tt, p.bn,
                                                              fc.FWD16_STAGES))
    with pytest.raises(AssertionError, match="halo chunks"):
        _emulate_fwd16(forced, *_fwd_inputs(B, T, F, Ci, Co))


@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_row_swz_is_swz_rows_at_a_power_of_two(cg):
    """RowSwz's shifts give swz_rows' offsets wherever the chunk count is a
    power of two, the only counts conv3x3_bf16_fwd_kernel is given: each
    (row, chunk) at its own offset, any 8 consecutive rows of a chunk in 8
    bank groups."""
    row, c = np.meshgrid(np.arange(64), np.arange(cg), indexing="ij")
    got = _row_swz(row, c, cg)
    np.testing.assert_array_equal(got, _swz_rows(row, c, cg))
    assert np.unique(got).size == got.size
    for r0 in range(0, 64 - 8, 3):
        groups = (2 * got[r0:r0 + 8] // 16) % 8
        assert all(np.unique(groups[:, k]).size == 8 for k in range(cg))


@pytest.mark.parametrize("geom", [(2, 9, 8, 16, 32), (2, 9, 8, 32, 64), (2, 9, 8, 64, 64),
                                  (2, 9, 8, 48, 64), (2, 9, 8, 80, 64), (2, 9, 8, 96, 64),
                                  (2, 9, 8, 112, 32), (2, 9, 4, 192, 128)],
                         ids=lambda g: f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}")
def test_conv_fwd_plan_bf16_resident_weights_only_at_a_power_of_two_ci(geom):
    """conv3x3_bf16_fwd_kernel takes every Ci % 16 == 0, but keeps its
    weights resident (a stage of all Ci channels, Ci / 8 chunks a halo row)
    only where Ci is a power of two; other Ci take 16-channel stages."""
    B, T, F, Ci, Co = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert p.kernel == 1 and fc.fwd16_takes(F, Ci, Co)
    assert fc.fwd16_res_takes(Ci) == (Ci & (Ci - 1) == 0)
    if not fc.fwd16_res_takes(Ci):
        assert p.res == 0
    else:
        assert p.res == int(2 * 9 * Ci * p.bn <= fc.FWD16_RES_MAX)
    assert p.smem == fc.fwd16_smem(bool(p.res), Ci, F, p.tt, p.bn, fc.FWD16_STAGES)


@pytest.mark.parametrize("geom", _geoms_2024(64) + _geoms_2024(60), ids=IDS[7:14] + IDS[:7])
def test_conv_fwd_plan_bf16_takes_the_persistent_kernels(geom):
    """Every 2024 block at B = 64 and 60 takes the persistent kernels:
    conv_c1_bf16_kernel at block 0, conv3x3_bf16_fwd_kernel at blocks 1-6,
    with at most 2 SM_COUNT lane partial rows per channel tile, w as the
    wrapper has it, and shared memory and registers for its CTAs an SM."""
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert fc.FWD_KERNELS[p.kernel] == ("conv_c1_bf16_kernel" if Ci == 1
                                        else "conv3x3_bf16_fwd_kernel")
    assert p.n_parts <= 2 * fc.SM_COUNT
    if Ci > 1:
        per_sm = fc.fwd16_per_sm(p.bn) if p.smem <= fc.SMEM_HALF else 1
        assert per_sm * (p.smem + 1024) <= fc.SMEM_SM
        assert p.n_parts * (Co // p.bn) <= per_sm * fc.SM_COUNT
        assert p.tt * F == fc.FWD16_ROWS


@pytest.mark.parametrize("geom", [(2, 9, 5, 16, 32), (2, 9, 8, 24, 32), (2, 9, 8, 16, 40),
                                  (1, 7, 256, 32, 32), (2, 9, 6, 64, 128), (2, 9, 5, 1, 16),
                                  (2, 9, 8, 1, 12), (1, 5, 130, 1, 24)],
                         ids=lambda g: f"B{g[0]}-T{g[1]}-F{g[2]}-{g[3]}to{g[4]}")
def test_conv_fwd_plan_bf16_other_shapes_keep_the_earlier_kernels(geom):
    """Shapes the persistent kernels do not take (F not a power of two, Ci
    not a multiple of 16, Co not a multiple of 32, F * 32 lanes past a
    thread's 8 sums; at Ci = 1, F or Co not a multiple of 8) keep
    conv3x3_bf16_kernel or conv_c1_kernel<bf16> and their plans."""
    B, T, F, Ci, Co = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert fc.FWD_KERNELS[p.kernel] == ("conv_c1_kernel<bf16>" if Ci == 1
                                        else "conv3x3_bf16_kernel")
    if Ci == 1:
        assert dataclasses.replace(p, kernel=0) == fc.conv_fwd_plan(B, T, F, Ci, Co)
    else:
        assert (p.bn, p.tt, p.ff, p.smem) == fc._bf16_conv_tiles(T, F, Co)
