"""The conv block's kernels' plans (ops/fused_cnn.py conv_fwd_plan,
glu_fwd_plan, conv_bwd_plan, glu_bwd_plan), on the CPU.

A plan is a pure function of the shape. Walked through the index maps that
csrc/fused_cnn.cu applies to it, every row, depth index and channel must be
covered exactly once, shared memory must fit the card, and the order in
which partial sums are added must follow from the shape alone. The forward
plans are walked in both modes (fp32 and bf16: the tensor-core conv's warp
tiles and ldmatrix rows, the GLU's extra gate tile); the GLU backward plan
also at widths past 128 channels and at F * Co lane sums past shared memory.
"""

import numpy as np
import pytest

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


def _walk_glu_mma(p, B, T, F, Co, pool):
    """glu_fwd_mma_kernel's maps: the tile's positions as glu_fwd_kernel
    orders them, 8 warps (4 over the rows, mi = 8 / ni m16 tiles each, 2
    over the ct columns) of m16n8 fragments, the A stage's items of 8
    channels; shared memory within the card's limit."""
    pt, pf = pool
    W, To, Fo = pt * pf, T // pt, F // pf
    Q = B * To * Fo
    ni = p.ct // 16
    mi = 8 // ni
    assert p.ct in (16, 32, 64, 128) and p.p == fc.GLU_MMA_ROWS // ni == 64 * mi
    assert p.nq == p.p // W and p.ks == -(-Co // 16) * 16 and p.grid_y == -(-Co // p.ct)
    assert p.smem == fc.glu_mma_smem(Co, p.ct, p.p, p.nq) <= SMEM_LIMIT
    assert p.n_tiles == -(-Q // p.nq) and (p.n_tiles == 0 or 1 <= p.grid_x <= p.n_tiles)
    k = np.arange(p.n_tiles)[:, None]
    pos = np.arange(p.p)[None, :]
    q = k * p.nq + pos // W
    valid = (pos // W < p.nq) & (q < Q)
    _once(np.bincount((q * W + pos % W)[valid], minlength=Q * W),
          "(pooled output, window element)")
    Wm, Wn, L_, M_i, N_i, E_ = np.meshgrid(np.arange(4), np.arange(2), np.arange(32),
                                           np.arange(mi), np.arange(ni), np.arange(4),
                                           indexing="ij")
    rows = Wm * 16 * mi + M_i * 16 + L_ // 4 + 8 * (E_ // 2)
    cols = Wn * ni * 8 + N_i * 8 + 2 * (L_ % 4) + E_ % 2
    _once(np.bincount((rows * p.ct + cols).ravel(), minlength=p.p * p.ct), "(row, column)")
    items = np.arange(p.p * (p.ks // 8))
    _once(np.bincount((items // (p.ks // 8)) * p.ks + items % (p.ks // 8) * 8,
                      minlength=p.p * p.ks)[::8], "A items")
    chans = (np.arange(p.grid_y)[:, None] * p.ct + np.arange(p.ct)[None, :]).ravel()
    _once(np.bincount(chans[chans < Co], minlength=Co), "output channels")


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
    """The bf16 plan: Ci = 1 the fp32 streaming plan; else the tensor-core
    kernel's warp tiles and ldmatrix rows (_walk_bf16_conv), every row and
    channel once, and each (clip, frame tile) one lane partial row, as the
    fp32 STATS epilogue writes them."""
    B, T, F, Ci, Co, _ = geom
    p = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    if Ci == 1:
        assert p == fc.conv_fwd_plan(B, T, F, Ci, Co)
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


@pytest.mark.parametrize("geom", FWD_GEOMS, ids=FWD_IDS)
def test_glu_fwd_plan_bf16_covers_pooled_outputs(geom):
    B, T, F, _, Co, pool = geom
    _walk_glu_mma(fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True), B, T, F, Co, pool)


@pytest.mark.parametrize("geom", _geoms_2024(60) + _geoms_2024(64) + WIDE[:2],
                         ids=IDS[:14] + FWD_IDS[len(GEOMS):len(GEOMS) + 2])
def test_fwd_plans_bf16_depend_on_the_shape_alone(geom):
    """Equal shapes give equal bf16 plans; the 2024 shapes keep two blocks of
    each bf16 forward kernel on an SM (the GLU at Co = 256 one: its tile
    holds Wg^T of 128 channels by 256)."""
    B, T, F, Ci, Co, pool = geom
    a = fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    g = fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    assert a == fc.conv_fwd_plan(B, T, F, Ci, Co, bf16=True)
    assert g == fc.glu_fwd_plan(B, T, F, Co, pool, bf16=True)
    assert all(isinstance(v, int) for v in a.ints() + g.ints())
    assert 2 * (a.smem + 1024) <= fc.SMEM_SM
    assert (2 if Co <= 128 else 1) * (g.smem + 1024) <= fc.SMEM_SM


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
