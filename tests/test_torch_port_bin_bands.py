"""The band plan of the binning kernels K1 and K1z
(`lanemapping_tpu_torch/kernels/bin_bands.py`), on the CPU.

The plan decides how the CUDA kernels cut a grid into bands; the kernels
only follow it.  For each case: every cell of the grid lies in exactly one
band, the cell index a band gives it lands on the cell's own row-major
output position (so a band's outputs are one contiguous stretch), shared
memory stays within the card's 227 KB, and the scratch holds every point.
A numpy model of the four passes on a plan then reproduces the plain
versions' means, counts exactly.
"""

import numpy as np
import pytest
import torch

PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)

# (n_tiles, n_points, height, width, depth, n_vals, record floats): K1's
# record is [value, cell index], K1z's the point itself, padded
CASES = {
    "flagship_1152": (8, 1 << 19, 1152, 1152, 1, 1, 2),
    "lidar_576x576x10": (8, 1 << 19, 576, 576, 10, 4, 4),
    "tiny_flagship_192": (2, 1 << 16, 192, 192, 1, 1, 2),
    "tiny_lidar_96x96x4": (2, 4096, 96, 96, 4, 4, 4),
    **{f"lidar_C{c}": (8, 1 << 19, 576, 576, 10, c, 4 if c <= 4 else 8)
       for c in range(3, 9)},
    "row_beyond_budget": (1, 1000, 64, 8192, 10, 8, 8),
}


@pytest.mark.parametrize("case", list(CASES), ids=list(CASES))
def test_band_plan_covers_grid_once_within_shared_memory(case):
    from lanemapping_tpu_torch.kernels.bin_bands import (SMEM_LIMIT,
                                                         band_plan)

    B, N, H, W, D, V, rec = CASES[case]
    plan = band_plan(B, N, H, W, D, V, rec)
    # a band spans whole rows, or one row in x-chunks
    assert plan.x_chunk == W or plan.rows_per_band == 1
    cover = np.zeros((H, W), np.int32)
    for k in range(plan.bands_per_tile):
        r0, rows, x0, cols = plan.band_rect(k)
        assert rows > 0 and cols > 0
        cover[r0:r0 + rows, x0:x0 + cols] += 1
    assert (cover == 1).all()
    # the band and cell index of every cell, as the kernels compute them
    row, col, sub = (a.ravel() for a in np.meshgrid(
        np.arange(H), np.arange(W), np.arange(D), indexing="ij"))
    band, local = plan.locate(row, col, sub)
    assert band.min() == 0 and band.max() == plan.bands_per_tile - 1
    r0 = (band // plan.n_xchunks) * plan.rows_per_band
    x0 = (band % plan.n_xchunks) * plan.x_chunk
    np.testing.assert_array_equal((r0 * W + x0) * D + local,
                                  (row * W + col) * D + sub)
    assert local.max() < plan.cells_per_band
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.scatter_smem_bytes <= SMEM_LIMIT
    assert plan.n_slots == B * N  # every point of every tile
    scratch = plan.scratch("meta")
    assert scratch["slot_rec"].numel() == plan.n_slots * plan.rec
    assert scratch["band_off"].numel() == plan.n_bands + 1


def test_band_plan_matches_the_kernels_design_points():
    """4 rows of 1152 cells (36.9 KB) for K1 and 192-wide x-chunks of the
    576 x 576 x 10 grid with C = 4 (38.4 KB) for K1z."""
    from lanemapping_tpu_torch.kernels import voxel_bin
    from lanemapping_tpu_torch.kernels.bin_bands import band_plan

    k1 = band_plan(*CASES["flagship_1152"])
    assert (k1.rows_per_band, k1.x_chunk, k1.smem_bytes) == (4, 1152, 36864)
    k1z = band_plan(*CASES["lidar_576x576x10"])
    assert voxel_bin.record_floats(4) == k1z.rec == 4
    assert (k1z.rows_per_band, k1z.x_chunk, k1z.n_xchunks,
            k1z.smem_bytes) == (1, 192, 3, 38400)
    with pytest.raises(ValueError):
        band_plan(1, 10, 4, 4, 20000, 4, 4)  # one column beyond the card
    with pytest.raises(ValueError):
        band_plan(1, 10, 4, 4, 1, 4, 6)  # records are a power of two


def simulate_passes(plan, row, col, sub, vals, valid):
    """Passes (A)-(D) in numpy: [B,N] cells, [B,N,V] values, [B,N] valid ->
    (flat outputs [B*H*W*D*V] of sum / max(count, 1), counts [B*H*W*D]).
    The kernels' order of records within a segment differs; the sums do
    not depend on it."""
    B, N = valid.shape
    V = plan.n_vals
    band, local = plan.locate(row, col, sub)
    gband = np.arange(B)[:, None] * plan.bands_per_tile + band
    count = np.bincount(gband[valid], minlength=plan.n_bands)  # (A)
    off = np.concatenate([[0], np.cumsum(count)])               # (B)
    assert off[-1] <= plan.n_slots
    order = np.argsort(np.where(valid, gband, plan.n_bands).ravel(),
                       kind="stable")[:off[-1]]                # (C)
    slot_local = local.ravel()[order]
    slot_vals = vals.reshape(-1, V)[order]
    out = np.full(B * plan.height * plan.width * plan.depth * V, np.nan,
                  np.float32)
    cnt_out = np.full(B * plan.height * plan.width * plan.depth, np.nan,
                      np.float32)
    for g in range(plan.n_bands):                               # (D)
        tile, k = divmod(g, plan.bands_per_tile)
        r0, rows, x0, cols = plan.band_rect(k)
        cells = rows * cols * plan.depth
        seg = slice(off[g], off[g + 1])
        assert (slot_local[seg] < cells).all()
        s = np.zeros((cells, V), np.float64)
        c = np.zeros(cells, np.float64)
        np.add.at(s, slot_local[seg], slot_vals[seg])
        np.add.at(c, slot_local[seg], 1)
        start = ((tile * plan.height + r0) * plan.width + x0) * plan.depth
        assert np.isnan(cnt_out[start:start + cells]).all()  # written once
        out[start * V:(start + cells) * V] = \
            (s / np.maximum(c, 1)[:, None]).ravel()
        cnt_out[start:start + cells] = c
    assert not np.isnan(cnt_out).any()  # every output written
    return out, cnt_out


@pytest.mark.parametrize("grid", [
    (96, 96, 4),   # whole-row bands
    (251, 6, 10),  # a 50 KB row: x-chunks of one row, ragged last chunk
], ids=["rows", "xchunks"])
def test_pass_model_on_plan_matches_plain_voxel_mean(grid):
    from lanemapping_tpu_torch.kernels.bin_bands import band_plan
    from lanemapping_tpu_torch.kernels.voxel_bin import (voxel_bin_mean_ref,
                                                         voxel_bin_sums_ref,
                                                         voxel_cells)

    X, Y, Z = grid
    rng = np.random.RandomState(3)
    lo = np.asarray(PC_RANGE[:3], np.float32)
    hi = np.asarray(PC_RANGE[3:], np.float32)
    n = 5000
    pts = np.concatenate([rng.uniform(lo - 1, hi + 1, (2, n, 3)),
                          rng.rand(2, n, 1)], -1).astype(np.float32)
    mask = rng.rand(2, n) > 0.2
    plan = band_plan(2, n, Y, X, Z, 4, 4)
    if X > 96:
        assert plan.n_xchunks > 1 and X % plan.x_chunk != 0
    ijk, valid = voxel_cells(torch.tensor(pts), PC_RANGE, grid)
    valid = (valid & torch.tensor(mask)).numpy()
    ijk = ijk.numpy()
    out, cnt = simulate_passes(plan, ijk[..., 1], ijk[..., 0], ijk[..., 2],
                               pts.astype(np.float64), valid)
    want = voxel_bin_mean_ref(torch.tensor(pts), torch.tensor(mask),
                              PC_RANGE, grid)
    _, want_cnt = voxel_bin_sums_ref(torch.tensor(pts), torch.tensor(mask),
                                     PC_RANGE, grid)
    np.testing.assert_array_equal(cnt, want_cnt.numpy().ravel())
    np.testing.assert_allclose(out, want.numpy().ravel(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("flip_rows", [False, True])
def test_pass_model_on_plan_matches_plain_bev_mean(flip_rows):
    from lanemapping_tpu_torch.kernels.bev_bin import (bev_bin_mean_ref,
                                                       bin_geometry)
    from lanemapping_tpu_torch.kernels.bin_bands import band_plan

    img = 256
    rng = np.random.RandomState(4)
    lo, size = bin_geometry(PC_RANGE, img)
    pts = np.stack([rng.uniform(lo[0] - 1, lo[0] + size[0] * img + 1,
                                (2, 5000)),
                    rng.uniform(lo[1] - 1, lo[1] + size[1] * img + 1,
                                (2, 5000)),
                    rng.normal(0, 1, (2, 5000)), rng.rand(2, 5000)],
                   -1).astype(np.float32)
    mask = rng.rand(2, 5000) > 0.2
    plan = band_plan(2, 5000, img, img)
    assert plan.bands_per_tile > 1 and img % plan.rows_per_band != 0
    q = (pts[..., :2] - lo) / size
    valid = mask & ((q >= 0) & (q < img)).all(-1)
    ij = np.where(valid[..., None], np.floor(q), 0).astype(np.int64)
    row = img - 1 - ij[..., 1] if flip_rows else ij[..., 1]
    out, cnt = simulate_passes(plan, row, ij[..., 0], np.zeros_like(row),
                               pts[..., 3:4].astype(np.float64), valid)
    want_m, want_c = bev_bin_mean_ref(torch.tensor(pts), torch.tensor(mask),
                                      PC_RANGE, img, flip_rows=flip_rows)
    np.testing.assert_array_equal(cnt, want_c.numpy().ravel())
    np.testing.assert_allclose(out, want_m.numpy().ravel(), rtol=1e-5,
                               atol=1e-6)
