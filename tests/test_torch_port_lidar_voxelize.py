"""The LiDAR half of the port's ``ops/voxelize.py`` (z-fold voxelizer on
K1z, ``first_k_in_voxel``) and ``ops/interp.py::resize_bicubic`` against
the JAX package, at the tiny LiDAR grid (96x96x4) and at a grid whose width
is not a multiple of 128.

On the CPU the K1z wrapper runs its plain version (``index_put_``); the
CUDA kernel itself is held to that plain version on the card
(`test_torch_port_kernels.py`, and every run of ``chip_smoke.py``).
Counts and voxel ids must match exactly; means within rtol 1e-5 /
atol 1e-6, since the sum order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)
TINY_GRID = (96, 96, 4)


def cloud(seed, n, grid, pc_range=PC_RANGE, clustered=False):
    """[n,4] points spread 5% past the range on every side, a masked
    fifth, and points exactly on the float32 voxel borders lo + k * size
    of each axis in turn (k = 0..dim; k = dim is the hi edge, out).  With
    ``clustered`` a third of the points pile onto 40 spots, so voxels hold
    more than 10 points."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(pc_range[:3], np.float32)
    hi = np.asarray(pc_range[3:], np.float32)
    size = (hi - lo) / np.asarray(grid, np.float32)
    pad = 0.05 * (hi - lo)
    pts = np.concatenate([rng.uniform(lo - pad, hi + pad, (n, 3)),
                          rng.rand(n, 1)], 1).astype(np.float32)
    if clustered:
        spots = rng.uniform(lo, hi, (40, 3))
        k = n // 3
        pts[-k:, :3] = spots[rng.randint(0, 40, k)] \
            + rng.normal(0, 0.3, (k, 3)) * size
    start = 0
    for ax, dim in enumerate(grid):
        k = np.arange(dim + 1, dtype=np.float32)
        pts[start:start + dim + 1, ax] = lo[ax] + k * size[ax]
        start += dim + 1
    mask = rng.rand(n) > 0.2
    return pts, mask


def test_point_voxel_ids_match_jax():
    from lanemapping_tpu.ops.voxelize import point_voxel_ids as ids_j
    from lanemapping_tpu_torch.ops.voxelize import point_voxel_ids

    clouds = [cloud(s, 6000, TINY_GRID) for s in (0, 1)]
    pts = np.stack([c[0] for c in clouds])
    lin, valid = point_voxel_ids(torch.tensor(pts), PC_RANGE, TINY_GRID)
    for b in range(2):
        want_lin, want_valid = ids_j(jnp.asarray(pts[b]), PC_RANGE, TINY_GRID)
        np.testing.assert_array_equal(lin[b].numpy(), np.asarray(want_lin))
        np.testing.assert_array_equal(valid[b].numpy(),
                                      np.asarray(want_valid))
    # the hi-edge border points are out of range, the lo-edge ones in
    assert 0 < valid.float().mean() < 1


@pytest.mark.parametrize("k", [1, 3, 10])
def test_first_k_in_voxel_matches_jax(k):
    from lanemapping_tpu.ops.voxelize import first_k_in_voxel as fk_j
    from lanemapping_tpu.ops.voxelize import point_voxel_ids as ids_j
    from lanemapping_tpu_torch.ops.voxelize import first_k_in_voxel

    clouds = [cloud(s, 5000, TINY_GRID, clustered=True) for s in (2, 3)]
    lins, oks, want = [], [], []
    for pts, mask in clouds:
        lin, in_range = ids_j(jnp.asarray(pts), PC_RANGE, TINY_GRID)
        ok = jnp.asarray(mask) & in_range
        want.append(np.asarray(fk_j(lin, ok, k)))
        lins.append(np.asarray(lin))
        oks.append(np.asarray(ok))
    got = first_k_in_voxel(torch.tensor(np.stack(lins)).long(),
                           torch.tensor(np.stack(oks)), k)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert got.sum() < np.stack(oks).sum()  # the cap bit


@pytest.mark.parametrize("cap", [None, 10])
def test_voxelize_matches_jax(cap):
    from lanemapping_tpu.ops.voxelize import voxelize_bev_zfold as zfold_j
    from lanemapping_tpu.ops.voxelize import voxelize_mean as mean_j
    from lanemapping_tpu_torch.ops.voxelize import (voxelize_bev_zfold,
                                                    voxelize_mean)

    clouds = [cloud(s, 6000, TINY_GRID, clustered=True) for s in (4, 5)]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    want_fold = jax.vmap(lambda p, m: zfold_j(p, m, PC_RANGE, TINY_GRID,
                                              max_points_per_voxel=cap))(
        jnp.asarray(pts), jnp.asarray(mask))
    got_fold = voxelize_bev_zfold(torch.tensor(pts), torch.tensor(mask),
                                  PC_RANGE, TINY_GRID,
                                  max_points_per_voxel=cap)
    assert got_fold.shape == (2, 96, 96, 16)
    np.testing.assert_allclose(got_fold.numpy(), np.asarray(want_fold),
                               rtol=1e-5, atol=1e-6)
    want_mean = mean_j(jnp.asarray(pts[1]), jnp.asarray(mask[1]), PC_RANGE,
                       TINY_GRID, max_points_per_voxel=cap)
    got_mean = voxelize_mean(torch.tensor(pts[1]), torch.tensor(mask[1]),
                             PC_RANGE, TINY_GRID, max_points_per_voxel=cap)
    assert got_mean.shape == (4, 96, 96, 4)
    np.testing.assert_allclose(got_mean.numpy(), np.asarray(want_mean),
                               rtol=1e-5, atol=1e-6)


def test_plain_zfold_counts_match_jax_exactly():
    from lanemapping_tpu.ops.voxelize import point_voxel_ids as ids_j
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_bin_sums

    pts, mask = cloud(6, 8000, TINY_GRID, clustered=True)
    lin, in_range = ids_j(jnp.asarray(pts), PC_RANGE, TINY_GRID)
    ok = np.asarray(in_range) & mask
    want = np.bincount(np.asarray(lin)[ok], minlength=96 * 96 * 4)
    want = want.reshape(4, 96, 96).transpose(1, 2, 0)  # [Y,X,Z]
    sums, cnts = voxel_bin_sums(torch.tensor(pts)[None],
                                torch.tensor(mask)[None], PC_RANGE,
                                TINY_GRID)
    assert sums.shape == (1, 96, 96, 4, 4) and cnts.shape == (1, 96, 96, 4)
    np.testing.assert_array_equal(cnts[0].numpy(), want)


@pytest.mark.parametrize("grid,pc_range", [
    (TINY_GRID, PC_RANGE),
    ((160, 16, 3), (-16.0, -4.0, -1.0, 16.0, 4.0, 2.0)),  # 160 = 1.25 * 128
], ids=["tiny", "width160"])
def test_plain_zfold_matches_pallas_oracle(grid, pc_range):
    """The retired TPU kernel's z-fold wrapper itself, run in interpret mode
    as the JAX package's tests run it (`tests/test_pallas_kernels.py:59-
    110`), including a width that is not a multiple of 128."""
    from pallas_reference_bev import voxelize_bev_zfold_pallas
    from lanemapping_tpu_torch.ops.voxelize import voxelize_bev_zfold

    pts, mask = cloud(7, 3000, grid, pc_range)
    want = np.asarray(voxelize_bev_zfold_pallas(
        jnp.asarray(pts), jnp.asarray(mask), pc_range, grid, interpret=True,
        capacity=1024))
    got = voxelize_bev_zfold(torch.tensor(pts), torch.tensor(mask), pc_range,
                             grid)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(24, 48), (5, 13), (13, 5), (1, 4),
                                        (6, 6)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bicubic_matches_jax(n_in, n_out, align_corners):
    from lanemapping_tpu.ops.interp import resize_bicubic as rs_j
    from lanemapping_tpu_torch.ops.interp import resize_bicubic

    x = np.random.RandomState(n_in * 31 + n_out).randn(
        2, n_in, n_in + 2, 3).astype(np.float32)
    want = np.asarray(rs_j(jnp.asarray(x), n_out, n_out + 3, align_corners))
    got = resize_bicubic(torch.tensor(x).permute(0, 3, 1, 2), n_out,
                         n_out + 3, align_corners).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
