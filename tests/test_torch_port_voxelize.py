"""K1 (BEV binning), its plain versions and the port's rasterize path
against the JAX package, plus the host modules the port keeps as copies.

On the CPU the K1 wrapper runs its plain version (``index_put_``); the CUDA
kernel itself is held to that plain version on the card
(`test_torch_port_kernels.py`, and every run of ``chip_smoke.py``).  Counts must match exactly;
means and sums within rtol 1e-5 / atol 1e-6, since the sum order differs.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import REPO, configs

PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)


def cloud(seed, n, img, pc_range=PC_RANGE):
    """Points spread past the range on every side (out-of-range drops),
    a masked fifth, and the first img+1 points exactly on cell borders
    lo + k * size in float32 (k = 0..img; k = img is the hi edge, out)."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(pc_range[:2], np.float32)
    hi = np.asarray(pc_range[3:5], np.float32)
    size = (hi - lo) / np.float32(img)
    pad = 0.05 * (hi - lo)
    pts = np.stack([rng.uniform(lo[0] - pad[0], hi[0] + pad[0], n),
                    rng.uniform(lo[1] - pad[1], hi[1] + pad[1], n),
                    rng.normal(0, 1, n), rng.rand(n)], 1).astype(np.float32)
    k = np.arange(img + 1, dtype=np.float32)
    pts[:img + 1, 0] = lo[0] + k * size[0]
    pts[:img + 1, 1] = lo[1] + k[::-1] * size[1]
    mask = rng.rand(n) > 0.2
    return pts, mask


@pytest.mark.parametrize("flip_rows", [False, True])
def test_plain_binning_matches_jax_rasterize(flip_rows):
    from lanemapping_tpu.ops.voxelize import rasterize_bev_intensity as rast_j
    from lanemapping_tpu_torch.ops.voxelize import rasterize_bev_intensity

    img = 96
    pts, mask = cloud(0, 30000, img)
    want_m, want_c = rast_j(jnp.asarray(pts), jnp.asarray(mask), PC_RANGE,
                            img, flip_rows=flip_rows)
    got_m, got_c = rasterize_bev_intensity(torch.tensor(pts),
                                           torch.tensor(mask), PC_RANGE, img,
                                           flip_rows=flip_rows)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5,
                               atol=1e-6)
    # border points landed in the interior; the hi-edge one is out of range
    assert 0 < np.asarray(want_c).sum() < mask.sum()


def test_plain_binning_matches_pallas_oracle():
    """The retired TPU kernel itself, run in interpret mode as the JAX
    package's tests run it, on the cells the port's plain version bins."""
    import jax
    from pallas_reference_bev import bev_bin_sums as pallas_bin
    from lanemapping_tpu_torch.kernels.bev_bin import (bev_bin_sums_ref,
                                                       bin_geometry)

    img = 128
    pts, mask = cloud(1, 5000, img)
    lo, size = bin_geometry(PC_RANGE, img)
    ij = np.floor((pts[:, :2] - lo) / size).astype(np.int32)
    valid = mask & np.all((ij >= 0) & (ij < img), axis=1)
    ij = np.clip(ij, 0, img - 1)
    want_s, want_c = jax.device_get(pallas_bin(
        jnp.asarray(ij[:, 1]), jnp.asarray(ij[:, 0]), jnp.asarray(pts[:, 3]),
        jnp.asarray(valid), height=img, width=img, band_rows=8,
        capacity=1024, interpret=True))
    got_s, got_c = bev_bin_sums_ref(torch.tensor(pts)[None],
                                    torch.tensor(mask)[None], PC_RANGE, img)
    np.testing.assert_array_equal(got_c[0].numpy(), want_c)
    np.testing.assert_allclose(got_s[0].numpy(), want_s, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("flip_rows", [False, True])
def test_plain_bev_mean_matches_jax_and_pallas_oracle(flip_rows):
    """K1's plain version, the (mean, count) the kernel writes, against the
    JAX rasterizer and the TPU kernel's wrapper in interpret mode (which
    has no row flip: its rows are flipped here)."""
    from lanemapping_tpu.ops.voxelize import rasterize_bev_intensity as rast_j
    from pallas_reference_bev import rasterize_bev_intensity_pallas
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_mean_ref

    img = 128
    clouds = [cloud(s, 5000, img) for s in (6, 7)]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    got_m, got_c = bev_bin_mean_ref(torch.tensor(pts), torch.tensor(mask),
                                    PC_RANGE, img, flip_rows=flip_rows)
    for b in range(2):
        want_m, want_c = rast_j(jnp.asarray(pts[b]), jnp.asarray(mask[b]),
                                PC_RANGE, img, flip_rows=flip_rows)
        np.testing.assert_array_equal(got_c[b].numpy(), np.asarray(want_c))
        np.testing.assert_allclose(got_m[b].numpy(), np.asarray(want_m),
                                   rtol=1e-5, atol=1e-6)
    want_p = np.asarray(rasterize_bev_intensity_pallas(
        jnp.asarray(pts[0]), jnp.asarray(mask[0]), PC_RANGE, img,
        interpret=True))
    if flip_rows:
        want_p = want_p[::-1]
    np.testing.assert_allclose(got_m[0].numpy(), want_p, rtol=1e-5,
                               atol=1e-6)


def test_bev_image_from_points_matches_jax_batched():
    import jax
    from lanemapping_tpu.ops.voxelize import bev_image_from_points as bev_j
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points

    img = 64
    clouds = [cloud(s, 6000, img) for s in (2, 3)]
    pts = np.stack([c[0] for c in clouds])
    pts[..., 3] *= 0.8
    mask = np.stack([c[1] for c in clouds])
    want = jax.vmap(lambda p, m: bev_j(p, m, PC_RANGE, img))(
        jnp.asarray(pts), jnp.asarray(mask))
    got = bev_image_from_points(torch.tensor(pts), torch.tensor(mask),
                                PC_RANGE, img)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    single = bev_image_from_points(torch.tensor(pts[0]),
                                   torch.tensor(mask[0]), PC_RANGE, img)
    np.testing.assert_array_equal(single.numpy(), got[0].numpy())


def test_fill_bev_holes_matches_jax():
    from lanemapping_tpu.ops.voxelize import fill_bev_holes as fill_j
    from lanemapping_tpu_torch.ops.voxelize import fill_bev_holes

    rng = np.random.RandomState(4)
    cnt = (rng.rand(80, 80) > 0.85).astype(np.float32) * rng.randint(1, 9,
                                                                     (80, 80))
    val = np.where(cnt > 0, rng.rand(80, 80), 0.0).astype(np.float32)
    for iters in (1, 6):
        want = np.asarray(fill_j(jnp.asarray(val), jnp.asarray(cnt), iters))
        got = fill_bev_holes(torch.tensor(val), torch.tensor(cnt), iters)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_in,n_out", [(1, 7), (7, 1), (5, 13), (13, 5),
                                        (6, 6)])
def test_resize_bilinear_matches_jax(n_in, n_out):
    from lanemapping_tpu.ops.interp import resize_bilinear_ac as rs_j
    from lanemapping_tpu_torch.ops.interp import resize_bilinear_ac

    x = np.random.RandomState(n_in * 31 + n_out).randn(2, n_in, n_in + 1,
                                                        3).astype(np.float32)
    want = np.asarray(rs_j(jnp.asarray(x), n_out, n_out + 2))
    got = resize_bilinear_ac(torch.tensor(x).permute(0, 3, 1, 2), n_out,
                             n_out + 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_upsample_then_avgpool_matches_jax():
    from lanemapping_tpu.ops.interp import upsample_then_avgpool as up_j
    from lanemapping_tpu_torch.ops.interp import upsample_then_avgpool

    x = np.random.RandomState(8).randn(2, 12, 20, 1).astype(np.float32)
    want = np.asarray(up_j(jnp.asarray(x), 48, 80, 8))
    got = upsample_then_avgpool(torch.tensor(x[..., 0]), 48, 80, 8)
    np.testing.assert_allclose(got.numpy(), want[..., 0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "configs", "*.py"))),
    ids=os.path.basename)
def test_config_loads_the_same_in_both_packages(path):
    cfg_j, cfg_t = configs(path)
    assert cfg_t.to_dict() == cfg_j.to_dict()


def test_las_and_cloud_copies_match_jax(tmp_path):
    from lanemapping_tpu.data import las as las_j, synthetic as syn_j
    from lanemapping_tpu_torch.data import las, synthetic
    from lanemapping_tpu_torch.data.las_tiles import LasTiles
    from lanemapping_tpu_torch.data.loader import Loader

    seqs = synthetic.random_lane_seqs(np.random.RandomState(9), 192, 4)
    want_seqs = syn_j.random_lane_seqs(np.random.RandomState(9), 192, 4)
    for a, b in zip(seqs, want_seqs):
        np.testing.assert_array_equal(a, b)
    pts = synthetic.lane_structured_points(seqs, [1, 2, 1, 2], 192,
                                           np.random.RandomState(10), 5000)
    np.testing.assert_array_equal(
        pts, syn_j.lane_structured_points(want_seqs, [1, 2, 1, 2], 192,
                                          np.random.RandomState(10), 5000))
    os.makedirs(tmp_path / "las")
    for i in range(3):
        las.write_las_points(str(tmp_path / "las" / f"t{i}.las"), pts[i:])
    got = las.load_lidar_points(str(tmp_path / "las" / "t1.las"))
    np.testing.assert_array_equal(
        got, las_j.load_lidar_points(str(tmp_path / "las" / "t1.las")))
    batches = list(Loader(LasTiles(str(tmp_path), max_points=6000),
                          batch_size=2, shuffle=False, drop_last=False))
    assert [b["image_name"] for b in batches] == [["t0", "t1"], ["t2"]]
    np.testing.assert_array_equal(batches[0]["points"][1, :len(got)],
                                  got.astype(np.float32))
    assert batches[1]["points_mask"].sum() == 4998
