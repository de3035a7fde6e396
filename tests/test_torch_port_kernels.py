"""The port's hand-written CUDA kernels (K1 ``bev_bin_mean``, K1z
``voxel_bin_mean``) against their plain PyTorch versions, and the
no-fallback rule of their wrappers.

This file imports neither JAX nor the JAX package, so the card-only tests
(marker ``cuda``) also run on a machine with no JAX:

    PYTHONPATH=. python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

Without a card they skip, with the reason; a CUDA kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import, so every
    worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode "
                    "(run `python -m pytest -m cuda` on the card)")
    return torch.device("cuda")


def cloud(seed, b, n, img, layout="spread"):
    """[b,n,4] points over and past the range, a masked fifth, and points
    exactly on the float32 cell borders of the first tile.  ``layout``:
    "spread" as above; "piled": a third of the points on 30 cells, as road
    paint piles on a few; "one_band": every point in the first 4 rows;
    "all_masked": the mask is all False."""
    from lanemapping_tpu_torch.kernels.bev_bin import bin_geometry

    rng = np.random.RandomState(seed)
    lo, size = bin_geometry(PC_RANGE, img)
    span = size * img
    pts = np.stack([rng.uniform(lo[0] - 0.05 * span[0],
                                lo[0] + 1.05 * span[0], (b, n)),
                    rng.uniform(lo[1] - 0.05 * span[1],
                                lo[1] + 1.05 * span[1], (b, n)),
                    rng.normal(0, 1, (b, n)), rng.rand(b, n)],
                   -1).astype(np.float32)
    k = np.arange(img + 1, dtype=np.float32)
    pts[0, :img + 1, 0] = lo[0] + k * size[0]
    pts[0, :img + 1, 1] = lo[1] + k * size[1]
    mask = rng.rand(b, n) > 0.2
    if layout == "piled":
        spots = lo + (rng.randint(0, img, (30, 2)) + 0.5) * size
        pts[:, -(n // 3):, :2] = spots[rng.randint(0, 30, (b, n // 3))]
    elif layout == "one_band":
        pts[..., 1] = lo[1] + rng.uniform(0, 4, (b, n)).astype(
            np.float32) * size[1]
    elif layout == "all_masked":
        mask[:] = False
    return torch.tensor(pts), torch.tensor(mask)


def test_binning_wrapper_takes_plain_version_only_on_cpu():
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(5, 2, 2000, 32)
    before = bev_bin.bev_bin_mean.launches
    m, c = bev_bin.bev_bin_mean(pts, mask, PC_RANGE, 32)
    m_ref, c_ref = bev_bin.bev_bin_mean_ref(pts, mask, PC_RANGE, 32)
    assert bev_bin.bev_bin_mean.launches == before  # no kernel on the CPU
    assert torch.equal(m, m_ref) and torch.equal(c, c_ref)
    assert 0 < c.sum() < mask.sum()


def test_binning_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    rerouted to the plain version."""
    from lanemapping_tpu_torch.kernels import bev_bin

    with pytest.raises(ValueError, match="unsupported device"):
        bev_bin.bev_bin_mean(torch.empty((1, 4, 4), device="meta"),
                             torch.empty((1, 4), dtype=torch.bool,
                                         device="meta"), PC_RANGE, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("img,flip_rows,layout", [
    (1152, False, "spread"), (1152, True, "spread"), (1152, True, "piled"),
    (1152, False, "one_band"), (1152, False, "all_masked"),
    (101, True, "piled"),  # bands that start off 16-byte alignment
])
def test_bev_bin_kernel_matches_plain_version_on_card(cuda_device, img,
                                                      flip_rows, layout):
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(6, 3, 300000, img, layout)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    before = bev_bin.bev_bin_mean.launches
    m, c = bev_bin.bev_bin_mean(pts, mask, PC_RANGE, img,
                                flip_rows=flip_rows)
    m_ref, c_ref = bev_bin.bev_bin_mean_ref(pts, mask, PC_RANGE, img,
                                            flip_rows=flip_rows)
    torch.cuda.synchronize()
    assert bev_bin.bev_bin_mean.launches == before + 1
    # counts are exact; the sum order of shared-memory atomics varies, and
    # a misbinned point would move a mean by O(1)
    assert torch.equal(c, c_ref)
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
    if layout == "all_masked":
        assert not m.any() and not c.any()
    else:
        assert 0 < c.sum() < mask.sum()


@pytest.mark.cuda
def test_bev_bin_kernel_rejects_bad_inputs_on_card(cuda_device):
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(7, 1, 100, 16)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_mean(pts.double(), mask, PC_RANGE, 16)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_mean(pts[:, ::2], mask[:, ::2], PC_RANGE, 16)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_mean(pts, mask, PC_RANGE, 16, intensity_col=4)


def voxel_cloud(seed, b, n, grid, layout="spread", n_cols=4):
    """[b,n,n_cols] points 5% past the range on every side, a masked fifth,
    a third piled onto 30 spots (contended voxels), and points exactly on
    the float32 voxel borders of each axis of the first tile.  ``layout``
    "one_band" puts every point in the first 20 columns of y row 3 (one
    band); "all_masked" masks every point."""
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_geometry

    rng = np.random.RandomState(seed)
    lo, size = voxel_geometry(PC_RANGE, grid)
    span = size * np.asarray(grid, np.float32)
    pts = np.concatenate([rng.uniform(lo - 0.05 * span, lo + 1.05 * span,
                                      (b, n, 3)),
                          rng.rand(b, n, n_cols - 3)], -1).astype(np.float32)
    spots = rng.uniform(lo, lo + span, (30, 3))
    k = n // 3
    pts[:, -k:, :3] = spots[rng.randint(0, 30, (b, k))]
    start = 0
    for ax, dim in enumerate(grid):
        pts[0, start:start + dim + 1, ax] = \
            lo[ax] + np.arange(dim + 1, dtype=np.float32) * size[ax]
        start += dim + 1
    mask = rng.rand(b, n) > 0.2
    if layout == "one_band":
        pts[..., 0] = lo[0] + rng.uniform(0, 20, (b, n)) * size[0]
        pts[..., 1] = lo[1] + 3.5 * size[1]
    elif layout == "all_masked":
        mask[:] = False
    return torch.tensor(pts), torch.tensor(mask)


def test_voxel_binning_wrapper_takes_plain_version_only_on_cpu():
    from lanemapping_tpu_torch.kernels import voxel_bin

    pts, mask = voxel_cloud(8, 2, 3000, (24, 20, 5))
    before = voxel_bin.voxel_bin_mean.launches
    m = voxel_bin.voxel_bin_mean(pts, mask, PC_RANGE, (24, 20, 5))
    m_ref = voxel_bin.voxel_bin_mean_ref(pts, mask, PC_RANGE, (24, 20, 5))
    _, c = voxel_bin.voxel_bin_sums_ref(pts, mask, PC_RANGE, (24, 20, 5))
    assert voxel_bin.voxel_bin_mean.launches == before  # no kernel on CPU
    assert m.shape == (2, 20, 24, 5 * 4)
    assert torch.equal(m, m_ref)
    assert 0 < c.sum() < mask.sum()


def test_voxel_binning_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    rerouted to the plain version."""
    from lanemapping_tpu_torch.kernels import voxel_bin

    with pytest.raises(ValueError, match="unsupported device"):
        voxel_bin.voxel_bin_mean(torch.empty((1, 4, 4), device="meta"),
                                 torch.empty((1, 4), dtype=torch.bool,
                                             device="meta"), PC_RANGE,
                                 (8, 8, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("grid,layout,n_cols", [
    ((96, 96, 4), "spread", 4), ((576, 576, 10), "spread", 4),
    ((576, 576, 10), "one_band", 4), ((576, 576, 10), "all_masked", 4),
    ((576, 576, 10), "spread", 3), ((96, 96, 4), "spread", 6),
    ((41, 13, 3), "spread", 3),  # bands that start off 16-byte alignment
    ((2001, 8, 4), "spread", 4),  # 4 ragged x-chunks of a 160 KB row
    # wider than the 8 floats a record carries: (cell, point index) records
    ((576, 576, 10), "spread", 9), ((576, 576, 10), "spread", 12),
    ((576, 576, 10), "spread", 16), ((576, 576, 10), "spread", 24),
    ((576, 576, 10), "one_band", 12),
])
def test_voxel_bin_kernel_matches_plain_version_on_card(cuda_device, grid,
                                                        layout, n_cols):
    from lanemapping_tpu_torch.kernels import voxel_bin

    pts, mask = voxel_cloud(9, 3, 200000, grid, layout, n_cols)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    before = voxel_bin.voxel_bin_mean.launches
    m = voxel_bin.voxel_bin_mean(pts, mask, PC_RANGE, grid)
    m_ref = voxel_bin.voxel_bin_mean_ref(pts, mask, PC_RANGE, grid)
    torch.cuda.synchronize()
    assert voxel_bin.voxel_bin_mean.launches == before + 1
    # a misbinned point would move a mean by O(1); the sum order of
    # shared-memory atomics varies from run to run
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
    if layout == "all_masked":
        assert not m.any()
    else:
        assert m.any()


@pytest.mark.cuda
def test_voxel_bin_kernel_rejects_bad_inputs_on_card(cuda_device):
    from lanemapping_tpu_torch.kernels import voxel_bin

    grid = (16, 16, 4)
    pts, mask = voxel_cloud(10, 1, 100, grid)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    bad = [(pts.double(), mask), (pts[:, ::2], mask[:, ::2]),
           (pts[..., :2].contiguous(), mask), (pts, mask.float()),
           (pts, mask.cpu()), (pts[0], mask[0]),
           # one voxel column of 4 * (C + 1) floats beyond shared memory
           (torch.cat([pts] * 3750, -1), mask)]
    for p, m in bad:
        with pytest.raises(ValueError):
            voxel_bin.voxel_bin_mean(p, m, PC_RANGE, grid)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["bev_bin_mean", "voxel_bin_mean"])
def test_binning_kernels_take_points_off_16_byte_alignment(cuda_device,
                                                          kernel):
    """Contiguous [B,N,4] points whose storage starts 4 bytes past a
    16-byte boundary are read one float at a time, not as float4."""
    from lanemapping_tpu_torch.kernels import bev_bin, voxel_bin

    if kernel == "bev_bin_mean":
        pts, mask = cloud(11, 2, 50000, 64, "piled")
    else:
        pts, mask = voxel_cloud(12, 2, 50000, (40, 36, 5))
    buf = torch.empty(pts.numel() + 1, device=cuda_device)
    off = buf[1:].view(pts.shape)
    off.copy_(pts.to(cuda_device))
    mask = mask.to(cuda_device)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    if kernel == "bev_bin_mean":
        m, c = bev_bin.bev_bin_mean(off, mask, PC_RANGE, 64)
        m_ref, c_ref = bev_bin.bev_bin_mean_ref(off, mask, PC_RANGE, 64)
        torch.cuda.synchronize()
        assert torch.equal(c, c_ref) and c.any()
    else:
        m = voxel_bin.voxel_bin_mean(off, mask, PC_RANGE, (40, 36, 5))
        m_ref = voxel_bin.voxel_bin_mean_ref(off, mask, PC_RANGE, (40, 36, 5))
        torch.cuda.synchronize()
        assert m.any()
    torch.testing.assert_close(m, m_ref, rtol=1e-5, atol=1e-5)
