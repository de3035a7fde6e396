"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the no-fallback rule of their wrappers.

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


def cloud(seed, b, n, img):
    """[b,n,4] points over and past the range, a masked fifth, and points
    exactly on the float32 cell borders of the first tile."""
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
    return torch.tensor(pts), torch.tensor(rng.rand(b, n) > 0.2)


def test_binning_wrapper_takes_plain_version_only_on_cpu():
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(5, 2, 2000, 32)
    before = bev_bin.bev_bin_sums.launches
    s, c = bev_bin.bev_bin_sums(pts, mask, PC_RANGE, 32)
    s_ref, c_ref = bev_bin.bev_bin_sums_ref(pts, mask, PC_RANGE, 32)
    assert bev_bin.bev_bin_sums.launches == before  # no kernel on the CPU
    assert torch.equal(s, s_ref) and torch.equal(c, c_ref)
    assert 0 < c.sum() < mask.sum()


def test_binning_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    rerouted to the plain version."""
    from lanemapping_tpu_torch.kernels import bev_bin

    with pytest.raises(ValueError, match="unsupported device"):
        bev_bin.bev_bin_sums(torch.empty((1, 4, 4), device="meta"),
                             torch.empty((1, 4), dtype=torch.bool,
                                         device="meta"), PC_RANGE, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("flip_rows", [False, True])
def test_bev_bin_kernel_matches_plain_version_on_card(cuda_device,
                                                      flip_rows):
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(6, 3, 300000, 256)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    before = bev_bin.bev_bin_sums.launches
    s, c = bev_bin.bev_bin_sums(pts, mask, PC_RANGE, 256,
                                flip_rows=flip_rows)
    s_ref, c_ref = bev_bin.bev_bin_sums_ref(pts, mask, PC_RANGE, 256,
                                            flip_rows=flip_rows)
    torch.cuda.synchronize()
    assert bev_bin.bev_bin_sums.launches == before + 1
    assert torch.equal(c, c_ref)  # counts are exact
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bev_bin_kernel_rejects_bad_inputs_on_card(cuda_device):
    from lanemapping_tpu_torch.kernels import bev_bin

    pts, mask = cloud(7, 1, 100, 16)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_sums(pts.double(), mask, PC_RANGE, 16)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_sums(pts[:, ::2], mask[:, ::2], PC_RANGE, 16)
    with pytest.raises(ValueError):
        bev_bin.bev_bin_sums(pts, mask, PC_RANGE, 16, intensity_col=4)


def voxel_cloud(seed, b, n, grid):
    """[b,n,4] points 5% past the range on every side, a masked fifth, a
    third piled onto 30 spots (contended voxels), and points exactly on the
    float32 voxel borders of each axis of the first tile."""
    from lanemapping_tpu_torch.kernels.voxel_bin import voxel_geometry

    rng = np.random.RandomState(seed)
    lo, size = voxel_geometry(PC_RANGE, grid)
    span = size * np.asarray(grid, np.float32)
    pts = np.concatenate([rng.uniform(lo - 0.05 * span, lo + 1.05 * span,
                                      (b, n, 3)),
                          rng.rand(b, n, 1)], -1).astype(np.float32)
    spots = rng.uniform(lo, lo + span, (30, 3))
    k = n // 3
    pts[:, -k:, :3] = spots[rng.randint(0, 30, (b, k))]
    start = 0
    for ax, dim in enumerate(grid):
        pts[0, start:start + dim + 1, ax] = \
            lo[ax] + np.arange(dim + 1, dtype=np.float32) * size[ax]
        start += dim + 1
    return torch.tensor(pts), torch.tensor(rng.rand(b, n) > 0.2)


def test_voxel_binning_wrapper_takes_plain_version_only_on_cpu():
    from lanemapping_tpu_torch.kernels import voxel_bin

    pts, mask = voxel_cloud(8, 2, 3000, (24, 20, 5))
    before = voxel_bin.voxel_bin_sums.launches
    s, c = voxel_bin.voxel_bin_sums(pts, mask, PC_RANGE, (24, 20, 5))
    s_ref, c_ref = voxel_bin.voxel_bin_sums_ref(pts, mask, PC_RANGE,
                                                (24, 20, 5))
    assert voxel_bin.voxel_bin_sums.launches == before  # no kernel on CPU
    assert s.shape == (2, 20, 24, 5, 4) and c.shape == (2, 20, 24, 5)
    assert torch.equal(s, s_ref) and torch.equal(c, c_ref)
    assert 0 < c.sum() < mask.sum()


def test_voxel_binning_wrapper_refuses_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    rerouted to the plain version."""
    from lanemapping_tpu_torch.kernels import voxel_bin

    with pytest.raises(ValueError, match="unsupported device"):
        voxel_bin.voxel_bin_sums(torch.empty((1, 4, 4), device="meta"),
                                 torch.empty((1, 4), dtype=torch.bool,
                                             device="meta"), PC_RANGE,
                                 (8, 8, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(96, 96, 4), (576, 576, 10)])
def test_voxel_bin_kernel_matches_plain_version_on_card(cuda_device, grid):
    from lanemapping_tpu_torch.kernels import voxel_bin

    pts, mask = voxel_cloud(9, 3, 200000, grid)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    before = voxel_bin.voxel_bin_sums.launches
    s, c = voxel_bin.voxel_bin_sums(pts, mask, PC_RANGE, grid)
    s_ref, c_ref = voxel_bin.voxel_bin_sums_ref(pts, mask, PC_RANGE, grid)
    torch.cuda.synchronize()
    assert voxel_bin.voxel_bin_sums.launches == before + 1
    assert torch.equal(c, c_ref)  # counts are exact
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)
    assert 0 < c.sum() < mask.sum()


@pytest.mark.cuda
def test_voxel_bin_kernel_rejects_bad_inputs_on_card(cuda_device):
    from lanemapping_tpu_torch.kernels import voxel_bin

    grid = (16, 16, 4)
    pts, mask = voxel_cloud(10, 1, 100, grid)
    pts, mask = pts.to(cuda_device), mask.to(cuda_device)
    bad = [(pts.double(), mask), (pts[:, ::2], mask[:, ::2]),
           (pts[..., :2].contiguous(), mask), (pts, mask.float()),
           (pts, mask.cpu()), (pts[0], mask[0])]
    for p, m in bad:
        with pytest.raises(ValueError):
            voxel_bin.voxel_bin_sums(p, m, PC_RANGE, grid)
