"""Shape limits of the port that the JAX package does not have, and their
repairs, on the CPU.

- ``ops/interp.py::resize_bilinear_ac`` splits a resize whose input or
  output reaches ``RESIZE_MAX_ELEMENTS`` (PyTorch's channels-last bilinear
  kernels on a card refuse 2^31 - 1 elements; the FPN's [B,256,288,288]
  maps reach it at 102 tiles).  The tests lower the threshold so that
  tiny shapes split, and hold the split to one call bit for bit (output
  and input gradient), and the tiny flagship, with every resize split, to
  JAX at ``test_torch_port_models.py``'s rel-max 2e-3.
- K1z (``kernels/voxel_bin.py``) takes more than 8 columns on the card
  through (cell, point index) records; its plain version, the CPU path
  and the kernel's oracle, is held at C = 12 to the JAX voxelizer and to
  the TPU kernel's z-fold wrapper in interpret mode, means within rtol
  1e-5 / atol 1e-6 (the sum order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch_port_helpers import jax_apply, rel_max_err, tiny_models

TOL = 2e-3  # test_torch_port_models.py's bar, float32
PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)


class Upsamples(TorchDispatchMode):
    """Records the input shape of every bilinear upsample op, forward
    (``upsample_bilinear2d``, ``.out``) and backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("aten.upsample_bilinear2d"):
            self.calls.append((str(func), tuple(args[0].shape)))
        return func(*args, **(kwargs or {}))


def channels_last_input(dtype, seed=0):
    x = torch.tensor(np.random.RandomState(seed).randn(7, 16, 9, 10),
                     dtype=torch.float32).to(dtype)
    return x.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("grad", [True, False], ids=["autograd", "no_grad"])
def test_split_resize_is_bit_identical_to_one_call(monkeypatch, dtype, grad):
    from lanemapping_tpu_torch.ops import interp

    x0 = channels_last_input(dtype)
    ref_x = x0.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        want = F.interpolate(ref_x, size=(20, 23), mode="bilinear",
                             align_corners=True)
    # 3 samples of [16,20,23] a slice: slices of 3, 3 and 1
    monkeypatch.setattr(interp, "RESIZE_MAX_ELEMENTS", 16 * 20 * 23 * 3 + 1)
    x = x0.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad), Upsamples() as ups:
        got = interp.resize_bilinear_ac(x, 20, 23)
    assert [s[0] for _, s in ups.calls] == [3, 3, 1]
    assert torch.equal(got, want)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    if grad:
        g = torch.tensor(np.random.RandomState(1).randn(*want.shape),
                         dtype=torch.float32).to(dtype)
        want.backward(g)
        with Upsamples() as ups:
            got.backward(g)
        assert [s[0] for _, s in ups.calls] == [1, 3, 3]  # reverse order
        assert torch.equal(x.grad, ref_x.grad)
        assert x.grad.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("over", [0, 1], ids=["below", "at"])
def test_resize_splits_only_at_the_threshold(monkeypatch, over):
    """One call while input and output stay below the threshold (the
    output, 7 x 16 x 20 x 23, decides here); two slices at it.  A
    downsample is decided by its input."""
    from lanemapping_tpu_torch.ops import interp

    x = channels_last_input(torch.float32)
    n_out = 7 * 16 * 20 * 23
    monkeypatch.setattr(interp, "RESIZE_MAX_ELEMENTS", n_out + 1 - over)
    with torch.no_grad(), Upsamples() as ups:
        interp.resize_bilinear_ac(x, 20, 23)
    assert [s[0] for _, s in ups.calls] == ([7] if not over else [6, 1])
    monkeypatch.setattr(interp, "RESIZE_MAX_ELEMENTS", x.numel() + 1 - over)
    with torch.no_grad(), Upsamples() as ups:
        got = interp.resize_bilinear_ac(x, 4, 5)
    assert [s[0] for _, s in ups.calls] == ([7] if not over else [6, 1])
    assert torch.equal(got, F.interpolate(x, size=(4, 5), mode="bilinear",
                                          align_corners=True))


@pytest.mark.parametrize("endp_mode", ["endp_est", "endpoint"])
def test_tiny_flagship_with_every_resize_split_matches_jax(monkeypatch,
                                                           endp_mode):
    """Every resize of the tiny Detector1stage split into single samples:
    the FPN's ``up_add`` and pyramid ``up``, ``bi_seg`` and ``endp``, the
    column head's 2S and (``endp_mode="endpoint"``) 8S.  Each output
    equals the unsplit forward's bit for bit and JAX's within rel-max
    2e-3."""
    from lanemapping_tpu_torch.ops import interp

    jmodel, variables, tmodel, _, _ = tiny_models(seed=0,
                                                  endp_mode=endp_mode)
    x = np.random.RandomState(5).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad(), Upsamples() as whole:
        unsplit = tmodel(torch.tensor(x))
    monkeypatch.setattr(interp, "RESIZE_MAX_ELEMENTS", 1)
    with torch.no_grad(), Upsamples() as ups:
        got = tmodel(torch.tensor(x))
    # the FPN's top-down and pyramid resizes, bi_seg, endp and the head's
    # 2S: 8 calls; the head's 8S in "endpoint" mode: 9
    assert len(whole.calls) == {"endp_est": 8, "endpoint": 9}[endp_mode]
    assert all(s[0] == 2 for _, s in whole.calls)
    assert len(ups.calls) == 2 * len(whole.calls)
    assert all(s[0] == 1 for _, s in ups.calls)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], unsplit[k]), k
        assert rel_max_err(got[k].numpy(), want[k]) < TOL, k


def test_plain_zfold_mean_at_twelve_columns_matches_jax_and_pallas_oracle():
    """K1z's plain version at C = 12 (beyond the 8 floats the kernel's
    record carries whole) against the JAX voxelizer, which takes any C,
    and the TPU kernel's z-fold wrapper in interpret mode, one pass per
    column."""
    from lanemapping_tpu.ops.voxelize import voxelize_bev_zfold as zfold_j
    from pallas_reference_bev import voxelize_bev_zfold_pallas
    from lanemapping_tpu_torch.kernels.voxel_bin import (record_floats,
                                                         voxel_bin_mean_ref,
                                                         voxel_geometry)

    grid = (96, 96, 4)
    rng = np.random.RandomState(12)
    lo, size = voxel_geometry(PC_RANGE, grid)
    span = size * np.asarray(grid, np.float32)
    n, k = 4000, 1333
    xyz = rng.uniform(lo - 0.05 * span, lo + 1.05 * span, (2, n, 3))
    spots = rng.uniform(lo, lo + span, (40, 3))  # voxels of many points
    xyz[:, -k:] = spots[rng.randint(0, 40, (2, k))]
    pts = np.concatenate([xyz, rng.randn(2, n, 9)], -1).astype(np.float32)
    mask = rng.rand(2, n) > 0.2
    assert record_floats(12) == 2  # (cell, point index) records on a card
    got = voxel_bin_mean_ref(torch.tensor(pts), torch.tensor(mask),
                             PC_RANGE, grid).numpy()
    assert got.shape == (2, 96, 96, 4 * 12)
    want = jax.vmap(lambda p, m: zfold_j(p, m, PC_RANGE, grid))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    want_p = voxelize_bev_zfold_pallas(jnp.asarray(pts[0]),
                                       jnp.asarray(mask[0]), PC_RANGE, grid,
                                       interpret=True, capacity=1024)
    np.testing.assert_allclose(got[0], np.asarray(want_p), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(got).max() > 0


def test_batch_ceiling_bisects_to_the_first_failed_batch():
    """`tools/batch_ceiling.py` runs batches in order until one fails, then
    halves the gap: with every batch above 37 out of memory, 32 and 64
    lead to 48, 40, 36, 38, 37."""
    from lanemapping_tpu_torch.tools import batch_ceiling
    from lanemapping_tpu_torch.tools.train_mfu_sweep import parse_cell

    seen = []

    def run(b):
        seen.append(b)
        if b > 37:
            return parse_cell(
                b, None, 1, "", "Traceback ...\ntorch.OutOfMemoryError: CUDA "
                "out of memory. Tried to allocate 4.00 GiB", 1.0)
        return parse_cell(
            b, None, 0, '{"value": 200.0, "unit": "tiles/s", '
            '"hbm_highwater_gb": 1.5, "digest_mean": 0.5}', "", 1.0)

    rec = batch_ceiling.find_ceiling([16, 32, 64, 128], run)
    assert seen == [16, 32, 64, 48, 40, 36, 38, 37]
    assert (rec["ceiling"], rec["first_failed"]) == (37, 38)
    assert rec["set_by"] == ("out of memory: torch.OutOfMemoryError: CUDA "
                             "out of memory. Tried to allocate 4.00 GiB")
    assert rec["cells"][0]["tiles_per_sec"] == 200.0
    assert rec["cells"][0]["digest_mean"] == 0.5
    seen.clear()
    rec = batch_ceiling.find_ceiling([32, 64], run, resolution=4)
    assert seen == [32, 64, 48, 40, 36]
    assert (rec["ceiling"], rec["first_failed"]) == (36, 40)


def test_batch_ceiling_tells_a_refusal_from_out_of_memory():
    from lanemapping_tpu_torch.tools import batch_ceiling
    from lanemapping_tpu_torch.tools.train_mfu_sweep import parse_cell

    msg = ("RuntimeError: upsample_bilinear2d_nhwc only supports output "
           "tensors with less than INT_MAX elements, but got [102, 256, "
           "288, 288]")
    cell = parse_cell(102, None, 1, "", "Traceback\n  File x\n" + msg, 2.0)
    assert cell["rc"] == 1 and not cell["oom"]
    rec = batch_ceiling.find_ceiling([102], lambda b: cell)
    assert rec["ceiling"] is None and rec["set_by"] == "refused: " + msg
    assert rec["first_failed"] == 102 and rec["cells"] == [cell]


def test_batch_ceiling_runs_bench_children_on_cpu(tmp_path):
    """One serving cell of the tiny config through a real bench child."""
    import json
    import os
    from lanemapping_tpu_torch.tools import batch_ceiling
    from torch_port_helpers import REPO

    out = tmp_path / "ceiling.json"
    rec = batch_ceiling.main([
        "--batches", "2", "--config", os.path.join(REPO, "configs",
                                                   "tiny_test.py"),
        "--bench-args", "--iters 1 --warmup 0", "--out", str(out),
        "--device", "cpu"])
    (cell,) = rec["cells"]
    assert "error" not in cell and cell["tiles_per_sec"] > 0
    assert np.isfinite(cell["digest_mean"]) and rec["mode"] == "serving"
    assert (rec["ceiling"], rec["first_failed"]) == (2, None)
    assert json.loads(out.read_text()) == rec
