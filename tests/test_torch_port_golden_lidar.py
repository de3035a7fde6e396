"""The golden set's point-cloud paths at full width (2^19-point clouds):
P3, the flagship ``--from-las`` in float32 (Las2BEV on K1's plain version
here), and P4, the LiDAR config as the stream serves it (the 576x576x10
z-fold grid on K1z's plain version here; ``tests/torch_port_golden.py``).

- The manifest's LiDAR weights are ``random_variables``' bit for bit.
- The stored set is what the JAX package computes now (floats within
  rel-max 1e-5, lane structure identical, columns within 1e-3 px).
- The port on the CPU meets the golden bars: P3's BEV tile within abs
  1e-5 everywhere (measured: 1.8e-7) and its count map exact, P4's grid
  row sums within rel 1e-6 of the row's magnitudes (measured: 2.0e-8),
  sampled cells within abs 1e-5 (measured: 3.8e-6) and its occupancy
  exact, head outputs within rel-max 2e-3 (measured: <= 2.2e-5) and the
  lanes as in P1.
- Both packages bin a point on a cell border into the same cell: the JAX
  package's jitted programs multiply by the float32 reciprocal of the cell
  size (XLA's rewrite of the division by a constant), and so does the
  port.
- ``tests/torch_port_golden.py``, which the card machine loads, imports
  neither JAX nor the JAX package, and the set stays under 10 MB.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_port_golden as G
import torch_port_make_golden as M
from torch_port_helpers import REPO, lidar_example, random_variables

PC_RANGE = (-15.0, -25.0, -2.0, 15.0, 25.0, 2.0)


def test_draw_variables_equals_random_variables_lidar():
    import lanemapping_tpu as lm
    manifest = G.load_manifest("lidar")
    assert manifest == M.manifest("lidar")
    cfg = lm.Config.fromfile(f"{G.REPO}/{G.CONFIGS['lidar']}")
    want = random_variables(lm.build_model(cfg), (lidar_example(G.N_POINTS),),
                            G.WEIGHT_SEEDS["lidar"])
    got = G.draw_variables(manifest, G.WEIGHT_SEEDS["lidar"])
    got_l, want_l = G.flat_leaves(got), G.flat_leaves(want)
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    assert len(got_l) == len(manifest["leaves"]) > 100
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype == np.float32, path
        assert np.array_equal(a, b), path


def test_golden_clouds_are_the_generators():
    from lanemapping_tpu.data import synthetic as syn_j
    from lanemapping_tpu_torch.data import synthetic as syn_t
    meta = G.load_meta()["inputs"]
    for kind in ("las_cloud", "lidar_cloud"):
        for syn in (syn_j, syn_t):
            for a, want in zip(G.golden_cloud(syn, G.SEEDS[kind]),
                               meta[kind]):
                G.check_digest(a, want, f"{kind} of {syn.__name__}")


def test_golden_p3_is_what_jax_computes_now():
    rec, info = M.p3(*M.inputs()["las_cloud"], screened=False)
    G.check_regen(G.regen_errors(rec, G.load_golden("p3")), "P3")
    meta = G.load_meta()["paths"]["p3"]
    assert info["bev_counts"] == meta["bev_counts"]
    for margin, unstable in meta["screen"]:
        assert margin > M.MARGIN and unstable == 0


def test_golden_p4_is_what_jax_computes_now():
    rec, _ = M.p4(*M.inputs()["lidar_cloud"], screened=False)
    G.check_regen(G.regen_errors(rec, G.load_golden("p4")), "P4")
    for margin, unstable in G.load_meta()["paths"]["p4"]["screen"]:
        assert margin > M.MARGIN and unstable == 0


def test_port_p3_meets_the_golden_bars():
    run = G.run_p3("cpu")
    fig = G.hold_p3(run, G.load_golden("p3"), "P3 on the CPU")
    assert fig["lanes"]["lanes"] == fig["lanes"]["lanes_golden"]


def test_port_p4_meets_the_golden_bars():
    run = G.run_p4("cpu")
    assert run["grid"].shape == (576, 576, 40)
    fig = G.hold_p4(run, G.load_golden("p4"), "P4 on the CPU")
    assert fig["voxels"]["nonzero"] > 10 ** 6


def border_points(n, dims, seed):
    """[n, 4] float32 points at float32 multiples of the cell size of each
    axis (``dims`` cells over ``PC_RANGE``): on or within an ulp of a cell
    border, where a division and a product with the reciprocal disagree."""
    rng = np.random.RandomState(seed)
    d = len(dims)
    lo = np.asarray(PC_RANGE[:d], np.float32)
    size = (np.asarray(PC_RANGE[3:3 + d], np.float32) - lo) \
        / np.asarray(dims, np.float32)
    k = rng.randint(0, 1 << 20, (n, d)) % np.asarray(dims)
    xy = lo + k.astype(np.float32) * size
    pts = np.zeros((n, 4), np.float32)
    pts[:, :d] = xy
    pts[:, 3] = rng.rand(n)
    if d == 2:
        pts[:, 2] = rng.uniform(-1.0, 1.0, n)
    # the case exists in this set
    assert (np.floor((xy - lo) / size)
            != np.floor((xy - lo) * (np.float32(1) / size))).any()
    return pts


def test_binning_matches_the_jitted_jax_package_on_cell_borders():
    """K1's and K1z's plain versions (the kernels use the same arithmetic)
    against the JAX package's rasterizer and voxelizer as its programs run
    them, under ``jax.jit``: the same cells for points on cell borders."""
    from lanemapping_tpu.ops.voxelize import (point_voxel_ids,
                                              rasterize_bev_intensity)
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_mean_ref
    from lanemapping_tpu_torch.ops.voxelize import \
        point_voxel_ids as ids_t

    img, grid = 1152, (576, 576, 10)
    pts = border_points(200_000, (img, img), 1)
    mask = np.ones(len(pts), bool)
    _, want = jax.jit(lambda p, m: rasterize_bev_intensity(
        p, m, PC_RANGE, img, flip_rows=True))(pts, mask)
    _, eager = rasterize_bev_intensity(jnp.asarray(pts), jnp.asarray(mask),
                                       PC_RANGE, img, flip_rows=True)
    _, got = bev_bin_mean_ref(torch.from_numpy(pts)[None],
                              torch.from_numpy(mask)[None], PC_RANGE, img,
                              flip_rows=True)
    assert not np.array_equal(np.asarray(want), np.asarray(eager))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))

    pts = border_points(200_000, grid, 2)
    want_ids, want_ok = jax.jit(lambda p: point_voxel_ids(
        p, PC_RANGE, grid))(pts)
    eager_ids, _ = point_voxel_ids(jnp.asarray(pts), PC_RANGE, grid)
    got_ids, got_ok = ids_t(torch.from_numpy(pts), PC_RANGE, grid)
    assert (np.asarray(want_ids) != np.asarray(eager_ids)).sum() > 100
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))


def test_golden_module_imports_no_jax_and_the_set_is_small():
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_port_golden as G\n"
            "G.load_golden('p1'); G.load_meta()\n"
            "G.draw_variables(G.load_manifest('lidar'), 1)\n"
            "G.load_train_golden('t3'); G.golden_adam('lidar')\n"
            "G.digest_plan({'a': (3, 5), 'b': (700,)})\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'optax', 'lanemapping_tpu'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout
    serving = ["flagship_variables.json", "golden.json",
               "lidar_variables.json", *G.PATHS.values()]
    training = [G.TRAIN_META, *G.TRAIN_PATHS.values()]
    names = sorted(os.listdir(G.GOLDEN_DIR))
    assert names == sorted(serving + training)
    size = [sum(os.path.getsize(os.path.join(G.GOLDEN_DIR, n)) for n in ns)
            for ns in (serving, training)]
    assert size[0] <= 10 * 10 ** 6 and size[1] <= 6 * 10 ** 6, size
