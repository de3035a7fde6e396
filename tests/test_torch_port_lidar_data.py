"""The port's copies of the host data modules against the JAX package:
``generate_dataset`` writes byte-identical files, the LaserLane datasets
give equal samples, and ``convert_las_directory`` writes the same PNGs."""

import filecmp
import os

import numpy as np
import pytest
from torch_port_helpers import TINY, TINY_LIDAR, configs


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same synthetic dataset written by each package (192 px tiles,
    4096-point clouds, transform params)."""
    from lanemapping_tpu.data.synthetic import generate_dataset as gen_j
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    roots = {}
    for name, gen in (("jax", gen_j), ("port", generate_dataset)):
        roots[name] = str(tmp_path_factory.mktemp(name))
        gen(roots[name], n_tiles=3, img=192, seed=3, with_params=True,
            with_points=True, points_per_tile=4096)
    return roots


def test_generate_dataset_writes_identical_files(datasets):
    a, b = datasets["jax"], datasets["port"]
    files = tree_files(a)
    assert files == tree_files(b)
    assert len(files) == 3 * 8 + 1  # png, 5 labels, params, las; split
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors


def test_hard_geometry_writes_identical_files(tmp_path):
    from lanemapping_tpu.data.synthetic import generate_dataset as gen_j
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    gen_j(str(tmp_path / "j"), n_tiles=2, img=192, seed=4, hard=True)
    generate_dataset(str(tmp_path / "t"), n_tiles=2, img=192, seed=4,
                     hard=True)
    files = tree_files(tmp_path / "j")
    assert files == tree_files(tmp_path / "t")
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "j", tmp_path / "t",
                                           files, shallow=False)
    assert not mismatch and not errors


def assert_same_sample(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["infer_only", "test"])
@pytest.mark.parametrize("dataset", ["LaserLaneProposalEgo",
                                     "LaserLaneProposal"])
def test_laserlane_samples_match_jax(datasets, dataset, mode):
    from lanemapping_tpu.registry import DATASETS as DATASETS_J
    from lanemapping_tpu_torch.registry import DATASETS

    cfg_j, cfg_t = configs(TINY_LIDAR if dataset.endswith("Ego") else TINY)
    root = datasets["port"]
    ds_j = DATASETS_J.get(dataset)(root, mode=mode, cfg=cfg_j)
    ds_t = DATASETS.get(dataset)(root, mode=mode, cfg=cfg_t)
    # "test" shuffles its stems with the global `random`: compare by stem
    assert sorted(ds_t.stems) == sorted(ds_j.stems)
    for i, stem in enumerate(ds_t.stems):
        got = ds_t[i]
        want = ds_j[ds_j.stems.index(stem)]
        assert_same_sample(got, want)
    if dataset.endswith("Ego"):
        assert got["points"].shape == (cfg_t.max_points, 4)
        assert got["points_mask"].sum() == 4096
    # infer_only skips the label build (`laserlane.py:223-227`)
    assert ("prop_ext" in got) == (mode == "test")


def test_convert_las_directory_writes_jax_pngs(datasets, tmp_path):
    """Both packages rasterize the same clouds; float32 rounding of the
    calibrated value may land a pixel on the other side of a .5 before the
    uint8 round: at most 1 LSB on at most 0.1% of the pixels."""
    from PIL import Image
    from lanemapping_tpu.tools.las2bev import convert_las_directory as conv_j
    from lanemapping_tpu_torch.tools.las2bev import convert_las_directory

    las_dir = os.path.join(datasets["port"], "las")
    kw = dict(img=192, max_points=4096, batch=2)
    rec_j = conv_j(las_dir, str(tmp_path / "j"), **kw)
    rec_t = convert_las_directory(las_dir, str(tmp_path / "t"), device="cpu",
                                  **kw)
    assert rec_t["n_tiles"] == rec_j["n_tiles"] == 3
    assert rec_t["n_points"] == rec_j["n_points"]
    for pj, pt in zip(rec_j["written"], rec_t["written"]):
        assert os.path.basename(pj) == os.path.basename(pt)
        a = np.asarray(Image.open(pj)).astype(int)
        b = np.asarray(Image.open(pt)).astype(int)
        assert a.shape == b.shape == (192, 192, 3)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
