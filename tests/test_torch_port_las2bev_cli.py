"""The port's Las2BEV command line against the JAX package's root script:
the same arguments, the same PNGs (float32 rounding of the calibrated value
may put a pixel on the other side of a .5 before the uint8 round: at most 1
LSB on at most 0.1% of the pixels, the bar of
``test_torch_port_lidar_data.py::test_convert_las_directory_writes_jax_pngs``)
and the same JSON stats."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from torch_port_helpers import REPO

ARGS = ["--img", "192", "--max-points", "4096", "--batch", "2",
        "--fill-iters", "4"]


@pytest.fixture(scope="module")
def las_dir(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("las_root"))
    generate_dataset(root, n_tiles=3, img=192, seed=3, with_params=True,
                     with_points=True, points_per_tile=4096)
    return os.path.join(root, "las")


def run(cmd, out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, *cmd, out_dir, *ARGS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def test_port_cli_writes_the_root_scripts_pngs(las_dir, tmp_path):
    from PIL import Image

    want = run([os.path.join("tools", "las2bev.py"), las_dir],
               str(tmp_path / "jax"))
    got = run(["-m", "lanemapping_tpu_torch.tools.las2bev", las_dir,
               "--device", "cpu"], str(tmp_path / "port"))
    assert set(got) == set(want) and "written" not in got
    assert got["n_tiles"] == want["n_tiles"] == 3
    assert got["n_points"] == want["n_points"] == 3 * 4096
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 3
    for n in names:
        a = np.asarray(Image.open(tmp_path / "jax" / n)).astype(int)
        b = np.asarray(Image.open(tmp_path / "port" / n)).astype(int)
        assert a.shape == b.shape == (192, 192, 3)
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_port_cli_refuses_the_card_without_one(las_dir, tmp_path):
    """``--device`` defaults to the card, and there is none here: the
    command fails rather than run on the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    done = subprocess.run(
        [sys.executable, "-m", "lanemapping_tpu_torch.tools.las2bev",
         las_dir, str(tmp_path / "out"), *ARGS], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert "device='cpu'" in done.stderr
    assert not os.path.exists(tmp_path / "out") \
        or not os.listdir(tmp_path / "out")
