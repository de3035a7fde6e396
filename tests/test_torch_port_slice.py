"""The port's whole slice against the JAX package, and its boundaries.

One seeded lane-structured cloud, written with ``write_las_points``, goes
raw LAS -> BEV tile -> tiny-config network -> decode -> host postprocess ->
lane records through the port's entry points (``LasTiles``,
``bev_image_from_points``, ``LaneMapper.map_arrays``) and through the JAX
chain (``bev_image_from_points`` -> ``model.apply`` -> ``decode_lanes`` ->
``lane_maps_from_decode`` -> ``lane_records``), with the same weights.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (REPO, TINY, assert_clear_of_thresholds,
                                assert_same_records, tiny_models)

N_POINTS = 1 << 15
# seed 0's decoded values sit clear of every decision threshold (asserted
# below), so float32 rounding differences between the packages cannot flip
# a vertex, a proposal or a tracker cell
SEED = 0


def write_clouds(root, n, img=192):
    from lanemapping_tpu_torch.data.las import write_las_points
    from lanemapping_tpu_torch.data.synthetic import (lane_structured_points,
                                                      random_lane_seqs)

    os.makedirs(os.path.join(root, "las"), exist_ok=True)
    for i in range(n):
        rng = np.random.RandomState(SEED + i)
        seqs = random_lane_seqs(rng, img=img, n_lanes=4)
        pts = lane_structured_points(seqs, [1, 2, 1, 1], img, rng, N_POINTS)
        write_las_points(os.path.join(root, "las", f"t{i}.las"), pts)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("las"))
    write_clouds(root, 2)
    jmodel, variables, tmodel, cfg_j, cfg_t = tiny_models(seed=1)
    ckpt = os.path.join(root, "tiny.pth")
    torch.save(tmodel.state_dict(), ckpt)
    return root, ckpt, jmodel, variables, cfg_j, cfg_t


def jax_chain(root, jmodel, variables, cfg):
    from lanemapping_tpu.data.las import load_lidar_points, pad_points
    from lanemapping_tpu.decode.lane_decode import decode_lanes, \
        host_decode_view
    from lanemapping_tpu.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu.ops.voxelize import bev_image_from_points
    from lanemapping_tpu.tools.export_lanes import lane_records
    from lanemapping_tpu.tools.las2bev import las2bev_params

    p = las2bev_params(cfg)
    bufs = [pad_points(load_lidar_points(os.path.join(root, "las",
                                                      f"t{i}.las")), N_POINTS)
            for i in range(2)]
    pts = jnp.asarray(np.stack([b[0] for b in bufs]))
    msk = jnp.asarray(np.stack([b[1] for b in bufs]))

    @jax.jit
    def run(v, pts, msk):
        x = jax.vmap(lambda a, m: bev_image_from_points(
            a, m, p["pc_range"], 192, gain=p["gain"], bias=p["bias"],
            fill_iters=p["fill_iters"]))(pts, msk)
        x3 = jnp.broadcast_to(x[..., None], x.shape + (3,))
        dec = decode_lanes(jmodel.apply(v, x3, train=False), cfg)
        return x, dec

    cfg.endp_decode = "exact_topk"
    x, dec = jax.device_get(run(variables, pts, msk))
    maps = lane_maps_from_decode(host_decode_view(dec), cfg)
    return x, dec, [lane_records(m) for m in maps["cls_offset_smooth"]]


def test_slice_las_to_lane_records_matches_jax(slice_setup):
    from lanemapping_tpu_torch import LaneMapper
    from lanemapping_tpu_torch.data.las_tiles import LasTiles
    from lanemapping_tpu_torch.data.loader import Loader
    from lanemapping_tpu_torch.ops.voxelize import bev_image_from_points
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params

    root, ckpt, jmodel, variables, cfg_j, cfg_t = slice_setup
    x_j, dec_j, recs_j = jax_chain(root, jmodel, variables, cfg_j)
    assert_clear_of_thresholds(dec_j, cfg_j)
    assert sum(map(len, recs_j)) >= 2

    batch = next(iter(Loader(LasTiles(root, max_points=N_POINTS),
                             batch_size=2, shuffle=False)))
    p = las2bev_params(cfg_t)
    x = bev_image_from_points(torch.tensor(batch["points"]),
                              torch.tensor(batch["points_mask"]),
                              p["pc_range"], 192, gain=p["gain"],
                              bias=p["bias"], fill_iters=p["fill_iters"])
    np.testing.assert_allclose(x.numpy(), x_j, rtol=1e-5, atol=1e-6)
    mapper = LaneMapper(cfg_t, ckpt=ckpt, device="cpu")
    tiles = x[..., None].expand(*x.shape, 3).numpy()
    recs = [r["lanes"] for r in mapper.map_arrays(tiles)]
    assert_same_records(recs, recs_j)


def test_stream_map_cli_writes_one_lane_json_per_tile(slice_setup, tmp_path):
    from lanemapping_tpu_torch.tools import stream_map

    root, ckpt = slice_setup[:2]
    rec = stream_map.main([TINY, root, "--from-las", "--device", "cpu",
                           "--ckpt", ckpt, "--out", str(tmp_path),
                           f"max_points={N_POINTS}"])
    assert rec["n_tiles"] == 2 and rec["device"] == "cpu"
    assert set(rec["stage_ms_per_batch"]) >= {"rasterize", "forward",
                                              "decode", "postprocess_host"}
    names = sorted(os.listdir(tmp_path / "lanes_2d"))
    assert names == ["t0.json", "t1.json"]
    for n in names:
        recs = json.load(open(tmp_path / "lanes_2d" / n))
        for r in recs:
            seq = np.asarray(r["seq"], np.float64)
            assert np.isfinite(seq).all() and r["seq_len"] == len(seq)
    assert sum(len(json.load(open(tmp_path / "lanes_2d" / n)))
               for n in names) >= 2


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lanemapping_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ['kernels.voxel_bin', 'models.lidar_encoder',\n"
        "       'data.laserlane', 'data.label_gen', 'data.proposal_gt',\n"
        "       'data.synthetic', 'engine.state', 'tools.las2bev',\n"
        "       'tools.stream_map', 'ops.losses', 'models.norm',\n"
        "       'models.head_losses', 'engine.optimizer',\n"
        "       'engine.checkpoint', 'engine.runner', 'utils.metrics',\n"
        "       'utils.skeleton', 'tools.train', 'models.legacy',\n"
        "       'models.row_head', 'decode.row_decode', 'decode.seg_infer',\n"
        "       'utils.vis_utils', 'tools.infer', 'utils.io_utils',\n"
        "       'tools.img2pc', 'tools.merge_lines', 'tools.convert_data',\n"
        "       'models.transformer', 'models.column_head',\n"
        "       'models.row_head_base', 'models.resnet_fpn_family',\n"
        "       'models.swin', 'utils.logger', 'parallel.dist',\n"
        "       'parallel.mesh', 'tools.multihost_test']\n"
        "missing = [m for m in new\n"
        "           if p.__name__ + '.' + m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'optax', 'orbax',\n"
        "                                    'lanemapping_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'cv2' not in sys.modules  # drawing imports it lazily\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


def test_registries_hold_the_jax_package_names():
    """The port builds every model the JAX package registers: the same
    names in BACKBONE, HEADS, PCENCODER and NET (24 in all)."""
    import lanemapping_tpu.registry as jr
    import lanemapping_tpu_torch.registry as tr

    n = 0
    for reg in ("BACKBONE", "HEADS", "PCENCODER", "NET"):
        names = set(getattr(tr, reg).module_dict)
        assert names == set(getattr(jr, reg).module_dict), reg
        n += len(names)
    assert n == 24


def test_entry_points_default_to_cuda(slice_setup, tmp_path):
    """LaneMapper, stream_map and convert_las_directory run on the card
    unless asked otherwise, and raise on a machine without one rather than
    carrying on."""
    import inspect
    from lanemapping_tpu_torch import LaneMapper
    from lanemapping_tpu_torch.tools import stream_map
    from lanemapping_tpu_torch.tools.las2bev import convert_las_directory

    assert inspect.signature(LaneMapper).parameters["device"].default == \
        "cuda"
    assert stream_map.parse_args([TINY, "r"]).device == "cuda"
    assert inspect.signature(convert_las_directory).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        assert LaneMapper(TINY).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        LaneMapper(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_map.main([TINY, slice_setup[0], "--from-las", "--out",
                         str(tmp_path)])
    assert not os.path.exists(tmp_path / "lanes_2d")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_las_directory(os.path.join(slice_setup[0], "las"),
                              str(tmp_path / "png"), img=192)
    assert not os.path.exists(tmp_path / "png")
