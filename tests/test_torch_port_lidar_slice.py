"""The port's ``stream_map`` on a LaserLane dataset against the JAX chain
of `tools/stream_map.py:119-158` (``fwd_dec_fn`` + postprocess), on the
CPU: the raw-point LiDAR config (``configs/tiny_test_lidar.py``, float32
and with the bf16 weights of a bf16 config) and image tiles through the
flagship wiring (``configs/tiny_test.py``), with the same seeded weights.
Lane records must be identical (columns to 1e-3 px).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (TINY, TINY_LIDAR, assert_clear_of_thresholds,
                                assert_same_records, tiny_lidar_models,
                                tiny_models)

# weight seeds whose decoded values sit clear of every host decision
# threshold on this dataset (asserted below), so float32 rounding
# differences between the packages cannot flip a vertex, a proposal or a
# tracker cell
SEEDS = {"lidar-float32": 8, "lidar-bfloat16": 3, "image": 8}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=2, img=192, seed=11, with_points=True,
                     points_per_tile=4096)
    return root


def jax_stream_chain(jmodel, variables, cfg, root, use_lidar):
    """`tools/stream_map.py`'s dataset, input shipping, ``fwd_dec_fn`` and
    postprocess for one batch, in the JAX package."""
    from lanemapping_tpu.data.loader import Loader
    from lanemapping_tpu.decode.lane_decode import (decode_lanes,
                                                    host_decode_view)
    from lanemapping_tpu.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu.engine.state import is_mono_batch
    from lanemapping_tpu.registry import DATASETS, build_from_cfg
    from lanemapping_tpu.tools.export_lanes import lane_records

    ds = build_from_cfg(dict(cfg.dataset.test, data_root=root,
                             mode="infer_only"), DATASETS,
                        default_args=dict(cfg=cfg))
    batch = next(iter(Loader(ds, batch_size=2, shuffle=False,
                             drop_last=False, num_threads=1)))
    compute_dtype = jnp.bfloat16 if cfg.get("compute_dtype") == "bfloat16" \
        else jnp.float32
    if compute_dtype == jnp.bfloat16:
        variables = jax.tree.map(lambda a: jnp.asarray(a).astype(
            jnp.bfloat16), variables)
    if use_lidar:
        inp = {"points": np.asarray(batch["points"], np.float32),
               "points_mask": np.asarray(batch["points_mask"])}
    else:
        inp = np.rint(np.asarray(batch["proj"]) * 255.0).astype(np.uint8)
        assert is_mono_batch(inp)
        inp = np.ascontiguousarray(inp[..., :1])

    @jax.jit
    def fwd_dec_fn(v, inp):
        if use_lidar:
            x = inp
        else:
            x = (inp.astype(jnp.float32) / 255.0).astype(compute_dtype)
            x = jnp.broadcast_to(x, x.shape[:-1] + (3,))
        dec = decode_lanes(jmodel.apply(v, x, train=False), cfg)
        keep = host_decode_view(dec)
        keep.pop("cls", None)
        keep.pop("cls_exp", None)
        keep["bi_seg_rows"] = jnp.round(
            jnp.clip(keep["bi_seg_rows"], 0.0, 1.0) * 255.0).astype(jnp.uint8)
        keep["prop_v_ext"] = keep["prop_v_ext"].astype(jnp.uint8)
        keep["orient"] = keep["orient"].astype(jnp.int8)
        return dec, keep

    cfg.endp_decode = "exact_topk"  # the port's torch.topk
    dec, keep = jax.device_get(fwd_dec_fn(variables, inp))
    maps = lane_maps_from_decode(keep, cfg)
    return batch["image_name"], dec, [lane_records(m)
                                      for m in maps["cls_offset_smooth"]]


def run_port_stream(config, root, ckpt, out, overrides=()):
    from lanemapping_tpu_torch.tools import stream_map

    rec = stream_map.main([config, root, "--split", "infer_only", "--device",
                           "cpu", "--ckpt", ckpt, "--out", str(out),
                           *overrides])
    names = sorted(os.listdir(os.path.join(out, "lanes_2d")))
    recs = {n[:-5]: json.load(open(os.path.join(out, "lanes_2d", n)))
            for n in names}
    return rec, recs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lidar_stream_matches_jax_chain(data_root, tmp_path, dtype):
    jmodel, variables, tmodel, cfg_j, _ = tiny_lidar_models(
        seed=SEEDS[f"lidar-{dtype}"], compute_dtype=dtype)
    names, dec_j, recs_j = jax_stream_chain(jmodel, variables, cfg_j,
                                            data_root, use_lidar=True)
    assert_clear_of_thresholds(dec_j, cfg_j, clamped_columns=True)
    assert sum(map(len, recs_j)) >= 2
    ckpt = str(tmp_path / "lidar.pth")
    torch.save(tmodel.state_dict(), ckpt)
    rec, recs = run_port_stream(TINY_LIDAR, data_root, ckpt, tmp_path,
                                [f"compute_dtype={dtype}"])
    assert rec["input"] == "lidar" and rec["dtype"] == "float32"
    assert rec["n_tiles"] == 2 and rec["points_per_tile"] == 4096
    assert set(rec["stage_ms_per_batch"]) >= {"upload", "voxelize",
                                              "forward", "decode"}
    assert_same_records([recs[n] for n in names], recs_j)


def test_image_tile_stream_matches_jax_chain(data_root, tmp_path):
    jmodel, variables, tmodel, cfg_j, _ = tiny_models(seed=SEEDS["image"])
    names, dec_j, recs_j = jax_stream_chain(jmodel, variables, cfg_j,
                                            data_root, use_lidar=False)
    assert_clear_of_thresholds(dec_j, cfg_j, clamped_columns=True)
    assert sum(map(len, recs_j)) >= 2
    ckpt = str(tmp_path / "image.pth")
    torch.save(tmodel.state_dict(), ckpt)
    rec, recs = run_port_stream(TINY, data_root, ckpt, tmp_path)
    assert rec["input"] == "image" and rec["n_tiles"] == 2
    assert set(rec["stage_ms_per_batch"]) >= {"upload", "normalize",
                                              "forward", "decode"}
    assert_same_records([recs[n] for n in names], recs_j)


def test_lidar_config_refuses_from_las(data_root, tmp_path):
    from lanemapping_tpu_torch.tools import stream_map

    with pytest.raises(SystemExit, match="drop --from-las"):
        stream_map.main([TINY_LIDAR, data_root, "--from-las", "--device",
                         "cpu", "--out", str(tmp_path)])
    assert not os.path.exists(tmp_path / "lanes_2d")
