"""The port's LiDAR network against the JAX package at
``configs/tiny_test_lidar.py`` (96x96x4 voxel grid, 4096 points): the
LidarEncoder's four outputs with both reference-exact flags off and on,
and the whole Detector1stage on the raw-point dict, in float32 and with
bf16-rounded weights (what the JAX streaming script computes for the
LiDAR config, see `test_detector_with_bf16_weights_matches_jax_promotion`).
Weights are carried across by ``tools/from_jax.params_from_jax``.
Tolerance: rel-max 2e-3, the existing torch-parity bar."""

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_port_helpers import (jax_apply, lane_clouds, nhwc, rel_max_err,
                                tiny_lidar_models)

TOL = 2e-3
FLAGS = {"off": {}, "on": {"ref_exact_voxel_cap": True,
                           "ref_exact_bicubic_upsample": True}}


def inputs(cfg):
    return lane_clouds([11, 12], 192, cfg.max_points)


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_lidar_encoder_matches_jax(flags):
    from lanemapping_tpu.registry import build_pcencoder

    _, variables, tmodel, cfg_j, _ = tiny_lidar_models(seed=0,
                                                       **FLAGS[flags])
    enc = build_pcencoder(cfg_j)
    assert enc.bicubic_upsample == (flags == "on")
    assert tmodel.pcencoder.bicubic_upsample == (flags == "on")
    assert tmodel.pcencoder.max_points_per_voxel == \
        (10 if flags == "on" else None)
    pts, mask = inputs(cfg_j)
    want = jax_apply(enc, {k: v["pcencoder"] for k, v in variables.items()},
                     jnp.asarray(pts), mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tmodel.pcencoder(torch.tensor(pts), torch.tensor(mask))
    for name, g, w in zip(("fea", "fea_up", "bi_seg", "endp"), got, want):
        assert rel_max_err(nhwc(g), w) < TOL, name


def test_detector_on_points_matches_jax():
    jmodel, variables, tmodel, cfg_j, _ = tiny_lidar_models(seed=1)
    pts, mask = inputs(cfg_j)
    want = jax_apply(jmodel, variables, {"points": jnp.asarray(pts),
                                         "points_mask": jnp.asarray(mask)})
    with torch.no_grad():
        got = tmodel({"points": torch.tensor(pts),
                      "points_mask": torch.tensor(mask)})
    assert set(got) == set(want)
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < TOL, k


def test_detector_with_bf16_weights_matches_jax_promotion():
    """The JAX streaming script casts the weights of a bf16 config to bf16
    but feeds the LiDAR net float32 points (`tools/stream_map.py:96-100,
    131-133`); flax then promotes every layer to float32 but takes
    BatchNorm's multiplier in bf16.  The port's stream computes the same
    (``round_weights_as_flax_promotes``)."""
    from lanemapping_tpu_torch.models.nets import \
        round_weights_as_flax_promotes

    jmodel, variables, tmodel, cfg_j, _ = tiny_lidar_models(seed=2)
    v16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                       variables)
    pts, mask = inputs(cfg_j)
    want = jax_apply(jmodel, v16, {"points": jnp.asarray(pts),
                                   "points_mask": jnp.asarray(mask)})
    assert {str(w.dtype) for w in want.values()} == {"float32"}
    round_weights_as_flax_promotes(tmodel)
    with torch.no_grad():
        got = tmodel({"points": torch.tensor(pts),
                      "points_mask": torch.tensor(mask)})
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < TOL, k
