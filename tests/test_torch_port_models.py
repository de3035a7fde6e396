"""The port's network modules against the JAX package at the tiny config:
FPNEncoder (all four outputs), VitSegNet, ColumnProposalHead (every output
key, both endpoint modes) and the whole Detector1stage, with the same
seeded weights carried across by ``tools/from_jax.params_from_jax``.
Tolerance: rel-max 2e-3 in float32, the existing torch-parity bar."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (configs, jax_apply, nhwc, random_variables,
                                rel_max_err, tiny_models)

TOL = 2e-3


@pytest.fixture(scope="module")
def tiny():
    return tiny_models(seed=0)


def test_fpn_encoder_matches_jax(tiny):
    jmodel, variables, tmodel, cfg_j, _ = tiny
    from lanemapping_tpu.registry import build_pcencoder

    enc = build_pcencoder(cfg_j)
    x = np.random.RandomState(1).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(enc, {k: v["pcencoder"] for k, v in variables.items()},
                     jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.pcencoder(torch.tensor(x).permute(0, 3, 1, 2))
    for name, g, w in zip(("fea_down", "fea_up", "bi_seg", "endp"), got,
                          want):
        assert rel_max_err(nhwc(g), w) < TOL, name


def test_vit_seg_net_matches_jax(tiny):
    _, variables, tmodel, cfg_j, _ = tiny
    from lanemapping_tpu.registry import build_backbone

    vit = build_backbone(cfg_j)
    x = np.random.RandomState(2).randn(2, 24, 24, 64).astype(np.float32)
    want = jax_apply(vit, {"params": variables["params"]["backbone"]},
                     jnp.asarray(x))
    with torch.no_grad():
        got = tmodel.backbone(torch.tensor(x).permute(0, 3, 1, 2))
    assert rel_max_err(nhwc(got), want) < TOL


@pytest.mark.parametrize("endp_mode", ["endp_est", "endpoint"])
def test_column_head_matches_jax(endp_mode):
    from lanemapping_tpu.models.column_head import ColumnProposalHead
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax

    cfg_j, cfg_t = configs()
    cfg_t.heads.endp_mode = endp_mode
    S, F_ = 24, 8
    head_j = ColumnProposalHead(dim_feat=F_, row_size=S, dim_shared=32,
                                num_prop=12, endp_mode=endp_mode)
    rng = np.random.RandomState(3)
    x = rng.randn(2, S, S, 2).astype(np.float32)
    x_up = rng.randn(2, 2 * S, 2 * S, F_).astype(np.float32)
    x_endp = rng.randn(2, 8 * S, 8 * S, 1).astype(np.float32)
    args = tuple(map(jnp.asarray, (x, x_up, x_endp)))
    variables = random_variables(head_j, args, seed=4)
    want = jax_apply(head_j, variables, *args)

    head_t = lmt.build_model(cfg_t).heads
    sd = params_from_jax({"heads": variables["params"]},
                         {"heads": variables["batch_stats"]})
    missing, unexpected = head_t.load_state_dict(
        {k[len("heads."):]: v for k, v in sd.items()
         if k.startswith("heads.")}, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    with torch.no_grad():
        got = head_t(*(torch.tensor(a).permute(0, 3, 1, 2)
                       for a in (x, x_up, x_endp)))
    assert set(got) == set(want)
    for k in want:
        g = nhwc(got[k]) if k in ("orient", "endpoint") else got[k].numpy()
        assert rel_max_err(g, want[k]) < TOL, k


def test_detector_matches_jax(tiny):
    jmodel, variables, tmodel, _, _ = tiny
    x = np.random.RandomState(5).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jmodel, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.tensor(x))
    assert set(got) == set(want)
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < TOL, k


@pytest.mark.parametrize("cfg_name", [
    "tiny_test.py", "Proj_polyline_fpn_vit_vertex_2.py", "tiny_test_lidar.py",
    "Proj_polyline_lidarconv_vit_vertex_2.py"])
def test_params_from_jax_covers_every_weight(cfg_name):
    """Every parameter and buffer of the port model (BatchNorm's
    num_batches_tracked aside) is carried from the flax trees, with the
    layout the port expects — for the tiny and the full flagship and LiDAR
    configs."""
    import os
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import (load_jax_weights,
                                                      params_from_jax,
                                                      rules_for)
    from torch_port_helpers import REPO, lidar_example

    cfg_j, cfg_t = configs(os.path.join(REPO, "configs", cfg_name))
    img = cfg_j.list_img_size_xy[0]
    lidar = cfg_j.get("use_lidar", False)
    example = lidar_example(cfg_j.get("max_points", 1 << 19)) if lidar \
        else jnp.zeros((1, img, img, 3))
    variables = random_variables(lm.build_model(cfg_j), (example,), seed=6)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    sd = params_from_jax(variables["params"], variables["batch_stats"],
                         rules_for(cfg_t))
    # spot-check layouts: conv HWIO -> OIHW, dense [I,O] -> [O,I]
    p = variables["params"]
    if lidar:
        np.testing.assert_array_equal(
            sd["pcencoder.zfold_encoder.stem.weight"].numpy(),
            np.transpose(p["pcencoder"]["zfold_encoder"]["stem"]["kernel"],
                         (3, 2, 0, 1)))
        np.testing.assert_array_equal(
            sd["pcencoder.fea_conv_bn.running_mean"].numpy(),
            variables["batch_stats"]["pcencoder"]["fea_conv_bn"]["mean"])
        grid = cfg_t.grid_size
        assert sd["pcencoder.zfold_encoder.stem.weight"].shape[1] == \
            grid[2] * 4
    else:
        np.testing.assert_array_equal(
            sd["pcencoder.fpn.conv1.weight"].numpy(),
            np.transpose(p["pcencoder"]["conv1"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd["heads.cls2.0.weight"].numpy()[:, :, 0],
        p["heads"]["cls2_fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["heads.ext2.1.running_var"].numpy(),
        variables["batch_stats"]["heads"]["ext2_bn"]["var"])


def test_patchify_matches_jax():
    from lanemapping_tpu.models.vit import patchify as patchify_j, \
        unpatchify as unpatchify_j
    from lanemapping_tpu_torch.models.vit import patchify, unpatchify

    x = np.random.RandomState(7).randn(2, 16, 24, 3).astype(np.float32)
    want = np.asarray(patchify_j(jnp.asarray(x), 8))
    got = patchify(torch.tensor(x).permute(0, 3, 1, 2), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    back = unpatchify(got, 2, 3, 8)
    np.testing.assert_array_equal(nhwc(back), x)
    np.testing.assert_array_equal(
        np.asarray(unpatchify_j(jnp.asarray(want), 2, 3, 8)), x)
