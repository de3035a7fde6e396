"""The ResnetFPN backbone family (`models/resnet_fpn_family.py`) against the
JAX package on the CPU, with seeded weights carried across by
``tools/from_jax``:

- all nine registered names at ``num_channels=8`` on a 48x48x8 input
  (five stages reach 3x3, so the up-paths run at strides 1 to 16), in eval
  and in train mode: the concatenated map and, in train mode, every
  BatchNorm's running statistics within rel-max 1e-5;
- the up-path alone, flax's ``nn.ConvTranspose(padding="SAME")`` (the
  kernel unflipped) against ``ConvTransposeSame`` at strides 1, 2, 4, 8
  and 16, within rel-max 1e-6;
- a tiny Detector1stage (``configs/tiny_test.py``, ResNet-18) with a
  family correlator in place of the ViT: every output within rel-max
  2e-3, the repo's whole-net bar in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (configs, jax_apply, random_variables,
                                rel_max_err)

NAMES = ["ResnetFPN", "ResnetFPN2", "ResnetFPN3", "ResnetFPN4",
         "ResnetFPN3_CBAM", "ResnetFPN4_CBAM", "ResnetFPN2_Dilated",
         "ResnetFPN3_Dilated", "ResnetFPN4_Dilated"]


def test_nine_names_are_registered_in_both_packages():
    from lanemapping_tpu.registry import BACKBONE as JB
    from lanemapping_tpu_torch.models.resnet_fpn_family import FAMILY
    from lanemapping_tpu_torch.registry import BACKBONE
    assert sorted(FAMILY) == sorted(NAMES)
    assert all(n in BACKBONE and n in JB for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_family_backbone_matches_jax(name):
    from lanemapping_tpu.registry import BACKBONE as JB
    from lanemapping_tpu_torch.models.resnet_fpn_family import \
        family_out_channels
    from lanemapping_tpu_torch.registry import BACKBONE
    from lanemapping_tpu_torch.tools.from_jax import (family_rules,
                                                      params_from_jax)

    rules = [(t[len("backbone."):], j[len("backbone/"):], f)
             for t, j, f in family_rules()]
    x = np.random.RandomState(0).randn(2, 48, 48, 8).astype(np.float32)
    jm = JB.get(name)(num_channels=8)
    tm = BACKBONE.get(name)(num_channels=8,
                            cfg={"featuremap_out_channel": 8})
    variables = random_variables(jm, (jnp.asarray(x),), 1)
    missing, unexpected = tm.load_state_dict(params_from_jax(
        variables["params"], variables["batch_stats"], rules), strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    for train in (False, True):
        want, upd = jax.device_get(jax.jit(lambda v, a: jm.apply(
            v, a, train=train, mutable=["batch_stats"]))(
                variables, jnp.asarray(x)))
        with torch.no_grad():
            got = tm.train(train)(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape[1] == family_out_channels(name, 8)
        assert rel_max_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-5
    stats = tm.state_dict()
    want_bs = params_from_jax({}, upd["batch_stats"], rules)
    assert want_bs
    for k, w in want_bs.items():
        assert rel_max_err(stats[k].numpy(), w.numpy()) < 1e-5, k


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_conv_transpose_same_matches_flax(stride):
    import flax.linen as fnn
    from lanemapping_tpu_torch.models.resnet_fpn_family import \
        ConvTransposeSame

    rng = np.random.RandomState(stride)
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    k = rng.randn(3, 3, 6, 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = np.asarray(fnn.ConvTranspose(4, (3, 3), strides=(stride, stride),
                                        padding="SAME").apply(
        {"params": {"kernel": k, "bias": b}}, jnp.asarray(x)))
    assert want.shape == (2, 5 * stride, 7 * stride, 4)
    m = ConvTransposeSame(6, 4, 3, stride)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        m.bias.copy_(torch.from_numpy(b))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert rel_max_err(got.permute(0, 2, 3, 1).numpy(), want) < 1e-6


def test_detector_with_a_family_correlator_matches_jax():
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfgs = configs()
    for cfg in cfgs:
        cfg.merge_from_dict({"pcencoder.resnet": "resnet18", "backbone": {
            "_delete_": True, "type": "ResnetFPN2", "num_channels": 8}})
    cfg_j, cfg_t = cfgs
    jm = lm.build_model(cfg_j)
    variables = random_variables(jm, (jnp.zeros((1, 192, 192, 3)),), 6)
    tm = load_jax_weights(lmt.build_model(cfg_t), variables["params"],
                          variables["batch_stats"], cfg_t)
    assert tm.backbone.n_stages == 2
    x = np.random.RandomState(7).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < 2e-3, k
