"""The slice's models against the JAX package on the CPU: MixSegNet, Dummy,
the legacy ResNetProjector, the RowSharNotReducRef, GridSeg and PixelSeg
heads, and the Segmentor, with seeded weights carried across by
``tools/from_jax``; in eval mode, and in training mode with the BatchNorm
running statistics.

Bars: outputs within rel-max 2e-3 (``rel_max_err``), running statistics
within rel-max 1e-5.  The row head's windows come from an argmax and its
write-back from a gate (``mean(ext1) > thr_ext``): each test asserts that
its seed keeps the top-2 margin of ``cls1`` and the gate's distance from
the threshold above ``MARGIN``, so float32 rounding cannot flip them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_apply, nhwc, random_variables,
                                rel_max_err, state_dict_np, zoo_models)

TOL = 2e-3
BN_TOL = 1e-5
MARGIN = 1e-4


def jax_train_apply(module, variables, *args):
    """Training-mode forward: (outputs, new batch_stats) as numpy."""
    out, upd = jax.jit(lambda v, *a: module.apply(
        v, *a, train=True, mutable=["batch_stats"]))(variables, *args)
    return jax.tree.map(np.asarray, out), jax.tree.map(
        np.asarray, upd["batch_stats"])


def port_sd(prefix, params, batch_stats, rules):
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    sd = params_from_jax(params, batch_stats, rules)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load(module, prefix, variables, rules):
    missing, unexpected = module.load_state_dict(
        port_sd(prefix, variables["params"], variables["batch_stats"],
                rules), strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module


def assert_outputs(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].detach().numpy()
        assert g.shape == want[k].shape, k
        assert rel_max_err(g, want[k]) < TOL, k


def assert_stats(module, prefix, new_bs, rules):
    want = port_sd(prefix, {}, new_bs, rules)
    got = state_dict_np(module)
    assert want
    for k, w in want.items():
        assert rel_max_err(got[k], w.numpy()) < BN_TOL, k


# -- correlators ------------------------------------------------------------

@pytest.mark.parametrize("patch", [8, 4])
def test_mixsegnet_matches_jax(patch):
    from lanemapping_tpu.models.vit import MixSegNet as JaxMix
    from lanemapping_tpu_torch.models.vit import MixSegNet
    from lanemapping_tpu_torch.tools.from_jax import build_rules

    kw = dict(image_size=24, patch_size=patch, channels=16, dim=128,
              depth=2, expansion_factor=2)
    x = np.random.RandomState(1).randn(2, 24, 24, 16).astype(np.float32)
    jm = JaxMix(**kw)
    variables = random_variables(jm, (jnp.asarray(x),), seed=2)
    want = jax_apply(jm, variables, jnp.asarray(x))
    rules = build_rules(pcencoder="PostProjector2", backbone="MixSegNet",
                        vit_depth=2, head=None)
    tm = load(MixSegNet(**kw), "backbone.",
              {"params": {"backbone": variables["params"]},
               "batch_stats": {}}, rules).eval()
    with torch.no_grad():
        got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.shape[1] == 128 // patch ** 2
    assert rel_max_err(nhwc(got), want) < TOL


@pytest.mark.parametrize("patch", [8, 4])
def test_mixseg_net_builds_and_matches_jax(patch):
    """The whole MixSeg config, at the patch the head's input width
    depends on: the port derives the correlator's output channels from
    ``patch_size`` (``dim / patch^2``) where flax infers them."""
    jm, variables, tm, _, cfg_t = zoo_models(
        "mixseg", seed=3, **{"backbone.patch_size": patch})
    assert tm.heads.bi_seg_proposal.in_channels == \
        128 // patch ** 2 + 8
    x = np.random.RandomState(4).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        assert_outputs(tm.eval()(torch.tensor(x)), want)


def test_dummy_correlator_matches_jax():
    """With the identity correlator the head reads the encoder's 64
    channels."""
    jm, variables, tm, _, _ = zoo_models(
        "mixseg", seed=5, backbone={"_delete_": True, "type": "Dummy"})
    assert tm.heads.bi_seg_proposal.in_channels == 64 + 8
    assert not list(tm.backbone.parameters())
    x = np.random.RandomState(6).rand(2, 192, 192, 3).astype(np.float32)
    want = jax_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        assert_outputs(tm.eval()(torch.tensor(x)), want)


# -- the legacy projector ---------------------------------------------------

@pytest.mark.parametrize("resnet", ["resnet18", "resnet34"])
def test_resnet_projector_matches_jax(resnet):
    from lanemapping_tpu.models.legacy import ResNetProjector as JaxProj
    from lanemapping_tpu_torch.models.legacy import ResNetProjector
    from lanemapping_tpu_torch.models.resnet_fpn import RESNET_LAYERS
    from lanemapping_tpu_torch.tools.from_jax import build_rules

    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    jm = JaxProj(resnet=resnet)
    variables = random_variables(jm, (jnp.asarray(x),), seed=8)
    wrap = lambda t: {"pcencoder": t}  # noqa: E731
    rules = build_rules(resnet_layers=RESNET_LAYERS[resnet],
                        pcencoder="PostProjector", backbone=None, head=None)
    tm = load(ResNetProjector(resnet=resnet), "pcencoder.",
              {"params": wrap(variables["params"]),
               "batch_stats": wrap(variables["batch_stats"])}, rules)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    want = jax_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(xt)
    assert got.shape == (2, 64, 8, 8)  # layer3 dilated: stride 8
    assert rel_max_err(nhwc(got), want) < TOL

    want, new_bs = jax_train_apply(jm, variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.train()(xt)
    assert rel_max_err(nhwc(got), want) < TOL
    assert_stats(tm, "pcencoder.", wrap(new_bs), rules)


# -- heads ------------------------------------------------------------------

# thr_ext 0.5 (the configs' 0.3 gates every lane at random weights), so
# that both branches of the gate run
ROW_KW = dict(dim_feat=2, row_size=24, dim_shared=32, dim_token=64,
              thr_ext=0.5, tr_heads=4, tr_dim_head=16, tr_mlp_dim=128)
ROW_SEED = 14


def row_setup(seed):
    from lanemapping_tpu.models.row_head import RowSharNotReducRef as JaxRow
    from lanemapping_tpu_torch.models.row_head import RowSharNotReducRef
    from lanemapping_tpu_torch.tools.from_jax import build_rules

    x = np.random.RandomState(seed).randn(2, 24, 24, 2).astype(np.float32)
    jm = JaxRow(**ROW_KW)
    variables = random_variables(jm, (jnp.asarray(x),), seed=seed + 1)
    rules = build_rules(pcencoder="PostProjector2", backbone=None,
                        head="RowSharNotReducRef")
    wrap = lambda t: {"heads": t}  # noqa: E731
    tm = load(RowSharNotReducRef(**ROW_KW), "heads.",
              {"params": wrap(variables["params"]),
               "batch_stats": wrap(variables["batch_stats"])}, rules)
    return x, jm, variables, tm, rules, wrap


def assert_row_margins(out, thr_ext):
    """The stage-1 decisions sit clear of float32 rounding: the argmax of
    every lane row of ``cls1`` and every lane's existence gate."""
    p = np.sort(out["cls"], axis=-1)
    assert (p[..., -1] - p[..., -2]).min() > MARGIN
    gate = out["ext"][..., 0].mean(-1)
    assert np.abs(gate - thr_ext).min() > MARGIN
    return gate > thr_ext


def overlapping_windows(out, gate, og=2):
    """Whether two lanes' +-og windows overlap in some row, one of the two
    gated (so the two write different values)."""
    corr = out["cls"].argmax(-1)  # [B,N,S]
    d = np.abs(corr[:, :, None] - corr[:, None, :])  # [B,N,N,S]
    off = ~np.eye(corr.shape[1], dtype=bool)[None, :, :, None]
    either = (gate[:, :, None] | gate[:, None, :])[..., None]
    return bool(((d <= 2 * og) & off & either).any())


@pytest.mark.parametrize("train", [False, True])
def test_row_shar_head_matches_jax(train):
    x, jm, variables, tm, rules, wrap = row_setup(ROW_SEED)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    if train:
        want, new_bs = jax_train_apply(jm, variables, jnp.asarray(x))
    else:
        want = jax_apply(jm, variables, jnp.asarray(x))
    gate = assert_row_margins(want, ROW_KW["thr_ext"])
    assert gate.any() and not gate.all()  # both branches of the gate
    assert overlapping_windows(want, gate)  # the write-back's lane order
    with torch.no_grad():
        got = tm.train(train)(xt)
    assert_outputs(got, want)
    np.testing.assert_array_equal(got["cls"].numpy().argmax(-1),
                                  want["cls"].argmax(-1))
    if train:
        assert_stats(tm, "heads.", wrap(new_bs), rules)


def test_row_shar_write_back_order_matters(monkeypatch):
    """At this seed, writing the lanes back in reverse order (what an
    unordered scatter may do) moves the stage-2 outputs far beyond the
    bar: the parity above pins the JAX loop's lane order."""
    import lanemapping_tpu_torch.models.row_head as trh

    x, jm, variables, tm, _, _ = row_setup(ROW_SEED)
    want = jax_apply(jm, variables, jnp.asarray(x))
    in_order = trh.write_back
    monkeypatch.setattr(trh, "write_back", lambda x_pad, win, upd: in_order(
        x_pad, win.flip(1), upd.flip(1)))
    with torch.no_grad():
        got = tm.eval()(torch.tensor(x).permute(0, 3, 1, 2))
    assert rel_max_err(got["cls"].numpy(), want["cls"]) < TOL
    assert max(rel_max_err(got[k].numpy(), want[k])
               for k in ("ext2", "cls2")) > 10 * TOL


@pytest.mark.parametrize("head", ["GridSeg", "PixelSeg"])
def test_seg_heads_match_jax(head):
    import lanemapping_tpu.models.row_head as jrh
    import lanemapping_tpu_torch.models.row_head as trh
    from lanemapping_tpu_torch.tools.from_jax import build_rules

    kw = dict(num_1=16, num_2=32, num_classes=13)
    x = np.random.RandomState(12).randn(2, 24, 24, 16).astype(np.float32)
    jm = getattr(jrh, head)(**kw)
    variables = random_variables(jm, (jnp.asarray(x),), seed=13)
    want = jax_apply(jm, variables, jnp.asarray(x))
    rules = build_rules(pcencoder="PostProjector2", backbone=None, head=head)
    tm = load(getattr(trh, head)(in_channels=16, **kw), "heads.",
              {"params": {"heads": variables["params"]},
               "batch_stats": {}}, rules)
    with torch.no_grad():
        assert_outputs(tm.eval()(torch.tensor(x).permute(0, 3, 1, 2)), want)


# -- whole nets ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["rowref", "gridseg", "fpnseg"])
def test_zoo_net_train_mode_matches_jax(name):
    """The RowRef net (Detector1stage with the row head), the legacy
    Detector with GridSeg and the Segmentor in training mode: outputs and
    every BatchNorm's running statistics, those of the encoder's semantic
    pyramids the row head never reads included."""
    from lanemapping_tpu_torch.tools.from_jax import rules_for

    jm, variables, tm, _, cfg_t = zoo_models(name, seed=14)
    x = np.random.RandomState(15).rand(2, 192, 192, 3).astype(np.float32)
    want, new_bs = jax_train_apply(jm, variables, jnp.asarray(x))
    if name == "rowref":
        assert_row_margins(want, cfg_t.heads.thr_ext)
    with torch.no_grad():
        got = tm.train()(torch.tensor(x))
    assert_outputs(got, want)
    assert_stats(tm, "", new_bs, rules_for(cfg_t))


@pytest.mark.parametrize("name", ["rowref", "gridseg", "fpnseg", "mixseg"])
def test_params_from_jax_covers_the_shipped_configs(name):
    """At the configs' full widths, every parameter and buffer of the port
    net (BatchNorm's num_batches_tracked aside) is carried from the flax
    trees, in the layout the port expects."""
    import os
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import (load_jax_weights,
                                                      params_from_jax,
                                                      rules_for)
    from torch_port_helpers import REPO, ZOO_CONFIGS, configs

    cfg_j, cfg_t = configs(os.path.join(REPO, "configs", ZOO_CONFIGS[name]))
    variables = random_variables(lm.build_model(cfg_j),
                                 (jnp.zeros((1, 1152, 1152, 3)),), seed=16)
    load_jax_weights(lmt.build_model(cfg_t), variables["params"],
                     variables["batch_stats"], cfg_t)
    sd = params_from_jax(variables["params"], variables["batch_stats"],
                         rules_for(cfg_t))
    p = variables["params"]
    if name == "rowref":  # [N, I, O] as it is; Dense [I, O] -> [O, I]
        np.testing.assert_array_equal(sd["heads.cls2.w1"].numpy(),
                                      p["heads"]["cls2"]["w1"])
        assert sd["heads.cls2.w1"].shape == (12, 8 * 144, 512)
        np.testing.assert_array_equal(sd["heads.to_token.weight"].numpy(),
                                      p["heads"]["to_token"]["kernel"].T)
    elif name == "gridseg":  # 1x1 conv HWIO -> OIHW
        np.testing.assert_array_equal(
            sd["heads.conf_fc1.weight"].numpy()[:, :, 0, 0],
            p["heads"]["conf_fc1"]["kernel"][0, 0].T)
        assert sd["heads.conf_fc1.weight"].shape[1] == 1024
        assert sd["pcencoder.out_conv.weight"].shape == (64, 256, 1, 1)
    elif name == "mixseg":
        np.testing.assert_array_equal(
            sd["backbone.mixers.2.token_fc1.weight"].numpy(),
            p["backbone"]["mixer2"]["token_fc1"]["kernel"].T)
        assert sd["backbone.mixers.2.token_fc1.weight"].shape == (2048, 324)
    else:
        assert not any(k.startswith(("backbone.", "heads.")) for k in sd)
