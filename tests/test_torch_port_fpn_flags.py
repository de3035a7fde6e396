"""The FPN encoder's three flags (`models/resnet_fpn.py`) against the JAX
package on the CPU, at ``configs/tiny_test.py`` (192 px, ResNet-34):

- ``s2d_stem``: the port's ``s2d_stem_kernel`` equals JAX's exactly; a 7x7
  stem loads into an s2d model through ``api.load_checkpoint`` and
  ``load_network_filtered``, and that model's outputs equal the 7x7
  model's within rel-max 1e-5;
- ``s2d_stem`` and ``endp_head_extra`` encoders (ResNet-18, 128 px tiles),
  weights carried across by
  ``tools/from_jax``: outputs within rel-max 1e-5 of JAX's in eval and in
  train mode, and the BatchNorm statistics of the train-mode pass within
  rel-max 1e-5, both packages in float64 (JAX under ``enable_x64``; its
  resize operators stay float32, ~1e-7 apart).  In float32 the two
  packages' summation orders through the ResNet-34 trunk part the
  train-mode outputs by up to 1.6e-5 at random weights, with or without
  a flag;
- ``remat`` ("full" and "dots"): one bf16 train step of the tiny
  Detector1stage (ResNet-18 trunk) gives the no-remat step's gradients,
  parameters and BatchNorm buffers, bit for bit, while the trunk's blocks
  run twice (the forward and the recompute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (configs, random_variables, rel_max_err,
                                wire_data_root)

FLAGS = {"s2d": {"s2d_stem": True}, "endp_extra": {"endp_head_extra": True}}


def test_s2d_stem_kernel_matches_jax():
    from lanemapping_tpu.models.resnet_fpn import s2d_stem_kernel as jax_s2d
    from lanemapping_tpu_torch.models.resnet_fpn import (s2d_stem_kernel,
                                                         s2d_stem_weight)
    w7 = np.random.RandomState(0).randn(7, 7, 3, 64).astype(np.float32)
    want = jax_s2d(w7)
    np.testing.assert_array_equal(s2d_stem_kernel(w7), want)
    got = s2d_stem_weight(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))


def flagged(**flags):
    cfgs = configs()
    for cfg in cfgs:
        cfg.merge_from_dict(flags)
    return cfgs


@pytest.mark.parametrize("how", ["load_checkpoint", "load_network_filtered"])
def test_s2d_model_with_a_7x7_stem_equals_the_7x7_model(how, tmp_path):
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.api import load_checkpoint
    from lanemapping_tpu_torch.engine.checkpoint import load_network_filtered
    from lanemapping_tpu_torch.engine.state import create_train_state

    _, cfg = configs()
    ref = lmt.build_model(cfg, seed=0)
    path = str(tmp_path / "w.pth")
    torch.save({"net": ref.state_dict()}, path)
    _, cfg_s2d = flagged(s2d_stem=True)
    model = lmt.build_model(cfg_s2d, seed=1)
    assert not hasattr(model.pcencoder.fpn, "conv1")
    if how == "load_checkpoint":
        load_checkpoint(model, path)
    else:
        load_network_filtered(path, create_train_state(model, cfg_s2d))
    got_sd, want_sd = model.state_dict(), ref.state_dict()
    assert set(got_sd) ^ set(want_sd) == {"pcencoder.fpn.conv1.weight",
                                          "pcencoder.fpn.conv1_s2d.weight"}
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 192, 192, 3)
                         .astype(np.float32))
    with torch.no_grad():
        got, want = model.eval()(x), ref.eval()(x)
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k].numpy()) < 1e-5, k


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_flagged_encoder_matches_jax(name):
    from lanemapping_tpu.registry import build_pcencoder as jax_encoder
    from lanemapping_tpu_torch.registry import build_pcencoder
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax, rules_for

    # a ResNet-18 trunk on 128 px tiles keeps the float64 programs small
    cfg_j, cfg_t = flagged(**FLAGS[name], **{"pcencoder.resnet": "resnet18"})
    je = jax_encoder(cfg_j)
    x = np.random.RandomState(4).rand(2, 128, 128, 3).astype(np.float32)
    variables = random_variables(je, (jnp.zeros((1, 128, 128, 3)),), 5)
    rules = [(t[len("pcencoder."):], j[len("pcencoder/"):], f)
             for t, j, f in rules_for(cfg_t) if t.startswith("pcencoder.")]
    te = build_pcencoder(cfg_t)
    missing, unexpected = te.load_state_dict(params_from_jax(
        variables["params"], variables["batch_stats"], rules), strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    flags = FLAGS[name]
    fpn = te.fpn
    assert hasattr(fpn, "conv1_s2d") == flags.get("s2d_stem", False)
    assert hasattr(fpn, "endp_extra") == flags.get("endp_head_extra", False)

    te.double()
    for train in (False, True):
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                               variables)
            want, upd = jax.device_get(jax.jit(lambda v, a: je.apply(
                v, a, train=train, mutable=["batch_stats"]))(
                    v64, jnp.asarray(x, jnp.float64)))
        with torch.no_grad():
            got = te.train(train)(torch.from_numpy(x).double()
                                  .permute(0, 3, 1, 2))
        for g, w in zip(got, want):
            assert rel_max_err(g.permute(0, 2, 3, 1).numpy(), w) < 1e-5
    stats = te.state_dict()
    for k, w in params_from_jax({}, upd["batch_stats"], rules).items():
        assert rel_max_err(stats[k].numpy(), w.numpy()) < 1e-5, k


@pytest.fixture(scope="module")
def bf16_batch(tmp_path_factory):
    """A batch of the tiny config as the port's Runner ships it."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    _, cfg = configs()
    wire_data_root(cfg, root)
    cfg.train_compute_dtype = "bfloat16"
    cfg.pcencoder.resnet = "resnet18"
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    runner = Runner(cfg, log_dir=str(tmp_path_factory.mktemp("logs")),
                    device="cpu")
    return cfg, runner._device_batch(batch)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_equals_the_step_without(policy, bf16_batch):
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.engine.state import (create_train_state,
                                                    make_train_step)
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)
    from lanemapping_tpu_torch.models.resnet_fpn import RematStage

    cfg, db = bf16_batch
    hp = head_hparams(cfg)
    step = make_train_step(lambda o, b: column_proposal_loss(o, b, hp),
                           torch.bfloat16)
    models, runs = {}, {}
    for remat in (False, True):
        cfg.remat, cfg.remat_policy = remat, policy
        model = lmt.build_model(cfg, seed=0)
        fpn = model.pcencoder.fpn
        assert isinstance(fpn.layer1, RematStage) == remat
        calls = []
        fpn.layer3[0].register_forward_pre_hook(
            lambda *_: calls.append(None))
        state = create_train_state(model, cfg)
        stats = step(state, db)
        assert stats["skipped_nan"] == 0.0
        models[remat], runs[remat] = model, (len(calls), float(stats["loss"]))
    assert runs[False][0] == 1 and runs[True][0] == 2, runs
    assert runs[False][1] == runs[True][1]
    ref = dict(models[False].named_parameters())
    for n, p in models[True].named_parameters():
        assert torch.equal(p.grad, ref[n].grad), n
        assert torch.equal(p, ref[n]), n
    ref = dict(models[False].named_buffers())
    for n, b in models[True].named_buffers():
        assert torch.equal(b, ref[n]), n
