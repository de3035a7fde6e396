"""RowSharNotReducRef_Base (`models/row_head_base.py`) against the JAX
package on the CPU, with seeded weights carried across by
``tools/from_jax``:

- the head alone at the JAX test's sizes (S=24, P=12, 64-wide lane tokens,
  32-wide row tokens), ``endp_mode`` "endpoint" and "Regr", in eval and in
  train mode: every output, and in train mode every BatchNorm's running
  statistics, within rel-max 1e-5;
- ``column_proposal_loss`` on its train-mode outputs: nine terms within
  rel 1e-5 of JAX's, the fused seg focal (whose JAX float32 sum drifts
  from float64) within 1e-6 of a float64 evaluation; ``endp_regression_
  loss`` within rel 1e-6; the row transformer's gradient within rel-max
  2e-3, the bar of the train-step tests;
- a tiny Detector1stage (``configs/tiny_test.py`` with this head) through
  the port's ``Runner.validate`` and export driver against the JAX
  Runner's on a stub: identical metrics and lane records (columns to
  1e-3 px, the repo's bar for the column head's decode), at a weight seed
  whose decode decisions clear float32 rounding (asserted).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (assert_clear_of_thresholds,
                                assert_same_records, configs, jax_apply,
                                random_variables, rel_max_err,
                                wire_data_root)

S, P, W = 24, 12, 10
HEAD = dict(type="RowSharNotReducRef_Base", dim_feat=8, row_size=S,
            dim_shared=32, num_prop=P, prop_width=2, prop_half_buff=4,
            dim_token=64, tr_heads=4, tr_dim_head=16, tr_mlp_dim=128,
            row_dim_token=32, row_tr_heads=4, row_tr_dim_head=8,
            row_tr_mlp_dim=64)
TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss")
# the loss scalars of the JAX package's own test of this head
HP = dict(row_size=S, num_prop=P, prop_fea_width=W, prop_width=2,
          prop_half_buff=4, ext_w=1.0, lambda_cls=1.0, mean_loss_w=1.0,
          orient_w=1.0, endp_loss_w=1.0, offset_w=1.0, spatial_att=True,
          cls_exp=True, cls_smooth=False, ext_smooth_w=0.0,
          endp_mode="endp_est", number_orients=11, seg_classes=3,
          fused_seg_focal=True, seg_focal_chunks=1, number_lanes=12)


def heads(endp_mode):
    """(JAX head, port head) of ``HEAD``."""
    from lanemapping_tpu.registry import HEADS as JH, build_from_cfg as jb
    from lanemapping_tpu_torch.registry import HEADS as TH, build_from_cfg
    cfg = dict(HEAD, endp_mode=endp_mode)
    return jb(cfg, JH), build_from_cfg(cfg, TH)


def head_rules(row_depth=1):
    from lanemapping_tpu_torch.tools.from_jax import build_rules
    return [r for r in build_rules(head="RowSharNotReducRef_Base",
                                   row_depth=row_depth, backbone=None)
            if r[0].startswith("heads.")]


def load_head(th, variables):
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    sd = params_from_jax({"heads": variables["params"]},
                         {"heads": variables["batch_stats"]}, head_rules())
    missing, unexpected = th.load_state_dict(
        {k[len("heads."):]: v for k, v in sd.items()}, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return th


def inputs(seed=0, B=2):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, S, 8).astype(np.float32),
            rng.randn(B, 2 * S, 2 * S, 8).astype(np.float32)]


def nchw(a):
    return torch.tensor(a).permute(0, 3, 1, 2)


def to_nhwc(out):
    return {k: (v.permute(0, 2, 3, 1) if k in ("orient", "endpoint") else v)
            for k, v in out.items()}


@pytest.mark.parametrize("endp_mode", ["endpoint", "Regr"])
def test_head_matches_jax_in_eval_and_train(endp_mode):
    jh, th = heads(endp_mode)
    ins = inputs()
    variables = random_variables(jh, [jnp.asarray(a) for a in ins], 3)
    load_head(th, variables)
    want = jax_apply(jh, variables, *[jnp.asarray(a) for a in ins])
    with torch.no_grad():
        got = to_nhwc(th.eval()(*map(nchw, ins)))
    assert set(got) == set(want)
    assert ("endp_reg" in got) == (endp_mode == "Regr")
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < 1e-5, k

    want, upd = jax.device_get(jax.jit(lambda v, *a: jh.apply(
        v, *a, train=True, mutable=["batch_stats"]))(
            variables, *[jnp.asarray(a) for a in ins]))
    with torch.no_grad():
        got = to_nhwc(th.train()(*map(nchw, ins)))
    for k in want:
        assert rel_max_err(got[k].numpy(), want[k]) < 1e-5, k
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    stats = th.state_dict()
    want_bs = params_from_jax({}, {"heads": upd["batch_stats"]}, head_rules())
    assert len(want_bs) == 20  # ten BatchNorms, mean and variance
    for k, w in want_bs.items():
        assert rel_max_err(stats[k[len("heads."):]].numpy(), w.numpy()) \
            < 1e-5, k


def label_batch(B=2):
    """The random labels of the JAX package's own loss test of this
    head."""
    rng = np.random.RandomState(1)
    img = 8 * S
    return {
        "prop_ext": rng.randint(0, 3, (B, P, S)).astype(np.uint8),
        "prop_coor": rng.uniform(-1, W, (B, P, S)).astype(np.float32),
        "prop_offset": rng.randn(B, P, S, W).astype(np.float32),
        "prop_offset_mask": rng.randint(0, 2, (B, P, S, W)).astype(
            np.float32),
        "lc_orient": rng.randint(0, 11, (B, S, S)).astype(np.uint8),
        "semantic_label_raw": rng.randint(0, 3, (B, img, img)).astype(
            np.uint8),
        "endp_map": np.where(rng.rand(B, img, img) > 0.99,
                             rng.rand(B, img, img), 0).astype(np.float32),
        "prop_inst": np.where(rng.rand(B, img, img) < 0.05,
                              rng.randint(0, 12, (B, img, img)),
                              255).astype(np.uint8),
        "prop_best": rng.randint(0, 12, (B, P)).astype(np.uint8),
        "initp": np.asarray([[[12.0, 3.0]], [[0.0, 0.0]]], np.float32),
        "endp": np.asarray([[[20.0, 9.0]], [[0.0, 0.0]]], np.float32)}


def test_loss_terms_and_row_transformer_gradient_match_jax():
    from lanemapping_tpu.models.head_losses import (column_proposal_loss as
                                                    jax_loss)
    from lanemapping_tpu.models.row_head_base import (
        endp_regression_loss as jax_endp_reg)
    from lanemapping_tpu_torch.models.head_losses import column_proposal_loss
    from lanemapping_tpu_torch.models.row_head_base import \
        endp_regression_loss
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    from test_torch_port_train_losses import f64_seg_focal

    jh, th = heads("Regr")
    ins = inputs()
    variables = random_variables(jh, [jnp.asarray(a) for a in ins], 3)
    load_head(th, variables)
    batch = label_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(params):
        out, _ = jh.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *[jnp.asarray(a) for a in ins], train=True,
                          mutable=["batch_stats"])
        # the net attaches the encoder's maps; stand-ins as the JAX test's
        out["endp_est"] = out["endpoint"]
        out["semantic_seg"] = jnp.zeros((2, 8 * S, 8 * S, 3), jnp.float32)
        res = jax_loss(out, jbatch, HP)
        return res["loss"], (res["loss_stats"],
                             jax_endp_reg(out, jbatch, img_size=8 * S))

    (jl, (jstats, jreg)), jg = jax.device_get(jax.jit(jax.value_and_grad(
        jfn, has_aux=True))(variables["params"]))

    out = to_nhwc(th.train()(*map(nchw, ins)))
    out["endp_est"] = out["endpoint"]
    out["semantic_seg"] = torch.zeros(2, 8 * S, 8 * S, 3)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    res = column_proposal_loss(out, tbatch, HP)
    reg = endp_regression_loss(out, tbatch, img_size=8 * S).detach()
    res["loss"].backward()
    res["loss_stats"] = {k: v.detach() for k, v in res["loss_stats"].items()}

    assert set(res["loss_stats"]) == set(jstats) == set(TERMS)
    for k in TERMS:
        if k != "binary_seg_loss":
            assert float(res["loss_stats"][k]) == pytest.approx(
                float(jstats[k]), rel=1e-5, abs=1e-7), k
    pw, coor, ext = 2, batch["prop_coor"], batch["prop_ext"]
    pos = np.where((coor >= W) | (coor < 0) | (ext == 0), 0.0, ext).sum(2) > 2
    want = f64_seg_focal(out["prop_seg_small"].detach().numpy(),
                         batch["prop_inst"], batch["prop_best"], pos, S, W,
                         pw)
    assert float(res["loss_stats"]["binary_seg_loss"]) == pytest.approx(
        want, rel=1e-6)
    assert float(reg) == pytest.approx(float(jreg), rel=1e-6)
    assert 0.0 < float(reg)

    want_g = params_from_jax({"heads": jg}, {}, head_rules())
    held = [k for k in want_g if k.startswith("heads.tr_row_correlator.")]
    assert len(held) == 11  # one block: every weight and bias of it
    for k in held:
        g = th.get_parameter(k[len("heads."):]).grad
        assert float(g.abs().max()) > 0, k
        assert rel_max_err(g.numpy(), want_g[k].numpy()) < 2e-3, k


# ---------------------------------------------------------------------------
# the head in a tiny Detector1stage, through both Runners

NAMES = [f"{190000 + i:06d}_{i:04d}" for i in range(4)]
# a weight seed whose decode decisions clear float32 rounding (asserted)
SEED = 2
MARGIN = 1e-4


def base_configs():
    cfgs = configs()
    for cfg in cfgs:
        cfg.merge_from_dict({"heads.type": "RowSharNotReducRef_Base",
                             "heads.dim_token": 64, "heads.tr_heads": 4,
                             "heads.tr_dim_head": 16,
                             "heads.tr_mlp_dim": 128,
                             "heads.row_dim_token": 32,
                             "heads.row_tr_heads": 4,
                             "heads.row_tr_dim_head": 8,
                             "heads.row_tr_mlp_dim": 64})
    return cfgs


def test_detector_validate_and_export_match_jax_runner(tmp_path):
    import lanemapping_tpu as lm
    from lanemapping_tpu.decode.lane_decode import decode_lanes
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from test_torch_port_zoo_runner import jax_stub, loaders
    from torch_port_helpers import port_runner

    root = str(tmp_path / "data")
    generate_dataset(root, n_tiles=4, img=192, seed=5, splits={
        "train": NAMES[:2], "valid": NAMES[2:], "test": NAMES[2:]})
    cfg_j, cfg_t = base_configs()
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.log_dir = str(tmp_path / "log")
    cfg_j.endp_decode = "exact_topk"  # the port's top-k is exact
    jm = lm.build_model(cfg_j)
    variables = random_variables(jm, (jnp.zeros((1, 192, 192, 3)),), SEED)
    runner = port_runner(cfg_t, variables, tmp_path / "log")
    assert runner.head_type == "RowSharNotReducRef_Base"
    stub = jax_stub(jm, variables, cfg_j)

    for batch in loaders((cfg_j, cfg_t))[1]:
        out = jax.device_get(stub._eval_step(stub.state,
                                             stub._eval_input(batch)))
        assert_clear_of_thresholds(jax.device_get(decode_lanes(out, cfg_j)),
                                   cfg_j, margin=MARGIN,
                                   clamped_columns=True)
    metrics = runner.validate()
    want = stub._validate_lanes(loaders((cfg_j, cfg_t))[1], None)
    assert set(metrics) == set(want)
    for k in want:
        assert metrics[k] == pytest.approx(want[k], abs=1e-12), k

    dirs = {p: str(tmp_path / p) for p in ("port", "jax")}
    port_loader, jloader = loaders((cfg_j, cfg_t), "test")
    runner.infer_and_export(port_loader, dirs["port"])
    stub.infer_and_export(jloader, dirs["jax"])
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["port"])) == \
        [n + ".json" for n in NAMES[2:]]
    got, want = ([json.load(open(os.path.join(d, f))) for f in files]
                 for d in (dirs["port"], dirs["jax"]))
    assert_same_records(got, want)
    assert sum(map(len, want)) > 0
