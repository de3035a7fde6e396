"""The port's training losses against the JAX package's on the CPU.

- the primitives of `ops/losses.py` within 1e-6, the cross-entropy's
  labels -1 and 255 clipped into [0, C-1] as the JAX package clips them;
- ``column_proposal_loss``: every one of the 10 terms within rel 1e-5 on a
  real batch of a synthetic LaserLane dataset at ``configs/tiny_test.py``
  (seeded random head outputs), on edge batches (no valid vertex, no
  orient label, no endpoint) and with ``cls_smooth`` on; its gradient with
  respect to every head output within rel-max 2e-3 of ``jax.grad``;
- the fused per-proposal seg focal (GT windows built on the device from
  ``prop_inst`` / ``prop_best``) against the unfused one (the
  full-resolution logits against the dataset's windowed GT), with
  ``seg_focal_chunks`` 1 and 2, and against a float64 evaluation;
- ``head_hparams`` of both shipped configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (REPO, TINY, configs, rel_max_err,
                                wire_data_root)

TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss")


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "optax_sigmoid_ce",
                                  "smooth_l1",
                                  "cross_entropy_with_int_labels"])
def test_loss_primitive_matches_jax(name):
    import lanemapping_tpu.ops.losses as jl
    import lanemapping_tpu_torch.ops.losses as tl

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 50, 5) * 3.0).astype(np.float32)
    if name == "cross_entropy_with_int_labels":
        y = rng.randint(-1, 7, (4, 50)).astype(np.int32)
        y[0, :3] = (-1, 255, 5)  # clipped to 0, 4, 4
        args = (x, y)
    else:
        y = rng.uniform(0.0, 1.0, x.shape).astype(np.float32)
        y[0] = (y[0] > 0.5)
        args = (x, y)
    want = np.asarray(getattr(jl, name)(*map(jnp.asarray, args)))
    got = getattr(tl, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if name == "cross_entropy_with_int_labels":
        logp = torch.log_softmax(torch.from_numpy(x[0, :3]), -1)
        np.testing.assert_allclose(
            got[0, :3], -logp[[0, 1, 2], [0, 4, 4]].numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def loss_setup(tmp_path_factory):
    """A real batch (the port's shipping) of the tiny config and seeded
    random head outputs shaped like the port's."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    cfg_j, cfg_t = configs(TINY)
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
    batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    runner = Runner(cfg_t, log_dir=str(tmp_path_factory.mktemp("logs")),
                    device="cpu")
    db = {k: v.numpy() for k, v in runner._device_batch(batch).items()}
    S, P = cfg_t.heads.row_size, cfg_t.heads.num_prop
    W = cfg_t.heads.prop_width + 2 * cfg_t.heads.prop_half_buff
    B, img = db["prop_ext"].shape[0], 8 * S
    rng = np.random.RandomState(7)
    shapes = {"semantic_seg": (B, img, img, 3), "endp_est": (B, img, img, 1),
              "orient": (B, S, S, 11), "proposal_conf": (B, P, 2),
              "ext2": (B, P, S, 3), "cls2": (B, P, S, W),
              "offset2": (B, P, S, W), "prop_seg_small": (B, P, 2 * S, 2 * W)}
    out = {k: (rng.randn(*s) * 2.0).astype(np.float32)
           for k, s in shapes.items()}
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, root=root, batch=batch, db=db,
                out=out)


def edge_batch(db, kind):
    db = dict(db)
    if kind == "no_valid_vertex":
        db["prop_ext"] = np.zeros_like(db["prop_ext"])
    elif kind == "no_orient":
        db["lc_orient"] = np.zeros_like(db["lc_orient"])
    elif kind == "no_endpoint":
        db["endp_map"] = np.zeros_like(db["endp_map"])
    return db


def both_losses(cfg_j, cfg_t, out, db, **hp_over):
    from lanemapping_tpu.models.head_losses import (column_proposal_loss as
                                                    jax_loss, head_hparams as
                                                    jax_hp)
    from lanemapping_tpu_torch.models.head_losses import (
        column_proposal_loss, head_hparams)

    hp_j, hp_t = jax_hp(cfg_j), head_hparams(cfg_t)
    hp_j.update(hp_over)
    hp_t.update(hp_over)

    def jfun(o):
        res = jax_loss(o, {k: jnp.asarray(v) for k, v in db.items()}, hp_j)
        return res["loss"], res["loss_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        jfun, has_aux=True))({k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.from_numpy(v).requires_grad_() for k, v in out.items()}
    res = column_proposal_loss(tout, {k: torch.from_numpy(v)
                                      for k, v in db.items()}, hp_t)
    res["loss"].backward()
    return (res, {k: v.grad for k, v in tout.items()},
            (jloss, jstats, jax.device_get(jgrads)))


@pytest.mark.parametrize("kind", ["real", "no_valid_vertex", "no_orient",
                                  "no_endpoint", "cls_smooth"])
def test_column_proposal_loss_matches_jax(loss_setup, kind):
    s = loss_setup
    over = {}
    if kind == "cls_smooth":
        over = {"cls_smooth": True, "cls_smooth_loss_w": 10.0}
    db = edge_batch(s["db"], kind)
    res, grads, (jloss, jstats, jgrads) = both_losses(
        s["cfg_j"], s["cfg_t"], s["out"], db, **over)
    for k in TERMS:
        got, want = float(res["loss_stats"][k].detach()), float(jstats[k])
        assert got == pytest.approx(want, rel=1e-5, abs=1e-7), k
    assert float(res["loss"].detach()) == pytest.approx(float(jloss),
                                                        rel=1e-5)
    zero = {"no_valid_vertex": ("cls_loss2", "cls_mean_loss2",
                                "offset_loss"),
            "no_orient": ("orient_loss",), "no_endpoint": ("endp_loss",),
            "cls_smooth": ()}.get(kind, ())
    for k in zero:
        assert float(res["loss_stats"][k].detach()) == 0.0, k
    if kind == "cls_smooth":
        assert float(res["loss_stats"]["cls_smooth_loss2"].detach()) > 0.0
    for k, g in grads.items():
        assert rel_max_err(g.numpy(), jgrads[k]) < 2e-3, k


def f64_seg_focal(seg_small, inst, best, pos, S, W, pw):
    """The per-proposal seg focal term in float64 numpy: upsample, window
    the 255-padded instance map, focal, positive proposals, / (S*S*8*B)."""
    from lanemapping_tpu_torch.ops.interp import _interp_matrix_np

    hb = (W - pw) // 2
    uh = _interp_matrix_np(2 * S, 8 * S).astype(np.float64)
    uw = _interp_matrix_np(2 * W, 8 * W).astype(np.float64)
    x = np.einsum("oh,bphw,vw->bpov", uh, seg_small.astype(np.float64), uw)
    pad = np.pad(inst, ((0, 0), (0, 0), (8 * hb, 8 * hb)),
                 constant_values=255)
    B, P = best.shape
    st, wf = 8 * pw, 8 * W
    y = np.stack([np.stack([pad[b][:, p * st:p * st + wf] == best[b, p]
                            for p in range(P)]) for b in range(B)])
    p_ = 1.0 / (1.0 + np.exp(-x))
    ce = np.maximum(x, 0) - x * y + np.log1p(np.exp(-np.abs(x)))
    p_t = p_ * y + (1 - p_) * (1 - y)
    f = ce * (1 - p_t) ** 2 * (0.25 * y + 0.75 * (1 - y))
    return float((f * pos[:, :, None, None]).sum() / (S * S * 8 * B))


@pytest.mark.parametrize("chunks", [1, 2])
def test_fused_seg_focal_matches_unfused(loss_setup, chunks):
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.models.head_losses import (
        _fused_prop_seg_focal, column_proposal_loss, head_hparams)
    from lanemapping_tpu_torch.ops.interp import _interp_matrix_np

    s = loss_setup
    cfg = s["cfg_t"]
    hp = head_hparams(cfg)
    hp["seg_focal_chunks"] = chunks
    db = {k: torch.from_numpy(v) for k, v in s["db"].items()}
    seg = torch.from_numpy(s["out"]["prop_seg_small"]).requires_grad_()
    ext, coor = db["prop_ext"].float(), db["prop_coor"]
    W = hp["prop_fea_width"]
    ext = torch.where((coor >= W) | (coor < 0) | (ext == 0), 0.0, ext)
    pos = ext.sum(2) > 2.0
    assert pos.any() and not pos.all()
    fused = _fused_prop_seg_focal(seg, db["prop_inst"], db["prop_best"],
                                  pos, hp)
    fused.backward()
    g_fused = seg.grad.clone()

    # unfused: the dataset's windowed GT of the same tiles
    cfg.fused_seg_focal = False
    try:
        full = next(iter(build_dataloader(cfg.dataset.train, cfg)))
        hp_u = head_hparams(cfg)
    finally:
        cfg.fused_seg_focal = True
    assert list(full["image_name"]) == list(s["batch"]["image_name"])
    S = hp["row_size"]
    uh = torch.from_numpy(_interp_matrix_np(2 * S, 8 * S))
    uw = torch.from_numpy(_interp_matrix_np(2 * W, 8 * W))
    seg.grad = None
    out = {k: torch.from_numpy(v) for k, v in s["out"].items()}
    out["prop_seg_small"] = seg
    out["prop_bi_seg"] = uh @ seg @ uw.T
    ub = dict(db, prop_bi_seg=torch.from_numpy(full["prop_bi_seg"]))
    unfused = column_proposal_loss(out, ub, hp_u)["loss_stats"][
        "binary_seg_loss"]
    unfused.backward()
    assert float(fused.detach()) == pytest.approx(float(unfused.detach()),
                                                  rel=1e-6)
    assert rel_max_err(g_fused.numpy(), seg.grad.numpy()) < 1e-5
    want = f64_seg_focal(s["out"]["prop_seg_small"], s["db"]["prop_inst"],
                         s["db"]["prop_best"], pos.numpy(), S, W,
                         hp["prop_width"])
    assert float(fused.detach()) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("config", ["Proj_polyline_fpn_vit_vertex_2.py",
                                    "Proj_polyline_lidarconv_vit_vertex_2.py"])
def test_head_hparams_match_jax(config):
    import os

    from lanemapping_tpu.models.head_losses import head_hparams as jax_hp
    from lanemapping_tpu_torch.models.head_losses import head_hparams

    cfg_j, cfg_t = configs(os.path.join(REPO, "configs", config))
    assert head_hparams(cfg_t) == jax_hp(cfg_j)
