"""The slice's losses against the JAX package on the CPU:
``row_shar_loss``, ``grid_seg_loss`` (both label conventions),
``pixel_seg_loss`` and ``segmentor_loss``, each term and its gradient
with respect to every head output, on seeded outputs and labels; and the
row head's parameter and input gradients through its loss, where the
write-back passes the gradient to the last writer only.

Bars, as for the column head's loss: loss terms within rel 1e-5,
gradients within rel-max 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import rel_max_err

RTOL = 1e-5
GTOL = 2e-3
B, S, N = 2, 24, 12


def lane_labels(rng, n_lanes=N, bg=255, shift=0):
    """[B,S,S] int label grids: each lane a column walk, skipping some
    rows and doubling others; background ``bg``; ids start at ``shift``."""
    label = np.full((B, S, S), bg, np.int64)
    for b in range(B):
        for n in rng.choice(n_lanes, 5, replace=False):
            col = rng.randint(0, S)
            for r in range(S):
                col = int(np.clip(col + rng.randint(-1, 2), 0, S - 2))
                if rng.rand() < 0.15:
                    continue
                label[b, r, col] = n + shift
                if rng.rand() < 0.1:
                    label[b, r, col + 1] = n + shift
    return label


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def compare(jax_loss, port_loss, out, batch):
    """Loss terms and the gradient w.r.t. every output, both packages."""
    def jfn(o):
        res = jax_loss(o, {k: jnp.asarray(v) for k, v in batch.items()})
        return res["loss"], res["loss_stats"]

    (jl, jstats), jg = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in out.items()}
    res = port_loss(tout, {k: torch.tensor(v) for k, v in batch.items()})
    res["loss"].backward()
    assert set(res["loss_stats"]) == set(jstats)
    for k in jstats:
        np.testing.assert_allclose(float(res["loss_stats"][k].detach()),
                                   float(jstats[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(float(res["loss"].detach()), float(jl),
                               rtol=RTOL)
    for k in out:
        g, w = tout[k].grad, np.asarray(jg[k])
        if not np.any(w):
            assert g is None or not g.any(), k
            continue
        assert rel_max_err(g.numpy(), w) < GTOL, k
    return res


def test_row_shar_loss_matches_jax():
    from lanemapping_tpu.models.row_head import row_shar_loss as jloss
    from lanemapping_tpu_torch.models.row_head import row_shar_loss

    rng = np.random.RandomState(0)
    out = {"ext": softmax(rng.randn(B, N, S, 2)),
           "cls": softmax(2 * rng.randn(B, N, S, S)),
           "ext2": softmax(rng.randn(B, N, S, 2)),
           "cls2": softmax(2 * rng.randn(B, N, S, S))}
    label = lane_labels(rng)
    # more columns than row_size: the loss reads the first row_size
    label = np.concatenate([label, np.full((B, S, 4), 3)], axis=2)
    kw = dict(n_lanes=N, row_size=S, lambda_cls=0.7)
    res = compare(lambda o, b: jloss(o, b, **kw),
                  lambda o, b: row_shar_loss(o, b, **kw), out,
                  {"label": label.astype(np.int16)})
    assert all(float(v.detach()) > 0 for v in res["loss_stats"].values())


@pytest.mark.parametrize("dataset_type", ["LaserLane", "KLane"])
def test_grid_seg_loss_matches_jax(dataset_type):
    from lanemapping_tpu.models.row_head import grid_seg_loss as jloss
    from lanemapping_tpu_torch.models.row_head import grid_seg_loss

    rng = np.random.RandomState(1)
    C = 13
    # LaserLane labels 0 = background, lanes 1..12; KLane 255 background
    bg, shift = (0, 1) if dataset_type == "LaserLane" else (255, 0)
    label = lane_labels(rng, bg=bg, shift=shift)
    label[0, 0, :3] = [bg, 12 if shift else 11, shift]  # an asymmetric row
    out = {"conf": (1 / (1 + np.exp(-rng.randn(B, S, S)))).astype(
               np.float32),
           "cls": rng.randn(B, S, S, C).astype(np.float32)}
    kw = dict(num_classes=C, dataset_type=dataset_type)
    compare(lambda o, b: jloss(o, b, **kw),
            lambda o, b: grid_seg_loss(o, b, **kw), out,
            {"label": label.astype(np.int16)})


def test_grid_seg_loss_flips_both_label_axes():
    """The loss scores the output against the label grid flipped in rows
    and columns: an output that is the flipped one-hot of the labels has
    a lower class loss than the unflipped one."""
    from lanemapping_tpu_torch.models.row_head import grid_seg_loss

    rng = np.random.RandomState(2)
    label = torch.tensor(lane_labels(rng, bg=0, shift=1))
    cls_lb = torch.where(label == 0, 12, label - 1)
    onehot = torch.nn.functional.one_hot(cls_lb, 13).float() * 20.0
    conf = (label != 0).float()
    losses = [grid_seg_loss({"conf": c, "cls": o}, {"label": label}, 13)
              for c, o in ((conf.flip(1, 2), onehot.flip(1, 2)),
                           (conf, onehot))]
    assert float(losses[0]["loss_stats"]["cls"]) < 1e-6
    assert float(losses[0]["loss_stats"]["conf"]) < 1e-6
    assert float(losses[1]["loss_stats"]["cls"]) > 1.0


def test_pixel_seg_loss_matches_jax():
    from lanemapping_tpu.models.row_head import pixel_seg_loss as jloss
    from lanemapping_tpu_torch.models.row_head import pixel_seg_loss

    rng = np.random.RandomState(3)
    label = lane_labels(rng, bg=0, shift=1)
    label = np.concatenate([label, np.zeros((B, S, 5), np.int64)], axis=2)
    out = {"cls": rng.randn(B, S, S, 7).astype(np.float32)}
    kw = dict(num_classes=7)
    compare(lambda o, b: jloss(o, b, **kw),
            lambda o, b: pixel_seg_loss(o, b, **kw), out,
            {"label": label.astype(np.int16)})


@pytest.mark.parametrize("endp_dtype", ["uint8", "float32"])
def test_segmentor_loss_matches_jax(endp_dtype):
    """Tile 0 holds endpoints, tile 1 at most one unit of heatmap (its
    endpoint term is masked out); the heatmap ships as its PNG uint8 or
    as float."""
    from lanemapping_tpu.models.head_losses import segmentor_loss as jloss
    from lanemapping_tpu_torch.models.head_losses import segmentor_loss

    rng = np.random.RandomState(4)
    H = 64
    endp = np.zeros((B, H, H), np.uint8)
    yy, xx = np.mgrid[:H, :H]
    for cy, cx in ((10, 20), (40, 50)):
        endp[0] = np.maximum(endp[0], (255 * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)).astype(np.uint8))
    endp[1, 5, 5] = 200
    if endp_dtype == "float32":
        endp = endp.astype(np.float32) / 255.0
    out = {"semantic_seg": rng.randn(B, H, H, 3).astype(np.float32),
           "endp_est": rng.randn(B, H, H, 1).astype(np.float32)}
    batch = {"mask": rng.randint(0, 3, (B, H, H)).astype(np.uint8),
             "endp_map": endp}
    res = compare(jloss, segmentor_loss, out, batch)
    assert float(res["loss_stats"]["endp_loss"].detach()) > 0


def test_row_head_gradients_match_jax():
    """Parameter and input gradients of the row head through
    ``row_shar_loss`` in training mode, at the seed whose windows overlap
    between gated lanes (`test_torch_port_zoo_models.py`)."""
    from lanemapping_tpu.models.row_head import row_shar_loss as jloss
    from lanemapping_tpu_torch.models.row_head import row_shar_loss
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax
    from test_torch_port_zoo_models import ROW_KW, ROW_SEED, row_setup

    x, jm, variables, tm, rules, wrap = row_setup(ROW_SEED)
    label = lane_labels(np.random.RandomState(5)).astype(np.int16)
    kw = dict(n_lanes=N, row_size=S)

    def jfn(params, xin):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xin,
                          train=True, mutable=["batch_stats"])
        return jloss(out, {"label": jnp.asarray(label)}, **kw)["loss"]

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        variables["params"], jnp.asarray(x))
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    loss = row_shar_loss(tm.train()(xt), {"label": torch.tensor(label)},
                         **kw)["loss"]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL)
    assert rel_max_err(xt.grad.permute(0, 2, 3, 1).numpy(),
                       np.asarray(jgx)) < GTOL
    want = params_from_jax(wrap(jax.device_get(jgp)), {}, rules)
    got = {"heads." + n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_max_err(got[k].numpy(), w.numpy()) < GTOL, k
    assert ROW_KW["thr_ext"] == tm.thr_ext
