"""The slice's decodes against the JAX package on the CPU, on the same
inputs, which must give identical results: ``decode_row_lanes``,
``row_lane_maps`` (both KLane heads), ``segmentor_infer`` with its
max-scatter of endpoint representatives, ``segmentor_displays`` and
``pixel_seg_decode``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

B, N, S = 2, 12, 24


def softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def row_head_out(seed):
    """Seeded stage-2 probabilities with lanes existing on some rows."""
    rng = np.random.RandomState(seed)
    ext = rng.randn(B, N, S, 2)
    ext[:, :5, :, 0] += 2.0  # lanes 0-4 exist on most rows
    return {"ext2": softmax(ext), "cls2": softmax(3 * rng.randn(B, N, S, S))}


def test_decode_row_lanes_matches_jax():
    from lanemapping_tpu.decode.row_decode import decode_row_lanes as jdec
    from lanemapping_tpu_torch.decode.row_decode import decode_row_lanes

    out = row_head_out(0)
    want = jdec({k: jnp.asarray(v) for k, v in out.items()}, N)
    got = decode_row_lanes({k: torch.tensor(v) for k, v in out.items()}, N)
    assert set(got) == set(want) == {"conf", "cls"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["conf"].sum() > 0


@pytest.mark.parametrize("head_type", ["RowSharNotReducRef", "GridSeg"])
def test_row_lane_maps_matches_jax(head_type):
    from lanemapping_tpu.config.config import Config as JConfig
    from lanemapping_tpu.decode.row_decode import decode_row_lanes as jdec
    from lanemapping_tpu.decode.row_decode import row_lane_maps as jmaps
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.decode.row_decode import row_lane_maps

    if head_type == "GridSeg":
        rng = np.random.RandomState(1)
        cls = rng.randn(B, S, S, N + 1).astype(np.float32)
        # lane pixels along column walks, drawn in the flipped frame
        for b in range(B):
            for n in range(4):
                col = rng.randint(2, S - 2)
                for r in range(S):
                    col = int(np.clip(col + rng.randint(-1, 2), 0, S - 1))
                    cls[b, S - 1 - r, S - 1 - col, n] += 6.0
        conf = (1 / (1 + np.exp(-rng.randn(B, S, S) - 1))).astype(
            np.float32)
        pred = {"conf": conf, "cls": cls}
    else:
        pred = {k: np.asarray(v) for k, v in jdec(
            {k: jnp.asarray(v) for k, v in row_head_out(2).items()},
            N).items()}
    cfg = dict(number_lanes=N, conf_thr=0.4)
    want = jmaps(pred, JConfig(cfg), head_type)
    got = row_lane_maps(pred, Config(cfg), head_type)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["cls_offset_smooth"][..., 0] > 0).sum() > 20


def seg_outputs(seed, H=96):
    """Semantic logits and an endpoint heatmap with three sharp blobs."""
    rng = np.random.RandomState(seed)
    seg = rng.randn(B, H, H, 3).astype(np.float32)
    endp = rng.randn(B, H, H, 1).astype(np.float32) - 3.0
    yy, xx = np.mgrid[:H, :H]
    for b in range(B):
        for cy, cx in ((30, 30), (36, 40), (70, 60)):
            endp[b, ..., 0] += 10 * np.exp(-((yy - cy - b) ** 2
                                             + (xx - cx) ** 2) / 1.5)
    return {"semantic_seg": seg, "endp_est": endp}


def test_segmentor_infer_matches_jax():
    from lanemapping_tpu.decode.seg_infer import segmentor_infer as jinf
    from lanemapping_tpu_torch.decode.seg_infer import segmentor_infer

    out = seg_outputs(3)
    kw = dict(seg_thre=0.1, n_lanes=N)
    want = jinf({k: jnp.asarray(v) for k, v in out.items()}, **kw)
    got = segmentor_infer({k: torch.tensor(v) for k, v in out.items()}, **kw)
    for k in ("seg", "endp"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    seg = got["seg"].numpy()
    assert set(np.unique(seg)) == {0, 1, 2}
    # raw scores, not a softmax: a pixel with p1 > p2 but p1 <= 0.1 is 0
    p = out["semantic_seg"]
    low = (p[..., 1] > p[..., 2]) & (p[..., 1] <= 0.1)
    assert low.any() and (seg[low] == 0).all()
    assert got["endp"].numpy().sum(axis=(1, 2)).min() >= 1


def test_segmentor_infer_endpoint_scatter_takes_the_max():
    """Two valid representatives on one pixel and an invalid one: the map
    holds 1 there (``amax``; an ``index_put`` could let the invalid
    slot's 0 win)."""
    import lanemapping_tpu_torch.decode.seg_infer as si

    coords = torch.tensor([[[10.0, 12.0], [10.0, 12.0], [10.0, 12.0],
                            [3.0, 4.0]]])
    valid = torch.tensor([[True, False, True, False]])
    orig = si.decode_endpoints
    try:
        si.decode_endpoints = lambda *a, **k: (coords, valid)
        got = si.segmentor_infer({"semantic_seg": torch.zeros(1, 16, 16, 3),
                                  "endp_est": torch.zeros(1, 16, 16, 1)})
    finally:
        si.decode_endpoints = orig
    endp = got["endp"][0]
    assert endp[10, 12] == 1.0 and endp.sum() == 1.0


def test_segmentor_displays_match_jax():
    from lanemapping_tpu.decode.seg_infer import segmentor_displays as jdisp
    from lanemapping_tpu_torch.decode.seg_infer import (segmentor_displays,
                                                        segmentor_infer)

    out = seg_outputs(4)
    pred = segmentor_infer({k: torch.tensor(v) for k, v in out.items()})
    proj = np.random.RandomState(5).rand(96, 96, 3).astype(np.float32)
    seg, endp = pred["seg"][0].numpy(), pred["endp"][0].numpy()
    for got, want in zip(segmentor_displays(proj, seg, endp),
                         jdisp(proj, seg, endp)):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_pixel_seg_decode_matches_jax():
    from lanemapping_tpu.models.row_head import pixel_seg_decode as jdec
    from lanemapping_tpu_torch.models.row_head import pixel_seg_decode

    cls = np.random.RandomState(6).randn(B, S, S, 7).astype(np.float32)
    want = jdec({"cls": jnp.asarray(cls)})
    got = pixel_seg_decode({"cls": torch.tensor(cls)})
    for k in ("cls_map", "rgb"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
