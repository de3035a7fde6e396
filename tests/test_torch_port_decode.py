"""The port's decode and host postprocess against the JAX package.

``decode_lanes`` runs on identical raw head maps (numpy seed) in both
packages; the JAX side uses ``endp_decode='exact_topk'`` (the port's
``torch.topk`` is exact; the JAX default ``approx_max_k`` is a TPU partial
reduction).  The host postprocess is a copy, so the same decode dict must
give bit-identical lane maps and lane records."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import configs

B, S, P, W, IMG = 2, 24, 12, 10, 192


def raw_maps(seed):
    """Raw head maps at the tiny config's shapes (NHWC image maps), with a
    few Gaussian endpoint blobs over noise so clustering has real work."""
    rng = np.random.RandomState(seed)
    endp = rng.normal(-4.0, 0.5, (B, IMG, IMG, 1))
    yy, xx = np.mgrid[:IMG, :IMG]
    for b in range(B):
        for _ in range(6):
            cy, cx = rng.uniform(25, IMG - 25, 2)
            endp[b, :, :, 0] += 8.0 * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0 ** 2))
    m = {
        "proposal_conf": rng.randn(B, P, 2),
        "ext2": rng.randn(B, P, S, 3) * 2.0,
        "cls2": rng.randn(B, P, S, W) * 3.0,
        "offset2": rng.randn(B, P, S, W),
        "orient": rng.randn(B, S, S, 11),
        "semantic_seg": rng.randn(B, IMG, IMG, 3),
        "endp_est": endp,
    }
    return {k: v.astype(np.float32) for k, v in m.items()}


def decode_both(maps, endp_decode):
    from lanemapping_tpu.decode.lane_decode import decode_lanes as dec_j
    from lanemapping_tpu_torch.decode.lane_decode import decode_lanes as dec_t

    cfg_j, cfg_t = configs()
    cfg_j.endp_decode = cfg_t.endp_decode = endp_decode
    want = {k: np.asarray(v) for k, v in dec_j(
        {k: jnp.asarray(v) for k, v in maps.items()}, cfg_j).items()}
    got = {k: v.numpy() for k, v in dec_t(
        {k: torch.tensor(v) for k, v in maps.items()}, cfg_t).items()}
    return got, want, cfg_j, cfg_t


@pytest.mark.parametrize("endp_decode", ["exact_topk", "exact_host"])
def test_decode_lanes_matches_jax(endp_decode):
    got, want, _, _ = decode_both(raw_maps(0), endp_decode)
    assert set(got) == set(want)
    for k in ("prop_v_ext", "orient", "endp_valid", "endp_coords"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("prop_conf", "prop_cls_conf", "bi_seg_rows", "cls", "cls_exp",
              "cls_offset") + (("endp_logits",)
                               if endp_decode == "exact_host" else ()):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    if endp_decode == "exact_topk":
        assert 4 <= want["endp_valid"].sum(axis=1).min()


def test_cluster_peaks_matches_jax_on_chains():
    """A chain of points 5 px apart spans far more than the radius and is
    still one cluster (single linkage); a sentinel group and isolated
    points form their own clusters."""
    from lanemapping_tpu.decode.lane_decode import cluster_peaks as cp_j
    from lanemapping_tpu_torch.decode.lane_decode import cluster_peaks

    rng = np.random.RandomState(1)
    chain = np.stack([np.arange(40) * 5.0, 100 + rng.uniform(-1, 1, 40)], 1)
    lone = rng.uniform(300, 900, (20, 2))
    sentinel = np.full((10, 2), -1e4)
    pts = np.concatenate([chain, lone, sentinel])[rng.permutation(70)]
    pts = pts.astype(np.float32)
    rc, rv = cluster_peaks(torch.tensor(pts)[None], 10.0)
    want_c, want_v, n = cp_j(jnp.asarray(pts), 10.0)
    np.testing.assert_array_equal(rv[0].numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(rc[0].numpy()[rv[0].numpy()],
                                  np.asarray(want_c)[np.asarray(want_v)])
    assert int(rv.sum()) == int(n) <= 22


def test_window_expectation_matches_jax():
    from lanemapping_tpu.decode.lane_decode import window_expectation as we_j
    from lanemapping_tpu_torch.decode.lane_decode import window_expectation

    rng = np.random.RandomState(2)
    logits = rng.randn(64, W).astype(np.float32)
    for i in range(W):  # argmax at every column, edges included
        logits[i, i] += 10.0
    probs = torch.softmax(torch.tensor(logits), -1).numpy()
    np.testing.assert_allclose(window_expectation(torch.tensor(probs)).numpy(),
                               np.asarray(we_j(jnp.asarray(probs))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("endp_decode", ["exact_topk", "exact_host"])
def test_postprocess_gives_bit_identical_lane_records(endp_decode):
    from lanemapping_tpu.decode.postprocess import \
        lane_maps_from_decode as post_j
    from lanemapping_tpu.tools.export_lanes import lane_records as rec_j
    from lanemapping_tpu_torch.decode.lane_decode import host_decode_view
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.tools.export_lanes import lane_records

    _, want, cfg_j, cfg_t = decode_both(raw_maps(3), endp_decode)
    dec = host_decode_view(want)  # one decode dict for both packages
    maps_j = post_j({k: v.copy() for k, v in dec.items()}, cfg_j)
    maps_t = lane_maps_from_decode({k: v.copy() for k, v in dec.items()},
                                   cfg_t)
    for k in maps_j:
        for a, b in zip(maps_t[k], maps_j[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
    recs_t = [lane_records(p) for p in maps_t["cls_offset_smooth"]]
    recs_j = [rec_j(p) for p in maps_j["cls_offset_smooth"]]
    assert recs_t == recs_j
    assert sum(map(len, recs_t)) > 0


def test_native_tracker_builds_from_the_ports_copy():
    from lanemapping_tpu_torch import native

    lib = native.get_lib()
    assert lib is not None
    built = os.path.realpath(native._LIB)
    pkg = os.path.realpath(os.path.dirname(os.path.dirname(native.__file__)))
    assert built.startswith(os.path.join(pkg, "_build") + os.sep)
    assert os.path.dirname(native._SRC) == os.path.dirname(native.__file__)
