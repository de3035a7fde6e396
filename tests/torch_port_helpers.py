"""Shared set-up for the tests that hold ``lanemapping_tpu_torch`` (the
PyTorch/CUDA port) to ``lanemapping_tpu`` (the JAX reference) on the CPU.

Weights and inputs come from numpy seeds and pass between the packages as
numpy arrays.  The flax variables are drawn directly in the shapes that
``jax.eval_shape(model.init)`` reports: running flax's own initialisers for
the tiny model costs ~20 s on this CPU, the shape trace ~1 s.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.py")
TINY_LIDAR = os.path.join(REPO, "configs", "tiny_test_lidar.py")


def configs(path=TINY):
    """(JAX Config, port Config) of one config file."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    return lm.Config.fromfile(path), lmt.Config.fromfile(path)


def random_variables(module, example_args, seed):
    """Seeded {params, batch_stats} numpy trees shaped like
    ``module.init(key, *example_args, train=False)``: kernels ~ N(0,
    1/fan_in), biases ~ N(0, 0.1^2), norm scales ~ U(0.8, 1.2), BatchNorm
    running means ~ N(0, 0.1^2) and variances ~ U(0.6, 1.4), embeddings
    ~ N(0, 1)."""
    shapes = jax.eval_shape(
        lambda k: module.init(k, *example_args, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "var":
            v = rng.uniform(0.6, 1.4, shape)
        elif leaf == "pos_embedding":
            v = rng.normal(0.0, 1.0, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def tiny_models(seed=0, endp_mode=None):
    """(JAX Detector1stage, its variables, port Detector1stage with the same
    weights, JAX cfg, port cfg) at ``configs/tiny_test.py``."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = configs()
    if endp_mode:
        cfg_j.heads.endp_mode = cfg_t.heads.endp_mode = endp_mode
    img = cfg_j.list_img_size_xy[0]
    jmodel = lm.build_model(cfg_j)
    variables = random_variables(jmodel, (jnp.zeros((1, img, img, 3)),),
                                 seed)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    return jmodel, variables, tmodel, cfg_j, cfg_t


def lidar_example(n_points):
    """The raw-point input ``model.init`` traces the LiDAR net with."""
    return {"points": jnp.zeros((1, n_points, 4)),
            "points_mask": jnp.ones((1, n_points), bool)}


def tiny_lidar_models(seed=0, **overrides):
    """(JAX Detector1stage, its variables, port Detector1stage with the same
    weights, JAX cfg, port cfg) at ``configs/tiny_test_lidar.py``, with
    top-level config ``overrides`` set in both."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = configs(TINY_LIDAR)
    for k, v in overrides.items():
        cfg_j[k] = cfg_t[k] = v
    jmodel = lm.build_model(cfg_j)
    variables = random_variables(jmodel, (lidar_example(cfg_j.max_points),),
                                 seed)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    return jmodel, variables, tmodel, cfg_j, cfg_t


def lane_clouds(seeds, img, n_points):
    """[len(seeds), n_points, 4] float32 lane-structured clouds (raw LAS
    intensity scaled to [0, 1] as `load_lidar_points` does) and an all-True
    mask with the last eighth of each cloud masked out as padding."""
    from lanemapping_tpu_torch.data.synthetic import (lane_structured_points,
                                                      random_lane_seqs)
    pts = []
    for s in seeds:
        rng = np.random.RandomState(s)
        seqs = random_lane_seqs(rng, img=img, n_lanes=4)
        p = lane_structured_points(seqs, [1, 2, 1, 2], img, rng, n_points)
        p[:, 3] = (np.clip(p[:, 3], 800.0, 33000.0) - 800.0) / 33000.0
        pts.append(p.astype(np.float32))
    mask = np.ones((len(seeds), n_points), bool)
    mask[:, -n_points // 8:] = False
    return np.stack(pts), mask


def jax_apply(module, variables, *args, **kw):
    out = jax.jit(lambda v, *a: module.apply(v, *a, train=False, **kw))(
        variables, *args)
    return jax.tree.map(np.asarray, out)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_max_err(got, want) -> float:
    """max |got - want| / max(1e-3, max |want|) — the bar of the existing
    torch-parity harness (`tests/test_torch_parity.py:452`), 2e-3 in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max()))


def assert_clear_of_thresholds(dec, cfg, margin=1e-4, img=192,
                               clamped_columns=False):
    """Proposal confidence off its threshold; at every vertex the host
    keeps, the column argmax off a tie and the column off an integer (the
    tracker truncates it to a cell).  With ``clamped_columns``, columns
    that are exact integers are left out: decode clamps the in-window
    offset to the window width (`lane_decode.py:207-209`), which gives the
    same integer in both packages."""
    conf = dec["prop_conf"][..., 1]
    assert np.abs(conf - cfg.proposal_obj_thre).min() > margin
    kept = (conf >= cfg.proposal_obj_thre)[..., None] \
        & (dec["prop_v_ext"] > 0.5)
    probs = np.sort(dec["prop_cls_conf"], axis=-1)
    assert (probs[..., -1] - probs[..., -2])[kept].min() > margin
    coors = dec["cls_offset"] / cfg.heads.row_size * img
    frac = np.abs(coors - np.round(coors))
    check = kept & (coors > 0)
    if clamped_columns:
        check &= frac > 0
    assert frac[check].min() > margin


def assert_same_records(got, want):
    """Same lanes, vertex rows and semantics; columns to 1e-3 px (float32
    rounding differs between the packages)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(r["lane_id"], r["seq_len"]) for r in g] == \
            [(r["lane_id"], r["seq_len"]) for r in w]
        for rg, rw in zip(g, w):
            sg, sw = np.asarray(rg["seq"]), np.asarray(rw["seq"])
            np.testing.assert_array_equal(sg[:, [0, 2]], sw[:, [0, 2]])
            np.testing.assert_allclose(sg[:, 1], sw[:, 1], atol=1e-3)
