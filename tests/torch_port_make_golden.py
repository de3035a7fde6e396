#!/usr/bin/env python
"""Write the golden set, ``tests/torch_port_golden/``: the JAX package's
outputs at the deployment shapes, from seeded weights and inputs.

    JAX_PLATFORMS=cpu python tests/torch_port_make_golden.py [--search]
    JAX_PLATFORMS=cpu python tests/torch_port_make_golden.py --train

Needed again only when the JAX package, one of its ``data/synthetic.py``
generators or the seeds of ``torch_port_golden.py`` change.  It writes the
weight manifests (``<config>_variables.json``: every leaf of
``jax.eval_shape(model.init)`` in the order ``random_variables`` draws
them), one ``.npz`` per path and ``golden.json`` (seeds, their decision
screens, input digests).  ``--search`` first looks for input seeds whose
device decisions clear their thresholds by ``MARGIN`` and whose lanes
survive perturbations at the port's float32 error (``screen``), and prints
them (set them in ``torch_port_golden.SEEDS``).

The paths run the JAX package's own entry points, at full width:

- P1: ``api.LaneMapper.map_arrays`` on two 1152 px tiles (float32; its
  ``Runner._eval_decode``), the head outputs from ``Runner._eval_step``;
- P2: the device program of ``tools/stream_map.py`` on P1's tiles, the
  state cast to bf16 as that script casts it;
- P3: that program with ``--from-las`` (``ops/voxelize.py::
  bev_image_from_points`` with ``tools/las2bev.py::las2bev_params``) on a
  cloud of 2^19 points, the network in float32;
- P4: that program on the LiDAR config (``use_lidar``), state cast to bf16,
  and the z-fold grid of ``ops/voxelize.py::voxelize_bev_zfold``.

``--train`` writes the training members instead (~20 min, ~15 GB; the
serving members and the manifests stay as they are): T0, the first two
batches of a seeded LaserLane set as the Runner ships them
(``golden_train.json``); T1-T3, three steps of the flagship in float32
and in bf16 and of the LiDAR config as it ships, from a seeded
mid-training Adam state, each beside the JAX package in float64
(``float64_jax``), kept as terms, per-leaf digests of the step-0 gradient
and of the parameter change, and the BatchNorm statistics
(``t1_flagship_f32.npz``, ``t2_flagship_bf16.npz``, ``t3_lidar.npz``).

The tests (``tests/test_torch_port_golden_*.py``) call the same ``p*``
and ``grads_fn`` functions to hold the stored set to what the JAX package
computes now.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import threading
import zipfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_port_golden as G  # noqa: E402
from torch_port_helpers import lidar_example, seeded_jax_runners  # noqa: E402

MARGIN = 1e-4
# the host screen of a seed (`unstable_draws`): seeded perturbations at the
# size of the port's float32 error against JAX on the CPU at full width
# (columns: median 9.2e-5 px, 99th percentile 6.1e-4, largest 1.1e-3;
# conf rows: 99th percentile 9.0e-6, largest 2.1e-5)
STABLE_DRAWS = 8
COL_SIGMA_PX = 5e-4
CONF_SIGMA = 1e-5


def jax_config(name):
    """The config on one device, as one card serves it (the tests' virtual
    8-device CPU would otherwise replicate every Runner program 8 times)."""
    import lanemapping_tpu as lm
    cfg = lm.Config.fromfile(os.path.join(G.REPO, G.CONFIGS[name]))
    cfg.mesh_shape = {"data": 1}
    return cfg


def example_input(cfg):
    if cfg.get("use_lidar", False):
        return lidar_example(G.N_POINTS)
    img = cfg.list_img_size_xy[0]
    return jnp.zeros((1, img, img, 3))


def manifest(name):
    """The leaves of the config's flax variables, in draw order."""
    import lanemapping_tpu as lm
    cfg = jax_config(name)
    model = lm.build_model(cfg)
    shapes = jax.eval_shape(
        lambda k: model.init(k, example_input(cfg), train=False),
        jax.random.PRNGKey(0))
    leaves = [[[p.key for p in path], list(s.shape)]
              for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    return {"config": G.CONFIGS[name].replace(os.sep, "/"),
            "rule": "torch_port_helpers.random_variables",
            "leaves": leaves}


def variables(name):
    return G.draw_variables(G.load_manifest(name), G.WEIGHT_SEEDS[name])


@contextlib.contextmanager
def seeded_runner(cfg, variables_):
    """A JAX ``Runner`` of ``cfg`` holding ``variables_``."""
    from lanemapping_tpu.engine.runner import Runner
    with seeded_jax_runners(variables_), \
            tempfile.TemporaryDirectory() as tmp:
        yield Runner(cfg, log_dir=tmp)


def cast_state(state, cfg):
    """``tools/stream_map.py:94-100``: a bf16 config's state in bf16."""
    if cfg.get("compute_dtype") != "bfloat16":
        return state
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if hasattr(x, "dtype") and x.dtype == jnp.float32
                        else x, state)


def stream_program(model, cfg, kind):
    """The device program of ``tools/stream_map.py:118-147`` (``kind``
    ``las``, ``lidar`` or ``image``): (head outputs, the readback view it
    ships, the network input, the float decode view with the column
    probabilities)."""
    from lanemapping_tpu.decode.lane_decode import (decode_lanes,
                                                    host_decode_view)
    from lanemapping_tpu.engine.state import make_eval_step
    from lanemapping_tpu.ops.voxelize import bev_image_from_points
    from lanemapping_tpu.tools.las2bev import las2bev_params

    eval_step = make_eval_step(model)
    cdt = jnp.bfloat16 if cfg.get("compute_dtype") == "bfloat16" \
        else jnp.float32
    las_p = las2bev_params(cfg)
    img = cfg.list_img_size_xy[0]

    def fwd(state, inp):
        if kind == "las":
            f = lambda p, m: bev_image_from_points(  # noqa: E731
                p, m, las_p["pc_range"], img, gain=las_p["gain"],
                bias=las_p["bias"], fill_iters=las_p["fill_iters"])
            x = jax.vmap(f)(inp["points"], inp["points_mask"])
            x = jnp.broadcast_to(x[..., None].astype(cdt), x.shape + (3,))
        elif kind == "lidar":
            x = inp
        else:
            x = (inp.astype(jnp.float32) / 255.0).astype(cdt)
            if x.shape[-1] == 1:
                x = jnp.broadcast_to(x, x.shape[:-1] + (3,))
        out = eval_step(state, x)
        dec = decode_lanes(out, cfg)
        view = {**host_decode_view(dec), "prop_cls_conf": dec["prop_cls_conf"]}
        keep = host_decode_view(dec)
        keep.pop("cls", None)
        keep.pop("cls_exp", None)
        keep["bi_seg_rows"] = jnp.round(
            jnp.clip(keep["bi_seg_rows"], 0.0, 1.0) * 255.0).astype(
                jnp.uint8)
        keep["prop_v_ext"] = keep["prop_v_ext"].astype(jnp.uint8)
        keep["orient"] = keep["orient"].astype(jnp.int8)
        return out, keep, x, view

    return jax.jit(fwd)


def squeeze(view):
    """The stream's readback squeeze (above) of a float view, on the host."""
    keep = {k: v for k, v in view.items()
            if k not in ("cls", "cls_exp", "prop_cls_conf")}
    keep["bi_seg_rows"] = np.round(np.clip(
        keep["bi_seg_rows"], 0.0, 1.0) * np.float32(255.0)).astype(np.uint8)
    keep["prop_v_ext"] = keep["prop_v_ext"].astype(np.uint8)
    keep["orient"] = keep["orient"].astype(np.int8)
    return keep


def host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def postprocess(keep, cfg):
    from lanemapping_tpu.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu.tools.export_lanes import lane_records
    keep = {k: v for k, v in keep.items() if k != "prop_cls_conf"}
    return G.lane_results(keep, cfg, lane_maps_from_decode, lane_records)


def tile_view(view, b):
    return {k: v[b:b + 1] for k, v in view.items()}


def structure(results):
    """Lane ids, lengths, vertex rows and semantics, and endpoints."""
    return [([(x["lane_id"], x["seq_len"],
               [(int(v[0]), int(v[2])) for v in x["seq"]])
              for x in r["lanes"]], np.asarray(r["endpoints"]).tolist())
            for r in results]


def unstable_draws(view, cfg, stream):
    """Of ``STABLE_DRAWS`` seeded perturbations of a one-tile float decode
    view (columns by N(0, COL_SIGMA_PX) px, the conf rows by N(0,
    CONF_SIGMA), then the stream's squeeze if ``stream``), how many change
    the lanes' structure or endpoints: the host tracker, thinning and NMS
    cut columns to cells and compare conf values, so decisions near a
    cell border or a tie turn float32 noise into other lanes.  Columns on
    an integer and conf values of exactly 0 or 1 stay: the decode's clamps
    and the softmax's saturation give them in both packages."""
    view = {k: v for k, v in view.items() if k != "prop_cls_conf"}
    lanes = lambda v: structure(postprocess(  # noqa: E731
        squeeze(v) if stream else v, cfg))
    base = lanes(view)
    rng = np.random.RandomState(0)
    cell = COL_SIGMA_PX * cfg.heads.row_size / cfg.list_img_size_xy[0]
    changed = 0
    for _ in range(STABLE_DRAWS):
        v = dict(view)
        col = v["cls_offset"] * np.float32(cfg.list_img_size_xy[0]
                                           / cfg.heads.row_size)
        v["cls_offset"] = np.where(col == np.round(col), v["cls_offset"], (
            v["cls_offset"] + rng.normal(0.0, cell, col.shape)).astype(
                np.float32))
        conf = v["bi_seg_rows"]
        v["bi_seg_rows"] = np.where((conf == 0) | (conf == 1), conf, (
            conf + rng.normal(0.0, CONF_SIGMA, conf.shape)).astype(
                np.float32))
        changed += lanes(v) != base
    return changed


def screen(view, cfg, stream):
    """(least device margin, unstable draws) of each tile."""
    return [(G.threshold_margin(tile_view(view, b), cfg),
             unstable_draws(tile_view(view, b), cfg, stream))
            for b in range(len(view["prop_conf"]))]


def p1(tiles, screened=True):
    """P1: ``LaneMapper.map_arrays`` in float32; heads from the Runner's
    eval forward; each tile's ``screen`` unless not ``screened``."""
    import lanemapping_tpu as lm
    cfg = jax_config("flagship")
    x = tiles.astype(np.float32) / 255.0
    with seeded_jax_runners(variables("flagship")), \
            tempfile.TemporaryDirectory() as tmp:
        mapper = lm.LaneMapper(cfg, log_dir=tmp)
        results = mapper.map_arrays(x)
        runner = mapper.runner
        out = host(runner._eval_step(runner.state, x))
        if screened:
            view = host(stream_program(runner.model, cfg, "image")(
                runner.state, tiles))[3]
    rec = {**G.pack_heads(out), **G.pack_lanes(results)}
    return rec, {"screen": screen(view, cfg, False)} if screened else {}


def p2(tiles):
    """P2: the bf16 stream program on P1's tiles."""
    cfg = jax_config("flagship")
    with seeded_runner(cfg, variables("flagship")) as runner:
        out, keep, _, _ = host(stream_program(runner.model, cfg, "image")(
            cast_state(runner.state, cfg), tiles))
    results = postprocess(keep, cfg)
    rec = {**G.pack_heads(out, with_moments=False),
           "lane_counts": np.array(G.lane_counts(results), np.int32)}
    return rec, {"lane_counts": G.lane_counts(results)}


def p3(points, mask, screened=True):
    """P3: the ``--from-las`` program, network in float32."""
    from lanemapping_tpu.ops.voxelize import rasterize_bev_intensity
    from lanemapping_tpu.tools.las2bev import las2bev_params
    cfg = jax_config("flagship")
    cfg.compute_dtype = "float32"
    with seeded_runner(cfg, variables("flagship")) as runner:
        out, keep, x, view = host(stream_program(runner.model, cfg, "las")(
            runner.state, {"points": points, "points_mask": mask}))
    p = las2bev_params(cfg)
    _, cnt = jax.jit(lambda a, m: rasterize_bev_intensity(
        a, m, p["pc_range"], G.IMG, flip_rows=True))(points[0], mask[0])
    rec = {**G.pack_heads(out), **G.pack_lanes(postprocess(keep, cfg)),
           "bev": x[..., 0]}
    cnt = np.asarray(cnt).astype(np.int32)
    info = {"bev_counts": G.digest(cnt)}
    if screened:
        info["screen"] = screen(view, cfg, True)
    return rec, info


def p4(points, mask, screened=True):
    """P4: the LiDAR program as the stream serves it (bf16 state, float32
    points), and the z-fold grid the encoder reads."""
    from lanemapping_tpu.ops.voxelize import voxelize_bev_zfold
    cfg = jax_config("lidar")
    with seeded_runner(cfg, variables("lidar")) as runner:
        out, keep, _, view = host(stream_program(
            runner.model, cfg, "lidar")(cast_state(runner.state, cfg),
                                        {"points": points,
                                         "points_mask": mask}))
    grid = jax.jit(lambda a, m: voxelize_bev_zfold(
        a, m, cfg.lidar_point_cloud_range, cfg.grid_size))(points[0],
                                                           mask[0])
    rec = {**G.pack_heads(out), **G.pack_lanes(postprocess(keep, cfg)),
           **G.voxel_record(np.asarray(grid))}
    return rec, {"screen": screen(view, cfg, True)} if screened else {}



# == training: T0-T3 (``--train``) ==========================================

def _taps(shape, kernel, strides, dilation):
    """Per kernel tap, its index and the slices of a VALID convolution's
    input it meets (channels-last, ``shape`` the input's)."""
    import itertools
    n = len(kernel)
    out = [(shape[1 + i] - (kernel[i] - 1) * dilation[i] - 1) // strides[i]
           + 1 for i in range(n)]
    for tap in itertools.product(*[range(k) for k in kernel]):
        yield tap, (slice(None),) + tuple(
            slice(t * d, t * d + (o - 1) * s + 1, s)
            for t, d, o, s in zip(tap, dilation, out, strides)), out


# XLA runs independent callbacks on several threads at once, and numpy's
# BLAS gives wrong products when called from several threads at once (the
# float64 flagship step came out different on every run, up to 3e-3 on a
# term): one callback at a time
_BLAS = threading.Lock()


def _conv_np(x, w, strides, dilation):
    """VALID float64 convolution, channels-last: a float64 matrix product
    per kernel tap (numpy's BLAS)."""
    out = None
    with _BLAS:
        for tap, sl, _ in _taps(x.shape, w.shape[:-2], strides, dilation):
            y = np.tensordot(x[sl], w[tap], axes=([x.ndim - 1], [0]))
            out = y if out is None else out + y
    return out


def _conv_np_vjp(x, w, dy, strides, dilation):
    dx, dw = np.zeros_like(x), np.zeros_like(w)
    g = dy.reshape(-1, dy.shape[-1])
    with _BLAS:
        for tap, sl, _ in _taps(x.shape, w.shape[:-2], strides, dilation):
            dw[tap] = x[sl].reshape(-1, x.shape[-1]).T @ g
            dx[sl] += (g @ w[tap].T).reshape(x[sl].shape)
    return dx, dw


def tap_conv(lhs, rhs, window_strides, padding, lhs_dilation=None,
             rhs_dilation=None, dimension_numbers=None,
             feature_group_count=1, batch_group_count=1, precision=None,
             preferred_element_type=None):
    """``lax.conv_general_dilated`` of float64 operands, computed on the
    host as a sum over the kernel's taps of float64 matrix products (XLA's
    CPU backend has no fast float64 convolution: a 3x3 64-channel layer
    at 144^2 takes 40x its float32 time, a flagship step in float64 over
    30 min; and a sum of taps inside XLA keeps ~78 GB of temporaries at
    full width); padding and input dilation stay in XLA.  Other operands
    go to the original.  Held to the original in float64, value and
    gradient, by `tests/test_torch_port_golden_train.py`."""
    if lhs.dtype != jnp.float64 or feature_group_count != 1 \
            or batch_group_count != 1:
        return _LAX_CONV(lhs, rhs, window_strides, padding, lhs_dilation,
                         rhs_dilation, dimension_numbers, feature_group_count,
                         batch_group_count, precision, preferred_element_type)
    from jax import lax
    n = lhs.ndim - 2
    dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape, dimension_numbers)
    x = jnp.transpose(lhs, (dn.lhs_spec[0], *dn.lhs_spec[2:], dn.lhs_spec[1]))
    w = jnp.transpose(rhs, (*dn.rhs_spec[2:], dn.rhs_spec[1], dn.rhs_spec[0]))
    w = w.astype(jnp.float64)
    strides = tuple(window_strides)
    dilation = tuple(rhs_dilation or (1,) * n)
    lhs_dilation = tuple(lhs_dilation or (1,) * n)
    if any(d > 1 for d in lhs_dilation):
        x = lax.pad(x, jnp.zeros((), x.dtype), [(0, 0, 0)] + [
            (0, 0, d - 1) for d in lhs_dilation] + [(0, 0, 0)])
    kernel = w.shape[:n]
    if isinstance(padding, str):
        padding = lax.padtype_to_pads(
            x.shape[1:-1], [(k - 1) * d + 1 for k, d in zip(kernel,
                                                           dilation)],
            strides, padding)
    x = lax.pad(x, jnp.zeros((), x.dtype), [(0, 0, 0)] + [
        (lo, hi, 0) for lo, hi in padding] + [(0, 0, 0)])
    out_sz = next(_taps(x.shape, kernel, strides, dilation))[2]
    out_t = jax.ShapeDtypeStruct((x.shape[0], *out_sz, w.shape[-1]),
                                 jnp.float64)

    @jax.custom_vjp
    def conv(x, w):
        return jax.pure_callback(
            lambda a, b: _conv_np(np.asarray(a), np.asarray(b), strides,
                                  dilation), out_t, x, w)

    def fwd(x, w):
        return conv(x, w), (x, w)

    def bwd(res, dy):
        x, w = res
        return jax.pure_callback(
            lambda a, b, g: _conv_np_vjp(np.asarray(a), np.asarray(b),
                                         np.asarray(g), strides, dilation),
            (jax.ShapeDtypeStruct(x.shape, x.dtype),
             jax.ShapeDtypeStruct(w.shape, w.dtype)), x, w, dy)

    conv.defvjp(fwd, bwd)
    out = conv(x, w)
    inv = [0] * (n + 2)
    for i, d in enumerate((dn.out_spec[0], *dn.out_spec[2:],
                           dn.out_spec[1])):
        inv[d] = i
    return jnp.transpose(out, inv)


_LAX_CONV = jax.lax.conv_general_dilated


@contextlib.contextmanager
def float64_jax():
    """The JAX package in float64: x64 enabled, float64 convolutions
    by ``tap_conv``, and the float32 that its losses
    (`models/head_losses.py`, `ops/losses.py`) and its attention
    (`models/transformer.py`) cast to read as float64 (their module's
    ``jnp`` seen through a proxy), so nothing of the step rounds to
    float32 but its inputs: the tile's /255, the points and the z-fold
    grid, the interpolation operators' float32 weights."""
    import pytest
    import lanemapping_tpu.models.head_losses as hl
    import lanemapping_tpu.models.transformer as tr
    import lanemapping_tpu.ops.losses as ol

    class Wide:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    # x64 for every thread: ``tap_conv``'s host callbacks run on XLA's
    # threads, where ``jax.enable_x64``'s thread-local setting would not
    # reach and their float64 operands would arrive as float32
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for mod in (hl, ol, tr):
                mp.setattr(mod, "jnp", Wide())
            mp.setattr(jax.lax, "conv_general_dilated", tap_conv)
            yield
    finally:
        jax.config.update("jax_enable_x64", was)


def train_config(name, root, **top):
    """The JAX config of ``name`` at ``G.TRAIN_BATCH`` on ``root``."""
    return G.wire_train(jax_config(name), root, **top)


def t0(root):
    """T0: the first two batches of the loader of each config on ``root``,
    shipped by the Runner's ``_device_batch``, with the GT cache off, on
    while it fills and on when it serves.  (info, {config: [batches]})."""
    from lanemapping_tpu.data.loader import build_dataloader
    from torch_port_helpers import jax_device_batch
    info, batches = {}, {}
    for name in G.CONFIGS:
        runs = []
        for cache in (False, True, True):
            cfg = train_config(name, root, gt_cache=cache)
            runs.append([(b["image_name"], jax_device_batch(cfg, b))
                         for b in build_dataloader(cfg.dataset.train, cfg)])
        recs = [[(n, G.batch_record(db)) for n, db in run] for run in runs]
        G.require(recs[0] == recs[1] == recs[2] and len(recs[0]) == 2,
                  f"T0 {name}: the GT cache changed the batches")
        info[name] = {"names": [n for n, _ in recs[0]],
                      "batches": [r for _, r in recs[0]]}
        batches[name] = [db for _, db in runs[0]]
    return info, batches


def grads_fn(model, cfg, cast, grad=True):
    """Jitted (params, batch_stats, batch) -> (terms with ``loss``, grads,
    new batch stats) of the differentiated function of
    `engine/state.py:84-99` with the parameter cast ``cast``; without
    ``grad``, -> the terms alone (the forward and the loss)."""
    from lanemapping_tpu.engine.state import model_input
    from lanemapping_tpu.models.head_losses import (column_proposal_loss,
                                                    head_hparams)
    hp = head_hparams(cfg)
    lidar = bool(cfg.get("use_lidar", False))
    cdt = jnp.bfloat16 if cast == "bf16" else None
    key = (model, cast, lidar, tuple(sorted(hp.items())),
           jax.config.jax_enable_x64, grad)
    try:  # one compile for equal nets (the tests' seeds)
        if key in _GRADS:
            return _GRADS[key]
    except TypeError:  # a net with unhashable fields
        key = None

    def inner(params, batch_stats, batch):
        params = jax.tree.map(CASTS[cast], params)
        out, upd = model.apply({"params": params, "batch_stats": batch_stats},
                               model_input(batch, lidar, cdt), train=True,
                               mutable=["batch_stats"])
        res = column_proposal_loss(out, batch, hp)
        return res["loss"], ({**res["loss_stats"], "loss": res["loss"]},
                             upd["batch_stats"])

    @jax.jit
    def run(params, batch_stats, batch):
        if not grad:
            return inner(params, batch_stats, batch)[1][0]
        (_, (terms, bs)), g = jax.value_and_grad(inner, has_aux=True)(
            params, batch_stats, batch)
        return terms, g, bs
    if key is not None:
        _GRADS[key] = run
    return run


_GRADS = {}


# the parameter casts: none; the flagship's bf16 (`engine/state.py:85-88`);
# the LiDAR step's bf16 rounding in float64 (flax promotes the bf16 weights
# against the float32 grid, so in float64 the rounded weights widen again)
CASTS = {"none": lambda x: x,
         "bf16": lambda x: x.astype(jnp.bfloat16)
         if x.dtype == jnp.float32 else x,
         "bf16_round": lambda x: x.astype(jnp.bfloat16).astype(x.dtype)}


def reference_step(model, cfg, tx, cast):
    """A jitted copy of `engine/state.py::make_train_step`'s step with the
    cast ``cast`` that also returns the gradient (the float64 runs: the
    JAX step casts only float32 parameters).  (state, batch) -> (state,
    terms, grads)."""
    import optax
    run = grads_fn(model, cfg, cast)

    @jax.jit
    def step(state, batch):
        terms, g, bs = run(state.params, state.batch_stats, batch)
        upd, opt = tx.update(g, state.opt_state, state.params)
        return state.replace(params=optax.apply_updates(state.params, upd),
                             batch_stats=bs, opt_state=opt,
                             step=state.step + 1), terms, g
    return step


def torch_layout(params, batch_stats, cfg):
    """Flax trees -> {torch name: float64 numpy} by the port's rules."""
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax, rules_for
    sd = params_from_jax(jax.device_get(params), jax.device_get(batch_stats),
                         rules_for(cfg), dtype=np.float64)
    return {k: v.numpy() for k, v in sd.items()}


def to_f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


def train_run(name, cfg, variables, batch, adam, mode, steps=None):
    """Step 0's terms and gradient, then ``G.TRAIN_STEPS`` steps from the
    Adam state ``adam``: mode ``f64`` (`reference_step` under
    `float64_jax`), ``f32`` or ``bf16`` (the gradient from `grads_fn`, the
    steps from the JAX package's ``make_train_step``).  {terms [steps,
    terms], grads, params before and after, batch_stats after} (torch
    layout, float64)."""
    import lanemapping_tpu as lm
    from torch_port_helpers import (jax_train_state, jax_train_step,
                                    with_adam_state)
    lidar = name == "lidar"
    model = lm.build_model(cfg)
    mu, nu, count = adam
    ctx = float64_jax() if mode == "f64" else contextlib.nullcontext()
    with ctx:
        tx, state = jax_train_state(cfg, variables)
        if mode == "f64":
            state = state.replace(params=to_f64(state.params),
                                  batch_stats=to_f64(state.batch_stats))
            opt = tx.init(state.params)
            state = state.replace(opt_state=with_adam_state(
                opt, to_f64(mu), to_f64(nu), count))
            step = reference_step(model, cfg, tx,
                                  "bf16_round" if lidar else "none")
        else:
            state = state.replace(opt_state=with_adam_state(
                state.opt_state, mu, nu, count))
            cast = "bf16" if mode == "bf16" else "none"
            grads = grads_fn(model, cfg, cast)
            cfg.train_compute_dtype = "bfloat16" if cast == "bf16" \
                else "float32"
            jstep = jax_train_step(model, tx, cfg)
        before = torch_layout(state.params, state.batch_stats, cfg)
        terms, g0 = [], None
        for i in range(steps or G.TRAIN_STEPS):
            if mode == "f64":
                state, t, g = step(state, batch)
            else:
                if i == 0:
                    _, g, _ = grads(state.params, state.batch_stats, batch)
                state, t = jstep(state, batch, jax.random.PRNGKey(0))
            if i == 0:
                g0 = torch_layout(g, {}, cfg)
            t = {k: float(v) for k, v in jax.device_get(t).items()}
            G.require(all(np.isfinite(list(t.values()))), f"{mode}: {t}")
            terms.append(G.term_vector(t))
            print(f"  {name} {mode} step {i}: loss {t['loss']!r}", flush=True)
        after = torch_layout(state.params, state.batch_stats, cfg)
    return {"terms": np.stack(terms), "grads": g0, "before": before,
            "after": after}


def adam_for(name, cfg, variables, batch, mode):
    """The manifest record and the trees of the seeded mid-training Adam
    state of ``name``: its per-leaf RMS from the gradient of the step as
    it ships (``mode``), its moments by `G.draw_adam` (held bit for bit to
    `mid_training_adam` here)."""
    from torch_port_helpers import mid_training_adam
    _, g, _ = grads_fn(__import__("lanemapping_tpu").build_model(cfg), cfg,
                       mode)(variables["params"], variables["batch_stats"],
                             batch)
    g = jax.tree.map(lambda a: np.asarray(a, np.float32), jax.device_get(g))
    leaves = G.flat_leaves(g)
    rec = {"seed": G.TRAIN_SEEDS["adam"], "count": G.ADAM_COUNT,
           "leaves": [[list(p), list(a.shape)] for p, a in leaves],
           "rms": G.grad_rms(g)}
    adam = G.golden_adam(name, {"adam": {name: rec}})
    want = mid_training_adam(g, rec["seed"], rec["count"])
    for a, b in zip(jax.tree.leaves(adam[:2]), jax.tree.leaves(want[:2])):
        G.require(a.dtype == b.dtype and np.array_equal(a, b),
                  "draw_adam is not mid_training_adam")
    return rec, adam


def digests(plan, prefix, run, ref):
    """The members of one run: its terms, the digests of its step-0
    gradient and of its parameter change, the exact per-leaf distances of
    both from the reference run ``ref`` (None: ``run`` is the reference),
    its BatchNorm statistics after the steps."""
    change = {k: run["after"][k] - run["before"][k] for k in run["grads"]}
    rec = {f"terms_{prefix}": run["terms"],
           f"bn_{prefix}": G.bn_vector(run["after"])}
    rec.update(G.pack_digest("g" + prefix, G.vector_digest(plan,
                                                           run["grads"])))
    rec.update(G.pack_digest("d" + prefix, G.vector_digest(plan, change)))
    if ref is not None:
        ref_change = {k: ref["after"][k] - ref["before"][k]
                      for k in ref["grads"]}
        for key, got, want in (("g", run["grads"], ref["grads"]),
                               ("d", change, ref_change)):
            rec[f"dist_{key}{prefix}"] = np.array(
                [np.linalg.norm(got[p["name"]] - want[p["name"]])
                 for p in plan])
    return rec


def lidar_grids(cfg, batch):
    """T3's z-fold grids of the batch, one `G.voxel_record` a tile."""
    from lanemapping_tpu.ops.voxelize import voxelize_bev_zfold
    f = jax.jit(lambda a, m: voxelize_bev_zfold(
        a, m, cfg.lidar_point_cloud_range, cfg.grid_size))
    rec = {}
    for b in range(len(batch["points"])):
        grid = np.asarray(f(batch["points"][b], batch["points_mask"][b]))
        for k, v in G.voxel_record(grid, n_sample=G.TRAIN_VOXEL_SAMPLE
                                   ).items():
            rec[f"{k}_{b}"] = v
    return rec


def train_main():
    """Write T1-T3 and ``golden_train.json`` (T0's digests)."""
    from lanemapping_tpu.data import synthetic
    meta = {"batch": G.TRAIN_BATCH, "tiles": G.TRAIN_TILES,
            "points": G.TRAIN_POINTS, "steps": G.TRAIN_STEPS,
            "seeds": G.TRAIN_SEEDS, "weight_seeds": G.WEIGHT_SEEDS,
            "sub_per_leaf": G.SUB_PER_LEAF, "sketch_dim": G.SKETCH_DIM,
            "terms": list(G.TERMS), "seed_notes": G.TRAIN_SEED_NOTES,
            "adam": {}, "paths": {}}
    with tempfile.TemporaryDirectory() as root:
        G.train_dataset(root, synthetic)
        meta["t0"], batches = t0(root)
    print("t0", json.dumps(meta["t0"]["flagship"]["names"]), flush=True)
    for name, paths in (("flagship", ("t1", "t2")), ("lidar", ("t3",))):
        batch = batches[name][0]
        variables = G.draw_variables(G.load_manifest(name),
                                     G.WEIGHT_SEEDS[name])
        shipped = "bf16" if name == "lidar" else "none"
        cfg = lambda: train_config(name, "")  # noqa: E731
        meta["adam"][name], adam = adam_for(name, cfg(), variables, batch,
                                            shipped)
        ref = train_run(name, cfg(), variables, batch, adam, "f64")
        plan = G.digest_plan({k: v.shape for k, v in ref["grads"].items()})
        rec = digests(plan, "ref", ref, None)
        jax_mode = "bf16" if name == "lidar" else "f32"
        recs = {paths[0]: {**rec, **digests(plan, "jax", train_run(
            name, cfg(), variables, batch, adam, jax_mode), ref)}}
        if name == "lidar":
            recs["t3"].update(lidar_grids(cfg(), batch))
        else:
            recs["t2"] = digests(plan, "jax", train_run(
                name, cfg(), variables, batch, adam, "bf16"), ref)
        for path, r in recs.items():
            out = os.path.join(G.GOLDEN_DIR, G.TRAIN_PATHS[path])
            save_npz(out, r)
            meta["paths"][path] = {
                "config": name, "jax_mode": "bf16" if path == "t2"
                else jax_mode, "bytes": os.path.getsize(out),
                "leaves": [[p["name"], p["n"]] for p in plan],
                "terms_ref": ref["terms"].tolist(),
                "terms_jax": r["terms_jax"].tolist()}
            print(path, meta["paths"][path]["bytes"], flush=True)
    with open(os.path.join(G.GOLDEN_DIR, G.TRAIN_META), "w") as f:
        json.dump(meta, f, indent=1)

def save_npz(path, arrays):
    """``np.savez`` with LZMA members (``np.load`` reads them; 10% smaller
    than ``savez_compressed`` on these float maps) and a fixed member date,
    so the same arrays write the same bytes."""
    with zipfile.ZipFile(path, "w") as zf:
        for k, a in arrays.items():
            buf = io.BytesIO()
            np.lib.format.write_array(buf, np.asarray(a))
            zf.writestr(zipfile.ZipInfo(k + ".npy", (1980, 1, 1, 0, 0, 0)),
                        buf.getvalue(), compress_type=zipfile.ZIP_LZMA)


def inputs(seeds=None):
    """P1/P2's tiles, P3's and P4's clouds, from the JAX package's
    generators."""
    from lanemapping_tpu.data import synthetic
    seeds = seeds or G.SEEDS
    return {"tiles": G.golden_tiles(synthetic, seeds),
            "las_cloud": G.golden_cloud(synthetic, seeds["las_cloud"]),
            "lidar_cloud": G.golden_cloud(synthetic, seeds["lidar_cloud"])}


def first_seed(kind, view_of, cfg, stream, n_tries):
    """The first seed whose one-tile view clears ``MARGIN`` on the device
    and keeps its lanes under every perturbation (``unstable_draws``)."""
    for s in range(n_tries):
        (m, unstable), = screen(view_of(s), cfg, stream)
        print(f"{kind} seed {s}: margin {m:.3e}, {unstable} of "
              f"{STABLE_DRAWS} perturbed decodes change the lanes",
              flush=True)
        if m > MARGIN and unstable == 0:
            return s
    raise SystemExit(f"no {kind} seed of 0-{n_tries - 1} clears the screen")


def search(n_tries=300):
    """The first seed of each input that clears the screen (``screen``)."""
    from lanemapping_tpu.data import synthetic
    flag32 = jax_config("flagship")
    flag32.compute_dtype = "float32"
    lidar = jax_config("lidar")
    found = {}
    with seeded_runner(flag32, variables("flagship")) as fr:
        img_prog = stream_program(fr.model, flag32, "image")
        las_prog = stream_program(fr.model, flag32, "las")
        for kind, make in (("lane_tile", lambda s: G.lane_tile(synthetic, s)),
                           ("noise_tile", G.noise_tile)):
            found[kind] = first_seed(
                kind, lambda s: host(img_prog(fr.state, make(s)[None]))[3],
                flag32, False, n_tries)

        def las_view(s):
            pts, msk = G.golden_cloud(synthetic, s)
            return host(las_prog(fr.state, {"points": pts,
                                             "points_mask": msk}))[3]
        found["las_cloud"] = first_seed("las_cloud", las_view, flag32, True,
                                        n_tries)
    with seeded_runner(lidar, variables("lidar")) as lr:
        prog = stream_program(lr.model, lidar, "lidar")
        state = cast_state(lr.state, lidar)

        def lidar_view(s):
            pts, msk = G.golden_cloud(synthetic, s)
            return host(prog(state, {"points": pts, "points_mask": msk}))[3]
        found["lidar_cloud"] = first_seed("lidar_cloud", lidar_view, lidar,
                                          True, n_tries)
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--search", action="store_true",
                    help="print input seeds that clear the margin first")
    ap.add_argument("--train", action="store_true",
                    help="write the training members (T0-T3) instead")
    args = ap.parse_args(argv)
    os.makedirs(G.GOLDEN_DIR, exist_ok=True)
    if args.train:
        train_main()
        return
    for name in G.CONFIGS:
        with open(os.path.join(G.GOLDEN_DIR, f"{name}_variables.json"),
                  "w") as f:
            json.dump(manifest(name), f)
    if args.search:
        print(json.dumps(search()))
        return
    ins = inputs()
    meta = {"weight_seeds": G.WEIGHT_SEEDS, "seeds": G.SEEDS,
            "subsample": {k: repr(v) for k, v in G.SUBSAMPLE.items()},
            "inputs": {"tiles": G.digest(ins["tiles"]),
                       "las_cloud": [G.digest(a) for a in ins["las_cloud"]],
                       "lidar_cloud": [G.digest(a)
                                       for a in ins["lidar_cloud"]]},
            "paths": {}}
    runs = {"p1": lambda: p1(ins["tiles"]), "p2": lambda: p2(ins["tiles"]),
            "p3": lambda: p3(*ins["las_cloud"]),
            "p4": lambda: p4(*ins["lidar_cloud"])}
    for path, run in runs.items():
        rec, info = run()
        for margin, unstable in info.get("screen", []):
            G.require(margin > MARGIN and unstable == 0,
                      f"{path}: screen {info['screen']}")
        out = os.path.join(G.GOLDEN_DIR, G.PATHS[path])
        save_npz(out, rec)
        info["bytes"] = os.path.getsize(out)
        meta["paths"][path] = info
        print(path, json.dumps(info), flush=True)
    with open(os.path.join(G.GOLDEN_DIR, "golden.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
