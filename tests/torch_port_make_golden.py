#!/usr/bin/env python
"""Write the golden set, ``tests/torch_port_golden/``: the JAX package's
outputs at the deployment shapes, from seeded weights and inputs.

    JAX_PLATFORMS=cpu python tests/torch_port_make_golden.py [--search]

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

The tests (``tests/test_torch_port_golden_*.py``) call the same ``p*``
functions to hold the stored set to what the JAX package computes now.
"""

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
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
    args = ap.parse_args(argv)
    os.makedirs(G.GOLDEN_DIR, exist_ok=True)
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
