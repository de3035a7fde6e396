"""The golden set: outputs of the JAX package at the deployment shapes, kept
in ``tests/torch_port_golden/``, and everything that reads them without JAX.

This module imports neither ``jax`` nor ``lanemapping_tpu``: the CPU tests
and ``chip_smoke.py`` (on a card machine that has no JAX) both load it.
``tests/torch_port_make_golden.py`` writes the set with the JAX package.

- The weights are drawn from a seed: ``draw_variables(manifest, seed)``
  gives, bit for bit, the ``{params, batch_stats}`` numpy trees that
  ``torch_port_helpers.random_variables`` draws from the shapes of
  ``jax.eval_shape(model.init)``; the manifest
  (``<config>_variables.json``) lists those leaves in the order they are
  drawn.
- The inputs are rebuilt from seeds with a ``data/synthetic.py`` module
  (the JAX package's or the port's copy, which draw the same numbers) and
  checked against the stored digests.
- Four paths, one ``.npz`` each (``PATHS``): P1 the flagship on PNG tiles
  in float32 (`api.LaneMapper.map_arrays`), P2 the same tiles through the
  bf16 stream (`tools/stream_map.py`'s device program), P3 the flagship
  ``--from-las`` in float32 (Las2BEV on K1, then the network), P4 the
  LiDAR config (K1z) as the stream serves it.
- The bars (below) come from the port against the JAX package on the CPU at
  full width: head outputs within rel-max 4.9e-5, lane columns within
  5.1e-3 px, ``semantic_map`` differing at 2.3e-5 of its pixels, bf16
  outputs 2.0e-2 to 6.4e-2 from the float32 golden where JAX's own bf16 is
  2.5e-2 to 6.2e-2 from it; and a vertex of ~4,000 whose column the host
  tracker takes from another candidate at a near-tie
  (``COLUMN_FLIP_SHARE``).

The ``run_p*`` functions drive the port's entry points on a device (the
CPU in the tests, the card in ``chip_smoke.py``) and the ``check_*``
functions hold what they return to the golden set, raising
``AssertionError`` at the first bar that fails.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_DIR = os.path.join(HERE, "torch_port_golden")
CONFIGS = {"flagship": os.path.join("configs",
                                    "Proj_polyline_fpn_vit_vertex_2.py"),
           "lidar": os.path.join("configs",
                                 "Proj_polyline_lidarconv_vit_vertex_2.py")}
PATHS = {"p1": "p1_flagship_png.npz", "p2": "p2_flagship_bf16.npz",
         "p3": "p3_flagship_las.npz", "p4": "p4_lidar.npz"}
IMG = 1152
N_POINTS = 1 << 19
# weight and input seeds whose device decisions clear their thresholds by
# 1e-4 at full width and whose lanes survive perturbations at the port's
# float32 error (`tests/torch_port_make_golden.py --search`, the first seed
# from 0 of each input; margins and screens in golden.json).  At LiDAR
# weight seed 0 no cloud seed of 0-39 cleared the margin: ~5,000 kept
# vertices put some column argmax within 1e-5 of a tie.
WEIGHT_SEEDS = {"flagship": 0, "lidar": 1}
SEEDS = {"lane_tile": 5, "noise_tile": 3, "las_cloud": 2, "lidar_cloud": 46}

# -- the bars -------------------------------------------------------------
HEAD_REL_MAX = 2e-3      # float32 head outputs, rel-max (CPU: <= 4.9e-5)
MOMENT_REL = 1e-4        # moments of the full maps kept as a subsample
COLUMN_PX = 1e-2         # lane columns (CPU: <= 5.1e-3 px)
# the share of vertices whose column may differ by more: the host tracker
# picks the free vertex nearest its extrapolated column, and where two
# candidates tie within float32 noise it takes the other (P1 on the H100
# and on the CPU at batch 3: one vertex of 3,879 moved 10 px, where the
# column argmax at that row is 2.0e-3 from a tie)
COLUMN_FLIP_SHARE = 1e-3
SEMANTIC_SHARE = 1e-4    # share of semantic_map pixels that may differ
BEV_ABS = 1e-5           # P3's BEV tile, everywhere; its count map exact
VOXEL_ROW_REL = 1e-6     # P4's z-fold grid, per (row, channel) sums
VOXEL_CELL_ABS = 1e-5    # P4's sampled grid cells
BF16_SLOPE, BF16_FLOOR = 1.5, 1e-2   # d_port <= 1.5 d_jax + 1e-2
REGEN_REL = 1e-5         # the JAX package now against the stored set

# the head outputs: stored whole, or as a strided subsample beside the
# moments of the whole map
FULL_KEYS = ("proposal_conf", "ext2", "cls2", "offset2")
SUBSAMPLE = {
    # [B, S, S, 11]: every 4th row and column
    "orient": (slice(None), slice(None, None, 4), slice(None, None, 4)),
    # [B, P, 2S, 20]: every 2nd proposal, every 8th row
    "prop_seg_small": (slice(None), slice(None, None, 2),
                       slice(None, None, 8)),
    # [B, 8S, 8S, C]: the anchor rows 3::8 the decode reads, columns 3::16
    "semantic_seg": (slice(None), slice(3, None, 8), slice(3, None, 16)),
    "endp_est": (slice(None), slice(3, None, 8), slice(3, None, 16)),
}
VOXEL_SAMPLE = 65536
VOXEL_SAMPLE_SEED = 25


def require(cond, msg):
    """An assertion that ``python -O`` keeps."""
    if not cond:
        raise AssertionError(msg)


# -- the weights ------------------------------------------------------------

def load_manifest(name: str) -> Dict:
    with open(os.path.join(GOLDEN_DIR, f"{name}_variables.json")) as f:
        return json.load(f)


def draw_leaf(rng: np.random.RandomState, leaf: str, shape) -> np.ndarray:
    """One leaf by the rule of ``torch_port_helpers.random_variables``."""
    shape = tuple(shape)
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        v = rng.normal(0.0, fan_in ** -0.5, shape)
    elif leaf == "scale":
        v = rng.uniform(0.8, 1.2, shape)
    elif leaf == "var":
        v = rng.uniform(0.6, 1.4, shape)
    elif leaf in ("pos_embedding", "lane_emb"):
        v = rng.normal(0.0, 1.0, shape)
    elif leaf in ("w1", "w2"):
        v = rng.normal(0.0, shape[1] ** -0.5, shape)
    else:  # bias, mean
        v = rng.normal(0.0, 0.1, shape)
    return v.astype(np.float32)


def draw_variables(manifest: Dict, seed: int) -> Dict:
    """``{params, batch_stats}`` numpy trees drawn leaf by leaf in the
    manifest's order from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    tree: Dict = {}
    for path, shape in manifest["leaves"]:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = draw_leaf(rng, path[-1], shape)
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats", {})}


def flat_leaves(tree: Dict, prefix=()) -> List:
    """[(key path, leaf)] of a nested dict, keys sorted at every level."""
    out = []
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out += flat_leaves(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


# -- the inputs -------------------------------------------------------------

def lane_tile(synthetic, seed: int) -> np.ndarray:
    """[IMG, IMG, 3] uint8 lane-structured intensity tile."""
    rng = np.random.RandomState(seed)
    seqs = synthetic.random_lane_seqs(rng, img=IMG)
    sem = rng.randint(1, 3, len(seqs))
    return synthetic.render_intensity_image(seqs, IMG, rng, semantics=sem)


def noise_tile(seed: int) -> np.ndarray:
    """[IMG, IMG, 3] uint8 uniform noise."""
    return np.random.RandomState(seed).randint(
        0, 256, (IMG, IMG, 3)).astype(np.uint8)


def golden_tiles(synthetic, seeds=None) -> np.ndarray:
    """P1's and P2's [2, IMG, IMG, 3] uint8 tiles."""
    seeds = seeds or SEEDS
    return np.stack([lane_tile(synthetic, seeds["lane_tile"]),
                     noise_tile(seeds["noise_tile"])])


def golden_cloud(synthetic, seed: int):
    """([1, N, 4] float32 points, [1, N] mask) of 2^19 lane-structured
    points, intensity normalised as `data/las.py::load_lidar_points` does,
    the last eighth masked out as padding."""
    rng = np.random.RandomState(seed)
    seqs = synthetic.random_lane_seqs(rng, img=IMG, n_lanes=4)
    p = synthetic.lane_structured_points(seqs, [1, 2, 1, 2], IMG, rng,
                                         N_POINTS)
    p[:, 3] = (np.clip(p[:, 3], 800.0, 33000.0) - 800.0) / 33000.0
    mask = np.ones((1, N_POINTS), bool)
    mask[:, -N_POINTS // 8:] = False
    return p.astype(np.float32)[None], mask


def digest(a: np.ndarray) -> Dict:
    """sha256 of the bytes, and float64 sum and sum of squares."""
    a = np.ascontiguousarray(a)
    f = a.astype(np.float64)
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "shape": list(a.shape), "dtype": str(a.dtype),
            "sum": float(f.sum()), "sum_sq": float((f * f).sum())}


def check_digest(a: np.ndarray, want: Dict, what: str):
    """The same bytes, shape and dtype (the float64 sums are shown only:
    numpy may sum in another order on another CPU)."""
    got = digest(a)
    keys = ("sha256", "shape", "dtype")
    require(all(got[k] == want[k] for k in keys), f"{what}: rebuilt input "
            f"{got} differs from the golden set's {want}")


# -- head outputs -----------------------------------------------------------

def moments(a: np.ndarray) -> np.ndarray:
    """[B, 4] float64 (sum, sum |x|, sum x^2, max |x|) of each tile's map."""
    f = np.asarray(a, np.float64).reshape(len(a), -1)
    return np.stack([f.sum(1), np.abs(f).sum(1), (f * f).sum(1),
                     np.abs(f).max(1)], 1)


def pack_heads(out: Dict[str, np.ndarray], with_moments=True) -> Dict:
    """The stored form of a forward's head outputs (float32 numpy)."""
    rec = {}
    for k in FULL_KEYS:
        rec[f"full_{k}"] = np.asarray(out[k], np.float32)
    for k, sl in SUBSAMPLE.items():
        rec[f"sub_{k}"] = np.ascontiguousarray(np.asarray(out[k],
                                                          np.float32)[sl])
        if with_moments:
            rec[f"mom_{k}"] = moments(out[k])
    return rec


def rel_max(got, want) -> float:
    """max |got - want| / max(1e-3, max |want|) (the torch-parity bar's
    measure)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    require(got.shape == want.shape, f"shapes {got.shape} {want.shape}")
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max()))


def moment_rel(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative moment error; the sum is taken relative to the
    sum of magnitudes (a signed sum may cancel)."""
    scale = want[:, [1, 1, 2, 3]]
    return float((np.abs(got - want) / np.maximum(scale, 1e-30)).max())


def head_errors(got: Dict, golden, rows=None) -> Dict[str, float]:
    """{output: rel-max error} of packed heads ``got`` against ``golden``
    (an ``.npz`` or dict in the same form), the subsampled maps
    element by element and their moments as ``mom_<key>``; ``rows``
    picks the golden set's tiles."""
    sel = slice(None) if rows is None else list(rows)
    err = {}
    for k in FULL_KEYS:
        err[k] = rel_max(got[f"full_{k}"], golden[f"full_{k}"][sel])
    for k in SUBSAMPLE:
        err[k] = rel_max(got[f"sub_{k}"], golden[f"sub_{k}"][sel])
        if f"mom_{k}" in got and f"mom_{k}" in golden:
            err[f"mom_{k}"] = moment_rel(got[f"mom_{k}"],
                                         golden[f"mom_{k}"][sel])
    return err


def check_heads(err: Dict[str, float], what: str):
    for k, e in err.items():
        bar = MOMENT_REL if k.startswith("mom_") else HEAD_REL_MAX
        require(e <= bar, f"{what}: {k} rel-max {e:.3e} above {bar:g}")


def bf16_distances(port_bf16: Dict, jax_bf16, f32) -> Dict[str, Dict]:
    """Per output: d_port (the port's bf16 from the float32 golden), d_jax
    (JAX's bf16 golden from it) and the port's bf16 from JAX's, all
    rel-max on the stored elements."""
    d = {}
    for k in FULL_KEYS + tuple(SUBSAMPLE):
        key = f"full_{k}" if k in FULL_KEYS else f"sub_{k}"
        d[k] = {"d_port": rel_max(port_bf16[key], f32[key]),
                "d_jax": rel_max(jax_bf16[key], f32[key]),
                "port_vs_jax": rel_max(port_bf16[key], jax_bf16[key])}
    return d


def check_bf16(d: Dict[str, Dict], what: str):
    for k, v in d.items():
        bar = BF16_SLOPE * v["d_jax"] + BF16_FLOOR
        require(v["d_port"] <= bar, f"{what}: {k} d_port {v['d_port']:.3e} "
                f"above {BF16_SLOPE} * d_jax {v['d_jax']:.3e} + "
                f"{BF16_FLOOR}")


# -- lanes ------------------------------------------------------------------

def lane_results(dec: Dict[str, np.ndarray], cfg, lane_maps_from_decode,
                 lane_records, rows=None) -> List[Dict]:
    """Per tile (``rows`` of the batch, default all) the lane dict of
    ``LaneMapper.map_arrays``, from a host decode view, with either
    package's postprocess."""
    if rows is not None:
        dec = {k: v[list(rows)] for k, v in dec.items()}
    maps = lane_maps_from_decode(dec, cfg)
    return [{"lanes": lane_records(maps["cls_offset_smooth"][b]),
             "endpoints": np.argwhere(maps["endp_by_cls"][b] > 0),
             "semantic_map": maps["semantic_line"][b]}
            for b in range(len(maps["cls_offset_smooth"]))]


def pack_lanes(results: List[Dict]) -> Dict[str, np.ndarray]:
    rec = {}
    for b, r in enumerate(results):
        lanes = r["lanes"]
        rec[f"lane_meta_{b}"] = np.array(
            [[x["lane_id"], x["seq_len"]] for x in lanes],
            np.int32).reshape(-1, 2)
        rec[f"lane_seq_{b}"] = np.array(
            [v for x in lanes for v in x["seq"]], np.float64).reshape(-1, 3)
        rec[f"endp_{b}"] = np.asarray(r["endpoints"], np.int32).reshape(
            -1, 2)
        sem = np.asarray(r["semantic_map"])
        require(sem.min() >= 0 and sem.max() < 256, "semantic_map range")
        rec[f"semantic_{b}"] = sem.astype(np.uint8)
    return rec


def lane_figures(got: List[Dict], golden, rows: Sequence[int]) -> Dict:
    """Of each tile of ``got`` against golden tile ``rows[i]``: lane
    counts; whether lane ids, lengths, vertex rows and semantics agree and,
    where they do, the largest column difference (px) of the vertices
    within ``COLUMN_PX`` and the share of vertices beyond it
    (``col_flip_share``, largest difference ``col_flip_px``); whether the
    endpoints agree; the share of ``semantic_map`` pixels that differ."""
    fig = {"lanes": [], "lanes_golden": [], "same_structure": True,
           "same_endpoints": True, "col_px": 0.0, "col_flip_share": 0.0,
           "col_flip_px": 0.0, "semantic_share": 0.0}
    for r, row in zip(got, rows):
        g = pack_lanes([r])
        meta, want_meta = g["lane_meta_0"], golden[f"lane_meta_{row}"]
        fig["lanes"].append(len(meta))
        fig["lanes_golden"].append(len(want_meta))
        seq, want_seq = g["lane_seq_0"], golden[f"lane_seq_{row}"]
        same = meta.shape == want_meta.shape and (meta == want_meta).all() \
            and seq.shape == want_seq.shape \
            and (seq[:, [0, 2]] == want_seq[:, [0, 2]]).all()
        fig["same_structure"] &= bool(same)
        if same and len(seq):
            d = np.abs(seq[:, 1] - want_seq[:, 1])
            near = d <= COLUMN_PX
            fig["col_px"] = max(fig["col_px"], float(d[near].max(initial=0)))
            fig["col_flip_share"] = max(fig["col_flip_share"],
                                        float((~near).mean()))
            fig["col_flip_px"] = max(fig["col_flip_px"], float(d.max()))
        e, want_e = g["endp_0"], golden[f"endp_{row}"]
        fig["same_endpoints"] &= bool(e.shape == want_e.shape
                                      and (e == want_e).all())
        sem, want_sem = g["semantic_0"], golden[f"semantic_{row}"]
        require(sem.shape == want_sem.shape, "semantic_map shape")
        fig["semantic_share"] = max(fig["semantic_share"],
                                    float((sem != want_sem).mean()))
    return fig


def check_lanes(fig: Dict, what: str):
    require(fig["lanes"] == fig["lanes_golden"], f"{what}: lanes per tile "
            f"{fig['lanes']}, golden {fig['lanes_golden']}")
    require(fig["same_structure"], f"{what}: lane ids, seq_len, vertex "
            "rows or semantics differ")
    require(fig["col_flip_share"] <= COLUMN_FLIP_SHARE, f"{what}: "
            f"{fig['col_flip_share']:.3e} of the vertices' columns differ "
            f"by more than {COLUMN_PX} px (up to {fig['col_flip_px']:.3f}; "
            f"bar {COLUMN_FLIP_SHARE})")
    require(fig["same_endpoints"], f"{what}: endpoints differ")
    require(fig["semantic_share"] <= SEMANTIC_SHARE, f"{what}: "
            f"{fig['semantic_share']:.3e} of semantic_map differs (bar "
            f"{SEMANTIC_SHARE})")


def lane_counts(results: List[Dict]) -> List[int]:
    return [len(r["lanes"]) for r in results]


# -- decisions --------------------------------------------------------------

def threshold_margin(dec: Dict[str, np.ndarray], cfg, img: int = IMG
                     ) -> float:
    """The least distance of a decision of the decode from its threshold,
    as ``torch_port_helpers.assert_clear_of_thresholds`` (with
    ``clamped_columns``) asserts it: proposal confidence; at every kept
    vertex the column argmax off a tie and the column off an integer, but
    exact integers (the decode's clamp gives them in both packages)."""
    conf = dec["prop_conf"][..., 1]
    margins = [np.abs(conf - cfg.proposal_obj_thre).min()]
    kept = (conf >= cfg.proposal_obj_thre)[..., None] \
        & (dec["prop_v_ext"] > 0.5)
    if kept.any():
        probs = np.sort(dec["prop_cls_conf"], axis=-1)
        margins.append((probs[..., -1] - probs[..., -2])[kept].min())
        coors = dec["cls_offset"] / cfg.heads.row_size * img
        frac = np.abs(coors - np.round(coors))
        check = kept & (coors > 0) & (frac > 0)
        if check.any():
            margins.append(frac[check].min())
    return float(min(margins))


# -- P4's voxel grid --------------------------------------------------------

def voxel_record(grid: np.ndarray, idx: Optional[np.ndarray] = None) -> Dict:
    """A [Y, X, Z*C] z-fold grid as float64 sums and sums of magnitudes per
    (row, channel), its count of non-zero elements and ``VOXEL_SAMPLE``
    seeded non-zero elements (flat indices ``idx``, drawn here when not
    given)."""
    grid = np.asarray(grid, np.float32)
    flat = grid.reshape(-1)
    if idx is None:
        nz = np.flatnonzero(flat)
        idx = np.sort(np.random.RandomState(VOXEL_SAMPLE_SEED).choice(
            nz, VOXEL_SAMPLE, replace=False))
    return {"vox_row_sums": grid.astype(np.float64).sum(axis=1),
            "vox_row_abs": np.abs(grid.astype(np.float64)).sum(axis=1),
            "vox_nonzero": np.int64(np.count_nonzero(flat)),
            "vox_idx": np.asarray(idx, np.int32), "vox_cells": flat[idx]}


def voxel_errors(grid: np.ndarray, golden) -> Dict:
    """Row sums relative to the row's sum of magnitudes (the coordinate
    channels' signed sums cancel), occupancy, sampled cells."""
    got = voxel_record(grid, golden["vox_idx"])
    scale = golden["vox_row_abs"]
    return {"row_rel": float((np.abs(got["vox_row_sums"]
                                     - golden["vox_row_sums"])
                              / np.maximum(scale, 1e-30)).max()),
            "rows_zero_where_golden": bool(
                (got["vox_row_abs"][scale == 0] == 0).all()),
            "nonzero": int(got["vox_nonzero"]),
            "nonzero_golden": int(golden["vox_nonzero"]),
            "cell_abs": float(np.abs(got["vox_cells"]
                                     - golden["vox_cells"]).max())}


def check_voxels(err: Dict, what: str):
    require(err["nonzero"] == err["nonzero_golden"]
            and err["rows_zero_where_golden"], f"{what}: occupancy {err}")
    require(err["row_rel"] <= VOXEL_ROW_REL, f"{what}: row sums rel "
            f"{err['row_rel']:.3e} (bar {VOXEL_ROW_REL})")
    require(err["cell_abs"] <= VOXEL_CELL_ABS, f"{what}: sampled cells abs "
            f"{err['cell_abs']:.3e} (bar {VOXEL_CELL_ABS})")


# -- the golden files -------------------------------------------------------

def load_golden(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(GOLDEN_DIR, PATHS[path])) as z:
        return {k: z[k] for k in z.files}


def load_meta() -> Dict:
    with open(os.path.join(GOLDEN_DIR, "golden.json")) as f:
        return json.load(f)


def regen_errors(new: Dict, stored) -> Dict[str, float]:
    """The JAX package now (``new``) against the stored set: floats as
    rel-max (lane columns in px), the rest as the count of elements that
    differ (semantic maps as the share of pixels)."""
    err = {}
    for k, want in stored.items():
        got = np.asarray(new[k])
        require(got.shape == want.shape, f"{k}: shapes {got.shape} "
                f"{want.shape}")
        if k.startswith("lane_seq_"):
            err[k + "_structure"] = int((got[:, [0, 2]]
                                         != want[:, [0, 2]]).sum())
            err[k] = float(np.abs(got[:, 1] - want[:, 1]).max()) \
                if len(got) else 0.0
        elif k.startswith("semantic_"):
            err[k] = float((got != want).mean())
        elif np.issubdtype(want.dtype, np.floating):
            err[k] = rel_max(got, want)
        else:
            err[k] = int((got != want).sum())
    return err


def check_regen(err: Dict[str, float], what: str):
    for k, e in err.items():
        if k.startswith("lane_seq_") and not k.endswith("_structure"):
            bar = 1e-3  # px, the tiny-config bar of assert_same_records
        elif k.startswith("semantic_"):
            bar = SEMANTIC_SHARE
        elif isinstance(e, float):
            bar = REGEN_REL
        else:
            bar = 0
        require(e <= bar, f"{what}: {k} differs from the stored golden set "
                f"by {e} (bar {bar})")


# -- the port on a device ---------------------------------------------------

def port_config(name: str, **top):
    """The port's Config of ``name`` with top-level keys ``top`` set."""
    from lanemapping_tpu_torch.config.config import Config
    cfg = Config.fromfile(os.path.join(REPO, CONFIGS[name]))
    for k, v in top.items():
        cfg[k] = v
    return cfg


def load_seeded_weights(model, name: str, cfg):
    """``model`` (the port's net of config ``name``) with the golden set's
    seeded weights."""
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights
    v = draw_variables(load_manifest(name), WEIGHT_SEEDS[name])
    load_jax_weights(model, v["params"], v["batch_stats"], cfg)
    return model


class HeadCapture:
    """While open, the head outputs of ``model``'s forwards, rows ``rows``
    of each, as float32 numpy (``heads``: one dict per forward)."""

    def __init__(self, model, rows: Sequence[int]):
        self.model, self.rows, self.heads = model, list(rows), []

    def __enter__(self):
        def hook(module, inputs, out):
            self.heads.append({k: v[self.rows].detach().float().cpu()
                               .numpy() for k, v in out.items()})
        self.handle = self.model.register_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def stack_heads(heads: List[Dict]) -> Dict[str, np.ndarray]:
    """Forwards' captured heads as one batch, packed for the golden bars."""
    return pack_heads({k: np.concatenate([h[k] for h in heads])
                       for k in heads[0]})


def golden_rows(n: int) -> List[int]:
    """Where a batch of ``n`` holds the two golden tiles: first and last."""
    return [0, n - 1]


def batch_of(device, golden_u8, n: int, seed: int):
    """[n, IMG, IMG, 3] uint8 seeded noise tiles on ``device`` with the
    golden tiles at ``golden_rows(n)``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, 256, (n, IMG, IMG, 3), generator=gen,
                      dtype=torch.uint8, device=device)
    x[golden_rows(n)] = torch.from_numpy(golden_u8).to(device)
    return x


def port_tiles() -> np.ndarray:
    from lanemapping_tpu_torch.data import synthetic
    tiles = golden_tiles(synthetic)
    check_digest(tiles, load_meta()["inputs"]["tiles"], "P1/P2 tiles")
    return tiles


def port_cloud(kind: str):
    from lanemapping_tpu_torch.data import synthetic
    pts, msk = golden_cloud(synthetic, SEEDS[kind])
    for a, want, what in zip((pts, msk), load_meta()["inputs"][kind],
                             ("points", "mask")):
        check_digest(a, want, f"{kind} {what}")
    return pts, msk


def port_lanes(keep: Dict, cfg, rows=None) -> List[Dict]:
    from lanemapping_tpu_torch.decode.postprocess import \
        lane_maps_from_decode
    from lanemapping_tpu_torch.tools.export_lanes import lane_records
    return lane_results({k: v.cpu().numpy() for k, v in keep.items()}, cfg,
                        lane_maps_from_decode, lane_records, rows)


def run_p1(device, batch: Optional[int] = None) -> Dict:
    """P1 on the port: ``LaneMapper.map_arrays`` (float32) on each golden
    tile alone, or, with ``batch``, the mapper's forward and decode
    (`api.forward_decode`) of a batch of seeded noise tiles holding the
    golden tiles at ``golden_rows(batch)``, postprocessed at those rows.
    {heads, results, rows}."""
    import torch
    from lanemapping_tpu_torch.api import LaneMapper, forward_decode

    tiles = port_tiles()
    cfg = port_config("flagship")
    mapper = LaneMapper(cfg, device=device)
    load_seeded_weights(mapper.model, "flagship", cfg)
    if batch is None:
        results = []
        with HeadCapture(mapper.model, [0]) as cap:
            for t in tiles:
                results += mapper.map_arrays(t[None].astype(np.float32)
                                             / 255.0)
        return {"heads": stack_heads(cap.heads), "results": results,
                "rows": [0, 1]}
    rows = golden_rows(batch)
    x = batch_of(torch.device(device), tiles, batch, seed=25)
    x = x.float() / 255.0
    with HeadCapture(mapper.model, rows) as cap:
        dec = forward_decode(mapper.model, x, cfg)
    del x
    return {"heads": stack_heads(cap.heads),
            "results": port_lanes(dec, cfg, rows), "rows": [0, 1]}


def serving_net(name: str, device, **top):
    """(cfg, the port's net of ``name`` with the seeded weights as
    `tools/stream_map.py` serves it on ``device``, its dtype)."""
    import torch
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.tools.stream_map import place, prepare_serving

    cfg = port_config(name, **top)
    model = load_seeded_weights(build_model(cfg, seed=0), name, cfg)
    dtype = prepare_serving(model, cfg)
    return cfg, place(model, torch.device(device), dtype), dtype


def run_p2(device, batch: Optional[int] = None) -> Dict:
    """P2 on the port: the bf16 stream's device program
    (`tools/stream_map.py::network_input`, the net, ``readback_view``) on
    each golden tile alone (a mono tile ships one channel, as the stream
    ships it), or inside a batch of ``batch`` seeded noise tiles.
    {heads, results, rows, dtype}."""
    import torch
    from lanemapping_tpu_torch.tools.stream_map import (network_input,
                                                        readback_view,
                                                        to_u8)

    tiles = port_tiles()
    cfg, model, dtype = serving_net("flagship", device)
    if batch is None:
        inputs = [torch.from_numpy(to_u8(t[None] / 255.0)).to(device)
                  for t in tiles]
        rows = [0]
    else:
        inputs = [batch_of(torch.device(device), tiles, batch, seed=26)]
        rows = golden_rows(batch)
    results = []
    with HeadCapture(model, rows) as cap, torch.inference_mode():
        for u8 in inputs:
            keep = readback_view(model(network_input("image", [u8], cfg,
                                                     dtype)), cfg)
            results += port_lanes(keep, cfg, rows)
    return {"heads": stack_heads(cap.heads), "results": results,
            "rows": [0, 1], "dtype": str(dtype)}


def run_p3(device) -> Dict:
    """P3 on the port: the ``--from-las`` device program in float32 (the
    BEV tile from K1 on a card), and the count map of the same cloud.
    {heads, results, rows, bev, counts}."""
    import torch
    from lanemapping_tpu_torch.ops.voxelize import rasterize_bev_intensity
    from lanemapping_tpu_torch.tools.las2bev import las2bev_params
    from lanemapping_tpu_torch.tools.stream_map import (network_input,
                                                        readback_view)

    pts, msk = port_cloud("las_cloud")
    cfg, model, dtype = serving_net("flagship", device,
                                    compute_dtype="float32")
    dev = [torch.from_numpy(pts).to(device), torch.from_numpy(msk).to(device)]
    p = las2bev_params(cfg)
    with HeadCapture(model, [0]) as cap, torch.inference_mode():
        x = network_input("las", dev, cfg, dtype)
        keep = readback_view(model(x), cfg)
        _, cnt = rasterize_bev_intensity(*dev, p["pc_range"], IMG,
                                         flip_rows=True)
    return {"heads": stack_heads(cap.heads), "results": port_lanes(keep, cfg),
            "rows": [0], "bev": x[..., 0].float().cpu().numpy(),
            "counts": cnt[0].cpu().numpy().astype(np.int32)}


def run_p4(device) -> Dict:
    """P4 on the port: the LiDAR stream's device program (float32 on
    bf16-rounded weights, the z-fold grid from K1z on a card), the grid as
    the encoder reads it.  {heads, results, rows, grid}."""
    import torch
    from lanemapping_tpu_torch.tools.stream_map import (network_input,
                                                        readback_view)

    pts, msk = port_cloud("lidar_cloud")
    cfg, model, dtype = serving_net("lidar", device)
    dev = [torch.from_numpy(pts).to(device), torch.from_numpy(msk).to(device)]
    grids = []
    hook = model.pcencoder.zfold_encoder.register_forward_pre_hook(
        lambda module, inputs: grids.append(
            inputs[0][0].permute(1, 2, 0).float().cpu().numpy()))
    try:
        with HeadCapture(model, [0]) as cap, torch.inference_mode():
            keep = readback_view(model(network_input("lidar", dev, cfg,
                                                     dtype)), cfg)
    finally:
        hook.remove()
    return {"heads": stack_heads(cap.heads), "results": port_lanes(keep, cfg),
            "rows": [0], "grid": grids[0]}


# -- the bars, per path -----------------------------------------------------

def hold_p1(run: Dict, golden, what: str) -> Dict:
    """P1's (and P3's, P4's) float32 bars: head outputs and lanes."""
    err = head_errors(run["heads"], golden, run["rows"])
    fig = lane_figures(run["results"], golden, run["rows"])
    check_heads(err, what)
    check_lanes(fig, what)
    return {"heads": err, "lanes": fig}


def hold_p2(run: Dict, golden_bf16, golden_f32, what: str) -> Dict:
    """P2's bf16 rule on every output; lanes only counted."""
    rows = run["rows"]
    d = bf16_distances(run["heads"],
                       {k: v[rows] for k, v in golden_bf16.items()},
                       {k: v[rows] for k, v in golden_f32.items()
                        if k.startswith(("full_", "sub_"))})
    check_bf16(d, what)
    return {"bf16": d, "lanes": lane_counts(run["results"]),
            "lanes_jax_bf16": golden_bf16["lane_counts"][rows].tolist()}


def hold_p3(run: Dict, golden, what: str) -> Dict:
    fig = hold_p1(run, golden, what)
    bev_abs = float(np.abs(run["bev"] - golden["bev"]).max())
    require(bev_abs <= BEV_ABS, f"{what}: BEV tile abs {bev_abs:.3e} "
            f"(bar {BEV_ABS})")
    check_digest(run["counts"], load_meta()["paths"]["p3"]["bev_counts"],
                 f"{what}: count map")
    fig["bev_abs"] = bev_abs
    return fig


def hold_p4(run: Dict, golden, what: str) -> Dict:
    fig = hold_p1(run, golden, what)
    fig["voxels"] = voxel_errors(run["grid"], golden)
    check_voxels(fig["voxels"], what)
    return fig
