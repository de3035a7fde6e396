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

import contextlib
import functools
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


# a golden hold's intra-op threads: since the CPU norms' repair its
# figures do not depend on the count (ROADMAP Queue 3 item 10); a hold
# pins one all the same, so that a failed bar names it (``names_threads``)
# and T3 can hold the same figures at one thread
HOLD_THREADS = 2


@contextlib.contextmanager
def threads(n: int):
    """torch's intra-op thread count at ``n`` within the block, restored
    after it."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield n
    finally:
        torch.set_num_threads(before)


def names_threads(hold):
    """``hold`` with the intra-op thread count and the CPU's vector
    capability in the message of a failed bar: PyTorch's CPU figures can
    depend on both."""
    @functools.wraps(hold)
    def run(*args, **kwargs):
        try:
            return hold(*args, **kwargs)
        except AssertionError as e:
            if "[torch threads" in str(e):   # a hold inside a hold
                raise
            import torch
            raise AssertionError(
                f"{e} [torch threads {torch.get_num_threads()}, cpu "
                f"capability {torch.backends.cpu.get_cpu_capability()}]"
            ) from e
    return run


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

def voxel_record(grid: np.ndarray, idx: Optional[np.ndarray] = None,
                 n_sample: int = VOXEL_SAMPLE) -> Dict:
    """A [Y, X, Z*C] z-fold grid as float64 sums and sums of magnitudes per
    (row, channel), its count of non-zero elements and ``n_sample``
    seeded non-zero elements (flat indices ``idx``, drawn here when not
    given)."""
    grid = np.asarray(grid, np.float32)
    flat = grid.reshape(-1)
    if idx is None:
        nz = np.flatnonzero(flat)
        idx = np.sort(np.random.RandomState(VOXEL_SAMPLE_SEED).choice(
            nz, n_sample, replace=False))
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

@names_threads
def hold_p1(run: Dict, golden, what: str) -> Dict:
    """P1's (and P3's, P4's) float32 bars: head outputs and lanes."""
    err = head_errors(run["heads"], golden, run["rows"])
    fig = lane_figures(run["results"], golden, run["rows"])
    check_heads(err, what)
    check_lanes(fig, what)
    return {"heads": err, "lanes": fig}


@names_threads
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


@names_threads
def hold_p3(run: Dict, golden, what: str) -> Dict:
    fig = hold_p1(run, golden, what)
    bev_abs = float(np.abs(run["bev"] - golden["bev"]).max())
    require(bev_abs <= BEV_ABS, f"{what}: BEV tile abs {bev_abs:.3e} "
            f"(bar {BEV_ABS})")
    check_digest(run["counts"], load_meta()["paths"]["p3"]["bev_counts"],
                 f"{what}: count map")
    fig["bev_abs"] = bev_abs
    return fig


@names_threads
def hold_p4(run: Dict, golden, what: str) -> Dict:
    fig = hold_p1(run, golden, what)
    fig["voxels"] = voxel_errors(run["grid"], golden)
    check_voxels(fig["voxels"], what)
    return fig


# == training: T0-T3 ========================================================
#
# T0 the training batch (the loader's first two batches of a seeded LaserLane
# set, as `Runner._device_batch` ships them, the proposal-GT cache off and
# on); T1 the flagship's step in float32, T2 the same in bf16 as it ships,
# T3 the LiDAR config's step as it ships (float32 on bf16-rounded weights,
# K1z on a card), each against the JAX package in float64 (`float64_jax` of
# the generator), at batch ``TRAIN_BATCH``, from a seeded mid-training Adam
# state at the config's lr.  Vectors too large to keep whole (gradients,
# parameter changes) are kept as per-leaf digests: a seeded subsample of
# ``SUB_PER_LEAF`` elements and a count sketch of ``SKETCH_DIM`` signed
# buckets (`digest_plan`), from which the L2 distance of any vector to the
# float64 one is estimated.

TRAIN_META = "golden_train.json"
TRAIN_PATHS = {"t1": "t1_flagship_f32.npz", "t2": "t2_flagship_bf16.npz",
               "t3": "t3_lidar.npz"}
TRAIN_BATCH = 2          # the one dimension cut (the configs train at 8)
TRAIN_TILES = 4          # two batches
TRAIN_POINTS = 7 << 16   # points a cloud, padded to N_POINTS (1/8 padding)
TRAIN_STEPS = 3
TRAIN_SEEDS = {"dataset": 3, "adam": 1, "digest": 13}
ADAM_COUNT = 10          # the schedule step the Adam state stands for
SUB_PER_LEAF = 512
SKETCH_DIM = 64
TRAIN_VOXEL_SAMPLE = 8192
# why the golden set's weight seeds (WEIGHT_SEEDS) serve training too
TRAIN_SEED_NOTES = {
    "flagship": "seed 0, P1-P3's: every term finite at every step; on T0's "
                "first batch each tile's own loss 157.62 / 161.12 and its "
                "gradient's norm 2071.4 / 2092.9 (the port, float32): no "
                "tile dominates",
    "lidar": "seed 1, P4's: every term finite at every step; each tile's "
             "own loss 32.68 / 35.91, its gradient's norm 103.9 / 107.9"}
TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss", "loss")

# -- the training bars (measured on the CPU at full width: PERF.md, PR 13) --
TERM_REL = 1e-5          # float32 terms at step 0, from JAX float64
DIST_SLOPE = 1.5         # d_port <= 1.5 d_jax32 + eps |v| + rho |v_group|
GRAD_EPS = 1e-7          # eps of gradients and parameter changes
BN_EPS = 1e-7            # eps of the BatchNorm statistics
GROUP_RHO = 1e-5         # rho: a float32 sum's error, of the group's norm
TERM_LATER_MAX = 10.0    # steps 1-2: the largest pooled term ratio
BATCH_MOMENT_REL = 1e-6  # float keys of T0 by moments, where bytes differ
# a pool of ratios d_port / d_jax (T2's gradient and terms, T3's gradient
# and change, T1's and T3's later terms): its median within POOL_MEDIAN
# and its POOL_Q quantile within POOL_Q_FACTOR.  Measured 90th
# percentiles: CPU T2 gradient 1.20, terms 1.14, T3 gradient 1.91; H100
# T2 terms 1.69 and 2.30 in two runs.  The factor is set from the ratio's
# law: a term's ratio of two normal rounding errors, the port's 1.3x JAX's
# (bf16, PERF.md §6), its denominator at the floor, exceeds 3.0 one time
# in 8 and 5.0 one time in 105, so the 90th percentile of 30 terms (about
# the 4th largest) would fail 3.0 in up to half the runs and fails 5.0 in
# ~2e-4; a term whose error is 5x JAX's still fails it
POOL_MEDIAN = 1.5
POOL_Q = 0.9
POOL_Q_FACTOR = 5.0


def train_dataset(root: str, synthetic) -> List[str]:
    """The T0 LaserLane set under ``root`` from a ``data/synthetic.py``
    module (the JAX package's or the port's, which write the same set):
    ``TRAIN_TILES`` 1152 px tiles with clouds of ``TRAIN_POINTS``, every
    tile in the train split."""
    names = [f"{190000 + i:06d}_{i:04d}" for i in range(TRAIN_TILES)]
    stems = synthetic.generate_dataset(
        root, n_tiles=TRAIN_TILES, img=IMG, seed=TRAIN_SEEDS["dataset"],
        with_points=True, points_per_tile=TRAIN_POINTS,
        splits={"train": names, "valid": names, "test": names,
                "single": names[:1], "pretrain": names})
    require(stems == names, f"tile names {stems}")
    return stems


def wire_train(cfg, root: str, **top):
    """``cfg`` (either package's) at ``TRAIN_BATCH`` on ``root``."""
    cfg.batch_size = TRAIN_BATCH
    for split in ("train", "val", "test"):
        cfg.dataset[split]["data_root"] = root
    for k, v in top.items():
        cfg[k] = v
    return cfg


def batch_record(db: Dict[str, np.ndarray]) -> Dict:
    """A shipped batch (numpy, bf16 widened to float32) as per-key
    digests; float keys carry their ``moments`` too."""
    rec = {}
    for k in sorted(db):
        a = np.ascontiguousarray(db[k])
        if a.dtype.name == "bfloat16":  # JAX's bf16 numpy, widened exactly
            a = a.astype(np.float32)
        d = digest(a)
        if np.issubdtype(a.dtype, np.floating):
            d["moments"] = moments(a).tolist()
        rec[k] = d
    return rec


def batch_errors(db: Dict[str, np.ndarray], want: Dict) -> Dict:
    """{key: 0 where the bytes agree, else the float keys' ``moment_rel``
    (inf for an integer key)}; keys, shapes and dtypes must agree."""
    require(sorted(db) == sorted(want), f"batch keys {sorted(db)} against "
            f"{sorted(want)}")
    err = {}
    for k, w in want.items():
        a = np.ascontiguousarray(db[k])
        if a.dtype.name == "bfloat16":  # JAX's bf16 numpy, widened exactly
            a = a.astype(np.float32)
        got = digest(a)
        require(got["shape"] == w["shape"] and got["dtype"] == w["dtype"],
                f"{k}: {got['shape']} {got['dtype']} against {w['shape']} "
                f"{w['dtype']}")
        if got["sha256"] == w["sha256"]:
            err[k] = 0.0
        elif "moments" in w:
            err[k] = moment_rel(moments(a), np.asarray(w["moments"]))
        else:
            err[k] = float("inf")
    return err


def check_batch(err: Dict, what: str, exact_floats: bool):
    for k, e in err.items():
        bar = 0.0 if exact_floats else BATCH_MOMENT_REL
        require(e <= bar, f"{what}: {k} differs from the golden batch "
                f"({e:.3e}, bar {bar})")


# -- the mid-training Adam state, without JAX -------------------------------

def grad_rms(grads: Dict) -> List[float]:
    """Per leaf of a flax-layout tree (``flat_leaves`` order), the RMS
    ``mid_training_adam`` scales the moments by."""
    return [float(np.sqrt(np.mean(np.square(g))))
            for _, g in flat_leaves(grads)]


def draw_adam(paths: Sequence, shapes: Sequence, rms: Sequence[float],
              seed: int, count: int = ADAM_COUNT):
    """(mu, nu, count): bit for bit what
    ``torch_port_helpers.mid_training_adam(grads, seed, count)`` draws for
    gradients whose leaves (``paths`` in ``flat_leaves`` order, which is
    jax's order of a dict tree) have these ``shapes`` and RMS values."""
    rng = np.random.RandomState(seed)
    floor = 1e-3 * max(rms)
    c1, c2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
    mu = [(rng.normal(0.0, 0.3 * max(r, floor), tuple(s)) * c1
           ).astype(np.float32) for s, r in zip(shapes, rms)]
    nu = [(max(r, floor) ** 2 * rng.uniform(0.5, 2.0, tuple(s)) * c2
           ).astype(np.float32) for s, r in zip(shapes, rms)]

    def tree(leaves):
        out: Dict = {}
        for path, v in zip(paths, leaves):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = v
        return out
    return tree(mu), tree(nu), count


def golden_adam(name: str, meta: Optional[Dict] = None):
    """The stored Adam state of config ``name`` as flax-layout trees."""
    meta = meta or load_train_meta()
    a = meta["adam"][name]
    return draw_adam([p for p, _ in a["leaves"]], [s for _, s in a["leaves"]],
                     a["rms"], a["seed"], a["count"])


# -- per-leaf digests --------------------------------------------------------

def digest_plan(shapes: Dict[str, Sequence[int]]) -> List[Dict]:
    """Per leaf (torch names, sorted): a seeded subsample of at most
    ``SUB_PER_LEAF`` flat indices and a count sketch (a bucket of
    ``SKETCH_DIM`` and a sign for every element), drawn from
    ``RandomState(TRAIN_SEEDS['digest'] + leaf index)``."""
    plan = []
    for i, name in enumerate(sorted(shapes)):
        n = int(np.prod(shapes[name]))
        rng = np.random.RandomState(TRAIN_SEEDS["digest"] + i)
        idx = np.arange(n) if n <= SUB_PER_LEAF else np.sort(
            rng.choice(n, SUB_PER_LEAF, replace=False))
        plan.append({"name": name, "n": n, "idx": idx,
                     "bucket": rng.randint(0, SKETCH_DIM, n),
                     "sign": rng.randint(0, 2, n).astype(np.float64) * 2 - 1})
    return plan


def vector_digest(plan: List[Dict], vec: Dict[str, np.ndarray]) -> Dict:
    """{sub: the subsamples, concatenated (float64); sk: [leaves,
    SKETCH_DIM] sketches; norm: [leaves] L2 norms} of a vector given as
    {torch name: array}."""
    sub, sk, norm = [], [], []
    for p in plan:
        v = np.asarray(vec[p["name"]], np.float64).reshape(-1)
        require(v.size == p["n"], f"{p['name']}: {v.size} elements, plan "
                f"{p['n']}")
        sub.append(v[p["idx"]])
        sk.append(np.bincount(p["bucket"], weights=p["sign"] * v,
                              minlength=SKETCH_DIM))
        norm.append(np.sqrt(np.dot(v, v)))
    return {"sub": np.concatenate(sub), "sk": np.stack(sk),
            "norm": np.asarray(norm)}


def leaf_groups(plan: List[Dict]) -> List[str]:
    """Each leaf's group: its module (the name without its last part)."""
    return [p["name"].rsplit(".", 1)[0] for p in plan]


def leaf_distances(plan: List[Dict], got: Dict, ref: Dict) -> np.ndarray:
    """[leaves, 2]: the L2 distance of vector ``got`` from ``ref`` (both
    ``vector_digest``s), estimated from the subsample (scaled to the leaf)
    and from the sketch."""
    out, o = [], 0
    for i, p in enumerate(plan):
        m = len(p["idx"])
        ds = got["sub"][o:o + m] - ref["sub"][o:o + m]
        o += m
        out.append([np.sqrt(np.dot(ds, ds) * p["n"] / m),
                    np.linalg.norm(got["sk"][i] - ref["sk"][i])])
    return np.asarray(out)


def group_distances(plan: List[Dict], d: np.ndarray) -> Dict[str, np.ndarray]:
    """Leaf distances pooled per group (root of the sum of squares)."""
    out: Dict[str, np.ndarray] = {}
    for g, row in zip(leaf_groups(plan), d):
        out[g] = np.sqrt(out.get(g, np.zeros(2)) ** 2 + row ** 2)
    return out


def pack_digest(prefix: str, dg: Dict) -> Dict[str, np.ndarray]:
    """A ``vector_digest`` as golden members, float64 throughout (a
    float32 subsample would round the reference by 6e-8 of an element,
    more than JAX float32's own error on some leaves: 4e-8 on the
    flagship's endpoint output layer)."""
    return {f"sub_{prefix}": dg["sub"], f"sk_{prefix}": dg["sk"],
            f"norm_{prefix}": dg["norm"]}


def unpack_digest(golden, prefix: str) -> Dict:
    return {"sub": golden[f"sub_{prefix}"],
            "sk": golden[f"sk_{prefix}"],
            "norm": golden.get(f"norm_{prefix}")}


def bn_vector(state: Dict[str, np.ndarray]) -> np.ndarray:
    """Every BatchNorm running mean and variance, by sorted name, float64."""
    return np.concatenate([np.asarray(state[k], np.float64).reshape(-1)
                           for k in sorted(state)
                           if k.endswith(("running_mean", "running_var"))])


def bn_groups(state: Dict[str, np.ndarray]) -> List[str]:
    """``bn_vector``'s elements' layers."""
    return [k.rsplit(".", 1)[0] for k in sorted(state)
            if k.endswith(("running_mean", "running_var"))
            for _ in range(np.asarray(state[k]).size)]


def term_vector(stats: Dict) -> np.ndarray:
    return np.array([float(stats[k]) for k in TERMS], np.float64)


# -- the bars ----------------------------------------------------------------

def rule_figures(d_port: Dict[str, np.ndarray], d_jax: Dict[str, np.ndarray],
                 floor: Dict[str, float]) -> Dict:
    """Per group, the rule d_port <= DIST_SLOPE d_jax + floor (the group's)
    on each estimate; {worst: (group, excess ratio), ratio_median,
    ratio_max, groups}."""
    worst, ratios = ("", 0.0), []
    for g in d_port:
        dp, dj = np.asarray(d_port[g]), np.asarray(d_jax[g])
        ex = float(np.max(dp / (DIST_SLOPE * dj + floor[g])))
        if ex > worst[1]:
            worst = (g, ex)
        ratios.append(float(np.max(dp / np.maximum(dj, 1e-300))))
    return {"worst": worst, "ratio_median": float(np.median(ratios)),
            "ratio_max": float(np.max(ratios)), "groups": len(ratios)}


def check_rule(fig: Dict, what: str):
    g, ex = fig["worst"]
    require(ex <= 1.0, f"{what}: group {g} d_port is {ex:.3f}x its bar "
            f"{DIST_SLOPE} d_jax32 + eps ({fig})")


def pooled_figures(ratios: Sequence[float]) -> Dict:
    r = np.asarray(ratios, np.float64)
    return {"median": float(np.median(r)),
            "quantile": float(np.quantile(r, POOL_Q)), "n": int(r.size),
            "max": float(r.max())}


def check_pooled(fig: Dict, what: str):
    require(fig["median"] <= POOL_MEDIAN, f"{what}: median d_port / d_jax "
            f"{fig['median']:.3f} above {POOL_MEDIAN} ({fig})")
    require(fig["quantile"] <= POOL_Q_FACTOR, f"{what}: quantile {POOL_Q} "
            f"of d_port / d_jax {fig['quantile']:.3f} above {POOL_Q_FACTOR} "
            f"({fig})")


def load_train_meta() -> Dict:
    with open(os.path.join(GOLDEN_DIR, TRAIN_META)) as f:
        return json.load(f)


def load_train_golden(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(GOLDEN_DIR, TRAIN_PATHS[path])) as z:
        return {k: z[k] for k in z.files}



# -- the port's training on a device ------------------------------------------

def port_train_config(name: str, root: str, **top):
    return wire_train(port_config(name), root, **top)


def first_train_batch(name: str, root: str) -> Dict:
    """The port loader's first batch of ``name`` on the T0 set at
    ``root``."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    cfg = port_train_config(name, root)
    return next(iter(build_dataloader(cfg.dataset.train, cfg)))


def host_batch(db) -> Dict[str, np.ndarray]:
    """A device batch as numpy (bf16 widened exactly to float32)."""
    import torch
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in db.items()}


def run_t0(device, root: str) -> Dict:
    """T0 on the port: the first two batches of each config's loader
    (`data/loader.py::build_dataloader`) on the T0 set at ``root`` (made
    by `train_dataset`), as ``Runner._device_batch`` ships them to
    ``device``, with the GT cache off, filling and serving.  {config:
    {names, batches (numpy), host (the loader's batches)}}."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.runner import Runner
    import tempfile
    out = {}
    for name in CONFIGS:
        with tempfile.TemporaryDirectory() as logs:
            runner = Runner(port_train_config(name, root), log_dir=logs,
                            device=device)
        runs = []
        for cache in (False, True, True):
            cfg = port_train_config(name, root, gt_cache=cache)
            runs.append([(b["image_name"], b)
                         for b in build_dataloader(cfg.dataset.train, cfg)])
        for run in runs[1:]:
            require([n for n, _ in run] == [n for n, _ in runs[0]],
                    f"T0 {name}: the GT cache changed the order")
        out[name] = {"names": [n for n, _ in runs[0]],
                     "batches": [[host_batch(runner._device_batch(b))
                                  for _, b in run] for run in runs],
                     "host": [b for _, b in runs[0]]}
        del runner
    return out


@names_threads
def hold_t0(run: Dict, meta: Dict, what: str, exact_floats: bool) -> Dict:
    """T0's bars: tile order equal; integer keys exact; float keys exact
    (``exact_floats``) or within ``BATCH_MOMENT_REL`` by their moments;
    with the GT cache off, filling and serving alike."""
    fig = {}
    for name, r in run.items():
        want = meta["t0"][name]
        require(r["names"] == want["names"], f"{what} {name}: tile order "
                f"{r['names']} against {want['names']}")
        errs = {}
        for c, batches in zip(("off", "filling", "serving"), r["batches"]):
            require(len(batches) == len(want["batches"]),
                    f"{what} {name}: {len(batches)} batches")
            for i, (db, w) in enumerate(zip(batches, want["batches"])):
                err = batch_errors(db, w)
                check_batch(err, f"{what} {name} cache {c} batch {i}",
                            exact_floats)
                for k, e in err.items():
                    errs[k] = max(errs.get(k, 0.0), e)
        fig[name] = errs
    return fig


def train_runner(name: str, device, dtype: str, logs: str):
    """A port ``Runner`` of ``name`` at ``TRAIN_BATCH`` training in
    ``dtype`` (``float32``/``bfloat16``) on ``device``, with the golden
    weights and the golden Adam state."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.from_jax import adam_state_from_jax
    cfg = port_train_config(name, "", train_compute_dtype=dtype)
    runner = Runner(cfg, log_dir=logs, device=device)
    load_seeded_weights(runner.model, name, cfg)
    mu, nu, count = golden_adam(name)
    adam_state_from_jax(runner.state, mu, nu, count, cfg)
    return runner


def state_numpy(model) -> Dict[str, np.ndarray]:
    return {k: v.detach().double().cpu().numpy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def run_steps(runner, batch: Dict, steps: int = TRAIN_STEPS,
              grids: bool = False) -> Dict:
    """``steps`` steps of a port ``Runner``'s ``train_step`` on the loader
    batch ``batch`` (shipped by ``_device_batch``).  {terms [steps,
    terms], grads (step 0), before, after, grids (the z-fold grids the
    LiDAR encoder read at step 0, with ``grids``)}, float64 numpy."""
    model, seen = runner.model, []
    hook = model.pcencoder.zfold_encoder.register_forward_pre_hook(
        lambda m, inp: seen.append(inp[0].detach().permute(
            0, 2, 3, 1).float().cpu().numpy())) if grids else None
    before = state_numpy(model)
    terms, g0 = [], None
    try:
        db = runner._device_batch(batch)
        for i in range(steps):
            stats = runner.train_step(runner.state, db)
            require(stats["skipped_nan"] == 0.0, "the NaN guard skipped")
            if i == 0:
                g0 = {n: p.grad.detach().double().cpu().numpy()
                      for n, p in model.named_parameters()}
                if hook is not None:
                    hook.remove()
            terms.append(term_vector(stats))
    finally:
        if hook is not None:
            hook.remove()
    return {"terms": np.stack(terms), "grads": g0, "before": before,
            "after": state_numpy(model), "grids": seen[:1]}


def run_train(name: str, device, dtype: str, batch: Dict,
              grids: bool = False) -> Dict:
    """`run_steps` of the golden Runner of ``name`` (`train_runner`)."""
    import tempfile
    with tempfile.TemporaryDirectory() as logs:
        return run_steps(train_runner(name, device, dtype, logs), batch,
                         grids=grids)


def change(run: Dict) -> Dict[str, np.ndarray]:
    return {k: run["after"][k] - run["before"][k] for k in run["grads"]}


def train_plan(run: Dict, meta_path: Dict) -> List[Dict]:
    shapes = {k: v.shape for k, v in run["grads"].items()}
    plan = digest_plan(shapes)
    require([[p["name"], p["n"]] for p in plan] == meta_path["leaves"],
            "the port's parameters are not the golden set's leaves")
    return plan


def distance_figures(plan, run_vec, golden, key: str, jax_key: str,
                     eps: float) -> Dict:
    """The rule on one vector (``g``: the step-0 gradient, ``d``: the
    parameter change): per group, the port's and JAX's distances from the
    float64 reference, and the group's floor: ``eps`` of the reference's
    norm and ``GROUP_RHO`` of the group's (a float32 reduction in another
    order: on the flagship's endpoint output layer JAX float32 sits 4e-8
    of the gradient from float64, the port 1e-6)."""
    ref = unpack_digest(golden["ref"], key + "ref")
    d_port = leaf_distances(plan, vector_digest(plan, run_vec), ref)
    d_jax = leaf_distances(plan, unpack_digest(golden["jax"], key + jax_key),
                           ref)
    norms: Dict[str, float] = {}
    for g, n in zip(leaf_groups(plan), ref["norm"]):
        norms[g] = norms.get(g, 0.0) + float(n) ** 2
    total = eps * float(np.sqrt(np.sum(ref["norm"] ** 2)))
    return {"port": group_distances(plan, d_port),
            "jax": group_distances(plan, d_jax),
            "floor": {g: total + GROUP_RHO * np.sqrt(v)
                      for g, v in norms.items()}}


def bn_figures(run: Dict, golden) -> Dict:
    """Per BatchNorm layer, the distances of the port's and JAX's running
    statistics after the steps from the float64 reference's, and its
    floor (``BN_EPS`` of all, ``GROUP_RHO`` of the layer's)."""
    groups = np.asarray(bn_groups(run["after"]))
    got = bn_vector(run["after"])
    ref, jx = golden["ref"]["bn_ref"], golden["jax"]["bn_jax"]
    require(got.shape == ref.shape, f"BatchNorm statistics {got.shape} "
            f"against {ref.shape}")
    port, jax_, floor = {}, {}, {}
    total = BN_EPS * float(np.linalg.norm(ref))
    for g in dict.fromkeys(groups):
        m = groups == g
        port[g] = np.array([np.linalg.norm(got[m] - ref[m])])
        jax_[g] = np.array([np.linalg.norm(jx[m] - ref[m])])
        floor[g] = total + GROUP_RHO * float(np.linalg.norm(ref[m]))
    return {"port": port, "jax": jax_, "floor": floor}


def term_figures(run: Dict, golden) -> Dict:
    """Per step and term: the port's and JAX's distances from the float64
    terms."""
    ref = golden["ref"]["terms_ref"]
    return {"port": np.abs(run["terms"] - ref),
            "jax": np.abs(golden["jax"]["terms_jax"] - ref), "ref": ref}


def term_ratios(t: Dict, steps) -> np.ndarray:
    """d_port / d_jax of every term at ``steps``, the denominator never
    below JAX's median relative distance over them times the term (one
    sum's error: two of one size have |X / Y| above 6.3 one time in ten);
    NaN where the term is 0."""
    ref = np.abs(t["ref"][steps])
    live = ref > 0
    floor_rel = float(np.median(t["jax"][steps][live] / ref[live]))
    r = t["port"][steps] / np.maximum(np.maximum(t["jax"][steps],
                                                 floor_rel * ref), 1e-300)
    return np.where(live, r, np.nan), floor_rel


def vector_ratios(plan, vec, golden, key: str = "g") -> List[float]:
    """d_port / d_jax of a vector's groups (``g``: the step-0 gradient,
    ``d``: the parameter change; each estimate), the denominator never
    below JAX's median relative distance over the groups times the
    group's norm (`term_ratios`' floor: where gradients are rounded to
    bf16, a group's distance counts flipped roundings and is 0 in one run,
    a bf16 step in another)."""
    d = distance_figures(plan, vec, golden, key, "jax", 0.0)
    ref = unpack_digest(golden["ref"], key + "ref")
    norms: Dict[str, float] = {}
    for g, n in zip(leaf_groups(plan), ref["norm"]):
        norms[g] = norms.get(g, 0.0) + float(n) ** 2
    live = [g for g in d["port"] if norms[g] > 0]
    floor_rel = float(np.median([d["jax"][g] / np.sqrt(norms[g])
                                 for g in live]))
    return [float(x) for g in live for x in d["port"][g] / np.maximum(
        np.maximum(d["jax"][g], floor_rel * np.sqrt(norms[g])), 1e-300)]


def float32_figures(run: Dict, golden, plan, pooled: bool = False) -> Dict:
    """The figures of `hold_float32`'s bars, none held."""
    t = term_figures(run, golden)
    rel0 = t["port"][0] / np.maximum(np.abs(t["ref"][0]), 1e-30)
    worst = int(np.argmax(rel0))
    later, _ = term_ratios(t, slice(1, None))
    fig = {"term_rel_step0": float(rel0[worst]),
           "term_step0": TERMS[worst],
           "term_rel_step0_jax": float(np.max(
               t["jax"][0] / np.maximum(np.abs(t["ref"][0]), 1e-30))),
           "terms_later": pooled_figures(later[np.isfinite(later)])}
    for key, vec in (("g", run["grads"]), ("d", change(run))):
        if pooled:
            fig[key] = pooled_figures(vector_ratios(plan, vec, golden, key))
        else:
            d = distance_figures(plan, vec, golden, key, "jax", GRAD_EPS)
            fig[key] = rule_figures(d["port"], d["jax"], d["floor"])
    d = bn_figures(run, golden)
    fig["bn"] = rule_figures(d["port"], d["jax"], d["floor"])
    return fig


@names_threads
def hold_float32(run: Dict, golden, plan, what: str,
                 pooled: bool = False) -> Dict:
    """T1's and T3's bars: step 0's terms within ``TERM_REL`` of float64;
    the step-0 gradient and the parameter change after the steps per
    group by d_port <= DIST_SLOPE d_jax + floor (``pooled``: by the pooled
    rule of `check_pooled` on `vector_ratios`), the BatchNorm statistics
    after the steps per layer by that rule; the terms of the later steps,
    where each package's float32 trajectory has parted from float64's by
    up to 2e-4, pooled: `term_ratios`' median within ``POOL_MEDIAN`` and
    largest within ``TERM_LATER_MAX``.  (T3 is ``pooled``: its gradient
    comes back through the bf16 cast of the weights, rounded to bf16 in
    every run, so a group's distance counts the few elements whose
    rounding flips, 0 in one run and a bf16 step in another, and Adam
    carries those flips into the parameter change.)"""
    fig = float32_figures(run, golden, plan, pooled)
    require(fig["term_rel_step0"] <= TERM_REL, f"{what}: step 0 "
            f"{fig['term_step0']} rel {fig['term_rel_step0']:.3e} from "
            f"float64 (bar {TERM_REL})")
    require(fig["terms_later"]["median"] <= POOL_MEDIAN
            and fig["terms_later"]["max"] <= TERM_LATER_MAX,
            f"{what}: later steps' terms {fig['terms_later']} (median "
            f"bar {POOL_MEDIAN}, largest {TERM_LATER_MAX})")
    for key, name in (("g", "gradient"), ("d", "parameter change")):
        if pooled:
            check_pooled(fig[key], f"{what} {name} groups")
        else:
            check_rule(fig[key], f"{what} {name}")
    check_rule(fig["bn"], f"{what} BatchNorm statistics")
    return fig


def bf16_ratios(run: Dict, golden, plan) -> Dict:
    """The two pools of ratios d_port / d_jax_bf16 (both distances from
    the float64 reference): the step-0 gradient's groups (each estimate),
    and every non-zero term at every step (`term_ratios`)."""
    grad_r = vector_ratios(plan, run["grads"], golden)
    t = term_figures(run, golden)
    ratio, floor_rel = term_ratios(t, slice(None))
    live = np.isfinite(ratio)
    return {"gradient": grad_r, "terms": ratio[live].tolist(),
            "term_floor_rel": floor_rel,
            "term_ratio": {TERMS[j]: ratio[:, j].tolist()
                           for j in range(len(TERMS)) if live[0, j]}}


@names_threads
def hold_bf16(run: Dict, golden, plan, what: str) -> Dict:
    """T2's pooled rule: each pool of `bf16_ratios` with its median within
    ``POOL_MEDIAN`` and its ``POOL_Q`` quantile within
    ``POOL_Q_FACTOR``."""
    r = bf16_ratios(run, golden, plan)
    fig = {"gradient": pooled_figures(r["gradient"]),
           "terms": pooled_figures(r["terms"]),
           "term_floor_rel": r["term_floor_rel"],
           "term_ratio": r["term_ratio"]}
    check_pooled(fig["gradient"], f"{what} gradient groups")
    check_pooled(fig["terms"], f"{what} terms")
    return fig


def golden_pair(path: str) -> Dict:
    """{ref, jax} members of a training path (T2's reference is T1's)."""
    jax_ = load_train_golden(path)
    return {"ref": load_train_golden("t1") if path == "t2" else jax_,
            "jax": jax_}


@names_threads
def hold_t3_grids(run: Dict, golden, what: str) -> Dict:
    """T3's z-fold grids, per tile, by P4's voxel bars."""
    require(len(run["grids"]) == 1, f"{what}: {len(run['grids'])} grids")
    fig = {}
    for b, grid in enumerate(run["grids"][0]):
        g = {k[:-len(f"_{b}")]: v for k, v in golden.items()
             if k.startswith("vox_") and k.endswith(f"_{b}")}
        fig[b] = voxel_errors(grid, g)
        check_voxels(fig[b], f"{what} tile {b}")
    return fig


def tile_shares(name: str, root: str, device="cpu") -> List[Dict]:
    """Per tile of T0's first batch (the T0 set at ``root``): the loss of
    the tile alone from the port's float32 train-mode forward of the
    batch, and the norm of that loss's gradient (the figures of
    ``TRAIN_SEED_NOTES``: no tile dominates the step)."""
    import tempfile
    import torch
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.state import model_input
    cfg = port_train_config(name, root)
    batch = next(iter(build_dataloader(cfg.dataset.train, cfg)))
    with tempfile.TemporaryDirectory() as logs:
        runner = train_runner(name, device, "float32", logs)
    db = runner._device_batch(batch)
    model = runner.model.train()
    out = model(model_input(db, name == "lidar"))
    params = [p for p in model.parameters() if p.requires_grad]
    shares = []
    for b in range(len(batch["image_name"])):
        loss = runner._loss_fn({k: v[b:b + 1] for k, v in out.items()},
                               {k: v[b:b + 1] for k, v in db.items()})["loss"]
        grads = torch.autograd.grad(loss, params, retain_graph=True,
                                    allow_unused=True)
        shares.append({"loss": float(loss), "grad_norm": float(torch.sqrt(
            sum((g.double() ** 2).sum() for g in grads if g is not None)))})
    return shares


# -- the thread sweep ---------------------------------------------------------
#
# PyTorch's CPU kernels may split a reduction among the intra-op threads, so
# a kernel that keeps one float32 sum per thread gives other figures at
# another thread count (its channels-last batch norm did: ROADMAP Queue 3
# item 10).  `thread_sweep` finds such a kernel on a training path in one
# run:
#
#     PYTHONPATH=. python tests/torch_port_golden.py sweep t3 --threads 1 8
#
# and `python tests/torch_port_golden.py holds t3 --threads 1 2 8` prints
# T1's or T3's figures at each count.

SWEEP_TOL = 1e-6          # rel-max between two thread counts
SWEEP_SAMPLE = 65536      # elements of each leaf module's output kept
TRAIN_PATH_OF = {"t1": ("flagship", "float32"), "t3": ("lidar", "bfloat16")}


def rel_diff(a, b) -> float:
    """max |a - b| / max |a| of two tensors (non-float ones: 0 or 1)."""
    import torch
    if a.shape != b.shape:
        return float("inf")
    if not a.is_floating_point():
        return 0.0 if torch.equal(a, b) else 1.0
    if a.numel() == 0:
        return 0.0
    a, b = a.detach().double(), b.detach().double()
    top, diff = float(a.abs().max()), float((a - b).abs().max())
    return diff / top if top > 0 else (0.0 if diff == 0 else float("inf"))


def port_frame(lines) -> str:
    """file:line (function) of the innermost frame of the port in a list of
    `traceback.format_stack` lines."""
    import re
    for line in reversed(lines):
        m = re.search(r'File "[^"]*/(lanemapping_tpu_torch/[^"]+)", line '
                      r'(\d+), in (\S+)', line)
        if m:
            return f"{m.group(1)}:{m.group(2)} ({m.group(3)})"
    return "?"


def op_sweep(fn, other: int, tol: float = SWEEP_TOL) -> List[Dict]:
    """Runs ``fn()`` once, and every aten op in it a second time on the same
    inputs (on copies of what it writes) at ``other`` intra-op threads:
    [{op, output (its index), pass (forward, or the autograd node of the
    backward), where (the port's frame that called it, or that built the
    node), calls, rel (the largest rel-max between the two counts)}] of
    the outputs above ``tol``, largest first.  Random ops and those that
    return uninitialised memory run once.  (The gradient of a bias before
    a BatchNorm is 0 up to rounding, so any change is of its own size.)"""
    import traceback
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(copy(t) for t in v)
        return v

    found: Dict[tuple, Dict] = {}

    class Sweep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if (func.is_view or "empty" in func.__name__
                    or torch.Tag.nondeterministic_seeded in func.tags):
                return func(*args, **kwargs)
            args2, kwargs2, written = list(args), dict(kwargs), []
            for i, a in enumerate(func._schema.arguments):
                if a.alias_info is None or not a.alias_info.is_write:
                    continue
                if i < len(args):
                    args2[i] = copy(args[i])
                    written.append((args[i], args2[i]))
                elif a.name in kwargs:
                    kwargs2[a.name] = copy(kwargs[a.name])
                    written.append((kwargs[a.name], kwargs2[a.name]))
            with threads(other):
                out2 = func(*args2, **kwargs2)
            out = func(*args, **kwargs)
            pairs = ([p for w in written for p in zip(tree_leaves(w[0]),
                                                       tree_leaves(w[1]))]
                     if written else list(zip(tree_leaves(out),
                                              tree_leaves(out2))))
            rels = [(i, rel_diff(a, b)) for i, (a, b) in enumerate(pairs)
                    if isinstance(a, torch.Tensor)]
            if any(r > tol for _, r in rels):
                node = torch._C._current_autograd_node()
                where = ("forward", port_frame(traceback.format_stack())) \
                    if node is None else (node.name(), port_frame(
                        node.metadata.get("traceback_", [])))
            for i, r in rels:
                if r <= tol:
                    continue
                key = (str(func), i) + where
                rec = found.setdefault(key, {
                    "op": key[0], "output": i, "pass": where[0],
                    "where": where[1], "calls": 0, "rel": 0.0})
                rec["calls"] += 1
                rec["rel"] = max(rec["rel"], r)
            return out

    with torch.autograd.detect_anomaly(check_nan=False), Sweep():
        fn()
    return sorted(found.values(), key=lambda r: -r["rel"])


def leaf_outputs(model) -> tuple:
    """(records, hooks): every leaf module's output, as a strided
    subsample of ``SWEEP_SAMPLE`` elements of each tensor, per call."""
    import torch
    from torch.utils._pytree import tree_leaves
    rec: Dict[str, List] = {}

    def hook(name):
        def keep(m, inp, out):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    flat = t.detach().reshape(-1)
                    step = max(1, flat.numel() // SWEEP_SAMPLE)
                    rec.setdefault(name, []).append(flat[::step].double())
        return keep

    hooks = [m.register_forward_hook(hook(n)) for n, m in
             model.named_modules() if not list(m.children())]
    return rec, hooks


def module_where(model, name: str) -> str:
    import inspect
    cls = type(model.get_submodule(name))
    try:
        path = inspect.getsourcefile(cls)
        line = inspect.getsourcelines(cls)[1]
    except (OSError, TypeError):
        return cls.__name__
    return f"{os.path.relpath(path, REPO)}:{line} ({cls.__name__})"


def thread_sweep(path: str, batch: Dict, counts=(1, HOLD_THREADS),
                 tol: float = SWEEP_TOL) -> Dict:
    """One step of ``path`` (``t1``/``t3``: `TRAIN_PATH_OF`) on the loader
    batch ``batch`` at each of the two thread counts, compared: ``modules``,
    the leaf modules whose forward output differs by more than ``tol``
    rel-max (on `leaf_outputs`' subsample; they inherit what ran before
    them), ``grads``, the parameters whose step-0 gradient does, and
    ``ops``, `op_sweep` of the step at ``counts[0]`` against
    ``counts[1]``: the kernels that move by themselves."""
    import tempfile
    import torch
    name, dtype = TRAIN_PATH_OF[path]
    runs = []
    for n in counts:
        with threads(n), tempfile.TemporaryDirectory() as logs:
            runner = train_runner(name, "cpu", dtype, logs)
            rec, hooks = leaf_outputs(runner.model)
            try:
                grads = run_steps(runner, batch, steps=1)["grads"]
            finally:
                for h in hooks:
                    h.remove()
            runs.append((rec, grads))
    model = runner.model
    (rec_a, g_a), (rec_b, g_b) = runs
    modules = [{"module": k, "where": module_where(model, k), "rel": r}
               for k in rec_a for r in [max(rel_diff(a, b) for a, b in zip(
                   rec_a[k], rec_b[k]))] if r > tol]
    grads = [{"param": k, "rel": r} for k in g_a for r in [rel_diff(
        torch.from_numpy(g_a[k]), torch.from_numpy(g_b[k]))] if r > tol]
    with threads(counts[0]), tempfile.TemporaryDirectory() as logs:
        runner = train_runner(name, "cpu", dtype, logs)
        ops = op_sweep(lambda: run_steps(runner, batch, steps=1),
                       counts[1], tol)
    return {"path": path, "counts": list(counts), "tol": tol,
            "modules": sorted(modules, key=lambda r: -r["rel"]),
            "grads": sorted(grads, key=lambda r: -r["rel"]), "ops": ops}


def hold_at(path: str, batch: Dict, n: int) -> Dict:
    """T1's or T3's hold on the CPU at ``n`` intra-op threads: {threads,
    seconds, failure (the first bar missed, or None), figures
    (`float32_figures`)}."""
    import time
    name, dtype = TRAIN_PATH_OF[path]
    with threads(n):
        t0 = time.perf_counter()
        run = run_train(name, "cpu", dtype, batch, grids=path == "t3")
        seconds = time.perf_counter() - t0
        golden = golden_pair(path)
        plan = train_plan(run, load_train_meta()["paths"][path])
        failure = None
        try:
            hold_float32(run, golden, plan, f"{path.upper()} on the CPU",
                         pooled=path == "t3")
            if path == "t3":
                hold_t3_grids(run, golden["jax"], "T3 on the CPU")
        except AssertionError as e:
            failure = str(e)
        return {"path": path, "threads": n, "seconds": seconds,
                "failure": failure,
                "figures": float32_figures(run, golden, plan,
                                           pooled=path == "t3")}


def main(argv=None):
    """``holds t1|t3 --threads N ...``: one JSON line of `hold_at` a count;
    ``sweep t1|t3 --threads A B``: `thread_sweep`'s JSON."""
    import argparse
    import tempfile
    import torch
    from lanemapping_tpu_torch.data import synthetic
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("what", choices=("holds", "sweep"))
    ap.add_argument("path", choices=sorted(TRAIN_PATH_OF))
    ap.add_argument("--threads", type=int, nargs="+",
                    default=[1, HOLD_THREADS])
    ap.add_argument("--out", help="write the sweep's JSON here too")
    args = ap.parse_args(argv)
    print(json.dumps({"torch": torch.__version__, "cpu_capability":
                      torch.backends.cpu.get_cpu_capability()}), flush=True)
    with tempfile.TemporaryDirectory() as root:
        train_dataset(root, synthetic)
        batch = first_train_batch(TRAIN_PATH_OF[args.path][0], root)
        if args.what == "holds":
            for n in args.threads:
                print(json.dumps(hold_at(args.path, batch, n)), flush=True)
            return
        require(len(args.threads) == 2, "sweep compares two counts")
        rec = thread_sweep(args.path, batch, tuple(args.threads))
    text = json.dumps(rec, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    import sys
    sys.path.insert(0, REPO)
    main()
