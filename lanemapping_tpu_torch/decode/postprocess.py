"""Polyline post-processing: greedy smoothing, NMS, semantics, re-render.

A copy of `lanemapping_tpu/decode/postprocess.py` (NumPy only, so the port
keeps its own copy rather than importing the JAX package).

Behavioural parity with the reference NumPy post-processing
(`baseline/utils/polyline_utils.py:57-638` and the map
assembly in `heads/polyline_fpn_vit_vertex_2.py:761-886`):

  1. greedy vertex-string tracker over the 144 row anchors with width-6 /
     depth-24 search buffers and linear extrapolation (`:222-387`),
  2. pairwise polyline NMS: vertex-level merge of overlapping lines, then
     duplicate suppression keeping the longer line (`:57-164`),
  3. run-length semantic uniformisation + endpoint pruning (`:448-586`),
  4. short-line removal and semantic-map re-render (`:589-638`).

This stage runs on host NumPy over coordinates already decoded on-device
(`decode/lane_decode.py`); one 144-vertex polyline set per tile is tiny, so
host cost is negligible next to the encoder, and an XLA reformulation of the
tracker is tracked as future work (SURVEY.md §7 hard-part #1).

Conventions: a lane is a float row-vector of length S (144); entries are
column coordinates at full image resolution (0..1151) or -1 for "no vertex";
row anchor r sits at image row 8*r+3.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logger import count, recording, trace_span, traced

BUFF_WIDTH = 6
BUFF_DEPTH = 24
NMS_DIST = 10


# --------------------------------------------------------------------------
# small geometry helpers
# --------------------------------------------------------------------------

def overlap_distance(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float]:
    """(min, max, mean) |a-b| over rows where both lines have a vertex;
    all -1 when they never overlap (reference `Hausdorf_distance:7-19`)."""
    d = np.abs(a - b)
    d[(a < 0) | (b < 0)] = -1.0
    if d.max() < 0:
        return -1.0, -1.0, -1.0
    valid = d[d >= 0]
    return float(valid.min()), float(d.max()), float(valid.mean())


def sort_left_to_right(lines: np.ndarray) -> np.ndarray:
    """Order lines by the column of their first valid vertex
    (reference `sort_lines_from_left_to_right:167-178`)."""
    first = np.full(len(lines), 1152.0)
    for i, row in enumerate(lines):
        idx = np.nonzero(row >= 0)[0]
        if len(idx):
            first[i] = row[idx[0]]
    return lines[np.argsort(first, kind="stable")]


def fill_gaps(lines: np.ndarray) -> np.ndarray:
    """Linear interpolation of interior missing vertices
    (reference `interpolate_plyline:180-198`)."""
    for row in lines:
        idx = np.nonzero(row > 1e-4)[0]
        if len(idx) < 2:
            continue
        # interpolate every gap between consecutive anchors
        for a, b in zip(idx[:-1], idx[1:]):
            if b - a > 1:
                t = (np.arange(a + 1, b) - a) / (b - a)
                row[a + 1:b] = (1 - t) * row[a] + t * row[b]
    return lines


def thin_vertex_grid(occ: np.ndarray, conf: np.ndarray,
                     half_k: int = 4,
                     first_row_only: bool = False) -> np.ndarray:
    """Keep only the max-confidence vertex inside each 2*half_k column window
    (reference `occupancy_filter:200-220` — note the reference's early
    ``return`` inside the row loop makes it a single-row filter; we apply the
    window over every row, the evidently intended behaviour).

    ``first_row_only=True`` (cfg ``ref_exact_occupancy_filter``) transcribes
    the reference bug bit-for-bit: a window slides over row 0 only, every
    other row keeps all its raw vertices."""
    out = occ.copy()
    if first_row_only:
        r, cols = 0, occ.shape[1]
        for c in range(half_k, cols - half_k):
            lo, hi = c - half_k, c + half_k
            if out[r, lo:hi].sum() > 1:
                vals = conf[r, lo:hi]
                idx = np.nonzero(out[r, lo:hi] > 0)[0]
                best = idx[np.argmax(vals[idx])]
                out[r, lo:hi] = 0
                out[r, lo + best] = 1
        return out
    rows, _ = occ.shape
    for r in range(rows):
        cols = np.nonzero(out[r])[0]
        if len(cols) < 2:
            continue
        for c in cols:
            lo, hi = c - half_k, c + half_k
            if lo < half_k - 1 or hi > occ.shape[1] - half_k:
                continue
            window = np.nonzero(out[r, lo:hi])[0]
            if len(window) > 1:
                best = window[np.argmax(conf[r, lo + window])]
                out[r, lo:hi] = 0
                out[r, lo + best] = 1
    return out


# --------------------------------------------------------------------------
# 1. greedy vertex-string tracker
# --------------------------------------------------------------------------

def smooth_lanes(out_cls: np.ndarray, orient: np.ndarray,
                 seg_conf: Optional[np.ndarray] = None,
                 complete_inner_nodes: bool = True,
                 occ_first_row_only: bool = False) -> np.ndarray:
    """Re-chain raw per-proposal vertices into coherent polylines
    (reference `smooth_cls_line_per_batch:222-387`).

    ``out_cls``: [P,S] predicted columns (image scale, -1 = none).
    ``orient``:  [S,S] per-pixel orientation classes (downsampled grid).
    ``seg_conf``: [S,1152] lane confidence at the S row anchors (rows 8r+3
    of the full map — all the reference ever samples, `:246`).
    """
    n_line, n_v = out_cls.shape
    src = sort_left_to_right(out_cls)

    # occupancy grid of free vertices at full column resolution
    occ = np.zeros((n_v, 1152))
    for i in range(n_line):
        rows = np.nonzero(out_cls[i] > 0)[0]
        occ[rows, out_cls[i, rows].astype(int)] = 1
    if seg_conf is not None:
        occ = thin_vertex_grid(occ, seg_conf, half_k=4,
                               first_row_only=occ_first_row_only)

    total = np.full_like(out_cls, -1.0)
    total_len = np.zeros(n_line)

    while occ.sum() > 2 and total_len.min() < 2:
        cand = np.full_like(out_cls, -1.0)
        cand_len = np.zeros(n_line)
        for li in range(n_line):
            started = False
            r = 0
            last_r = 0
            last_c = 0.0
            cur_c = 0.0
            h_step = 1
            active = li
            while r < n_v:
                if started and (r - last_r > BUFF_DEPTH):
                    break
                if not started:
                    c = src[li, r]
                    if c > 0 and occ[r, int(c)] > 0:
                        started = True
                        occ[r, int(c)] = 0
                        cand[li, r] = c
                        cand_len[li] += 1
                        last_r, last_c, cur_c = r, c, c
                        active = li
                    r += 1
                    h_step = 1
                    continue
                # predict the next column by linear extrapolation
                pred = cur_c
                if cand_len[li] > 1:
                    pred = cur_c + (cur_c - last_c) / h_step
                near_d, near_i, near_r = 1152.0, n_line, r
                # width search: nearest free vertex on this row
                for si in range(n_line):
                    c = src[si, r]
                    if c > 0 and occ[r, int(c)] > 0:
                        d = abs(pred - c)
                        if d < near_d:
                            near_d, near_i, near_r = d, si, r
                # depth search: first free vertex further down the active line
                for rr in range(r + 1, n_v):
                    if rr - r > BUFF_DEPTH:
                        break
                    c = src[active, rr]
                    if c > 0 and occ[rr, int(c)] > 0:
                        d = abs(pred - c)
                        if d < near_d:
                            near_d, near_i, near_r = d, active, rr
                        break
                if near_d < BUFF_WIDTH:
                    c = src[near_i, near_r]
                    cand[li, near_r] = c
                    cand_len[li] += 1
                    occ[near_r, int(c)] = 0
                    last_c, cur_c = cur_c, c
                    h_step = near_r - last_r
                    last_r = near_r
                    r = near_r + 1
                    active = near_i
                else:
                    cand[li, r] = -1
                    r += 1
                    h_step += 1

        # merge candidate strings into the running result: attach to an
        # existing lane if extrapolated ends meet, else open a new slot
        for li in range(n_line):
            if cand_len[li] <= 2:
                continue
            v_idx = np.nonzero(cand[li] > 0)[0]
            c_start_r, c_end_r = v_idx[0], v_idx[-1]
            c_start_v = cand[li, c_start_r]
            c_end_v = cand[li, c_end_r]
            c_end_next = c_end_v + (c_end_v - cand[li, v_idx[-2]])
            attached = False
            for si in range(n_line):
                if total_len[si] < 2:
                    continue
                t_idx = np.nonzero(total[si] > 0)[0]
                t_start_r, t_end_r = t_idx[0], t_idx[-1]
                t_start_v = total[si, t_start_r]
                t_end_v = total[si, t_end_r]
                t_end_next = t_end_v + (t_end_v - total[si, t_idx[-2]])
                attach_bottom = (0 < c_start_r - t_end_r < BUFF_DEPTH
                                 and abs(t_end_next - c_start_v) < BUFF_WIDTH)
                attach_top = (0 < t_start_r - c_end_r < BUFF_DEPTH
                              and abs(c_end_next - t_start_v) < BUFF_WIDTH)
                if attach_bottom or attach_top:
                    total[si, v_idx] = cand[li, v_idx]
                    total_len[si] += cand_len[li]
                    attached = True
                    break
            if not attached:
                for si in range(n_line):
                    if total_len[si] < 2:
                        total[si, v_idx] = cand[li, v_idx]
                        total_len[si] = cand_len[li]
                        break

    if complete_inner_nodes:
        total = fill_gaps(total)
    return sort_left_to_right(total)


# --------------------------------------------------------------------------
# 2. polyline NMS
# --------------------------------------------------------------------------

def _merge_pair(a: np.ndarray, b: np.ndarray, sem_rows: np.ndarray) -> None:
    """Vertex-level merge of two overlapping lines, in place
    (reference `lines_align:22-45` + the point-to-point pass `:92-137`)."""
    # align: make `a` the left line per-row; drop near-duplicate vertices
    d = np.abs(a - b)
    d[(a < 0) | (b < 0)] = -1
    for r in np.nonzero(d >= 1e-5)[0]:
        if b[r] < a[r]:
            a[r], b[r] = b[r], a[r]
        if abs(a[r] - b[r]) < 2.0:
            if (abs(a[r] - a[r - 1]) < abs(b[r] - b[r - 1])
                    and a[r - 1] > 0 and b[r - 1] > 0):
                b[r] = -1
            else:
                a[r] = -1

    last_a = None
    last_b = None
    n_v = len(a)
    for r in range(n_v):
        va, vb = a[r], b[r]
        if vb < 0:
            continue
        if va < 0:  # only b has a vertex: try to absorb it into a
            if last_a is None or abs(last_a - vb) < NMS_DIST:
                a[r], b[r] = vb, -1.0
                last_a = a[r]
            else:
                last_b = vb
        else:  # both have vertices on this row
            if abs(vb - va) < NMS_DIST:
                ra = sem_rows[r, int(va)]
                rb = sem_rows[r, int(vb)]
                high = va if ra > rb else vb
                if last_a is None and last_b is None:
                    a[r], b[r] = high, -1.0
                    last_a = a[r]
                elif last_a is not None and abs(last_a - high) < NMS_DIST:
                    a[r], b[r] = high, -1.0
                    last_a = a[r]
                else:
                    a[r], b[r] = -1.0, high
                    last_b = b[r]
            elif last_a is None and last_b is None:
                if va > vb:  # keep `a` on the left
                    a[r], b[r] = vb, va
                last_a, last_b = a[r], b[r]


def polyline_nms(lines: np.ndarray, sem_rows: np.ndarray) -> np.ndarray:
    """Merge overlapping polylines, then suppress near-duplicates keeping the
    longer line (reference `polyline_NMS2:57-164`).  ``sem_rows``: [S,1152]
    confidence at the row anchors."""
    n_line = len(lines)
    for i in range(n_line - 1):
        if np.count_nonzero(lines[i] > 0) < 2:
            continue
        for j in range(i + 1, n_line):
            if np.count_nonzero(lines[j] > 0) < 2:
                continue
            mn, _, _ = overlap_distance(lines[i], lines[j])
            if 0.0 <= mn < NMS_DIST:
                _merge_pair(lines[i], lines[j], sem_rows)
    lines = fill_gaps(lines)

    for i in range(n_line - 1):
        n_i = np.count_nonzero(lines[i] > 0)
        if n_i < 2:
            lines[i] = -1.0
            continue
        for j in range(i + 1, n_line):
            n_j = np.count_nonzero(lines[j] > 0)
            if n_j < 2:
                lines[j] = -1.0
                continue
            _, mx, mean = overlap_distance(lines[i], lines[j])
            if mx >= 0 and (mx < NMS_DIST * 1.5 or mean < NMS_DIST * 0.8):
                if n_i < n_j:
                    lines[i] = -1.0
                else:
                    lines[j] = -1.0
    return lines


# --------------------------------------------------------------------------
# 3. semantics
# --------------------------------------------------------------------------

def lane_vertex_semantics(lines: np.ndarray,
                          point_sem: np.ndarray) -> np.ndarray:
    """Per-vertex solid/dashed labels by segment voting against the decoded
    point-semantic map (reference `get_pred_semantic_lane_coordinates`,
    `polyline_fpn_vit_vertex_2.py:1091-1115`), vectorised over all
    [P, S-1] segments (the double Python loop was a measured hot spot on
    the streaming host)."""
    n_line, n_v = lines.shape
    c0 = np.trunc(lines[:, :-1]).astype(np.int64)
    c1 = np.trunc(lines[:, 1:]).astype(np.int64)
    valid = (c0 >= 0) & (c1 >= 0)
    w = point_sem.shape[1]
    rows0 = (np.arange(n_v - 1) * 8 + 3)[None, :]
    s0 = point_sem[rows0, np.clip(c0, 0, w - 1)]
    s1 = point_sem[rows0 + 8, np.clip(c1, 0, w - 1)]
    val = np.where((s0 == 2) | (s1 == 2), 2.0, 1.0)
    sem = np.zeros_like(lines)
    sem[:, :-1] = np.where(valid, val, 0.0)
    # trailing vertex inherits its segment's label (reference `:1113-1115`)
    last = valid[:, -1] & (c1[:, -1] > 0)
    sem[:, -1] = np.where(last, val[:, -1], 0.0)
    return sem


def _run_length(sem_row: np.ndarray) -> List[List[int]]:
    runs = [[int(sem_row[0]), 1]]
    for v in sem_row[1:]:
        if int(v) == runs[-1][0]:
            runs[-1][1] += 1
        else:
            runs.append([int(v), 1])
    return runs


def uniform_semantics(ply: np.ndarray, endp_map: Optional[np.ndarray],
                      r_buff: int = 20, ep: Optional[np.ndarray] = None,
                      keep_line_ends: bool = False):
    """Run-length smoothing of per-vertex semantics + endpoint pruning
    (reference `polyline_uniform_semantics_by_statistics:448-586`).

    ``ply``: [N,S,2] (column, semantic) per vertex.  ``ep``: optional
    precomputed [M,2] endpoint coordinates (skips a full-map argwhere).
    ``keep_line_ends``: exempt endpoints in a line's terminal zone from the
    interior-endpoint prune — the reference radius-kills over ALL vertices,
    deleting the line's own terminal endpoints precisely when decode and
    heatmap agree (cfg ``endp_keep_line_ends``; False = reference).
    Returns (ply, endp_map).
    """
    from scipy.spatial import cKDTree

    n_line, n_v, _ = ply.shape
    all_pts = []
    if endp_map is not None and ep is None:
        ep = np.argwhere(endp_map > 0)
    ep_i = ep.astype(int) if ep is not None else None
    for li in range(n_line):
        v_idx = np.nonzero(ply[li, :, 0] > 0)[0]
        if len(v_idx) < 2:
            continue
        pts = np.stack([np.arange(3, n_v * 8, 8), ply[li, :, 0]], axis=1)
        all_pts.append(pts[v_idx])

        runs = _run_length(ply[li, :, 1])
        # swallow short runs sandwiched between equal longer neighbours,
        # growing the tolerated void size 5 -> r_buff in steps of 3
        void = 5
        while void < r_buff:
            k = 1
            while k < len(runs) - 1:
                prev, cur, nxt = runs[k - 1], runs[k], runs[k + 1]
                if (prev[0] > 0 and prev[0] != cur[0] and nxt[0] == prev[0]
                        and cur[1] < void and prev[1] >= cur[1]
                        and nxt[1] >= cur[1]):
                    prev[1] += cur[1] + nxt[1]
                    del runs[k:k + 2]
                    k = 1
                else:
                    k += 1
            void += 3
        pos = 0
        for val, cnt in runs:
            ply[li, pos:pos + cnt, 1] = val
            pos += cnt

        # a single-semantic long line should have no interior endpoints
        if endp_map is not None and len(ep):
            best = max((c for v, c in runs if v > 0), default=0)
            if best > 130:
                tree = cKDTree(pts[v_idx])
                d, _ = tree.query(ep, k=1)
                kill = d <= 8
                if keep_line_ends:
                    for term in (pts[v_idx[0]], pts[v_idx[-1]]):
                        kill &= np.hypot(*(ep - term).T) > 8
                for idx in np.nonzero(kill)[0]:
                    endp_map[ep_i[idx, 0], ep_i[idx, 1]] = 0.0

    # prune endpoints with no polyline within 10 px
    if endp_map is not None and len(ep) and all_pts:
        tree = cKDTree(np.concatenate(all_pts, axis=0))
        d, _ = tree.query(ep, k=1)
        for idx in np.nonzero(d > 10)[0]:
            endp_map[ep_i[idx, 0], ep_i[idx, 1]] = 0.0
    return ply, endp_map


def remove_short(ply: np.ndarray, min_v_count: int = 8) -> np.ndarray:
    """Drop polylines with fewer vertices than ``min_v_count``
    (reference `remove_short_polyline:589-608`)."""
    for li in range(len(ply)):
        if np.count_nonzero(ply[li, :, 0] > 0) < min_v_count:
            ply[li, :, 0] = -1.0
            ply[li, :, 1] = 0.0
    return ply


def render_semantic_map(ply: np.ndarray, img: int = 1152) -> np.ndarray:
    """Rasterise final polylines back to a semantic image
    (reference `renew_semantic_map:610-638`).

    Vectorised: all segments are gathered at once and rasterised in groups
    of equal sample count (up to 72 lanes x 143 segments per 1152px tile
    made the per-segment loop of `lanemapping_tpu` a measurable host cost in
    the streaming pipeline).  Occupancy is identical to that loop; the class
    value where differently-labelled segments CROSS can differ, because
    last-write-wins order is grouped by sample count here and by lane
    order in the loop (itself arbitrary at crossings).
    """
    n_line, n_v, _ = ply.shape
    c0 = np.trunc(ply[:, :-1, 0])
    c1 = np.trunc(ply[:, 1:, 0])
    li, r = np.nonzero((c0 >= 0) & (c1 >= 0))
    out = np.zeros((img, img), np.float32)
    if not len(li):
        return out
    a_c, b_c = c0[li, r], c1[li, r]
    val = np.where((ply[li, r, 1].astype(int) == 2)
                   | (ply[li, r + 1, 1].astype(int) == 2), 2.0, 1.0)
    a_r = r * 8 + 3
    n_samp = np.maximum(8, np.abs(b_c - a_c).astype(int)) + 1
    for n in np.unique(n_samp):
        m = n_samp == n
        t = np.linspace(0.0, 1.0, n)
        rr = np.rint(a_r[m, None] + 8.0 * t[None, :]).astype(np.int64)
        cc = np.rint(a_c[m, None]
                     + (b_c - a_c)[m, None] * t[None, :]).astype(np.int64)
        keep = (rr >= 0) & (rr < img) & (cc >= 0) & (cc < img)
        out[rr[keep], cc[keep]] = np.broadcast_to(
            val[m, None], rr.shape)[keep]
    return out


# --------------------------------------------------------------------------
# map assembly (reference `get_lane_map_numpy_with_label:761-886`)
# --------------------------------------------------------------------------

_fallback_said = False


def _native_fallback(stage: str, err: Optional[BaseException]) -> None:
    """The NumPy result of ``stage`` stands in for the native one: counted
    (``native_fallbacks``, while a profiler runs), and said once a
    process with the exception behind it (``err``, or the library's own
    failure to build or load)."""
    global _fallback_said
    count("native_fallbacks")
    if _fallback_said:
        return
    _fallback_said = True
    if err is None:
        from .. import native
        err = native.load_error()
    warnings.warn(f"native post-process unavailable: {stage} and any later "
                  f"stage run in NumPy ({err!r})", RuntimeWarning,
                  stacklevel=3)


def _smooth_dispatch(coors, orient, seg_conf, img, occ_first_row_only=False):
    """Prefer the native C++ tracker (`native/`), falling back
    to the NumPy implementation when the library isn't built."""
    err = None
    try:
        from ..native import smooth_lanes_native
        out = smooth_lanes_native(coors, orient, seg_conf, True, img,
                                  occ_first_row_only=occ_first_row_only)
        if out is not None:
            return out
    except Exception as e:
        err = e
    _native_fallback("tracker", err)
    return smooth_lanes(coors, orient, seg_conf=seg_conf,
                        complete_inner_nodes=True,
                        occ_first_row_only=occ_first_row_only)


def _nms_dispatch(lines, sem_rows, img):
    err = None
    try:
        from ..native import polyline_nms_native
        out = polyline_nms_native(lines, sem_rows, img)
        if out is not None:
            return out
    except Exception as e:
        err = e
    _native_fallback("NMS", err)
    return polyline_nms(lines, sem_rows)


def _uniform_dispatch(ply, endp_map, ep, r_buff, keep_line_ends=False):
    """Native semantic uniformisation + endpoint pruning with NumPy
    fallback; ``ep`` [M,2] are the endpoint coordinates already scattered
    into ``endp_map``."""
    err = None
    try:
        from ..native import uniform_semantics_native
        out = uniform_semantics_native(ply, ep, r_buff=r_buff,
                                       keep_line_ends=keep_line_ends)
        if out is not None:
            ply, keep = out
            dropped = ep[~keep].astype(int)
            if len(dropped):
                endp_map[dropped[:, 0], dropped[:, 1]] = 0.0
            return ply, endp_map
    except Exception as e:
        err = e
    _native_fallback("semantics", err)
    return uniform_semantics(ply, endp_map, r_buff=r_buff,
                             ep=np.asarray(ep, np.float64),
                             keep_line_ends=keep_line_ends)


@traced("serve.postprocess")
def lane_maps_from_decode(dec: Dict, cfg) -> Dict:
    """Host assembly of final lane maps from the on-device decode dict.
    While a profiler runs it counts ``tiles`` and ``proposals`` (those that
    pass ``proposal_obj_thre`` and the border cut) and spans the tracker,
    NMS and semantics of each tile."""
    row_size = cfg.heads.row_size
    img = cfg.list_img_size_xy[0]
    B, P, S = dec["cls_offset"].shape

    view_detail = bool(cfg.get("view_detail", False))
    out = {"cls_offset_smooth": [], "endp_by_cls": [], "semantic_line": []}
    if view_detail:
        out["cls_coor_pred_smooth"] = []
        out["cls_exp_smooth"] = []
    for b in range(B):
        conf = dec["prop_conf"][b, :, 1]
        v_ext = np.array(dec["prop_v_ext"][b], dtype=np.float64)
        v_ext[conf < cfg.proposal_obj_thre, :] = 0.0
        v_ext[0:4, :] = 0.0   # border proposals (reference `:814-816`)
        v_ext[-6:, :] = 0.0
        if recording():
            kept = conf >= cfg.proposal_obj_thre
            kept[0:4] = False
            kept[-6:] = False
            count("proposals", int(np.count_nonzero(kept)))
            count("tiles")
        exist = np.where(v_ext > 0.5, v_ext, -1.0)

        coors = np.array(dec["cls_offset"][b], dtype=np.float64)
        coors = coors / row_size * img
        coors = np.where(exist == -1, -1.0, coors)
        coors = np.clip(coors, -1.0, img - 1.0)
        coors[(coors > -1) & (coors < 0)] = 0.0

        # point-semantic scatter map at full resolution (float32: the map
        # is only compared against {1,2} downstream)
        point_sem = np.zeros((img, img), np.float32)
        li_idx, rows = np.nonzero(coors > 0)
        point_sem[rows * 8 + 3, coors[li_idx, rows].astype(int)] = \
            exist[li_idx, rows]

        # anchor-row confidence matrix [S,1152] — the decode ships only
        # these rows (devices->host traffic), and native tracker/NMS take
        # them as float32 directly
        seg_conf = np.ascontiguousarray(dec["bi_seg_rows"][b],
                                        dtype=np.float32)
        orient = np.array(dec["orient"][b], dtype=np.int64)
        # cfg.ref_exact_occupancy_filter: reproduce the reference's
        # single-row occupancy_filter bug (`polyline_utils.py:220`)
        occ_first = bool(cfg.get("ref_exact_occupancy_filter", False))
        with trace_span("postprocess.track"):
            smooth = _smooth_dispatch(coors, orient, seg_conf, img,
                                      occ_first_row_only=occ_first)
        with trace_span("postprocess.nms"):
            smooth = _nms_dispatch(smooth, seg_conf, img)

        if view_detail:
            # raw-argmax and expectation variants (reference `:821-845`:
            # the cls path carries a +4 half-stride offset)
            for key, out_key, off in (("cls", "cls_coor_pred_smooth", 4.0),
                                      ("cls_exp", "cls_exp_smooth", 0.0)):
                v = np.array(dec[key][b], dtype=np.float64)
                v = v / row_size * img + off
                v = np.where(exist == -1, -1.0, v)
                v = np.clip(v, -1.0, img - 1.0)
                v[(v > -1) & (v < 0)] = 0.0
                vs = _smooth_dispatch(v, orient, seg_conf, img,
                                      occ_first_row_only=occ_first)
                out[out_key].append(_nms_dispatch(vs, seg_conf, img))

        if "endp_logits" in dec:
            # cfg.endp_decode == 'exact_host': the reference's adaptive-K
            # loop on the raw heatmap (decode/endpoints_host.py)
            from .endpoints_host import decode_endpoints_host
            pts = decode_endpoints_host(np.asarray(dec["endp_logits"][b]),
                                        cfg.number_lanes).astype(int)
        else:
            coords = np.array(dec["endp_coords"][b])
            valid = np.array(dec["endp_valid"][b])
            pts = coords[valid].astype(int)
        endp_map = np.zeros((img, img), np.float32)
        if len(pts):
            endp_map[pts[:, 0], pts[:, 1]] = 1.0

        sem = lane_vertex_semantics(smooth, point_sem)
        ply = np.stack([smooth, sem], axis=2)
        with trace_span("postprocess.semantics"):
            ply, endp_map = _uniform_dispatch(
                ply, endp_map, np.asarray(pts, np.float64).reshape(-1, 2),
                r_buff=cfg.get("endp_prune_r_buff", 20),
                keep_line_ends=cfg.get("endp_keep_line_ends", False))
        ply = remove_short(ply, min_v_count=8)
        out["cls_offset_smooth"].append(ply)
        out["endp_by_cls"].append(endp_map)
        out["semantic_line"].append(render_semantic_map(ply, img))
    return out
