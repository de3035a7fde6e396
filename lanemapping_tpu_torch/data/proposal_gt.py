"""Column-proposal ground-truth construction, vectorised (a copy of
`lanemapping_tpu/data/proposal_gt.py`).

Functional parity with the reference's per-sample GT build
(reference `baseline/datasets/laserlane_proposals.py:102-494`), which
runs a Python loop over 12 lanes and 72 proposals inside every dataloader
worker (the CPU hot spot flagged in SURVEY.md §3.1).  Here the whole build is
NumPy scatter/gather math:

  * per-(lane,row) column extraction is a single ``np.maximum.at`` scatter
    (the reference's last-write-wins indexed assignment picks the max column
    because ``np.where`` enumerates row-major),
  * proposal<->lane mean-distance assignment is one broadcasted [P,L,S]
    reduction,
  * window slicing is one fancy-gather on the padded maps.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def lane_line_maps(inst: np.ndarray, n_cls: int, row_size: int, ds: int,
                   ori_raw: Optional[np.ndarray], semantic: np.ndarray):
    """Per-lane row-anchor maps (reference `:414-494`).

    ``inst``: [H,H] instance ids 0..n_cls-1, background >= n_cls (255).
    Returns (ext [L,S], coor [L,S], offset [L,S,S], offset_mask [L,S,S],
    orient [S,S]).
    """
    H = inst.shape[0]
    S = row_size
    rows, cols = np.nonzero(inst < n_cls)
    lane = inst[rows, cols]

    coor_raw = np.zeros((n_cls, H), dtype=np.float64)
    np.maximum.at(coor_raw, (lane, rows), cols.astype(np.float64))
    coor_raw /= ds
    coor = coor_raw[:, 3::ds].copy()  # [L,S], 0 where lane absent in the row

    col_index = np.arange(S, dtype=np.float64)
    offset = coor[:, :, None] - col_index[None, None, :]  # [L,S,S]
    offset_mask = (np.abs(offset) < 3.0).astype(np.float32)
    offset_mask[:, :, :3] = 0.0  # reference `:468` avoids the first columns

    present = coor > 0.0
    ext = present * semantic[:, None].astype(np.float64)  # [L,S]
    coor = np.where(present, coor, -1.0)

    orient = np.zeros((S, S), dtype=np.int32)
    if ori_raw is not None:
        buff = 3
        for c in range(n_cls):
            r_idx = np.nonzero(present[c])[0]
            if len(r_idx) < 2:
                continue
            dcol = coor[c, r_idx].astype(np.int64)
            left = np.clip(dcol - buff, 0, None)
            right = np.clip(dcol + buff, None, S - 1)
            src_col = np.clip((coor[c, r_idx] * ds).astype(np.int64), 0, H - 1)
            src = ori_raw[r_idx * ds + 3, src_col]
            for r, l, rg, v in zip(r_idx, left, right, src):
                orient[r, l:rg] = v
    return ext, coor, offset, offset_mask, orient


def merge_touching_lanes(ext, coor, offset, offset_mask, bi_seg,
                         init_pts, term_pts, inst=None):
    """Merge lane j into lane i when j's start touches i's end
    (reference `:334-367`).  Mutates all inputs in place.

    ``bi_seg`` may be None when the per-lane binary maps aren't needed
    (fused seg-focal path); ``inst`` is an optional [H,H] id map relabelled
    j->i at each merge so ``inst == lane_id`` stays equal to the merged
    per-lane map (bi_seg[i] |= bi_seg[j]; bi_seg[j] = 0)."""
    n_cls = ext.shape[0]
    for i in range(n_cls):
        e1 = term_pts[i]
        if not (e1[0] > 0 and e1[1] > 0):
            continue
        for j in range(n_cls):
            if j == i:
                continue
            s2 = init_pts[j]
            if (s2[0] > 0 and s2[1] > 0 and abs(e1[0] - s2[0]) < 2
                    and abs(e1[1] - s2[1]) < 2):
                rows = np.nonzero(ext[j] > 0)[0]
                ext[i, rows] = ext[j, rows]
                coor[i, rows] = coor[j, rows]
                offset[i, rows] = offset[j, rows]
                offset_mask[i, rows] = offset_mask[j, rows]
                ext[j, rows] = 0
                coor[j, rows] = -1
                offset[j, rows] = 0
                offset_mask[j, rows] = 0
                init_pts[j] = 0
                term_pts[j] = 0
                if bi_seg is not None:
                    bi_seg[i] |= bi_seg[j]
                    bi_seg[j] = 0
                if inst is not None:
                    inst[inst == j] = i


def assign_proposals(coor: np.ndarray, num_prop: int, prop_width: int,
                     half_buff: int) -> np.ndarray:
    """Nearest-GT-lane id per proposal by constrained mean column distance
    (reference `:163-208`).  Returns int [P]."""
    P, pw, hb = num_prop, prop_width, half_buff
    col0 = pw * np.arange(P, dtype=np.float64)  # [P]
    c = coor[None, :, :]  # [1,L,S]
    left = (col0 - hb)[:, None, None]
    right = (col0 + hb + pw)[:, None, None]
    valid = (c >= left) & (c <= right) & (c >= 0)
    dist = np.abs(col0[:, None, None] - c) * valid
    cnt = valid.sum(axis=2).astype(np.float64)  # [P,L]
    mean = dist.sum(axis=2) / np.maximum(cnt, 1.0)
    mean = np.where(mean == 0.0, 143.0, mean)  # reference `:191`
    return np.argmin(mean, axis=1)


def build_proposal_gt(inst_raw: np.ndarray, mask: np.ndarray,
                      ori_raw: np.ndarray, endp_map: np.ndarray,
                      init_pts: np.ndarray, term_pts: np.ndarray,
                      semantic: np.ndarray, *, n_cls: int, row_size: int,
                      ds: int, num_prop: int, prop_width: int,
                      half_buff: int,
                      emit_full_bi_seg: bool = True) -> Dict[str, np.ndarray]:
    """Full per-tile GT dict (reference `format_gt_column_proposal`,
    `laserlane_proposals.py:102-252`).

    ``inst_raw``: [H,H] ids 0..n_cls-1 with background 255 (post-remap).
    ``init_pts``/``term_pts``: [L,2] raw (row,col), zero for empty slots.

    ``emit_full_bi_seg``: build the windowed ``prop_bi_seg`` [P,H,W*ds]
    explicitly (reference layout).  With the fused seg-focal loss
    (``cfg.fused_seg_focal``) the same GT is derived ON DEVICE from the
    merged instance map ``prop_inst`` + per-proposal lane id ``prop_best``
    (`models/head_losses.py:_fused_prop_seg_focal`) — skipping a ~6.6 MB
    windowed gather per tile here and a ~6.6 MB/tile host->device upload.
    """
    S, P, pw, hb = row_size, num_prop, prop_width, half_buff
    W = pw + 2 * hb
    H = S * ds

    ext, coor, offset, offset_mask, orient = lane_line_maps(
        inst_raw, n_cls, S, ds, ori_raw, semantic)
    inst_merged = inst_raw.copy()
    if emit_full_bi_seg:
        bi_seg = np.zeros((n_cls, H, H), dtype=np.uint8)
        for c in range(n_cls):
            bi_seg[c] = inst_raw == c
    else:
        bi_seg = None

    init_pts = np.array(init_pts, dtype=np.float64).copy()
    term_pts = np.array(term_pts, dtype=np.float64).copy()
    merge_touching_lanes(ext, coor, offset, offset_mask, bi_seg,
                         init_pts, term_pts, inst=inst_merged)

    best = assign_proposals(coor, P, pw, hb)  # [P]

    # padded gathers for the per-proposal windows (reference `:198-228`)
    offset_pad = np.pad(offset, ((0, 0), (0, 0), (hb, hb)))
    offmask_pad = np.pad(offset_mask, ((0, 0), (0, 0), (hb, hb)))
    win = pw * np.arange(P)[:, None] + np.arange(W)[None, :]  # [P,W]

    gt_exist = ext[best]                                     # [P,S]
    col_base = (pw * np.arange(P) - hb)[:, None]
    gt_coors = coor[best] - col_base                         # [P,S]
    gt_offset = offset_pad[best[:, None, None],
                           np.arange(S)[None, :, None],
                           win[:, None, :]]                  # [P,S,W]
    gt_offset_mask = offmask_pad[best[:, None, None],
                                 np.arange(S)[None, :, None],
                                 win[:, None, :]]

    coor_scaled = np.where(coor > -1.0, coor * ds, coor)

    out = {
        "prop_obj": np.zeros((P, 2), np.float32),
        "prop_ext": gt_exist.astype(np.float32),
        "prop_coor": gt_coors.astype(np.float32),
        "prop_offset": gt_offset.astype(np.float32),
        "prop_offset_mask": gt_offset_mask.astype(np.float32),
        "prop_inst": inst_merged.astype(np.uint8),
        "prop_best": best.astype(np.uint8),
        "lc_orient": orient.astype(np.int32),
        "lc_coor_raw": coor_scaled.astype(np.float32),
        "semantic_label_raw": mask.astype(np.uint8),
        "endp_map": endp_map.astype(np.float32),
    }
    if emit_full_bi_seg:
        biseg_pad = np.pad(bi_seg, ((0, 0), (0, 0), (hb * ds, hb * ds)))
        win_raw = (ds * pw) * np.arange(P)[:, None] \
            + np.arange(W * ds)[None, :]
        out["prop_bi_seg"] = biseg_pad[best[:, None, None],
                                       np.arange(H)[None, :, None],
                                       win_raw[:, None, :]].astype(np.uint8)
    return out
