"""KLane row-head decode: per-lane argmax maps on the device, lane-map
assembly on the host (port of `lanemapping_tpu/decode/row_decode.py`;
reference `heads/row_shared_not_reduc_ref.py:334-393,440-546`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def decode_row_lanes(out: Dict, n_lanes: int) -> Dict:
    """``out['ext2']`` [B,N,S,2], ``out['cls2']`` [B,N,S,S] (softmax
    probabilities) -> ``conf`` [B,S,S] and the existence-masked per-lane
    one-hot maps plus their any-lane map, ``cls`` [B,N+1,S,S]."""
    del n_lanes  # the lane axis of ``cls2``
    ext = torch.argmax(out["ext2"], dim=-1)  # 0 = lane exists (`:351`)
    corr = torch.argmax(out["cls2"], dim=-1)  # [B,N,S]
    S = out["cls2"].shape[-1]
    onehot = F.one_hot(corr, S).to(out["cls2"].dtype)
    cls_maps = onehot * (ext == 0)[..., None].to(onehot.dtype)
    bg = torch.amax(cls_maps, dim=1, keepdim=True)  # any-lane map
    return {"conf": bg[:, 0], "cls": torch.cat([cls_maps, bg], dim=1)}


def row_lane_maps(pred: Dict, cfg, head_type: str) -> Dict:
    """Lane-map assembly for the KLane grid heads (NumPy, host side).

    The reference's per-lane vertex extraction and greedy smoothing with
    an all-vertical orientation prior (`:505-521`: ``pred_lines[line_id,
    row] = col / 144 * 1152 + 4``, then ``smooth_cls_line_per_batch(...,
    orient_map=5, complete_inner_nodes=True)``), emitting the shared
    ``cls_offset_smooth`` [B, N, S, 2] (column, semantic) contract of
    `lane_records` and `render_lane_overlays`; KLane heads carry no
    per-vertex semantics, so vertices export as solid (1).  GridSeg's loss
    flips both label axes (`models/row_head.py::grid_seg_loss`), so its
    maps are flipped back here; the row head trains unflipped.

    ``pred``: for RowSharNotReducRef the `decode_row_lanes` output (``cls``
    [B,N+1,S,S]); for GridSeg the raw head output (``conf`` [B,S,S]
    sigmoid, ``cls`` [B,S,S,C] logits); numpy arrays.
    """
    from .postprocess import smooth_lanes

    if head_type == "GridSeg":
        conf = np.asarray(pred["conf"])[:, ::-1, ::-1]
        cls_logits = np.asarray(pred["cls"])[:, ::-1, ::-1]
        n_lanes = cls_logits.shape[-1] - 1  # the last class is background
        cls_idx = np.argmax(cls_logits, axis=-1)
        lane_px = (cls_idx < n_lanes) & (conf > cfg.get("conf_thr", 0.3))
        cls_idx = np.where(lane_px, cls_idx, 255)
    else:  # RowSharNotReducRef
        cls_maps = np.asarray(pred["cls"])  # [B, N+1, S, S]
        n_lanes = cls_maps.shape[1] - 1
        lane_px = cls_maps[:, :n_lanes].max(axis=1) > 0.5
        cls_idx = np.where(lane_px, np.argmax(cls_maps[:, :n_lanes], axis=1),
                           255)

    B, S = cls_idx.shape[0], cls_idx.shape[1]
    orient_vertical = np.full((S, S), 5.0)
    smooth, idx_maps = [], []
    for b in range(B):
        pred_lines = np.full((n_lanes, S), -1.0)
        rows, cols = np.nonzero(cls_idx[b] != 255)
        # reference `:507-509`: col / row_size * 1152 + 4; of several
        # pixels of one lane in a row the last wins, as numpy assigns
        pred_lines[cls_idx[b, rows, cols], rows] = cols / S * 1152.0 + 4.0
        ply = smooth_lanes(pred_lines, orient_vertical,
                           complete_inner_nodes=True)
        smooth.append(np.stack([ply, np.where(ply > 0, 1.0, 0.0)], axis=-1))
        idx_maps.append(cls_idx[b])
    return {"cls_offset_smooth": np.stack(smooth),
            "cls_idx": np.stack(idx_maps)}
