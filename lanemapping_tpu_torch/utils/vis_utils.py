"""Visualization overlays: lanes/semantics/endpoints/segmentation on BEV
(a copy of `lanemapping_tpu/utils/vis_utils.py`; NumPy, with ``cv2``
imported only inside the drawing functions).

Parity with `/root/reference/baseline/utils/vis_utils.py:20-120` (cv2
overlays, HSL color ramps).  Colors follow the lane-id palette from the
shipped configs (`configs/Proj_polyline_fpn_vit_vertex_2.py:102-115`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

SOLID_COLOR = (255, 0, 0)
DASHED_COLOR = (0, 0, 255)

CLS_LANE_COLORS = [
    (0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 255, 255), (255, 0, 255),
    (255, 255, 0), (42, 42, 128), (158, 168, 3), (240, 32, 160),
    (84, 46, 8), (255, 97, 0), (100, 255, 0),
]


def _cv2():
    import cv2
    return cv2


def to_gray_rgb(proj: np.ndarray) -> np.ndarray:
    """[H,W,3] float BEV tile -> uint8-range grayscale RGB canvas
    (reference `polyline_fpn_vit_vertex_2.py:956-959`)."""
    g = proj.mean(axis=-1, keepdims=True)
    return np.repeat(g, 3, axis=-1) * 255.0


def draw_seg_points(canvas: np.ndarray, coords: np.ndarray,
                    semantic_id: Optional[int] = None) -> np.ndarray:
    color = {1: SOLID_COLOR, 2: DASHED_COLOR}.get(semantic_id,
                                                  (255, 255, 255))
    coords = np.asarray(coords)
    if coords.size:
        canvas[coords[:, 0].astype(int), coords[:, 1].astype(int)] = color
    return canvas


def draw_lane(canvas: np.ndarray, lane_coors: np.ndarray, lane_id: int = 0,
              color=None, thickness: int = 2) -> np.ndarray:
    """Polyline overlay; lane_coors [V,2] (row, col)."""
    cv2 = _cv2()
    if color is None:
        color = CLS_LANE_COLORS[lane_id % len(CLS_LANE_COLORS)]
    pts = np.asarray(lane_coors)
    for a, b in zip(pts[:-1], pts[1:]):
        cv2.line(canvas, (int(a[1]), int(a[0])), (int(b[1]), int(b[0])),
                 color=color, thickness=thickness)
    return canvas


def draw_semantic_lane(canvas: np.ndarray, lane_coors: np.ndarray,
                       semantic_id: int, thickness: int = 2) -> np.ndarray:
    """Semantic-coloured overlay; segments with a row jump > 40 px are
    skipped (reference `:63-64`)."""
    cv2 = _cv2()
    color = SOLID_COLOR if semantic_id == 1 else (
        DASHED_COLOR if semantic_id == 2 else (255, 255, 255))
    pts = np.asarray(lane_coors)
    for a, b in zip(pts[:-1], pts[1:]):
        if abs(a[0] - b[0]) > 40:
            continue
        cv2.line(canvas, (int(a[1]), int(a[0])), (int(b[1]), int(b[0])),
                 color=color, thickness=thickness)
    return canvas


def draw_endpoints(canvas: np.ndarray, endp_coors: np.ndarray,
                   color=(0, 0, 250), radius: int = 7,
                   filled: bool = False) -> np.ndarray:
    cv2 = _cv2()
    for r, c in np.asarray(endp_coors).reshape(-1, 2):
        cv2.circle(canvas, (int(c), int(r)), radius=radius, color=color,
                   thickness=cv2.FILLED if filled else 1)
    return canvas


def rgb_cls_map(cls_idx: np.ndarray) -> np.ndarray:
    """Per-lane-id RGB rendering of a grid class map (reference
    `row_shared_not_reduc_ref.py:735-744` ``get_rgb_img_from_cls_map``,
    vectorised; 255 = background = black)."""
    cls_idx = np.asarray(cls_idx)
    palette = np.array(CLS_LANE_COLORS, dtype=np.uint8)
    lane = cls_idx != 255
    out = np.zeros(cls_idx.shape + (3,), dtype=np.uint8)
    out[lane] = palette[cls_idx[lane] % len(palette)]
    return out


def render_lane_overlays(proj: np.ndarray, ply: np.ndarray,
                         endp_map: Optional[np.ndarray] = None) -> np.ndarray:
    """One-call overlay of final decoded polylines + endpoints on a tile."""
    canvas = to_gray_rgb(proj).astype(np.float32)
    for li in range(len(ply)):
        rows = np.nonzero(ply[li, :, 0] > 0)[0]
        if len(rows) < 2:
            continue
        coors = np.stack([rows * 8 + 3, ply[li, rows, 0]], axis=1)
        draw_lane(canvas, coors, lane_id=li)
        sem = int(np.round(ply[li, rows, 1].max()))
        draw_semantic_lane(canvas, coors, sem)
    if endp_map is not None:
        draw_endpoints(canvas, np.argwhere(endp_map > 0), filled=True,
                       radius=5)
    return canvas.clip(0, 255).astype(np.uint8)


# ---- HSL colour ramps (reference `:96-120`) -------------------------------

def rgb2hsl(rgb: Sequence[int]) -> Tuple[float, float, float]:
    cv2 = _cv2()
    arr = np.array([[[c / 255 for c in rgb]]], np.float32)
    h, l, s = cv2.cvtColor(arr, cv2.COLOR_RGB2HLS)[0][0]
    return h, s, l


def hsl2rgb(hsl: Sequence[float]) -> Tuple[int, int, int]:
    cv2 = _cv2()
    arr = np.array([[[hsl[0], hsl[2], hsl[1]]]], np.float32)
    rgb = cv2.cvtColor(arr, cv2.COLOR_HLS2RGB)[0][0]
    return tuple(int(c * 255) for c in rgb)


def color_ramp(begin_rgb, end_rgb, count: int) -> List[Tuple[int, int, int]]:
    if count < 2:
        return []
    a, b = rgb2hsl(begin_rgb), rgb2hsl(end_rgb)
    step = [(b[i] - a[i]) / (count - 1) for i in range(3)]
    return [hsl2rgb([a[i] + step[i] * k for i in range(3)])
            for k in range(count)]


def _draw_lane_set(canvas: np.ndarray, coors_px: np.ndarray,
                   semantic: Optional[np.ndarray] = None) -> np.ndarray:
    """Draw every lane of a [P,S] column array (image scale, -1 = none) on
    ``canvas``; per-lane palette colors, or solid/dashed colors when
    ``semantic`` [P,S] is given."""
    n_lane, n_v = coors_px.shape
    anchors = np.arange(n_v) * 8 + 3
    for li in range(n_lane):
        rows = np.nonzero(coors_px[li] > 0)[0]
        if len(rows) < 2:
            continue
        pts = np.stack([anchors[rows], coors_px[li, rows]], axis=1)
        if semantic is None:
            draw_lane(canvas, pts, lane_id=li)
        else:
            for sid in (1, 2):
                sel = semantic[li, rows] == sid
                if np.count_nonzero(sel) >= 2:
                    draw_semantic_lane(canvas, pts[sel], sid)
    return canvas


def get_lane_map_on_source_image(maps, batch, cfg, dec=None):
    """Rich per-batch visualization dict (reference
    `polyline_fpn_vit_vertex_2.py:926-1083` get_lane_map_on_source_image):

      'source_img_gray'           grayscale source tiles
      'gt_on_img'                 GT polylines on the source (when GT avail)
      'pred_smooth_lane_vertex'   [P,S,3] (row, col, semantic) arrays
      'pred_bi_seg_on_image'      semantic-coloured smoothed lanes
      'pred_offset_lanes_on_image' per-lane-coloured smoothed lanes
    and with ``cfg.view_detail``: 'pred_lanes_on_image',
    'pred_org_lanes_on_image' (raw argmax coords), 'pred_smooth_lanes_on_image'
    (argmax + tracker), 'pred_exp_lanes_on_image' (expectation + tracker).

    ``maps`` is `lane_maps_from_decode` output; ``dec`` the decode dict
    (needed only for the raw-coordinate view_detail variant).
    """
    out = {"source_img_gray": [], "gt_on_img": [],
           "pred_smooth_lane_vertex": [], "pred_bi_seg_on_image": [],
           "pred_offset_lanes_on_image": []}
    view_detail = bool(cfg.get("view_detail", False))
    if view_detail:
        out.update({"pred_lanes_on_image": [],
                    "pred_org_lanes_on_image": [],
                    "pred_smooth_lanes_on_image": [],
                    "pred_exp_lanes_on_image": []})
    img = cfg.list_img_size_xy[0]
    row_size = cfg.heads.row_size
    B = len(maps["cls_offset_smooth"])
    for b in range(B):
        base = to_gray_rgb(np.asarray(batch["proj"][b])).astype(np.float32)
        out["source_img_gray"].append(base.clip(0, 255).astype(np.uint8))

        ply = maps["cls_offset_smooth"][b]  # [P,S,2] (col, semantic)
        n_lane, n_v = ply.shape[:2]
        vertex = np.zeros((n_lane, n_v, 3))
        vertex[:, :, 0] = np.arange(n_v) * 8 + 3
        vertex[:, :, 1] = ply[:, :, 0]
        vertex[:, :, 2] = ply[:, :, 1]
        out["pred_smooth_lane_vertex"].append(vertex)

        out["pred_bi_seg_on_image"].append(_draw_lane_set(
            base.copy(), ply[:, :, 0],
            semantic=ply[:, :, 1]).clip(0, 255).astype(np.uint8))
        out["pred_offset_lanes_on_image"].append(_draw_lane_set(
            base.copy(), ply[:, :, 0]).clip(0, 255).astype(np.uint8))

        if "lc_coor_raw" in batch:
            gt = np.asarray(batch["lc_coor_raw"][b], np.float64)
            out["gt_on_img"].append(_draw_lane_set(
                base.copy(), gt).clip(0, 255).astype(np.uint8))

        if view_detail:
            out["pred_lanes_on_image"].append(
                base.clip(0, 255).astype(np.uint8))
            if dec is not None:
                # raw argmax coords carry the +4 half-stride (reference
                # `:821-825`)
                raw = np.asarray(dec["cls"][b], np.float64) \
                    / row_size * img + 4.0
                raw = np.clip(raw, -1.0, img - 1.0)
                out["pred_org_lanes_on_image"].append(_draw_lane_set(
                    base.copy(), raw).clip(0, 255).astype(np.uint8))
            for key, out_key in (("cls_coor_pred_smooth",
                                  "pred_smooth_lanes_on_image"),
                                 ("cls_exp_smooth",
                                  "pred_exp_lanes_on_image")):
                if key in maps:
                    out[out_key].append(_draw_lane_set(
                        base.copy(),
                        maps[key][b]).clip(0, 255).astype(np.uint8))
    return out
