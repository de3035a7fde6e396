"""Segmentor inference: thresholded semantic map and endpoint peaks on the
device, display maps on the host (port of
`lanemapping_tpu/decode/seg_infer.py`; reference
`pcencoder/postprojector.py:115-183,221-261` ``infer_validate`` and
``get_pred_seg_endp_displays``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .lane_decode import decode_endpoints


def segmentor_displays(proj, seg, endp=None):
    """Overlay maps for the Segmentor export driver: the grayscale source
    tile with (a) the per-class segmentation and (b) its dilated skeleton
    drawn on top, plus endpoint markers on (a) when ``endp`` is given.

    ``proj`` [H,W,3] float, ``seg`` [H,W] in {0,1,2}, ``endp`` optional
    [H,W] binary; numpy.  Returns (seg_rgb, skel_rgb) uint8 arrays."""
    from ..utils.skeleton import skeletonize
    from ..utils.vis_utils import draw_endpoints, draw_seg_points, \
        to_gray_rgb

    base = to_gray_rgb(np.asarray(proj))
    seg_img = base.copy()
    skel_img = base.copy()
    seg = np.asarray(seg)
    for sid in (1, 2):
        coords = np.argwhere(seg == sid)
        if not len(coords):
            continue
        draw_seg_points(seg_img, coords, semantic_id=sid)
        skel = skeletonize((seg == sid).astype(np.uint8))
        # 1x3 rectangular dilation (reference `:241-243`)
        skel = skel | np.pad(skel, ((0, 0), (1, 0)))[:, :-1] \
            | np.pad(skel, ((0, 0), (0, 1)))[:, 1:]
        draw_seg_points(skel_img, np.argwhere(skel > 0), semantic_id=sid)
    if endp is not None:
        draw_endpoints(seg_img, np.argwhere(np.asarray(endp) > 0))
    return (seg_img.clip(0, 255).astype(np.uint8),
            skel_img.clip(0, 255).astype(np.uint8))


def segmentor_infer(out: Dict, seg_thre: float = 0.1,
                    n_lanes: int = 12) -> Dict:
    """NHWC ``semantic_seg`` / ``endp_est`` logits -> ``seg`` [B,H,W] in
    {0,1,2} and the binary endpoint map ``endp`` [B,H,W].  The threshold
    applies to the raw channel scores, not a softmax, as the reference
    does; endpoint representatives land in the map by a max-scatter, since
    two may share a pixel."""
    p = out["semantic_seg"].float()
    p1, p2 = p[..., 1], p[..., 2]
    zero = torch.zeros((), dtype=torch.long, device=p.device)
    seg = torch.where((p1 > p2) & (p1 > seg_thre), zero + 1,
                      torch.where((p2 > p1) & (p2 > seg_thre), zero + 2,
                                  zero))
    coords, valid = decode_endpoints(out["endp_est"][..., 0],
                                     num_cls=n_lanes, top_k=100)
    B, H, W = seg.shape
    hh = torch.clamp(coords[..., 0].long(), 0, H - 1)
    ww = torch.clamp(coords[..., 1].long(), 0, W - 1)
    endp = torch.zeros(B, H * W, device=p.device).scatter_reduce_(
        1, hh * W + ww, valid.float(), "amax")
    return {"seg": seg, "endp": endp.view(B, H, W)}
