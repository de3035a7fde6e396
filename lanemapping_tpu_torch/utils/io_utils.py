"""Lane-sequence IO + BEV transform parameter parsing (a copy of
`lanemapping_tpu/utils/io_utils.py`).

Parity with the reference's `baseline/utils/io_utils.py:12-150`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..data.label_gen import NpEncoder


def save_seqs_json(seq_list: List[Dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(seq_list, f, indent=4, cls=NpEncoder)


def save_seqs_txt(seq_list: List[Dict], path: str) -> None:
    with open(path, "w") as f:
        for lane_id, rec in enumerate(seq_list):
            for v in rec["seq"]:
                f.write(" ".join(str(x) for x in v) + f" {lane_id}\n")


def save_seqs_list(lane_vertexes: List[np.ndarray], path: str) -> None:
    """Save a list of [V,D] vertex arrays (reference `save_seqs_list:28-56`)."""
    recs = []
    for v in lane_vertexes:
        if v.shape[0] < 2:
            continue
        recs.append({"seq_len": v.shape[0], "seq": v,
                     "init_vertex": v[0], "end_vertex": v[-1]})
    if os.path.splitext(path)[1] == ".txt":
        save_seqs_txt(recs, path)
    else:
        save_seqs_json(recs, path)


def save_lane_seq_2d(lane_vertexes: np.ndarray, path: str,
                     with_pervertex_semantics: bool = True) -> None:
    """Write decoded [L,V,2+] (col, sem) polylines (reference `:58-93`)."""
    recs = []
    for lane in lane_vertexes:
        v = lane[lane[:, 1] > 0] if lane.shape[1] > 1 else lane
        if v.shape[0] < 2:
            continue
        body = v if with_pervertex_semantics else v[:, :-1]
        recs.append({"seq_len": v.shape[0], "seq": body,
                     "init_vertex": body[0], "end_vertex": body[-1]})
    if os.path.splitext(path)[1] == ".txt":
        save_seqs_txt(recs, path)
    else:
        save_seqs_json(recs, path)


def load_lane_seq(path: str, dim_coor: int = 2):
    """(seqs [L,Vmax,D], lens, init_pts, end_pts) (reference `:100-123`)."""
    with open(path) as f:
        data = json.load(f)
    lens = [rec["seq_len"] for rec in data]
    init_pts = [rec["init_vertex"] for rec in data]
    end_pts = [rec["end_vertex"] for rec in data]
    if len(lens) < 2:
        return [], lens, init_pts, end_pts
    seqs = np.zeros((len(lens), max(lens), dim_coor))
    for i, rec in enumerate(data):
        if lens[i]:
            seqs[i, :lens[i]] = [v[:dim_coor] for v in rec["seq"]]
    return seqs, lens, init_pts, end_pts


def load_pc_2_img_transform_paras(path: str) -> Dict:
    """Per-tile BEV<->LiDAR transform params from the paired txt
    (reference `:125-150`): line pairs of label + values."""
    with open(path) as f:
        lines = f.read().split("\n")
    out = {
        "coor_las_path": lines[1],
        "las_read_offset": [float(x) for x in lines[3].split()],
        "las_rotation_trans_quan": [float(x) for x in lines[5].split()],
        "bev_img_offset": [float(x) for x in lines[7].split()],
        "img_reso": [float(x) for x in lines[9].split()],
        "local_min_ele": float(lines[11]),
        "ele_reso": float(lines[13]),
    }
    return out
