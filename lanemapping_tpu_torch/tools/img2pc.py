"""BEV-image polylines -> 3-D LiDAR-frame polylines (a copy of
`lanemapping_tpu/tools/img2pc.py`, with the root `tools/img2pc.py` CLI as
``main``).

    python -m lanemapping_tpu_torch.tools.img2pc <img_seq_dir> \\
        <bev_img_dir> <params_dir> [--workers 12]

Parity with the reference's `baseline/utils/coor_img2pc.py:22-263`: per-tile
scale/offset, elevation from the BEV G-channel with nearest-valid-pixel fill,
per-line least-squares elevation smoothing, inverse quaternion rotation and
the LAS read offset.  Quaternion rotation is vectorised over all vertices
(the reference rotates one vertex at a time, `:167-172`).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..utils.io_utils import (load_lane_seq, load_pc_2_img_transform_paras,
                              save_seqs_json, save_seqs_txt)

EPS = 1e-6


def quat_rotate(quan: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Rotate [N,3] vectors by quaternion [w,x,y,z] (normalised like the
    reference: v' = q * v * q^-1 with q^-1 = conj(q)/||q||, `:38-53`)."""
    quan = np.asarray(quan, dtype=np.float64)
    norm = np.sqrt(np.sum(quan ** 2))
    assert norm > EPS
    w, x, y, z = quan / norm  # Las2BEV writes unit quaternions
    # rotation matrix of the (assumed unit) quaternion
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return vecs @ R.T


def fit_line_least_squares(x: np.ndarray, y: np.ndarray):
    """w, b for y ~ w*x + b (reference `LeastSuqare:59-73`)."""
    n = len(y)
    q = n * np.sum(x * x) - np.sum(x) ** 2
    w = 0.0 if abs(q) < EPS else (n * np.sum(x * y) - np.sum(x) * np.sum(y)) / q
    b = np.sum(y - w * x) / n
    return w, b


def fill_elevation_at(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Fill empty G-channel pixels at the requested (row,col) points with the
    nearest non-empty neighbourhood mean (reference
    `modify_empty_pixel_elevation:98-122`)."""
    h, w, _ = img.shape
    occupied = img.sum(axis=2)
    for r, c in pts:
        r, c = int(r), int(c)
        if (r == 0 and c == 0) or occupied[r, c] > 1:
            continue
        step = 1
        while True:
            r0, r1 = max(r - step, 0), min(r + step, h)
            c0, c1 = max(c - step, 0), min(c + step, w)
            block = img[r0:r1, c0:c1]
            mass = block.sum()
            if mass > 0:
                n_valid = np.count_nonzero(block.sum(axis=2) > 0)
                img[r, c, 1] = block[..., 1].sum() / n_valid
                break
            step += 1
    return img


def img_seqs_to_pc(params: Dict, img_seqs: np.ndarray,
                   img_seq_lens: List[int], bev_img: np.ndarray) -> np.ndarray:
    """[L,V,2] image (row,col) -> [L,V,3] LiDAR xyz
    (reference `transform_coordinate_from_img_2_pc:127-183`)."""
    n_line, max_len, _ = img_seqs.shape
    out = np.zeros((n_line, max_len, 3))
    out[:, :, 0] = img_seqs[:, :, 0] * params["img_reso"][0] + \
        params["bev_img_offset"][0]
    out[:, :, 1] = img_seqs[:, :, 1] * params["img_reso"][1] + \
        params["bev_img_offset"][1]

    bev_img = np.array(bev_img)
    pts = np.concatenate([img_seqs[i, :img_seq_lens[i]]
                          for i in range(n_line)], axis=0)
    bev_img = fill_elevation_at(bev_img, pts)
    out[:, :, 2] = bev_img[img_seqs[:, :, 0].astype(int),
                           img_seqs[:, :, 1].astype(int), 1] * \
        params["ele_reso"] + params["local_min_ele"]

    # least-squares elevation smoothing per line (`:154-159`)
    for i in range(n_line):
        n = img_seq_lens[i]
        if n < 2:
            continue
        idx = np.arange(n, dtype=np.float64)
        w, b = fit_line_least_squares(idx, out[i, :n, 2])
        out[i, :n, 2] = w * idx + b

    # inverse rotation + translation back to the LiDAR frame (`:162-177`)
    quan_t = np.asarray(params["las_rotation_trans_quan"][0:3])
    quan = np.asarray(params["las_rotation_trans_quan"][3:])
    flat = out.reshape(-1, 3)
    flat = quat_rotate(quan, flat) + quan_t
    flat += np.asarray(params["las_read_offset"])
    return flat.reshape(n_line, max_len, 3)


def convert_tile(img_seq_path: str, bev_img_path: str, params_path: str,
                 out_json: str, out_txt: str) -> None:
    from PIL import Image

    img_seqs, lens, _, _ = load_lane_seq(img_seq_path)
    if len(img_seqs) < 1:
        return
    params = load_pc_2_img_transform_paras(params_path)
    pc = img_seqs_to_pc(params, np.asarray(img_seqs), lens,
                        Image.open(bev_img_path))
    recs = []
    for i in range(pc.shape[0]):
        v = pc[i, :lens[i]]
        recs.append({"seq": v, "seq_len": lens[i],
                     "init_vertex": v[0], "end_vertex": v[-1]})
    save_seqs_json(recs, out_json)
    save_seqs_txt(recs, out_txt)


def convert_directory(img_seq_dir: str, bev_img_dir: str, params_dir: str,
                      n_workers: int = 12) -> str:
    """Batch conversion (reference `multiprocessing_seqs_files:219-263`).

    The workers are forked, also from a process whose CUDA context is live
    (``stream_map``'s): they run NumPy and PIL only, and torch marks
    a forked child so that any CUDA call there raises rather than touching
    the parent's context."""
    from multiprocessing import Pool

    parent = os.path.dirname(img_seq_dir)
    out_json_dir = os.path.join(parent, "out_pc_seq_json_dir")
    out_txt_dir = os.path.join(parent, "out_pc_seq_txt_dir")
    os.makedirs(out_json_dir, exist_ok=True)
    os.makedirs(out_txt_dir, exist_ok=True)
    jobs = []
    for name in sorted(os.listdir(img_seq_dir)):
        stem, ext = os.path.splitext(name)
        if ext != ".json":
            continue
        jobs.append((os.path.join(img_seq_dir, name),
                     os.path.join(bev_img_dir, stem + ".png"),
                     os.path.join(params_dir, stem + ".txt"),
                     os.path.join(out_json_dir, stem + ".json"),
                     os.path.join(out_txt_dir, stem + ".txt")))
    if n_workers > 1:
        with Pool(n_workers) as p:
            p.starmap(convert_tile, jobs)
    else:
        for j in jobs:
            convert_tile(*j)
    return out_json_dir


def main(argv=None) -> str:
    import argparse

    ap = argparse.ArgumentParser(
        description="BEV-image lane seqs -> 3-D LiDAR-frame seqs")
    ap.add_argument("img_seq_dir")
    ap.add_argument("bev_img_dir")
    ap.add_argument("params_dir")
    ap.add_argument("--workers", type=int, default=12)
    args = ap.parse_args(argv)
    out = convert_directory(args.img_seq_dir, args.bev_img_dir,
                            args.params_dir, n_workers=args.workers)
    print(f"[img2pc] wrote {out}")
    return out


if __name__ == "__main__":
    main()
