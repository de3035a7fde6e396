"""Global lane-map assembly: merge per-tile 3-D polylines across tiles (a
copy of `lanemapping_tpu/tools/merge_lines.py`, with the root
`tools/merge_lines.py` CLI as ``main``).

    python -m lanemapping_tpu_torch.tools.merge_lines <seq_dir> \\
        [--downsample 0.6]

Parity with the reference's `baseline/utils/merge_lines.py:17-316`: PCA
principal direction per active sequence, projection-sorted merging of
overlapping tile polylines (forward and reversed orientation), an
active-sequence sliding window over sorted tile files, and distance-based
downsampling of the merged map.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ..utils.io_utils import load_lane_seq, save_seqs_list

EPS = 1e-6
ATTACH_DIST = 0.5     # metres: start-vertex to active-line distance
SEARCH_DIST = 10.0    # metres: candidate search radius
COS_ALIGNED = 0.7


def principal_direction(seq: np.ndarray) -> np.ndarray:
    """Dominant XY direction by PCA (reference `calculate_principal_strict`),
    sign-aligned with the start->end chord."""
    seq = np.asarray(seq, dtype=np.float64)
    centred = seq - seq.mean(axis=0)
    centred[:, 2] = 0.0
    _, vecs = np.linalg.eigh(centred.T @ centred)
    d = vecs[:, -1]
    chord = chord_direction(seq)
    if np.dot(d, chord) < 0:
        d = -d
    return d


def chord_direction(seq: np.ndarray) -> np.ndarray:
    d = (seq[-1] - seq[0]).astype(np.float64)
    d[2] = 0.0
    return d / (np.linalg.norm(d) + EPS)


def local_orientation(seq: np.ndarray) -> np.ndarray:
    """Direction of the last <=5 vertices (reference `cal_local_orient`)."""
    return chord_direction(seq[-5:] if len(seq) > 5 else seq)


def nearest_vertex(pt: np.ndarray, seq: np.ndarray,
                   perpendicular: bool = False) -> Tuple[float, int]:
    """(distance, index) of the seq vertex nearest to pt; optionally the
    perpendicular distance to the seq direction through that vertex
    (reference `calculate_neatest_dist_id:17-31`)."""
    d2 = np.sum((seq[:, :2] - pt[:2]) ** 2, axis=1)
    i = int(np.argmin(d2))
    dist = float(np.sqrt(d2[i]))
    if perpendicular:
        direction = chord_direction(seq)
        rel = np.asarray(pt, dtype=np.float64) - seq[i]
        dist = float(np.linalg.norm(np.cross(direction, rel)))
    return dist, i


def merge_forward(base: np.ndarray, new: np.ndarray) -> Tuple[np.ndarray, int]:
    """Merge a same-direction continuation into base by sorting both on the
    base principal axis (reference `merge_2_seqs:67-100`)."""
    d = principal_direction(base)
    base_t = base @ d
    new_t = new @ d
    overlap_new = np.nonzero(new_t < base_t[-1])[0]
    overlap_base = np.nonzero(base_t > new_t[0])[0]
    first_touch = int(overlap_base[0]) if len(overlap_base) else len(base)

    if len(overlap_new) == 0:
        return np.concatenate([base, new], axis=0), first_touch

    # interleave overlapping vertices by projection order, then append tail
    merged = list(base)
    merged_t = list(base_t)
    for ni in overlap_new:
        for bi in range(first_touch, len(merged)):
            if new_t[ni] < merged_t[bi]:
                merged.insert(bi, new[ni])
                merged_t.insert(bi, new_t[ni])
                break
    tail = new[overlap_new[-1] + 1:]
    return np.concatenate([np.asarray(merged), tail], axis=0) if len(tail) \
        else np.asarray(merged), first_touch


def merge_reversed(base: np.ndarray, new: np.ndarray) -> np.ndarray:
    """Merge an opposite-direction overlap: extend base by the new vertices
    projecting beyond either end (reference `merge_2_reversed_seqs:102-132`)."""
    d = principal_direction(base)
    base_t = base @ d
    new_t = new @ d
    fwd = np.nonzero(new_t > base_t[-1])[0]
    bwd = np.nonzero(new_t < base_t[0])[0]
    parts = [new[bwd]] if len(bwd) else []
    parts.append(base)
    if len(fwd):
        parts.append(new[fwd[::-1]])
    return np.concatenate(parts, axis=0)


def downsample_seq(seq: np.ndarray, dist_min: float = 0.6) -> np.ndarray:
    """Keep vertices at least ``dist_min`` apart along XY
    (reference `downsample_seqs:133-153`)."""
    if len(seq) == 0:
        return seq
    keep = [0]
    acc = 0.0
    deltas = np.diff(seq[:, :2], axis=0)
    steps = np.sqrt((deltas ** 2).sum(axis=1))
    for i, s in enumerate(steps, start=1):
        acc += s
        if acc > dist_min:
            keep.append(i)
            acc = 0.0
    if keep[-1] != len(seq) - 1 and acc > 0.05:
        keep.append(len(seq) - 1)
    return seq[keep]


def merge_tile_files(seq_filenames: List[str]) -> List[np.ndarray]:
    """Sliding-window merge over sorted tile files
    (reference `merge_lines:166-291`)."""
    files = sorted(seq_filenames)
    merged: List[np.ndarray] = []

    seqs0, lens0, _, _ = load_lane_seq(files[0], dim_coor=3)
    active = [np.asarray(s[:lens0[i]]) for i, s in enumerate(seqs0)]
    active_roi = [0] * len(active)
    active_orient = [local_orientation(s) for s in active]

    for fname in files[1:]:
        seqs, lens, init_pts, _ = load_lane_seq(fname, dim_coor=3)
        if len(seqs) == 0:
            continue
        tiles = [np.asarray(s[:lens[i]]) for i, s in enumerate(seqs)]
        touched = [False] * len(active)

        for ti, ts in enumerate(tiles):
            t_orient = local_orientation(ts)
            best_i, best_d = -1, SEARCH_DIST
            start = np.asarray(init_pts[ti], dtype=np.float64)
            for ai, a in enumerate(active):
                d, _ = nearest_vertex(start, a[active_roi[ai]:],
                                      perpendicular=True)
                if d < best_d:
                    best_i, best_d = ai, d

            attached = False
            if best_i >= 0 and best_d < ATTACH_DIST:
                cosang = float(t_orient @ active_orient[best_i])
                end_d, _ = nearest_vertex(active[best_i][-1], ts,
                                          perpendicular=True)
                if end_d < ATTACH_DIST and cosang > COS_ALIGNED:
                    roi = active_roi[best_i]
                    body, touch = merge_forward(active[best_i][roi:], ts)
                    active[best_i] = np.concatenate(
                        [active[best_i][:roi], body], axis=0)
                    active_roi[best_i] += touch
                    attached = True
                elif end_d < ATTACH_DIST and cosang < -COS_ALIGNED:
                    active[best_i] = merge_reversed(active[best_i], ts)
                    attached = True
                if attached:
                    active_orient[best_i] = local_orientation(active[best_i])
                    touched[best_i] = True

            if not attached:  # open a new active sequence
                active.append(ts)
                active_roi.append(0)
                active_orient.append(t_orient)
                touched.append(True)

        # retire sequences no tile touched this round
        for i in range(len(touched) - 1, -1, -1):
            if not touched[i]:
                seq = active.pop(i)
                active_roi.pop(i)
                active_orient.pop(i)
                if len(seq) >= 3:
                    merged.append(seq)

    merged.extend(s for s in active if len(s) >= 3)
    return merged


def merge_directory(seq_dir: str, downsample: float = 0.6) -> Tuple[str, str]:
    """Merge every tile's 3-D lanes under ``seq_dir`` into ``merged.txt``
    and ``merged_downsample.txt`` there; returns both paths (reference
    `__main__:293-316`)."""
    files = [os.path.join(seq_dir, f) for f in os.listdir(seq_dir)
             if f.endswith(".json")
             and os.stat(os.path.join(seq_dir, f)).st_size > 0]
    merged = merge_tile_files(files)
    down = [downsample_seq(s, downsample) for s in merged]
    p1 = os.path.join(seq_dir, "merged.txt")
    p2 = os.path.join(seq_dir, "merged_downsample.txt")
    save_seqs_list(merged, p1)
    save_seqs_list(down, p2)
    return p1, p2


def main(argv=None) -> Tuple[str, str]:
    import argparse

    ap = argparse.ArgumentParser(
        description="Merge per-tile 3-D lane seqs into a global map")
    ap.add_argument("seq_dir", help="out_pc_seq_json_dir from img2pc")
    ap.add_argument("--downsample", type=float, default=0.6)
    args = ap.parse_args(argv)
    p1, p2 = merge_directory(args.seq_dir, args.downsample)
    print(f"[merge_lines] wrote {p1} and {p2}")
    return p1, p2


if __name__ == "__main__":
    main()
