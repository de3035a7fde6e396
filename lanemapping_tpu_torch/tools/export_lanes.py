"""Per-tile lane-seq JSON export (port of
`lanemapping_tpu/tools/export_lanes.py`; it feeds the offline
global-mapping tools).

Parity with the reference's ``write_lane_vertex`` path
(`baseline/engine/runner.py:823-828`, `baseline/utils/io_utils.py:58-93`):
one JSON per tile with per-vertex (row, col, semantic) records.
"""

from __future__ import annotations

import numpy as np


def lane_records(ply: np.ndarray, row_anchor_stride: int = 8,
                 row_anchor_offset: int = 3):
    """[P,S,2] (col, semantic) -> list of lane dicts with 3-D-liftable verts."""
    recs = []
    for li in range(len(ply)):
        rows = np.nonzero(ply[li, :, 0] > 0)[0]
        if len(rows) < 2:
            continue
        verts = [[int(r * row_anchor_stride + row_anchor_offset),
                  float(ply[li, r, 0]), int(ply[li, r, 1])] for r in rows]
        recs.append({
            "lane_id": int(li),
            "seq_len": len(verts),
            "init_vertex": verts[0][:2],
            "end_vertex": verts[-1][:2],
            "seq": verts,
        })
    return recs


def export_lane_seqs(runner, loader, out_dir: str, max_batches=None):
    """One lane JSON per tile of ``loader`` under ``out_dir`` (JAX
    `export_lanes.py:38-57`): the Runner's forward and decode
    (``Runner._eval_decode``), then the host postprocess, as
    ``Runner.infer_and_export`` runs them."""
    runner.infer_and_export(loader, out_dir, max_batches=max_batches)
