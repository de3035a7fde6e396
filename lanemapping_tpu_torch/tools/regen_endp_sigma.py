"""A dataset variant with its endpoint heatmaps re-rendered at a new sigma
(port of the root `tools/regen_endp_sigma.py`).

The endpoint-heatmap width is a label-generation parameter (reference
`data/convert_data.py:248-318`, sigma 2 Gaussians): sweeping it means
re-rendering ``labels/sparse_endp/*.png`` from the per-tile sparse_seq
JSONs (`data/label_gen.py::endpoint_heatmap`).  Everything else (images,
segmentation, instance and orientation labels, split file, transform
params, clouds) does not depend on sigma, so the variant root symlinks it.

    python -m lanemapping_tpu_torch.tools.regen_endp_sigma --src <root> \\
        --dst <root>_s3 --sigma 3

It runs on the host alone, as the JAX script does, and writes the same
PNGs byte for byte.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

SHARED = ("cropped_tiff", "cropped_tiff_param", "data_split-shuffle.json",
          "las", "labels/sparse_seq", "labels/sparse_semantic",
          "labels/sparse_instance", "labels/sparse_orient")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--sigma", type=float, default=3.0)
    ap.add_argument("--img", type=int, default=1152)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Writes the variant root; returns the number of endpoint maps."""
    from PIL import Image

    from ..data.label_gen import endpoint_heatmap

    args = parse_args(argv)
    os.makedirs(os.path.join(args.dst, "labels"), exist_ok=True)
    for rel in SHARED:
        src = os.path.join(args.src, rel)
        dst = os.path.join(args.dst, rel)
        if os.path.exists(src) and not os.path.exists(dst):
            os.symlink(src, dst)

    seq_dir = os.path.join(args.src, "labels", "sparse_seq")
    out_dir = os.path.join(args.dst, "labels", "sparse_endp")
    os.makedirs(out_dir, exist_ok=True)
    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(seq_dir)
                   if f.endswith(".json"))
    for i, stem in enumerate(stems):
        with open(os.path.join(seq_dir, stem + ".json")) as f:
            recs = json.load(f)
        init_pts = np.array([r["init_vertex"] for r in recs], np.float64)
        end_pts = np.array([r["end_vertex"] for r in recs], np.float64)
        if len(recs):
            hm = endpoint_heatmap(init_pts, end_pts, args.img, args.img,
                                  sigma=args.sigma)
        else:
            hm = np.zeros((args.img, args.img), np.float32)
        Image.fromarray((hm * 255.0).astype(np.uint8)).save(
            os.path.join(out_dir, stem + ".png"))
        if (i + 1) % 200 == 0:
            print(f"[regen_endp] {i + 1}/{len(stems)}", flush=True)
    print(f"[regen_endp] wrote {len(stems)} endpoint maps at sigma="
          f"{args.sigma} under {out_dir}")
    return len(stems)


if __name__ == "__main__":
    main()
