"""Offline label generation CLI (port of the root `tools/convert_data.py`,
reference `data/convert_data.py:440-478`): dense annotation_seq JSONs ->
the sparse label set (``sparse_{seq,semantic,instance,orient,endp}``)
beside the JSON directory, by `data/label_gen.py::convert_annotation_file`.

    python -m lanemapping_tpu_torch.tools.convert_data <seq_dir> \\
        [--top-k 20] [--col-range 100 1000] [--workers 12]
"""

from __future__ import annotations

import argparse
import os
from multiprocessing import Pool


def main(argv=None) -> str:
    from ..data.label_gen import convert_annotation_file

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seq_dir", help="directory of dense annotation_seq JSONs")
    ap.add_argument("--top-k", type=int, default=20)
    ap.add_argument("--col-range", type=int, nargs=2, default=(100, 1000))
    ap.add_argument("--workers", type=int, default=12)
    args = ap.parse_args(argv)

    out_root = os.path.dirname(os.path.abspath(args.seq_dir))
    files = [os.path.join(args.seq_dir, f)
             for f in sorted(os.listdir(args.seq_dir))
             if f.endswith(".json")
             and os.stat(os.path.join(args.seq_dir, f)).st_size > 0]
    print(f"[convert_data] {len(files)} files -> {out_root}")
    jobs = [(f, out_root, args.top_k, tuple(args.col_range)) for f in files]
    if args.workers > 1:
        with Pool(args.workers) as p:
            p.starmap(convert_annotation_file, jobs)
    else:
        for job in jobs:
            convert_annotation_file(*job)
    print("[convert_data] done")
    return out_root


if __name__ == "__main__":
    main()
