"""The port's 3-D lane map against the JAX package on the CPU: the BEV ->
LiDAR lift (`tools/img2pc.py`), the global merge (`tools/merge_lines.py`)
and the lane-sequence IO (`utils/io_utils.py`) write byte-identical files
on a synthetic LaserLane root with transform params; and the lift runs
end to end behind ``LaneMapper.map_directory(params_dir=...)`` and
``stream_map --params-dir`` at ``configs/tiny_test.py``.

The 2-D input of the parity tests is the dataset's own ground-truth lane
seqs (``labels/sparse_seq``), so no random-weight model decides whether
lanes exist.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
from torch_port_helpers import TINY, wire_data_root

N_TILES = 6


@pytest.fixture(scope="module")
def params_root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("synth3d"))
    generate_dataset(root, n_tiles=N_TILES, img=192, seed=21,
                     with_params=True)
    return root


def gt_lanes(root, dst):
    """The dataset's ground-truth lane seqs as a lanes directory."""
    shutil.copytree(os.path.join(root, "labels", "sparse_seq"), dst)
    return dst


def assert_same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n
    return names


def assert_lifted(pc_dir):
    """Every lifted vertex 3-D and finite; (files, lanes, vertices)."""
    files = [f for f in os.listdir(pc_dir) if f.endswith(".json")
             and not f.startswith("merged")]
    lanes = verts = 0
    for f in files:
        with open(os.path.join(pc_dir, f)) as fh:
            for r in json.load(fh):
                seq = np.asarray(r["seq"], np.float64)
                assert seq.ndim == 2 and seq.shape[1] == 3
                assert np.isfinite(seq).all() and r["seq_len"] == len(seq)
                lanes += 1
                verts += len(seq)
    return files, lanes, verts


def test_lift_and_merge_match_jax_byte_for_byte(params_root, tmp_path):
    from lanemapping_tpu.tools.img2pc import convert_directory as j_convert
    from lanemapping_tpu.tools.merge_lines import merge_directory as j_merge
    from lanemapping_tpu_torch.tools.img2pc import convert_directory
    from lanemapping_tpu_torch.tools.merge_lines import merge_directory

    bev = os.path.join(params_root, "cropped_tiff")
    params = os.path.join(params_root, "cropped_tiff_param")
    out = {}
    for name, convert, merge in (("jax", j_convert, j_merge),
                                 ("port", convert_directory,
                                  merge_directory)):
        lanes = gt_lanes(params_root, str(tmp_path / name / "lanes_2d"))
        pc_dir = convert(lanes, bev, params, n_workers=1)
        txt_dir = os.path.join(os.path.dirname(pc_dir), "out_pc_seq_txt_dir")
        merged, down = merge(pc_dir)
        out[name] = (pc_dir, txt_dir, merged, down)
    (jpc, jtxt, jm, jd), (pc, txt, m, d) = out["jax"], out["port"]
    names = assert_same_tree(jpc, pc)  # 3-D JSONs and the merged maps
    assert_same_tree(jtxt, txt)
    assert {"merged.txt", "merged_downsample.txt"} <= set(names)
    assert os.path.basename(m) == "merged.txt" and filecmp.cmp(jm, m, False)
    assert filecmp.cmp(jd, d, shallow=False)
    files, lanes, verts = assert_lifted(pc)
    assert len(files) == N_TILES and lanes >= 2 * N_TILES
    assert os.path.getsize(m) > 0 and os.path.getsize(d) > 0


def test_worker_pool_lift_equals_serial(params_root, tmp_path):
    """The forked worker pool of the streaming tools writes what a
    serial lift writes."""
    from lanemapping_tpu_torch.tools.img2pc import convert_directory

    bev = os.path.join(params_root, "cropped_tiff")
    params = os.path.join(params_root, "cropped_tiff_param")
    dirs = [convert_directory(gt_lanes(params_root,
                                       str(tmp_path / str(n) / "lanes_2d")),
                              bev, params, n_workers=n) for n in (1, 3)]
    assert len(assert_same_tree(*dirs)) == N_TILES


def test_io_utils_match_jax(params_root, tmp_path):
    import lanemapping_tpu.utils.io_utils as jio
    import lanemapping_tpu_torch.utils.io_utils as tio

    stem = sorted(os.listdir(os.path.join(params_root, "cropped_tiff")))[0]
    stem = os.path.splitext(stem)[0]
    ppath = os.path.join(params_root, "cropped_tiff_param", stem + ".txt")
    assert tio.load_pc_2_img_transform_paras(ppath) == \
        jio.load_pc_2_img_transform_paras(ppath)
    seq_path = os.path.join(params_root, "labels", "sparse_seq",
                            stem + ".json")
    jl, tl = jio.load_lane_seq(seq_path), tio.load_lane_seq(seq_path)
    np.testing.assert_array_equal(np.asarray(tl[0]), np.asarray(jl[0]))
    assert tl[1:] == jl[1:]

    rng = np.random.RandomState(0)
    lanes = rng.uniform(0, 192, (4, 9, 3))
    lanes[1, 5:] = 0.0  # a lane whose tail is dropped (column <= 0)
    lanes[2, 1:, 1] = 0.0  # a lane left with one vertex: skipped
    for ext in (".json", ".txt"):
        for mod in (jio, tio):
            d = tmp_path / mod.__name__.split(".")[0]
            d.mkdir(exist_ok=True)
            mod.save_lane_seq_2d(lanes, str(d / f"lanes{ext}"))
            mod.save_seqs_list(list(lanes), str(d / f"list{ext}"))
    assert len(assert_same_tree(tmp_path / "lanemapping_tpu",
                                tmp_path / "lanemapping_tpu_torch")) == 4


@pytest.fixture(scope="module")
def tiny_lanes(params_root, tmp_path_factory):
    """``LaneMapper.map_directory(params_dir=...)`` of the port on the CPU
    at the tiny config: its output directory."""
    import lanemapping_tpu_torch as lmt

    cfg = wire_data_root(lmt.Config.fromfile(TINY), params_root)
    out = str(tmp_path_factory.mktemp("map"))
    mapper = lmt.LaneMapper(cfg, device="cpu",
                            log_dir=os.path.join(out, "log"))
    lanes = mapper.map_directory(
        params_root, out, params_dir=os.path.join(params_root,
                                                  "cropped_tiff_param"))
    assert lanes == os.path.join(out, "lanes_2d")
    return out


def test_map_directory_lifts_and_merges(params_root, tiny_lanes, tmp_path):
    """The mapper's 3-D files are the serial lift of its own 2-D lanes, by
    the JAX functions; exported names match the tile and param stems."""
    from lanemapping_tpu.tools.img2pc import convert_directory
    from lanemapping_tpu.tools.merge_lines import merge_directory

    lanes_2d = os.path.join(tiny_lanes, "lanes_2d")
    stems = {os.path.splitext(f)[0]
             for f in os.listdir(os.path.join(params_root, "cropped_tiff"))}
    assert {os.path.splitext(f)[0] for f in os.listdir(lanes_2d)} == stems
    pc_dir = os.path.join(tiny_lanes, "out_pc_seq_json_dir")
    files, lanes, _ = assert_lifted(pc_dir)
    assert files and lanes >= 2 * len(files)
    ref = convert_directory(shutil.copytree(lanes_2d,
                                            str(tmp_path / "lanes_2d")),
                            os.path.join(params_root, "cropped_tiff"),
                            os.path.join(params_root, "cropped_tiff_param"),
                            n_workers=1)
    merge_directory(ref)
    assert_same_tree(ref, pc_dir)
    for f in ("merged.txt", "merged_downsample.txt"):
        assert os.path.getsize(os.path.join(pc_dir, f)) > 0


def test_stream_map_params_dir(params_root, tiny_lanes, tmp_path):
    """``stream_map --params-dir`` lifts and merges what it streamed and
    returns the merged map's paths; its lanes and 3-D files equal the
    mapper's on the same weights."""
    from lanemapping_tpu_torch.tools import stream_map

    rec = stream_map.main([TINY, params_root, "--split", "all", "--device",
                           "cpu", "--out", str(tmp_path),
                           "--params-dir",
                           os.path.join(params_root, "cropped_tiff_param")])
    assert rec["n_tiles"] == N_TILES
    assert rec["pc_dir"] == str(tmp_path / "out_pc_seq_json_dir")
    assert rec["merged_map"] == os.path.join(rec["pc_dir"], "merged.txt")
    assert os.path.getsize(rec["merged_downsample"]) > 0
    assert_same_tree(os.path.join(tiny_lanes, "lanes_2d"), rec["lanes_dir"])
    assert_same_tree(os.path.join(tiny_lanes, "out_pc_seq_json_dir"),
                     rec["pc_dir"])


def test_stream_map_without_params_dir_stops_at_2d(params_root, tmp_path):
    from lanemapping_tpu_torch.tools import stream_map

    rec = stream_map.main([TINY, params_root, "--split", "infer_only",
                           "--device", "cpu", "--out", str(tmp_path),
                           "--params-dir", str(tmp_path / "absent")])
    assert "merged_map" not in rec
    assert os.listdir(tmp_path) == ["lanes_2d"]


def test_convert_data_cli_matches_jax_label_gen(tmp_path):
    """The port's ``convert_data`` CLI writes the JAX package's sparse
    label set, byte for byte, from one dense annotation JSON."""
    from lanemapping_tpu.data.label_gen import convert_annotation_file
    from lanemapping_tpu_torch.data.synthetic import random_lane_seqs
    from lanemapping_tpu_torch.tools import convert_data

    rng = np.random.RandomState(4)
    seqs = random_lane_seqs(rng, img=1152, n_lanes=5)
    ann = [{"semantic": int(rng.randint(1, 3)),
            "seq": np.asarray(s).tolist()} for s in seqs]
    for d in ("jax", "port"):
        (tmp_path / d / "annotation_seq").mkdir(parents=True)
        with open(tmp_path / d / "annotation_seq" / "t0.json", "w") as f:
            json.dump(ann, f)
    convert_annotation_file(str(tmp_path / "jax" / "annotation_seq" /
                                "t0.json"), str(tmp_path / "jax"))
    convert_data.main([str(tmp_path / "port" / "annotation_seq"),
                       "--workers", "1"])
    subdirs = sorted(os.listdir(tmp_path / "jax"))
    assert len(subdirs) > 1
    for sub in subdirs:
        assert_same_tree(tmp_path / "jax" / sub, tmp_path / "port" / sub)
