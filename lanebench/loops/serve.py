"""Offline batch mapping: raw survey clouds -> lane JSONs, as a survey team
runs it, for ``--seconds``.

Set-up draws the traffic mix's clouds from the seed, writes them as the
``.las`` files the program's ``LasTiles`` reads, draws the served model's
weights from the configuration's ``seed`` (a deployment serves one model,
and random weights set the host post-process's load), and runs the mix's
warm-up batches through the whole path.

The loop is a frozen copy of the program's streaming loop
(`lanemapping_tpu_torch/tools/stream_map.py::main`), in its order, over the
program's stage functions: the program's ``Loader`` (8 threads, prefetch 3)
cycles over the clouds; each batch is uploaded, turned into the network
input (K1 rasterize and hole fill), run through the forward and the device
decode, then read back and post-processed (tracker, NMS, semantics, lane
JSON) on a pool of ``workers`` threads.  The loop is closed: no more
batches wait for the post-process than there are workers.  A tile counts
when its JSON is written inside the window; the drain after it is not
timed.

Spans: the host's wait on the loader, CUDA events around upload, binning,
forward and decode, the host time of each batch's post-process on its
worker (readback included).  Tiles sampled from the seed have their
network input and head outputs kept from the timed path, for the check.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import tempfile
from typing import Dict, List

import numpy as np
import torch

from lanebench import core, inputs, reference
from lanebench.weights import draw_state_dict


class Cycle:
    """``n`` tiles of a dataset taken round and round, each named after
    its source tile and its round."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i: int) -> Dict:
        s = dict(self.ds[i % len(self.ds)])
        s["image_name"] = f"{s['image_name']}.{i // len(self.ds)}"
        return s


def sample_tiles(seed: int, n_batches: int, batch: int, k: int
                 ) -> Dict[int, List[int]]:
    """``k`` tiles (batch index -> tile rows) drawn from the seed among
    the first ``n_batches`` batches of the window."""
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    flat = rng.choice(n_batches * batch, size=k, replace=False)
    out: Dict[int, List[int]] = {}
    for f in sorted(int(x) for x in flat):
        out.setdefault(f // batch, []).append(f % batch)
    return out


def run(cell, rec: core.Run, seed: int, seconds: float, device,
        t_start: float) -> None:
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.data.las_tiles import LasTiles
    from lanemapping_tpu_torch.data.loader import Loader
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode
    from lanemapping_tpu_torch.kernels.bev_bin import bev_bin_mean
    from lanemapping_tpu_torch.models.nets import build_model
    from lanemapping_tpu_torch.tools import stream_map as sm
    from lanemapping_tpu_torch.tools.export_lanes import lane_records
    from lanebench.plain import build_model as plain_build

    tr = cell.traffic
    cfg_d = dict(cell.config)
    cfg = Config(json.loads(json.dumps(cfg_d)))
    cfg.batch_size = B = int(tr["batch"])
    img = cfg.list_img_size_xy[0]
    cuda = device.type == "cuda"
    work = tempfile.mkdtemp(prefix="lanebench_serve_")
    try:
        # -- inputs: the survey's clouds as files -----------------------
        clouds = inputs.survey_clouds(tr["clouds"], tr["points"], img, seed,
                                      device)
        inputs.write_survey(work, clouds)
        del clouds
        ds = LasTiles(work, mode="all", cfg=cfg)
        loader = Loader(Cycle(ds, len(ds) * 10000), batch_size=B,
                        shuffle=False, drop_last=True,
                        num_threads=int(tr["loader_threads"]),
                        prefetch=int(tr["prefetch"]))
        lanes_dir = os.path.join(work, "lanes_2d")
        os.makedirs(lanes_dir)

        # -- the program's model at the served weights ------------------
        sd = draw_state_dict(plain_build(cfg_d), int(cfg_d["seed"]), device)
        model = build_model(cfg).to(device)
        model.load_state_dict(sd)
        dtype = sm.prepare_serving(model, cfg)
        model = sm.place(model, device, dtype)
        del sd

        def mark():
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                return ev
            return core.now()

        spans = rec.spans
        sample = sample_tiles(seed, int(tr["sample_within_batches"]), B,
                              int(tr["sample_tiles"]))

        def fwd_dec(batch, idx, timed):
            host = (np.asarray(batch["points"], np.float32),
                    np.asarray(batch["points_mask"], bool))
            t = [mark()]
            dev = [torch.from_numpy(a).to(device) for a in host]
            t.append(mark())
            with torch.inference_mode():
                x = sm.network_input("las", dev, cfg, dtype)
                t.append(mark())
                out = model(x)
                t.append(mark())
                keep = sm.readback_view(out, cfg)
                t.append(mark())
                cap = None
                if timed and idx in sample:
                    rows = sample[idx]
                    cap = {"rows": rows,
                           "input": x[rows, ..., 0].clone(),
                           "out": {k: v[rows].clone()
                                   for k, v in out.items()}}
            if timed:
                for stage, a, b in zip(("upload", "binning", "forward",
                                        "decode"), t[:-1], t[1:]):
                    spans.add_events(stage, a, b)
            return keep, cap

        def postprocess(keep, names, cap):
            t0 = core.now()
            dec = {k: v.cpu().numpy() for k, v in keep.items()}
            if cap is not None:
                cap["input"] = cap["input"].cpu()
                cap["out"] = {k: v.cpu() for k, v in cap["out"].items()}
            maps = lane_maps_from_decode(dec, cfg)
            written, lanes = [], 0
            for j, name in enumerate(names):
                recs = lane_records(maps["cls_offset_smooth"][j])
                lanes += len(recs)
                with open(os.path.join(lanes_dir, f"{name}.json"), "w") as f:
                    json.dump(recs, f)
                written.append(core.now())
            ms = (core.now() - t0) * 1e3
            if cap is not None:
                cap["dec"] = {k: v[cap["rows"]] for k, v in dec.items()}
                cap["names"] = [names[j] for j in cap["rows"]]
            return ms, written, cap, lanes

        launched = bev_bin_mean.launches
        stream = iter(loader)
        for _ in range(int(tr["warmup_batches"])):
            b = next(stream)
            postprocess(fwd_dec(b, -1, False)[0], b["image_name"], None)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        rec.notes["setup_s"] = core.now() - t_start

        # -- the window -------------------------------------------------
        workers = int(tr["workers"])
        pool = cf.ThreadPoolExecutor(workers)
        futures: List[cf.Future] = []
        sent = 0
        prof = core.Profiler(rec.tracing, work)
        trace_left = int(tr["trace_batches"]) if rec.tracing else 0
        t0 = core.now()
        deadline = t0 + seconds
        idx = 0
        while True:
            past = core.now() >= deadline
            if past:
                if trace_left <= 0:
                    break
                prof.start()
                trace_left -= 1
            tw = core.now()
            with prof.span("lanebench.ingest_wait"):
                b = next(stream)
            if not past:
                spans.add_host("ingest_wait", (core.now() - tw) * 1e3)
            with prof.span("lanebench.device_stages"):
                keep, cap = fwd_dec(b, idx if not past else -1, not past)
            futures.append(pool.submit(postprocess, keep, b["image_name"],
                                       cap))
            if not past:
                sent += len(b["image_name"])
            idx += 1
            with prof.span("lanebench.wait_postprocess"):
                while sum(not f.done() for f in futures) >= workers:
                    cf.wait([f for f in futures if not f.done()],
                            return_when=cf.FIRST_COMPLETED)
        prof.stop()
        if cuda:
            rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        # -- drain (not timed) ----------------------------------------------
        t_drain = core.now()
        done, caps, lanes, tiles = 0, [], 0, 0
        for f in futures:
            try:
                ms, written, cap, n_lanes = f.result(timeout=120)
            except Exception as e:  # its tiles never came: failures
                rec.failed += B
                core.log(f"post-process failed: {type(e).__name__}: {e}")
                continue
            spans.add_host("postprocess", ms)
            done += sum(t <= deadline for t in written)
            lanes += n_lanes
            tiles += len(written)
            if cap is not None:
                caps.append(cap)
        pool.shutdown(wait=True)
        stream.close()
        rec.notes["drain_s"] = core.now() - t_drain
        rec.trace = prof.reduce()
        rec.attempted = sent
        rec.units = done
        rec.window_s = seconds
        rec.e2e["serve_tiles_per_s"] = done / seconds
        rec.launches = {"bev_bin_mean": bev_bin_mean.launches - launched}
        from lanebench import flops
        rec.kernel_bytes = {"k1": flops.k1_bytes(B, int(tr["points"]), 4,
                                                 img)}
        if rec.tracing:  # the forward's FLOPs a tile
            rec.unit_flops = flops.model_flops(cfg_d, 1, False)
        rec.notes["batches"] = idx
        # the host post-process's load: lanes written a tile
        rec.notes["lanes_per_tile"] = lanes / max(1, tiles)
        pp = spans.ms("postprocess")
        rec.notes["postprocess_ms_by_third"] = [
            float(np.mean(p)) for p in np.array_split(np.asarray(pp), 3)]
        del model, keep, futures
        if cuda:
            torch.cuda.empty_cache()

        # -- the check -------------------------------------------------------
        t = core.now()
        check(cell, rec, seed, device, work, lanes_dir, caps, cfg_d)
        rec.notes["check_s"] = core.now() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_tiles(work: str, names: List[str], n_points: int, device):
    """The sampled tiles' clouds, read from the files both sides read,
    padded to ``n_points``: ([T, N, 4], [T, N]) on ``device``."""
    pts, msk = [], []
    for name in names:
        p = inputs.read_las(os.path.join(work, "las",
                                         name.split(".")[0] + ".las"))
        n = min(len(p), n_points)
        buf = np.zeros((n_points, 4), np.float32)
        buf[:n] = p[:n]
        m = np.zeros(n_points, bool)
        m[:n] = True
        pts.append(buf)
        msk.append(m)
    return (torch.from_numpy(np.stack(pts)).to(device),
            torch.from_numpy(np.stack(msk)).to(device))


def check(cell, rec, seed, device, work, lanes_dir, caps, cfg_d) -> None:
    """The sampled tiles against the plain reference: the network input
    and the head outputs against the reference's from the same files; the
    decode the stream shipped against the reference's decode of the
    program's own head outputs; the lane JSONs against the reference's
    post-process of the program's own decode."""
    lim = cell.limits
    names = [n for c in caps for n in c["names"]]
    if not names:
        rec.check("sampled_tiles_compared", 1.0, 0.0)
        return
    pts, msk = load_tiles(work, names, int(cell.traffic["points"]), device)
    ref = reference.serve_tiles(cfg_d, draw_state_dict(
        _plain(cfg_d), int(cfg_d["seed"]), device), pts, msk, "float32")
    ig = hg = 0.0
    dec_bad = json_bad = 0
    t = 0
    for c in caps:
        for j, name in enumerate(c["names"]):
            r = ref[t]
            t += 1
            ig = max(ig, reference.input_gap(c["input"][j].to(device),
                                             r["input"]))
            prog_out = {k: v[j].to(device) for k, v in c["out"].items()}
            hg = max(hg, reference.head_gap(prog_out, r["out"]))
            with torch.no_grad():
                dv = reference.decode_view(
                    {k: v[None] for k, v in prog_out.items()}, cfg_d)
            for k, v in dv.items():
                dec_bad += int(np.sum(v[0].cpu().numpy() != c["dec"][k][j]))
            one = {k: v[j:j + 1] for k, v in c["dec"].items()}
            want = reference.lane_records(one, cfg_d)[0]
            with open(os.path.join(lanes_dir, name + ".json")) as f:
                got = json.load(f)
            json_bad += int(reference.records_differ(got, want))
    rec.notes["tiles_compared"] = t
    rec.check("input_gap", ig, lim["input_gap"])
    rec.check("head_gap", hg, lim["head_gap"])
    # exact comparisons: the same code on the same values
    rec.check("decode_mismatches", dec_bad, 0)
    rec.check("json_mismatches", json_bad, 0)


def _plain(cfg_d):
    from lanebench.plain import build_model
    return build_model(cfg_d)
