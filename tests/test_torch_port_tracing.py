"""The port's span and counter recorder (`utils/logger.py`), the spans and
counters the program records with it, and the benchmark's readers of them
(`lanebench/metrics/`).

Spans and counters record only while a ``torch.profiler`` runs: with none
running they make no torch call and record nothing; with one they record
name, clocks, thread and parent and appear in the Chrome trace.  Library
builds are recorded always.  CPU only, tiny shapes."""

import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.py")
TRAIN_PHASES = ["train.buffers", "train.cast", "train.forward", "train.loss",
                "train.backward", "train.guard", "train.optimizer"]


@pytest.fixture
def rec():
    """The recorder, emptied before and after the test."""
    from lanemapping_tpu_torch.utils import logger
    logger.reset_recorder()
    yield logger
    logger.reset_recorder()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_untraced_span_and_counter_record_and_call_nothing(rec, monkeypatch):
    calls = []
    real = torch.autograd.profiler.record_function

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    clocks = []
    monkeypatch.setattr(rec, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: clocks.append(1) or 0,
        thread_time_ns=lambda: clocks.append(1) or 0))

    @rec.traced("lane.decorated")
    def f(x):
        return x + 1

    assert not rec.recording()
    for _ in range(3):
        with rec.trace_span("lane.off") as s:
            assert s is None
        assert f(1) == 2
        rec.count("lane.counter", 5)
    assert rec.trace_span("lane.off") is rec.trace_span("lane.other")
    assert calls == [] and clocks == []
    r = rec.recorded()
    assert r["spans"] == [] and r["counters"] == {}
    # under a profiler the same calls do record, through record_function
    with _profiled():
        with rec.trace_span("lane.on"):
            pass
        rec.count("lane.counter", 5)
    assert len(calls) == 1 and len(clocks) == 4
    assert rec.recorded()["counters"] == {"lane.counter": 5}


def test_traced_spans_record_parent_thread_cpu_and_reach_the_trace(
        rec, tmp_path):
    def worker():
        with rec.trace_span("lane.worker"):
            time.sleep(0.02)

    with _profiled() as prof:
        assert rec.recording()
        with rec.trace_span("lane.outer"):
            with rec.trace_span("lane.busy"):
                t = time.perf_counter()
                while time.perf_counter() - t < 0.02:
                    pass
            th = threading.Thread(target=worker, name="lane-worker")
            th.start()
            th.join()
        rec.count("lane.items", 2)
        rec.count("lane.items")
    assert not rec.recording()
    r = rec.recorded()
    by = {s["name"]: s for s in r["spans"]}
    assert set(by) == {"lane.outer", "lane.busy", "lane.worker"}
    outer, busy, work = by["lane.outer"], by["lane.busy"], by["lane.worker"]
    assert outer["parent"] is None and busy["parent"] == outer["id"]
    # a span's parent is the one open on its own thread
    assert work["parent"] is None
    assert work["thread_name"] == "lane-worker"
    assert work["thread"] != outer["thread"] == busy["thread"]
    assert outer["start_ns"] <= busy["start_ns"] < busy["end_ns"] \
        <= outer["end_ns"]
    for s in r["spans"]:
        assert 0 <= s["cpu_ns"] <= s["end_ns"] - s["start_ns"]
    # busy-waiting is on the CPU, sleeping is not
    assert busy["cpu_ns"] > 0.5 * (busy["end_ns"] - busy["start_ns"])
    assert work["cpu_ns"] < 0.5 * (work["end_ns"] - work["start_ns"])
    assert r["counters"] == {"lane.items": 3}
    # the trace holds the ranges of the profiling thread (torch's default
    # leaves other threads' out); the recorder holds every thread's
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"lane.outer", "lane.busy"} <= names


def test_profiler_trace_writes_the_spans_beside_it(rec, tmp_path):
    from lanemapping_tpu_torch.utils.logger import (start_profiler_trace,
                                                    stop_profiler_trace,
                                                    trace_span)
    with _profiled():
        with trace_span("lane.before"):  # emptied by the start
            pass
    start_profiler_trace(str(tmp_path))
    with trace_span("lane.traced"):
        torch.ones(4).sum()
    rec.count("lane.count", 7)
    path = stop_profiler_trace()
    with open(os.path.join(os.path.dirname(path), "spans.json")) as f:
        spans = json.load(f)
    assert [s["name"] for s in spans["spans"]] == ["lane.traced"]
    assert spans["counters"] == {"lane.count": 7}
    assert spans["dropped"] == 0


def test_spans_past_the_cap_are_counted_as_dropped(rec, monkeypatch):
    monkeypatch.setattr(rec, "MAX_SPANS", 2)
    with _profiled():
        for _ in range(5):
            with rec.trace_span("lane.capped"):
                pass
    r = rec.recorded()
    assert len(r["spans"]) == 2 and r["dropped"] == 3


def _tiny_cfg():
    from lanemapping_tpu_torch.config.config import Config
    return Config.fromfile(TINY)


def test_train_step_records_its_seven_phases_in_order(rec):
    from lanemapping_tpu_torch.tools.bench import build_train

    torch.manual_seed(0)
    cfg = _tiny_cfg()
    state, step, batch = build_train(cfg, 2, torch.device("cpu"))
    step(state, batch)  # untraced: records nothing
    assert rec.recorded()["spans"] == []
    with _profiled():
        stats = step(state, batch)
    assert not stats["skipped_nan"]
    # a read on the CPU never waits on a card
    assert rec.recorded()["counters"]["guard_waits"] == 0
    spans = sorted(rec.recorded()["spans"], key=lambda s: s["start_ns"])
    outer, phases = spans[0], spans[1:]
    assert outer["name"] == "train.step" and outer["parent"] is None
    assert [s["name"] for s in phases] == TRAIN_PHASES
    assert all(s["parent"] == outer["id"] for s in phases)
    for a, b in zip(phases, phases[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert outer["start_ns"] <= phases[0]["start_ns"] \
        and phases[-1]["end_ns"] <= outer["end_ns"]
    # profile_train's record: host ms a step of each phase
    from lanemapping_tpu_torch.tools.profile_train import phase_ms_per_step
    ms = phase_ms_per_step(rec.recorded()["spans"], 1)
    assert set(ms) == {"train.step", *TRAIN_PHASES}
    assert sum(ms[n] for n in TRAIN_PHASES) <= ms["train.step"]
    # the model's own span is the inference one: not taken in training
    state.model.eval()
    from lanemapping_tpu_torch.engine.state import model_input
    with _profiled(), torch.no_grad():
        state.model(model_input(batch).float())
    assert [s["name"] for s in rec.recorded()["spans"]][-1:] == \
        ["serve.forward"]


def _decode(cfg, seed=0):
    """A host decode dict of the tiny config from seeded raw head maps."""
    from lanemapping_tpu_torch.decode.lane_decode import (decode_lanes,
                                                          host_decode_view)
    B, S, P, W, IMG = 2, 24, 12, 10, 192
    rng = np.random.RandomState(seed)
    m = {"proposal_conf": rng.randn(B, P, 2),
         "ext2": rng.randn(B, P, S, 3) * 2.0,
         "cls2": rng.randn(B, P, S, W) * 3.0,
         "offset2": rng.randn(B, P, S, W),
         "orient": rng.randn(B, S, S, 11),
         "semantic_seg": rng.randn(B, IMG, IMG, 3),
         "endp_est": rng.normal(-4.0, 0.5, (B, IMG, IMG, 1))}
    dec = decode_lanes({k: torch.tensor(v.astype(np.float32))
                        for k, v in m.items()}, cfg)
    return {k: v.numpy() for k, v in host_decode_view(dec).items()}


def test_postprocess_counts_tiles_and_kept_proposals(rec):
    from lanemapping_tpu_torch.decode.postprocess import lane_maps_from_decode

    cfg = _tiny_cfg()
    assert cfg.proposal_obj_thre == 0.3
    dec = _decode(cfg)
    # 12 proposals a tile; rows 0-3 and the last six are the border cut
    dec["prop_conf"][0, :, 1] = [0.9] * 12            # rows 4, 5: 2 kept
    dec["prop_conf"][1, :, 1] = [0.9, 0.9, 0.9, 0.9, 0.31, 0.29,
                                 0.9, 0.9, 0.9, 0.9, 0.9, 0.9]  # row 4: 1
    lane_maps_from_decode(dec, cfg)  # untraced: counts nothing
    assert rec.recorded()["counters"] == {}
    with _profiled():
        lane_maps_from_decode(dec, cfg)
    r = rec.recorded()
    assert r["counters"] == {"tiles": 2, "proposals": 3}
    names = [s["name"] for s in r["spans"]]
    assert sorted(names) == sorted(
        ["serve.postprocess"] + 2 * ["postprocess.track", "postprocess.nms",
                                     "postprocess.semantics"])
    top = [s for s in r["spans"] if s["name"] == "serve.postprocess"][0]
    assert all(s["parent"] == top["id"] for s in r["spans"] if s is not top)


@pytest.mark.parametrize("how", ["unavailable", "raises"])
def test_native_fallback_is_counted_and_said_once(rec, monkeypatch, how):
    from lanemapping_tpu_torch import native
    from lanemapping_tpu_torch.decode import postprocess as pp

    cfg = _tiny_cfg()
    dec = _decode(cfg, seed=1)
    want = pp.lane_maps_from_decode({k: v.copy() for k, v in dec.items()},
                                    cfg)
    monkeypatch.setattr(pp, "_fallback_said", False)
    if how == "unavailable":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_failed", OSError("no g++ here"))
        said = "no g\\+\\+ here"
    else:
        def broken(*a, **k):
            raise ValueError("bad native call")
        for name in ("smooth_lanes_native", "polyline_nms_native",
                     "uniform_semantics_native"):
            monkeypatch.setattr(native, name, broken)
        said = "bad native call"
    with pytest.warns(RuntimeWarning, match=said) as warned:
        with _profiled():
            got = pp.lane_maps_from_decode(
                {k: v.copy() for k, v in dec.items()}, cfg)
        pp.lane_maps_from_decode({k: v.copy() for k, v in dec.items()}, cfg)
    assert len([w for w in warned if "native" in str(w.message)]) == 1
    # tracker, NMS and semantics of each of the two tiles, traced once
    assert rec.recorded()["counters"]["native_fallbacks"] == 6
    # the NumPy result (the native library's agrees to rounding)
    for a, b in zip(got["cls_offset_smooth"], want["cls_offset_smooth"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)


def _fake_nvcc(tmp_path):
    """An ``nvcc`` that writes its ``-o`` file after a short pause."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ \"$1\" != \"-o\" ]; do shift; done\n"
                    "sleep 0.2\ntouch \"$2\"\n")
    nvcc.chmod(0o755)
    return str(tmp_path / "cuda")


@pytest.mark.parametrize("tool", ["g++", "nvcc"])
def test_library_builds_are_recorded_always(rec, monkeypatch, tmp_path,
                                            tool):
    from lanemapping_tpu_torch import native
    from lanemapping_tpu_torch.kernels import build

    n0 = len(rec.recorded()["builds"])
    t0 = time.perf_counter()
    if tool == "g++":
        monkeypatch.setattr(native, "_LIB", str(tmp_path / "libpostproc.so"))
        native.build_library(force=True)
        assert os.path.exists(tmp_path / "libpostproc.so")
        library = "postproc"
    else:
        monkeypatch.setenv("CUDA_HOME", _fake_nvcc(tmp_path))
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
        monkeypatch.setattr(build, "_paths", lambda n: (
            str(tmp_path / f"{n}.cu"), str(tmp_path / "_build" / f"lib{n}.so")))
        built = build.build_all(["k_a", "k_b"], force=True)
        assert set(built) == {"k_a", "k_b"}
        library = "k_a"
    t1 = time.perf_counter()
    new = rec.recorded()["builds"][n0:]
    assert not rec.recording()  # recorded with no profiler running
    assert library in {b["library"] for b in new}
    for b in new:
        assert b["tool"] == tool
        assert t0 <= b["start"] < b["end"] <= t1
        assert b["seconds"] == pytest.approx(b["end"] - b["start"])
    if tool == "nvcc":
        assert all(b["seconds"] >= 0.2 for b in new)


def _span(name, start_ms, end_ms, cpu_ms, thread=1, parent=None, sid=0):
    return {"id": sid, "parent": parent, "name": name, "thread": thread,
            "thread_name": f"t{thread}", "start_ns": int(start_ms * 1e6),
            "end_ns": int(end_ms * 1e6), "cpu_ns": int(cpu_ms * 1e6)}


def _synthetic():
    """Two serving batches, two post-process batches, two training steps
    and two overlapping builds, with the values each reader should give."""
    spans = [
        _span("serve.input", 0, 10, 4), _span("serve.forward", 10, 40, 6),
        _span("serve.decode", 40, 50, 10),
        _span("serve.postprocess", 5, 105, 40, thread=2),
        _span("postprocess.track", 10, 50, 20, thread=2, parent=1),
        _span("serve.postprocess", 20, 70, 10, thread=3),
    ]
    t = 1000.0
    for step in range(2):  # phases of 1 ms with gaps of 0.5 ms; guard 3 ms
        sid = 100 + step
        spans.append(_span("train.step", t - 0.5, t + 12.0, 11.0, thread=9,
                           sid=sid))
        for name in TRAIN_PHASES:
            d = 3.0 if name == "train.guard" else 1.0
            spans.append(_span(name, t, t + d, d, thread=9, parent=sid))
            t += d + 0.5
    # a step cut by the profiler's start: no guard, left out
    spans.append(_span("train.step", 2000.0, 2001.0, 1.0, thread=9, sid=200))
    spans.append(_span("train.optimizer", 2000.0, 2001.0, 1.0, thread=9,
                       parent=200))
    counters = {"tiles": 16, "proposals": 40, "native_fallbacks": 2,
                "bn_mixed": 72, "bn_k2": 64, "guard_waits": 1}
    builds = [{"tool": "nvcc", "library": "a", "start": 1.0, "end": 5.0,
               "seconds": 4.0},
              {"tool": "nvcc", "library": "b", "start": 2.0, "end": 6.0,
               "seconds": 4.0},
              {"tool": "g++", "library": "postproc", "start": 10.0,
               "end": 12.5, "seconds": 2.5}]
    # a step: 12.5 ms from its start to its end, 3 of them in the guard
    want = {"launch_offcpu.serve": 100.0 * (1 - 20 / 50),
            "postprocess_offcpu.serve": 100.0 * (1 - 50 / 150),
            "proposals_per_tile.serve": 40 / 16,
            "native_fallbacks.serve": 2,
            "step_host_ms.train": 12.5 - 3.0,
            "guard_wait_ms.train": 3.0,
            "native_build_s": 5.0 + 2.5,
            "bn_mixed_per_step.train": 72 / 2,
            "bn_k2_per_step.train": 64 / 2,
            "guard_waits_per_step.train": 1 / 2}
    return {"spans": spans, "counters": counters, "builds": builds,
            "dropped": 0}, want


READERS = ["launch_offcpu.serve", "postprocess_offcpu.serve",
           "proposals_per_tile.serve", "native_fallbacks.serve",
           "step_host_ms.train", "guard_wait_ms.train", "native_build_s",
           "bn_mixed_per_step.train", "bn_k2_per_step.train",
           "guard_waits_per_step.train"]


@pytest.mark.parametrize("metric", READERS)
def test_reader_of_the_programs_records(monkeypatch, metric):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from lanebench import core
    from lanemapping_tpu_torch.utils import logger

    read = core.load_file_module(
        os.path.join(REPO, "lanebench", "metrics", metric + ".py"),
        "tracing_test_" + metric.replace(".", "_")).read
    run = types.SimpleNamespace()
    recording, want = _synthetic()
    monkeypatch.setattr(logger, "recorded", lambda: recording)
    assert read(run) == pytest.approx(want[metric])
    empty = {"spans": [], "counters": {}, "builds": [], "dropped": 0}
    monkeypatch.setattr(logger, "recorded", lambda: empty)
    # nothing recorded; a process that built nothing spent 0 s building
    assert read(run) == (0.0 if metric == "native_build_s" else None)
    # a program without the recorder: no reading, and no error
    monkeypatch.delattr(logger, "recorded")
    assert read(run) is None


def test_untraced_span_costs_a_flag_read(rec):
    """Untraced, a span is cheaper than a bare record_function by far (a
    coarse bound that holds on a loaded host; PERF.md has the card host's
    figures)."""
    n = 20000

    def per_call(body):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter()
            body()
            best = min(best, (time.perf_counter() - t) / n)
        return best

    def spans():
        for _ in range(n):
            with rec.trace_span("lane.cost"):
                pass

    def record_functions():
        for _ in range(n):
            with torch.autograd.profiler.record_function("lane.cost"):
                pass
    assert per_call(spans) < 0.25 * per_call(record_functions)
    assert rec.recorded()["spans"] == []


def test_bn_mixed_reader_without_mixed_calls_and_without_the_call(
        monkeypatch):
    """0 where the traced steps ran no mixed BatchNorm call (float32
    activations); no reading from a program whose BatchNorm has none."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from lanebench import core
    from lanemapping_tpu_torch.models import norm
    from lanemapping_tpu_torch.utils import logger

    read = core.load_file_module(
        os.path.join(REPO, "lanebench", "metrics",
                     "bn_mixed_per_step.train.py"),
        "tracing_test_bn_mixed_float32").read
    recording, _ = _synthetic()
    recording["counters"].pop("bn_mixed")
    monkeypatch.setattr(logger, "recorded", lambda: recording)
    assert read(types.SimpleNamespace()) == 0.0
    monkeypatch.delattr(norm, "MIXED_DTYPES")
    assert read(types.SimpleNamespace()) is None


def test_bn_k2_reader_counts_k2_alone_and_nothing_without_k2(monkeypatch):
    """The library's mixed calls count in ``bn_mixed`` and not here: 0
    where no traced step launched K2; no reading from a program without
    K2."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from lanebench import core
    from lanemapping_tpu_torch.utils import logger

    read = core.load_file_module(
        os.path.join(REPO, "lanebench", "metrics", "bn_k2_per_step.train.py"),
        "tracing_test_bn_k2").read
    recording, _ = _synthetic()
    recording["counters"].pop("bn_k2")
    monkeypatch.setattr(logger, "recorded", lambda: recording)
    assert read(types.SimpleNamespace()) == 0.0
    monkeypatch.setitem(sys.modules,
                        "lanemapping_tpu_torch.kernels.batch_norm", None)
    assert read(types.SimpleNamespace()) is None


def test_guard_waits_reader_without_waits_and_without_the_counter(
        monkeypatch):
    """0 where every traced step found the loss's flag off the card; no
    reading from a program that does not count the guard's waits."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from lanebench import core
    from lanemapping_tpu_torch.utils import logger

    read = core.load_file_module(
        os.path.join(REPO, "lanebench", "metrics",
                     "guard_waits_per_step.train.py"),
        "tracing_test_guard_waits").read
    recording, _ = _synthetic()
    recording["counters"]["guard_waits"] = 0
    monkeypatch.setattr(logger, "recorded", lambda: recording)
    assert read(types.SimpleNamespace()) == 0.0
    recording["counters"].pop("guard_waits")
    assert read(types.SimpleNamespace()) is None
