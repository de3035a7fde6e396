"""The benchmark's KLane RowRef cell (`lanebench/`, cell ``rowref.train``):
its plain reference against the port, the route the reference follows,
its weight rule, its labels, its loop and its readers, and the head's
spans and counters (`models/row_head.py`).  CPU only, at chip_smoke's
tiny RowRef (192 px tiles, row_size 24, dim_feat 2, ResNet-18, a
one-block correlator)."""

import json
import os
import sys
import time
import types

import pytest
import torch

from torch_port_helpers import REPO, ZOO_COMMON, ZOO_TINY

if REPO not in sys.path:
    sys.path.insert(0, REPO)

SEED = 3000000019
with open(os.path.join(REPO, "lanebench", "limits", "rowref.train.json")) as f:
    MARGINS = {k: v for k, v in json.load(f).items() if k.startswith("_")}


def tiny_cfg(dtype="float32"):
    """The resolved tiny RowRef configuration as the cell's file holds
    one (a JSON object)."""
    from lanemapping_tpu_torch.config.config import Config
    cfg = Config.fromfile(os.path.join(
        REPO, "configs", "Proj28_GFC-T3_RowRef_82_73_laser.py"))
    cfg.merge_from_dict({**ZOO_COMMON, **ZOO_TINY["rowref"],
                         "train_compute_dtype": dtype})
    return json.loads(json.dumps(cfg.to_dict()))


def port_model(cfg_d, sd):
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.models.nets import build_model
    model = build_model(Config(json.loads(json.dumps(cfg_d))))
    model.load_state_dict(sd)
    return model


def port_loss(cfg_d):
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.engine.runner import Runner
    cfg = Config(json.loads(json.dumps(cfg_d)))
    return Runner._build_loss(cfg, cfg.heads.type)


@pytest.fixture(scope="module")
def tiny():
    from lanebench import rows
    torch.manual_seed(0)
    cfg_d = tiny_cfg()
    sd = rows.draw_state_dict(cfg_d, SEED, torch.device("cpu"))
    batch = rows.train_batches(cfg_d, 1, 2, SEED, torch.device("cpu"))[0]
    return types.SimpleNamespace(cfg=cfg_d, sd=sd, batch=batch)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_plain_reference_matches_the_port_forward_loss_and_gradients(tiny):
    from lanebench import rows
    prog = port_model(tiny.cfg, tiny.sd).train()
    ref = rows.plain_model(tiny.cfg)
    ref.load_state_dict(tiny.sd)
    ref.train()
    x = tiny.batch["proj"]
    out_p, out_r = prog(x), ref(x)
    out_r.pop("route")
    assert set(out_p) == set(out_r)
    for k in out_r:
        assert _rel(out_p[k], out_r[k]) < 1e-5, k
    loss_p = port_loss(tiny.cfg)(out_p, tiny.batch)["loss"]
    loss_r = rows.loss(out_r, tiny.batch, tiny.cfg)["loss"]
    assert float(loss_p.detach()) == pytest.approx(float(loss_r.detach()),
                                                   rel=1e-6)
    loss_p.backward()
    loss_r.backward()
    grads_r = dict(ref.named_parameters())
    moved = 0
    for n, p in prog.named_parameters():
        g_r = grads_r[n].grad
        if g_r is None or float(g_r.norm()) == 0.0:
            assert p.grad is None or float(p.grad.norm()) == 0.0, n
            continue
        moved += 1
        assert _rel(p.grad, g_r) < 1e-4, n
    assert moved > 50
    for m in (prog.state_dict(), ref.state_dict()):  # statistics moved
        assert float(m["heads.ext1.bn.running_var"].std()) > 0


def test_pinned_route_agrees_and_a_moved_window_is_counted(tiny):
    from lanebench import rows
    from lanebench.reference_rows import route_flips
    prog = port_model(tiny.cfg, tiny.sd).eval()
    ref = rows.plain_model(tiny.cfg)
    ref.load_state_dict(tiny.sd)
    thr = tiny.cfg["heads"]["thr_ext"]
    x = tiny.batch["proj"]
    with torch.no_grad():
        out_p = prog(x)
        route = (torch.argmax(out_p["cls"], -1),
                 out_p["ext"][..., 0].mean(-1) > thr)
        out_r = ref(x, route)
    assert torch.equal(out_r["route"][0], route[0])
    for k in ("ext2", "cls2"):
        assert _rel(out_p[k], out_r[k]) < 1e-5, k
    assert route_flips(out_r, route, thr, 0.0, 0.0)["flips"] == 0
    # one lane-row's window moved to the column the reference likes least
    moved = route[0].clone()
    worst = int(torch.argmin(out_r["cls"][0, 0, 0]))
    moved[0, 0, 0] = worst
    with torch.no_grad():
        out_m = ref(x, (moved, route[1]))
    assert _rel(out_m["cls2"], out_r["cls2"]) > 1e-6
    r = route_flips(out_m, (moved, route[1]), thr, 0.0, 0.0)
    assert r["windows"] == 1 and r["flips"] == 1
    p = out_m["cls"][0, 0, 0]
    gap = float(p.max() - p[worst])
    assert r["window_gap"] == pytest.approx(gap)
    assert route_flips(out_m, (moved, route[1]), thr, 2 * gap,
                       0.0)["flips"] == 0
    # a gate turned: counted beyond the gate margin only
    gates = route[1].clone()
    gates[1, 3] = ~gates[1, 3]
    r = route_flips(out_r, (route[0], gates), thr, 0.0, 0.0)
    assert r["gates"] == 1 and r["flips"] == 1
    assert route_flips(out_r, (route[0], gates), thr, 0.0,
                       1.0)["flips"] == 0


def test_weight_rule_covers_every_leaf_and_loads_into_both(tiny):
    from lanebench import rows
    ref = rows.plain_model(tiny.cfg)
    prog = port_model(tiny.cfg, tiny.sd)
    assert list(tiny.sd) == list(ref.state_dict())
    assert set(tiny.sd) == set(prog.state_dict())
    ref.load_state_dict(tiny.sd, strict=True)
    for name, m in ref.named_modules():
        if type(m).__name__ != "PerLaneConvHead":
            continue
        for leaf, fan in (("w1", m.w1.shape[1]), ("b1", m.w1.shape[1]),
                          ("w2", m.w2.shape[1]), ("b2", m.w2.shape[1])):
            v = tiny.sd[f"{name}.{leaf}"]
            assert float(v.abs().max()) <= fan ** -0.5
            assert float(v.abs().max()) > 0.9 * fan ** -0.5
    emb = tiny.sd["heads.lane_emb"]
    assert 0.8 < float(emb.std()) < 1.2
    again = rows.draw_state_dict(tiny.cfg, SEED, torch.device("cpu"))
    other = rows.draw_state_dict(tiny.cfg, SEED + 1, torch.device("cpu"))
    assert all(torch.equal(again[k], tiny.sd[k]) for k in tiny.sd)
    assert not torch.equal(other["heads.cls1.w1"], tiny.sd["heads.cls1.w1"])
    assert not torch.equal(other["pcencoder.fpn.conv1.weight"],
                           tiny.sd["pcencoder.fpn.conv1.weight"])


def test_label_drawer_rows_and_ids():
    from lanebench import inputs, rows
    S, L = 144, 12
    lab = rows.row_labels(32, S, L, inputs.generator(
        torch.device("cpu"), SEED, 5), torch.device("cpu"))
    assert lab.shape == (32, S, S) and lab.dtype == torch.int32
    ids = set(lab.unique().tolist())
    assert ids <= set(range(L)) | {rows.BACKGROUND} and len(ids) == L + 1
    per_row = (lab[:, None] == torch.arange(L)[None, :, None, None]).sum(-1)
    seen = set(per_row.unique().tolist())
    assert {0, 1, 2} <= seen and max(seen) <= 2
    lanes = (per_row.sum(-1) > 0).sum(-1)
    assert int(lanes.min()) >= 3 and int(lanes.max()) <= L
    assert int(lanes.max()) >= 10 and int(lanes.min()) <= 5
    again = rows.row_labels(32, S, L, inputs.generator(
        torch.device("cpu"), SEED, 5), torch.device("cpu"))
    assert torch.equal(lab, again)


def _cell(dtype, limits=None):
    with open(os.path.join(REPO, "lanebench", "traffic",
                           "train_rows.json")) as f:
        tr = json.load(f)
    tr.update(batch=2, ring=4, trace_steps=2)
    lim = limits or {"head1_gap": 0.5, "grad_gap": 0.5, "change_gap": 0.5,
                     "route_flips": 0}
    return types.SimpleNamespace(name="rowref.train", config=tiny_cfg(dtype),
                                 traffic=tr, limits={**lim, **MARGINS})


def _run(cell, seconds=1.0):
    from lanebench import core
    rec = core.Run(cell, seconds, False)
    rec.device_kind = "cpu"
    core.loop(cell).run(cell, rec, SEED, seconds, torch.device("cpu"),
                        time.perf_counter())
    return rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_loop_and_its_check_run_on_the_cpu(dtype):
    rec = _run(_cell(dtype))
    got = {**{n: v for n, v, _ in rec.checks},
           **rec.notes.get("readings", {})}
    assert rec.correct and rec.units > 0 and rec.failed == 0
    assert got["route_flips"] == 0
    assert len(rec.notes["ref_losses"]) == 3
    if dtype == "float32":
        # the same arithmetic on the same route: round-off only
        assert rec.notes["route"]["windows"] == 0
        assert got["loss_gap"] < 1e-5 and got["head1_gap"] < 1e-4
        assert got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-2
    else:
        # bf16 picks other windows than float32 would, inside the margin
        assert rec.notes["route"]["windows"] > 0
        assert rec.notes["route"]["window_gap"] < MARGINS["_route_margin"]
        assert got["head1_gap"] > 1e-3


def test_the_control_fails_where_the_program_passes():
    """The float8 control, on its own route, against limits at three
    times the program's readings: not correct, with route flips."""
    import lanebench.control_rows as control_rows
    cell = _cell("bfloat16")
    prog = {n: v for n, v, _ in _run(cell).checks}
    cell.limits = {**{k: 3.0 * v for k, v in prog.items()}, **MARGINS}
    line = control_rows.seed_line(cell, SEED, torch.device("cpu"), "float8",
                                  1.0, program=False)
    assert line["control_correct"] is False, line["control_checks"]
    assert line["control"]["route_flips"] > 0
    assert line["control_route"]["windows"] >= line["control_route"]["flips"]


def _recording(spans, counters):
    keys = ("id", "parent", "name", "start_ns", "end_ns")
    return {"spans": [dict(zip(keys, s), thread=1, thread_name="main",
                           cpu_ns=0) for s in spans],
            "counters": counters, "builds": [], "dropped": 0}


def test_the_readers_on_a_synthetic_recording(monkeypatch):
    from lanebench import core, recorder
    head = core.reader("head_host_ms.train")
    writebacks = core.reader("lane_writebacks_per_step.train")
    ms = 1_000_000
    spans = []
    for k in range(2):  # two steps, a head span of 3 and 5 ms
        base = 10 * k + 1
        spans += [(base, None, "train.step", 0, 40 * ms),
                  (base + 1, base, "train.forward", 0, 20 * ms),
                  (base + 2, base + 1, "rowref.head", 0, (3 + 2 * k) * ms),
                  (base + 3, base, "train.guard", 30 * ms, 31 * ms)]
    rec = _recording(spans, {"rowref.write_backs": 24})
    monkeypatch.setattr(recorder, "recorded", lambda: rec)
    assert head(None) == pytest.approx(4.0)
    assert writebacks(None) == pytest.approx(12.0)
    # a program without the span or the counter: no reading
    bare = _recording([s for s in spans if s[2] != "rowref.head"], {})
    monkeypatch.setattr(recorder, "recorded", lambda: bare)
    assert head(None) is None and writebacks(None) is None
    # untraced: no step recorded
    monkeypatch.setattr(recorder, "recorded", lambda: _recording([], {}))
    assert head(None) is None and writebacks(None) is None


def test_head_spans_and_counters_record_under_a_profiler_only(tiny):
    from lanemapping_tpu_torch.utils import logger
    model = port_model(tiny.cfg, tiny.sd).eval()
    head = model.heads
    fea = torch.randn(2, head.dim_feat, head.row_size, head.row_size)
    logger.reset_recorder()
    try:
        with torch.no_grad():
            head(fea)
        r = logger.recorded()
        assert r["counters"] == {} and r["spans"] == []
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                out = head(fea)
        r = logger.recorded()
    finally:
        logger.reset_recorder()
    thr = tiny.cfg["heads"]["thr_ext"]
    gated = int((out["ext"][..., 0].mean(-1) > thr).sum())
    assert r["counters"] == {"rowref.write_backs": head.n_lanes,
                             "rowref.lanes": 2 * head.n_lanes,
                             "rowref.lanes_gated": gated}
    by_name = {s["name"]: s for s in r["spans"]}
    top = by_name["rowref.head"]
    children = ["rowref.stage1", "rowref.window", "rowref.correlator",
                "rowref.write_back", "rowref.stage2"]
    assert sorted(by_name) == sorted(["rowref.head"] + children)
    assert all(by_name[c]["parent"] == top["id"] for c in children)
    starts = [by_name[c]["start_ns"] for c in children]
    assert starts == sorted(starts)


def test_flop_count_of_a_step_is_linear_in_the_batch(tiny):
    from lanebench import rows
    two = rows.model_flops(tiny.cfg, 2)
    assert two > 0 and rows.model_flops(tiny.cfg, 4) == 2 * two
