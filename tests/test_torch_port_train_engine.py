"""The port's training engine against the JAX package's on the CPU: LR
schedules and optimizer updates against optax, the data loader's batch
order, the validation metrics, and the Runner (train, checkpoint, resume,
finetune load, NaN guard, validate) and its entry points (``tools/train``,
``LaneMapper.map_directory`` / ``evaluate``), at ``configs/tiny_test.py``.

The schedules and updates are held to optax run in float64 (x64): in
float32 optax rounds its own constants by more than the 1e-6 bar, where
torch computes them in double — Adam's bias correction ``1 - 0.999**t``
cancels to a 1.3e-5 relative error at t = 1, the SGD warm-up factor
``1 - (1 - t/5000)`` to 1.3e-4 — so the float32 comparison would measure
optax's rounding, not the formulas.
"""

import copy
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_port_helpers import TINY, configs, wire_data_root


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 tiles: train 4 (2 batches of 2), valid 2, test 2."""
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=8, img=192, seed=5)
    return root


def tiny(root, **over):
    cfg_j, cfg_t = configs(TINY)
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        for k, v in over.items():
            cfg[k] = v
    return cfg_j, cfg_t


# -- schedules and optimizers -----------------------------------------------

SCHEDULES = {
    "cosine": dict(optimizer=dict(type="Adam", lr=2.1e-4),
                   scheduler=dict(type="CosineAnnealingLR", T_max=7,
                                  eta_min=1e-5)),
    "lambda": dict(optimizer=dict(type="Adam", lr=1e-3),
                   scheduler=dict(type="LambdaLR", gamma=0.9,
                                  steps_per_epoch=3)),
    "sgd_warmup": dict(optimizer=dict(type="SGD", lr=0.05, momentum=0.9),
                       scheduler=dict(type="CosineAnnealingLR", T_max=40)),
}


def set_cfg(cfg, over):
    for k, v in over.items():
        cfg[k] = dict(v)
    return cfg


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_sequence_matches_optax(name):
    from lanemapping_tpu.engine.optimizer import build_schedule
    from lanemapping_tpu_torch.engine.optimizer import build_optimizer

    cfg_j, cfg_t = (set_cfg(c, SCHEDULES[name]) for c in configs(TINY))
    base = build_schedule(cfg_j)
    if name == "sgd_warmup":  # the JAX optimizer's warm-up factor
        warm = optax.linear_schedule(0.0, 1.0, 5000)
        want_fn = lambda s: base(s) * warm(s)  # noqa: E731
    else:
        want_fn = base
    opt, sched = build_optimizer(cfg_t, [torch.zeros(1, requires_grad=True)])
    steps = [0, 1, 2, 3, 5, 7, 8, 12, 40, 41, 4999, 5000, 6000]
    for t in range(max(steps) + 1):
        if t in steps:
            got = opt.param_groups[0]["lr"]
            with jax.enable_x64(True):
                want = float(want_fn(jnp.asarray(t, jnp.int64)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (t, got,
                                                                     want)
        opt.step()
        sched.step()


@pytest.mark.parametrize("opt_type", ["Adam", "AdamW", "SGD"])
def test_optimizer_updates_match_optax(opt_type):
    from lanemapping_tpu.engine.optimizer import build_optimizer as jax_opt
    from lanemapping_tpu_torch.engine.optimizer import build_optimizer

    over = {"optimizer": dict(type=opt_type, lr=1e-2, momentum=0.9,
                              weight_decay=0.05),
            "scheduler": dict(type="CosineAnnealingLR", T_max=4000)}
    cfg_j, cfg_t = (set_cfg(c, over) for c in configs(TINY))
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(7, 5), "b": rng.randn(11)}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt, sched = build_optimizer(cfg_t, list(tp.values()))
    # SGD's warm-up makes its first lr 0: start both at update 1000
    start = 1000 if opt_type == "SGD" else 0
    for _ in range(start):
        opt.step()  # no gradients yet: nothing moves
        sched.step()
    with jax.enable_x64(True):
        tx = jax_opt(cfg_j)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        jstate = tx.init(jp)
        if start:
            jstate = (jstate[0], jstate[1]._replace(count=jnp.asarray(
                start, jnp.int32)))
        for _ in range(5):
            g = {k: rng.randn(*v.shape) for k, v in params.items()}
            upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
            jp = optax.apply_updates(jp, upd)
            for k, v in tp.items():
                v.grad = torch.from_numpy(g[k])
            opt.step()
            sched.step()
            for k in params:
                np.testing.assert_allclose(tp[k].detach().numpy(),
                                           np.asarray(jp[k]), rtol=1e-6,
                                           atol=1e-9, err_msg=k)
    moved = np.abs(tp["a"].detach().numpy() - params["a"]).max()
    assert moved > 1e-3


def test_mu_dtype_is_refused():
    """A ``optimizer.mu_dtype`` that names no dtype is refused, by both
    packages, before any optimizer is built (a float dtype builds
    ``MuDtypeAdam``, held to optax in `test_torch_port_engine_gaps.py`)."""
    from lanemapping_tpu.engine.optimizer import build_optimizer as jax_opt
    from lanemapping_tpu_torch.engine.optimizer import build_optimizer

    for opt_type in ("Adam", "SGD"):
        cfg_j, cfg_t = configs(TINY)
        for cfg in (cfg_j, cfg_t):
            cfg.optimizer["type"] = opt_type
            cfg.optimizer["mu_dtype"] = "bfloat17"
        with pytest.raises(TypeError):
            jax_opt(cfg_j)
        with pytest.raises(TypeError, match="mu_dtype"):
            build_optimizer(cfg_t, [torch.zeros(1, requires_grad=True)])


# -- data and metrics -------------------------------------------------------

def test_loader_order_matches_jax(data_root):
    from lanemapping_tpu.data.loader import build_dataloader as jax_loader
    from lanemapping_tpu_torch.data.loader import build_dataloader

    cfg_j, cfg_t = tiny(data_root, workers=2)
    jl = jax_loader(cfg_j.dataset.train, cfg_j, is_train=True)
    tl = build_dataloader(cfg_t.dataset.train, cfg_t, is_train=True)
    orders = []
    for _ in range(3):  # epochs reshuffle with seed + epoch
        jb, tb = list(jl), list(tl)
        assert [b["image_name"] for b in jb] == [b["image_name"] for b in tb]
        for a, b in zip(jb, tb):
            assert set(a) == set(b)
            for k in a:
                if not isinstance(a[k], list):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        orders.append([n for b in tb for n in b["image_name"]])
    assert len({tuple(o) for o in orders}) > 1
    assert len(tl) == len(jl) == 2


def test_metrics_match_jax(data_root):
    import lanemapping_tpu.utils.metrics as jm
    import lanemapping_tpu.utils.skeleton as js
    import lanemapping_tpu_torch.utils.metrics as tm
    import lanemapping_tpu_torch.utils.skeleton as ts
    from lanemapping_tpu_torch.data.loader import build_dataloader

    _, cfg_t = tiny(data_root)
    batch = next(iter(build_dataloader(cfg_t.dataset.val, cfg_t,
                                       is_train=False)))
    rng = np.random.RandomState(3)
    label = batch["lc_coor_raw"][0]
    pred = np.where(rng.rand(*label.shape) < 0.8,
                    label + rng.randn(*label.shape) * 6.0, 0.0)
    mask = batch["mask"][0]
    seg = np.roll(mask, 3, axis=1)
    endp_gt = batch["endp_map"][0]
    endp_pred = np.argwhere(endp_gt > 0.5) + rng.randint(-4, 5, (1, 2))
    grid = (rng.rand(144, 144) > 0.9).astype(np.float64)
    calls = [
        ("cal_coor_measures", (label, pred), dict(buffer_px=10,
                                                  img_size=192)),
        ("eval_metric_endp_detector", (endp_pred, endp_gt), dict(r_thre=20)),
        ("eval_metric_line_segmentor", (seg, mask),
         dict(bi_seg=False, semantics=2, buffer_px=10)),
        ("eval_metric_line_segmentor", (seg, mask), dict(buffer_px=10)),
        ("grid_measures", (grid, np.roll(grid, 1, axis=0)), {}),
        ("prf_from_counts", (5, 9, 4, 7), {}),
    ]
    for name, args, kw in calls:
        want = getattr(jm, name)(*args, **kw)
        got = getattr(tm, name)(*args, **kw)
        assert got == want, name
    np.testing.assert_array_equal(ts.skeletonize(mask > 0),
                                  js.skeletonize(mask > 0))


# -- Runner -----------------------------------------------------------------

def port_state(runner):
    """A deep copy of a Runner's train state, as state dicts."""
    st = runner.state
    return copy.deepcopy({
        "model": st.model.state_dict(),
        "optimizer": st.optimizer.state_dict(),
        "scheduler": st.scheduler.state_dict(), "step": st.step,
        "generator": st.generator.get_state()})


def assert_same_state(a, b):
    assert a["step"] == b["step"]
    assert a["scheduler"] == b["scheduler"]
    assert torch.equal(a["generator"], b["generator"])
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_train_save_resume_prefers_epoch(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.engine.runner import Runner

    _, cfg = tiny(data_root, log_every=1)
    runner = Runner(cfg, log_dir=str(tmp_path), device="cpu")
    runner.train(max_iters=2)
    assert runner.state.step == 2
    recs = [json.loads(l) for l in open(tmp_path / "train.jsonl")]
    assert [r["iter"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["skipped_nan"] == 0.0
               for r in recs)
    save_model(str(tmp_path), runner.state, "epoch_1")
    saved = port_state(runner)
    runner.train_step(runner.state, runner._device_batch(next(iter(
        runner_loader(runner)))))
    save_model(str(tmp_path), runner.state, "best")  # newer, but not epoch_N

    fresh = Runner(cfg, log_dir=str(tmp_path), device="cpu")
    assert fresh.resume_latest()
    assert_same_state(port_state(fresh), saved)
    empty = Runner(cfg, log_dir=str(tmp_path / "none"), device="cpu")
    assert not empty.resume_latest()


def runner_loader(runner):
    from lanemapping_tpu_torch.data.loader import build_dataloader
    return build_dataloader(runner.cfg.dataset.train, runner.cfg)


def test_load_network_filtered_keeps_matching_shapes(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.checkpoint import (
        load_network_filtered, save_model)
    from lanemapping_tpu_torch.engine.runner import Runner

    _, cfg = tiny(data_root)
    src = Runner(cfg, log_dir=str(tmp_path / "src"), device="cpu")
    path = save_model(str(tmp_path / "src"), src.state, "epoch_1")
    sd = src.model.state_dict()
    pth = str(tmp_path / "ref.pth")
    bad = "heads.proposal_confidence.1.weight"
    torch.save({"net": {"module." + k: (torch.zeros(3, 3) if k == bad
                                        else v) for k, v in sd.items()}},
               pth)
    cfg.seed = 99  # other initial weights
    for ckpt in (path, pth):
        dst = Runner(cfg, log_dir=str(tmp_path / "dst"), device="cpu")
        before = dst.model.state_dict()[bad].clone()
        load_network_filtered(ckpt, dst.state)
        got = dst.model.state_dict()
        same = [k for k in sd if torch.equal(got[k], sd[k])]
        if ckpt == pth:
            assert torch.equal(got[bad], before)
            assert set(sd) - set(same) == {bad}
        else:
            assert set(same) == set(sd)
        assert dst.state.step == 0


def test_nan_guard_skips_the_update(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.runner import Runner

    _, cfg = tiny(data_root)
    runner = Runner(cfg, log_dir=str(tmp_path), device="cpu")
    batch = next(iter(runner_loader(runner)))
    runner.train_step(runner.state, runner._device_batch(batch))
    before = port_state(runner)
    lr = runner.state.optimizer.param_groups[0]["lr"]
    db = runner._device_batch(batch)
    proj = db["proj"].float() / 255.0
    proj[0, 5, 7, 0] = float("nan")
    db["proj"] = proj
    stats = runner.train_step(runner.state, db)
    assert stats["skipped_nan"] == 1.0 and not torch.isfinite(stats["loss"])
    after = port_state(runner)
    assert after["step"] == before["step"] + 1
    after["step"] = before["step"]
    assert_same_state(after, before)
    assert runner.state.optimizer.param_groups[0]["lr"] == lr


def test_validate_matches_jax_metrics(data_root, tmp_path):
    """The port's ``validate`` against the JAX Runner's ``_validate_lanes``
    fed the port's decodes: the same keys and values, and ``best`` saved
    on the first pass."""
    from lanemapping_tpu.data.loader import build_dataloader as jax_loader
    from lanemapping_tpu.engine.runner import Runner as JaxRunner
    from lanemapping_tpu_torch.engine.runner import Runner

    cfg_j, cfg_t = tiny(data_root)
    runner = Runner(cfg_t, log_dir=str(tmp_path), device="cpu")
    metrics = runner.validate()
    assert os.path.isdir(tmp_path / "ckpt" / "best")
    assert runner.best_metric == metrics["composite"]

    stub = object.__new__(JaxRunner)
    stub.cfg, stub.state = cfg_j, None
    stub._eval_input = lambda batch: batch
    stub._eval_decode = lambda state, batch: {
        k: v.numpy() for k, v in runner._eval_decode(batch).items()}
    split = cfg_j.dataset.get("val") or cfg_j.dataset.test
    want = stub._validate_lanes(jax_loader(split, cfg_j, is_train=False),
                                None)
    assert set(metrics) == set(want)
    assert {"coor_f1", "endp_f1", "composite", "semantic_f1"} <= set(want)
    for k in want:
        assert metrics[k] == pytest.approx(want[k], abs=1e-12), k
    assert json.loads(open(tmp_path / "val.jsonl").readline())["epoch"] == 0


def test_train_cli_runs_on_cpu(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.checkpoint import save_model
    from lanemapping_tpu_torch.tools import train

    runner = train.main([TINY, f"dataset.train.data_root={data_root}",
                         f"dataset.val.data_root={data_root}",
                         f"dataset.test.data_root={data_root}",
                         f"log_dir={tmp_path}", "log_every=1", "--device",
                         "cpu", "--max-iters", "2"])
    assert runner.state.step == 2 and runner.device.type == "cpu"
    (run_dir,) = os.listdir(tmp_path)
    assert os.path.isfile(tmp_path / run_dir / "tiny_test.py")
    assert len(open(tmp_path / run_dir / "train.jsonl").readlines()) == 2
    save_model(str(tmp_path / run_dir), runner.state, "epoch_1")
    resumed = train.main([TINY, f"dataset.train.data_root={data_root}",
                          "--device", "cpu", "--max-iters", "1", "--resume",
                          str(tmp_path / run_dir)])
    assert resumed.state.step == 3  # 2 restored, 1 more
    assert os.listdir(tmp_path) == [run_dir]


def test_lane_mapper_map_directory_and_evaluate(data_root, tmp_path):
    from lanemapping_tpu_torch import LaneMapper

    _, cfg = tiny(data_root)
    mapper = LaneMapper(cfg, device="cpu", log_dir=str(tmp_path / "log"))
    lanes_dir = mapper.map_directory(data_root, str(tmp_path / "out"))
    assert sorted(os.listdir(lanes_dir)) == sorted(
        f"{190000 + i:06d}_{i:04d}"[:11] + ".json" for i in range(8))
    metrics = mapper.evaluate(data_root, split="test")
    assert {"coor_f1", "endp_f1", "composite"} <= set(metrics)
    # as in the JAX package, a params dir that is not there stops at 2-D
    # (the lift itself: tests/test_torch_port_map3d.py)
    out = mapper.map_directory(data_root, str(tmp_path / "o"),
                               params_dir=str(tmp_path / "absent"))
    assert os.listdir(tmp_path / "o") == ["lanes_2d"] and os.listdir(out)


def test_dropout_draws_from_the_train_state_generator(data_root, tmp_path):
    """With dropout set, the masks come from the train state's generator
    (seeded from ``cfg.seed``): two Runners of one seed take the same
    step, another seed another one."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.models.norm import Dropout

    losses = []
    for i, seed in enumerate((4, 4, 5)):
        _, cfg = tiny(data_root)
        cfg.backbone.dropout = cfg.backbone.emb_dropout = 0.3
        runner = Runner(cfg, log_dir=str(tmp_path / str(i)), device="cpu")
        drops = [m for m in runner.model.modules() if isinstance(m, Dropout)]
        assert drops and all(m.generator is runner.state.generator
                             for m in drops)
        runner.state.generator.manual_seed(seed)
        batch = next(iter(runner_loader(runner)))
        stats = runner.train_step(runner.state, runner._device_batch(batch))
        losses.append(float(stats["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_training_entry_points_default_to_cuda(data_root, tmp_path):
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools import train

    assert inspect.signature(Runner).parameters["device"].default == "cuda"
    assert train.parse_args([TINY]).device == "cuda"
    if torch.cuda.is_available():
        return
    _, cfg = tiny(data_root)
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(cfg, log_dir=str(tmp_path / "log"))
    assert not os.path.exists(tmp_path / "log")
