"""The engine's small gaps against the JAX package on the CPU:

- ``optimizer.mu_dtype="bfloat16"`` (`engine/optimizer.py::MuDtypeAdam`):
  Adam and AdamW for 3 steps against optax's ``adam`` / ``adamw`` with
  ``mu_dtype``, jitted as the JAX train step runs it (an eager call rounds
  ``b1 * mu`` to bf16, XLA keeps it in float32), under
  ``jax.enable_x64(True)`` (optax rounds its bias correction and schedule
  to float32 before use either way; x64 keeps the schedule's cosine in
  float64, as the port computes it): the stored bf16 first moments equal,
  the float32 second moments and parameters within rel 1e-6 (float32
  rounding of one update);
- an optax ``mu_dtype`` state carried into the port's train state by
  ``tools/from_jax.adam_state_from_jax`` (bf16 ``exp_avg``), then one more
  step of both: the tiny config's parameters within rel-max 1e-6;
- ``utils/logger.py``: ``MetricWriter``, ``trace_span`` inside a torch
  profile, ``start/stop_profiler_trace``;
- the Runner's TensorBoard scalars, and its records when tensorboard does
  not import.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import configs, random_variables

SHAPES = [(7, 5), (13,), (3, 4, 2)]


def opt_configs(opt_type):
    cfgs = configs()
    for cfg in cfgs:
        cfg.merge_from_dict({"optimizer": {
            "_delete_": True, "type": opt_type, "lr": 3e-3,
            "mu_dtype": "bfloat16", "weight_decay": 1e-2},
            "scheduler.T_max": 10})
    return cfgs


def jitted_update(tx):
    """(grads, opt state, params) -> (new params, new state), jitted."""
    @jax.jit
    def update(g, st, p):
        up, st = tx.update(g, st, p)
        return jax.tree.map(lambda a, u: a + u, p, up), st
    return update


@pytest.mark.parametrize("opt_type", ["Adam", "AdamW"])
def test_mu_dtype_adam_matches_optax(opt_type):
    from lanemapping_tpu.engine.optimizer import build_optimizer as jax_opt
    from lanemapping_tpu_torch.engine.optimizer import (MuDtypeAdam,
                                                        build_optimizer)

    cfg_j, cfg_t = opt_configs(opt_type)
    rng = np.random.RandomState(0)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 10 ** rng.uniform(-3, 1)
              for s in SHAPES] for _ in range(3)]
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = build_optimizer(cfg_t, params)
    assert isinstance(opt, MuDtypeAdam) and opt.mu_dtype == torch.bfloat16
    del cfg_t.optimizer["mu_dtype"]  # without it, torch.optim's own
    assert type(build_optimizer(cfg_t, params)[0]) is getattr(
        torch.optim, opt_type)
    with jax.enable_x64(True):
        update = jitted_update(jax_opt(cfg_j))
        jp = [jnp.asarray(a) for a in init]
        st = jax_opt(cfg_j).init(jp)
        for k, g in enumerate(grads):
            jp, st = update(g, st, jp)
            for p, a in zip(params, g):
                p.grad = torch.from_numpy(a)
            opt.step()
            sched.step()
            adam = st[0]
            for i, p in enumerate(params):
                s = opt.state[p]
                assert s["exp_avg"].dtype == torch.bfloat16
                assert str(adam.mu[i].dtype) == "bfloat16"
                np.testing.assert_array_equal(
                    s["exp_avg"].float().numpy(),
                    np.asarray(adam.mu[i], np.float32), err_msg=f"{k} {i}")
                np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                           np.asarray(adam.nu[i]), rtol=1e-6)
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jp[i]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{k} {i}")
        assert int(adam.count) == 3


def test_mu_dtype_state_carries_from_optax(tmp_path):
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu.engine.optimizer import build_optimizer as jax_opt
    from lanemapping_tpu_torch.engine.state import create_train_state
    from lanemapping_tpu_torch.tools.from_jax import (adam_state_from_jax,
                                                      load_jax_weights,
                                                      params_from_jax,
                                                      rules_for)

    cfg_j, cfg_t = opt_configs("Adam")
    jm = lm.build_model(cfg_j)
    variables = random_variables(jm, (jnp.zeros((1, 192, 192, 3)),), 0)
    model = load_jax_weights(lmt.build_model(cfg_t), variables["params"],
                             variables["batch_stats"], cfg_t)
    state = create_train_state(model, cfg_t)
    rng = np.random.RandomState(1)
    grads = [jax.tree.map(lambda a: (1e-2 * rng.randn(*a.shape)).astype(
        np.float32), variables["params"]) for _ in range(2)]
    with jax.enable_x64(True):
        update = jitted_update(jax_opt(cfg_j))
        jp = jax.tree.map(jnp.asarray, variables["params"])
        jp, st = update(grads[0], jax_opt(cfg_j).init(jp), jp)
        host = jax.device_get((jp, st[0].mu, st[0].nu))
        model.load_state_dict(params_from_jax(host[0], {}, rules_for(cfg_t)),
                              strict=False)
        adam_state_from_jax(state, jax.tree.map(
            lambda a: np.asarray(a, np.float32), host[1]), host[2], 1, cfg_t)
        jp = jax.device_get(update(grads[1], st, jp)[0])
    assert all(s["exp_avg"].dtype == torch.bfloat16
               for s in state.optimizer.state.values())
    g_sd = params_from_jax(grads[1], {}, rules_for(cfg_t))
    for n, p in model.named_parameters():
        p.grad = g_sd[n].view(p.shape).clone()
    state.optimizer.step()
    want = params_from_jax(jp, {}, rules_for(cfg_t))
    worst = max(float((p.detach() - want[n]).abs().max()
                      / max(1e-3, float(want[n].abs().max())))
                for n, p in model.named_parameters())
    assert worst < 1e-6


def test_metric_writer_trace_span_and_profiler_trace(tmp_path):
    from lanemapping_tpu_torch.utils.logger import (MetricWriter, get_logger,
                                                    start_profiler_trace,
                                                    stop_profiler_trace,
                                                    trace_span)

    w = MetricWriter(str(tmp_path / "m"))
    w.write("train", {"iter": 0, "loss": 1.5})
    w.write("train", {"iter": 1, "loss": 1.25})
    with open(tmp_path / "m" / "train.jsonl") as f:
        assert [json.loads(line) for line in f] == [
            {"iter": 0, "loss": 1.5}, {"iter": 1, "loss": 1.25}]
    assert get_logger() is get_logger()

    with torch.profiler.profile() as prof:
        with trace_span("lane_span"):
            torch.ones(8).sum()
    assert "lane_span" in {e.key for e in prof.key_averages()}
    start_profiler_trace(str(tmp_path))
    with trace_span("traced_span"):
        torch.ones(8).sum()
    path = stop_profiler_trace()
    assert path == str(tmp_path / "profile" / "trace.json")
    with open(path) as f:
        assert "traced_span" in f.read()


def test_runner_tensorboard_scalars(tmp_path, monkeypatch):
    from lanemapping_tpu_torch.engine.runner import Runner

    _, cfg = configs()
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(("dir", log_dir))

        def add_scalar(self, tag, value, step):
            written.append((tag, value, step))

    fake = types.ModuleType("torch.utils.tensorboard")
    fake.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", fake)
    runner = Runner(cfg, log_dir=str(tmp_path / "b"), device="cpu")
    runner._log("train", {"epoch": 0, "iter": 3, "loss": 0.5})
    runner._log("train", {"epoch": 0, "iter": 4, "loss": 0.25})
    assert written == [("dir", str(tmp_path / "b")), ("train/loss", 0.5, 3),
                       ("train/loss", 0.25, 4)]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    runner = Runner(cfg, log_dir=str(tmp_path / "c"), device="cpu")
    runner._log("val", {"epoch": 2, "composite": 0.25})
    with open(os.path.join(tmp_path, "c", "val.jsonl")) as f:
        assert json.loads(f.read()) == {"epoch": 2, "composite": 0.25}
