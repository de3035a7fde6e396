"""The port's Runner on 2 gloo ranks against the JAX Runner on its
``mesh_shape`` mesh (``data=2`` of the tests' 8 virtual CPU devices), on
the CPU at ``configs/tiny_test.py``: ``Runner.train`` for 4 steps of
global batch 8 and ``validate(max_batches=2)`` from the same seeded
weights (numpy-drawn flax variables, crossed with `tools/from_jax.py`),
both packages on the same 32-tile synthetic dataset, held to the bars of
the root `tools/multihost_test.py`: every logged loss within rel 1e-3, the
parameter digest (the sum of ``|p|``) within rel 1e-5, every validation
metric within abs 5e-2.  The port's ranks run while the JAX Runner does.

Both train at a tenth of the config's lr, as the single-process training
parity tests do: at random weights the float32 gradient of the encoder
carries rounding noise (the biases ahead of a BatchNorm have a gradient
of pure rounding; the same port run at another intra-op thread count
gives another gradient), and Adam turns that noise into lr-sized
updates, so at the config's lr the loss curves of two correct runs part
beyond the loss bar within a few steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_dist_workers import join_all, spawn
from torch_port_helpers import (TINY, configs, random_variables,
                                wire_data_root)

from lanemapping_tpu_torch.tools import multihost_test

STEPS, BATCH = 4, 8
LR = {"optimizer.lr": 2.1e-5}  # a tenth of the config's


def jax_runner(cfg_j, log_dir, variables):
    """The JAX Runner with ``variables`` as its initial state (flax's own
    initialisers cost ~20 s on this CPU; the state is what they would
    build, from other draws)."""
    import lanemapping_tpu.engine.runner as jr
    from lanemapping_tpu.engine.state import TrainState

    def create(model, tx, rng, example):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return TrainState(params=params, batch_stats=jax.tree.map(
            jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "create_train_state", create)
        runner = jr.Runner(cfg_j, log_dir=log_dir)
    runner._tb = None  # the run is read from train.jsonl
    return runner


def test_two_rank_runner_matches_the_jax_runner(tmp_path):
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    root = multihost_test.make_dataset(str(tmp_path / "tiles"))
    cfg_j, cfg_t = configs(TINY)
    img = cfg_j.list_img_size_xy[0]
    variables = random_variables(lm.build_model(cfg_j),
                                 (jnp.zeros((1, img, img, 3)),), seed=0)
    model = lmt.build_model(cfg_t)
    load_jax_weights(model, variables["params"], variables["batch_stats"],
                     cfg_t)
    init = str(tmp_path / "init.pth")
    torch.save(model.state_dict(), init)

    out = str(tmp_path / "port.json")
    ranks = spawn(multihost_test.member, 2, root, str(tmp_path / "port"),
                  out, "cpu", STEPS, BATCH, LR, 1, init)

    log_j = str(tmp_path / "jax")
    cfg = multihost_test.build_cfg(root, log_j, BATCH, overrides=LR)
    for k in ("batch_size", "workers", "log_every", "log_dir", "epochs",
              "eval_ep", "save_ep"):
        cfg_j[k] = cfg[k]
    cfg_j.merge_from_dict(LR)
    wire_data_root(cfg_j, root)
    assert tuple(cfg_j.mesh_shape.items()) == (("data", 2),)
    jr = jax_runner(cfg_j, log_j, variables)
    assert jr.mesh.devices.size == 2
    jr.train(max_iters=STEPS)
    val = jr.validate(max_batches=2)
    with open(os.path.join(log_j, "train.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    digest = float(sum(np.abs(np.asarray(x, np.float64)).sum()
                       for x in jax.tree.leaves(
                           jax.device_get(jr.state.params))))

    join_all(ranks)
    with open(out) as f:
        port = json.load(f)
    assert port["world"] == 2 and len(losses) == STEPS
    cmp = multihost_test.compare(
        {"losses": losses, "param_digest": digest, "val": val}, port)
    assert cmp["pass"], cmp
