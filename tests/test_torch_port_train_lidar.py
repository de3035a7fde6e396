"""The port's LiDAR train step against the JAX package's on the CPU, at
``configs/tiny_test_lidar.py`` with ``train_compute_dtype="bfloat16"``:
the JAX step casts the weights to bf16 and feeds the float32 points, so
flax promotes and the whole step computes float32 on bf16-ROUNDED weights
(gradients rounded to bf16 on their way back through the cast).  The port
reproduces that (`engine/state.py::make_train_step`), and here both
packages take three steps from one mid-training Adam state
(`torch_port_helpers.mid_training_adam`, no element excluded) on the same
batch of a synthetic LaserLane dataset with clouds: the loss trajectory
within rel 1e-4, every parameter and BatchNorm buffer within rel-max
1e-4.  The learning rate is a tenth of the config's, as in
`test_torch_port_train_step.py`.

The z-fold voxelizer (K1z on the card; its plain version here) runs inside
the differentiated forward on points, not parameters: its output enters
autograd as a leaf.
"""

import jax
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_device_batch, jax_grads, jax_train_state,
                                jax_train_step, mid_training_adam,
                                port_batch_numpy, port_runner, rel_max_err,
                                state_dict_np, tiny_lidar_models,
                                wire_data_root, with_adam_state)

LR = 2.1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3, with_points=True,
                     points_per_tile=4096)
    jmodel, variables, _, cfg_j, cfg_t = tiny_lidar_models(
        seed=1, train_compute_dtype="bfloat16")
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.scheduler.T_max = 1000
        cfg.optimizer.lr = LR
    batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    tx, jstate = jax_train_state(cfg_j, variables)
    return dict(jmodel=jmodel, variables=variables, cfg_j=cfg_j, cfg_t=cfg_t,
                batch=batch, tx=tx, jstate=jstate,
                log_dir=tmp_path_factory.mktemp("logs"))


def test_shipped_lidar_batch_matches_jax(setup):
    runner = port_runner(setup["cfg_t"], setup["variables"],
                         setup["log_dir"])
    db = runner._device_batch(setup["batch"])
    assert "proj" not in db and db["points"].dtype == torch.float32
    assert db["endp_map"].dtype == torch.bfloat16  # bf16 training, no u8
    db = port_batch_numpy(db)
    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    assert set(db) == set(jdb)
    for k in jdb:
        np.testing.assert_array_equal(db[k], np.asarray(jdb[k], db[k].dtype),
                                      err_msg=k)


def test_step_runs_float32_on_bf16_rounded_weights(setup):
    """Inside the step every layer sees float32 weights that are bf16
    values, and the voxelized plane that feeds the encoder is a leaf."""
    from lanemapping_tpu_torch.kernels import voxel_bin

    runner = port_runner(setup["cfg_t"], setup["variables"],
                         setup["log_dir"])
    enc = runner.model.pcencoder.zfold_encoder
    seen = {}

    def pre(mod, inp):
        seen["vox"] = inp[0]
        seen["stem"] = mod.stem.weight

    enc.register_forward_pre_hook(pre)
    calls = []
    orig = voxel_bin.voxel_bin_mean_ref
    voxel_bin.voxel_bin_mean_ref = lambda *a: calls.append(1) or orig(*a)
    try:
        stats = runner.train_step(runner.state,
                                  runner._device_batch(setup["batch"]))
    finally:
        voxel_bin.voxel_bin_mean_ref = orig
    assert calls == [1] and stats["skipped_nan"] == 0.0
    vox, w = seen["vox"], seen["stem"]
    assert vox.grad_fn is None and not vox.requires_grad
    assert vox.dtype == torch.float32 and w.dtype == torch.float32
    assert torch.equal(w, w.to(torch.bfloat16).float())
    assert w.grad_fn is not None  # the cast, differentiated
    master = runner.model.pcencoder.zfold_encoder.stem.weight
    assert master.dtype == torch.float32 and master.grad is not None
    assert torch.equal(master.grad, master.grad.to(torch.bfloat16).float())


def test_three_lidar_steps_match_jax(setup):
    from lanemapping_tpu_torch.tools.from_jax import (adam_state_from_jax,
                                                      params_from_jax,
                                                      rules_for)

    cfg_t, variables = setup["cfg_t"], setup["variables"]
    runner = port_runner(cfg_t, variables, setup["log_dir"])
    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    grads = jax.device_get(jax_grads(setup["jmodel"], setup["cfg_j"])(
        setup["jstate"].params, setup["jstate"].batch_stats, jdb)[1])
    mu, nu, count = mid_training_adam(grads, seed=2)
    adam_state_from_jax(runner.state, mu, nu, count, cfg_t)
    jstate = setup["jstate"].replace(opt_state=with_adam_state(
        setup["jstate"].opt_state, mu, nu, count))
    jstep = jax_train_step(setup["jmodel"], setup["tx"], setup["cfg_j"])
    losses, jlosses = [], []
    for _ in range(3):
        stats = runner.train_step(runner.state,
                                  runner._device_batch(setup["batch"]))
        jstate, jstats = jstep(jstate, jdb, jax.random.PRNGKey(0))
        losses.append(float(stats["loss"]))
        jlosses.append(float(jstats["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]

    want = params_from_jax(jax.device_get(jstate.params),
                           jax.device_get(jstate.batch_stats),
                           rules_for(cfg_t))
    got = state_dict_np(runner.model)
    for k, w in want.items():
        assert rel_max_err(got[k], w.numpy()) < 1e-4, k
