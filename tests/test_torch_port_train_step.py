"""The port's train step against the JAX package's on the CPU, at
``configs/tiny_test.py`` in float32: the same weights (``random_variables``
-> ``load_jax_weights``), the same batch of a synthetic LaserLane dataset,
shipped by each package's Runner.

- one step in float32: the 10 loss terms within rel 1e-5, the BatchNorm
  running statistics within rel-max 1e-5 (torch's own unbiased-variance
  rule would miss that bar), and the gradient of every parameter of the
  correlator and the head within rel-max 2e-3;
- the same gradients in float64, every parameter within rel-max 2e-3.
  The image encoder's float32 gradients are ill-conditioned in both
  packages alike (the backward through its 36 batch-statistics
  BatchNorms): against a float64 evaluation, each package's float32
  gradients of the encoder are off by up to 3-11 % rel-max (weight seeds
  0-7), the correlator's and the head's by < 1e-3, so the encoder is held
  to the JAX package in float64;
- three steps from one mid-training Adam state (carried into torch by
  ``adam_state_from_jax``) at a tenth of the config's lr (``LR``): the
  loss trajectory within rel 1e-4 and every parameter and buffer within
  rel-max 1e-4.  No element is excluded as
  "noise level": the carried second moment is set from each leaf's
  gradient scale, floored at 1e-3 of the largest (`mid_training_adam`),
  so Adam cannot scale a gradient that is rounding noise in both packages
  (a bias before a batch-statistics BatchNorm) up to a full lr step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import (jax_device_batch, jax_grads,
                                jax_train_state, jax_train_step,
                                mid_training_adam,
                                port_batch_numpy, port_runner, rel_max_err,
                                state_dict_np, tiny_models, wire_data_root,
                                with_adam_state)

# a tenth of the config's 2.1e-4: at the config's rate the random-init
# loss falls by ~17 % per step, and the float32 ill-conditioning of the
# encoder's gradient (above) parts the two packages by 1.3e-4 at step 3
LR = 2.1e-5

TERMS = ("proposal_loss", "ext_loss2", "cls_loss2", "cls_mean_loss2",
         "cls_smooth_loss2", "endp_loss", "orient_loss", "binary_seg_loss",
         "offset_loss", "semantic_seg_loss")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    # weight seed 1: the JAX package's float32 sum of the fused seg focal
    # (368,640 terms here) drifts from a float64 evaluation by 4.7e-6 to
    # 1.2e-5 over seeds 0-5 while the port stays within 1e-7 of it
    # (`test_torch_port_train_losses.py` holds the port to float64 there);
    # at seed 1 every term of both packages sits within 1e-6
    jmodel, variables, _, cfg_j, cfg_t = tiny_models(seed=1)
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.scheduler.T_max = 1000  # the tiny config decays to 0 in 4
        cfg.optimizer.lr = LR
    batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    tx, jstate = jax_train_state(cfg_j, variables)
    return dict(jmodel=jmodel, variables=variables, cfg_j=cfg_j, cfg_t=cfg_t,
                batch=batch, tx=tx, jstate=jstate,
                jstep=jax_train_step(jmodel, tx, cfg_j),
                jgrads=jax_grads(jmodel, cfg_j),
                log_dir=tmp_path_factory.mktemp("logs"))


def test_shipped_batch_matches_jax(setup):
    runner = port_runner(setup["cfg_t"], setup["variables"],
                         setup["log_dir"])
    db = port_batch_numpy(runner._device_batch(setup["batch"]))
    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    assert set(db) == set(jdb)
    for k in jdb:
        assert db[k].dtype == jdb[k].dtype, k
        np.testing.assert_array_equal(db[k], jdb[k], err_msg=k)
    assert db["proj"].shape[-1] == 1  # the mono squeeze


def test_one_step_matches_jax(setup):
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax, rules_for

    cfg_t, variables = setup["cfg_t"], setup["variables"]
    runner = port_runner(cfg_t, variables, setup["log_dir"])
    before = state_dict_np(runner.model)
    counts = {}  # values per channel each BatchNorm normalised
    for name, m in runner.model.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_hook(
                lambda mod, inp, out, name=name: counts.__setitem__(
                    name, inp[0].numel() // inp[0].shape[1]))
    db = runner._device_batch(setup["batch"])
    stats = runner.train_step(runner.state, db)

    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    (jloss, (jstats, jbs)), jgrads = setup["jgrads"](
        setup["jstate"].params, setup["jstate"].batch_stats, jdb)
    assert stats["skipped_nan"] == 0.0 and runner.state.step == 1
    for k in TERMS:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(stats["loss"]), float(jloss), rtol=1e-5)

    rules = rules_for(cfg_t)
    want_g = params_from_jax(jax.device_get(jgrads), {}, rules)
    got_g = {n: p.grad for n, p in runner.model.named_parameters()}
    assert set(got_g) == set(want_g)
    worst = max((rel_max_err(got_g[k].numpy(), want_g[k].numpy()), k)
                for k in want_g if not k.startswith("pcencoder."))
    assert worst[0] < 2e-3, worst

    # BatchNorm running statistics after the step (flax: biased variance)
    want_bs = params_from_jax({}, jax.device_get(jbs), rules)
    got = state_dict_np(runner.model)
    assert len(want_bs) >= 2 * 30
    gap = 0.0  # what torch's unbiased rule would add, largest over layers
    for k, want in want_bs.items():
        want = want.numpy()
        assert rel_max_err(got[k], want) < 1e-5, k
        n = counts[k.rsplit(".", 1)[0]]
        if k.endswith("running_var") and n > 1:
            var_b = (want - 0.9 * before[k]) / 0.1
            gap = max(gap, rel_max_err(want + 0.1 * var_b / (n - 1), want))
    assert gap > 1e-5, gap


def test_gradients_match_jax_in_float64(setup):
    """Every parameter gradient of one step, both packages in float64
    (the losses stay float32 in both, as they are written)."""
    from lanemapping_tpu.engine.state import model_input as jax_input
    from lanemapping_tpu_torch.engine.state import model_input
    from lanemapping_tpu_torch.tools.from_jax import params_from_jax, rules_for

    cfg_t, variables = setup["cfg_t"], setup["variables"]
    runner = port_runner(cfg_t, variables, setup["log_dir"])
    model = runner.model.double().train()
    db = runner._device_batch(setup["batch"])
    loss = runner._loss_fn(model(model_input(db).double()), db)["loss"]
    loss.backward()

    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        grads = jax.device_get(jax_grads(setup["jmodel"], setup["cfg_j"])(
            f64(variables["params"]), f64(variables["batch_stats"]),
            {**jdb, "proj": jax_input(jdb).astype(jnp.float64)})[1])
    want_g = params_from_jax(grads, {}, rules_for(cfg_t))
    worst = (0.0, None)
    for n, p in model.named_parameters():
        if p.grad is None:  # the endpoint branch no loss reads
            assert not want_g[n].numpy().any(), n
            continue
        worst = max(worst, (rel_max_err(p.grad.numpy(), want_g[n].numpy()),
                            n))
    assert worst[0] < 2e-3, worst


def test_three_steps_match_jax(setup):
    from lanemapping_tpu_torch.tools.from_jax import (adam_state_from_jax,
                                                      params_from_jax,
                                                      rules_for)

    cfg_t, variables = setup["cfg_t"], setup["variables"]
    runner = port_runner(cfg_t, variables, setup["log_dir"])
    jdb = jax_device_batch(setup["cfg_j"], setup["batch"])
    grads = jax.device_get(setup["jgrads"](
        setup["jstate"].params, setup["jstate"].batch_stats, jdb)[1])
    mu, nu, count = mid_training_adam(grads, seed=1)
    adam_state_from_jax(runner.state, mu, nu, count, cfg_t)
    jstate = setup["jstate"].replace(opt_state=with_adam_state(
        setup["jstate"].opt_state, mu, nu, count))
    losses, jlosses = [], []
    for _ in range(3):
        stats = runner.train_step(runner.state,
                                  runner._device_batch(setup["batch"]))
        jstate, jstats = setup["jstep"](jstate, jdb,
                                        jax.random.PRNGKey(0))
        losses.append(float(stats["loss"]))
        jlosses.append(float(jstats["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert runner.state.step == int(jstate.step) == 3
    assert runner.state.scheduler.last_epoch == count + 3

    want = params_from_jax(jax.device_get(jstate.params),
                           jax.device_get(jstate.batch_stats),
                           rules_for(cfg_t))
    got = state_dict_np(runner.model)
    start = state_dict_np(port_runner(cfg_t, variables,
                                      setup["log_dir"]).model)
    moved = 0
    for k, w in want.items():
        assert rel_max_err(got[k], w.numpy()) < 1e-4, k
        moved += not np.array_equal(start[k], w.numpy())
    assert moved == len(want)
