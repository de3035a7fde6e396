"""The flagship's bf16 training step, the port against the JAX package,
at ``configs/tiny_test.py`` (192 px) with ``train_compute_dtype =
"bfloat16"`` as the flagship ships it: the same weights and batch, with
the JAX package in float64 (`torch_port_make_golden.float64_jax`) as the
reference both are measured from.

- Step 0's terms and gradient at weight seeds 0 and 1, pooled
  (`torch_port_golden.bf16_ratios`):
  d_port / d_jax_bf16 over every gradient group (module) and every
  non-zero loss term, each pool's median within 1.5 and its 90th
  percentile within ``POOL_Q_FACTOR`` (measured here: gradient median
  0.94, 90th percentile 1.16; terms median 0.71, 90th percentile 1.39).
- The train-mode forward in bf16, module by module (each module's first
  output): the port's relative L2 distance from JAX's float32 forward
  within 1.5x JAX bf16's own + 1e-3 (measured here: at most 1.11x; at
  full width 1.29-1.45x, where XLA's CPU compiler skips bf16 roundings
  between fused ops, and 1.00-1.08x with ``XLA_FLAGS=
  --xla_allow_excess_precision=false``).
- The loss casts: the port's loss on JAX's bf16 head outputs equals JAX's
  loss on them within rel 1e-5 (measured: 2.7e-6, the fused seg focal's
  float32 sum; a bf16 rounding in another place would move a term by
  ~1e-3).

``JAX_PLATFORMS=cpu python tests/test_torch_port_train_bf16.py [--f64]
[--full ROOT]`` prints the module-by-module table (``--f64``: measured
from JAX in float64; ``--full``: the flagship at 1152 px on a T0 set
under ROOT, `torch_port_golden.train_dataset`).
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_golden as G
import torch_port_make_golden as M
from torch_port_helpers import (jax_device_batch, tiny_models,  # noqa: F401
                                two_threads, wire_data_root)

SEEDS = (0, 1)
MODULE_SLOPE, MODULE_FLOOR = 1.5, 1e-3


def tiny_setup(root, seed):
    from lanemapping_tpu_torch.data.loader import build_dataloader
    jmodel, variables, tmodel, cfg_j, cfg_t = tiny_models(seed=seed)
    for cfg in (cfg_j, cfg_t):
        wire_data_root(cfg, root)
        cfg.batch_size = 2
        cfg.scheduler.T_max = 1000
        cfg.train_compute_dtype = "bfloat16"
    batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    return jmodel, variables, tmodel, cfg_j, cfg_t, batch


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=4, img=192, seed=3)
    return root


def bf16_step(root, seed, log_dir):
    """(the port's run, the golden-form JAX runs, the digest plan) of one
    bf16 step at weight ``seed``: step 0's terms and gradient of the JAX
    package in float64 and in bf16 (its differentiated function,
    `torch_port_make_golden.grads_fn`) and of the port's
    ``Runner.train_step``."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights
    jmodel, variables, _, cfg_j, cfg_t, batch = tiny_setup(root, seed)
    jdb = jax_device_batch(cfg_j, batch)
    golden = {}
    for key, cast in (("ref", "none"), ("jax", "bf16")):
        ctx = M.float64_jax() if key == "ref" else contextlib.nullcontext()
        with ctx:
            params, stats = variables["params"], variables["batch_stats"]
            if key == "ref":
                params, stats = M.to_f64(params), M.to_f64(stats)
            terms, g, _ = M.grads_fn(jmodel, cfg_j, cast)(params, stats, jdb)
            golden[key] = {"terms": G.term_vector(jax.device_get(terms))[None],
                           "grads": M.torch_layout(g, {}, cfg_j)}
    plan = G.digest_plan({k: v.shape for k, v in
                          golden["ref"]["grads"].items()})
    golden = {k: {f"terms_{k}": v["terms"], **G.pack_digest(
        "g" + k, G.vector_digest(plan, v["grads"]))}
        for k, v in golden.items()}
    runner = Runner(cfg_t, log_dir=str(log_dir), device="cpu")
    load_jax_weights(runner.model, variables["params"],
                     variables["batch_stats"], cfg_t)
    return G.run_steps(runner, batch, steps=1), golden, plan


def test_bf16_step_meets_the_pooled_rule(root, tmp_path, two_threads):
    pools = {"gradient": [], "terms": []}
    for seed in SEEDS:
        run, golden, plan = bf16_step(root, seed, tmp_path / str(seed))
        r = G.bf16_ratios(run, golden, plan)
        for k in pools:
            pools[k] += r[k]
        # the rule is not empty: bf16 is far from float64 in both packages
        assert r["term_floor_rel"] > 1e-4
    for k, pool in pools.items():
        G.check_pooled(G.pooled_figures(pool), f"tiny bf16 {k}")


def module_distances(jmodel, variables, tmodel, cfg_t, jdb, ref="f32"):
    """[(torch module, d_jax, d_port)]: per module of the train-mode
    forward (its first output), the relative L2 distance of JAX's bf16
    and the port's bf16 from JAX's forward in ``ref`` (``f32``, or
    ``f64`` under `torch_port_make_golden.float64_jax`)."""
    from lanemapping_tpu.engine.state import model_input as jax_input
    from lanemapping_tpu_torch.engine.state import model_input
    from lanemapping_tpu_torch.tools.from_jax import rules_for

    def japply(cast):
        p, bs = variables["params"], variables["batch_stats"]
        if cast == "bf16":
            p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        if cast == "f64":
            p, bs = M.to_f64(p), M.to_f64(bs)
        _, st = jax.jit(lambda p, x: jmodel.apply(
            {"params": p, "batch_stats": bs}, x,
            train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True))(
                p, jax_input(jdb, False,
                             jnp.bfloat16 if cast == "bf16" else None))
        return jax.tree.map(lambda a: np.asarray(a, np.float64),
                            st["intermediates"])

    if ref == "f64":
        with M.float64_jax():
            i32 = japply("f64")
    else:
        i32 = japply("f32")
    i16 = japply("bf16")
    seen = {}

    def keep(name):
        def hook(module, inputs, out):
            if isinstance(out, torch.Tensor) and name not in seen:
                seen[name] = out.detach().float()
        return hook

    hooks = [m.register_forward_hook(keep(n))
             for n, m in tmodel.named_modules() if n]
    tmodel.train()
    params = {n: p.to(torch.bfloat16) for n, p in tmodel.named_parameters()}
    with torch.no_grad():
        torch.func.functional_call(tmodel, params, (model_input(
            {"proj": torch.from_numpy(np.array(jdb["proj"]))}, False,
            torch.bfloat16),))
    for h in hooks:
        h.remove()

    def get(tree, path):
        for key in path.split("/"):
            if not isinstance(tree, dict) or key not in tree:
                return None
            tree = tree[key]
        return tree

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))

    rows = {}
    for t_key, j_path, tf in rules_for(cfg_t):
        tmod = t_key if tf == "bn" else t_key.rsplit(".", 1)[0]
        jmod = j_path if tf == "bn" else j_path.rsplit("/", 1)[0]
        a32, a16 = get(i32, jmod), get(i16, jmod)
        if tmod in rows or tmod not in seen or not isinstance(a32, dict) \
                or "__call__" not in a32:
            continue
        want = np.asarray(a32["__call__"][0], np.float32)
        got = seen[tmod].numpy()
        if got.ndim == 4 and got.shape != want.shape:
            got = got.transpose(0, 2, 3, 1)
        if got.shape == want.shape:
            rows[tmod] = (rel(a16["__call__"][0], want), rel(got, want))
    return [(k, *v) for k, v in rows.items()]


def test_bf16_forward_rounds_as_jax_module_by_module(root, two_threads):
    jmodel, variables, tmodel, cfg_j, cfg_t, batch = tiny_setup(root, 1)
    rows = module_distances(jmodel, variables, tmodel, cfg_t,
                            jax_device_batch(cfg_j, batch))
    assert len(rows) > 80
    for name, d_jax, d_port in rows:
        assert d_port <= MODULE_SLOPE * d_jax + MODULE_FLOOR, (name, d_jax,
                                                               d_port)
    assert min(d for _, d, _ in rows) > 1e-4  # bf16 rounds every module


def test_bf16_loss_casts_as_jax(root, two_threads):
    """The losses of the same bf16 head outputs: the port's casts are
    JAX's (the JAX package's float32 sum of the fused seg focal drifts by
    up to 1.2e-5 from float64, the port's by 1e-7)."""
    from lanemapping_tpu.engine.state import model_input as jax_input
    from lanemapping_tpu.models.head_losses import (column_proposal_loss,
                                                    head_hparams)
    from lanemapping_tpu_torch.models import head_losses as port_losses
    jmodel, variables, _, cfg_j, cfg_t, batch = tiny_setup(root, 1)
    jdb = jax_device_batch(cfg_j, batch)
    p = jax.tree.map(lambda x: x.astype(jnp.bfloat16), variables["params"])
    # two programs, so the bf16 outputs are rounded before the loss reads
    # them (in one, XLA would keep them at float32 precision)
    out = jax.jit(lambda p, x: jmodel.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, x,
        train=True, mutable=["batch_stats"])[0])(
            p, jax_input(jdb, False, jnp.bfloat16))
    want = jax.jit(lambda o: column_proposal_loss(
        o, jdb, head_hparams(cfg_j)))(out)["loss_stats"]
    tout = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            for k, v in out.items()}
    tdb = {k: torch.from_numpy(np.array(v)) for k, v in jdb.items()}
    got = port_losses.column_proposal_loss(
        tout, tdb, port_losses.head_hparams(cfg_t))["loss_stats"]
    assert tout["cls2"].dtype == torch.bfloat16
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                   atol=1e-9, err_msg=k)


def main(argv):
    """Print the module-by-module table (tiny, or ``--full ROOT``; with
    ``--f64`` first, from JAX in float64 instead of float32)."""
    ref = "f64" if argv[:1] == ["--f64"] else "f32"
    argv = argv[1:] if ref == "f64" else argv
    import lanemapping_tpu as lm
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.models.nets import build_model
    if argv[:1] == ["--full"]:
        root = argv[1]
        if not os.path.isdir(os.path.join(root, "las")):
            from lanemapping_tpu_torch.data import synthetic
            G.train_dataset(root, synthetic)
        cfg_j, cfg_t = M.train_config("flagship", root), \
            G.port_train_config("flagship", root)
        variables = G.draw_variables(G.load_manifest("flagship"),
                                     G.WEIGHT_SEEDS["flagship"])
        jmodel = lm.build_model(cfg_j)
        tmodel = G.load_seeded_weights(build_model(cfg_t, seed=0),
                                       "flagship", cfg_t)
        batch = next(iter(build_dataloader(cfg_t.dataset.train, cfg_t)))
    else:
        import tempfile
        from lanemapping_tpu_torch.data.synthetic import generate_dataset
        root = tempfile.mkdtemp()
        generate_dataset(root, n_tiles=4, img=192, seed=3)
        jmodel, variables, tmodel, cfg_j, cfg_t, batch = tiny_setup(root, 1)
    rows = module_distances(jmodel, variables, tmodel, cfg_t,
                            jax_device_batch(cfg_j, batch), ref)
    print(f"reference: JAX in {ref}")
    for name, d_jax, d_port in rows:
        print(f"{name:48s} d_jax {d_jax:.3e} d_port {d_port:.3e} "
              f"ratio {d_port / d_jax:.3f}")
    r = np.array([d_port / d_jax for _, d_jax, d_port in rows])
    print(f"{len(rows)} modules: ratio median {np.median(r):.3f}, max "
          f"{r.max():.3f} ({rows[int(np.argmax(r))][0]})")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main(sys.argv[1:])
