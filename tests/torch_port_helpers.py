"""Shared set-up for the tests that hold ``lanemapping_tpu_torch`` (the
PyTorch/CUDA port) to ``lanemapping_tpu`` (the JAX reference) on the CPU.

Weights and inputs come from numpy seeds and pass between the packages as
numpy arrays.  The flax variables are drawn directly in the shapes that
``jax.eval_shape(model.init)`` reports: running flax's own initialisers for
the tiny model costs ~20 s on this CPU, the shape trace ~1 s.
"""

import contextlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_test.py")
TINY_LIDAR = os.path.join(REPO, "configs", "tiny_test_lidar.py")


@pytest.fixture
def golden_threads(request):
    """A golden hold's intra-op thread count (``HOLD_THREADS``, or the
    test's parameter), restored after the test: PyTorch's CPU figures may
    depend on it, and an xdist worker may have run anything before."""
    from torch_port_golden import HOLD_THREADS, threads
    with threads(getattr(request, "param", HOLD_THREADS)) as n:
        yield n


def configs(path=TINY):
    """(JAX Config, port Config) of one config file."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    return lm.Config.fromfile(path), lmt.Config.fromfile(path)


def random_variables(module, example_args, seed, init_kw=None,
                     eager=False):
    """Seeded {params, batch_stats} numpy trees shaped like
    ``module.init(key, *example_args, **init_kw)`` (``init_kw`` defaults
    to ``train=False``; ``eager`` runs the init instead of tracing it, for
    a module that cannot be traced): kernels ~ N(0,
    1/fan_in), biases ~ N(0, 0.1^2), norm scales ~ U(0.8, 1.2), BatchNorm
    running means ~ N(0, 0.1^2) and variances ~ U(0.6, 1.4), embeddings
    ~ N(0, 1), the lane-batched ``[N, I, O]`` weights of the row head's
    ``PerLaneConvHead`` ~ N(0, 1/I)."""
    init_kw = {"train": False} if init_kw is None else init_kw
    init = lambda k: module.init(k, *example_args, **init_kw)  # noqa: E731
    shapes = init(jax.random.PRNGKey(0)) if eager \
        else jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "var":
            v = rng.uniform(0.6, 1.4, shape)
        elif leaf in ("pos_embedding", "lane_emb"):
            v = rng.normal(0.0, 1.0, shape)
        elif leaf in ("w1", "w2"):
            v = rng.normal(0.0, shape[1] ** -0.5, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": v["params"], "batch_stats": v.get("batch_stats", {})}


def tiny_models(seed=0, endp_mode=None):
    """(JAX Detector1stage, its variables, port Detector1stage with the same
    weights, JAX cfg, port cfg) at ``configs/tiny_test.py``."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = configs()
    if endp_mode:
        cfg_j.heads.endp_mode = cfg_t.heads.endp_mode = endp_mode
    img = cfg_j.list_img_size_xy[0]
    jmodel = lm.build_model(cfg_j)
    variables = random_variables(jmodel, (jnp.zeros((1, img, img, 3)),),
                                 seed)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    return jmodel, variables, tmodel, cfg_j, cfg_t


# the four configs of the KLane / segmentation / MLP-Mixer slice, shrunk to
# tiny widths: 192 px tiles (S = 24), ResNet-18 trunks, a one-block
# correlator of width 128 (2 channels after the 8x8 un-patch), float32
ZOO_CONFIGS = {
    "rowref": "Proj28_GFC-T3_RowRef_82_73_laser.py",
    "gridseg": "Proj28_GFC-T3_Seg_82_11_laser.py",
    "fpnseg": "Proj_FPN_Seg.py",
    "mixseg": "Proj_polyline_fpn_mixseg_vertex.py",
}
_TINY_VIT = {"backbone.image_size": 24, "backbone.dim": 128,
             "backbone.depth": 1, "backbone.heads": 4,
             "backbone.dim_head": 32}
ZOO_TINY = {
    "rowref": {**_TINY_VIT, "heads.dim_feat": 2, "heads.row_size": 24,
               "heads.dim_shared": 32, "heads.dim_token": 64,
               "heads.tr_heads": 4, "heads.tr_dim_head": 16,
               "heads.tr_mlp_dim": 128},
    "gridseg": {**_TINY_VIT, "backbone.output_channels": 16,
                "heads.num_1": 16, "heads.num_2": 32},
    "fpnseg": {},
    "mixseg": {"backbone.image_size": 24, "backbone.dim": 128,
               "backbone.depth": 1, "heads.row_size": 24,
               "heads.num_prop": 12, "heads.dim_shared": 32},
}
ZOO_COMMON = {"list_img_size_xy": [192, 192], "pcencoder.resnet": "resnet18",
              "batch_size": 2, "workers": 0, "train_compute_dtype": "float32"}


def zoo_configs(name, **over):
    """(JAX Config, port Config) of one of the slice's configs at tiny
    widths, with dotted ``over`` merged into both."""
    cfgs = configs(os.path.join(REPO, "configs", ZOO_CONFIGS[name]))
    for cfg in cfgs:
        cfg.merge_from_dict({**ZOO_COMMON, **ZOO_TINY[name], **over})
    return cfgs


def zoo_models(name, seed=0, **over):
    """(JAX net, its variables, port net with the same weights, JAX cfg,
    port cfg) of ``zoo_configs(name, **over)``."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = zoo_configs(name, **over)
    img = cfg_j.list_img_size_xy[0]
    jmodel = lm.build_model(cfg_j)
    variables = random_variables(jmodel, (jnp.zeros((1, img, img, 3)),),
                                 seed)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    return jmodel, variables, tmodel, cfg_j, cfg_t


def lidar_example(n_points):
    """The raw-point input ``model.init`` traces the LiDAR net with."""
    return {"points": jnp.zeros((1, n_points, 4)),
            "points_mask": jnp.ones((1, n_points), bool)}


def tiny_lidar_models(seed=0, **overrides):
    """(JAX Detector1stage, its variables, port Detector1stage with the same
    weights, JAX cfg, port cfg) at ``configs/tiny_test_lidar.py``, with
    top-level config ``overrides`` set in both."""
    import lanemapping_tpu as lm
    import lanemapping_tpu_torch as lmt
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    cfg_j, cfg_t = configs(TINY_LIDAR)
    for k, v in overrides.items():
        cfg_j[k] = cfg_t[k] = v
    jmodel = lm.build_model(cfg_j)
    variables = random_variables(jmodel, (lidar_example(cfg_j.max_points),),
                                 seed)
    tmodel = lmt.build_model(cfg_t)
    load_jax_weights(tmodel, variables["params"], variables["batch_stats"],
                     cfg_t)
    return jmodel, variables, tmodel, cfg_j, cfg_t


def lane_clouds(seeds, img, n_points):
    """[len(seeds), n_points, 4] float32 lane-structured clouds (raw LAS
    intensity scaled to [0, 1] as `load_lidar_points` does) and an all-True
    mask with the last eighth of each cloud masked out as padding."""
    from lanemapping_tpu_torch.data.synthetic import (lane_structured_points,
                                                      random_lane_seqs)
    pts = []
    for s in seeds:
        rng = np.random.RandomState(s)
        seqs = random_lane_seqs(rng, img=img, n_lanes=4)
        p = lane_structured_points(seqs, [1, 2, 1, 2], img, rng, n_points)
        p[:, 3] = (np.clip(p[:, 3], 800.0, 33000.0) - 800.0) / 33000.0
        pts.append(p.astype(np.float32))
    mask = np.ones((len(seeds), n_points), bool)
    mask[:, -n_points // 8:] = False
    return np.stack(pts), mask


def jax_apply(module, variables, *args, **kw):
    out = jax.jit(lambda v, *a: module.apply(v, *a, train=False, **kw))(
        variables, *args)
    return jax.tree.map(np.asarray, out)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def rel_max_err(got, want) -> float:
    """max |got - want| / max(1e-3, max |want|) — the bar of the existing
    torch-parity harness (`tests/test_torch_parity.py:452`), 2e-3 in f32."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1e-3, np.abs(want).max()))


def assert_clear_of_thresholds(dec, cfg, margin=1e-4, img=192,
                               clamped_columns=False):
    """Proposal confidence off its threshold; at every vertex the host
    keeps, the column argmax off a tie and the column off an integer (the
    tracker truncates it to a cell).  With ``clamped_columns``, columns
    that are exact integers are left out: decode clamps the in-window
    offset to the window width (`lane_decode.py:207-209`), which gives the
    same integer in both packages."""
    conf = dec["prop_conf"][..., 1]
    assert np.abs(conf - cfg.proposal_obj_thre).min() > margin
    kept = (conf >= cfg.proposal_obj_thre)[..., None] \
        & (dec["prop_v_ext"] > 0.5)
    probs = np.sort(dec["prop_cls_conf"], axis=-1)
    assert (probs[..., -1] - probs[..., -2])[kept].min() > margin
    coors = dec["cls_offset"] / cfg.heads.row_size * img
    frac = np.abs(coors - np.round(coors))
    check = kept & (coors > 0)
    if clamped_columns:
        check &= frac > 0
    assert frac[check].min() > margin


def assert_same_records(got, want):
    """Same lanes, vertex rows and semantics; columns to 1e-3 px (float32
    rounding differs between the packages)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(r["lane_id"], r["seq_len"]) for r in g] == \
            [(r["lane_id"], r["seq_len"]) for r in w]
        for rg, rw in zip(g, w):
            sg, sw = np.asarray(rg["seq"]), np.asarray(rw["seq"])
            np.testing.assert_array_equal(sg[:, [0, 2]], sw[:, [0, 2]])
            np.testing.assert_allclose(sg[:, 1], sw[:, 1], atol=1e-3)


# -- training ---------------------------------------------------------------

def wire_data_root(cfg, root):
    """Point every split of a config (JAX or port) at ``root``."""
    for split in ("train", "val", "test"):
        cfg.dataset[split]["data_root"] = root
    return cfg


def jax_device_batch(cfg_j, batch):
    """The JAX Runner's shipped batch (`engine/runner.py::_device_batch`)
    of a host batch, on one CPU device, as numpy arrays: the Runner's own
    method on a stand-in that carries only what it reads."""
    from lanemapping_tpu.engine.runner import Runner
    from lanemapping_tpu.parallel.mesh import make_mesh

    stub = object.__new__(Runner)
    stub.cfg = cfg_j
    stub.use_lidar = bool(cfg_j.get("use_lidar", False))
    stub.mesh = make_mesh(cfg_j, devices=jax.devices()[:1])
    return {k: np.asarray(v) for k, v in stub._device_batch(batch).items()}


def port_batch_numpy(db):
    """A port device batch as numpy arrays (bf16 widened exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in db.items()}


def port_runner(cfg_t, variables, log_dir):
    """A CPU ``Runner`` of the port holding the JAX variables."""
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.tools.from_jax import load_jax_weights

    runner = Runner(cfg_t, log_dir=str(log_dir), device="cpu")
    load_jax_weights(runner.model, variables["params"],
                     variables["batch_stats"], cfg_t)
    return runner


def jax_train_state(cfg_j, variables):
    """(tx, TrainState) of the JAX package from numpy variables."""
    from lanemapping_tpu.engine.optimizer import build_optimizer
    from lanemapping_tpu.engine.state import TrainState

    tx = build_optimizer(cfg_j)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return tx, TrainState(params=params,
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   variables["batch_stats"]),
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))


def mid_training_adam(grads, seed, count=10):
    """A seeded mid-training Adam state at update ``count`` for gradients
    like ``grads`` (numpy tree in the flax layout): per leaf, with s the
    RMS of its gradient floored at 1e-3 of the largest leaf RMS, the
    bias-corrected second moment is s^2 * U(0.5, 2) and the corrected
    first moment N(0, (0.3 s)^2) — the moments Adam holds after steps of
    gradients of this size.  The floor keeps a leaf whose gradient is
    rounding noise (a bias before a batch-statistics BatchNorm, exactly 0
    in exact arithmetic) from being scaled up to a full lr step."""
    rng = np.random.RandomState(seed)
    rms = jax.tree.map(lambda g: float(np.sqrt(np.mean(np.square(g)))),
                       grads)
    floor = 1e-3 * max(jax.tree.leaves(rms))
    c1, c2 = 1.0 - 0.9 ** count, 1.0 - 0.999 ** count
    mu = jax.tree.map(lambda g, r: (rng.normal(0.0, 0.3 * max(r, floor),
                                               g.shape) * c1
                                    ).astype(np.float32), grads, rms)
    nu = jax.tree.map(lambda g, r: (max(r, floor) ** 2 * rng.uniform(
        0.5, 2.0, g.shape) * c2).astype(np.float32), grads, rms)
    return mu, nu, count


def with_adam_state(opt_state, mu, nu, count):
    """An optax ``adam`` state (ScaleByAdamState, ScaleByScheduleState)
    set to (mu, nu, count)."""
    adam, sched = opt_state
    c = jnp.asarray(count, jnp.int32)
    return (adam._replace(count=c, mu=jax.tree.map(jnp.asarray, mu),
                          nu=jax.tree.map(jnp.asarray, nu)),
            sched._replace(count=c))


def jax_train_step(jmodel, tx, cfg_j):
    """The JAX package's jitted train step at ``cfg_j``'s compute dtype."""
    from lanemapping_tpu.engine.state import make_train_step
    from lanemapping_tpu.models.head_losses import (column_proposal_loss,
                                                    head_hparams)

    hp = head_hparams(cfg_j)
    cdt = jnp.bfloat16 if cfg_j.get("train_compute_dtype") == "bfloat16" \
        else None
    return jax.jit(make_train_step(
        jmodel, tx, lambda out, batch: column_proposal_loss(out, batch, hp),
        compute_dtype=cdt, use_lidar=bool(cfg_j.get("use_lidar", False))))


def state_dict_np(model):
    return {k: v.detach().float().numpy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def jax_grads(jmodel, cfg_j):
    """Jitted (params, batch_stats, device batch) -> ((loss, (terms, new
    batch stats)), parameter gradients) of the JAX step's differentiated
    function (`engine/state.py:84-99` there), without its dtype cast."""
    from lanemapping_tpu.engine.state import model_input
    from lanemapping_tpu.models.head_losses import (column_proposal_loss,
                                                    head_hparams)
    hp = head_hparams(cfg_j)
    use_lidar = bool(cfg_j.get("use_lidar", False))

    @jax.jit
    def run(params, batch_stats, batch):
        def inner(p):
            out, upd = jmodel.apply(
                {"params": p, "batch_stats": batch_stats},
                model_input(batch, use_lidar), train=True,
                mutable=["batch_stats"])
            res = column_proposal_loss(out, batch, hp)
            return res["loss"], (res["loss_stats"], upd["batch_stats"])
        return jax.value_and_grad(inner, has_aux=True)(params)

    return run


# -- the JAX package's root scripts ------------------------------------------

def jax_script(name):
    """A root script of the JAX package as a module."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def seeded_jax_runners(variables):
    """JAX Runners built in this context start from ``variables`` instead
    of running ``model.init``."""
    import lanemapping_tpu.engine.runner as jr
    from lanemapping_tpu.engine.state import TrainState

    def create(model, tx, rng, example):
        params = jax.tree.map(jnp.asarray, variables["params"])
        return TrainState(params=params,
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   variables["batch_stats"]),
                          opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "create_train_state", create)
        yield


@contextlib.contextmanager
def recorded_validates(*runner_classes):
    """[(class's module, metrics, runner)] of every ``validate`` of these
    classes."""
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        for cls in runner_classes:
            def wrapped(self, *a, _orig=cls.validate, _cls=cls, **kw):
                m = _orig(self, *a, **kw)
                seen.append((_cls.__module__, dict(m), self))
                return m
            mp.setattr(cls, "validate", wrapped)
        yield seen
