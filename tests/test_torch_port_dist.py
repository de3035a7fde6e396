"""The port's data-parallel layer (`lanemapping_tpu_torch/parallel/`) on
the CPU: the mesh and its row split, the process-group helpers, and, on 2
gloo ranks (``torch.multiprocessing``, `tests/torch_port_dist_workers.py`)
each holding half of a seeded batch,

- BatchNorm in training against flax ``BatchNorm`` on the whole batch:
  outputs and running statistics within rel-max 1e-5, the input's and
  the parameters' gradients within rel-max 1e-4;
- each loss's two contributions summed against the JAX loss on the whole
  batch, every term within rel 1e-5 (``column_proposal_loss``'s 10 terms,
  also with one rank's half holding no valid vertex and no labelled
  orientation pixel; ``row_shar_loss``, ``grid_seg_loss``,
  ``segmentor_loss``, ``endp_regression_loss``), and the gradients of the
  contributions with respect to each rank's outputs, put together, within
  rel-max 2e-3 of the JAX loss's (the bar of the single-process loss
  tests);
- dropout: the two ranks' masks are the rows of the one-process mask;
- `tools/train.py`'s rank entry (what it spawns, one rank per card of a
  mesh of more than one) on two CPU ranks: one step, logged once, by
  rank 0;
- ``stream_map`` over ``devices=[cpu, cpu]`` with a ragged last batch: the
  same lane JSONs, byte for byte, as one replica.  Both run with one
  intra-op thread, where PyTorch's CPU kernels do not depend on the batch
  size (its channels-last GroupNorm does at several threads).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_dist_workers import LOSS_KW, join_all, pack, spawn
from torch_port_helpers import TINY, configs, rel_max_err, wire_data_root

B = 4  # the global batch of the loss cases, 2 rows per rank


# -- mesh and single-process helpers ----------------------------------------

@pytest.mark.parametrize("shape,n_dev,want", [
    (None, 3, 3), ({"data": -1}, 4, 4), ({"data": 2}, 8, 2),
    ({"data": 8}, 2, 2)])
def test_make_mesh_sizes_and_shrinks(shape, n_dev, want):
    """The JAX ``make_mesh`` rules (`tests/test_parallel.py:28-35`): -1
    takes every device, an axis larger than the devices shrinks."""
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.parallel.mesh import make_mesh

    cfg = Config.fromdict({"mesh_shape": shape}) if shape else None
    mesh = make_mesh(cfg, devices=["cpu"] * n_dev)
    assert mesh == [torch.device("cpu")] * want
    assert make_mesh(cfg, device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="data"):
        make_mesh(Config.fromdict({"mesh_shape": {"model": 2}}),
                  devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(cfg)


def test_shard_batch_splits_rows_and_refuses_ragged():
    from lanemapping_tpu_torch.parallel.mesh import row_slice, shard_batch

    batch = {"proj": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "image_name": [f"t{i}" for i in range(8)]}
    parts = shard_batch(batch, [torch.device("cpu")] * 4)
    assert len(parts) == 4 and all(set(p) == {"proj"} for p in parts)
    assert torch.equal(torch.cat([p["proj"] for p in parts]),
                       torch.from_numpy(batch["proj"]))
    assert row_slice(1, 4, 8) == slice(2, 4)
    with pytest.raises(ValueError, match="divide"):
        shard_batch(batch, [torch.device("cpu")] * 3)


def test_backend_follows_the_device_assignment(monkeypatch):
    from lanemapping_tpu_torch.parallel.dist import (backend_for,
                                                     local_world_size,
                                                     rank_devices)

    cards = [f"cuda:{i}" for i in range(4)]
    assert backend_for(["cuda:0", "cuda:1"], 2) == "nccl"
    assert backend_for(["cuda:0"], 1) == "nccl"
    assert backend_for(["cuda:0", "cuda:0"], 2) == "gloo"  # a shared card
    assert backend_for(["cuda:0"], 2) == "gloo"  # two ranks on one card
    assert backend_for(["cpu", "cpu"], 2) == "gloo"
    assert rank_devices(["cuda:0", "cuda:1"], 4) == [
        torch.device(d) for d in ("cuda:0", "cuda:1", "cuda:0", "cuda:1")]
    # 8 ranks from the environment on hosts of 4 cards: 2 hosts, a card
    # per rank on each (ranks r and r + 4 both take their host's card r)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert local_world_size("host0:29500", 8, 4) == 4
    assert backend_for(cards, local_world_size("host0:29500", 8, 4)) == \
        "nccl"
    # the same 8 ranks behind a loopback coordinator share 4 cards
    assert local_world_size("127.0.0.1:29500", 8, 4) == 8
    assert backend_for(cards, 8) == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert local_world_size("host0:29500", 8, 4) == 8


def test_dist_helpers_single_process():
    """`tests/test_parallel.py:38-48` against the port's helpers."""
    from lanemapping_tpu_torch.parallel import dist

    assert dist.maybe_initialize_distributed() is None  # no coordinator
    assert dist.get_rank() == 0 and dist.get_world_size() == 1
    assert dist.is_main_process()
    dist.synchronize()
    assert dist.all_gather_host({"x": 1}) == [{"x": 1}]
    np.testing.assert_allclose(dist.all_reduce_mean_host(np.arange(3.0)),
                               np.arange(3.0))
    x = torch.arange(4.0)
    assert dist.sum_over_ranks(x) is x and dist.global_rows(3) == 3
    assert torch.equal(dist.global_mean(x), torch.mean(x))


# -- two ranks ---------------------------------------------------------------

def loss_cases(tmp_path_factory):
    """{case: (outputs, batch)} at global batch 4, numpy."""
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.engine.runner import Runner

    root = str(tmp_path_factory.mktemp("laserlane"))
    generate_dataset(root, n_tiles=8, img=192, seed=3)  # 4 train tiles
    _, cfg = configs(TINY)
    wire_data_root(cfg, root)
    cfg.batch_size = B
    runner = Runner(cfg, log_dir=str(tmp_path_factory.mktemp("logs")),
                    device="cpu")
    db = {k: v.numpy() for k, v in runner._device_batch(next(iter(
        build_dataloader(cfg.dataset.train, cfg)))).items()}
    S, P = cfg.heads.row_size, cfg.heads.num_prop
    W = cfg.heads.prop_width + 2 * cfg.heads.prop_half_buff
    img = 8 * S
    rng = np.random.RandomState(7)
    shapes = {"semantic_seg": (B, img, img, 3), "endp_est": (B, img, img, 1),
              "orient": (B, S, S, 11), "proposal_conf": (B, P, 2),
              "ext2": (B, P, S, 3), "cls2": (B, P, S, W),
              "offset2": (B, P, S, W), "prop_seg_small": (B, P, 2 * S, 2 * W)}
    out = {k: (rng.randn(*s) * 2.0).astype(np.float32)
           for k, s in shapes.items()}
    empty = dict(db)  # rank 1's half: no valid vertex, no orient label
    for k in ("prop_ext", "lc_orient"):
        empty[k] = db[k].copy()
        empty[k][B // 2:] = 0
    assert db["prop_ext"][:B // 2].any() and db["lc_orient"][:B // 2].any()

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    N, Hs = 12, 32
    label = np.where(rng.rand(B, S, S + 4) < 0.1,
                     rng.randint(0, N, (B, S, S + 4)), 255).astype(np.int16)
    grid = np.where(rng.rand(B, S, S) < 0.2,
                    rng.randint(1, 13, (B, S, S)), 0).astype(np.int16)
    endp = np.zeros((B, Hs, Hs), np.uint8)
    yy, xx = np.mgrid[:Hs, :Hs]
    for b, (cy, cx) in ((0, (10, 20)), (2, (20, 5)), (3, (4, 4))):
        endp[b] = (255 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
                   ).astype(np.uint8)
    lane = np.asarray([[12.0, 3.0], [0.0, 0.0], [30.0, 9.0], [0.0, 0.0]],
                      np.float32)[:, None]
    return {
        "column:real": (out, db),
        "column:rank1_empty": (out, empty),
        "row_shar": ({k: softmax(rng.randn(B, N, S, d) * (1 + (d > 2)))
                      for k, d in (("ext", 2), ("cls", S), ("ext2", 2),
                                   ("cls2", S))}, {"label": label}),
        "grid_seg": ({"conf": (1 / (1 + np.exp(-rng.randn(B, S, S))))
                      .astype(np.float32),
                      "cls": rng.randn(B, S, S, 13).astype(np.float32)},
                     {"label": grid}),
        "segmentor": ({"semantic_seg": rng.randn(B, Hs, Hs, 3).astype(
                           np.float32),
                       "endp_est": rng.randn(B, Hs, Hs, 1).astype(
                           np.float32)},
                      {"mask": rng.randint(0, 3, (B, Hs, Hs)).astype(
                          np.uint8), "endp_map": endp}),
        "endp_regression": ({"endp_reg": rng.rand(B, 4).astype(np.float32)},
                            {"initp": lane, "endp": lane + 5 * (lane > 0)}),
    }


def bn_inputs():
    rng = np.random.RandomState(11)
    out = {}
    for kind, shape in (("2d", (8, 16, 6, 6)), ("1d", (48, 10))):
        C = shape[1]
        out.update({f"{kind}_x": (rng.randn(*shape) * 2.0 + 1.0).astype(
                        np.float32),
                    f"{kind}_dy": rng.randn(*shape).astype(np.float32),
                    f"{kind}_w": rng.uniform(0.8, 1.2, C).astype(np.float32),
                    f"{kind}_b": rng.normal(0, 0.1, C).astype(np.float32),
                    f"{kind}_rm": rng.normal(0, 0.1, C).astype(np.float32),
                    f"{kind}_rv": rng.uniform(0.6, 1.4, C).astype(
                        np.float32)})
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The rank checks on 2 ranks and, at the same time, `tools/train.py`'s
    rank entry on 2 ranks (one intra-op thread each)."""
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.tools import train
    from torch_port_dist_workers import rank_checks

    work = str(tmp_path_factory.mktemp("ranks"))
    cases = loss_cases(tmp_path_factory)
    bn = bn_inputs()
    np.savez(os.path.join(work, "bn.npz"), **bn)
    pack(os.path.join(work, "losses.npz"), cases)
    root = os.path.join(work, "tiles")
    generate_dataset(root, n_tiles=8, img=192, seed=5)
    argv = [TINY, f"dataset.train.data_root={root}",
            f"dataset.val.data_root={root}", "batch_size=4", "log_every=1",
            "--device", "cpu", "--max-iters", "1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # read by the spawned ranks
        join_all(spawn(rank_checks, 2, work),
                 spawn(train._rank_main, 2, argv, os.path.join(work, "cli"),
                       [torch.device("cpu")] * 2))
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
             for r in range(2)]
    with open(os.path.join(work, "cli", "train.jsonl")) as f:
        cli = [json.loads(line) for line in f]
    return {"ranks": ranks, "cases": cases, "bn": bn, "cli": cli}


def test_dist_helpers_two_ranks(two_ranks):
    for r, res in enumerate(two_ranks["ranks"]):
        assert int(res["rank"]) == r and int(res["world"]) == 2
        assert bool(res["main"]) == (r == 0)
        np.testing.assert_array_equal(res["gather_r"], [0, 1])
        np.testing.assert_array_equal(res["gather_a"],
                                      [np.arange(3.0), np.arange(3.0) + 1])
        np.testing.assert_allclose(res["mean"], np.arange(3.0) + 0.5)


@pytest.mark.parametrize("kind", ["2d", "1d"])
def test_sync_batchnorm_matches_flax_on_the_whole_batch(two_ranks, kind):
    import flax.linen as nn

    bn, ranks = two_ranks["bn"], two_ranks["ranks"]
    x, dy = bn[f"{kind}_x"], bn[f"{kind}_dy"]
    nhwc = (lambda a: np.moveaxis(a, 1, -1)) if kind == "2d" \
        else (lambda a: a)
    layer = nn.BatchNorm(use_running_average=False, momentum=0.9,
                         epsilon=1e-5)
    stats = {"mean": bn[f"{kind}_rm"], "var": bn[f"{kind}_rv"]}

    def f(xj, scale, bias):
        y, upd = layer.apply({"params": {"scale": scale, "bias": bias},
                              "batch_stats": stats}, xj,
                             mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, vjp, new = jax.vjp(f, jnp.asarray(nhwc(x)), bn[f"{kind}_w"],
                          bn[f"{kind}_b"], has_aux=True)
    dx, dw, db = vjp(jnp.asarray(nhwc(dy)))
    got = np.concatenate([r[f"{kind}_y"] for r in ranks])
    assert rel_max_err(nhwc(got), y) < 1e-5
    for r in ranks:  # every rank moves to the global statistics
        assert rel_max_err(r[f"{kind}_rm"], new["mean"]) < 1e-5
        assert rel_max_err(r[f"{kind}_rv"], new["var"]) < 1e-5
    got_dx = np.concatenate([r[f"{kind}_dx"] for r in ranks])
    assert rel_max_err(nhwc(got_dx), dx) < 1e-4
    # each rank's parameter gradient is its part; the train step sums them
    assert rel_max_err(sum(r[f"{kind}_dw"] for r in ranks), dw) < 1e-4
    assert rel_max_err(sum(r[f"{kind}_db"] for r in ranks), db) < 1e-4


def test_dropout_draws_the_one_process_mask(two_ranks):
    from lanemapping_tpu_torch.models.norm import Dropout

    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(3)
    want = drop(torch.ones(16, 6)).numpy()
    nxt = torch.rand(2, generator=drop.generator).numpy()
    for r, res in enumerate(two_ranks["ranks"]):
        np.testing.assert_array_equal(res["dropout"], want[8 * r:8 * r + 8])
        np.testing.assert_array_equal(res["dropout_next"], nxt)


def jax_loss(case, out, batch):
    from lanemapping_tpu.models import head_losses, row_head
    from lanemapping_tpu.models.row_head_base import endp_regression_loss

    kind = case.split(":")[0]
    if kind == "column":
        cfg_j, _ = configs(TINY)
        return head_losses.column_proposal_loss(
            out, batch, head_losses.head_hparams(cfg_j))
    if kind == "endp_regression":
        loss = endp_regression_loss(out, batch, **LOSS_KW[kind])
        return {"loss": loss, "loss_stats": {"endp_reg": loss}}
    fn = {"row_shar": row_head.row_shar_loss,
          "grid_seg": row_head.grid_seg_loss,
          "segmentor": head_losses.segmentor_loss}[kind]
    return fn(out, batch, **LOSS_KW[kind])


@pytest.mark.parametrize("case", ["column:real", "column:rank1_empty",
                                  "row_shar", "grid_seg", "segmentor",
                                  "endp_regression"])
def test_loss_contributions_sum_to_the_jax_loss(two_ranks, case):
    out, batch = two_ranks["cases"][case]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jfn(o):
        res = jax_loss(case, o, jb)
        return res["loss"], res["loss_stats"]

    (jl, jstats), jg = jax.device_get(jax.jit(jax.value_and_grad(
        jfn, has_aux=True))({k: jnp.asarray(v) for k, v in out.items()}))
    ranks = two_ranks["ranks"]
    for k, want in list(jstats.items()) + [("loss", jl)]:
        key = f"{case}/loss" if k == "loss" else f"{case}/stat/{k}"
        got = sum(float(r[key]) for r in ranks)
        assert got == pytest.approx(float(want), rel=1e-5, abs=1e-7), k
    if case == "column:rank1_empty":
        # the terms normalised by the vertex and orientation counts are
        # nonzero: the global count of rank 0's rows divides them
        for k in ("cls_loss2", "orient_loss"):
            assert float(jstats[k]) > 0 and float(
                ranks[1][f"{case}/stat/{k}"]) == 0.0, k
    for k in out:
        got = np.concatenate([r[f"{case}/grad/{k}"] for r in ranks])
        want = np.asarray(jg[k])
        if not np.any(want):
            assert not np.any(got), k
            continue
        assert rel_max_err(got, want) < 2e-3, k


def test_train_cli_rank_runs_its_rows_on_two_cpu_ranks(two_ranks):
    recs = two_ranks["cli"]
    assert len(recs) == 1 and recs[0]["iter"] == 0
    assert np.isfinite(recs[0]["loss"]) and recs[0]["skipped_nan"] == 0.0


def test_stream_map_over_two_replicas_equals_one(tmp_path):
    from lanemapping_tpu_torch.data.synthetic import generate_dataset
    from lanemapping_tpu_torch.tools import stream_map

    root = str(tmp_path / "tiles")
    generate_dataset(root, n_tiles=7, img=192, seed=3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        recs = [stream_map.main(
            [TINY, root, "--split", "all", "--batch", "4", "--device", "cpu",
             "--out", str(tmp_path / f"out{n}"), "--seed", "0"],
            devices=["cpu"] * n) for n in (1, 2)]
    finally:
        torch.set_num_threads(threads)
    assert [r["devices"] for r in recs] == [["cpu"], ["cpu", "cpu"]]
    assert [r["n_tiles"] for r in recs] == [7, 7]  # batches of 4 and 3
    dirs = [r["lanes_dir"] for r in recs]
    names = sorted(os.listdir(dirs[0]))
    assert len(names) == 7 and names == sorted(os.listdir(dirs[1]))
    for name in names:
        a, b = (open(os.path.join(d, name), "rb").read() for d in dirs)
        assert a == b, name
    assert sum(len(json.loads(open(os.path.join(dirs[0], n)).read()))
               for n in names) > 0
