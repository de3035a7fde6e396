"""What the ranks of the multi-rank CPU tests run
(`tests/test_torch_port_dist*.py`).

The ranks are processes of ``torch.multiprocessing.spawn`` joined in a gloo
group on ``127.0.0.1``; they import this module and the port, never JAX
(the test process computes the JAX side).  Inputs reach them as ``.npz``
files and their results go back the same way, one file per rank.
"""

import json
import os

import numpy as np
import torch


def spawn(fn, world, *args):
    """Start ``fn(rank, world, port, *args)`` on ``world`` ranks; returns
    the process context (``join_all`` waits for it)."""
    import torch.multiprocessing as mp
    from lanemapping_tpu_torch.parallel.dist import free_port

    return mp.spawn(fn, args=(world, free_port()) + args, nprocs=world,
                    join=False)


def join_all(*contexts, timeout=300):
    for ctx in contexts:
        while not ctx.join(timeout):
            pass


def _start(rank, world, port):
    torch.set_num_threads(1)
    from lanemapping_tpu_torch.parallel.dist import \
        maybe_initialize_distributed
    if world > 1:
        maybe_initialize_distributed(
            coordinator=f"127.0.0.1:{port}", num_processes=world,
            process_id=rank, devices=["cpu"])


def _rows(a, rank, world):
    from lanemapping_tpu_torch.parallel.mesh import row_slice
    return a[row_slice(rank, world, len(a))]


# -- the losses, by case -----------------------------------------------------

LOSS_KW = {"row_shar": dict(n_lanes=12, row_size=24, lambda_cls=0.7),
           "grid_seg": dict(num_classes=13, dataset_type="LaserLane"),
           "segmentor": {}, "endp_regression": dict(img_size=192)}


def port_loss(case, out, batch, hp):
    """{'loss', 'loss_stats'} of one case's port loss."""
    from lanemapping_tpu_torch.models import head_losses, row_head
    from lanemapping_tpu_torch.models.row_head_base import \
        endp_regression_loss

    kind = case.split(":")[0]
    if kind == "column":
        return head_losses.column_proposal_loss(out, batch, hp)
    if kind == "endp_regression":
        loss = endp_regression_loss(out, batch, **LOSS_KW[kind])
        return {"loss": loss, "loss_stats": {"endp_reg": loss}}
    fn = {"row_shar": row_head.row_shar_loss,
          "grid_seg": row_head.grid_seg_loss,
          "segmentor": head_losses.segmentor_loss}[kind]
    return fn(out, batch, **LOSS_KW[kind])


def unpack(path):
    """{case: (out, batch)} of an ``.npz`` written by ``pack``."""
    data = np.load(path)
    cases = {}
    for key in data.files:
        case, part, name = key.split("/")
        cases.setdefault(case, ({}, {}))[part == "batch"][name] = data[key]
    return cases


def pack(path, cases):
    np.savez(path, **{f"{case}/{part}/{k}": v
                      for case, (out, batch) in cases.items()
                      for part, d in (("out", out), ("batch", batch))
                      for k, v in d.items()})


def rank_checks(rank, world, port, work):
    """The dist helpers, BatchNorm over the global batch, dropout and each
    loss's contribution, on this rank's rows of ``<work>/bn.npz`` and
    ``<work>/losses.npz``; results in ``<work>/rank<r>.npz``."""
    _start(rank, world, port)
    from lanemapping_tpu_torch.config.config import Config
    from lanemapping_tpu_torch.models.head_losses import head_hparams
    from lanemapping_tpu_torch.models.norm import (BatchNorm1d, BatchNorm2d,
                                                   Dropout)
    from lanemapping_tpu_torch.parallel import dist

    res = {}
    try:
        res["rank"], res["world"] = dist.get_rank(), dist.get_world_size()
        res["main"] = dist.is_main_process()
        dist.synchronize()
        got = dist.all_gather_host({"r": rank, "a": np.arange(3.0) + rank})
        res["gather_r"] = np.array([g["r"] for g in got])
        res["gather_a"] = np.stack([g["a"] for g in got])
        res["mean"] = dist.all_reduce_mean_host(np.arange(3.0) + rank)

        bn = np.load(os.path.join(work, "bn.npz"))
        for kind, cls in (("2d", BatchNorm2d), ("1d", BatchNorm1d)):
            x = bn[f"{kind}_x"]
            m = cls(x.shape[1], eps=1e-5, momentum=0.1).train()
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(bn[f"{kind}_w"]))
                m.bias.copy_(torch.from_numpy(bn[f"{kind}_b"]))
                m.running_mean.copy_(torch.from_numpy(bn[f"{kind}_rm"]))
                m.running_var.copy_(torch.from_numpy(bn[f"{kind}_rv"]))
            xt = torch.from_numpy(_rows(x, rank, world)).requires_grad_()
            y = m(xt)
            y.backward(torch.from_numpy(_rows(bn[f"{kind}_dy"], rank, world)))
            res.update({f"{kind}_y": y.detach().numpy(),
                        f"{kind}_dx": xt.grad.numpy(),
                        f"{kind}_dw": m.weight.grad.numpy(),
                        f"{kind}_db": m.bias.grad.numpy(),
                        f"{kind}_rm": m.running_mean.numpy(),
                        f"{kind}_rv": m.running_var.numpy()})

        drop = Dropout(0.5).train()
        drop.generator = torch.Generator().manual_seed(3)
        res["dropout"] = drop(torch.ones(8, 6)).numpy()
        res["dropout_next"] = torch.rand(
            2, generator=drop.generator).numpy()

        cfg = Config.fromfile(os.path.join(os.path.dirname(__file__), "..",
                                           "configs", "tiny_test.py"))
        hp = head_hparams(cfg)
        for case, (out, batch) in unpack(os.path.join(
                work, "losses.npz")).items():
            tout = {k: torch.from_numpy(_rows(v, rank, world))
                    .requires_grad_() for k, v in out.items()}
            tb = {k: torch.from_numpy(_rows(v, rank, world))
                  for k, v in batch.items()}
            r = port_loss(case, tout, tb, hp)
            r["loss"].backward()
            res[f"{case}/loss"] = r["loss"].detach().numpy()
            for k, v in r["loss_stats"].items():
                res[f"{case}/stat/{k}"] = v.detach().numpy()
            for k, v in tout.items():
                res[f"{case}/grad/{k}"] = v.grad.numpy() \
                    if v.grad is not None else np.zeros_like(v.detach())
    finally:
        dist.shutdown()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **res)


# -- the Runner ---------------------------------------------------------------

def runner_checks(rank, world, port, root, work, init_from):
    """Short ``Runner`` runs at global batch 4 on ``world`` ranks: a plain
    run of 2 steps with a validate, the NaN guard (2 ranks), and one step
    each with dropout and with ``remat``.
    Writes ``<work>/runner_<world>rank_<rank>.json``."""
    _start(rank, world, port)
    from lanemapping_tpu_torch.data.loader import build_dataloader
    from lanemapping_tpu_torch.engine.checkpoint import load_network_filtered
    from lanemapping_tpu_torch.engine.runner import Runner
    from lanemapping_tpu_torch.parallel import dist
    from lanemapping_tpu_torch.tools.multihost_test import (build_cfg,
                                                            state_digest)

    def runner(tag, **over):
        log_dir = os.path.join(work, f"{tag}_{world}rank")
        r = Runner(build_cfg(root, log_dir, 4, overrides=over),
                   log_dir=log_dir, device="cpu")
        r._tb = None  # the checks read the step records, not TensorBoard
        if init_from:
            load_network_filtered(init_from, r.state)
        return r

    def train(r, steps):
        step, losses, first = r.train_step, [], {}

        def recorded(state, batch):
            stats = step(state, batch)
            losses.append({k: float(v) for k, v in stats.items()})
            if not first:  # the BatchNorm statistics after one step
                first.update({k: v.tolist() for k, v in
                              r.model.state_dict().items()
                              if "running" in k})
            return stats
        r.train_step = recorded
        r.train(max_iters=steps)
        r.train_step = step
        return {"records": losses, "buffers_step1": first,
                "digests": dist.all_gather_host(state_digest(r.model))}

    res = {}
    try:
        r = runner("plain")
        res["plain"] = train(r, 2)
        res["plain"]["val"] = r.validate(max_batches=2)
        res["dropout"] = train(runner("dropout", **{
            "backbone.dropout": 0.3, "backbone.emb_dropout": 0.3}), 1)
        res["remat"] = train(runner("remat", remat=True), 1)
        if world > 1:
            r = runner("nan")
            batch = next(iter(build_dataloader(r.cfg.dataset.train, r.cfg)))
            r.train_step(r.state, r._device_batch(batch))
            before = state_digest(r.model)
            opt = [v.clone() for st in r.state.optimizer.state.values()
                   for v in st.values() if torch.is_tensor(v)]
            db = r._device_batch(batch)
            if rank == 1:  # a non-finite input on one rank only
                proj = db["proj"].float() / 255.0
                proj[0, 5, 7, 0] = float("nan")
                db["proj"] = proj
            stats = r.train_step(r.state, db)
            after = [v for st in r.state.optimizer.state.values()
                     for v in st.values() if torch.is_tensor(v)]
            res["nan"] = {
                "skipped": stats["skipped_nan"],
                "loss_finite": bool(torch.isfinite(stats["loss"])),
                "step": r.state.step,
                "state_kept": state_digest(r.model) == before,
                "optimizer_kept": all(torch.equal(a, b)
                                      for a, b in zip(opt, after))}
    finally:
        dist.shutdown()
    with open(os.path.join(work, f"runner_{world}rank_{rank}.json"),
              "w") as f:
        json.dump(res, f)
