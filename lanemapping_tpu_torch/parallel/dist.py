"""Process-group utilities (port of `lanemapping_tpu/parallel/dist.py`).

``maybe_initialize_distributed`` starts the group from the JAX package's
environment (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) or
its arguments, on ``tcp://<coordinator>``.  Rank ``r`` takes device
``r % len(devices)`` of its host's mesh; the backend follows from that
assignment, as this rank sees it on its own host: NCCL when each of the
host's ranks has a card of its own, gloo when ranks share a card or run
on the CPU.  The host's rank count is ``LOCAL_WORLD_SIZE`` when set, else
every rank when the coordinator is on the loopback address, else one rank
per card of the mesh.  With gloo, CUDA tensors support only
``broadcast`` and ``all_reduce``, so every collective on device tensors
here is an ``all_reduce``, and host objects travel with
``all_gather_object``.

The host helpers (``get_rank`` ... ``all_reduce_mean_host``) are the JAX
module's.  The device helpers serve the global-batch semantics of the
train step: ``sum_over_ranks`` (a count or a statistic, no gradient),
``SumOverRanks`` (a differentiable sum, whose backward sums the gradient
over the ranks), ``global_rows`` and ``global_mean``.  Every one of them
returns its input unchanged at a world of one.
"""

from __future__ import annotations

import os
import socket
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist


_LOOPBACK = ("127.0.0.1", "localhost")


def rank_devices(devices: Sequence, world: int) -> List[torch.device]:
    """The device of each rank: rank ``r`` takes ``devices[r % n]``."""
    devices = [torch.device(d) for d in devices]
    return [devices[r % len(devices)] for r in range(world)]


def local_world_size(coordinator: str, world: int, n_devices: int) -> int:
    """The number of ranks on this host: ``LOCAL_WORLD_SIZE`` when set, else
    all ``world`` behind a loopback coordinator, else one rank per device
    of the host's mesh."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if coordinator.rsplit(":", 1)[0] in _LOOPBACK:
        return world
    return min(world, n_devices)


def backend_for(devices: Sequence, local_world: int) -> str:
    """``nccl`` when each of the host's ``local_world`` ranks, dealt onto
    the host's mesh ``devices``, has a card of its own; else ``gloo``
    (ranks sharing a card, or on the CPU)."""
    cards = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in cards):
        idx = {d.index if d.index is not None else 0 for d in cards}
        if len(idx) == len(cards) and local_world <= len(cards):
            return "nccl"
    return "gloo"


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a coordinator on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 devices: Optional[Sequence] = None
                                 ) -> Optional[torch.device]:
    """Join the process group; returns this rank's device.  A no-op (None)
    unless ``coordinator`` or ``COORDINATOR_ADDRESS`` is set.  ``devices``
    is the mesh the ranks are dealt onto (default: every local card,
    `mesh.py::make_mesh`)."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if coordinator is None:
        return None
    # NB: rank 0 is falsy — `process_id or env[...]` would misroute the
    # coordinator process
    if num_processes is None:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    if devices is None:
        from .mesh import make_mesh
        devices = make_mesh()
    num_processes, process_id = int(num_processes), int(process_id)
    devices = [torch.device(d) for d in devices]
    backend = backend_for(devices, local_world_size(
        coordinator, num_processes, len(devices)))
    device = rank_devices(devices, num_processes)[process_id]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator.rsplit(":", 1)[0] in _LOOPBACK:
        # every rank on this host: connect the ranks over the loopback
        # interface, whatever the host's name resolves to
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    why = "a card per rank" if backend == "nccl" else \
        "ranks share a card" if device.type == "cuda" else "CPU ranks"
    print(f"[dist] rank {process_id} of {num_processes} on {device}: "
          f"{backend} backend ({why})", flush=True)
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)
    return device


def shutdown() -> None:
    """Leave the process group (after a barrier); a no-op without one."""
    if tdist.is_available() and tdist.is_initialized():
        synchronize()
        tdist.destroy_process_group()


def get_rank() -> int:
    return tdist.get_rank() if tdist.is_available() and \
        tdist.is_initialized() else 0


def get_world_size() -> int:
    return tdist.get_world_size() if tdist.is_available() and \
        tdist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def dist_print(*args, **kwargs) -> None:
    """Rank-0-gated print (reference `dist_utils.py:38-41`)."""
    if is_main_process():
        print(*args, **kwargs)


def synchronize() -> None:
    """Barrier over the ranks (reference `dist_utils.py:43-55`)."""
    if get_world_size() > 1:
        tdist.barrier()


def all_gather_host(value: Any) -> List[Any]:
    """One host object (a tree of scalars and arrays) per rank, in rank
    order (reference `dist_utils.py:112-152`).  Unlike JAX's
    ``process_allgather``, ``all_gather_object`` already returns one tree
    per rank, so nothing needs re-splitting."""
    if get_world_size() == 1:
        return [value]
    out: List[Any] = [None] * get_world_size()
    tdist.all_gather_object(out, value)
    return out


def all_reduce_mean_host(x: np.ndarray) -> np.ndarray:
    """Mean over ranks of a host array (reference `dist_utils.py:94-109`)."""
    return np.mean(np.stack(all_gather_host(np.asarray(x))), axis=0)


# -- device tensors: the global batch of the train step -----------------------

def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, detached (a count or a statistic);
    ``x`` itself at a world of one."""
    if get_world_size() == 1:
        return x
    y = x.detach().clone()
    tdist.all_reduce(y)
    return y


class SumOverRanks(torch.autograd.Function):
    """Differentiable sum over the ranks: every rank gets the global value,
    and the backward pass sums the incoming gradients over the ranks, so
    a loss computed from the global value on every rank (and divided by
    the world size) has the global loss's gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        tdist.all_reduce(g)
        return g


def sum_over_ranks_grad(x: torch.Tensor) -> torch.Tensor:
    return x if get_world_size() == 1 else SumOverRanks.apply(x)


def global_rows(n: int) -> int:
    """Rows of the global batch when each rank holds ``n``."""
    return n * get_world_size()


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's contribution to the mean of ``x`` over the global batch
    (ranks hold equal shards): ``torch.mean(x)`` at a world of one."""
    world = get_world_size()
    if world == 1:
        return torch.mean(x)
    return torch.sum(x) / (x.numel() * world)
