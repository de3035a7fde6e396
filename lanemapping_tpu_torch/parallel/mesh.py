"""The devices of the ``data`` axis and the row split of a batch over them
(port of `lanemapping_tpu/parallel/mesh.py`).

A torch program has no logical array that spans devices, so the JAX mesh
becomes a list of ``torch.device``: one model replica per device when one
process serves (`tools/stream_map.py`), one rank per device when several
processes train (`tools/train.py`).  ``batch_sharding`` / ``shard_batch``
become a split by rows: replica or rank ``i`` of ``n`` takes rows
``[i*B/n, (i+1)*B/n)``, and a batch whose rows do not divide evenly is
refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def make_mesh(cfg=None, devices: Optional[Sequence[Device]] = None,
              device: Device = "cuda") -> List[torch.device]:
    """The devices of the config's ``data`` axis (JAX `mesh.py:20-32`).

    ``devices`` defaults to every local card (``device="cuda"``, which
    raises on a machine with none), to the one card named (``"cuda:1"``) or
    to the one CPU (``device="cpu"``).
    ``cfg.mesh_shape`` (default ``{"data": -1}``) sizes the axis: -1 takes
    every device, a size larger than the number of devices shrinks to it.
    """
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda" and torch.device(device).index is not None:
            devices = [torch.device(device)]
        elif kind == "cuda":
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError(
                    "make_mesh: CUDA asked for and no card is available; "
                    "pass device='cpu' to run on the CPU")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [torch.device(kind)]
    devices = [torch.device(d) for d in devices]
    shape = dict(cfg.get("mesh_shape", {"data": -1})) if cfg is not None \
        else {"data": -1}
    if set(shape) != {"data"}:
        raise ValueError(f"mesh_shape {shape}: the port shards the batch "
                         f"over one 'data' axis only")
    size = int(shape["data"])
    if size == -1 or size > len(devices):
        size = len(devices)  # fewer devices than asked for: shrink the axis
    if size < 1:
        raise ValueError(f"mesh_shape {shape}: the data axis needs >= 1 "
                         f"device")
    return devices[:size]


def row_slice(i: int, n: int, rows: int) -> slice:
    """Rows ``[i*rows/n, (i+1)*rows/n)``: replica or rank ``i`` of ``n``."""
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not divide over {n} "
                         f"devices")
    k = rows // n
    return slice(i * k, (i + 1) * k)


def shard_batch(batch: Dict, mesh: Sequence[torch.device]
                ) -> List[Dict[str, torch.Tensor]]:
    """One dict per device of ``mesh``: its rows of every array of
    ``batch``, on that device.  String metadata stays on the host (it is
    left out, as in the JAX package)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in mesh]
    for k, v in batch.items():
        if isinstance(v, (list, tuple)) and v and isinstance(v[0], str):
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        for i, dev in enumerate(mesh):
            out[i][k] = t[row_slice(i, len(mesh), t.shape[0])].to(dev)
    return out
