"""The batch loop of the port's evaluation, export and serving paths: the
device stage of one batch on the calling thread while worker threads run
the host stage (readback, postprocess, metrics, files) of the batches
before it."""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional


def pipelined(batches: Iterable, device_fn: Callable, host_fn: Callable,
              workers: int, max_batches: Optional[int] = None) -> List:
    """``[host_fn(device_fn(b), b) for b in batches]``, the first
    ``max_batches`` of them, in batch order.

    ``device_fn`` runs on the calling thread, ``host_fn`` on a pool of
    ``workers`` threads (inline at 0).  At most ``2 * workers`` batches
    are in flight: each pins its batch in host memory and its device
    output.  An exception in ``host_fn`` is raised here, where its result
    is taken."""
    batches = itertools.islice(batches, max_batches)
    if workers == 0:
        return [host_fn(device_fn(b), b) for b in batches]
    results, pending = [], deque()
    with ThreadPoolExecutor(workers) as pool:
        for b in batches:
            pending.append(pool.submit(host_fn, device_fn(b), b))
            while len(pending) >= 2 * workers:
                results.append(pending.popleft().result())
        results.extend(f.result() for f in pending)
    return results
