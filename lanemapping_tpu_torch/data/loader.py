"""Batched, prefetching data loader (a copy of
`lanemapping_tpu/data/loader.py`).

Numpy samples are assembled into batches on a thread pool and prefetched
ahead of the device step, so host-side LAS parsing and proposal-GT builds
overlap device compute.  Under a process group of more than one rank
(`parallel/dist.py`) ``build_dataloader`` gives each rank its slice of
every global batch, train and eval loaders alike, as the JAX package
does: rank ``r`` of ``n`` loads rows ``[r*B/n, (r+1)*B/n)`` of each
global batch of ``cfg.batch_size``, and ragged tails are dropped so that
every rank holds as many rows.  Shuffling is keyed by seed + epoch as in
the JAX package, so for one seed both packages see the same batches in
the same order, and all ranks shuffle alike.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, str):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_threads: int = 4, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size  # GLOBAL batch size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over "
                f"{process_count} processes")

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last or self.process_count > 1:
            # multi-host always drops the ragged tail (every process must
            # contribute an equal slice to the global array)
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[np.ndarray]:
        """Per-process index batches for this epoch.  All processes shuffle
        identically (same seed+epoch), so rank slices of each global batch
        are disjoint and together cover the epoch exactly once."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        local = self.batch_size // self.process_count
        batches = []
        for i in range(0, n, self.batch_size):
            b = idx[i:i + self.batch_size]
            if len(b) < self.batch_size and (self.drop_last
                                             or self.process_count > 1):
                # multi-host always drops ragged tails: every process must
                # contribute an equal slice to the global array
                continue
            b = b[self.process_index * local:(self.process_index + 1) * local]
            batches.append(b)
        return batches

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        self.epoch += 1
        if self.num_threads == 1:
            for b in batches:
                yield collate([self.dataset[int(i)] for i in b])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            # bounded put that re-checks stop: an abandoned iterator must
            # not leave this thread blocked forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self.num_threads) as ex:
                    for b in batches:
                        if stop.is_set():
                            break
                        samples = list(ex.map(
                            lambda i: self.dataset[int(i)], b))
                        if not put_checked(collate(samples)):
                            return
            except Exception as e:  # surface worker errors to the consumer
                put_checked(e)
            finally:
                put_checked(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def build_dataloader(split_cfg, cfg, is_train: bool = True) -> Loader:
    """Factory mirroring the reference `build_dataloader`
    (`datasets/registry.py:33-62`): this rank's slice of the global
    batches when the process group has more than one rank."""
    from ..parallel.dist import get_rank, get_world_size
    from ..registry import build_dataset

    return Loader(
        build_dataset(split_cfg, cfg),
        batch_size=cfg.batch_size,
        shuffle=is_train,
        drop_last=is_train,
        seed=cfg.get("seed", 0),
        num_threads=min(8, max(1, cfg.get("workers", 4))),
        process_index=get_rank(),
        process_count=get_world_size(),
    )
