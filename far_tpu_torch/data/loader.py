"""Batching with background prefetch on host threads.

The port's own copy of ``far_tpu/data/loader.py``. ``collate_pairs``
stacks sample dicts into a ``PairBatch`` of CPU tensors (float32, and
``pair_id`` int64); an optional field goes in only where every sample has
it. ``Loader`` walks an index list in batches (the tail that does not fill
one is dropped), made ahead by ``workers`` threads: batch b by thread
b % workers into a queue of its own, ``prefetch`` deep, read round-robin,
so the order does not depend on the threads' timing. A worker's exception
is raised in the consumer. The caller moves each batch to the model's
device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from far_tpu_torch.types import PairBatch

_OPTIONAL = ("T_0to1", "T_1to0", "depth0", "depth1", "scale0", "scale1")


def collate_pairs(samples: List[Dict]) -> PairBatch:
    """Stack sample dicts into a PairBatch of CPU tensors."""
    def stack(key):
        return torch.from_numpy(np.stack([np.asarray(s[key], np.float32)
                                          for s in samples]))

    kwargs = {k: stack(k) for k in ("image0", "image1", "K0", "K1")}
    kwargs["pair_id"] = torch.from_numpy(np.stack([np.asarray(s["pair_id"])
                                                   for s in samples]))
    for key in _OPTIONAL:
        if all(key in s for s in samples):
            kwargs[key] = stack(key)
    return PairBatch(**kwargs)


def to_device(batch: PairBatch, device=None) -> PairBatch:
    """The batch with every tensor moved to ``device`` (None: where it is)."""
    return PairBatch(**{f.name: None if getattr(batch, f.name) is None
                        else getattr(batch, f.name).to(device)
                        for f in dataclasses.fields(batch)})


class Loader:
    """Iterate a dataset by index list with background prefetch.

    Args:
        dataset: sequence-like with __getitem__ -> sample dict.
        indices: iteration order (``far_tpu_torch.data.sampler``).
        batch_size: pairs a batch; the tail is dropped.
        prefetch: batches each worker prepares ahead.
        keep_meta: yield (batch, {"pair_names", "scene"}) pairs.
        workers: threads making batches.
    """

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 prefetch: int = 2, collate=collate_pairs,
                 keep_meta: bool = False, workers: int = 1):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.collate = collate
        self.keep_meta = keep_meta
        self.workers = max(1, workers)

    def __len__(self):
        return len(self.indices) // self.batch_size

    def _make_batch(self, b: int):
        idx = self.indices[b * self.batch_size:(b + 1) * self.batch_size]
        samples = [self.dataset[int(i)] for i in idx]
        batch = self.collate(samples)
        if self.keep_meta:
            meta = {"pair_names": [s.get("pair_names") for s in samples],
                    "scene": [s.get("scene") for s in samples]}
            return batch, meta
        return batch

    def _produce(self, q: queue.Queue, worker: int):
        try:
            for b in range(worker, len(self), self.workers):
                q.put(self._make_batch(b))
            q.put(None)
        except BaseException as e:  # raised again in the consumer
            q.put(e)

    def __iter__(self) -> Iterator:
        queues = [queue.Queue(maxsize=self.prefetch) for _ in range(self.workers)]
        for w, q in enumerate(queues):
            threading.Thread(target=self._produce, args=(q, w), daemon=True).start()
        for b in range(len(self)):
            item = queues[b % self.workers].get()
            if isinstance(item, BaseException):
                raise item
            assert item is not None
            yield item
