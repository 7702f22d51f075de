"""Threaded prefetching batch loader (copy of side_tpu/data/loader.py).

TPU-native replacement for torch DataLoader(num_workers=N)
(/root/reference/src/testTrain.py:70-77): a thread pool decodes/augments
samples (cv2 releases the GIL) while the device consumes previous batches;
batches are plain NumPy dicts, moved to the device by the trainer.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np

from .dataset import collate


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 0, prefetch: int = 2, keep_meta: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.rng = np.random.RandomState(seed)
        self.prefetch = prefetch
        self.keep_meta = keep_meta
        # ring of reusable batch buffers, persistent ACROSS epochs (the
        # trainer re-iterates the same Loader every epoch): prefetch queued
        # + 1 in-flight in the producer + 1 held by the consumer.
        self._ring = [dict() for _ in range(prefetch + 2)]
        self._ring_i = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        n = len(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        for i in range(0, stop, self.batch_size):
            yield idx[i:i + self.batch_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        STOP = object()

        def make_batch(batch_idx):
            samples = list(pool.map(self.dataset.__getitem__, batch_idx))
            # reuse a ring buffer (see __init__).  Contract: a yielded
            # batch is overwritten after `prefetch + 1` further batches are
            # consumed (trainer/detector copy to device immediately, so
            # this never bites; deep-copy if you must keep one).  Avoids
            # fresh first-touch pages per batch — see collate's docstring.
            buf = self._ring[self._ring_i % len(self._ring)]
            self._ring_i += 1
            batch = collate(samples, out=buf)
            if not self.keep_meta:
                batch.pop("meta", None)
            return batch

        def producer():
            try:
                for batch_idx in self._batches():
                    q.put(make_batch(batch_idx))
            finally:
                q.put(STOP)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is STOP:
                    break
                yield item
        finally:
            pool.shutdown(wait=False)
