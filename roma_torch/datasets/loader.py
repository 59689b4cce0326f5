"""Host-side batch loader: threaded prefetch feeding fixed-shape device batches.

Replaces the reference's DataLoader(num_workers=8) + WeightedRandomSampler +
rank-dependent dataset sizing (train_roma_outdoor.py:236-246,
megadepth.py:52-57). Data parallel: each rank draws its own weighted sample
stream (seeded by `host_id`, the rank) and produces its own rows of the
global batch (`parallel.mesh.global_batch_from_host_local`), replacing DDP's
sampler rank logic. A copy of the JAX package's, but for `PairLoader`,
which hands its batches out in the order the iterator made them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, Sequence

import numpy as np


class ConcatScenes:
    """Flat index over a list of scene datasets."""

    def __init__(self, scenes: Sequence):
        self.scenes = list(scenes)
        self.offsets = np.cumsum([0] + [len(s) for s in self.scenes])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def __getitem__(self, idx: int) -> dict:
        s = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return self.scenes[s][idx - self.offsets[s]]


def collate(items: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def weighted_pair_iterator(
    scenes: Sequence,
    weights: np.ndarray,
    batch_size: int,
    seed: int = 0,
    host_id: int = 0,
    replacement: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Infinite stream of weighted-sampled batches (1/n^alpha scene weights)."""
    ds = ConcatScenes(scenes)
    assert len(ds) == len(weights), (len(ds), len(weights))
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    rng = np.random.default_rng(seed * 10_007 + host_id)
    while True:
        idx = rng.choice(len(ds), size=batch_size, replace=replacement, p=p)
        yield collate([ds[int(i)] for i in idx])


class PairLoader:
    """Threaded prefetcher around any batch iterator. The iterator is not
    thread-safe and its items consume generators in order (a scene's shake
    and flip), so one worker at a time draws the next batch and queues it
    under the same lock: the batches come out in the iterator's order
    while the consumer trains on earlier ones. `next(it)` samples and loads
    at once, so the loads are serialized: a thread beyond the first buys
    nothing (`num_threads` is the JAX package's signature, whose loader
    serializes them the same way)."""

    def __init__(self, it: Iterator[dict], prefetch: int = 4, num_threads: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._it = it
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._done = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop.is_set():
            with self._lock:
                if self._done or self._stop.is_set():
                    return
                try:
                    batch = next(self._it)
                except StopIteration:
                    batch = None
                    self._done = True
                self._q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        batch = self._q.get()
        if batch is None:
            self._stop.set()
            raise StopIteration
        return batch

    def close(self, timeout: float = 30.0):
        """Stop the workers: drain the queue so that none stays blocked on a
        full one, and wait for them."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while any(t.is_alive() for t in self._threads):
            if time.monotonic() > deadline:
                raise RuntimeError("PairLoader: a worker did not stop")
            try:
                self._q.get_nowait()
            except queue.Empty:
                time.sleep(1e-3)
