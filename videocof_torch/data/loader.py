"""Threaded prefetching batch loader (counterpart of
`videocof_tpu/data/loader.py`) — the torch ``DataLoader(num_workers>0)``
role in the reference's training stack (`scripts/train.py` passes the CoT
dataset to a torch DataLoader).

Dataset ``__getitem__`` does host-side work (cv2 video decode, resize,
ground-frame synthesis) that would otherwise serialize with the device step;
cv2 releases the GIL while it decodes and resizes, so a small thread pool
gives real parallelism without worker processes. Batches are yielded in
deterministic submission order regardless of which thread finishes first
(futures are consumed FIFO), so a seeded run is reproducible at any thread
count, and a bounded look-ahead keeps at most ``prefetch_batches`` assembled
batches in memory. The host-to-device copy stays in
`CoFTrainer.prepare_batch`.

Works with either index sampling (shuffled per epoch from a seed) or a
batch sampler like `data.buckets.AspectRatioBatchSampler` that yields index
lists (same-aspect batches).
"""

from __future__ import annotations

import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, List, Optional

import numpy as np


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 2,
        prefetch_batches: int = 2,
        drop_last: bool = True,
        batch_sampler: Optional[Any] = None,
        epochs: Optional[int] = None,
        collate: Optional[Callable[[List[Any]], Any]] = None,
    ):
        """``epochs=None`` iterates forever (fresh shuffle per epoch).
        ``batch_sampler`` overrides batch_size/shuffle/drop_last."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last
        self.batch_sampler = batch_sampler
        self.epochs = epochs
        self.collate = collate

    # ------------------------------------------------------------- indexing
    def _epoch_batches(self, epoch: int) -> Iterator[List[int]]:
        if self.batch_sampler is not None:
            yield from iter(self.batch_sampler)
            return
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        for lo in range(0, n, self.batch_size):
            b = idx[lo:lo + self.batch_size].tolist()
            if len(b) == self.batch_size or not self.drop_last:
                yield b

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> Iterator[Any]:
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            pending: deque = deque()
            # bound look-ahead in BATCHES (a batch_sampler supplies its own
            # batch sizes, so a sample-count bound would collapse the
            # look-ahead for large bucket batches)
            max_batches_ahead = self.prefetch_batches + 1

            def gen_indices():
                epoch = 0
                while self.epochs is None or epoch < self.epochs:
                    for batch in self._epoch_batches(epoch):
                        yield batch
                    epoch += 1

            batches = gen_indices()
            sizes: deque = deque()      # per-batch sizes, FIFO
            alive = True

            def top_up():
                nonlocal alive
                while alive and len(sizes) < max_batches_ahead:
                    try:
                        idxs = next(batches)
                    except StopIteration:
                        alive = False
                        return
                    for i in idxs:
                        pending.append(
                            pool.submit(self.dataset.__getitem__, i))
                    sizes.append(len(idxs))

            top_up()
            while sizes:
                k = sizes.popleft()
                samples = [pending.popleft().result() for _ in range(k)]
                top_up()
                yield self.collate(samples) if self.collate else samples

    def sample_iter(self) -> Iterator[Any]:
        """Flatten batches back to single samples (the `Trainer.train`
        contract, which assembles its own batch_size groups)."""
        for batch in self:
            yield from batch


def device_prefetch(iterator: Iterator, size: int = 1) -> Iterator:
    """Overlap host-side batch production with device execution: a daemon
    thread keeps ``size`` upcoming items ready while the consumer's step
    runs (CUDA launches return before the device finishes, so the device is
    busy during the next item's host work). A worker's exception is raised
    in the consumer."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            if err:
                raise err[0]
            return
        yield item
