"""DataLoader: host-side batching with background prefetch (counterpart of
``tlxcv_tpu/data/loader.py``).

Collates to stacked numpy arrays; a background thread keeps ``prefetch``
batches ahead so host work overlaps the card's steps.  ``device_prefetch``
keeps the next transfers in flight; the Trainer's transfer is a
``non_blocking`` copy from pinned memory.
"""
from __future__ import annotations

import queue
import threading
import typing as tp

import numpy as np


def default_collate(samples):
    elem = samples[0]
    if isinstance(elem, tuple) and hasattr(elem, "_fields"):  # namedtuple
        return type(elem)(*(default_collate(list(s)) for s in zip(*samples)))
    if isinstance(elem, (tuple, list)):
        return type(elem)(default_collate(list(s)) for s in zip(*samples))
    if isinstance(elem, dict):
        return {k: default_collate([s[k] for s in samples]) for k in elem}
    if isinstance(elem, np.ndarray):
        return np.stack(samples)
    if isinstance(elem, (int, np.integer)):
        return np.asarray(samples, np.int32)
    if isinstance(elem, (float, np.floating)):
        return np.asarray(samples, np.float32)
    return np.asarray(samples)


class DataLoader:
    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 collate_fn=None, prefetch=2, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idx])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def worker():
            try:
                for b in self._batches():
                    # Poll the stop flag so an abandoned iterator (e.g.
                    # Trainer's max_steps_per_epoch breaking early) does
                    # not leave this thread blocked on a full queue.
                    while not stop.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # propagate to consumer
                err.append(e)
            finally:
                # Block-put the sentinel with the same stop-polling loop
                # as batches: the old eviction path (get_nowait to make
                # room) DISCARDED a real undelivered batch whenever the
                # consumer was slower than the loader — one silently
                # dropped batch per epoch.  If stop is set the consumer
                # is gone and no sentinel is needed.
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # Generator closed (early break / GC): release the worker.
            stop.set()


def device_prefetch(batches: tp.Iterable, put: tp.Callable, depth: int = 2):
    """Keep ``depth`` device transfers in flight ahead of the consumer.

    ``put`` is the host->device placement (e.g. ``Trainer._put_batch``, a
    ``non_blocking`` copy from pinned memory), so issuing batch t+1's
    transfer before batch t's step is consumed overlaps the copy with the
    card's work.  Pure lookahead: no threads, safe to abandon early.
    """
    import collections

    buf: collections.deque = collections.deque()
    it = iter(batches)
    try:
        while len(buf) < depth:
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out
