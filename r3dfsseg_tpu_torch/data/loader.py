"""Prefetching episode loader (counterpart of `r3dfsseg_tpu/data/loader.py`).

A thread pool overlaps host-side episode assembly (numpy and the native C
pass, which release the interpreter lock) with device compute, and stacks
`episode_batch` episodes into one batched Episode.  Batch i is always
produced by worker i % n_workers and batches are yielded strictly in index
order, so with per-worker seeded samplers a run is bit-reproducible
whatever the thread scheduling (the JAX package's ordered mode; its
unordered mode has no caller and is not ported).  Worker exceptions (e.g. a
sampler ValueError when a class has too few scans) propagate to the
consuming iterator instead of hanging it.

`device_prefetch` puts batches on the device a batch or two ahead of the
step that takes them: pinned host tensors copied with ``non_blocking``.
"""
from __future__ import annotations

import heapq
import queue
import threading
from collections import deque
from typing import Callable, Iterator, Optional

from r3dfsseg_tpu_torch.models.episode import Episode, stack_episodes


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def to_device(ep, device):
    """An episode's numpy fields (or a plain tuple's: pretraining's (x, y)
    batches) as tensors on ``device``, in a container of the same type.
    On a CUDA device each field goes through pinned host memory and is
    copied without blocking the host, so the copy overlaps the step before
    it."""
    import torch

    device = torch.device(device)
    pin = device.type == "cuda"

    def put(a):
        if a is None:
            return None
        t = torch.as_tensor(a)
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    fields = [put(a) for a in ep]
    return type(ep)(*fields) if isinstance(ep, Episode) else tuple(fields)


def device_prefetch(it, device, n: int = 2):
    """Yield ``it``'s episodes (or tuples) on ``device``, with ``n`` copies submitted ahead
    of the one yielded (the counterpart of the JAX package's
    `device_put_prefetch`)."""
    buf = deque()
    for item in it:
        buf.append(to_device(item, device))
        if len(buf) >= max(n, 1):
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def prefetch_iter(it, prefetch: int = 4):
    """Run an iterator on a background thread, keeping up to `prefetch`
    items ready.  Order-preserving; exceptions re-raise at the consumer.
    Used by the eval path so episode file reads overlap device compute."""
    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    _end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(_WorkerError(e))
        q.put(_end)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _end:
            return
        if isinstance(item, _WorkerError):
            raise item.exc
        yield item


class EpisodeLoader:
    def __init__(self, sample_fn: Callable[[], Episode], *,
                 num_batches: int, episode_batch: int = 1, prefetch: int = 4,
                 worker_fns: Optional[list] = None, start: int = 0):
        """`sample_fn` is used by a single worker; for more workers pass
        `worker_fns` (one independent sampler per worker — numpy Generators
        are not thread-safe).  With ``start`` the workers draw batches
        0 .. start-1 and drop them, and the loader yields batches
        start .. num_batches-1: the stream a resumed run continues."""
        self.worker_fns = worker_fns or [sample_fn]
        self.num_batches = num_batches
        self.episode_batch = episode_batch
        self.prefetch = prefetch
        self.start = start

    def __len__(self):
        return self.num_batches - self.start

    def _make_batch(self, fn):
        eps = [fn() for _ in range(self.episode_batch)]
        return stack_episodes(eps) if self.episode_batch > 1 else eps[0]

    def __iter__(self) -> Iterator[Episode]:
        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()
        n_workers = len(self.worker_fns)
        # In-order release uses a pending buffer on the consumer side, so
        # the queue's maxsize alone cannot bound memory (a stalled worker
        # would let the others run arbitrarily far ahead).  Workers instead
        # wait until their next index is within `window` of consumption.
        window = max(self.prefetch, 1) + n_workers
        cond = threading.Condition()
        progress = {"yielded": self.start}

        def worker(w, fn):
            for i in range(w, self.num_batches, n_workers):
                if stop.is_set():
                    return
                if i < self.start:
                    try:
                        self._make_batch(fn)      # drawn and dropped
                    except BaseException as e:  # handed to the consumer, first
                        q.put((-1 - w, _WorkerError(e)))
                        return
                    continue
                with cond:
                    while not stop.is_set() and i - progress["yielded"] >= window:
                        cond.wait(timeout=0.2)
                if stop.is_set():
                    return
                try:
                    item = (i, self._make_batch(fn))
                except BaseException as e:  # handed to the consumer
                    item = (i, _WorkerError(e))
                q.put(item)

        threads = [threading.Thread(target=worker, args=(w, fn), daemon=True)
                   for w, fn in enumerate(self.worker_fns)]
        for t in threads:
            t.start()
        pending: list = []   # (index, batch) heap for in-order release
        next_idx = self.start
        try:
            while next_idx < self.num_batches:
                while not (pending and pending[0][0] <= next_idx):
                    heapq.heappush(pending, q.get())
                _, batch = heapq.heappop(pending)
                if isinstance(batch, _WorkerError):
                    raise batch.exc
                next_idx += 1
                with cond:
                    progress["yielded"] = next_idx
                    cond.notify_all()
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            # drain so workers blocked on put() can exit
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
