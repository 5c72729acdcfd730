"""Background-thread batch prefetching.

Capability of the reference's DataLoader worker processes (SURVEY.md §2.7
"CPU data-loading parallelism": ``num_workers = os.cpu_count()*2`` etc.) —
host-side sample assembly overlaps device steps so the device never starves
(the reference's measured bottleneck was exactly this, the ``voxel_gene_time``
telemetry). Threads (not processes) suffice here because the heavy lifting
is numpy/C++ releasing the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

__all__ = ["ThreadedPrefetcher", "MappedPrefetcher", "prefetch"]

_SENTINEL = object()


class MappedPrefetcher:
    """Parallel map over a cheap work iterator — the scalable worker design.

    ``ThreadedPrefetcher`` serializes the whole ``next()`` under one lock,
    which lock-steps workers when the source iterator does the heavy sample
    assembly. Here the lock only covers pulling a WORK ITEM (e.g. a token
    chunk or index list — microseconds) and ``map_fn`` (imread, voxelize,
    augment — the actual cost) runs outside it, on ``num_workers`` threads
    concurrently. Output order matches the work order when ``ordered`` (a
    reorder buffer holds at most ``depth + num_workers`` items), so training
    stays reproducible.
    """

    def __init__(
        self,
        make_work_iter: Callable[[], Iterable],
        map_fn: Callable,
        num_workers: int = 4,
        depth: int = 8,
        ordered: bool = True,
    ):
        self.make_work_iter = make_work_iter
        self.map_fn = map_fn
        self.num_workers = max(num_workers, 1)
        self.depth = depth
        self.ordered = ordered

    def __iter__(self) -> Iterator:
        work = iter(self.make_work_iter())
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        lock = threading.Lock()
        stop = threading.Event()
        errors: list = []
        counter = [0]

        def worker():
            while not stop.is_set():
                with lock:
                    try:
                        item = next(work)
                    except StopIteration:
                        break
                    except Exception as e:
                        errors.append(e)
                        stop.set()  # wind down the other workers promptly
                        break
                    idx = counter[0]
                    counter[0] += 1
                try:
                    val = self.map_fn(item)
                except Exception as e:
                    errors.append(e)
                    stop.set()
                    break
                # Bounded put that can bail out when the consumer stops early.
                while not stop.is_set():
                    try:
                        q.put((idx, val), timeout=0.1)
                        break
                    except queue.Full:
                        continue
            q.put(_SENTINEL)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        finished = 0
        pending: dict = {}
        expect = 0
        try:
            while finished < self.num_workers:
                item = q.get()
                if item is _SENTINEL:
                    finished += 1
                    continue
                idx, val = item
                if not self.ordered:
                    yield val
                    continue
                pending[idx] = val
                while expect in pending:
                    yield pending.pop(expect)
                    expect += 1
            # Drain any late items put before sentinels were counted.
            while self.ordered and expect in pending:
                yield pending.pop(expect)
                expect += 1
            if errors:
                raise errors[0]
        finally:
            stop.set()


class ThreadedPrefetcher:
    """Wrap an iterator; ``depth`` batches are produced ahead by workers."""

    def __init__(self, make_iter: Callable[[], Iterable], depth: int = 4,
                 num_workers: int = 1):
        self.make_iter = make_iter
        self.depth = depth
        self.num_workers = num_workers

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        src = iter(self.make_iter())
        lock = threading.Lock()
        stop = threading.Event()
        errors: list = []

        def worker():
            while not stop.is_set():
                try:
                    with lock:
                        item = next(src)
                except StopIteration:
                    q.put(_SENTINEL)
                    return
                except Exception as e:  # surface loader errors to the consumer
                    errors.append(e)
                    q.put(_SENTINEL)
                    return
                q.put(item)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()
        finished = 0
        try:
            while finished < self.num_workers:
                item = q.get()
                if item is _SENTINEL:
                    finished += 1
                    continue
                yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()


def prefetch(iterable: Iterable, depth: int = 4) -> Iterator:
    """One-shot convenience wrapper."""
    return iter(ThreadedPrefetcher(lambda: iterable, depth=depth))
