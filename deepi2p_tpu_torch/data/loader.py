"""Batching over an indexable dataset, and the move of batches to the card.

:class:`BatchLoader` is the JAX package's ``data/prefetch.py::BatchLoader``:
``num_workers`` threads take batch indices from one queue, call the one
dataset object, collate, and leave the batch in a bounded ready buffer
from which the consumer takes batches in order.  With ``shuffle`` the
order is ``np.random.default_rng(seed).shuffle`` of the indices, as
there, so one seed gives one order in both packages.  With ``shard=(r,
n)`` the loader reads block ``r`` of ``n`` equal blocks of each batch of
that order, a rank's share of a batch split over ``n`` ranks.  The last
partial batch is dropped, and a sample that fails to load reaches the
consumer as its exception, as the JAX loader's defaults have it.
Threads, not processes: the loaders' numpy and file reads release the
interpreter lock for most of a sample, and every worker shares the
dataset (a dataset whose samples draw from one generator, as the real
loaders' do, then sees its draws in the order the threads reach it; one
worker keeps the order of the indices).

:func:`device_prefetch` keeps ``size`` batches on their way to the card:
a helper thread takes each collated batch from the loader, pins it and
copies it with ``non_blocking=True`` on a side stream; the consumer's
stream waits on the copy's event before it uses the batch.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Dict, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from .base import collate


class BatchLoader:
    """Threaded sample -> batch pipeline over any indexable dataset."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 num_workers: int = 1, seed: int = 0, prefetch: int = 4,
                 shard: tuple = (0, 1)):
        if batch_size < 1:
            raise ValueError(f"batch_size {batch_size} < 1")
        if batch_size % shard[1] or not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard {shard} of a batch of {batch_size}")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        bs = self.batch_size
        r, n = self.shard
        part = bs // n
        batches = [order[i + r * part:i + (r + 1) * part]
                   for i in range(0, len(self) * bs, bs)]

        tasks: queue.Queue = queue.Queue()
        for task in enumerate(batches):
            tasks.put(task)
        ready: Dict[int, object] = {}
        cond = threading.Condition()
        state = {"next": 0, "stop": False}
        cap = self.prefetch + self.num_workers

        def worker():
            while True:
                with cond:
                    if state["stop"]:
                        return
                try:
                    bi, idxs = tasks.get_nowait()
                except queue.Empty:
                    return
                try:
                    out = collate([self.dataset[int(i)] for i in idxs])
                except Exception as e:  # handed to the consumer
                    out = e
                with cond:
                    # bounded ready buffer, but the batch the consumer
                    # waits for is always taken (no deadlock)
                    while (len(ready) >= cap and bi != state["next"]
                           and not state["stop"]):
                        cond.wait()
                    if state["stop"]:
                        return
                    ready[bi] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for bi in range(len(batches)):
                with cond:
                    while bi not in ready:
                        cond.wait()
                    out = ready.pop(bi)
                    state["next"] = bi + 1
                    cond.notify_all()
                if isinstance(out, BaseException):
                    raise out
                yield out
        finally:
            with cond:
                state["stop"] = True
                cond.notify_all()
            for t in threads:
                t.join()


def device_prefetch(batches: Iterable[Dict[str, np.ndarray]],
                    device="cuda", size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of numpy arrays -> batches of tensors on ``device``, with
    up to ``size`` copies in flight ahead of the consumer.

    On the card a helper thread takes each batch from ``batches``, pins
    its arrays and copies them with ``non_blocking=True`` on a side
    stream, so the consumer waits only for the batch it takes next.
    Before a batch is handed out the consumer's current stream waits on
    its copy's event, and its tensors are recorded on that stream (the
    allocator then keeps their memory until the consumer's work is done).
    Each pinned buffer is kept until its copy's event has completed.  A
    failure of ``batches`` reaches the consumer in its place.  On the CPU
    the batch is the arrays as tensors.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        for b in batches:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in b.items()}
        return
    side = torch.cuda.Stream(device=dev)
    copied: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                copied.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def helper():
        it = iter(batches)
        try:
            with torch.cuda.device(dev):
                for b in it:
                    host = {k: torch.from_numpy(
                        np.ascontiguousarray(v)).pin_memory()
                        for k, v in b.items()}
                    with torch.cuda.stream(side):
                        on_dev = {k: v.to(dev, non_blocking=True)
                                  for k, v in host.items()}
                        event = torch.cuda.Event()
                        event.record(side)
                    if not offer((on_dev, event, host)):
                        event.synchronize()
                        return
            offer(done)
        except BaseException as e:  # handed to the consumer
            offer(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=helper, daemon=True)
    thread.start()
    pinned: deque = deque()      # (event, pinned batch) until the copy ends
    try:
        while True:
            item = copied.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            on_dev, event, host = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            for v in on_dev.values():
                v.record_stream(consumer)
            while pinned and pinned[0][0].query():
                pinned.popleft()
            pinned.append((event, host))
            yield on_dev
    finally:
        stop.set()
        thread.join()
        while not copied.empty():
            item = copied.get_nowait()
            if isinstance(item, tuple):
                item[1].synchronize()
        for event, _ in pinned:
            event.synchronize()
        pinned.clear()
