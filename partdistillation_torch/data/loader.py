"""Per-process data loader: items -> mapper -> fixed-shape batches.

The port's own copy of the JAX package's ``data/loader.py``: a thread-pool
mapper with a bounded in-flight window and a bounded prefetch queue, the same
per-epoch shuffle keyed by (seed, epoch), so both packages build the same
batches in the same order. Batches are dicts of stacked numpy arrays with
static shapes; the final partial batch of an epoch is padded by repeating the
last example, with a ``batch_valid`` bool vector marking real rows. Mask
stacks (bool, ndim >= 3) are collated as f32, as the JAX package collates
them. ``host_shard`` takes this process's strided slice; without explicit
arguments it reads the torch.distributed rank and world size, or (0, 1).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
from torch.profiler import record_function

__all__ = ["host_shard", "batch_iterator", "DataLoader"]


def host_shard(items: List[dict], process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List[dict]:
    """Strided slice of the item list for this host."""
    if process_index is None or process_count is None:
        import torch.distributed as dist

        ready = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if ready else 0
        process_count = dist.get_world_size() if ready else 1
    return items[process_index::process_count]


def _collate(examples: List[dict], target: int) -> Dict[str, np.ndarray]:
    n = len(examples)
    while len(examples) < target:
        examples = examples + [examples[-1]]
    batch: Dict[str, np.ndarray] = {}
    for key in examples[0]:
        vals = [ex[key] for ex in examples]
        if isinstance(vals[0], str):
            batch[key] = np.asarray(vals, dtype=object)
        else:
            arr = np.stack([np.asarray(v) for v in vals])
            if arr.dtype == bool and arr.ndim >= 3:
                # mask stacks as f32, as the JAX package collates them (the
                # losses take f32); small bool vectors (valid flags) stay bool
                arr = arr.astype(np.float32)
            batch[key] = arr
    batch["batch_valid"] = np.arange(target) < n
    return batch


def batch_iterator(
    items: List[dict],
    mapper: Callable[[dict], Optional[dict]],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    epochs: Optional[int] = 1,
    num_workers: int = 8,
    drop_last: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches; skips items the mapper rejects (returns None).

    ``epochs=None`` repeats forever (training); per-epoch reshuffle keyed by
    (seed, epoch).
    """
    if not items:
        return
    import os

    # 0 = synchronous-ish: one worker thread; never more threads than cores
    # (on a 1-cpu host, extra threads only add GIL contention — measured
    # 58 img/s single-thread vs 14 img/s with 8 workers)
    num_workers = max(min(num_workers, os.cpu_count() or num_workers), 1)
    epoch = 0
    # pending carries across epochs: with fewer usable items than batch_size
    # (fewshot subsets, heavy mapper filtering) a batch still fills after
    # several epochs instead of spinning forever under drop_last.
    pending: List[dict] = []
    while epochs is None or epoch < epochs:
        order = np.arange(len(items))
        if shuffle:
            np.random.RandomState((seed, epoch)).shuffle(order)
        got_any = False
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            # Bounded in-flight window instead of pool.map: map() schedules
            # the WHOLE epoch eagerly and buffers every decoded example in
            # finished futures (no backpressure -> OOM at ~8 MB/example on
            # million-item epochs). _epoch is injected for per-item augment
            # RNG derivation (mappers._item_rng).
            ep = epoch

            def submit(i):
                return pool.submit(mapper, {**items[int(i)], "_epoch": ep})

            window = 2 * max(num_workers, 1)
            from collections import deque

            inflight = deque(submit(i) for i in order[:window])
            next_idx = window
            while inflight:
                example = inflight.popleft().result()
                if next_idx < len(order):
                    inflight.append(submit(order[next_idx]))
                    next_idx += 1
                if example is None:
                    continue
                got_any = True
                pending.append(example)
                if len(pending) == batch_size:
                    yield _collate(pending, batch_size)
                    pending = []
        if epochs is None and not got_any:
            return  # every item rejected: an infinite loader would spin forever
        epoch += 1
    if pending and not drop_last:
        yield _collate(pending, batch_size)


class DataLoader:
    """batch_iterator + a background prefetch thread (bounded queue).
    ``close()`` stops the thread at its next batch (an endless training
    loader would otherwise keep a full queue alive after the loop ends).
    The consumer's wait on the queue runs in the profiler span
    ``loader.wait``; ``stats()`` counts the batches handed out and those
    asked for while the queue held none."""

    def __init__(self, items: List[dict], mapper, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 epochs: Optional[int] = 1, num_workers: int = 8,
                 prefetch: int = 4, drop_last: bool = False):
        self._iter = batch_iterator(items, mapper, batch_size, shuffle, seed,
                                    epochs, num_workers, drop_last)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        # written by the consuming thread alone
        self._taken = self._taken_empty = 0
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        try:
            for batch in self._iter:
                if not self._put(batch):
                    return
        except BaseException as e:  # surface in the consumer, don't die silent
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        while True:
            empty = self._q.empty()
            with record_function("loader.wait"):
                batch = self._q.get()
            if batch is self._done:
                if self._error is not None:
                    raise RuntimeError("DataLoader worker failed") from self._error
                return
            self._taken += 1
            self._taken_empty += empty
            yield batch

    def stats(self) -> Dict[str, int]:
        """``taken``: batches handed out; ``taken_empty``: those of them
        asked for while the prefetch queue held none."""
        return {"taken": self._taken, "taken_empty": self._taken_empty}

    def close(self):
        self._stop.set()
        self._thread.join()
        self._iter.close()  # shuts the mapper pool down
