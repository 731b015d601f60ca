"""Threaded prefetching batch loader (the port of ccvpe_tpu/data/loader.py).

Samples are decoded by a pool of threads (PIL releases the GIL while it
decodes and resizes), stacked into NHWC numpy batches, and kept in a bounded
prefetch queue. Batches come out in order, and each sample draws from its own
`random.Random(f"{seed}/{epoch}/{index}")`, so the batches do not depend on
the number of threads, and both packages yield the same batches.

Traced (core/profiling.py), each sample's read is the span `loader.fetch`
on its worker thread.

Per-host shards: with (shard_id, num_shards) each host reads a disjoint
block of every global batch of the shared per-epoch shuffle, so the global
batch, order included, is the single-process one.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ccvpe_tpu_torch.core.profiling import span


class ThreadedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        drop_last: bool = True,
        indices: Optional[Sequence[int]] = None,
        shard_id: int = 0,
        num_shards: int = 1,
        collate: Optional[Callable[[List[Any]], Dict[str, np.ndarray]]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.base_indices = list(indices if indices is not None else range(len(dataset)))
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.collate = collate or default_collate
        self.epoch = 0
        # mid-epoch resume: skip the first N batches of the epoch's shuffle
        # without decoding them
        self.start_batch = 0

    def _local_count(self) -> int:
        """Samples this shard yields per epoch (as _epoch_indices gives them,
        so every host runs the same number of batches)."""
        gb = self.batch_size * self.num_shards
        n = len(self.base_indices) // gb * self.batch_size
        if not self.drop_last:
            tail = len(self.base_indices) % gb
            n += max(0, -(-(tail - self.shard_id) // self.num_shards))
        return n

    def __len__(self) -> int:
        n = self._local_count()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> List[int]:
        idx = list(self.base_indices)
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.num_shards == 1:
            return idx
        # each global batch (num_shards * batch_size consecutive indices of
        # the shared shuffle) splits into contiguous per-shard blocks
        gb = self.batch_size * self.num_shards
        out = []
        for t in range(len(idx) // gb):
            base = t * gb + self.shard_id * self.batch_size
            out.extend(idx[base: base + self.batch_size])
        if not self.drop_last:
            # the ragged tail round-robin, so every sample is seen once; with
            # drop_last it is dropped on every shard
            out.extend(idx[len(idx) // gb * gb:][self.shard_id::self.num_shards])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        self.epoch += 1
        if self.drop_last:
            indices = indices[: len(indices) // self.batch_size * self.batch_size]
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        batches = batches[self.start_batch:]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        job_q: "queue.Queue" = queue.Queue()
        for bi, b in enumerate(batches):
            job_q.put((bi, b))
        results: Dict[int, Any] = {}
        results_lock = threading.Lock()
        next_emit = [0]
        stop = threading.Event()

        def fetch(i: int) -> Any:
            rng = random.Random(f"{self.seed}/{self.epoch}/{i}")
            with span("loader.fetch"):
                try:
                    return self.dataset.__getitem__(i, rng=rng)
                except TypeError:
                    return self.dataset[i]

        def worker():
            while not stop.is_set():
                try:
                    bi, batch_idx = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.collate([fetch(i) for i in batch_idx])
                except Exception as e:  # handed to the consumer, which raises it
                    batch = e
                with results_lock:
                    results[bi] = batch
                    while next_emit[0] in results:
                        out_q.put(results.pop(next_emit[0]))
                        next_emit[0] += 1

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(min(self.num_workers, max(1, len(batches))))]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def default_collate(samples: List[Any]) -> Dict[str, np.ndarray]:
    """Stack dataclass or dict samples field-wise into numpy batches; string
    fields (VIGOR's city) become a numpy string array."""
    first = samples[0]
    if hasattr(first, "__dataclass_fields__"):
        out = {}
        for f in first.__dataclass_fields__:
            vals = [getattr(s, f) for s in samples]
            if isinstance(vals[0], str):
                out[f] = np.array(vals)
            else:
                out[f] = np.stack([np.asarray(v) for v in vals])
        return out
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    raise TypeError(f"cannot collate {type(first)}")
