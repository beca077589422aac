"""Host-side data loader: shuffling, collation, background prefetch (port of
text_to_video_finetuning_tpu/data/loader.py; the same batches in the same
order for the same seed).

Replaces torch.utils.data.DataLoader (reference train.py:641-645). Decode
happens on a worker thread (cv2 releases the GIL inside C++ decode) while
the device runs the previous step; batches are numpy trees the engine
copies to the device.

Bucketing support (reference utils/bucketing.py + utils/dataset.py resize
paths): with `use_bucketing` the datasets emit items at a small bucket set
of (H, W) shapes.  `bucket_batching=True` groups items by shape so every
batch is stackable.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List

import numpy as np


def default_collate(items):
    """Stack numpy leaves; pass through non-arrays as lists (the reference
    batch carries 'text_prompt'/'dataset' strings)."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 2, seed: int = 0, drop_last: bool = True,
                 collate_fn=default_collate, prefetch: int = 2,
                 pad_last: bool = False, num_shards: int = 1,
                 shard_index: int = 0, bucket_batching: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        # pad_last: wrap-around-pad every batch to full size (torch
        # DistributedSampler semantics), so every batch has the full size
        self.pad_last = pad_last
        self.drop_last = drop_last and not pad_last
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        # shards: batch_size is the global batch; every shard draws the
        # same seeded index permutation and loads only its contiguous
        # 1/num_shards slice of each global batch
        assert batch_size % max(num_shards, 1) == 0, (
            f"global batch {batch_size} not divisible by {num_shards} hosts")
        self.num_shards = max(num_shards, 1)
        self.shard_index = shard_index
        # bucket batching groups by item shape AFTER loading, which is a
        # host-local decision; the multi-host loader contract (identical
        # batch sequence on every host) would need shape metadata up front
        if bucket_batching and self.num_shards > 1:
            raise NotImplementedError(
                "bucket_batching is single-host only; use fixed-size "
                "(width, height) train_data on multi-host meshes")
        self.bucket_batching = bucket_batching
        self._epoch = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        """Batch count; an UPPER BOUND when bucket_batching is on (each
        bucket shape drops its own partial remainder under drop_last, which
        item shapes can't predict without loading).  Consumers that must
        hit an exact step count should loop epochs until done (the training
        engine does: engine.py main loop)."""
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        n = (len(indices) // self.batch_size * self.batch_size
             if self.drop_last else len(indices))
        local = self.batch_size // self.num_shards
        for i in range(0, n, self.batch_size):
            batch = indices[i:i + self.batch_size]
            if self.pad_last and len(batch) < self.batch_size:
                reps = -(-self.batch_size // len(indices))  # ceil
                pool = np.concatenate([indices] * (reps + 1))
                batch = np.concatenate(
                    [batch, pool[:self.batch_size - len(batch)]])
            if self.num_shards > 1:
                batch = batch[self.shard_index * local:
                              (self.shard_index + 1) * local]
            yield batch

    def _item_batches(self) -> Iterator[List[dict]]:
        """Yield lists of item dicts; runs inside the worker thread."""
        if not self.bucket_batching:
            for batch_idx in self._batches():
                yield [self.dataset[int(i)] for i in batch_idx]
            return
        # shape-keyed queues: a batch is emitted as soon as one bucket
        # fills, so batches stay stackable and shapes stay in the bucket set
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(indices)
        queues: dict = {}
        for i in indices:
            item = self.dataset[int(i)]
            key = tuple(np.asarray(item["pixel_values"]).shape)
            queues.setdefault(key, []).append(item)
            if len(queues[key]) == self.batch_size:
                yield queues.pop(key)
        for key in sorted(queues, key=str):
            items = queues[key]
            if len(items) < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_last:
                    orig = list(items)
                    while len(items) < self.batch_size:
                        items.append(orig[len(items) % len(orig)])
            yield items

    def __iter__(self) -> Iterator:
        self._epoch += 1
        if self.num_workers == 0:
            for items in self._item_batches():
                yield self.collate_fn(items)
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for items in self._item_batches():
                    if stop.is_set():
                        break
                    out_q.put(self.collate_fn(items))
            except Exception as e:  # surface errors on the consumer side
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
