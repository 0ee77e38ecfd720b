"""Per-process sharded loading and device prefetch (the port of
``tf_operator_tpu/data/loader.py``, without grain).

:class:`NpySource` maps the ``data/synthetic.py`` layout
(``images.npy`` / ``labels.npy``) from disk; :func:`make_loader` gives
each process a disjoint shard of its records, as grain's
``IndexSampler(ShardOptions(shard_index, shard_count,
drop_remainder=True))`` does: the records are cut into ``process_count``
equal contiguous shards (the remainder dropped), and each epoch visits
this process's shard in a fresh order drawn from
``np.random.default_rng([seed, epoch])``, in whole batches (the last
partial batch of an epoch dropped).  The shards and the records each
epoch covers are grain's; the order within them is not (grain's
sampler draws it another way).  :func:`device_prefetch` normalises each
batch (:func:`_normalize`) and keeps the next ones in flight to the
device: on the card the copies leave pinned host buffers on a side
stream, a queue of ``prefetch`` batches deep.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch


class NpySource:
    """The records of a ``data/synthetic.py`` directory, memory-mapped
    (processes share the page cache; no process holds a copy)."""

    def __init__(self, directory: str):
        self.images = np.load(os.path.join(directory, "images.npy"), mmap_mode="r")
        self.labels = np.load(os.path.join(directory, "labels.npy"), mmap_mode="r")
        if len(self.images) != len(self.labels):
            raise ValueError(f"{directory}: {len(self.images)} images, {len(self.labels)} labels")

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx) -> Dict[str, np.ndarray]:
        return {"image": np.asarray(self.images[idx]), "label": np.asarray(self.labels[idx])}


class ShardedLoader:
    """Batches ``{"image", "label"}`` of this process's shard of
    ``source`` (module docstring).  ``num_epochs=None`` runs forever."""

    def __init__(self, source: NpySource, batch_size: int, *, process_id: int,
                 process_count: int, seed: int = 0, shuffle: bool = True,
                 num_epochs: Optional[int] = None):
        if not 0 <= process_id < process_count:
            raise ValueError(f"process {process_id} of {process_count}")
        per = len(source) // process_count
        if batch_size < 1 or batch_size > per:
            raise ValueError(f"batch size {batch_size} must be in 1..{per} (the records of "
                             f"a shard of {len(source)} over {process_count} processes)")
        self.source, self.batch_size = source, batch_size
        self.seed, self.shuffle, self.num_epochs = seed, shuffle, num_epochs
        #: this process's records: a contiguous shard, the remainder dropped
        self.shard = np.arange(process_id * per, (process_id + 1) * per)

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The record ids epoch ``epoch`` visits, in order (whole batches)."""

        order = (np.random.default_rng([self.seed, epoch]).permutation(self.shard)
                 if self.shuffle else self.shard)
        return order[: len(order) - len(order) % self.batch_size]

    def indexed(self) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
        """``(record ids, batch)`` pairs, in the order of ``__iter__``."""

        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            idx = self.epoch_indices(epoch)
            for i in range(0, len(idx), self.batch_size):
                ids = idx[i:i + self.batch_size]
                yield ids, self.source[ids]
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for _, batch in self.indexed():
            yield batch


def make_loader(directory: str, per_process_batch: int, *, process_id: Optional[int] = None,
                process_count: Optional[int] = None, seed: int = 0, shuffle: bool = True,
                num_epochs: Optional[int] = None) -> ShardedLoader:
    """A loader of ``per_process_batch``-row batches of this process's
    disjoint shard of the dataset at ``directory``; ``process_id`` /
    ``process_count`` default to this process's place in the job's
    world (``runtime/bootstrap.world``)."""

    if process_id is None or process_count is None:
        from tf_operator_tpu_torch.runtime.bootstrap import world

        pid, n = world()
        process_id = pid if process_id is None else process_id
        process_count = n if process_count is None else process_count
    return ShardedLoader(NpySource(directory), per_process_batch, process_id=process_id,
                         process_count=process_count, seed=seed, shuffle=shuffle,
                         num_epochs=num_epochs)


def _normalize(batch: Dict[str, np.ndarray], image_dtype=np.float32) -> Dict[str, np.ndarray]:
    """uint8 [0, 255] -> ``image_dtype`` in [0, 1]; labels -> int32."""

    return {"image": (batch["image"].astype(np.float32) / 255.0).astype(image_dtype),
            "label": batch["label"].astype(np.int32)}


def device_prefetch(loader, device, *, image_dtype=np.float32,
                    prefetch: Optional[int] = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Normalised batches of ``loader`` as tensors on ``device``, the
    next ones in flight while the caller computes.  On a CUDA device each
    batch is staged in pinned host memory and copied on a side stream,
    ``prefetch`` batches ahead (default ``TPU_OPERATOR_PREFETCH``, else
    2); the caller's stream waits for a batch's copy before the batch is
    handed over, and the batch is recorded on it, so its memory is not
    reused while the caller's work reads it.  On the CPU the batches pass
    through as tensors."""

    if prefetch is None:
        prefetch = int(os.environ.get("TPU_OPERATOR_PREFETCH", "2"))
    if prefetch < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {prefetch}")
    device = torch.device(device)
    if device.type != "cuda":
        for host in loader:
            yield {k: torch.from_numpy(v) for k, v in _normalize(host, image_dtype).items()}
        return
    side = torch.cuda.Stream(device)

    def put(host):
        pinned = {k: torch.from_numpy(v).pin_memory()
                  for k, v in _normalize(host, image_dtype).items()}
        with torch.cuda.stream(side):
            out = {k: v.to(device, non_blocking=True) for k, v in pinned.items()}
            done = torch.cuda.Event()
            done.record(side)
        # the pinned buffers live until their copy has run
        return out, done, pinned

    buf = collections.deque()
    it = iter(loader)
    for host in it:
        buf.append(put(host))
        if len(buf) == prefetch:
            break
    while buf:
        out, done, _ = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        current = torch.cuda.current_stream(device)
        current.wait_event(done)
        for v in out.values():
            v.record_stream(current)
        yield out
