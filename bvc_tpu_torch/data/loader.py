"""Prefetching input pipeline feeding one GPU (counterpart of
:mod:`bvc_tpu.data.loader`).

- :class:`EpochSampler`: the JAX package's deterministic global shuffle per
  epoch (``default_rng((seed, epoch))``) and ``drop_last`` (a short last
  batch padded by wrapping around when it is off);
- :class:`DataLoader`: a thread pool of ``num_workers`` decoding samples
  (capped at the cores this process may use), ``prefetch`` batches in
  flight, ``collate_fn(batch, epoch, batch_idx)``, ``max_batches``.  Each
  sample is written straight into its batch's slot: no ``np.stack``.

On a CUDA device a batch is assembled in a **pinned** host buffer and sent
with ``non_blocking=True`` on a side stream as soon as it is complete, so
the copy of batch k+1 overlaps step k (the JAX loader's double buffer).
When the consumer takes a batch, its stream waits on that copy's event and
the device tensors are recorded on it (the caching allocator keeps them
until the consumer's work is done).  The pinned buffers form a ring of
``prefetch + 1``; a buffer is refilled only after the event of its last
copy has completed, so a batch in flight is never overwritten.  A dict
batch (JEPA's ``video``, ``enc_idx``, ``pred_idx``) travels the same way,
its small arrays through pinned copies of their own.

``stall_ms`` is the host time the consumer spent waiting for a batch in
the last epoch, ms a batch after the first (which fills the pipeline):
above zero, the pipeline did not keep up.

Per-sample RNG: each (epoch, index) pair gets its own ``Generator`` seeded
from (seed, epoch, index), so augmentations are reproducible and
independent of worker scheduling.  ``to_device=False`` yields the numpy
batches (what the JAX loader yields with ``to_device=False``), for tests;
on the CPU a batch is a fresh tensor.

Data parallel: the sampler shuffles and batches the whole dataset the same
way on every rank, and each rank takes its contiguous block of every global
batch (the JAX loader's host slice); a global batch the world does not
divide raises.  A collator (JEPA's masks) sees the rank's block, with the
batch's index for drawing over the global batch
(``training/trainer_jepa.py``).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import os
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from bvc_tpu_torch.parallel.sharding import host_local_batch_slice
from bvc_tpu_torch.utils.device import resolve_device
from bvc_tpu_torch.utils.logging import get_logger


class EpochSampler:
    """Deterministic per-epoch index order, batch-aligned, this rank's block
    of every global batch."""

    def __init__(self, dataset_len: int, global_batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.n = dataset_len
        self.global_batch = global_batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        # (start, size) of this rank's block; raises when the world does not divide
        self.start, self.per_rank = host_local_batch_slice(global_batch_size)

    def batches(self, epoch: int) -> list[np.ndarray]:
        """The index arrays of this rank's block of this epoch's batches."""
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
        else:
            order = np.arange(self.n)
        n_batches = self.n // self.global_batch
        if not self.drop_last and self.n % self.global_batch:
            n_batches += 1
            # wrap-around padding (repeats indices when n < batch)
            order = np.resize(order, n_batches * self.global_batch)
        order = order[: n_batches * self.global_batch]
        batches = order.reshape(n_batches, self.global_batch)
        return list(batches[:, self.start: self.start + self.per_rank])


class _PinnedRing:
    """Pinned host batch buffers, reused in turn; each remembers the event
    of the last copy out of it and is handed out again only after that
    event has completed."""

    def __init__(self, size: int):
        self.size = size
        self._slots: dict[tuple, list[list]] = {}
        self._lock = threading.Lock()

    def acquire(self, batch_idx: int, shape: tuple, dtype: np.dtype):
        key = (shape, np.dtype(dtype).str)
        with self._lock:
            slots = self._slots.setdefault(key, [[None, None, False]
                                                 for _ in range(self.size)])
            slot = slots[batch_idx % self.size]
            if slot[2]:
                raise RuntimeError("pinned batch buffer handed out twice")
            slot[2] = True
        if slot[0] is None:
            slot[0] = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                  pin_memory=True)
        if slot[1] is not None:
            slot[1].synchronize()  # the last copy out of this buffer is done
        return slot

    def release(self, slot: list, event: torch.cuda.Event | None) -> None:
        with self._lock:
            slot[1], slot[2] = event, False


class _Sent:
    """A batch on its way to the device: the device tensors (same
    structure as the host batch) and the event of their copy."""

    def __init__(self, batch: Any, event: torch.cuda.Event):
        self.batch, self.event = batch, event


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


class DataLoader:
    """Iterate batches for one epoch at a time, on ``device`` (``cuda``
    when None; raises when there is none, see :func:`resolve_device`)."""

    def __init__(
        self,
        dataset,
        global_batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 6,
        prefetch: int = 2,
        drop_last: bool = True,
        max_batches: int = 0,
        to_device: bool = True,
        collate_fn=None,
        device: str | torch.device | None = None,
    ):
        # collate_fn(stacked_batch, epoch, batch_idx) -> batch or dict; the
        # JEPA path attaches multi-block masks per batch, seeded from
        # (epoch, batch_idx) so they do not depend on prefetch order
        self.dataset = dataset
        self.sampler = EpochSampler(len(dataset), global_batch_size, shuffle, seed, drop_last)
        # decode threads beyond the usable cores thrash (GIL handoffs, cache churn)
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):  # non-Linux
            cores = os.cpu_count() or 1
        self.num_workers = max(1, min(num_workers, cores))
        self.prefetch = max(1, prefetch)
        self.max_batches = max_batches
        self.seed = seed
        self.to_device = to_device
        self.collate_fn = collate_fn
        self.device = resolve_device(device) if to_device else None
        self._cuda = self.device is not None and self.device.type == "cuda"
        self._ring = _PinnedRing(self.prefetch + 1) if self._cuda else None
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._send_lock = threading.Lock()
        self._sample_spec: tuple | None = None  # (shape, dtype) of one sample
        self.stall_ms = 0.0
        self._logger = get_logger("bvc_tpu_torch.loader")

    def __len__(self) -> int:
        n = self.sampler.n // self.sampler.global_batch
        if not self.sampler.drop_last and self.sampler.n % self.sampler.global_batch:
            n += 1
        return min(n, self.max_batches) if self.max_batches else n

    def _sample(self, epoch: int, idx) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch, int(idx)))
        return self.dataset[(int(idx), rng)]

    def _assemble(self, pool: cf.Executor, epoch: int, batch_idx: int, idxs: np.ndarray):
        first = None
        if self._sample_spec is None:
            first = self._sample(epoch, idxs[0])
            self._sample_spec = (first.shape, first.dtype)
        shape, dtype = self._sample_spec
        slot = None
        if self._cuda:
            slot = self._ring.acquire(batch_idx, (len(idxs), *shape), dtype)
            host = slot[0].numpy()
        else:
            host = np.empty((len(idxs), *shape), dtype)

        def fill(i: int) -> None:
            sample = self._sample(epoch, idxs[i]) if i or first is None else first
            if sample.shape != shape or sample.dtype != dtype:
                raise ValueError(f"sample {int(idxs[i])} is {sample.dtype}{sample.shape}, "
                                 f"the batch's samples {dtype}{shape}")
            host[i] = sample

        try:
            for f in [pool.submit(fill, i) for i in range(len(idxs))]:
                f.result()
            batch = host
            if self.collate_fn is not None:
                batch = self.collate_fn(batch, epoch, batch_idx)
            if not self.to_device:
                return batch
            if not self._cuda:
                return _map(batch, torch.from_numpy)
            sent = self._send(batch, host, slot[0])
        except BaseException:
            if slot is not None:
                self._ring.release(slot, None)
            raise
        self._ring.release(slot, sent.event)
        return sent

    def _send(self, batch: Any, host: np.ndarray, pinned: torch.Tensor) -> _Sent:
        """Issue the host-to-device copies of ``batch`` on the side stream."""

        def copy(x: np.ndarray) -> torch.Tensor:
            src = pinned if x is host else torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
            dst = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dst.copy_(src, non_blocking=True)
            return dst

        with self._send_lock, torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = _map(batch, copy)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Sent(out, event)

    def _receive(self, sent: _Sent) -> Any:
        """The batch on the consumer's stream: wait for its copy there and
        keep its memory until the work queued there is done."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(sent.event)
        for t in _tensors(sent.batch):
            t.record_stream(stream)
        return sent.batch

    def epoch(self, epoch: int) -> Iterator[Any]:
        batches = self.sampler.batches(epoch)
        if self.max_batches:
            batches = batches[: self.max_batches]
        stall, served, self.stall_ms = 0.0, 0, 0.0
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: collections.deque = collections.deque()
            it = iter(enumerate(batches))
            # keep `prefetch` batch-futures in flight; samples within a
            # batch fan out over the pool
            outer = cf.ThreadPoolExecutor(max_workers=self.prefetch)
            try:
                for i, idxs in it:
                    pending.append(outer.submit(self._assemble, pool, epoch, i, idxs))
                    if len(pending) == self.prefetch:
                        break
                while pending:
                    fut = pending.popleft()
                    for i, idxs in it:
                        pending.append(outer.submit(self._assemble, pool, epoch, i, idxs))
                        break
                    t0 = time.perf_counter()
                    batch = fut.result()
                    if served:
                        stall += time.perf_counter() - t0
                        self.stall_ms = stall * 1e3 / served
                    served += 1
                    yield self._receive(batch) if self._cuda else batch
            finally:
                # wait for running assemblers: their buffers are reused next
                outer.shutdown(wait=True, cancel_futures=True)
        paths = getattr(self.dataset, "served", None)
        self._logger.info("epoch %d: the consumer waited %.1f ms a batch; frames read so far "
                          "by path %s", epoch, self.stall_ms, dict(paths or {}))


def _map(batch: Any, fn) -> Any:
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    return fn(batch)
