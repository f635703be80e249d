"""Data loading: host numpy -> device batches (port of
``flexflow_tpu.data.dataloader``; reference: python/flexflow_dataloader.cc).

The dataset stays in host RAM. :func:`batch_iterator` yields numpy batches
— shuffled with ``np.random.default_rng(seed).shuffle`` and gathered with
numpy, the same batches as the JAX package's native ``BatchPipeline`` —
and :func:`prefetch_iterator` stages them onto the device on a side
thread: pinned host copies and ``non_blocking`` transfers on a copy stream,
one batch ahead of the step that consumes them.
"""
from __future__ import annotations

import threading
from queue import Empty, Full, Queue
from typing import Iterator, List, Optional, Sequence

import numpy as np


class SingleDataLoader:
    """API-parity loader for one tensor (reference: flexflow_cffi.py:2447)."""

    def __init__(self, ffmodel, batch_tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None):
        self.ffmodel = ffmodel
        self.batch_tensor = batch_tensor
        self.full_array = np.asarray(full_array)
        self.num_samples = num_samples or self.full_array.shape[0]
        self.batch_size = batch_tensor.dims[0]
        self._idx = 0

    def reset(self) -> None:
        self._idx = 0

    def next_batch(self, ffmodel=None) -> np.ndarray:
        lo = self._idx
        hi = lo + self.batch_size
        if hi > self.num_samples:
            self.reset()
            lo, hi = 0, self.batch_size
        self._idx = hi
        return self.full_array[lo:hi]

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size


def batch_iterator(arrays: Sequence[np.ndarray], batch_size: int,
                   shuffle: bool = False, seed: int = 0,
                   drop_remainder: bool = True,
                   start_batch: int = 0) -> Iterator[List[np.ndarray]]:
    """Batches of rows of ``arrays`` (one leading sample axis). With
    ``shuffle`` the row order is ``default_rng(seed).shuffle``'s;
    ``start_batch`` skips the first k batches of that order."""
    n = arrays[0].shape[0]
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    if start_batch > 0:
        idx = idx[start_batch * batch_size:]
    m = len(idx)
    nb = m // batch_size if drop_remainder else -(-m // batch_size)
    for b in range(nb):
        sl = idx[b * batch_size:(b + 1) * batch_size]
        yield [a[sl] for a in arrays]


def to_device(arrays: List[np.ndarray], device, stream=None):
    """numpy arrays -> tensors on ``device``. For CUDA: pinned host copies
    and ``non_blocking`` transfers on ``stream`` (the current stream when
    None); the caller orders the consumer after that stream."""
    import torch

    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type != "cuda":
        return [t.to(device) for t in tensors]
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        return [t.pin_memory().to(device, non_blocking=True)
                for t in tensors]


def prefetch_iterator(it: Iterator, device, depth: int = 2):
    """Device batches from host batches, staged ``depth`` ahead by a side
    thread. On CUDA the copies run on a side stream and each batch carries
    an event: the consumer's stream waits on it before the batch is used
    (and the batch's memory is tied to that stream), so the transfer of
    batch b+1 overlaps step b. Producer errors reach the consumer; leaving
    the generator early stops and joins the producer."""
    import torch

    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: Queue = Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                staged = to_device(batch, device, copy_stream)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                if not put_or_stop((staged, ready)):
                    return
            put_or_stop(end)
        except BaseException as e:  # reaches the consumer, not swallowed
            put_or_stop(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            staged, ready = item
            if ready is not None:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(ready)
                for x in staged:
                    x.record_stream(cur)
            yield staged
    finally:
        stop.set()
        while t.is_alive():
            try:
                while True:
                    q.get_nowait()
            except Empty:
                pass
            t.join(timeout=0.1)
