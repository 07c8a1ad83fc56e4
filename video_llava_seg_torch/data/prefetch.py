"""Host -> device input prefetching (the port's counterpart of
`video_llava_seg_tpu/data/prefetch.py`, a `jax.device_put` thread).

A daemon thread stays `size` batches ahead of the train step: it collates
(the wrapped iterator), applies the optional host-side `transform`, casts
each array as `train_step.batch_to_device` does (float arrays to `dtype`,
integers to int64, bools kept), copies it into pinned host memory and
issues its non-blocking host -> device copy on a side CUDA stream. The
consumer's stream waits on that batch's copies (an event recorded on the
side stream) before the batch is handed out, and every tensor is marked
used on the consumer's stream (`record_stream`), so the caching allocator
does not hand its memory to another batch while the step still reads it.
An error in the thread surfaces in the consumer. `close()` (or leaving a
`with` block) stops the thread and waits for it.

The device is the caller's: nothing here picks one. A CPU device (the
tests) runs the same thread with plain tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

_END = object()


def host_tensors(batch: Dict[str, Any], dtype: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as CPU tensors with `batch_to_device`'s
    dtypes."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if t.is_floating_point():
            t = t.to(dtype)
        elif t.dtype != torch.bool:
            t = t.long()
        out[k] = t
    return out


class DevicePrefetcher:
    """Iterator over device batches; `waits` holds the seconds the
    consumer's thread spent blocked on each `next()` (the host's wait for
    the queue; the wait for the copies is the consumer stream's)."""

    def __init__(self, iterator: Iterator, device, size: int = 2,
                 transform: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.waits: List[float] = []
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(
            target=self._worker, args=(iterator, transform), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless closed meanwhile; False once closed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterator, transform):
        try:
            for batch in iterator:
                if self._stop.is_set():
                    return
                if transform is not None:
                    batch = transform(batch)
                host = host_tensors(batch, self.dtype)
                if self._stream is None:
                    item = (host, None)
                else:
                    with torch.cuda.stream(self._stream):
                        dev = {k: t.pin_memory().to(self.device,
                                                    non_blocking=True)
                               for k, t in host.items()}
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    item = (dev, done)
                if not self._put(item):
                    return
        except Exception as exc:  # surfaced in the consumer
            self._put(exc)
        finally:
            self._put(_END)

    def close(self, timeout: float = 120.0):
        """Stop the thread (after the batch it is making) and wait for it;
        queued batches are dropped."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"prefetch thread still running after "
                               f"{timeout} s")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        batch, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        self.waits.append(time.perf_counter() - t0)
        return batch


def prefetch_to_device(iterator: Iterator, device, size: int = 2,
                       transform: Optional[Callable] = None,
                       dtype: torch.dtype = torch.float32
                       ) -> DevicePrefetcher:
    """Wrap `iterator` (collated numpy batches) with a thread that stays
    `size` batches ahead on `device`."""
    return DevicePrefetcher(iterator, device, size=size,
                            transform=transform, dtype=dtype)
