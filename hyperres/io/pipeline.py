"""Double-buffered host -> device input pipeline.

The device-side successor of the reference's chunked streaming (the
32-band HDF5 chunk loop emit_proj.py:969-987 and the sequential tile
reads tiles_helpers/utils.py:266-301): a background thread stages the
next host batch (file read + decode) while the device consumes the
current one, with ``jax.device_put`` overlapping transfer and compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import jax
import numpy as np


class PrefetchToDevice:
    """Iterate host batches with background prefetch + device placement.

    ``source`` yields numpy arrays / pytrees; ``depth`` buffers are kept
    in flight (device_put is async, so depth=2 gives classic double
    buffering). Exceptions in the loader thread are re-raised at the
    consuming site."""

    _SENTINEL = object()

    def __init__(self, source: Iterable[Any], depth: int = 2,
                 device=None, transform: Optional[Callable] = None):
        self.source = source
        self.depth = max(1, int(depth))
        self.device = device
        self.transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._iterated = False

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer is gone — a
        consumer that exits early (break / exception in its loop body)
        must not leave the loader blocked forever on a full queue,
        pinning in-flight buffers and the open source."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for item in self.source:
                if self._stop.is_set():
                    return
                if self.transform is not None:
                    item = self.transform(item)
                placed = jax.device_put(item, self.device)
                if not self._put(placed):
                    return
            self._put(self._SENTINEL)
        except BaseException as e:  # noqa: BLE001 - reraised at consumer
            self._put(e)
        finally:
            close = getattr(self.source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def __iter__(self) -> Iterator[Any]:
        # single-shot: the source generator is consumed by the first
        # pass, and _stop stays set after it — a silent second iteration
        # would hang on the queue (the restarted worker exits without
        # enqueueing the sentinel once _stop is set)
        if self._iterated:
            raise RuntimeError(
                "PrefetchToDevice is single-use; build a new instance "
                "(its source iterable is already consumed)")
        self._iterated = True
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # normal exhaustion or early consumer exit: release the
            # loader (GeneratorExit lands here when the caller breaks)
            self._stop.set()


def band_chunk_reader(dataset_read: Callable[[int, int], np.ndarray],
                      n_bands: int, chunk: int = 32
                      ) -> Iterator[np.ndarray]:
    """Yield (..., chunk) band slabs from a reader callable — the
    generalisation of the reference's tuned 32-band chunking
    (emit_proj.py:969)."""
    for b0 in range(0, n_bands, chunk):
        yield dataset_read(b0, min(b0 + chunk, n_bands))


def tile_batch_reader(
    tiff_reader,
    windows: Sequence,
    batch: int = 8,
    dtype=np.float32,
) -> Iterator[np.ndarray]:
    """Yield (batch, B, h, w) stacks of equally sized tile windows from a
    TiffReader — the streaming feed for sharded tile processing. The
    final partial batch is zero-padded to keep device shapes static."""
    if not windows:
        return
    h, w = windows[0].height, windows[0].width
    buf = []
    for win in windows:
        if win.height != h or win.width != w:
            raise ValueError("All tile windows must share one shape")
        buf.append(tiff_reader.read(window=win).astype(dtype))
        if len(buf) == batch:
            yield np.stack(buf)
            buf = []
    if buf:
        pad = batch - len(buf)
        block = np.stack(buf)
        if pad:
            block = np.concatenate(
                [block, np.zeros((pad,) + block.shape[1:], dtype=dtype)])
        yield block
