"""AsyncIngestFeeder: a two-stage host pipeline in front of the card (the
port of ``zipkin_tpu/tpu/feeder.py:39-152``).

It overlaps the two halves of the line-rate path:

- **stage A (parse thread)**: ``TorchStorage._fast_parse``: native parse
  and intern, boundary sample, columnar pack, under the store's intern
  lock;
- **stage B (dispatch thread)**: ``TorchStorage._fast_dispatch``: the
  archive, then the device step.

With one thread a stage and a small bounded queue between them, batch N+1
parses while the card runs batch N. The order across batches is not kept:
it does not matter to the aggregate state (sketch updates commute) or to
the sampled archive (the trace-affine sample is a function of the trace
id); a caller that needs a strict replay order uses the synchronous path.

Under CPython the numpy pack and the dispatch's host work both hold the
GIL, so the two stages largely serialize; the reference measured the
pipeline slower than the synchronous loop for that reason. The class is
the threaded way to drive the path, with backpressure (``submit`` blocks
while ``depth`` batches are in flight); the multi-process tier
(:mod:`zipkin_tpu_torch.tpu.mp_ingest`) is the one that takes the parse
off the GIL.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional


class AsyncIngestFeeder:
    """Feeds raw JSON v2 or proto3 payloads to a TorchStorage through the
    two-stage pipeline. Use it as a context manager or call ``drain()``."""

    def __init__(self, store, depth: int = 4, sampler=None) -> None:
        from zipkin_tpu_torch import native

        if not native.available():  # pragma: no cover - no C toolchain
            raise RuntimeError("AsyncIngestFeeder needs the native codec")
        self.store = store
        self.sampler = sampler
        self._parse_q: queue.Queue = queue.Queue(maxsize=depth)
        self._dispatch_q: queue.Queue = queue.Queue(maxsize=depth)
        self._accepted = 0
        self._dropped = 0
        self._fallback = 0
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._parse_t = threading.Thread(target=self._parse_loop, name="feeder-parse", daemon=True)
        self._dispatch_t = threading.Thread(target=self._dispatch_loop, name="feeder-dispatch",
                                            daemon=True)
        self._parse_t.start()
        self._dispatch_t.start()

    def _parse_loop(self) -> None:
        # after a failure keep consuming (and discarding), so a blocked
        # submit() wakes and sees _error: a bounded queue left full on the
        # error path would deadlock
        while True:
            data = self._parse_q.get()
            if data is None:
                self._dispatch_q.put(None)
                return
            if self._error is not None:
                continue
            try:
                work = self.store._fast_parse(data, self.sampler)
                self._dispatch_q.put(("raw", data) if work is None else work)
            except BaseException as e:  # pragma: no cover - defensive
                self._error = e

    def _dispatch_loop(self) -> None:
        from zipkin_tpu_torch.model import codec

        while True:
            item = self._dispatch_q.get()
            if item is None:
                return
            if self._error is not None:
                continue  # drain and discard after a failure (see above)
            try:
                if isinstance(item, tuple) and item and item[0] == "raw":
                    # a payload the native parser cannot take: the object
                    # path, with the boundary sampling the collector applies,
                    # or the fallback would ingest more than the sketches
                    spans = codec.decode_spans(item[1])
                    kept = [s for s in spans if self.sampler.test(s)] if self.sampler else spans
                    if kept:
                        self.store.accept(kept).execute()
                    with self._lock:
                        self._fallback += 1
                        self._accepted += len(kept)
                        self._dropped += len(spans) - len(kept)
                    continue
                accepted, dropped, chunks = item
                for parsed, cols in chunks:
                    self.store._fast_dispatch(parsed, cols)
                with self._lock:
                    self._accepted += accepted
                    self._dropped += dropped
            except BaseException as e:
                self._error = e

    def submit(self, data: bytes) -> None:
        """Enqueue one payload (blocks while the pipeline is full; raises
        once either stage has failed)."""
        while True:
            if self._error is not None:
                raise RuntimeError("feeder failed") from self._error
            try:
                self._parse_q.put(data, timeout=0.1)
                return
            except queue.Full:
                continue

    def drain(self) -> int:
        """Close the pipeline, wait for everything to land on the card, and
        return the accepted span count. The feeder is not reusable after."""
        self._parse_q.put(None)
        self._parse_t.join()
        self._dispatch_t.join()
        if self._error is not None:
            raise RuntimeError("feeder failed") from self._error
        self.store.agg.block_until_ready()
        return self._accepted

    def __enter__(self) -> "AsyncIngestFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.drain()
