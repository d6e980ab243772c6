"""Background epoch pipeline: ingestion off the query path.

``append_edges`` batches are sharded and delta-surveyed on a worker
thread, so queries keep answering from the last *merged* epoch snapshot
at steady latency. On the card the worker launches its kernels on its
own thread's current stream.

The pipeline is a plain daemon thread draining a FIFO queue. Each batch
is applied atomically by the service's ``apply`` callback (which swaps an
immutable snapshot pointer), so readers never observe a half-applied
epoch. Worker exceptions are captured and re-raised on the next
:meth:`flush`/:meth:`submit` so ingestion failures cannot pass silently.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable


class IngestPipeline:
    """FIFO batch applier on a daemon worker thread.

    Per-batch apply wall time is tracked (:meth:`stats`): the last and
    mean apply seconds of the epochs merged so far."""

    def __init__(self, apply: Callable[[Any], None], max_pending: int = 64):
        self._apply = apply
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._error: BaseException | None = None
        self._closed = False
        self._lock = threading.Lock()
        self._batches_applied = 0
        self._apply_s_total = 0.0
        self._apply_s_last = 0.0
        self._thread = threading.Thread(
            target=self._run, name="repro-torch-serve-ingest", daemon=True)
        self._thread.start()

    # -- worker -----------------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self._queue.get()
            try:
                if batch is None:
                    return
                if self._error is None:
                    t0 = time.perf_counter()
                    self._apply(batch)
                    dt = time.perf_counter() - t0
                    with self._lock:
                        self._batches_applied += 1
                        self._apply_s_total += dt
                        self._apply_s_last = dt
            except BaseException as exc:  # surfaced on flush/submit
                with self._lock:
                    self._error = exc
            finally:
                self._queue.task_done()

    # -- front door -------------------------------------------------------

    def _raise_pending_error(self) -> None:
        with self._lock:
            exc, self._error = self._error, None
        if exc is not None:
            raise RuntimeError("ingest worker failed") from exc

    def submit(self, batch: Any) -> None:
        """Enqueue one edge batch; blocks only if max_pending is hit."""
        if self._closed:
            raise RuntimeError("ingest pipeline is closed")
        self._raise_pending_error()
        self._queue.put(batch)

    def flush(self) -> None:
        """Block until every submitted batch is merged; re-raise failures."""
        self._queue.join()
        self._raise_pending_error()

    @property
    def pending(self) -> int:
        return self._queue.unfinished_tasks

    def stats(self) -> dict:
        """Apply-side timing: batch count, last and mean apply seconds."""
        with self._lock:
            n = self._batches_applied
            return {"batches_applied": n,
                    "apply_s_last": self._apply_s_last,
                    "apply_s_mean": self._apply_s_total / max(1, n)}

    def close(self) -> None:
        """Drain remaining work, stop the worker, surface any error."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        self._raise_pending_error()
