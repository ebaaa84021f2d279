"""Double-buffered host->device batch feeding (streaming executor).

The pipeline-parallel analogue in SURVEY.md section 2.2: host decode /
2-bit packing -> device compute, overlapped.  A worker thread stages the
NEXT batch's host->device transfers while the device computes on the
current one, so the scan kernels never wait on host-to-device transfer
latency (which dominates exactly when batches are large enough to keep the
device busy).  The reference has no analogue -- it is single-threaded and reads
with fgets one line at a time (binning.c:1154-1166).

Ordering is preserved; the queue depth bounds host+device staging memory
to ``depth`` batches.  Any exception in the worker is re-raised at the
consuming end so failures are not silent.  If the consumer abandons
iteration early (e.g. the scan raises mid-loop), the worker notices via a
stop flag on its next timed put and exits, releasing its staged device
buffers instead of blocking forever.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence


class DeviceFeeder:
    """Iterate device-resident batches with transfer/compute overlap.

    items: any iterable of host batches.
    stage: host batch -> device arrays (e.g. jax.device_put of its arrays);
      runs on the worker thread.  jax dispatches transfers asynchronously,
      so by the time the consumer receives a batch its transfer is already
      in flight or complete.
    depth: max staged batches (2 = classic double buffering).

    Supports the context-manager protocol; ``close()`` (or leaving the
    ``with`` block, or garbage collection of an abandoned feeder) signals
    the worker to stop staging and drains the queue so the thread exits
    promptly rather than leaking itself plus ``depth`` device batches.
    """

    _DONE = object()

    def __init__(
        self,
        items: Iterable,
        stage: Callable,
        *,
        depth: int = 2,
    ) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def work() -> None:
            try:
                for it in items:
                    staged = stage(it)
                    # timed put so a stopped consumer is noticed even when
                    # the queue stays full (the consumer stopped draining)
                    while not self._stop.is_set():
                        try:
                            self._q.put(staged, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                # DONE must actually arrive (a dropped marker deadlocks the
                # consumer); timed puts so a stopped consumer still lets the
                # worker exit even when the queue stays full
                while not self._stop.is_set():
                    try:
                        self._q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker and release staged batches (idempotent)."""
        self._stop.set()
        # drain whatever is staged so the worker's pending put unblocks
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "DeviceFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # backstop for abandoned feeders
        self._stop.set()

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._DONE:
                self._thread.join()
                if self._err is not None:
                    raise self._err
                return
            yield item


def feed_read_batches(batches: Sequence, *, depth: int = 2) -> DeviceFeeder:
    """Stage reads_io batches: (codes, lengths, read_ids) device arrays.

    Returns the DeviceFeeder itself (iterable AND a context manager) so
    call sites can wrap consumption in ``with`` and guarantee the worker
    exits when the consuming loop raises.
    """
    import jax
    import jax.numpy as jnp

    def stage(b):
        return (
            jax.device_put(jnp.asarray(b.codes)),
            jax.device_put(jnp.asarray(b.lengths)),
            jax.device_put(jnp.asarray(b.read_ids)),
        )

    return DeviceFeeder(batches, stage, depth=depth)
