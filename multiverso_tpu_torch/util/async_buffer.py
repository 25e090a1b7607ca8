"""AsyncBuffer — double-buffer prefetch.

Reference (SURVEY.md §2.24, ``util/async_buffer.h``): overlap the next
``Get`` with compute; used by the word-embedding apps to hide parameter-pull
latency behind the training step.

TPU-native: the same overlap idea, generalized — a background thread runs the
fill function (typically a ``table.get_rows`` pull or a data-shard load)
while the caller computes on the previous buffer.  On TPU the *fused* path
makes most pulls disappear into the compiled step, so this matters mainly for
host-side input pipelines and the eager parity path.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Generic, TypeVar

T = TypeVar("T")

__all__ = ["AsyncBuffer"]


class AsyncBuffer(Generic[T]):
    """Prefetching double buffer.

    ``fill`` runs on a dedicated background thread.  ``get()`` blocks on the
    in-flight fill, hands out its result, and immediately kicks off the next
    fill — so compute on buffer *t* overlaps the production of buffer *t+1*,
    exactly the reference's two-buffer pipeline.
    """

    def __init__(self, fill: Callable[[], T]):
        self._fill = fill
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="mvtpu-asyncbuf")
        self._future = self._pool.submit(fill)
        self._stopped = False

    def get(self) -> T:
        if self._stopped:
            raise RuntimeError("AsyncBuffer is stopped")
        # Resubmit before propagating a fill failure: a transient error must
        # not poison the buffer (result() would re-raise the same stale
        # exception on every later get()).
        try:
            value = self._future.result()
        finally:
            self._future = self._pool.submit(self._fill)
        return value

    def stop(self) -> None:
        """Join the fill thread (reference destructor joins its thread)."""
        if not self._stopped:
            self._stopped = True
            self._future.cancel()
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncBuffer[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
