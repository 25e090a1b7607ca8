"""Hot-path serve layer (docs/serving.md) — the part the tables use.

The port's tables wear the same read cache and coalescer as the JAX
package's (``tables/base.py``: ``-serve_cache_entries`` arms them):

- :class:`~multiverso_tpu_torch.serve.coalescer.Coalescer` merges
  concurrent/adjacent reads on one table into a single fetch, windowed
  by ``-coalesce_window_us`` and capped by ``-serve_max_batch``;
- :class:`~multiverso_tpu_torch.serve.cache.VersionedLRUCache` serves
  repeat reads locally while ``cached_version >= server_version -
  max_staleness``; the "server version" is the table's local apply
  counter.

- :class:`~multiverso_tpu_torch.serve.client.ServeClient` wires both
  over a :class:`~multiverso_tpu_torch.native.NativeRuntime`, with
  busy-retry against ``-server_inflight_max`` sheds (``BusyError`` →
  ``fault.RetryPolicy`` backoff);
- :class:`~multiverso_tpu_torch.serve.wire.AnonServeClient` speaks the
  serve protocol over a plain socket to a server rank's reactor;
- :class:`~multiverso_tpu_torch.serve.hedge.HedgedReader` hedges row
  reads over two such connections past a p95-derived delay.

All five are copies of the JAX package's modules; the wire clients'
server end is the port's own copy of the native runtime
(``native/``).
"""

from __future__ import annotations

from .cache import VersionedLRUCache
from .client import ServeClient
from .coalescer import Coalescer
from .hedge import HedgedReader, LatencyTracker
from .wire import AnonServeClient, FrameDecoder, ServeBusy

__all__ = ["AnonServeClient", "Coalescer", "FrameDecoder", "HedgedReader",
           "LatencyTracker", "ServeBusy", "ServeClient",
           "VersionedLRUCache"]
