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

- :class:`~multiverso_tpu_torch.serve.wire.AnonServeClient` speaks the
  serve protocol over a plain socket to a server rank's reactor;
- :class:`~multiverso_tpu_torch.serve.hedge.HedgedReader` hedges row
  reads over two such connections past a p95-derived delay.

All four are copies of the JAX package's modules.  The wire clients'
server end, and ``ServeClient`` (which imports the ctypes binding), need
the native runtime and are not ported yet (ROADMAP.md Queue 1, "Modules
that need the native runtime").
"""

from __future__ import annotations

from .cache import VersionedLRUCache
from .coalescer import Coalescer
from .hedge import HedgedReader, LatencyTracker
from .wire import AnonServeClient, FrameDecoder, ServeBusy

__all__ = ["AnonServeClient", "Coalescer", "FrameDecoder", "HedgedReader",
           "LatencyTracker", "ServeBusy", "VersionedLRUCache"]
