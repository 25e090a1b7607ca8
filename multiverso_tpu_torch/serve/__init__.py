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

Both are copies of the JAX package's modules.  The client, wire and
hedge modules (``ServeClient``, ``AnonServeClient``, ``HedgedReader``)
need the native runtime and are not ported yet (ROADMAP.md Queue 1,
"Modules that need the native runtime").
"""

from __future__ import annotations

from .cache import VersionedLRUCache
from .coalescer import Coalescer

__all__ = ["Coalescer", "VersionedLRUCache"]
