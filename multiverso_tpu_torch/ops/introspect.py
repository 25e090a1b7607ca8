"""OpsClient — scrape a live rank (or the whole fleet) in-band
(docs/observability.md).

The fleet's health is served over the SAME wire the serve tier speaks:
``MsgType::OpsQuery`` on any server rank's listen port, answered at the
epoll reactor without touching the actor mailbox — so a rank whose
server actor is wedged behind a full mailbox still answers its scrape.
No rank identity, no machine file, no native library: this module is
pure stdlib (plus the vendorable ``serve/wire.py`` framing), so a
monitoring box can poll a fleet with nothing but this file pair.

Three report kinds:

- ``metrics`` — Prometheus text exposition.  Per-rank when scraped
  local-scope; a fleet-scope scrape returns every rank's series with an
  injected ``rank="N"`` label plus ``mv_ops_rank_up{rank=...} 0|1``
  markers (a silent rank is explicit data, never missing data).
  Histogram bucket lines carry OpenMetrics-style **exemplars** — the
  last trace id that landed in the bucket — so a p99 sample links to
  the merged Chrome trace that explains it.
- ``health`` — JSON verdict: serve queue depth vs
  ``-server_inflight_max``, heartbeat-lease dead peers, fan-in
  counters, blackbox trigger count, ready/healthy booleans.
- ``tables`` — JSON per-table stats: version, bucket-version spread,
  negotiated codec, add-aggregation buffer depth.

``tools/mvtop.py`` is the CLI over this client.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

from ..serve.wire import (AnonServeClient, OPS_SCOPE_FLEET,
                          OPS_SCOPE_LOCAL)

__all__ = ["OpsClient", "parse_prometheus"]

# `name{labels} value [# {exemplar-labels} exemplar-value]`
# The label block is quote-aware (not `[^}]*`): escaped label VALUES may
# legally contain `}`, `\"` and `\\` per the exposition format.
_LINE = re.compile(
    r"^(?P<name>[^\s{#]+)"
    r'(?P<labels>\{(?:[^"}]|"(?:[^"\\]|\\.)*")*\})?\s+'
    r"(?P<value>[^\s#]+)"
    r"(?:\s+#\s+\{(?P<exemplar>[^}]*)\}\s+(?P<exvalue>\S+))?\s*$")


def parse_prometheus(text: str) -> Tuple[Dict[str, float],
                                         Dict[str, Dict[str, str]]]:
    """Parse exposition text → (``{series_line: value}``,
    ``{series_line: exemplar_labels}``).  Series keys keep their label
    block verbatim (``name{k="v"}``); comment lines are skipped;
    exemplar labels (e.g. ``trace_id``) come back as a dict."""
    values: Dict[str, float] = {}
    exemplars: Dict[str, Dict[str, str]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            continue
        key = m.group("name") + (m.group("labels") or "")
        try:
            values[key] = float(m.group("value"))
        except ValueError:
            continue
        if m.group("exemplar"):
            ex = {}
            for pair in m.group("exemplar").split(","):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    ex[k.strip()] = v.strip().strip('"')
            exemplars[key] = ex
    return values, exemplars


class OpsClient:
    """One scrape connection to a rank's listen endpoint.

    Thin, reconnecting wrapper over the anonymous serve wire: every
    call opens a short-lived connection when none is held, so a scraper
    survives rank restarts without bookkeeping."""

    def __init__(self, endpoint: str, timeout: Optional[float] = 10.0):
        self.endpoint = endpoint
        self.timeout = timeout
        self._conn: Optional[AnonServeClient] = None

    # ------------------------------------------------------------- raw
    def report(self, kind: str = "health", fleet: bool = False) -> str:
        scope = OPS_SCOPE_FLEET if fleet else OPS_SCOPE_LOCAL
        try:
            return self._client().ops_report(kind, scope=scope)
        except (ConnectionError, OSError):
            # One reconnect: the held socket may have died between polls.
            self.close()
            return self._client().ops_report(kind, scope=scope)

    # ---------------------------------------------------------- parsed
    def health(self, fleet: bool = False) -> Dict[str, Any]:
        return json.loads(self.report("health", fleet=fleet))

    def tables(self) -> List[Dict[str, Any]]:
        return json.loads(self.report("tables"))

    def fleet_tables(self) -> Dict[str, Any]:
        return json.loads(self.report("tables", fleet=True))

    def hotkeys(self, fleet: bool = False):
        """Workload-plane report (docs/observability.md): per-table
        hot-key top-K with count-min estimates, bucket-load skew ratio,
        observed-staleness stats and the add L2/Linf + NaN/Inf health
        sentinels.  Local scope returns the table list; fleet scope the
        usual ``{"ranks": {...}, "silent": [...]}`` wrapper."""
        return json.loads(self.report("hotkeys", fleet=fleet))

    def latency(self, fleet: bool = False):
        """Latency-attribution report (docs/observability.md "latency
        plane"): per-stage histograms (``queue``/``wire_out``/
        ``mailbox``/``apply``/``reactor``/``wire_back`` p50/p95/p99
        with exemplar trace ids), the end-to-end ``total``, per-peer
        clock offsets, and the sampling profiler's status.  Fleet
        scope returns the usual ``{"ranks": {...}}`` wrapper —
        ``tools/latdoctor.py`` is the CLI over this."""
        return json.loads(self.report("latency", fleet=fleet))

    def audit(self, fleet: bool = False):
        """Delivery-audit report (docs/observability.md "audit
        plane"): per table, the worker-side acked-add ledger (last seq
        sent / acked per shard stream), the server-side delivery book
        (per-origin applied watermark, dup/reorder counts, pending
        out-of-order ranges, the bounded anomaly ring) and per-bucket
        content checksums.  Fleet scope returns the usual
        ``{"ranks": {...}}`` wrapper — ``tools/mvaudit.py`` diffs
        acked-vs-applied across it and names every gap, dup, or
        reorder."""
        return json.loads(self.report("audit", fleet=fleet))

    def replication(self, fleet: bool = False):
        """Replication report (docs/replication.md): the routing epoch
        + shard→owner/backup maps, this rank's backed shard, promoted
        shards, and the forward/ack/promotion ledger (forwards, acks,
        applied, parked sync acks, catch-up installs, dup-skipped
        replays).  Fleet scope returns the usual ``{"ranks": {...}}``
        wrapper — ``tools/mvtop.py --replication`` renders it."""
        return json.loads(self.report("replication", fleet=fleet))

    def capacity(self, fleet: bool = False):
        """Capacity-plane report (docs/observability.md "capacity
        plane"): per rank, /proc stats (RSS / VmHWM / open fds /
        uptime), arena + write-queue + registered byte gauges, and per
        table the shard's resident bytes/rows with per-bucket byte and
        load arrays plus the bounded load-history ring (rate curves).
        Worker-side replica/agg/cache bytes are their OWN fields, so
        capacity sums never double-count a replicated row.  Fleet scope
        returns the usual ``{"ranks": {...}}`` wrapper —
        ``tools/mvplan.py`` bin-packs placement proposals over it and
        ``tools/mvtop.py --capacity`` renders it."""
        return json.loads(self.report("capacity", fleet=fleet))

    def alerts(self, fleet: bool = False):
        """Health-plane report (docs/observability.md "health plane"):
        per rank, the native stall watchdog's per-loop progress table
        and the host-pushed alert state (every rule's ok / pending /
        firing verdict with value, severity and age).  Fleet scope
        returns the usual ``{"ranks": {...}, "silent": [...]}``
        wrapper — ``tools/mvtop.py --alerts`` renders it and
        ``tools/mvdoctor.py`` correlates it across planes.  A silent
        rank's alerts are UNKNOWN, never resolved."""
        return json.loads(self.report("alerts", fleet=fleet))

    def metrics(self, fleet: bool = False) -> Tuple[
            Dict[str, float], Dict[str, Dict[str, str]]]:
        """(values, exemplars) of the scraped exposition text."""
        return parse_prometheus(self.report("metrics", fleet=fleet))

    def metrics_text(self, fleet: bool = False) -> str:
        return self.report("metrics", fleet=fleet)

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "OpsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _client(self) -> AnonServeClient:
        if self._conn is None:
            self._conn = AnonServeClient(self.endpoint,
                                         timeout=self.timeout)
        return self._conn
