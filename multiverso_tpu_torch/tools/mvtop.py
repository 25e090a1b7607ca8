#!/usr/bin/env python
"""mvtop — live fleet introspection CLI (docs/observability.md).

Polls every rank of a running fleet over the ANONYMOUS serve wire
(``MsgType::OpsQuery`` — answered at the epoll reactor, so even a rank
whose server actor is drowning still reports) and renders one table row
per rank: health verdict, serve queue depth vs the shed bound, live
anonymous clients/sheds, heartbeat-lease dead peers, table versions, and
blackbox trigger count.

Under ``--watch`` every refresh also derives TIME-SERIES RATES from the
two most recent scrapes — versions/s (the apply rate), served gets/adds
per second, client sheds/s — plus a sparkline of the recent apply-rate
history, so a hot shard reads as a moving number instead of a counter
you eyeball twice.

``--audit`` switches to the delivery-audit view (the ``"audit"``
OpsQuery kind): one row per (server rank, table, origin) with the
acked/applied watermark lag, dup/reorder counts and pending
out-of-order ranges; under ``--watch`` a two-scrape ``dup/s`` rate
column joins (``-`` before the first scrape, per the rate discipline —
never a fake zero).  ``tools/mvaudit.py`` is the full diffing auditor.

``--hotkeys`` switches to the workload view (the ``"hotkeys"`` OpsQuery
kind): one row per table per rank ranked by bucket-load skew ratio,
with the space-saving top-K hot keys, observed staleness, and NaN/Inf
update-health sentinels.

``--qos`` switches to the tail-plane tenant view (the ``"latency"``
OpsQuery kind's ``qos`` section, docs/serving.md "tail"): one row per
(rank, tenant class) with its weight, guaranteed budget, live inflight,
admit/shed totals, and deadline sheds, plus the rank's hedge-cancel
ledger; under ``--watch`` two-scrape ``admit/s``/``shed/s`` rate
columns join under the same ``-``-before-two-scrapes discipline.

``--capacity`` switches to the capacity view (the ``"capacity"``
OpsQuery kind, docs/observability.md "capacity plane"): one row per
(rank, table) with shard resident bytes/rows, the worker replica side
table as its own column, agg-buffer bytes, and the rank's arena /
write-queue / RSS gauges; under ``--watch`` two-scrape byte-growth
columns (``b/s``, ``rss/s``) join under the ``-``-before-first-scrape
discipline.  ``tools/mvplan.py`` turns the same scrape into a dry-run
placement proposal.

``--replication`` switches to the replication view (the
``"replication"`` OpsQuery kind, docs/replication.md): one row per
rank with the routing epoch, the shard→owner and shard→backup maps,
which shard the rank backs, its promoted shards, and the
forward/ack/catch-up ledger — the epoch flip after a failover reads
directly off the ``epoch``/``owners``/``promoted`` columns.

``--alerts`` switches to the health-plane view (the ``"alerts"``
OpsQuery kind, docs/observability.md "health plane"): one row per
(rank, rule) with the declarative SLO rule's ok / pending / firing
state, severity, observed value and firing age, plus synthetic
``watchdog:<loop>`` rows for native loops the stall watchdog has
flagged.  A SILENT rank renders an explicit ``unknown`` row — never
``resolved``.  The default view's ``--watch`` refresh also derives a
per-rank firing-alert count column from the same scrape.

Under ``--watch`` a refresh whose scrape fails does NOT kill the loop:
the last good table is re-printed dimmed with every row marked
``stale``, and the next interval retries.

Usage::

    python tools/mvtop.py HOST:PORT [HOST:PORT ...]       # one snapshot
    python tools/mvtop.py HOST:PORT --fleet               # rank fans out
    python tools/mvtop.py HOST:PORT ... --watch 2         # refresh loop
    python tools/mvtop.py HOST:PORT --hotkeys [--fleet]   # workload view
    python tools/mvtop.py HOST:PORT --audit [--fleet]     # delivery audit
    python tools/mvtop.py HOST:PORT --replication [--fleet]  # repl view
    python tools/mvtop.py HOST:PORT --alerts [--fleet]    # health plane
    python tools/mvtop.py HOST:PORT --metrics [--fleet]   # raw Prometheus

``--fleet`` asks the FIRST endpoint to aggregate the whole fleet
server-side (bounded deadline; silent ranks are explicit rows), so a
monitoring box needs reachability to one rank only.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from multiverso_tpu_torch import health  # noqa: E402
from multiverso_tpu_torch.ops.audit import audit_rows  # noqa: E402
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402

_COLS = ("rank", "up", "healthy", "engine", "queue", "max", "clients",
         "shed", "dead", "tables", "vmax", "agg", "boxes")
# Rate columns appended by a RateTracker (watch mode): per-second deltas
# between consecutive scrapes + a sparkline of recent apply rates.
_RATE_COLS = ("v/s", "get/s", "add/s", "shed/s", "trend")

_HOTKEY_COLS = ("rank", "table", "gets", "adds", "skew", "stale~",
                "nan", "inf", "top keys")

_AUDIT_COLS = ("rank", "table", "origin", "applied", "acked", "lag",
               "dups", "reorders", "pending", "gap")
_AUDIT_RATE_COLS = ("dup/s",)

_QOS_COLS = ("rank", "class", "weight", "budget", "inflight", "admits",
             "sheds", "dl_shed", "cancelled")
_QOS_RATE_COLS = ("admit/s", "shed/s")

_REPL_COLS = ("rank", "armed", "sync", "epoch", "owners", "backups",
              "backs", "promoted", "fwd", "acks", "applied", "lag",
              "catchups", "dup_skip")

_CAP_COLS = ("rank", "table", "res_bytes", "rows", "repl_rows",
             "agg_B", "arena_B", "arena_def", "wq_B", "rss_MB")
_CAP_RATE_COLS = ("b/s", "rss/s")

_ALERT_COLS = ("rank", "rule", "severity", "state", "value", "age_s")

# Every ops-plane report kind (serve.wire.OPS_KINDS) -> the mvtop view
# that renders it.  tests assert this map covers OPS_KINDS exactly, so
# a new kind cannot land without an operator-facing view (and a
# docs/observability.md section).
KIND_VIEWS = {
    "metrics": "--metrics",
    "health": "(default)",
    "tables": "(default)",
    "hotkeys": "--hotkeys",
    "latency": "--qos",
    "audit": "--audit",
    "replication": "--replication",
    "capacity": "--capacity",
    "alerts": "--alerts",
}

_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"
_DIM = "\x1b[2m"
_RESET = "\x1b[0m"


def sparkline(values, width: int = 8) -> str:
    """Render the last ``width`` values as a unicode sparkline ("-"
    when there is nothing to show)."""
    vals = [float(v) for v in list(values)[-width:]]
    if not vals:
        return "-"
    hi = max(vals)
    if hi <= 0:
        return _SPARK_GLYPHS[0] * len(vals)
    return "".join(
        _SPARK_GLYPHS[min(len(_SPARK_GLYPHS) - 1,
                          int(v / hi * (len(_SPARK_GLYPHS) - 1)))]
        for v in vals)


def compute_rates(prev: dict, cur: dict, dt: float) -> dict:
    """Per-second rates between two scrape samples of one rank.

    ``prev``/``cur`` are ``{counter_name: value}`` dicts (the vmax /
    gets / adds / shed counters a health+tables scrape yields); the
    result maps each key to ``max(0, (cur - prev) / dt)`` — a restarted
    rank's counter reset reads as 0, not a negative rate.  A counter
    missing from either sample (or ``None`` — the metrics registry's
    ``rate()`` answer before two flushes exist) is simply absent from
    the result: the caller renders ``-``, never a fake 0.0 that would
    read as "zero traffic" on a fresh scrape."""
    out = {}
    if dt <= 0:
        return out
    for k, v in cur.items():
        if v is None or prev.get(k) is None:
            continue
        try:
            d = float(v) - float(prev[k])
        except (KeyError, TypeError, ValueError):
            continue
        out[k] = max(0.0, d / dt)
    return out


class RateTracker:
    """Two-scrape delta state per rank (watch mode): feed each refresh's
    raw counters, get the rate columns + sparkline back."""

    HISTORY = 32

    def __init__(self):
        self._prev = {}      # rank -> (ts, counters)
        self._trend = {}     # rank -> [recent v/s]

    def update(self, rank: str, counters: dict,
               now: float = None) -> dict:
        ts = time.monotonic() if now is None else float(now)
        cols = {c: "-" for c in _RATE_COLS}
        prev = self._prev.get(rank)
        self._prev[rank] = (ts, dict(counters))
        if prev is None:
            return cols
        rates = compute_rates(prev[1], counters, ts - prev[0])

        def fmt(key):
            # An uncomputable rate renders '-', never a fake zero.
            v = rates.get(key)
            return "-" if v is None else f"{v:.1f}"

        trend = self._trend.setdefault(rank, [])
        trend.append(rates.get("vmax", 0.0))
        del trend[:-self.HISTORY]
        cols["v/s"] = fmt("vmax")
        cols["get/s"] = fmt("gets")
        cols["add/s"] = fmt("adds")
        cols["shed/s"] = fmt("shed")
        cols["trend"] = sparkline(trend)
        # Audit view's rate column rides the same two-scrape state.
        if "dups" in counters:
            cols["dup/s"] = fmt("dups")
        # Capacity view's byte-growth columns (docs/observability.md
        # "capacity plane") — '-' before two scrapes, never a fake 0.
        if "res_bytes" in counters:
            cols["b/s"] = fmt("res_bytes")
        if "rss" in counters:
            cols["rss/s"] = fmt("rss")
        # QoS view's per-class rate columns (docs/serving.md "tail").
        if "admits" in counters:
            cols["admit/s"] = fmt("admits")
        if "sheds" in counters:
            cols["shed/s"] = fmt("sheds")
        return cols


def _row_from_health(rank: str, h: dict, tables: list) -> dict:
    vmax = max((t.get("version", 0) or 0 for t in tables), default=0)
    agg = sum(t.get("agg_pending", 0) or 0 for t in tables)
    return {
        "rank": rank,
        "up": "yes",
        "healthy": "yes" if h.get("healthy") else "NO",
        # Effective engine; a "uring!epoll"-style cell flags a rank
        # whose requested engine was degraded at startup (the health
        # report's engine_fallback field).
        "engine": ("%s!%s" % (h.get("engine_requested", "?"),
                              h.get("engine", "?"))
                   if h.get("engine_fallback") else h.get("engine", "?")),
        "queue": h.get("serve_queue_depth", 0),
        "max": h.get("server_inflight_max", 0),
        "clients": h.get("clients", 0),
        "shed": h.get("client_shed", 0),
        "dead": ",".join(map(str, h.get("dead_peers", []))) or "-",
        "tables": len(tables),
        "vmax": vmax,
        "agg": agg,
        "boxes": h.get("blackbox_triggers", 0),
        # Raw counters for the rate tracker (dropped before render).
        "_counters": {
            "vmax": vmax,
            "gets": sum(t.get("gets", 0) or 0 for t in tables),
            "adds": sum(t.get("adds", 0) or 0 for t in tables),
            "shed": h.get("client_shed", 0) or 0,
        },
    }


def _dead_row(rank: str) -> dict:
    row = {c: "-" for c in _COLS}
    row.update({"rank": rank, "up": "NO", "healthy": "NO"})
    return row


def collect(endpoints: list, fleet: bool, timeout: float) -> list:
    rows = []
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            fh = c.health(fleet=True)
            ft = c.fleet_tables()
        silent = set(map(str, fh.get("silent", [])))
        for rank in sorted(fh.get("ranks", {}), key=int):
            h = fh["ranks"][rank]
            if rank in silent or h is None:
                rows.append(_dead_row(rank))
                continue
            tables = (ft.get("ranks", {}) or {}).get(rank) or []
            rows.append(_row_from_health(rank, h, tables))
        for rank in map(str, fh.get("dead", [])):
            for row in rows:
                if row["rank"] == rank and row["up"] == "yes":
                    row["healthy"] = "NO(lease)"
        return rows
    for ep in endpoints:
        try:
            with OpsClient(ep, timeout=timeout) as c:
                h = c.health()
                tables = c.tables()
            rows.append(_row_from_health(h.get("rank", ep), h, tables))
        except (ConnectionError, OSError, TimeoutError):
            rows.append(_dead_row(ep))
    return rows


def _fmt_topk(entry: dict, n: int = 4) -> str:
    top = (entry.get("hotkeys") or {}).get("topk") or []
    return " ".join(f"{t['key']}:{t['count']}" for t in top[:n]) or "-"


def hotkey_rows(endpoints: list, fleet: bool, timeout: float) -> list:
    """One row per (rank, table), ranked by skew ratio descending —
    the hot-shard triage view."""
    per_rank = {}
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            fh = c.hotkeys(fleet=True)
        for rank, tables in (fh.get("ranks") or {}).items():
            per_rank[str(rank)] = tables or []
    else:
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    h = c.health()
                    per_rank[str(h.get("rank", ep))] = c.hotkeys()
            except (ConnectionError, OSError, TimeoutError):
                per_rank[str(ep)] = None
    rows = []
    for rank in sorted(per_rank):
        tables = per_rank[rank]
        if tables is None:
            rows.append({c: "-" for c in _HOTKEY_COLS} | {"rank": rank})
            continue
        for t in tables:
            if "gets" not in t:     # no local shard on this rank
                continue
            rows.append({
                "rank": rank,
                "table": t.get("id", "?"),
                "gets": t.get("gets", 0),
                "adds": t.get("adds", 0),
                "skew": f"{t.get('skew_ratio', 0.0):.2f}",
                "stale~": f"{t.get('staleness_mean', 0.0):.1f}",
                "nan": t.get("nan_count", 0),
                "inf": t.get("inf_count", 0),
                "top keys": _fmt_topk(t),
            })
    rows.sort(key=lambda r: -float(r.get("skew", 0) or 0))
    return rows


def qos_rows(per_rank: dict, tracker: "RateTracker" = None,
             now: float = None) -> list:
    """One row per (rank, tenant class) from ``{rank: latency-report}``
    (docs/serving.md "tail").  With a tracker (watch mode) two-scrape
    admit/s + shed/s columns are derived — '-' before two scrapes
    exist, never a fake zero."""
    rows = []
    for rank in sorted(per_rank, key=str):
        rep = per_rank[rank] or {}
        q = rep.get("qos") or {}
        for c in q.get("classes") or []:
            row = {
                "rank": rank,
                "class": c.get("name", "?"),
                "weight": c.get("weight", "-"),
                "budget": c.get("budget", "-"),
                "inflight": c.get("inflight", "-"),
                "admits": c.get("admits", 0),
                "sheds": c.get("sheds", 0),
                "dl_shed": c.get("deadline_sheds", 0),
                "cancelled": q.get("cancelled", 0),
            }
            if tracker is not None:
                rates = tracker.update(
                    f"{rank}/{row['class']}",
                    {"vmax": 0, "admits": row["admits"],
                     "sheds": row["sheds"]}, now=now)

                def fmt(key, rates=rates):
                    return rates.get(key, "-")

                row["admit/s"] = fmt("admit/s")
                row["shed/s"] = fmt("shed/s")
            rows.append(row)
    return rows


def collect_qos(endpoints: list, fleet: bool, timeout: float,
                tracker: "RateTracker" = None) -> list:
    """Fetch per-rank latency reports (their qos sections) and render
    the tenant rows."""
    per_rank = {}
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            doc = c.latency(fleet=True)
        for rank, rep in (doc.get("ranks") or {}).items():
            per_rank[str(rank)] = rep
    else:
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    rep = c.latency()
                per_rank[str(rep.get("rank", ep))] = rep
            except (ConnectionError, OSError, TimeoutError):
                per_rank[str(ep)] = None
    return qos_rows(per_rank, tracker=tracker)


def collect_audit(endpoints: list, fleet: bool, timeout: float,
                  tracker: "RateTracker" = None) -> list:
    """One row per (server rank, table, origin) from the fleet audit
    report; with a tracker (watch mode) a two-scrape dup/s column is
    derived — '-' before two scrapes exist, never a fake zero."""
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            doc = c.audit(fleet=True)
    else:
        doc = {"ranks": {}, "silent": []}
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    local = c.audit()
                doc["ranks"][str(local.get("rank", ep))] = local
            except (ConnectionError, OSError, TimeoutError):
                doc["silent"].append(ep)
    rows = []
    for r in audit_rows(doc):
        row = {c: r.get(c, "-") for c in _AUDIT_COLS}
        row["acked"] = "-" if r["acked"] is None else r["acked"]
        row["lag"] = "-" if r["lag"] is None else r["lag"]
        row["gap"] = "GAP" if r["gap"] else "-"
        if tracker is not None:
            key = f"{r['rank']}/{r['table']}/{r['origin']}"
            rates = tracker.update(key, {"dups": r["dups"]})
            row["dup/s"] = rates.get("dup/s", "-")
        rows.append(row)
    for ep in doc.get("silent") or []:
        rows.append({c: "-" for c in _AUDIT_COLS} | {"rank": ep})
    return rows


def capacity_rows(per_rank: dict, tracker: "RateTracker" = None,
                  now: float = None) -> list:
    """One row per (rank, table) from ``{rank: capacity-report}``
    (docs/observability.md "capacity plane"): shard resident bytes and
    rows, the worker replica side table as its OWN column (never folded
    into the shard count — the double-count fix), agg-buffer bytes, the
    rank's arena/write-queue/RSS gauges, and — with a tracker (watch
    mode) — two-scrape byte-growth columns (``b/s``/``rss/s``), '-'
    before two scrapes exist, never a fake zero.  Pure, so the
    canned-scrape tests drive it without a fleet."""
    rows = []
    for rank in sorted(per_rank, key=str):
        doc = per_rank[rank]
        if not doc:
            rows.append({c: "-" for c in _CAP_COLS} | {"rank": rank})
            continue
        arena = doc.get("arena") or {}
        proc = doc.get("proc") or {}
        net = doc.get("net") or {}
        rss = proc.get("rss_bytes", -1) or -1
        for t in doc.get("tables") or []:
            shard = t.get("shard")
            if not shard:
                continue
            worker = t.get("worker") or {}
            res = shard.get("resident_bytes", 0)
            row = {
                "rank": rank,
                "table": t.get("id", "?"),
                "res_bytes": res,
                "rows": shard.get("rows", 0),
                "repl_rows": worker.get("replica_rows", 0),
                "agg_B": worker.get("agg_bytes", 0),
                "arena_B": arena.get("bytes", 0),
                "arena_def": arena.get("deferred", 0),
                "wq_B": net.get("writeq_bytes", 0),
                "rss_MB": f"{rss / 1e6:.1f}" if rss >= 0 else "-",
            }
            if tracker is not None:
                rates = tracker.update(
                    f"{rank}/{row['table']}",
                    {"vmax": 0, "res_bytes": res,
                     "rss": rss if rss >= 0 else None}, now=now)
                row["b/s"] = rates.get("b/s", "-")
                row["rss/s"] = rates.get("rss/s", "-")
            rows.append(row)
    return rows


def collect_capacity(endpoints: list, fleet: bool, timeout: float,
                     tracker: "RateTracker" = None) -> list:
    per_rank = {}
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            doc = c.capacity(fleet=True)
        for rank, rep in (doc.get("ranks") or {}).items():
            per_rank[str(rank)] = rep
        for rank in doc.get("silent") or []:
            per_rank[str(rank)] = None
    else:
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    rep = c.capacity()
                per_rank[str(rep.get("rank", ep))] = rep
            except (ConnectionError, OSError, TimeoutError):
                per_rank[str(ep)] = None
    return capacity_rows(per_rank, tracker=tracker)


def repl_rows(doc: dict) -> list:
    """One row per rank from a fleet ``"replication"`` report
    (docs/replication.md): the routed shard map, who backs what, and
    the forward/ack/promotion ledger.  Pure so the canned-scrape test
    can drive it without a fleet."""
    rows = []
    for rank in sorted(doc.get("ranks") or {}, key=str):
        r = (doc["ranks"] or {}).get(rank)
        if not r:
            rows.append({c: "-" for c in _REPL_COLS} | {"rank": rank,
                                                        "armed": "DEAD"})
            continue
        st = r.get("stats") or {}
        rows.append({
            "rank": rank,
            "armed": "yes" if r.get("armed") else "no",
            "sync": "yes" if r.get("sync") else "no",
            "epoch": r.get("epoch", 0),
            "owners": ",".join(str(x) for x in r.get("owners") or []),
            "backups": ",".join(str(x) for x in r.get("backups") or []),
            "backs": r.get("backup_shard", -1),
            "promoted": ",".join(str(x) for x in r.get("promoted") or [])
                        or "-",
            "fwd": st.get("forwards", 0),
            "acks": st.get("acks", 0),
            "applied": st.get("applied", 0),
            "lag": r.get("outstanding", 0),
            "catchups": st.get("catchups", 0),
            "dup_skip": st.get("dup_skips", 0),
        })
    for ep in doc.get("silent") or []:
        rows.append({c: "-" for c in _REPL_COLS} | {"rank": ep,
                                                    "armed": "SILENT"})
    return rows


def collect_replication(endpoints: list, fleet: bool,
                        timeout: float) -> list:
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            doc = c.replication(fleet=True)
    else:
        doc = {"ranks": {}, "silent": []}
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    local = c.replication()
                doc["ranks"][str(local.get("rank", ep))] = local
            except (ConnectionError, OSError, TimeoutError):
                doc["silent"].append(ep)
    return repl_rows(doc)


def alert_view_rows(doc: dict) -> list:
    """Format ``health.fleet_alert_rows`` for the table: firing rows
    first (criticals first within a state), ``unknown`` rows next —
    a silent rank reads as "no idea", never "all clear".  Pure, so the
    canned-scrape tests drive it without a fleet."""
    sev_rank = {"critical": 0, "warning": 1, "info": 2}
    state_rank = {"firing": 0, "unknown": 1, "pending": 2, "ok": 3}
    rows = []
    for r in health.fleet_alert_rows(doc):
        rows.append({
            "rank": r["rank"],
            "rule": r["rule"],
            "severity": r["severity"],
            "state": r["state"],
            "value": "-" if r["value"] is None else f"{r['value']:.4g}",
            "age_s": "-" if r["age_s"] is None else f"{r['age_s']:.0f}",
        })
    rows.sort(key=lambda r: (state_rank.get(r["state"], 9),
                             sev_rank.get(r["severity"], 9),
                             str(r["rank"]), r["rule"]))
    return rows


def firing_counts(doc: dict) -> dict:
    """``{rank: firing-alert count}`` from an ``"alerts"`` report —
    the default watch view's ``alerts`` column.  A silent rank counts
    as ``"?"`` (unknown), never 0."""
    counts = {}
    for r in health.fleet_alert_rows(doc):
        rank = str(r["rank"])
        if r["state"] == "unknown":
            counts.setdefault(rank, "?")
        else:
            base = counts.get(rank, 0)
            base = 0 if not isinstance(base, int) else base
            counts[rank] = base + (1 if r["state"] == "firing" else 0)
    return counts


def fetch_alerts(endpoints: list, fleet: bool, timeout: float) -> dict:
    """Raw ``"alerts"`` report in the fleet-wrapper shape (per-endpoint
    polling synthesises the same ``{"ranks":, "silent":}`` envelope)."""
    if fleet:
        with OpsClient(endpoints[0], timeout=timeout) as c:
            return c.alerts(fleet=True)
    doc = {"ranks": {}, "silent": []}
    for ep in endpoints:
        try:
            with OpsClient(ep, timeout=timeout) as c:
                local = c.alerts()
            doc["ranks"][str(local.get("rank", ep))] = local
        except (ConnectionError, OSError, TimeoutError):
            doc["silent"].append(ep)
    return doc


def collect_alerts(endpoints: list, fleet: bool, timeout: float) -> list:
    return alert_view_rows(fetch_alerts(endpoints, fleet, timeout))


def render_stale(table: str, err: Exception) -> str:
    """The watch loop's answer to a mid-refresh scrape failure: the
    last good table re-printed dimmed, every row marked ``stale`` —
    the loop survives, and stale data cannot masquerade as fresh."""
    stamp = time.strftime("%H:%M:%S")
    lines = [f"mvtop @ {stamp} — scrape failed ({err}); "
             f"showing last good scrape"]
    for line in table.splitlines():
        lines.append(f"{_DIM}{line}  stale{_RESET}")
    return "\n".join(lines)


def render(rows: list, cols=_COLS) -> str:
    rows = [{c: r.get(c, "-") for c in cols} for r in rows]
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows))
              if rows else len(c) for c in cols}
    out = ["  ".join(c.rjust(widths[c]) for c in cols)]
    for r in rows:
        out.append("  ".join(str(r[c]).rjust(widths[c]) for c in cols))
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("endpoints", nargs="+", metavar="HOST:PORT")
    ap.add_argument("--fleet", action="store_true",
                    help="ask the first endpoint to aggregate the fleet "
                         "server-side (silent ranks become explicit rows)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the raw Prometheus exposition instead of "
                         "the table")
    ap.add_argument("--audit", action="store_true",
                    help="delivery-audit view: acked/applied watermark "
                         "lag, dup/reorder counts and pending ranges "
                         "per (rank, table, origin) — the \"audit\" "
                         "OpsQuery kind (mvaudit diffs it fully)")
    ap.add_argument("--hotkeys", action="store_true",
                    help="workload view: tables ranked by bucket-load "
                         "skew ratio, with top-K hot keys and NaN/Inf "
                         "health sentinels")
    ap.add_argument("--qos", action="store_true",
                    help="tail-plane tenant view: per-class admission "
                         "budgets, admit/shed totals, deadline sheds "
                         "and hedge cancels (docs/serving.md \"tail\")")
    ap.add_argument("--capacity", action="store_true",
                    help="capacity view: per-(rank, table) resident "
                         "bytes/rows, replica side-table rows, arena "
                         "and write-queue gauges, RSS, and (--watch) "
                         "two-scrape byte-growth rates "
                         "(docs/observability.md \"capacity plane\")")
    ap.add_argument("--replication", action="store_true",
                    help="replication view: routing epoch + shard "
                         "owner/backup maps, promoted shards, and the "
                         "forward/ack ledger per rank "
                         "(docs/replication.md)")
    ap.add_argument("--alerts", action="store_true",
                    help="health-plane view: per-(rank, rule) SLO "
                         "alert state (ok/pending/firing) with value "
                         "and age, plus native watchdog stall rows — "
                         "the \"alerts\" OpsQuery kind "
                         "(docs/observability.md \"health plane\")")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                    help="refresh every SEC seconds until interrupted "
                         "(adds two-scrape rate columns + sparklines)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    tracker = RateTracker()
    last = None  # last good refresh's output (watch-mode stale fallback)
    while True:
        try:
            out = _refresh(args, tracker)
        except (ConnectionError, OSError, TimeoutError) as e:
            # A mid-watch scrape failure must not kill the loop: show
            # the last good table dimmed + marked stale and retry on
            # the next interval.  Single-shot mode still fails loudly.
            if args.watch <= 0 or last is None:
                raise
            print(render_stale(last, e))  # mvlint: MV006-exempt(CLI output)
        else:
            last = out
            print(out)  # mvlint: MV006-exempt(CLI output)
        if args.watch <= 0:
            return 0
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return 0


def _refresh(args, tracker: RateTracker) -> str:
    """One scrape + render pass — everything main()'s loop prints.
    Raises the usual socket errors instead of printing so the watch
    loop can fall back to the stale rendering."""
    stamp = time.strftime("%H:%M:%S")
    if args.metrics:
        with OpsClient(args.endpoints[0], timeout=args.timeout) as c:
            return c.metrics_text(fleet=args.fleet)
    if args.audit:
        t = tracker if args.watch > 0 else None
        rows = collect_audit(args.endpoints, args.fleet,
                             args.timeout, tracker=t)
        cols = _AUDIT_COLS + (_AUDIT_RATE_COLS if t else ())
        return (f"mvtop --audit @ {stamp} — {len(rows)} stream(s)\n"
                + render(rows, cols))
    if args.qos:
        t = tracker if args.watch > 0 else None
        rows = collect_qos(args.endpoints, args.fleet, args.timeout,
                           tracker=t)
        cols = _QOS_COLS + (_QOS_RATE_COLS if t else ())
        return (f"mvtop --qos @ {stamp} — {len(rows)} class row(s)\n"
                + render(rows, cols))
    if args.capacity:
        t = tracker if args.watch > 0 else None
        rows = collect_capacity(args.endpoints, args.fleet,
                                args.timeout, tracker=t)
        cols = _CAP_COLS + (_CAP_RATE_COLS if t else ())
        return (f"mvtop --capacity @ {stamp} — {len(rows)} "
                f"table row(s)\n" + render(rows, cols))
    if args.replication:
        rows = collect_replication(args.endpoints, args.fleet,
                                   args.timeout)
        return (f"mvtop --replication @ {stamp} — {len(rows)} rank(s)\n"
                + render(rows, _REPL_COLS))
    if args.hotkeys:
        rows = hotkey_rows(args.endpoints, args.fleet, args.timeout)
        return (f"mvtop --hotkeys @ {stamp} — {len(rows)} table row(s)\n"
                + render(rows, _HOTKEY_COLS))
    if args.alerts:
        rows = collect_alerts(args.endpoints, args.fleet, args.timeout)
        firing = sum(1 for r in rows if r["state"] == "firing")
        return (f"mvtop --alerts @ {stamp} — {len(rows)} alert(s), "
                f"{firing} firing\n" + render(rows, _ALERT_COLS))
    rows = collect(args.endpoints, args.fleet, args.timeout)
    cols = _COLS
    if args.watch > 0:
        # Watch mode folds in the health plane: a per-rank firing-alert
        # count ('?' for silent ranks) + the two-scrape rate columns.
        cols = _COLS + ("alerts",) + _RATE_COLS
        try:
            counts = firing_counts(fetch_alerts(
                args.endpoints, args.fleet, args.timeout))
        except (ConnectionError, OSError, TimeoutError):
            counts = {}
        for row in rows:
            row["alerts"] = counts.get(str(row["rank"]), "-")
            row.update(tracker.update(
                str(row["rank"]), row.get("_counters", {})))
    return (f"mvtop @ {stamp} — {len(rows)} rank(s)\n"
            + render(rows, cols))


if __name__ == "__main__":
    sys.exit(main())
