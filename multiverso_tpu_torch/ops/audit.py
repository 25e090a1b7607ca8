"""Fleet-wide delivery-audit diffing (docs/observability.md "audit
plane") — the pure logic behind ``tools/mvaudit.py`` and mvtop's
``--audit`` view.

Input is the ``"audit"`` OpsQuery fleet report: per rank, per table,
the worker-side acked-add ledger (last seq SENT / ACKED per server
shard stream) and the server-side delivery book (per-origin applied
watermark, dup/reorder counters, pending out-of-order ranges, anomaly
ring).  The invariant diffed here::

    acked(origin o, table t, shard s)  <=  watermark(rank s, t, origin o)

An acked seq the owning server never applied is a **lost acked add** —
the failure class the push-pull contract promises away and ROADMAP
item 1's replication gate must prove absent.  Everything else the books
surface is *named*, not judged: dups (transport retries and injected
chaos both look like this — the point is visibility), reorders (benign
when the pending set drains), gaps (pending ranges that outlived the
server's ``-audit_grace_ms``, which also fired the ``audit_gap``
flight-recorder trigger at detection time), and unacked tails (a
SIGKILLed worker's in-flight async adds: *never acked*, which is
precisely not the same as lost).

Shard streams map to server ranks positionally (static membership:
server shard ``s`` lives on rank ``s``) — the same contract
``ShardOf``/``OwnerOf`` encode on the wire plane.

Pure stdlib, no sockets: feed it any parsed fleet report (live scrape,
archived JSON, test fixture).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

__all__ = ["diff_fleet", "audit_rows", "confirm_lost",
           "checksum_divergence", "render_findings"]

# Finding severity order (render + exit-code policy): a lost acked add
# or an aged gap is a contract violation; the rest is visibility.
_SEVERITY = {"lost": 0, "gap": 1, "silent": 2, "pending_dropped": 3,
             "dup": 4, "reorder": 5, "unacked": 6}


def _tables(rank_doc: Optional[Dict[str, Any]]) -> List[Dict[str, Any]]:
    if not isinstance(rank_doc, dict):
        return []
    return rank_doc.get("tables") or []


def _shard_watermark(ranks: Dict[str, Any], shard: int, table_id,
                     origin: int) -> Optional[int]:
    """The applied watermark covering (shard, table, origin) — the
    shard's registration-time rank first, then any rank whose BACKUP
    instance backs the shard (docs/replication.md): after a failover
    the promoted backup's book is the shard's book, so a dead primary
    does not blind the lost-acked-add check exactly when it matters."""
    def find(doc, book_key):
        for st in _tables(doc):
            if st.get("id") != table_id:
                continue
            book = st.get(book_key)
            if not isinstance(book, dict):
                return None
            for o in book.get("origins") or []:
                if o.get("origin") == origin:
                    return o.get("watermark", 0)
            return 0  # book exists, origin unseen
        return None

    sdoc = ranks.get(str(shard))
    mark = find(sdoc, "server") if sdoc else None
    if mark is not None:
        return mark
    for doc in ranks.values():
        if isinstance(doc, dict) and doc.get("backup_shard") == shard:
            mark = find(doc, "backup")
            if mark is not None:
                return mark
    return None


def diff_fleet(fleet: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Diff one fleet audit report into a finding list, most severe
    first.  Every finding names its table, origin, and seq range —
    "what vanished, whose, and which seqs" rather than a boolean."""
    ranks: Dict[str, Any] = fleet.get("ranks") or {}
    findings: List[Dict[str, Any]] = []

    for r in fleet.get("silent") or []:
        findings.append({"kind": "silent", "rank": int(r),
                         "detail": "rank never answered the audit "
                                   "scrape (fleet deadline)"})

    # Server-side books: dups / reorders / aged gaps / pending evictions.
    for srank, doc in ranks.items():
        for t in _tables(doc):
            server = t.get("server")
            if not isinstance(server, dict):
                continue
            anomalies = server.get("anomalies") or []
            for o in server.get("origins") or []:
                origin = o.get("origin")
                base = {"table": t.get("id"), "origin": origin,
                        "shard": int(srank)}
                if o.get("dups"):
                    seqs = [a for a in anomalies
                            if a.get("kind") == "dup"
                            and a.get("origin") == origin]
                    findings.append({**base, "kind": "dup",
                                     "count": o["dups"],
                                     "seqs": [(a["seq_lo"], a["seq_hi"])
                                              for a in seqs]})
                if o.get("reorders"):
                    findings.append({**base, "kind": "reorder",
                                     "count": o["reorders"],
                                     "pending": o.get("pending") or []})
                if o.get("gap_fired"):
                    lo = (o.get("watermark") or 0) + 1
                    pend = o.get("pending") or []
                    hi = pend[0][0] - 1 if pend else lo
                    findings.append({**base, "kind": "gap",
                                     "seq_lo": lo, "seq_hi": hi,
                                     "detail": "pending out-of-order "
                                               "range outlived "
                                               "-audit_grace_ms "
                                               "(audit_gap blackbox "
                                               "fired)"})
                if o.get("pending_dropped"):
                    findings.append({**base, "kind": "pending_dropped",
                                     "count": o["pending_dropped"]})

    # Acked-vs-applied: the contract invariant, per (origin, table,
    # shard stream).
    for orank, doc in ranks.items():
        for t in _tables(doc):
            worker = t.get("worker") or {}
            for sh in worker.get("shards") or []:
                shard = sh.get("shard", 0)
                sent = sh.get("sent", 0) or 0
                acked = sh.get("acked", 0) or 0
                base = {"table": t.get("id"), "origin": int(orank),
                        "shard": shard}
                if sent > acked:
                    findings.append({**base, "kind": "unacked",
                                     "seq_lo": acked + 1,
                                     "seq_hi": sent,
                                     "detail": "sent but never acked "
                                               "(async tail / dead "
                                               "worker) — NOT lost"})
                if acked <= 0:
                    continue
                # The shard's book: its registration-time rank, or —
                # after a failover — the backup holder's backed book
                # (docs/replication.md).
                watermark = _shard_watermark(ranks, shard, t.get("id"),
                                             int(orank))
                if watermark is None:
                    if ranks.get(str(shard)) is None:
                        # Dead primary AND no backup book: silent, not
                        # provably lossy — already a finding above.
                        continue
                    watermark = 0  # acked but the server has no book
                if acked > watermark:
                    findings.append({**base, "kind": "lost",
                                     "seq_lo": watermark + 1,
                                     "seq_hi": acked,
                                     "detail": "ACKED but never applied "
                                               "— lost acked add(s)"})

    findings.sort(key=lambda f: _SEVERITY.get(f["kind"], 99))
    return findings


def confirm_lost(findings: List[Dict[str, Any]],
                 refreshed: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop transient 'lost' findings: a fleet scrape is not atomic, so
    an ack that landed between the server's and the origin's snapshots
    reads as acked-beyond-watermark for one round.  A loss is CONFIRMED
    only when the refreshed snapshot still reports it for the same
    (table, origin, shard) stream; every other finding kind passes
    through from the refreshed diff unchanged."""
    still = {(f["table"], f["origin"], f["shard"])
             for f in refreshed if f["kind"] == "lost"}
    out = [f for f in refreshed if f["kind"] != "lost"]
    out.extend(f for f in findings
               if f["kind"] == "lost"
               and (f["table"], f["origin"], f["shard"]) in still)
    out.sort(key=lambda f: _SEVERITY.get(f["kind"], 99))
    return out


def checksum_divergence(a: List[int], b: List[int]) -> List[int]:
    """Bucket indices where two shards' content beacons disagree — the
    replica-divergence primitive (two replicas of the SAME shard must
    match bucket for bucket; an empty list means bit-identical state).
    Length mismatch reads as every bucket diverging."""
    if len(a) != len(b):
        return list(range(max(len(a), len(b))))
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def audit_rows(fleet: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flatten a fleet audit report into one row per (server rank,
    table, origin) for tabular rendering (mvaudit / mvtop --audit),
    joining in the origin rank's acked watermark for the lag column."""
    ranks: Dict[str, Any] = fleet.get("ranks") or {}

    def acked_of(origin: int, table_id: Any, shard: int) -> Optional[int]:
        doc = ranks.get(str(origin))
        for t in _tables(doc):
            if t.get("id") != table_id:
                continue
            for sh in (t.get("worker") or {}).get("shards") or []:
                if sh.get("shard") == shard:
                    return sh.get("acked", 0)
        return None

    rows = []
    for srank in sorted(ranks, key=lambda r: int(r)):
        for t in _tables(ranks[srank]):
            server = t.get("server")
            if not isinstance(server, dict):
                continue
            for o in server.get("origins") or []:
                acked = acked_of(o.get("origin"), t.get("id"),
                                 int(srank))
                watermark = o.get("watermark", 0)
                rows.append({
                    "rank": int(srank),
                    "table": t.get("id"),
                    "origin": o.get("origin"),
                    "applied": watermark,
                    "acked": acked,
                    # acked-vs-applied lag: >0 would be a loss in the
                    # making; None ('-') when the origin's ledger is
                    # unreachable (silent rank).
                    "lag": (acked - watermark) if acked is not None
                           else None,
                    "dups": o.get("dups", 0),
                    "reorders": o.get("reorders", 0),
                    "pending": len(o.get("pending") or []),
                    "gap": bool(o.get("gap_fired")),
                })
    return rows


def render_findings(findings: List[Dict[str, Any]]) -> str:
    """Human-readable one-line-per-finding rendering, most severe
    first (the mvaudit CLI's verdict body)."""
    if not findings:
        return "audit: clean — every acked add applied, no gaps"
    lines = []
    for f in findings:
        kind = f["kind"].upper()
        where = ""
        if "table" in f:
            where = (f" table {f['table']} origin {f['origin']}"
                     f" shard {f['shard']}")
        elif "rank" in f:
            where = f" rank {f['rank']}"
        seqs = ""
        if "seq_lo" in f:
            seqs = f" seqs [{f['seq_lo']},{f['seq_hi']}]"
        elif f.get("seqs"):
            seqs = " seqs " + ",".join(f"[{lo},{hi}]"
                                       for lo, hi in f["seqs"][:8])
        count = f" x{f['count']}" if "count" in f else ""
        detail = f" — {f['detail']}" if f.get("detail") else ""
        lines.append(f"{kind}{where}{count}{seqs}{detail}")
    return "\n".join(lines)
