#!/usr/bin/env python
"""mvdoctor — cross-plane root-cause correlation
(docs/observability.md "health plane").

Scrapes FIVE ops planes from a running fleet over the anonymous serve
wire — ``"alerts"`` (declarative SLO rules + native stall watchdog),
``"latency"`` (per-stage histograms), ``"audit"`` (delivery ledgers),
``"capacity"`` (bytes/rows/RSS) and ``"hotkeys"`` (workload skew) —
and correlates them into a RANKED root-cause diagnosis instead of five
tables you eyeball side by side:

- a firing latency-SLO alert is joined with the latency plane's
  dominant p99 stage ("rank 0: latency SLO burn — dominant p99 stage
  is 'apply'"), and when that stage is ``apply`` and the workload
  plane shows a skewed table on the same rank, the hot keys are named
  as the likely cause;
- a firing audit-gap alert (or raw gap in the audit books) names the
  exact (rank, table, origin) streams that lost acked adds;
- a firing RSS-growth alert names the rank's largest resident table
  from the capacity plane;
- a native watchdog stall names the stuck loop and points at the
  folded stacks already dumped into the flight recorder;
- a SILENT rank is a finding of its own — unknown is not healthy.

Every firing alert surfaces even when no correlation matches, so the
diagnosis is a superset of ``mvtop --alerts``.  Findings are ranked
critical > warning > info.

Usage::

    python tools/mvdoctor.py HOST:PORT            # per-endpoint polls
    python tools/mvdoctor.py HOST:PORT --fleet    # rank fans out
    python tools/mvdoctor.py HOST:PORT --json     # machine-readable
    python tools/mvdoctor.py HOST:PORT --strict   # exit 1 on critical
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from multiverso_tpu_torch import health  # noqa: E402
from multiverso_tpu_torch.latency import dominant_stage, stage_summary  # noqa: E402
from multiverso_tpu_torch.ops.audit import audit_rows  # noqa: E402
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402

PLANES = ("alerts", "latency", "audit", "capacity", "hotkeys", "health")

_SEV_RANK = {"critical": 0, "warning": 1, "info": 2}

# A table whose bucket-load skew ratio clears this bound is "hot" for
# correlation purposes (mirrors the workload plane's triage intuition:
# perfectly balanced buckets sit at 1.0).
_HOT_SKEW = 4.0


def _per_rank(doc: dict) -> dict:
    """``{rank: report-or-None}`` from a fleet envelope or a single
    rank's local report.  Silent ranks are explicit ``None`` entries."""
    if not doc:
        return {}
    if "ranks" in doc:
        out = {str(r): rep for r, rep in (doc.get("ranks") or {}).items()}
        for r in doc.get("silent") or []:
            out[str(r)] = None
        return out
    return {str(doc.get("rank", "?")): doc}


def collect(endpoints: list, fleet: bool, timeout: float) -> dict:
    """``{plane: raw-report-doc}`` for every plane in :data:`PLANES`.

    Fleet scope asks the first endpoint to aggregate server-side;
    otherwise each endpoint is polled and the same ``{"ranks":,
    "silent":}`` envelope is synthesised so :func:`diagnose` sees one
    shape.  A plane whose scrape fails entirely becomes ``{}`` — the
    diagnosis degrades to the planes that answered instead of dying."""
    planes = {}
    for plane in PLANES:
        if fleet:
            try:
                with OpsClient(endpoints[0], timeout=timeout) as c:
                    planes[plane] = json.loads(
                        c.report(plane, fleet=True))
            except (ConnectionError, OSError, TimeoutError, ValueError):
                planes[plane] = {}
            continue
        doc = {"ranks": {}, "silent": []}
        for ep in endpoints:
            try:
                with OpsClient(ep, timeout=timeout) as c:
                    local = json.loads(c.report(plane))
                # The hotkeys report is a bare list; every other plane
                # is a dict that names its own rank.
                rank = (local.get("rank", ep)
                        if isinstance(local, dict) else ep)
                doc["ranks"][str(rank)] = local
            except (ConnectionError, OSError, TimeoutError, ValueError):
                doc["silent"].append(ep)
        planes[plane] = doc
    return planes


def _hot_tables(rep) -> list:
    """Skew-sorted ``(table, skew, top-keys)`` for one rank's hotkeys
    report (a list of per-table entries)."""
    out = []
    for t in rep or []:
        if "gets" not in t:
            continue
        skew = float(t.get("skew_ratio", 0.0) or 0.0)
        if skew < _HOT_SKEW:
            continue
        top = (t.get("hotkeys") or {}).get("topk") or []
        keys = " ".join(f"{e['key']}:{e['count']}" for e in top[:4])
        out.append((t.get("id", "?"), skew, keys or "-"))
    out.sort(key=lambda x: -x[1])
    return out


def diagnose(planes: dict) -> list:
    """Pure cross-plane correlation: raw plane docs in, ranked finding
    dicts out (``{"severity", "rank", "title", "evidence": [...]}``).

    Canned-scrape tests drive this without a fleet; the acceptance bar
    is a seeded ``apply_delay`` fault producing a finding that names
    BOTH the rank and the ``apply`` stage."""
    findings = []
    alert_rows = health.fleet_alert_rows(planes.get("alerts") or {})
    lat = _per_rank(planes.get("latency") or {})
    cap = _per_rank(planes.get("capacity") or {})
    hot = _per_rank(planes.get("hotkeys") or {})

    def add(severity, rank, title, evidence=(), score=0.0):
        findings.append({"severity": severity, "rank": str(rank),
                         "title": title, "evidence": list(evidence),
                         "score": float(score)})

    # -- audit plane: a gap is a correctness loss, alert or not. ------
    gap_streams = {}
    for r in audit_rows(planes.get("audit") or {}):
        if r.get("gap"):
            gap_streams.setdefault(str(r["rank"]), []).append(
                f"table {r['table']} origin {r['origin']} "
                f"(applied {r['applied']}, acked {r['acked']})")
    for rank, streams in sorted(gap_streams.items()):
        add("critical", rank,
            "delivery audit gap — acked adds never applied",
            [f"stream: {s}" for s in streams],
            score=len(streams) + 100.0)

    # -- health plane: an engine downgrade deserves a line even when
    # nothing is on fire — the rank asked for uring and silently lost
    # its zero-copy data plane at startup.
    for rank, h in sorted((_per_rank(planes.get("health") or {})).items()):
        if isinstance(h, dict) and h.get("engine_fallback"):
            add("info", rank,
                "net engine degraded at startup",
                [f"requested '{h.get('engine_requested', '?')}', running "
                 f"'{h.get('engine', '?')}' — the probe reason is in the "
                 "startup log / lifecycle blackbox stream"],
                score=1.0)

    # -- alert plane: every firing rule surfaces; correlations enrich.
    for a in alert_rows:
        rank, rule, state = a["rank"], a["rule"], a["state"]
        if state == "unknown":
            add("warning", rank,
                "rank is SILENT — every plane unknown",
                ["no ops reply inside the fleet deadline; unknown is "
                 "not healthy (and not 'resolved')"], score=50.0)
            continue
        if state != "firing":
            continue
        sev = a["severity"] if a["severity"] in _SEV_RANK else "warning"
        value = a.get("value")
        detail = "" if value is None else f" (value {value:.4g}"
        if detail and a.get("age_s") is not None:
            detail += f", firing {a['age_s']:.0f}s"
        ev = [f"alert '{rule}' firing" + (detail + ")" if detail
                                          else "")]
        score = float(value or 0.0)

        if rule.startswith("watchdog:"):
            loop = rule.split(":", 1)[1]
            add("critical", rank,
                f"native loop '{loop}' stalled with work queued",
                [f"queued={value:.0f}" if value is not None else
                 "work queued, no progress",
                 "folded stacks already dumped to the flight recorder "
                 "(watchdog_stacks blackbox event)"],
                score=90.0)
            continue

        if rule.startswith("lat"):
            rep = lat.get(str(rank)) or {}
            dom = dominant_stage(rep, "p99_ms")
            if dom:
                summary = stage_summary(rep)
                v = summary.get(dom, {}).get("p99_ms", 0.0)
                ev.append(f"latency plane: dominant p99 stage is "
                          f"'{dom}' ({v:.3f} ms)")
                if dom == "apply":
                    for table, skew, keys in _hot_tables(
                            hot.get(str(rank)))[:1]:
                        ev.append(f"workload plane: table {table} is "
                                  f"hot (skew {skew:.1f}, top keys "
                                  f"{keys}) — likely cause")
                title = (f"latency SLO burn — dominant p99 stage is "
                         f"'{dom}'")
            else:
                title = "latency SLO burn (no stage samples to blame)"
            add(sev, rank, title, ev, score=80.0 + score)
            continue

        if rule == "rss-growth":
            rep = cap.get(str(rank)) or {}
            tables = sorted((t for t in rep.get("tables") or []
                             if t.get("shard")),
                            key=lambda t: -(t["shard"].get(
                                "resident_bytes", 0) or 0))
            if tables:
                t = tables[0]
                ev.append(f"capacity plane: largest table "
                          f"{t.get('id', '?')} holds "
                          f"{t['shard'].get('resident_bytes', 0)} "
                          f"resident bytes")
            add(sev, rank, "RSS growing past the rule budget", ev,
                score=40.0 + score)
            continue

        if rule == "audit-gap" and str(rank) in gap_streams:
            continue  # already a richer finding above
        add(sev, rank, f"alert '{rule}' firing", ev, score=score)

    # -- workload plane: hot shards are findings even before any rule
    # fires — the thing you fix before it becomes a latency page.  A
    # rank whose hot table already rode along as latency evidence is
    # not repeated.
    for rank, rep in sorted(hot.items()):
        if rep is None:
            continue
        correlated = any(f["rank"] == str(rank)
                         and any("workload plane" in e
                                 for e in f["evidence"])
                         for f in findings)
        if correlated:
            continue
        for table, skew, keys in _hot_tables(rep)[:2]:
            add("info", rank,
                f"hot shard: table {table} skew {skew:.1f}",
                [f"top keys: {keys}"], score=skew)

    findings.sort(key=lambda f: (_SEV_RANK.get(f["severity"], 9),
                                 -f["score"], f["rank"], f["title"]))
    for f in findings:
        f.pop("score", None)
    return findings


def render(findings: list) -> str:
    if not findings:
        return "no findings — every scraped plane is quiet"
    out = []
    for i, f in enumerate(findings, 1):
        out.append(f"{i}. [{f['severity']}] rank {f['rank']}: "
                   f"{f['title']}")
        for ev in f["evidence"]:
            out.append(f"     - {ev}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("endpoints", nargs="+", metavar="HOST:PORT")
    ap.add_argument("--fleet", action="store_true",
                    help="ask the first endpoint to aggregate every "
                         "plane fleet-wide server-side")
    ap.add_argument("--json", action="store_true",
                    help="print {'findings': [...], 'planes': {...}} "
                         "as JSON instead of the ranked text")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any finding is critical (CI / "
                         "chaos-drill gate)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    planes = collect(args.endpoints, args.fleet, args.timeout)
    findings = diagnose(planes)
    if args.json:
        print(json.dumps({"findings": findings, "planes": planes},  # mvlint: MV006-exempt(CLI output)
                         indent=2))
    else:
        print(render(findings))  # mvlint: MV006-exempt(CLI output)
    if args.strict and any(f["severity"] == "critical"
                           for f in findings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
