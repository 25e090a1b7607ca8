#!/usr/bin/env python
"""mvaudit — fleet-wide delivery-consistency auditor
(docs/observability.md "audit plane").

Scrapes the ``"audit"`` OpsQuery kind over the anonymous serve wire
(fleet scope: one reachable rank aggregates every peer's books) and
diffs acked-vs-applied watermarks across the fleet:

- every **dup**, **reorder**, and **gap** is NAMED with its seq range
  and origin (the server-side anomaly rings keep the evidence);
- an acked seq the owning server never applied is reported as a
  **LOST ACKED ADD** — the push-pull contract violation this tool
  exists to catch.  Because a fleet scrape is not atomic, a 'lost'
  verdict is confirmed against a second snapshot ``--settle`` seconds
  later before it is believed (an ack racing the scrape is not a loss);
- a worker's unacked tail (async adds in flight when it died) is
  reported as **never acked** — explicitly not lost;
- per-bucket content checksums ride along (``--checksums``): the
  replica-divergence primitive for shard replication.

Exit code 0 = contract held (dups/reorders may still be named — retries
legitimately duplicate); 1 = a confirmed loss or an aged gap; 2 = the
scrape itself failed.  ``--strict`` also fails on dups/reorders.

Usage::

    python tools/mvaudit.py HOST:PORT            # fleet audit via one rank
    python tools/mvaudit.py HOST:PORT --local    # just that rank's books
    python tools/mvaudit.py HOST:PORT --json     # raw findings as JSON
    python tools/mvaudit.py HOST:PORT --watch 2  # refresh loop
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from multiverso_tpu_torch.ops.audit import (audit_rows, confirm_lost,  # noqa: E402
                                      diff_fleet, render_findings)
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402

_COLS = ("rank", "table", "origin", "applied", "acked", "lag", "dups",
         "reorders", "pending", "gap")


def _render_rows(rows: list) -> str:
    disp = []
    for r in rows:
        d = dict(r)
        d["acked"] = "-" if r["acked"] is None else r["acked"]
        d["lag"] = "-" if r["lag"] is None else r["lag"]
        d["gap"] = "GAP" if r["gap"] else "-"
        disp.append({c: str(d.get(c, "-")) for c in _COLS})
    widths = {c: max(len(c), *(len(r[c]) for r in disp))
              if disp else len(c) for c in _COLS}
    return "\n".join(
        ["  ".join(c.rjust(widths[c]) for c in _COLS)] +
        ["  ".join(r[c].rjust(widths[c]) for c in _COLS) for r in disp])


def _snapshot(endpoint: str, fleet: bool, timeout: float) -> dict:
    with OpsClient(endpoint, timeout=timeout) as c:
        doc = c.audit(fleet=fleet)
    if not fleet:
        # Wrap a local report in the fleet shape so one diff path serves
        # both scopes.
        doc = {"ranks": {str(doc.get("rank", 0)): doc}, "silent": []}
    return doc


def run_once(endpoint: str, fleet: bool, timeout: float, settle: float,
             as_json: bool, checksums: bool, strict: bool) -> int:
    try:
        fleet_doc = _snapshot(endpoint, fleet, timeout)
    except (ConnectionError, OSError, ValueError) as exc:
        print(f"mvaudit: scrape failed: {exc}", file=sys.stderr)  # mvlint: MV006-exempt(CLI output)
        return 2
    findings = diff_fleet(fleet_doc)
    if any(f["kind"] == "lost" for f in findings) and settle > 0:
        # Non-atomic scrape: believe a loss only if a settled second
        # snapshot still shows it for the same stream.
        time.sleep(settle)
        try:
            fleet_doc = _snapshot(endpoint, fleet, timeout)
        except (ConnectionError, OSError, ValueError) as exc:
            print(f"mvaudit: confirm scrape failed: {exc}",  # mvlint: MV006-exempt(CLI output)
                  file=sys.stderr)
            return 2
        findings = confirm_lost(findings, diff_fleet(fleet_doc))
    rows = audit_rows(fleet_doc)

    if as_json:
        print(json.dumps({"rows": rows, "findings": findings}, indent=2))  # mvlint: MV006-exempt(CLI output)
    else:
        stamp = time.strftime("%H:%M:%S")
        print(f"mvaudit @ {stamp} — {len(rows)} stream(s), "  # mvlint: MV006-exempt(CLI output)
              f"{len(findings)} finding(s)")
        if rows:
            print(_render_rows(rows))  # mvlint: MV006-exempt(CLI output)
        print(render_findings(findings))  # mvlint: MV006-exempt(CLI output)
        if checksums:
            for rank, doc in sorted((fleet_doc.get("ranks") or {}).items(),
                                    key=lambda kv: int(kv[0])):
                for t in (doc or {}).get("tables") or []:
                    sums = t.get("checksums")
                    if sums:
                        head = " ".join(f"{c:08x}" for c in sums[:8])
                        print(f"checksums rank {rank} table {t['id']}: "  # mvlint: MV006-exempt(CLI output)
                              f"{head}{' ...' if len(sums) > 8 else ''}")

    bad_kinds = {"lost", "gap"}
    if strict:
        bad_kinds |= {"dup", "reorder", "pending_dropped"}
    return 1 if any(f["kind"] in bad_kinds for f in findings) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("endpoint", metavar="HOST:PORT",
                    help="any reachable rank (fleet scope aggregates "
                         "the rest server-side)")
    ap.add_argument("--local", action="store_true",
                    help="audit only the contacted rank (no fan-out)")
    ap.add_argument("--json", action="store_true",
                    help="print rows + findings as JSON")
    ap.add_argument("--checksums", action="store_true",
                    help="print per-bucket content checksum beacons")
    ap.add_argument("--strict", action="store_true",
                    help="also exit nonzero on dups/reorders (default: "
                         "named but tolerated — retries duplicate "
                         "legitimately)")
    ap.add_argument("--settle", type=float, default=0.5, metavar="SEC",
                    help="confirmation delay before believing a 'lost' "
                         "verdict (a non-atomic scrape can race an "
                         "in-flight ack); 0 disables")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SEC",
                    help="refresh every SEC seconds until interrupted")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    while True:
        rc = run_once(args.endpoint, not args.local, args.timeout,
                      args.settle, args.json, args.checksums, args.strict)
        if args.watch <= 0:
            return rc
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            return rc


if __name__ == "__main__":
    sys.exit(main())
