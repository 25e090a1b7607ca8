#!/usr/bin/env python
"""latdoctor — name the stage where the tail lives
(docs/observability.md "latency plane").

Fetches the per-stage latency histograms a running rank (or the whole
fleet) serves over the ANONYMOUS ops wire (the ``"latency"`` OpsQuery
kind: stage p50/p95/p99 reconstructed from the wire-stamped timing
trails, per-peer clock offsets, profiler status) and prints, per rank:

- one row per stage (queue / wire_out / mailbox / apply / reactor /
  wire_back) with p50/p95/p99 and sample count;
- the end-to-end ``total`` row plus the stage-sum sanity line (offset-
  corrected stages telescope back to the total — a big gap means the
  clock offsets are stale);
- the DOMINANT stage per percentile — the one-line answer to "where is
  my p99".  A seeded ``MV_SetFault("apply_delay", ...)`` slowdown must
  show up here as ``apply``, never as the wire (the acceptance bar).
- per-peer clock offsets and the sampling profiler's status.

Usage::

    python tools/latdoctor.py HOST:PORT            # one rank
    python tools/latdoctor.py HOST:PORT --fleet    # rank fans out
    python tools/latdoctor.py HOST:PORT --json     # raw report JSON
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from multiverso_tpu_torch.latency import dominant_stage, stage_summary  # noqa: E402
from multiverso_tpu_torch.ops.introspect import OpsClient  # noqa: E402

_STAGE_ORDER = ("queue", "wire_out", "mailbox", "apply", "reactor",
                "wire_back")
_QUANTILES = ("p50_ms", "p95_ms", "p99_ms")

# A class whose deadline sheds reach this fraction of its admits has a
# tail the stage table cannot explain: the slow requests were DROPPED,
# never measured — the note below says so (docs/serving.md "tail").
_DEADLINE_DOMINANCE = 0.05


def deadline_note(report: dict):
    """One-line warning when deadline sheds dominate a class's tail,
    or None.  A shed request produces NO reply trail, so a class
    shedding 5%+ of its admitted reads has a p99 that reflects only the
    SURVIVORS — the real tail is in serve.deadline.shed, not the stage
    histograms."""
    q = report.get("qos") or {}
    worst = None
    for c in q.get("classes") or []:
        sheds = c.get("deadline_sheds", 0) or 0
        admits = max(1, c.get("admits", 0) or 0)
        if sheds and sheds / admits >= _DEADLINE_DOMINANCE:
            if worst is None or sheds > worst[1]:
                worst = (c.get("name", "?"), sheds, admits)
    if worst is None:
        return None
    name, sheds, admits = worst
    return (f"note: deadline sheds dominate class '{name}' "
            f"({sheds} shed vs {admits} admitted) — its p99 reflects "
            f"only surviving reads; the dropped tail never reports a "
            f"trail.  Raise the caller budget or shed earlier at the "
            f"reactor.")


def render_rank(rank: str, report: dict) -> str:
    """Human-readable per-rank breakdown (one string, many lines)."""
    out = [f"rank {rank} (timing "
           f"{'armed' if report.get('armed') else 'DISARMED'})"]
    summary = stage_summary(report)
    if not summary:
        out.append("  no stage samples yet")
        return "\n".join(out)
    ordered = [s for s in _STAGE_ORDER if s in summary]
    ordered += sorted(set(summary) - set(ordered) - {"total"})
    width = max(len(s) for s in ordered + ["total"])
    out.append(f"  {'stage'.ljust(width)}  {'p50':>9} {'p95':>9} "
               f"{'p99':>9} {'count':>7}")
    for name in ordered:
        st = summary[name]
        out.append(f"  {name.ljust(width)}  "
                   f"{st['p50_ms']:>7.3f}ms {st['p95_ms']:>7.3f}ms "
                   f"{st['p99_ms']:>7.3f}ms {int(st['count']):>7}")
    total = summary.get("total")
    if total:
        out.append(f"  {'total'.ljust(width)}  "
                   f"{total['p50_ms']:>7.3f}ms {total['p95_ms']:>7.3f}ms "
                   f"{total['p99_ms']:>7.3f}ms {int(total['count']):>7}")
        for q in _QUANTILES:
            ssum = sum(summary[s][q] for s in ordered)
            if total[q] > 0:
                out.append(
                    f"  stage sum @ {q[:-3]}: {ssum:.3f}ms "
                    f"({ssum / total[q] * 100.0:.0f}% of e2e "
                    f"{total[q]:.3f}ms)")
    for q in _QUANTILES:
        dom = dominant_stage(report, q)
        if dom:
            v = summary[dom][q]
            out.append(f"  dominant {q[:-3]} stage = {dom} "
                       f"({v:.3f} ms)")
    ex = (report.get("stages") or {}).get(
        dominant_stage(report, "p99_ms") or "", {}).get("exemplar_p99")
    if ex:
        out.append(f"  p99 exemplar trace id: {ex} "
                   f"(resolve in the merged Chrome trace)")
    for off in report.get("offsets") or []:
        out.append(f"  clock offset vs rank {off['rank']}: "
                   f"{off['offset_ns'] / 1e3:.1f} us "
                   f"(rtt {off['rtt_ns'] / 1e3:.1f} us, "
                   f"{off['samples']} samples)")
    prof = report.get("profiler") or {}
    out.append(f"  profiler: "
               f"{'running' if prof.get('running') else 'stopped'} "
               f"hz={prof.get('hz', 0)} "
               f"samples={prof.get('samples', 0)}")
    note = deadline_note(report)
    if note:
        out.append("  " + note)
    return "\n".join(out)


def collect(endpoint: str, fleet: bool, timeout: float) -> dict:
    """``{rank: report}`` — fleet scope unwraps the merge envelope."""
    with OpsClient(endpoint, timeout=timeout) as c:
        doc = c.latency(fleet=fleet)
    if not fleet:
        return {str(doc.get("rank", "?")): doc}
    out = {}
    for rank, rep in sorted((doc.get("ranks") or {}).items(), key=str):
        if rep is None:
            out[str(rank)] = {"armed": False, "stages": {},
                              "silent": True}
        else:
            out[str(rank)] = rep
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("endpoints", nargs="+", metavar="HOST:PORT")
    ap.add_argument("--fleet", action="store_true",
                    help="ask the first endpoint to aggregate the whole "
                         "fleet server-side")
    ap.add_argument("--json", action="store_true",
                    help="print the raw report JSON instead of the table")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    if args.json:
        with OpsClient(args.endpoints[0], timeout=args.timeout) as c:
            print(json.dumps(c.latency(fleet=args.fleet), indent=2))  # mvlint: MV006-exempt(CLI output)
        return 0
    ranks = {}
    if args.fleet:
        ranks = collect(args.endpoints[0], fleet=True,
                        timeout=args.timeout)
    else:
        for ep in args.endpoints:
            try:
                ranks.update(collect(ep, fleet=False,
                                     timeout=args.timeout))
            except (ConnectionError, OSError, TimeoutError) as exc:
                print(f"rank @ {ep}: unreachable ({exc})")  # mvlint: MV006-exempt(CLI output)
    for rank, rep in ranks.items():
        if rep.get("silent"):
            print(f"rank {rank}: SILENT (no report inside the fleet "  # mvlint: MV006-exempt(CLI output)
                  f"deadline)")
            continue
        print(render_rank(rank, rep))  # mvlint: MV006-exempt(CLI output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
