#!/usr/bin/env python
"""mvplan — the dry-run placement advisor (docs/observability.md,
"capacity plane"; ROADMAP item 2's input shape).

Ingests a fleet ``"capacity"`` scrape (live endpoint or a saved JSON
file), aggregates per-(table, bucket) resident BYTES and load RATE
across every server rank, and greedy-bin-packs the 64 version buckets
of each table onto the fleet's shards by ``bytes x load-rate`` weight.
The output is a VERSIONED dry-run proposal — a JSON diff against the
current placement (bucket ``b`` lives wherever its bytes currently
reside; the degenerate seed map is ``b % shards``): which buckets move
where, and the projected per-shard byte/load spread before vs after.
No data moves; this is exactly the map format item 2's migration
protocol will consume (copy at snapshot version → forward deltas →
flip the map entry).

Usage::

    python tools/mvplan.py HOST:PORT [--fleet]       # live scrape
    python tools/mvplan.py --scrape capacity.json    # saved fleet doc
    python tools/mvplan.py ... --out proposal.json   # write the plan
    python tools/mvplan.py ... --strict --max-spread 2.0

``--strict`` exits 1 when the OBSERVED (before) spread of any table
exceeds ``--max-spread`` — the "this fleet needs a rebalance" alarm a
cron job can sit on.  Exit codes: 0 ok, 1 strict violation, 2 unusable
input.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROPOSAL_VERSION = 1
NBUCKETS = 64


def aggregate_fleet(doc: dict) -> dict:
    """Fold a fleet capacity doc into per-table bucket totals.

    Returns ``{table_id: {"shards": n, "bytes": [64], "load": [64],
    "rate": [64] | None, "shard_bytes": {server_id: bytes},
    "shard_load": {server_id: load}}`` — bytes/load summed across every
    rank holding a shard of the table; ``rate`` is the history-ring
    per-bucket rate when at least one rank recorded two windows
    (``None`` otherwise — consumers fall back to lifetime load, never
    a fake zero curve)."""
    ranks = doc.get("ranks")
    if ranks is None:  # a local-scope report: treat as a 1-rank fleet
        ranks = {str(doc.get("rank", 0)): doc}
    tables: dict = {}
    for rank_doc in ranks.values():
        if not rank_doc:
            continue
        sid = rank_doc.get("server_id", -1)
        for t in rank_doc.get("tables") or []:
            shard = t.get("shard")
            if not shard:
                continue
            tid = t.get("id")
            agg = tables.setdefault(tid, {
                "shards": 0, "bytes": [0] * NBUCKETS,
                "load": [0] * NBUCKETS, "rate": None,
                "shard_bytes": {}, "shard_load": {}})
            agg["shards"] = max(agg["shards"],
                                rank_doc.get("servers", 0) or 0)
            bb = shard.get("bucket_bytes") or [0] * NBUCKETS
            bg = shard.get("bucket_gets") or [0] * NBUCKETS
            ba = shard.get("bucket_adds") or [0] * NBUCKETS
            for b in range(min(NBUCKETS, len(bb))):
                agg["bytes"][b] += bb[b]
                agg["load"][b] += bg[b] + ba[b]
            if sid >= 0:
                agg["shard_bytes"][sid] = (
                    agg["shard_bytes"].get(sid, 0)
                    + shard.get("resident_bytes", 0))
                agg["shard_load"][sid] = (
                    agg["shard_load"].get(sid, 0)
                    + shard.get("gets", 0) + shard.get("adds", 0))
            hist = t.get("history") or {}
            rate = hist.get("bucket_rate")
            if rate:
                if agg["rate"] is None:
                    agg["rate"] = [0.0] * NBUCKETS
                for b in range(min(NBUCKETS, len(rate))):
                    agg["rate"][b] += rate[b]
    return tables


def bucket_weights(agg: dict) -> list:
    """Per-bucket packing weight: bytes scaled by the bucket's share of
    the load curve (history-ring rate when recorded, lifetime load
    otherwise).  A loaded bucket weighs up to 2x its bytes; an idle one
    weighs its bytes alone — so packing balances bytes first and
    tiebreaks toward spreading the hot buckets."""
    load = agg["rate"] if agg["rate"] is not None else agg["load"]
    total_load = float(sum(load)) or 1.0
    weights = []
    for b in range(NBUCKETS):
        share = float(load[b]) / total_load
        weights.append(float(agg["bytes"][b]) * (1.0 + share * NBUCKETS))
    return weights


def spread(per_shard: list) -> float:
    """max/mean imbalance over per-shard totals (1.0 = perfectly flat;
    0.0 when nothing is placed anywhere)."""
    vals = [float(v) for v in per_shard]
    mean = sum(vals) / len(vals) if vals else 0.0
    return max(vals) / mean if mean > 0 else 0.0


def current_map(agg: dict, nshards: int) -> list:
    """The observed placement: bucket b lives on the shard holding it
    today.  Contiguous row-range sharding spreads one bucket's rows
    over every shard, so the degenerate-but-faithful seed is
    ``b % nshards`` (the ``row % shards`` map the proposal diffs
    against); a KV table's hash placement matches it exactly."""
    return [b % nshards for b in range(NBUCKETS)]


def plan_table(agg: dict, nshards: int) -> dict:
    """Greedy bin-pack one table's 64 buckets onto nshards shards by
    descending weight into the lightest bin — the LPT heuristic
    (<= 4/3 OPT for makespan, far inside the 2x acceptance bar)."""
    weights = bucket_weights(agg)
    cur = current_map(agg, nshards)
    order = sorted(range(NBUCKETS), key=lambda b: -weights[b])
    assign = [0] * NBUCKETS
    bins = [0.0] * nshards
    bin_bytes = [0] * nshards
    bin_load = [0] * nshards
    load = agg["rate"] if agg["rate"] is not None else agg["load"]
    for b in order:
        tgt = min(range(nshards), key=lambda s: bins[s])
        assign[b] = tgt
        bins[tgt] += weights[b]
        bin_bytes[tgt] += agg["bytes"][b]
        bin_load[tgt] += load[b]
    cur_bytes = [0] * nshards
    cur_load = [0] * nshards
    for b in range(NBUCKETS):
        cur_bytes[cur[b]] += agg["bytes"][b]
        cur_load[cur[b]] += load[b]
    moves = [{"bucket": b, "from": cur[b], "to": assign[b],
              "bytes": agg["bytes"][b], "load": load[b]}
             for b in range(NBUCKETS) if cur[b] != assign[b]]
    return {
        "shards": nshards,
        "map": assign,
        "current_map": cur,
        "moves": moves,
        "moved_bytes": sum(m["bytes"] for m in moves),
        "spread_before": {"bytes": spread(cur_bytes),
                          "load": spread(cur_load),
                          "weight": spread(
                              [sum(weights[b] for b in range(NBUCKETS)
                                   if cur[b] == s)
                               for s in range(nshards)])},
        "spread_after": {"bytes": spread(bin_bytes),
                         "load": spread(bin_load),
                         "weight": spread(bins)},
    }


def propose(doc: dict) -> dict:
    """The full dry-run proposal over a fleet capacity doc."""
    tables = aggregate_fleet(doc)
    out = {"proposal_version": PROPOSAL_VERSION, "tables": {}}
    for tid, agg in sorted(tables.items(), key=lambda kv: str(kv[0])):
        nshards = max(int(agg["shards"]), 1)
        if sum(agg["bytes"]) <= 0:
            continue  # nothing resident: nothing to plan
        plan = plan_table(agg, nshards)
        # OBSERVED spread: what the fleet actually holds per server_id
        # today (the strict-mode alarm input) — falls back to the
        # seed-map projection when server ids were absent.
        if agg["shard_bytes"]:
            ids = sorted(agg["shard_bytes"])
            plan["observed_spread"] = {
                "bytes": spread([agg["shard_bytes"][s] for s in ids]),
                "load": spread([agg["shard_load"].get(s, 0)
                                for s in ids]),
            }
        else:
            plan["observed_spread"] = dict(plan["spread_before"])
        out["tables"][str(tid)] = plan
    return out


def max_observed_spread(proposal: dict) -> float:
    worst = 0.0
    for plan in proposal["tables"].values():
        worst = max(worst, plan["observed_spread"].get("load", 0.0),
                    plan["observed_spread"].get("bytes", 0.0))
    return worst


def _load_doc(args) -> dict:
    if args.scrape:
        with open(args.scrape) as fh:
            return json.load(fh)
    if not args.endpoint:
        raise SystemExit(2)
    from multiverso_tpu_torch.ops.introspect import OpsClient

    with OpsClient(args.endpoint, timeout=args.timeout) as c:
        return c.capacity(fleet=args.fleet)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("endpoint", nargs="?", metavar="HOST:PORT",
                    help="rank endpoint to scrape (omit with --scrape)")
    ap.add_argument("--fleet", action="store_true",
                    help="ask the endpoint for a fleet-scope scrape "
                         "(server-side fan-out; silent ranks explicit)")
    ap.add_argument("--scrape", metavar="FILE",
                    help="plan over a saved fleet capacity JSON doc "
                         "instead of a live scrape")
    ap.add_argument("--out", metavar="FILE",
                    help="write the proposal JSON here (stdout default)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 when any table's OBSERVED spread "
                         "exceeds --max-spread (the rebalance alarm)")
    ap.add_argument("--max-spread", type=float, default=2.0,
                    help="strict-mode spread bound (default 2.0)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not args.endpoint and not args.scrape:
        ap.error("need HOST:PORT or --scrape FILE")

    try:
        doc = _load_doc(args)
    except (OSError, json.JSONDecodeError, ConnectionError) as exc:
        print(f"mvplan: unusable input: {exc}", file=sys.stderr)  # mvlint: MV006-exempt(CLI output)
        return 2

    proposal = propose(doc)
    text = json.dumps(proposal, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    else:
        print(text)  # mvlint: MV006-exempt(CLI output)
    nmoves = sum(len(p["moves"]) for p in proposal["tables"].values())
    worst = max_observed_spread(proposal)
    print(f"mvplan: {len(proposal['tables'])} table(s), {nmoves} "  # mvlint: MV006-exempt(CLI output)
          f"bucket move(s) proposed; worst observed spread "
          f"{worst:.2f}x (bound {args.max_spread:.2f}x)",
          file=sys.stderr)
    if args.strict and worst > args.max_spread:
        print("mvplan: STRICT: observed spread exceeds the bound — "  # mvlint: MV006-exempt(CLI output)
              "this fleet needs the proposed rebalance",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
