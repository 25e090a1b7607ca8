// Ops — the live introspection plane (docs/observability.md).
//
// Three pieces, all servable IN-BAND over the existing wire (the epoll
// reactor answers MsgType::OpsQuery without touching the actor mailbox,
// so a wedged server still answers its health scrape):
//
//  - LocalReport(kind): this rank's report text.  "metrics" renders the
//    native Dashboard as Prometheus exposition (histograms with
//    per-bucket EXEMPLAR trace ids) — unless the host pushed its own
//    registry rendering (SetHostMetrics, fed by the Python metrics
//    flusher, which already bridges every native monitor), in which
//    case the pushed superset is served.  "health" and "tables" are
//    JSON built by the Zoo (queue depth vs -server_inflight_max, lease
//    state, per-table version/spread/codec/agg depth); "hotkeys" is the
//    workload plane (hot-key top-K + count-min estimates, bucket-load
//    skew, observed staleness, add-health sentinels).
//  - BuildReply(query, reply): wraps LocalReport into an OpsReply
//    message (local scope only — fleet scope is Zoo::HandleOpsQuery's
//    bounded fan-out).
//  - The flight recorder ("black box"): a bounded in-memory ring of
//    lifecycle events that BlackboxTrigger dumps — together with the
//    recent span ring and monitor totals — to
//    <trace_dir>/blackbox_rank<r>.json on failure triggers (barrier
//    timeout, dead peer, shed storm; the Python layer adds
//    CheckpointCorrupt), so the first chaos-induced failover ships with
//    a black box whose spans correlate by trace id with the surviving
//    ranks' traces.
#pragma once

#include <cstdint>
#include <string>

#include "mvtpu/message.h"

namespace mvtpu {
namespace ops {

// Host-pushed registry rendering (Prometheus text).  Empty = none; the
// Python metrics flusher pushes via MV_SetOpsHostMetrics.
void SetHostMetrics(const std::string& prom_text);

// Host-pushed alert state (JSON object text from the Python health
// evaluator, via MV_SetOpsHostAlerts each metrics flush).  Served
// verbatim under the "alerts" report's "host" key — the native side
// never parses it.  Empty = served as null.
void SetHostAlerts(const std::string& alerts_json);

// This rank's report for `kind` ("metrics" | "health" | "tables" |
// "hotkeys" | "latency" | "audit" | "replication" | "capacity" |
// "alerts" — the health plane's watchdog table + host alert state).
// Unknown kinds return a one-line JSON error instead of failing — a
// scraper probing a newer protocol must not kill the connection.
std::string LocalReport(const std::string& kind);

// Fill `reply` as the OpsReply to a LOCAL-scope `query` (kind from the
// query's first blob).  Routing fields (src/dst) are the caller's job.
void BuildReply(const Message& query, Message* reply);

// Fill `reply` as the ReplyReplica to an anonymous RequestReplica —
// the shard's hot-key top-K snapshot (docs/serving.md "tail"): a
// bounded read under the shard lock, safe from the reactor thread like
// the table-stats scrape, which is what lets a hedged read win while a
// straggling apply clogs the actor mailbox.  Routing fields (src/dst)
// are the caller's job; a table with no local shard answers empty.
void BuildReplicaReply(const Message& query, Message* reply);

// Prometheus-sanitized metric name (mirrors metrics.py _prom_name).
std::string PromName(const std::string& name);

// ---- flight recorder -------------------------------------------------
// Bounded event ring (capacity: the -blackbox_events flag); recording
// is always on and costs one small lock — the ring IS the black box.
void BlackboxEvent(const std::string& kind, const std::string& detail);
// Dump ring + recent spans + monitor totals to
// <trace_dir>/blackbox_rank<r>.json (the -trace_dir flag; no-op without
// it, the event still lands in the ring).  Returns the path written, or
// "" when no dump happened.  Re-triggering overwrites (last failure
// wins — each dump carries every ring event before it anyway).
std::string BlackboxTrigger(const std::string& reason);
// Triggers fired so far (testing).
long long BlackboxTriggerCount();
// Test isolation: drop ring + counters + pushed host metrics.
void BlackboxReset();

}  // namespace ops
}  // namespace mvtpu
