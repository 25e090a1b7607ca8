// Capacity plane — fleet-wide memory & bytes accounting
// (docs/observability.md, "capacity plane").
//
// ROADMAP item 2 (load-aware placement + live migration) needs a data
// substrate before anything can move: per-bucket resident BYTES and a
// load RATE CURVE, not just lifetime op totals.  This module is that
// substrate:
//
//  - an arm latch (`-capacity_enabled`, MV_SetCapacityTracking) in the
//    workload::Armed() tradition: disarmed, every hot-path accounting
//    hook is one relaxed atomic load;
//  - a process-wide named byte-gauge registry: subsystems that hold
//    bytes outside the table shards (HostArena, epoll write queues,
//    worker replica side tables, serve caches via the Python mirror)
//    register a callback and the "capacity" ops report enumerates them;
//  - /proc/self process stats (RSS, VmHWM, open fds, uptime) for the
//    host-level rows of the health + capacity reports;
//  - a bounded per-table load HISTORY ring (kHistoryWindows == the
//    metrics.py HISTORY_SNAPSHOTS discipline): each capacity scrape at
//    least `-capacity_history_ms` after the last appends one window of
//    (ts, gets, adds, bytes, per-bucket load), so a single scrape
//    yields per-bucket RATES — the advisor's (bytes x load rate) input
//    — instead of forcing every consumer to diff two scrapes.
#pragma once

#include <cstdint>
#include <functional>
#include <string>
#include <vector>

namespace mvtpu {
namespace capacity {

// Process-global arm switch (the `-capacity_enabled` flag, latched by
// Zoo::Start; MV_SetCapacityTracking toggles live).  Disarmed, every
// incremental hot-path hook is this one relaxed load.  Construction /
// snapshot-load walks are NOT gated — they are one-time full
// recomputes, and re-arming resyncs via ServerTable::RecomputeCapacity
// so counters never stay stale once tracking is on.
bool Armed();
void Arm(bool on);

// Per-entry overhead charged for one KV hash-map entry beside its key
// and value bytes (node + bucket amortization).  Part of the
// byte-accounting CONTRACT: ground-truth walks use the same constant,
// so "within 10%" in the acceptance gate measures the incremental
// bookkeeping, not allocator trivia.
constexpr int64_t kKVEntryOverhead = 64;

// ---- named byte gauges ------------------------------------------------
// A gauge is a callback returning CURRENT bytes held; registration is
// idempotent by name (latest wins — subsystems re-register across
// restarts).  Callbacks run at scrape time on the ops thread and must
// be cheap and lock-light.
using GaugeFn = std::function<long long()>;
void RegisterGauge(const std::string& name, GaugeFn fn);
void UnregisterGauge(const std::string& name);
// {"name":bytes,...} over every registered gauge.
std::string GaugesJson();

// ---- /proc/self process stats ----------------------------------------
struct ProcStats {
  long long rss_bytes = -1;     // VmRSS
  long long vm_hwm_bytes = -1;  // peak resident (VmHWM)
  long long open_fds = -1;      // entries in /proc/self/fd
  double uptime_s = 0.0;        // since this module loaded
};
ProcStats Proc();
std::string ProcJson();  // {"rss_bytes":..,"vm_hwm_bytes":..,...}

// ---- per-table load history ring --------------------------------------
// Bounded at kHistoryWindows windows per table (the HISTORY_SNAPSHOTS
// discipline); kLoadBuckets mirrors ServerTable::kVersionBuckets (the
// table layer static_asserts the two agree).
constexpr int kHistoryWindows = 64;
constexpr int kLoadBuckets = 64;

// True when at least `-capacity_history_ms` passed since the last
// recorded window (one shared clock for every table: a scrape records
// all tables or none, so windows align across tables).  Latches the
// new timestamp when due.
bool HistoryDue();
// Append one window for `table_id` (called per table when HistoryDue).
void RecordHistory(int32_t table_id, int64_t gets, int64_t adds,
                   int64_t bytes, const int64_t* bucket_load);
// JSON for one table:
//   {"windows":n,"span_ms":t,"get_rate":r,"add_rate":r,"bytes_rate":r,
//    "bucket_rate":[64 per-second rates],
//    "curve":[{"ts_ms":..,"gets":..,"adds":..,"bytes":..},...]}
// Rates are (newest - oldest) / span over the ring; absent (rate
// fields = null-free zero-window object) with fewer than two windows —
// consumers render '-' rather than a fake 0 (the mvtop discipline).
std::string HistoryJson(int32_t table_id);
// Drop every ring + the shared clock (test isolation / re-arm).
void ResetHistory();

}  // namespace capacity
}  // namespace mvtpu
