// Dashboard — named accumulating monitors (per-op latency counters),
// dumped at shutdown. Capability parity with include/multiverso/dashboard.h
// (SURVEY.md §2.26), extended for the observability layer
// (docs/observability.md):
//
// - every monitor keeps fixed log2 latency buckets (1 µs .. ~67 s) so the
//   Python metrics registry can reconstruct p50/p95/p99 from one
//   MV_DumpMonitors() call instead of name-by-name MV_QueryMonitor;
// - when tracing is enabled, each Monitor also records a SPAN (wall-clock
//   start + duration) tagged with a trace id.  The id lives in a
//   thread-local: a worker-side op generates one, stamps it into the
//   request message header, and the server actor adopts it before
//   ProcessGet/ProcessAdd — so a worker Get and its server-side apply
//   (and the wire Send that carried it) share one trace id across ranks.
#pragma once

#include <chrono>
#include <cstdint>
#include <string>

namespace mvtpu {

// Bucket i holds values <= 1e-6 * 2^i seconds (i in [0, kNumBuckets-2]);
// the last bucket is the +inf overflow.  The Python side mirrors these
// bounds (multiverso_tpu_torch/metrics.py NATIVE_TIME_BUCKETS) — the two lists
// MUST stay identical or bridged percentiles silently skew.
constexpr int kDashboardBuckets = 28;

class Dashboard {
 public:
  // Records into the monitor's bucket AND, when this thread carries a
  // trace id, stamps that id as the bucket's EXEMPLAR — the last trace
  // that landed there, so a p99 bucket links straight to the span
  // timeline that explains it (docs/observability.md).
  static void Record(const std::string& name, double seconds);
  static std::string Report();
  static void Reset();
  // count/total for one monitor (testing/introspection).
  static bool Query(const std::string& name, long long* count, double* total);
  // Every monitor in one pass (MV_DumpMonitors): one line per stat,
  //   name\tcount\ttotal\tmax\tb0,b1,...,b27\te0,e1,...,e27\n
  // The trailing exemplar field (last trace id per bucket, 0 = none) is
  // OPTIONAL on the parse side — pre-exemplar consumers read 4 fields.
  static std::string Dump();

  // ---- tracing (spans) -------------------------------------------------
  static void SetTraceEnabled(bool on);
  static bool TraceEnabled();
  // Rank salt for NewTraceId + the pid column of DumpSpans (set by
  // Zoo::Start so ids never collide across ranks).
  static void SetTraceRank(int rank);
  // Thread-local trace id: 0 = none.  Worker ops own a fresh id for the
  // op's duration; the server actor adopts the one riding the message.
  static void SetThreadTraceId(int64_t id);
  static int64_t ThreadTraceId();
  static int64_t NewTraceId();
  static void RecordSpan(const std::string& name, int64_t trace_id,
                         int64_t ts_us, int64_t dur_us);
  // One line per span: name\ttrace_id\tts_us\tdur_us\trank\ttid\n
  // (ts is wall-clock µs so per-rank dumps merge on one timeline).
  static std::string DumpSpans();
  static void ClearSpans();
};

// RAII timer: MONITOR-macro equivalent.  With tracing on it also emits a
// span; `trace_id` pins the span to a specific id (e.g. the one riding a
// wire message) — 0 uses/creates the thread-local id.
class Monitor {
 public:
  explicit Monitor(std::string name, int64_t trace_id = 0);
  ~Monitor();

 private:
  std::string name_;
  std::chrono::steady_clock::time_point start_;
  int64_t trace_id_ = 0;     // span id (0 = tracing off at ctor)
  int64_t wall_us_ = 0;      // span start, wall-clock µs
  bool own_thread_id_ = false;
};

}  // namespace mvtpu
