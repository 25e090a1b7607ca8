#include "mvtpu/dashboard.h"

#include <algorithm>
#include <atomic>
#include <functional>
#include <map>
#include <sstream>
#include <thread>
#include <vector>

#include "mvtpu/mutex.h"

namespace mvtpu {

namespace {
struct Stat {
  long long count = 0;
  double total = 0.0;
  double max = 0.0;
  long long buckets[kDashboardBuckets] = {0};
  // Per-bucket exemplar: the LAST trace id whose observation landed in
  // the bucket (0 = none yet / tracing off) — the p99-to-trace link.
  long long exemplars[kDashboardBuckets] = {0};
};

// First bucket whose upper bound (1e-6 * 2^i) holds `seconds`; the last
// bucket is +inf.  Mirrored by metrics.py NATIVE_TIME_BUCKETS.
int BucketOf(double seconds) {
  double bound = 1e-6;
  for (int i = 0; i < kDashboardBuckets - 1; ++i) {
    if (seconds <= bound) return i;
    bound *= 2.0;
  }
  return kDashboardBuckets - 1;
}

Mutex g_mu;
std::map<std::string, Stat> g_stats GUARDED_BY(g_mu);

struct Span {
  std::string name;
  int64_t trace_id;
  int64_t ts_us;
  int64_t dur_us;
  uint64_t tid;
};

// Bounded: a long tracing session must not grow the heap without limit —
// the newest spans win (old ones were presumably already dumped).
constexpr size_t kMaxSpans = 1 << 16;
Mutex g_span_mu;
std::vector<Span> g_spans GUARDED_BY(g_span_mu);
size_t g_span_next GUARDED_BY(g_span_mu) = 0;  // ring cursor once full

std::atomic<bool> g_trace_enabled{false};
std::atomic<int> g_trace_rank{0};
std::atomic<int64_t> g_trace_seq{0};
thread_local int64_t t_trace_id = 0;

uint64_t ThisThreadId() {
  return std::hash<std::thread::id>{}(std::this_thread::get_id());
}

int64_t NowWallUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}
}  // namespace

void Dashboard::Record(const std::string& name, double seconds) {
  int bucket = BucketOf(seconds);
  int64_t exemplar = t_trace_id;  // this thread's active span id (0 = none)
  MutexLock lk(g_mu);
  Stat& s = g_stats[name];
  ++s.count;
  s.total += seconds;
  s.max = std::max(s.max, seconds);
  ++s.buckets[bucket];
  if (exemplar != 0) s.exemplars[bucket] = exemplar;
}

std::string Dashboard::Report() {
  MutexLock lk(g_mu);
  std::ostringstream os;
  os << "---------------- Dashboard ----------------\n";
  for (const auto& kv : g_stats) {
    const Stat& s = kv.second;
    os << "  " << kv.first << ": count=" << s.count
       << " total=" << s.total << "s mean="
       << (s.total / static_cast<double>(s.count)) * 1e3
       << "ms max=" << s.max * 1e3 << "ms\n";
  }
  os << "--------------------------------------------";
  return os.str();
}

void Dashboard::Reset() {
  {
    MutexLock lk(g_mu);
    g_stats.clear();
  }
  ClearSpans();
}

bool Dashboard::Query(const std::string& name, long long* count,
                      double* total) {
  MutexLock lk(g_mu);
  auto it = g_stats.find(name);
  if (it == g_stats.end()) return false;
  if (count) *count = it->second.count;
  if (total) *total = it->second.total;
  return true;
}

std::string Dashboard::Dump() {
  MutexLock lk(g_mu);
  std::ostringstream os;
  for (const auto& kv : g_stats) {
    const Stat& s = kv.second;
    os << kv.first << '\t' << s.count << '\t' << s.total << '\t' << s.max
       << '\t';
    for (int i = 0; i < kDashboardBuckets; ++i) {
      if (i) os << ',';
      os << s.buckets[i];
    }
    os << '\t';
    for (int i = 0; i < kDashboardBuckets; ++i) {
      if (i) os << ',';
      os << s.exemplars[i];
    }
    os << '\n';
  }
  return os.str();
}

// ---- tracing --------------------------------------------------------------

void Dashboard::SetTraceEnabled(bool on) { g_trace_enabled = on; }
bool Dashboard::TraceEnabled() { return g_trace_enabled; }
void Dashboard::SetTraceRank(int rank) { g_trace_rank = rank; }

void Dashboard::SetThreadTraceId(int64_t id) { t_trace_id = id; }
int64_t Dashboard::ThreadTraceId() { return t_trace_id; }

int64_t Dashboard::NewTraceId() {
  // Rank salt in the high bits: two ranks can never mint the same id,
  // which is what lets merged traces correlate spans by id alone.
  return ((static_cast<int64_t>(g_trace_rank) + 1) << 40) | ++g_trace_seq;
}

void Dashboard::RecordSpan(const std::string& name, int64_t trace_id,
                           int64_t ts_us, int64_t dur_us) {
  Span sp{name, trace_id, ts_us, dur_us, ThisThreadId()};
  MutexLock lk(g_span_mu);
  if (g_spans.size() < kMaxSpans) {
    g_spans.push_back(std::move(sp));
  } else {
    g_spans[g_span_next] = std::move(sp);
    g_span_next = (g_span_next + 1) % kMaxSpans;
  }
}

std::string Dashboard::DumpSpans() {
  MutexLock lk(g_span_mu);
  std::ostringstream os;
  int rank = g_trace_rank;
  for (const auto& sp : g_spans) {
    os << sp.name << '\t' << sp.trace_id << '\t' << sp.ts_us << '\t'
       << sp.dur_us << '\t' << rank << '\t' << sp.tid << '\n';
  }
  return os.str();
}

void Dashboard::ClearSpans() {
  MutexLock lk(g_span_mu);
  g_spans.clear();
  g_span_next = 0;
}

// ---- Monitor --------------------------------------------------------------

Monitor::Monitor(std::string name, int64_t trace_id)
    : name_(std::move(name)), start_(std::chrono::steady_clock::now()) {
  if (!Dashboard::TraceEnabled()) return;
  wall_us_ = NowWallUs();
  if (trace_id != 0) {
    // Pinned id (e.g. the one riding a wire message): adopt it for the
    // span AND for nested monitors on this thread.
    trace_id_ = trace_id;
  } else if (t_trace_id != 0) {
    trace_id_ = t_trace_id;          // nested op: share the enclosing id
  } else {
    trace_id_ = Dashboard::NewTraceId();
  }
  if (t_trace_id == 0) {
    Dashboard::SetThreadTraceId(trace_id_);
    own_thread_id_ = true;           // restore on destruction
  }
}

Monitor::~Monitor() {
  auto dt = std::chrono::duration<double>(
                std::chrono::steady_clock::now() - start_).count();
  Dashboard::Record(name_, dt);
  if (trace_id_ != 0) {
    Dashboard::RecordSpan(name_, trace_id_, wall_us_,
                          static_cast<int64_t>(dt * 1e6));
    if (own_thread_id_) Dashboard::SetThreadTraceId(0);
  }
}

}  // namespace mvtpu
