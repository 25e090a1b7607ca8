#include "mvtpu/capacity.h"

#include <dirent.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <sstream>

#include "mvtpu/configure.h"
#include "mvtpu/mutex.h"

namespace mvtpu {
namespace capacity {

namespace {

// Armed by default (the `-capacity_enabled` flag default); Zoo::Start
// latches the flag value, MV_SetCapacityTracking toggles live.
std::atomic<bool> g_armed{true};

int64_t SteadyNowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Module-load anchor for the uptime field (steady clock: a stepped
// wall clock must not produce negative uptimes).
const int64_t g_start_ms = SteadyNowMs();

Mutex g_gauge_mu;
// std::map: deterministic JSON ordering for canned-scrape tests.
// capacity: the registry itself is bounded by the (static) set of
// registering subsystems — a handful of names, never per-key.
std::map<std::string, GaugeFn> g_gauges GUARDED_BY(g_gauge_mu);

struct Window {
  int64_t ts_ms = 0;
  int64_t gets = 0;
  int64_t adds = 0;
  int64_t bytes = 0;
  int64_t bucket_load[kLoadBuckets] = {0};
};

Mutex g_hist_mu;
// capacity: bounded by construction — kHistoryWindows windows per live
// table id; table ids are a registry, never per-key.
std::map<int32_t, std::deque<Window>> g_history GUARDED_BY(g_hist_mu);
int64_t g_last_window_ms GUARDED_BY(g_hist_mu) = -1;

std::string FmtDouble(double v) {
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%.9g", v);
  return buf;
}

}  // namespace

bool Armed() { return g_armed.load(std::memory_order_relaxed); }
void Arm(bool on) { g_armed.store(on, std::memory_order_relaxed); }

void RegisterGauge(const std::string& name, GaugeFn fn) {
  MutexLock lk(g_gauge_mu);
  g_gauges[name] = std::move(fn);
}

void UnregisterGauge(const std::string& name) {
  MutexLock lk(g_gauge_mu);
  g_gauges.erase(name);
}

std::string GaugesJson() {
  // Snapshot the callbacks under the lock, RUN them outside it: a
  // gauge that takes its subsystem's lock (arena, write queues) must
  // never nest inside the registry mutex.
  std::vector<std::pair<std::string, GaugeFn>> snap;
  {
    MutexLock lk(g_gauge_mu);
    for (const auto& kv : g_gauges) snap.push_back(kv);
  }
  std::ostringstream os;
  os << "{";
  bool first = true;
  for (const auto& kv : snap) {
    long long v = kv.second ? kv.second() : 0;
    if (!first) os << ',';
    first = false;
    os << "\"" << kv.first << "\":" << v;
  }
  os << "}";
  return os.str();
}

ProcStats Proc() {
  ProcStats st;
  st.uptime_s =
      static_cast<double>(SteadyNowMs() - g_start_ms) / 1e3;
  // VmRSS / VmHWM from /proc/self/status (kB lines); best-effort —
  // non-Linux hosts report -1 and the JSON still parses.
  if (std::FILE* fp = std::fopen("/proc/self/status", "r")) {
    char line[256];
    while (std::fgets(line, sizeof(line), fp)) {
      long long kb = 0;
      if (std::sscanf(line, "VmRSS: %lld kB", &kb) == 1)
        st.rss_bytes = kb * 1024;
      else if (std::sscanf(line, "VmHWM: %lld kB", &kb) == 1)
        st.vm_hwm_bytes = kb * 1024;
    }
    std::fclose(fp);
  }
  if (DIR* d = ::opendir("/proc/self/fd")) {
    long long n = 0;
    while (::readdir(d)) ++n;
    ::closedir(d);
    st.open_fds = n - 3;  // ".", "..", and the opendir fd itself
  }
  return st;
}

std::string ProcJson() {
  ProcStats st = Proc();
  std::ostringstream os;
  os << "{\"rss_bytes\":" << st.rss_bytes
     << ",\"vm_hwm_bytes\":" << st.vm_hwm_bytes
     << ",\"open_fds\":" << st.open_fds
     << ",\"uptime_s\":" << FmtDouble(st.uptime_s) << "}";
  return os.str();
}

bool HistoryDue() {
  int64_t interval = configure::Has("capacity_history_ms")
                         ? configure::GetInt("capacity_history_ms")
                         : 250;
  int64_t now = SteadyNowMs();
  MutexLock lk(g_hist_mu);
  if (g_last_window_ms >= 0 && now - g_last_window_ms < interval)
    return false;
  g_last_window_ms = now;
  return true;
}

void RecordHistory(int32_t table_id, int64_t gets, int64_t adds,
                   int64_t bytes, const int64_t* bucket_load) {
  Window w;
  w.ts_ms = SteadyNowMs();
  w.gets = gets;
  w.adds = adds;
  w.bytes = bytes;
  if (bucket_load)
    std::memcpy(w.bucket_load, bucket_load,
                sizeof(int64_t) * kLoadBuckets);
  MutexLock lk(g_hist_mu);
  auto& ring = g_history[table_id];
  ring.push_back(w);
  while (ring.size() > static_cast<size_t>(kHistoryWindows))
    ring.pop_front();
}

std::string HistoryJson(int32_t table_id) {
  // Render from a snapshot copy so the emitter never holds g_hist_mu.
  std::deque<Window> snap;
  {
    MutexLock lk(g_hist_mu);
    auto it = g_history.find(table_id);
    if (it != g_history.end()) snap = it->second;
  }
  const std::deque<Window>& ring = snap;
  std::ostringstream os;
  os << "{\"windows\":" << ring.size();
  if (ring.size() >= 2) {
    const Window& a = ring.front();
    const Window& b = ring.back();
    double span_s =
        static_cast<double>(b.ts_ms - a.ts_ms) / 1e3;
    os << ",\"span_ms\":" << (b.ts_ms - a.ts_ms);
    if (span_s > 0) {
      auto rate = [&](int64_t hi, int64_t lo) {
        double d = static_cast<double>(hi - lo) / span_s;
        return d > 0 ? d : 0.0;  // a counter reset reads 0, not < 0
      };
      os << ",\"get_rate\":" << FmtDouble(rate(b.gets, a.gets));
      os << ",\"add_rate\":" << FmtDouble(rate(b.adds, a.adds));
      os << ",\"bytes_rate\":" << FmtDouble(rate(b.bytes, a.bytes));
      os << ",\"bucket_rate\":[";
      for (int i = 0; i < kLoadBuckets; ++i) {
        if (i) os << ',';
        os << FmtDouble(rate(b.bucket_load[i], a.bucket_load[i]));
      }
      os << "]";
    }
  }
  os << ",\"curve\":[";
  for (size_t i = 0; i < ring.size(); ++i) {
    if (i) os << ',';
    os << "{\"ts_ms\":" << ring[i].ts_ms << ",\"gets\":" << ring[i].gets
       << ",\"adds\":" << ring[i].adds << ",\"bytes\":" << ring[i].bytes
       << "}";
  }
  os << "]}";
  return os.str();
}

void ResetHistory() {
  MutexLock lk(g_hist_mu);
  g_history.clear();
  g_last_window_ms = -1;
}

}  // namespace capacity
}  // namespace mvtpu
