#include "mvtpu/profiler.h"

#include <dlfcn.h>
#include <execinfo.h>
#include <signal.h>
#include <string.h>
#include <sys/time.h>

#include <atomic>
#include <cstdio>
#include <map>
#include <sstream>
#include <vector>

#include "mvtpu/log.h"
#include "mvtpu/mutex.h"

namespace mvtpu {
namespace profiler {

namespace {

constexpr int kMaxDepth = 32;
constexpr int kRingSlots = 8192;

struct Sample {
  void* pc[kMaxDepth];
  int depth;
};

// Preallocated ring written ONLY by the signal handler (slot claimed
// with one fetch_add); the dump side reads slots below the published
// count.  Slots are never recycled — a full ring drops new samples
// (g_dropped) until Clear(), which bounds handler work and memory.
Sample g_ring[kRingSlots];
std::atomic<int> g_next{0};
std::atomic<long long> g_samples{0};
std::atomic<long long> g_dropped{0};
std::atomic<bool> g_running{false};
std::atomic<int> g_hz{0};
bool g_handler_installed = false;
Mutex g_mu;  // Start/Stop/Dump serialization (never the handler)

void OnSigprof(int, siginfo_t*, void*) {
  // Async-signal context: no locks, no allocation.  backtrace(3) is
  // preloaded by Start() so its lazy dynamic-linker initialization
  // cannot run here.
  if (!g_running.load(std::memory_order_relaxed)) return;
  int slot = g_next.fetch_add(1, std::memory_order_relaxed);
  if (slot >= kRingSlots) {
    g_next.store(kRingSlots, std::memory_order_relaxed);
    g_dropped.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  Sample& s = g_ring[slot];
  s.depth = backtrace(s.pc, kMaxDepth);
  g_samples.fetch_add(1, std::memory_order_relaxed);
}

std::string SymbolOf(void* addr) {
  Dl_info info;
  if (dladdr(addr, &info) && info.dli_sname) return info.dli_sname;
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%p", addr);
  return buf;
}

}  // namespace

bool Start(int hz) {
  if (hz <= 0) {
    Stop();
    return true;
  }
  MutexLock lk(g_mu);
  // Pre-warm backtrace's one-time libgcc initialization (it may
  // allocate) OUTSIDE the signal handler.
  void* warm[4];
  backtrace(warm, 4);
  if (!g_handler_installed) {
    struct sigaction sa;
    memset(&sa, 0, sizeof(sa));
    sa.sa_sigaction = OnSigprof;
    sa.sa_flags = SA_RESTART | SA_SIGINFO;
    sigemptyset(&sa.sa_mask);
    if (sigaction(SIGPROF, &sa, nullptr) != 0) {
      Log::Error("profiler: sigaction(SIGPROF) failed");
      return false;
    }
    g_handler_installed = true;
  }
  g_hz.store(hz, std::memory_order_relaxed);
  g_running.store(true, std::memory_order_relaxed);
  itimerval it{};
  int64_t period_us = 1000000 / hz;
  if (period_us <= 0) period_us = 1;
  it.it_interval.tv_sec = static_cast<time_t>(period_us / 1000000);
  it.it_interval.tv_usec = static_cast<suseconds_t>(period_us % 1000000);
  it.it_value = it.it_interval;
  if (setitimer(ITIMER_PROF, &it, nullptr) != 0) {
    g_running.store(false, std::memory_order_relaxed);
    Log::Error("profiler: setitimer(ITIMER_PROF) failed");
    return false;
  }
  Log::Info("profiler: sampling at %d Hz (CPU time)", hz);
  return true;
}

void Stop() {
  MutexLock lk(g_mu);
  if (!g_running.exchange(false)) return;
  itimerval off{};
  setitimer(ITIMER_PROF, &off, nullptr);
  g_hz.store(0, std::memory_order_relaxed);
}

bool Running() { return g_running.load(std::memory_order_relaxed); }

std::string DumpFolded() {
  MutexLock lk(g_mu);
  int n = std::min(g_next.load(std::memory_order_acquire), kRingSlots);
  // Aggregate identical stacks first (by raw addresses), symbolize each
  // distinct stack once — dladdr per frame per SAMPLE would make dumps
  // quadratic on hot stacks.
  std::map<std::vector<void*>, long long> agg;
  for (int i = 0; i < n; ++i) {
    const Sample& s = g_ring[i];
    if (s.depth <= 0) continue;
    std::vector<void*> key(s.pc, s.pc + s.depth);
    ++agg[key];
  }
  std::ostringstream os;
  for (const auto& [stack, count] : agg) {
    // backtrace() returns innermost-first; folded convention wants
    // outermost-first with the leaf last.  Skip the two innermost
    // frames (the handler + the kernel trampoline) — they are the
    // profiler observing itself, never the profiled code.
    size_t skip = stack.size() > 2 ? 2 : 0;
    bool first = true;
    for (size_t i = stack.size(); i > skip; --i) {
      if (!first) os << ';';
      first = false;
      os << SymbolOf(stack[i - 1]);
    }
    os << ' ' << count << '\n';
  }
  return os.str();
}

std::string StatusJson() {
  std::ostringstream os;
  os << "{\"running\":" << (Running() ? "true" : "false")
     << ",\"hz\":" << g_hz.load(std::memory_order_relaxed)
     << ",\"samples\":" << g_samples.load(std::memory_order_relaxed)
     << ",\"dropped\":" << g_dropped.load(std::memory_order_relaxed)
     << "}";
  return os.str();
}

void Clear() {
  MutexLock lk(g_mu);
  g_next.store(0, std::memory_order_relaxed);
  g_samples.store(0, std::memory_order_relaxed);
  g_dropped.store(0, std::memory_order_relaxed);
}

}  // namespace profiler
}  // namespace mvtpu
