// Stall watchdog (mvtpu/watchdog.h) — progress counters + a low-rate
// checker that turns "alive process, dead loop" into a blackbox dump.
#include "mvtpu/watchdog.h"

#include <atomic>
#include <chrono>
#include <cstdio>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

#include "mvtpu/dashboard.h"
#include "mvtpu/mutex.h"
#include "mvtpu/ops.h"
#include "mvtpu/profiler.h"

namespace mvtpu {
namespace watchdog {

namespace {

using Clock = std::chrono::steady_clock;

struct Loop {
  std::string name;
  std::atomic<long long> progress{0};
  std::atomic<long long> queued{0};
  std::atomic<long long> stalls{0};
  std::atomic<bool> stalled{false};
  // Checker-thread-local bookkeeping (only the checker reads/writes):
  long long seen_progress = 0;
  Clock::time_point seen_at{};
};

// Armed state on the hot path is ONE relaxed load — a disarmed
// watchdog (the default) costs nothing measurable anywhere.
std::atomic<int> g_stall_ms{0};

Mutex g_mu;
// Loops register once and live until Reset(); unique_ptr keeps the
// Loop address stable across map rehashes so the atomics stay valid
// outside the lock.
std::unordered_map<std::string, std::unique_ptr<Loop>> g_loops
    GUARDED_BY(g_mu);
std::thread g_checker GUARDED_BY(g_mu);
std::atomic<bool> g_checker_run{false};

std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c & 0xff);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

Loop* FindOrCreate(const std::string& name) {
  MutexLock lock(g_mu);
  auto it = g_loops.find(name);
  if (it != g_loops.end()) return it->second.get();
  auto loop = std::make_unique<Loop>();
  loop->name = name;
  loop->seen_at = Clock::now();
  Loop* raw = loop.get();
  g_loops.emplace(name, std::move(loop));
  return raw;
}

struct Stall {
  std::string loop;
  long long age_ms;
  long long queued;
};

// One checker pass: flag every loop with queued work and zero progress
// past the deadline.  Stalls are COLLECTED under the map lock and
// fired after it drops — BlackboxTrigger/DumpFolded take their own
// locks and must never nest inside g_mu.
void CheckOnce(int stall_ms) {
  std::vector<Stall> fired;
  Clock::time_point now = Clock::now();
  {
    MutexLock lock(g_mu);
    for (auto& kv : g_loops) {
      Loop* l = kv.second.get();
      long long progress = l->progress.load(std::memory_order_relaxed);
      if (progress != l->seen_progress) {
        l->seen_progress = progress;
        l->seen_at = now;
        l->stalled.store(false, std::memory_order_relaxed);
        continue;
      }
      long long queued = l->queued.load(std::memory_order_relaxed);
      long long age_ms = std::chrono::duration_cast<
          std::chrono::milliseconds>(now - l->seen_at).count();
      if (queued > 0 && age_ms >= static_cast<long long>(stall_ms) &&
          !l->stalled.load(std::memory_order_relaxed)) {
        l->stalled.store(true, std::memory_order_relaxed);
        l->stalls.fetch_add(1, std::memory_order_relaxed);
        fired.push_back(Stall{l->name, age_ms, queued});
      }
    }
  }
  for (const Stall& s : fired) {
    Dashboard::Record("watchdog.stalls", 0.0);
    char buf[256];
    std::snprintf(buf, sizeof(buf),
                  "stall: %s no progress for %lldms, queue=%lld",
                  s.loop.c_str(), s.age_ms, s.queued);
    ops::BlackboxEvent("watchdog_stall", buf);
    // The folded stacks name WHERE the loop is stuck; with the
    // profiler disarmed this is just an empty dump, still cheap.
    ops::BlackboxEvent("watchdog_stacks", profiler::DumpFolded());
    ops::BlackboxTrigger(buf);
  }
}

void CheckerLoop(int stall_ms) {
  int period_ms = stall_ms / 4;
  if (period_ms < 10) period_ms = 10;
  if (period_ms > 1000) period_ms = 1000;
  while (g_checker_run.load(std::memory_order_acquire)) {
    std::this_thread::sleep_for(std::chrono::milliseconds(period_ms));
    if (!g_checker_run.load(std::memory_order_acquire)) break;
    CheckOnce(stall_ms);
  }
}

void StopChecker() {
  std::thread joinme;
  {
    MutexLock lock(g_mu);
    g_checker_run.store(false, std::memory_order_release);
    joinme = std::move(g_checker);
  }
  if (joinme.joinable()) joinme.join();
}

}  // namespace

void Arm(int stall_ms) {
  StopChecker();
  if (stall_ms <= 0) {
    g_stall_ms.store(0, std::memory_order_release);
    return;
  }
  g_stall_ms.store(stall_ms, std::memory_order_release);
  MutexLock lock(g_mu);
  // Re-baseline every loop so a pre-arm quiet period never reads as an
  // instant stall.
  Clock::time_point now = Clock::now();
  for (auto& kv : g_loops) {
    Loop* l = kv.second.get();
    l->seen_progress = l->progress.load(std::memory_order_relaxed);
    l->seen_at = now;
    l->stalled.store(false, std::memory_order_relaxed);
  }
  g_checker_run.store(true, std::memory_order_release);
  g_checker = std::thread(CheckerLoop, stall_ms);
}

bool Armed() {
  return g_stall_ms.load(std::memory_order_relaxed) > 0;
}

void Bump(const std::string& loop) {
  if (!Armed()) return;
  FindOrCreate(loop)->progress.fetch_add(1, std::memory_order_relaxed);
}

void Busy(const std::string& loop, long long queued) {
  if (!Armed()) return;
  FindOrCreate(loop)->queued.store(queued, std::memory_order_relaxed);
}

std::string StatsJson() {
  Clock::time_point now = Clock::now();
  std::string out = "[";
  MutexLock lock(g_mu);
  bool first = true;
  for (auto& kv : g_loops) {
    Loop* l = kv.second.get();
    long long age_ms = std::chrono::duration_cast<
        std::chrono::milliseconds>(now - l->seen_at).count();
    bool stalled = l->stalled.load(std::memory_order_relaxed);
    char buf[320];
    std::snprintf(
        buf, sizeof(buf),
        "%s{\"loop\":\"%s\",\"progress\":%lld,\"queued\":%lld,"
        "\"stalls\":%lld,\"stalled\":%s,\"age_s\":%.3f,"
        "\"stalled_s\":%.3f}",
        first ? "" : ",", JsonEscape(l->name).c_str(),
        l->progress.load(std::memory_order_relaxed),
        l->queued.load(std::memory_order_relaxed),
        l->stalls.load(std::memory_order_relaxed),
        stalled ? "true" : "false",
        static_cast<double>(age_ms) / 1e3,
        stalled ? static_cast<double>(age_ms) / 1e3 : 0.0);
    out += buf;
    first = false;
  }
  out += "]";
  return out;
}

long long StallCount() {
  MutexLock lock(g_mu);
  long long total = 0;
  for (auto& kv : g_loops)
    total += kv.second->stalls.load(std::memory_order_relaxed);
  return total;
}

void Reset() {
  StopChecker();
  g_stall_ms.store(0, std::memory_order_release);
  MutexLock lock(g_mu);
  g_loops.clear();
}

}  // namespace watchdog
}  // namespace mvtpu
