#include "mvtpu/repl.h"

#include <atomic>

namespace mvtpu {
namespace repl {

namespace {
std::atomic<bool> g_armed{false};
std::atomic<bool> g_sync{true};
std::atomic<long long> g_forwards{0};
std::atomic<long long> g_acks{0};
std::atomic<long long> g_applied{0};
std::atomic<long long> g_parked{0};
std::atomic<long long> g_lag_waits{0};
std::atomic<long long> g_snapshots{0};
std::atomic<long long> g_catchups{0};
std::atomic<long long> g_promotions{0};
std::atomic<long long> g_epoch_flips{0};
std::atomic<long long> g_dup_skips{0};
}  // namespace

void Arm(bool on) { g_armed.store(on, std::memory_order_release); }
bool Armed() { return g_armed.load(std::memory_order_relaxed); }
void ArmSync(bool on) { g_sync.store(on, std::memory_order_release); }
bool Sync() { return g_sync.load(std::memory_order_relaxed); }

Stats GetStats() {
  Stats s;
  s.forwards = g_forwards.load(std::memory_order_relaxed);
  s.acks = g_acks.load(std::memory_order_relaxed);
  s.applied = g_applied.load(std::memory_order_relaxed);
  s.parked = g_parked.load(std::memory_order_relaxed);
  s.lag_waits = g_lag_waits.load(std::memory_order_relaxed);
  s.snapshots = g_snapshots.load(std::memory_order_relaxed);
  s.catchups = g_catchups.load(std::memory_order_relaxed);
  s.promotions = g_promotions.load(std::memory_order_relaxed);
  s.epoch_flips = g_epoch_flips.load(std::memory_order_relaxed);
  s.dup_skips = g_dup_skips.load(std::memory_order_relaxed);
  return s;
}

void NoteForward() { g_forwards.fetch_add(1, std::memory_order_relaxed); }
void NoteAck() { g_acks.fetch_add(1, std::memory_order_relaxed); }
void NoteApplied() { g_applied.fetch_add(1, std::memory_order_relaxed); }
void NoteParked() { g_parked.fetch_add(1, std::memory_order_relaxed); }
void NoteLagWait() { g_lag_waits.fetch_add(1, std::memory_order_relaxed); }
void NoteSnapshot() { g_snapshots.fetch_add(1, std::memory_order_relaxed); }
void NoteCatchup() { g_catchups.fetch_add(1, std::memory_order_relaxed); }
void NotePromotion() {
  g_promotions.fetch_add(1, std::memory_order_relaxed);
}
void NoteEpochFlip() {
  g_epoch_flips.fetch_add(1, std::memory_order_relaxed);
}
void NoteDupSkip() { g_dup_skips.fetch_add(1, std::memory_order_relaxed); }

void ResetStats() {
  g_forwards.store(0);
  g_acks.store(0);
  g_applied.store(0);
  g_parked.store(0);
  g_lag_waits.store(0);
  g_snapshots.store(0);
  g_catchups.store(0);
  g_promotions.store(0);
  g_epoch_flips.store(0);
  g_dup_skips.store(0);
}

}  // namespace repl
}  // namespace mvtpu
