// Workload sketches — bounded-memory hot-key accounting for the server
// hot path (docs/observability.md, "workload plane").
//
// Multiverso's native workloads (word embedding, LightLDA, recommender
// serving) are huge sparse tables under heavily skewed access.  The
// systems plane can say how LONG an apply took; nothing said
// WHICH keys were hot.  These two classic sketches answer that in O(1)
// per touched key with memory bounded by construction:
//
//  - SpaceSaving (Metwally et al. 2005): top-K heavy hitters.  K
//    counters; an unmonitored key evicts the minimum counter and
//    inherits its count as `error` — every true heavy hitter with
//    frequency > N/K is guaranteed to be monitored, and
//    count - error <= true <= count.
//  - CountMin (Cormode & Muthukrishnan 2005): depth x width counter
//    array, per-row hashes; Estimate() = min over rows.  Never
//    underestimates; overestimates by at most eps * N with probability
//    1 - delta for width = e/eps, depth = ln(1/delta).  Answers "how
//    hot is ARBITRARY key k", including keys SpaceSaving evicted.
//
// HotKeyTracker combines both per server table, armed by the
// `-hotkey_enabled` flag (mirrored into one process-global atomic so a
// disarmed ProcessGet/ProcessAdd pays exactly one relaxed load).
#pragma once

#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "mvtpu/mutex.h"

namespace mvtpu {
namespace workload {

// Process-global arm switch (the `-hotkey_enabled` flag, latched by
// Zoo::Start and togglable at runtime via MV_SetHotKeyTracking for
// armed-vs-disarmed A/B measurement).  Disarmed, every accounting hook
// compiles down to this one relaxed atomic load.
bool Armed();
void Arm(bool on);

// Hot-key replica arm switch (docs/embedding.md): latched from
// `-hotkey_replica` at Zoo::Start, togglable live via
// MV_SetHotKeyReplica.  Disarmed, the worker GetRows replica probe is
// one relaxed atomic load (the same discipline as Armed()).
bool ReplicaArmed();
void ArmReplica(bool on);

// Stable 64-bit key hash shared with the Python mirror
// (multiverso_tpu_torch/sketch.py) so per-rank sketches merge coherently:
// FNV-1a, the same function KVHash uses for the partition contract.
uint64_t KeyHash(const void* data, size_t n);
inline uint64_t KeyHash(const std::string& s) {
  return KeyHash(s.data(), s.size());
}
inline uint64_t KeyHash(int64_t v) { return KeyHash(&v, sizeof(v)); }

// ---------------------------------------------------------------------
// SpaceSaving top-K.  NOT internally synchronized — the owning
// HotKeyTracker serializes access under its own mutex.
class SpaceSaving {
 public:
  explicit SpaceSaving(int k);

  struct Entry {
    std::string label;   // human-readable key (row id / KV key)
    uint64_t hash = 0;
    int64_t count = 0;   // upper bound on the true frequency
    int64_t error = 0;   // inherited overcount: true >= count - error
  };

  // O(1) expected: bump a monitored key, or evict the minimum counter
  // and inherit its count as the new key's error.
  void Offer(uint64_t hash, const std::string& label, int64_t n = 1);
  // Monitored entries, descending by count.
  std::vector<Entry> TopK() const;
  int64_t total() const { return total_; }
  int capacity() const { return k_; }
  // Fold another sketch in (fleet-scope / per-rank merges): offers every
  // entry of `other` carrying its count; errors add conservatively.
  void Merge(const SpaceSaving& other);

 private:
  int FindMin() const;
  int k_;
  int64_t total_ = 0;
  std::vector<Entry> entries_;                  // <= k_ monitored keys
  // hash -> slot in entries_ (size <= k_; evictions retarget one key).
  std::unordered_map<uint64_t, int> index_;
  int IndexOf(uint64_t hash) const;
};

// ---------------------------------------------------------------------
// CountMin.  Counter cells are relaxed atomics: Add/Estimate are
// lock-free (a torn read can only mis-estimate one sample, which the
// sketch's own eps bound already dwarfs).
class CountMin {
 public:
  explicit CountMin(int width = 1024, int depth = 4);
  CountMin(const CountMin&) = delete;
  CountMin& operator=(const CountMin&) = delete;

  void Add(uint64_t hash, int64_t n = 1);
  int64_t Estimate(uint64_t hash) const;     // min over rows; never under
  int64_t total() const {
    return total_.load(std::memory_order_relaxed);
  }
  int width() const { return width_; }
  int depth() const { return depth_; }

 private:
  uint64_t RowHash(int row, uint64_t hash) const;
  int width_, depth_;
  std::vector<std::atomic<int64_t>> cells_;   // depth_ * width_
  std::atomic<int64_t> total_{0};
};

// ---------------------------------------------------------------------
// Per-table tracker: one SpaceSaving (sized from `-hotkey_topk` at
// first armed offer) + one CountMin, behind one small mutex on the
// SpaceSaving side only.  All entry points no-op on a single atomic
// load when disarmed.
class HotKeyTracker {
 public:
  HotKeyTracker();

  // O(1): offer one touched key to both sketches.
  void Note(uint64_t hash, const std::string& label, int64_t n = 1);

  struct Item {
    std::string label;
    int64_t count;      // SpaceSaving upper bound
    int64_t error;      // SpaceSaving inherited overcount
    int64_t estimate;   // CountMin estimate for the same key
  };
  std::vector<Item> TopK() const;
  int64_t Estimate(uint64_t hash) const { return cm_.Estimate(hash); }
  int64_t total() const { return cm_.total(); }
  // JSON fragment: {"total":N,"topk":[{"key":..,"count":..,...},...]}
  std::string Json() const;

 private:
  mutable Mutex mu_;
  // Lazily sized from -hotkey_topk (flags may not be parsed when a
  // standalone table constructs the tracker).
  std::unique_ptr<SpaceSaving> ss_ GUARDED_BY(mu_);
  CountMin cm_;
};

}  // namespace workload
}  // namespace mvtpu
