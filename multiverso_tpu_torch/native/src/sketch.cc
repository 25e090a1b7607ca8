#include "mvtpu/sketch.h"

#include <algorithm>
#include <sstream>

#include "mvtpu/configure.h"

namespace mvtpu {
namespace workload {

namespace {

// Armed by default (the `-hotkey_enabled` flag default); Zoo::Start
// re-latches from the parsed flags, MV_SetHotKeyTracking toggles live.
std::atomic<bool> g_armed{true};

// Replica disarmed by default (the `-hotkey_replica` flag default):
// serving reads from a side table is an opt-in semantics choice, not
// free observability.
std::atomic<bool> g_replica_armed{false};

// Minimal JSON string escape for key labels (KV keys are caller data).
std::string JsonEscape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) out += ' ';
        else out += c;
    }
  }
  return out;
}

}  // namespace

bool Armed() { return g_armed.load(std::memory_order_relaxed); }
void Arm(bool on) { g_armed.store(on, std::memory_order_relaxed); }

bool ReplicaArmed() {
  return g_replica_armed.load(std::memory_order_relaxed);
}
void ArmReplica(bool on) {
  g_replica_armed.store(on, std::memory_order_relaxed);
}

uint64_t KeyHash(const void* data, size_t n) {
  // FNV-1a 64 — identical to table.h KVHash and the Python mirror
  // (multiverso_tpu_torch/sketch.py), so per-rank CountMin cells line up and
  // fleet merges estimate the same key the same way everywhere.
  const unsigned char* p = static_cast<const unsigned char*>(data);
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

// ------------------------------------------------------------ SpaceSaving

SpaceSaving::SpaceSaving(int k) : k_(std::max(1, k)) {
  entries_.reserve(static_cast<size_t>(k_));
}

int SpaceSaving::IndexOf(uint64_t hash) const {
  auto it = index_.find(hash);
  return it == index_.end() ? -1 : it->second;
}

int SpaceSaving::FindMin() const {
  int min_i = 0;
  for (size_t i = 1; i < entries_.size(); ++i)
    if (entries_[i].count < entries_[min_i].count)
      min_i = static_cast<int>(i);
  return min_i;
}

void SpaceSaving::Offer(uint64_t hash, const std::string& label,
                        int64_t n) {
  total_ += n;
  int slot = IndexOf(hash);
  if (slot >= 0) {
    entries_[static_cast<size_t>(slot)].count += n;
    return;
  }
  if (static_cast<int>(entries_.size()) < k_) {
    entries_.push_back(Entry{label, hash, n, 0});
    index_.emplace(hash, static_cast<int>(entries_.size()) - 1);
    return;
  }
  // Evict the minimum counter: the newcomer inherits its count as
  // `error` — the classic space-saving guarantee that any key with
  // true frequency > total/K is monitored.
  int min_i = FindMin();
  Entry& e = entries_[static_cast<size_t>(min_i)];
  index_.erase(e.hash);
  e.error = e.count;       // everything below could belong to the evictee
  e.count += n;
  e.hash = hash;
  e.label = label;
  index_.emplace(hash, min_i);
}

std::vector<SpaceSaving::Entry> SpaceSaving::TopK() const {
  std::vector<Entry> out = entries_;
  std::sort(out.begin(), out.end(),
            [](const Entry& a, const Entry& b) { return a.count > b.count; });
  return out;
}

void SpaceSaving::Merge(const SpaceSaving& other) {
  for (const auto& e : other.entries_) {
    int slot = IndexOf(e.hash);
    if (slot >= 0) {
      entries_[static_cast<size_t>(slot)].count += e.count;
      entries_[static_cast<size_t>(slot)].error += e.error;
      total_ += e.count;
      continue;
    }
    Offer(e.hash, e.label, e.count);
    int now = IndexOf(e.hash);
    if (now >= 0)
      entries_[static_cast<size_t>(now)].error += e.error;
  }
}

// --------------------------------------------------------------- CountMin

CountMin::CountMin(int width, int depth)
    : width_(std::max(8, width)), depth_(std::max(1, depth)),
      cells_(static_cast<size_t>(width_) * static_cast<size_t>(depth_)) {
  for (auto& c : cells_) c.store(0, std::memory_order_relaxed);
}

uint64_t CountMin::RowHash(int row, uint64_t hash) const {
  // Distinct per-row hash families via a splitmix64 finalize of
  // (hash ^ row-salt) — cheap and well-mixed.
  uint64_t x = hash ^ (0x9e3779b97f4a7c15ull *
                       static_cast<uint64_t>(row + 1));
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ull;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebull;
  x ^= x >> 31;
  return x;
}

void CountMin::Add(uint64_t hash, int64_t n) {
  for (int r = 0; r < depth_; ++r) {
    size_t cell = static_cast<size_t>(r) * static_cast<size_t>(width_) +
                  RowHash(r, hash) % static_cast<uint64_t>(width_);
    cells_[cell].fetch_add(n, std::memory_order_relaxed);
  }
  total_.fetch_add(n, std::memory_order_relaxed);
}

int64_t CountMin::Estimate(uint64_t hash) const {
  int64_t est = INT64_MAX;
  for (int r = 0; r < depth_; ++r) {
    size_t cell = static_cast<size_t>(r) * static_cast<size_t>(width_) +
                  RowHash(r, hash) % static_cast<uint64_t>(width_);
    est = std::min(est, cells_[cell].load(std::memory_order_relaxed));
  }
  return est == INT64_MAX ? 0 : est;
}

// ----------------------------------------------------------- HotKeyTracker

HotKeyTracker::HotKeyTracker() = default;

void HotKeyTracker::Note(uint64_t hash, const std::string& label,
                         int64_t n) {
  if (!Armed()) return;
  cm_.Add(hash, n);
  MutexLock lk(mu_);
  if (!ss_) {
    int k = static_cast<int>(
        configure::Has("hotkey_topk") ? configure::GetInt("hotkey_topk")
                                      : 16);
    ss_ = std::make_unique<SpaceSaving>(k);
  }
  ss_->Offer(hash, label, n);
}

std::vector<HotKeyTracker::Item> HotKeyTracker::TopK() const {
  std::vector<Item> out;
  MutexLock lk(mu_);
  if (!ss_) return out;
  for (const auto& e : ss_->TopK())
    out.push_back(Item{e.label, e.count, e.error, cm_.Estimate(e.hash)});
  return out;
}

std::string HotKeyTracker::Json() const {
  std::ostringstream os;
  os << "{\"total\":" << total() << ",\"topk\":[";
  bool first = true;
  for (const auto& it : TopK()) {
    if (!first) os << ',';
    first = false;
    os << "{\"key\":\"" << JsonEscape(it.label) << "\",\"count\":"
       << it.count << ",\"error\":" << it.error << ",\"estimate\":"
       << it.estimate << "}";
  }
  os << "]}";
  return os.str();
}

}  // namespace workload
}  // namespace mvtpu
