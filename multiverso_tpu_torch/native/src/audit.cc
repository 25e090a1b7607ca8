#include "mvtpu/audit.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <sstream>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/ops.h"

namespace mvtpu {
namespace audit {

namespace {

std::atomic<bool> g_armed{true};

int64_t FlagOr(const char* name, int64_t dflt) {
  return configure::Has(name) ? configure::GetInt(name) : dflt;
}

int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

const char* AnomalyName(Anomaly::Kind k) {
  switch (k) {
    case Anomaly::kDup: return "dup";
    case Anomaly::kReorder: return "reorder";
    case Anomaly::kGap: return "gap";
  }
  return "?";
}

// Bound on the per-origin pending out-of-order set: a reorder window
// larger than this is already an audit_gap story, and the books must
// stay O(1) against a hostile seq stream.
constexpr size_t kMaxPendingRanges = 64;

std::atomic<uint32_t*> g_crc_table{nullptr};

const uint32_t* CrcTable() {
  uint32_t* t = g_crc_table.load(std::memory_order_acquire);
  if (t) return t;
  uint32_t* fresh = new uint32_t[256];
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    fresh[i] = c;
  }
  uint32_t* expect = nullptr;
  if (!g_crc_table.compare_exchange_strong(expect, fresh,
                                           std::memory_order_acq_rel))
    delete[] fresh;  // lost the race; the winner's table serves everyone
  return g_crc_table.load(std::memory_order_acquire);
}

}  // namespace

void Arm(bool on) { g_armed.store(on, std::memory_order_relaxed); }
bool Armed() { return g_armed.load(std::memory_order_relaxed); }

uint32_t Crc32(const void* data, size_t n, uint32_t seed) {
  const uint32_t* table = CrcTable();
  uint32_t c = seed ^ 0xffffffffu;
  const unsigned char* p = static_cast<const unsigned char*>(data);
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xffu] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// ---------------------------------------------------------- DeliveryBook

void DeliveryBook::RecordAnomaly(Anomaly::Kind kind, int origin,
                                 int64_t lo, int64_t hi) {
  size_t cap = static_cast<size_t>(
      std::max<int64_t>(8, FlagOr("audit_ring", 64)));
  Anomaly a{kind, origin, lo, hi, NowMs()};
  if (ring_.size() < cap) {
    ring_.push_back(a);
  } else {
    // Bounded ring: overwrite the oldest slot (ring_next_ wraps).
    ring_[ring_next_ % cap] = a;
  }
  ring_next_ = (ring_next_ + 1) % cap;
  ++ring_total_;
}

void DeliveryBook::NoteApply(int origin, int64_t seq_lo, int64_t seq_hi,
                             int32_t table_id) {
  if (!Armed() || seq_lo <= 0 || seq_hi < seq_lo) return;
  int64_t now_ms = NowMs();
  MutexLock lk(mu_);
  OriginState& st = origins_[origin];
  ++st.applied;
  st.covered += seq_hi - seq_lo + 1;
  if (seq_hi <= st.watermark) {
    // Entirely below the watermark: a re-delivered message (transport
    // retry, injected dup).  The apply itself already happened — the
    // updater re-applied the delta, which is the documented
    // INDETERMINATE retry contract — the book's job is to make the
    // duplication VISIBLE, not to mask it.
    ++st.dups;
    Dashboard::Record("audit.dup", 0.0);
    RecordAnomaly(Anomaly::kDup, origin, seq_lo, seq_hi);
  } else if (seq_lo <= st.watermark + 1) {
    // Contiguous (or overlapping a retried prefix): advance, then
    // drain any pending ranges the new watermark reaches.
    st.watermark = seq_hi;
    auto it = st.pending.begin();
    while (it != st.pending.end() && it->first <= st.watermark + 1) {
      st.watermark = std::max(st.watermark, it->second);
      it = st.pending.erase(it);
    }
    if (st.pending.empty()) {
      st.pending_since_ms = -1;
      st.gap_fired = false;  // episode closed; a future gap re-arms
    }
  } else {
    // Ahead of a hole: out-of-order.  Park the range; contiguity (or
    // the grace deadline) decides later whether this was a benign
    // reorder or a real loss.
    ++st.reorders;
    Dashboard::Record("audit.reorder", 0.0);
    RecordAnomaly(Anomaly::kReorder, origin, seq_lo, seq_hi);
    auto it = st.pending.find(seq_lo);
    if (it == st.pending.end() || it->second < seq_hi)
      st.pending[seq_lo] = std::max(seq_hi, it == st.pending.end()
                                                ? seq_hi
                                                : it->second);
    if (st.pending_since_ms < 0) st.pending_since_ms = now_ms;
    while (st.pending.size() > kMaxPendingRanges) {
      // Evict the HIGHEST range: the low end is what contiguity will
      // drain next, and the eviction stays visible in the counter.
      st.pending.erase(std::prev(st.pending.end()));
      ++st.pending_dropped;
    }
  }
  CheckGapsLocked(table_id, now_ms);
}

void DeliveryBook::CheckGapsLocked(int32_t table_id, int64_t now_ms) {
  int64_t grace = FlagOr("audit_grace_ms", 2000);
  for (auto& [origin, st] : origins_) {
    if (st.pending.empty() || st.gap_fired ||
        st.pending_since_ms < 0 || now_ms - st.pending_since_ms < grace)
      continue;
    st.gap_fired = true;
    int64_t miss_lo = st.watermark + 1;
    int64_t miss_hi = st.pending.begin()->first - 1;
    RecordAnomaly(Anomaly::kGap, origin, miss_lo, miss_hi);
    Dashboard::Record("audit.gap", 0.0);
    // The whole point of detection-time auditing: the black box
    // captures the evidence NOW, with the recent event/span ring
    // still holding the window the adds vanished in.
    ops::BlackboxTrigger(
        "audit_gap: table " + std::to_string(table_id) + " origin " +
        std::to_string(origin) + " missing seqs [" +
        std::to_string(miss_lo) + "," + std::to_string(miss_hi) +
        "] beyond grace");
  }
}

int64_t DeliveryBook::Watermark(int origin) const {
  MutexLock lk(mu_);
  auto it = origins_.find(origin);
  return it == origins_.end() ? 0 : it->second.watermark;
}

bool DeliveryBook::Covers(int origin, int64_t seq_lo,
                          int64_t seq_hi) const {
  if (seq_lo <= 0 || seq_hi < seq_lo) return false;
  MutexLock lk(mu_);
  auto it = origins_.find(origin);
  if (it == origins_.end()) return false;
  const OriginState& st = it->second;
  if (seq_hi <= st.watermark) return true;
  // Parked out-of-order range fully containing [lo, hi] also counts:
  // that delivery happened, it just arrived ahead of a hole.
  for (const auto& [plo, phi] : st.pending)
    if (plo <= seq_lo && seq_hi <= phi) return true;
  return false;
}

void DeliveryBook::NoteDupSkipped(int origin, int64_t seq_lo,
                                  int64_t seq_hi) {
  if (!Armed()) return;
  MutexLock lk(mu_);
  OriginState& st = origins_[origin];
  ++st.dups;
  Dashboard::Record("audit.dup", 0.0);
  RecordAnomaly(Anomaly::kDup, origin, seq_lo, seq_hi);
}

std::vector<std::pair<int, int64_t>> DeliveryBook::ExportWatermarks()
    const {
  MutexLock lk(mu_);
  std::vector<std::pair<int, int64_t>> out;
  out.reserve(origins_.size());
  for (const auto& [origin, st] : origins_)
    out.emplace_back(origin, st.watermark);
  return out;
}

void DeliveryBook::ImportWatermarks(
    const std::vector<std::pair<int, int64_t>>& w) {
  MutexLock lk(mu_);
  for (const auto& [origin, mark] : w) {
    OriginState& st = origins_[origin];
    if (mark > st.watermark) st.watermark = mark;
  }
}

void DeliveryBook::CheckGaps(int32_t table_id) {
  if (!Armed()) return;
  MutexLock lk(mu_);
  CheckGapsLocked(table_id, NowMs());
}

std::string DeliveryBook::Json() const {
  MutexLock lk(mu_);
  std::ostringstream os;
  os << "{\"origins\":[";
  bool first = true;
  for (const auto& [origin, st] : origins_) {
    if (!first) os << ',';
    first = false;
    os << "{\"origin\":" << origin << ",\"watermark\":" << st.watermark
       << ",\"applied\":" << st.applied << ",\"covered\":" << st.covered
       << ",\"dups\":" << st.dups << ",\"reorders\":" << st.reorders
       << ",\"pending_dropped\":" << st.pending_dropped
       << ",\"pending\":[";
    bool pf = true;
    for (const auto& [lo, hi] : st.pending) {
      if (!pf) os << ',';
      pf = false;
      os << "[" << lo << "," << hi << "]";
    }
    os << "],\"gap_fired\":" << (st.gap_fired ? "true" : "false") << "}";
  }
  os << "],\"anomalies\":[";
  first = true;
  // Oldest-first over the wrapped ring so the report reads as a log.
  size_t n = ring_.size();
  size_t start = n && ring_total_ > static_cast<long long>(n)
                     ? ring_next_ % n
                     : 0;
  for (size_t i = 0; i < n; ++i) {
    const Anomaly& a = ring_[(start + i) % n];
    if (!first) os << ',';
    first = false;
    os << "{\"kind\":\"" << AnomalyName(a.kind) << "\",\"origin\":"
       << a.origin << ",\"seq_lo\":" << a.seq_lo << ",\"seq_hi\":"
       << a.seq_hi << ",\"ts_ms\":" << a.ts_ms << "}";
  }
  os << "],\"anomaly_total\":" << ring_total_ << "}";
  return os.str();
}

void DeliveryBook::Reset() {
  MutexLock lk(mu_);
  origins_.clear();
  ring_.clear();
  ring_next_ = 0;
  ring_total_ = 0;
}

// ------------------------------------------------------------- AckLedger

void AckLedger::NextRange(int shard, int64_t span, int64_t* lo,
                          int64_t* hi) {
  if (span < 1) span = 1;
  MutexLock lk(mu_);
  if (shard >= static_cast<int>(shards_.size()))
    shards_.resize(static_cast<size_t>(shard) + 1);
  ShardState& st = shards_[shard];
  *lo = st.sent + 1;
  *hi = st.sent + span;
  st.sent = *hi;
}

void AckLedger::Ack(int shard, int64_t seq_hi) {
  MutexLock lk(mu_);
  if (shard < 0 || shard >= static_cast<int>(shards_.size())) return;
  ShardState& st = shards_[shard];
  if (seq_hi > st.acked) st.acked = seq_hi;
}

std::vector<AckLedger::ShardState> AckLedger::Snapshot() const {
  MutexLock lk(mu_);
  return shards_;
}

std::string AckLedger::Json() const {
  auto snap = Snapshot();
  std::ostringstream os;
  os << "{\"shards\":[";
  for (size_t s = 0; s < snap.size(); ++s) {
    if (s) os << ',';
    os << "{\"shard\":" << s << ",\"sent\":" << snap[s].sent
       << ",\"acked\":" << snap[s].acked << "}";
  }
  os << "]}";
  return os.str();
}

void AckLedger::Reset() {
  MutexLock lk(mu_);
  shards_.clear();
}

}  // namespace audit
}  // namespace mvtpu
