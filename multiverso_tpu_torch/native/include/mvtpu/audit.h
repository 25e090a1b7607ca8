// Delivery-audit plane (docs/observability.md "audit plane").
//
// Proves the asynchronous push-pull contract held: every Add a worker
// sends is stamped with a durable identity — (origin_rank, table, seq)
// where seq is a per-(worker, table, server-shard) monotonic counter
// carried behind msgflag::kHasAudit — and both ends keep books:
//
//   client  AckLedger     per shard: last seq SENT and last seq ACKED
//                         (a blocking add's ReplyAdd echoes its stamp;
//                         per-connection FIFO means an ack of seq n
//                         covers every earlier seq on that stream)
//   server  DeliveryBook  per origin: applied watermark w (all seqs
//                         <= w applied), a bounded out-of-order pending
//                         set, dup/reorder counters, and a bounded
//                         anomaly ring naming each event's seq range
//
// The invariant the auditor checks fleet-wide (tools/mvaudit.py):
//   acked(origin, table, shard) <= watermark(server shard, table, origin)
// An acked seq the server never applied is a LOST ACKED ADD — the
// failure class ROADMAP item 1's replication gate must prove absent.
// A pending out-of-order range that survives `-audit_grace_ms` fires
// the flight recorder (`audit_gap`), capturing evidence at
// detection time rather than postmortem.
//
// Periodic per-bucket content checksums (Crc32 over table state,
// bucket mapping shared with the version stamps) give replica-
// divergence detection its primitive: two shards holding the same rows
// must report identical bucket checksums, and the XOR-of-row-CRCs
// construction makes the value independent of iteration order.
//
// `-audit=false` (or MV_SetAudit) compiles the whole plane down to one
// relaxed atomic load per site.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <utility>
#include <vector>

#include "mvtpu/mutex.h"

namespace mvtpu {
namespace audit {

// Arm switch: latched from -audit at Zoo::Start, toggled live by
// MV_SetAudit.  Disarmed, workers stamp nothing and servers book
// nothing (frames already in flight still parse — the flag bit is
// per message).
void Arm(bool on);
bool Armed();

// CRC-32 (IEEE 802.3, reflected) — the checksum beacon primitive.
// `seed` chains: Crc32(b, n, Crc32(a, m)) == Crc32(a+b).
uint32_t Crc32(const void* data, size_t n, uint32_t seed = 0);

// One recorded delivery anomaly (the bounded ring's unit).
struct Anomaly {
  enum Kind { kDup = 0, kReorder = 1, kGap = 2 };
  Kind kind;
  int origin;
  int64_t seq_lo, seq_hi;
  int64_t ts_ms;  // steady-clock ms at detection
};

// Server-side per-(table, origin) delivery book.  One instance per
// ServerTable; every stamped RequestAdd lands in NoteApply right after
// the table applied it.  Thread-safe (the server actor is single-
// threaded today, but ops scrapes read concurrently).
class DeliveryBook {
 public:
  struct OriginState {
    int64_t watermark = 0;   // all seqs <= watermark applied
    int64_t applied = 0;     // stamped messages applied
    int64_t covered = 0;     // logical adds covered (sum of range widths)
    int64_t dups = 0;        // re-delivered ranges (retry/injected dup)
    int64_t reorders = 0;    // ranges that arrived ahead of a gap
    int64_t pending_dropped = 0;  // ranges evicted from a full pending set
    int64_t pending_since_ms = -1;  // first out-of-order observed (-1 none)
    bool gap_fired = false;  // audit_gap blackbox latched this episode
    // mvlint: MV018-exempt(bounded at kMaxPending ranges — the
    // highest range evicts + counts pending_dropped when full)
    std::map<int64_t, int64_t> pending;  // lo -> hi, disjoint, sorted
  };

  // Book one applied stamped message.  `table_id` only names the table
  // in anomaly records / the audit_gap trigger reason.
  void NoteApply(int origin, int64_t seq_lo, int64_t seq_hi,
                 int32_t table_id);

  // ---- replication / failover support (docs/replication.md) ---------
  // True when [seq_lo, seq_hi] was already applied here (entirely
  // below the watermark or inside a parked out-of-order range).  With
  // replication armed the server consults this BEFORE ProcessAdd: a
  // post-failover replay of an already-forwarded add must ack without
  // re-applying — stamped adds become idempotent end-to-end, which is
  // what lets workers retry through a promotion without double-counts.
  bool Covers(int origin, int64_t seq_lo, int64_t seq_hi) const;
  // Book a dup that was SKIPPED (not re-applied): counts the anomaly
  // so the auditor still names it, but applied/covered stay honest.
  void NoteDupSkipped(int origin, int64_t seq_lo, int64_t seq_hi);
  // Current applied watermark for one origin (0 = none booked) — the
  // value an add ack echoes as its acked bound (docs/replication.md):
  // under the per-connection FIFO this equals the request's seq_hi,
  // but across a failover a hole (an attempt that died with the old
  // primary) must never be covered by a later ack — the book's
  // watermark is the truth, the FIFO rule was only its proxy.
  int64_t Watermark(int origin) const;
  // Snapshot/restore the per-origin applied watermarks — rides the
  // ShardSnapshot catch-up payload so a joining backup's book agrees
  // with the primary's at the snapshot version (mvaudit's diff then
  // holds across primary AND backup).
  std::vector<std::pair<int, int64_t>> ExportWatermarks() const;
  void ImportWatermarks(const std::vector<std::pair<int, int64_t>>& w);

  // Grace sweep: fire the audit_gap flight-recorder trigger for any
  // origin whose pending set outlived `-audit_grace_ms` (also run
  // opportunistically by NoteApply).  Called by the audit report build
  // so a gap with no follow-up traffic still surfaces.
  void CheckGaps(int32_t table_id);

  // {"origins":[{...}],"anomalies":[{...}]} — the server half of one
  // table's entry in the "audit" OpsQuery report.
  std::string Json() const;

  // Test / bench isolation.
  void Reset();

 private:
  void RecordAnomaly(Anomaly::Kind kind, int origin, int64_t lo,
                     int64_t hi) REQUIRES(mu_);
  void CheckGapsLocked(int32_t table_id, int64_t now_ms) REQUIRES(mu_);

  mutable Mutex mu_;
  std::map<int, OriginState> origins_ GUARDED_BY(mu_);
  std::vector<Anomaly> ring_ GUARDED_BY(mu_);  // bounded by -audit_ring
  size_t ring_next_ GUARDED_BY(mu_) = 0;
  long long ring_total_ GUARDED_BY(mu_) = 0;
};

// Client-side per-(table, shard) acked-add ledger.  Seq assignment and
// ack watermarks live together because both are keyed by the shard
// stream.  Thread-safe: table ops may run on any caller thread while
// the worker actor thread lands acks.
class AckLedger {
 public:
  // Allocate the seq range a new Add message to `shard` covers:
  // `span` logical adds (1 for a plain add; the collapsed window size
  // for an aggregation flush).  Returns [lo, hi] inclusive.
  void NextRange(int shard, int64_t span, int64_t* lo, int64_t* hi);
  // A ReplyAdd ack echoing [lo, hi] landed from `shard`: advance the
  // acked watermark (per-connection FIFO: an ack covers every earlier
  // seq on the stream, so max-merge of hi is exact).
  void Ack(int shard, int64_t seq_hi);

  struct ShardState {
    int64_t sent = 0;   // last seq assigned (0 = none)
    int64_t acked = 0;  // acked watermark (all seqs <= acked applied)
  };
  std::vector<ShardState> Snapshot() const;
  std::string Json() const;  // {"shards":[{"shard","sent","acked"}]}
  void Reset();

 private:
  mutable Mutex mu_;
  std::vector<ShardState> shards_ GUARDED_BY(mu_);  // grown on demand
};

}  // namespace audit
}  // namespace mvtpu
