// Table layer: worker-side stubs + server-side shards.
// Capability parity with include/multiverso/table_interface.h and
// include/multiverso/table/ (SURVEY.md §2.10–2.12): ArrayTable (dense 1-D)
// and MatrixTable (2-D, row-addressable) in float32.  The worker stub
// turns Get/Add into request messages answered by Server actors; a Waiter
// blocks the caller until every contacted shard replied — the reference's
// §3.2/§3.3 hot path.  Sharding matches the reference: server rank r owns
// a contiguous array chunk / matrix row block computed by ShardRange, the
// worker partitions each request across owners (WorkerTable::Partition
// semantics) and reassembles replies by the reply's src rank.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "mvtpu/audit.h"
#include "mvtpu/capacity.h"
#include "mvtpu/codec.h"
#include "mvtpu/message.h"
#include "mvtpu/mutex.h"
#include "mvtpu/sketch.h"
#include "mvtpu/stream.h"
#include "mvtpu/updater.h"
#include "mvtpu/waiter.h"

namespace mvtpu {

// Contiguous balanced partition of n elements over `size` shards; the
// same formula on worker and server sides is the partition contract.
struct ShardRange {
  int64_t begin = 0;
  int64_t end = 0;
  int64_t len() const { return end - begin; }
};

inline ShardRange ShardOf(int64_t n, int rank, int size) {
  int64_t base = n / size;
  int64_t rem = n % size;
  int64_t b = rank * base + std::min<int64_t>(rank, rem);
  return {b, b + base + (rank < rem ? 1 : 0)};
}

inline int OwnerOf(int64_t index, int64_t n, int size) {
  // Inverse of ShardOf: first `rem` shards have base+1 elements.
  int64_t base = n / size;
  int64_t rem = n % size;
  int64_t big = (base + 1) * rem;  // elements held by the larger shards
  if (base == 0) return static_cast<int>(index);  // n < size degenerate
  if (index < big) return static_cast<int>(index / (base + 1));
  return static_cast<int>(rem + (index - big) / base);
}

// ---- host-bridge borrow window (docs/host_bridge.md) -----------------
// RAII thread-local borrow scope for the *Borrowed C API: while a scope
// is active on this thread, raw float payloads whose bytes fall inside
// [base, base+len) ship as Blob::Borrow sharing `hold` (the HostArena
// keepalive) instead of being copied into owning blobs.  Encode paths
// (1bit/sparse) and the aggregation buffer ignore the scope — they must
// mutate or outlive the payload, so they take ownership by copying
// (copy-on-conflict).  Scopes do not nest.
class BorrowScope {
 public:
  BorrowScope(const void* base, size_t len, std::shared_ptr<void> hold);
  ~BorrowScope();
  BorrowScope(const BorrowScope&) = delete;
  BorrowScope& operator=(const BorrowScope&) = delete;
};

// Payload blob for [p, p+bytes): borrowed when the active scope covers
// the window, an owning copy otherwise — THE one spelling every raw
// send-path payload goes through.
Blob WrapPayload(const void* p, size_t bytes);

// ---------------------------------------------------------------- server
class ServerTable {
 public:
  ServerTable() {
    for (auto& b : bucket_versions_) b.store(0, std::memory_order_relaxed);
    for (auto& b : bucket_gets_) b.store(0, std::memory_order_relaxed);
    for (auto& b : bucket_adds_) b.store(0, std::memory_order_relaxed);
    for (auto& b : bucket_bytes_) b.store(0, std::memory_order_relaxed);
  }
  virtual ~ServerTable() = default;
  // Fill reply blobs for a get request.
  virtual void ProcessGet(const Message& req, Message* reply) = 0;
  virtual void ProcessAdd(const Message& req) = 0;
  // Store/Load operate on the LOCAL shard (multi-process callers keep
  // one file per rank, the reference's per-server dump model).
  virtual bool Store(Stream* out) const = 0;
  virtual bool Load(Stream* in) = 0;

  // ---- serve-layer versions (docs/serving.md) ------------------------
  // Every ProcessAdd bumps a per-shard monotonic counter; row/key adds
  // additionally stamp the touched BUCKETS, so a read of untouched
  // buckets can report an older (still-valid) version and client caches
  // miss less.  Replies stamp the version covering the data they serve.
  static constexpr int kVersionBuckets = 64;
  int64_t version() const {
    return version_.load(std::memory_order_acquire);
  }
  int64_t bucket_version(int b) const {
    if (b < 0 || b >= kVersionBuckets) return version();
    return bucket_versions_[b].load(std::memory_order_acquire);
  }

  // ---- workload observability (docs/observability.md) ----------------
  // Data-plane accounting beside the version plumbing: per-bucket
  // get/add load counters (skew = max bucket / mean bucket), a top-K /
  // count-min hot-key tracker, an observed-staleness histogram, and
  // update-health sentinels (add L2/Linf accumulators, NaN/Inf counts
  // with a flight-recorder trigger on the first NaN).  Every hook
  // no-ops on one relaxed atomic load when `-hotkey_enabled=false`.
  void set_table_id(int32_t id) { obs_table_id_ = id; }
  int32_t observed_table_id() const { return obs_table_id_; }

  struct LoadStats {
    int64_t gets = 0;        // ProcessGet calls served
    int64_t adds = 0;        // ProcessAdd calls applied
    double skew_ratio = 0;   // max bucket load / mean bucket load
    int64_t bucket_load_max = 0;
    double bucket_load_mean = 0;
    double add_l2 = 0;       // sqrt of accumulated delta L2^2
    double add_linf = 0;     // max |delta element| ever applied
    long long nan_count = 0;
    long long inf_count = 0;
    long long staleness_count = 0;  // stamped reads observed
    double staleness_mean = 0;      // mean version distance at serve time
  };
  LoadStats Load() const;
  std::string HotKeysJson() const { return tracker_.Json(); }

  // ---- capacity accounting (docs/observability.md "capacity plane") --
  // Resident bytes/rows of THIS shard, per bucket and in total —
  // migration's placement unit, measured.  Construction and snapshot
  // Load recompute exactly (RecomputeCapacity: a full walk under the
  // shard lock); growth on the hot path (KV key inserts — matrix/array
  // shards are fixed-size) bumps the counters incrementally behind one
  // relaxed capacity::Armed() load.  Re-arming via
  // MV_SetCapacityTracking resyncs every table, so counters disarmed
  // adds left stale heal the moment tracking turns back on.
  struct CapacityUsage {
    int64_t bytes = 0;  // resident payload + per-entry overhead
    int64_t rows = 0;   // matrix rows / KV entries / array elements
  };
  CapacityUsage Capacity() const {
    CapacityUsage u;
    u.bytes = resident_bytes_.load(std::memory_order_relaxed);
    u.rows = resident_rows_.load(std::memory_order_relaxed);
    return u;
  }
  std::vector<int64_t> BucketBytes() const {
    std::vector<int64_t> out(kVersionBuckets, 0);
    for (int b = 0; b < kVersionBuckets; ++b)
      out[b] = bucket_bytes_[b].load(std::memory_order_relaxed);
    return out;
  }
  // Per-bucket get/add load counters (the rate-curve substrate the
  // capacity history ring snapshots); both arrays kVersionBuckets long.
  void BucketLoads(int64_t* gets, int64_t* adds) const {
    for (int b = 0; b < kVersionBuckets; ++b) {
      if (gets) gets[b] = bucket_gets_[b].load(std::memory_order_relaxed);
      if (adds) adds[b] = bucket_adds_[b].load(std::memory_order_relaxed);
    }
  }
  int64_t total_gets() const {
    return total_gets_.load(std::memory_order_relaxed);
  }
  int64_t total_adds() const {
    return total_adds_.load(std::memory_order_relaxed);
  }
  // Exact full walk under the shard lock; called at construction,
  // after a successful snapshot Load, and on re-arm.
  virtual void RecomputeCapacity() {}

 protected:
  // Zero + set the whole-shard counters (the Recompute entry).
  void ResetCapacity(int64_t bytes, int64_t rows) {
    resident_bytes_.store(bytes, std::memory_order_relaxed);
    resident_rows_.store(rows, std::memory_order_relaxed);
    for (auto& b : bucket_bytes_) b.store(0, std::memory_order_relaxed);
  }
  void ChargeBucketBytes(int bucket, int64_t bytes) {
    if (bucket >= 0)
      bucket_bytes_[bucket % kVersionBuckets].fetch_add(
          bytes, std::memory_order_relaxed);
  }
  // Hot-path increment for one NEW resident entry (KV insert): one
  // relaxed load disarmed, three relaxed bumps armed.  rows=0 for
  // side-slot growth that adds bytes but no logical entry.
  void NoteEntryBytes(int bucket, int64_t bytes, int64_t rows = 1) {
    if (!capacity::Armed()) return;
    resident_bytes_.fetch_add(bytes, std::memory_order_relaxed);
    if (rows) resident_rows_.fetch_add(rows, std::memory_order_relaxed);
    ChargeBucketBytes(bucket, bytes);
  }

 public:
  std::vector<workload::HotKeyTracker::Item> HotTopK() const {
    return tracker_.TopK();
  }

  // ---- hot-key replica push (docs/embedding.md) ----------------------
  // Fill a ReplyReplica with this shard's current SpaceSaving top-K
  // rows: [int32 row ids][int64 bucket versions][float row data], rows
  // and versions snapshotted atomically against concurrent adds.  The
  // default is an empty push (table kinds with no row-replica form);
  // MatrixServerTable overrides.  Answered by the server actor for
  // MsgType::RequestReplica — sheddable like a Get, never blocks adds.
  virtual void BuildReplica(Message* reply) { (void)reply; }
  int64_t replica_pushes() const {
    return replica_pushes_.load(std::memory_order_relaxed);
  }

  // ---- delivery audit (docs/observability.md "audit plane") ----------
  // Book one applied stamped add: the server actor calls this right
  // after ProcessAdd for every RequestAdd carrying an AuditStamp, so
  // the per-(table, origin) applied watermark tracks exactly what the
  // updaters saw.  No-op when the message is unstamped or -audit=false.
  void NoteAuditApply(const Message& req) {
    if (!req.has_audit() || !audit::Armed()) return;
    audit_book_.NoteApply(req.src, req.audit.seq_lo, req.audit.seq_hi,
                          obs_table_id_);
  }
  audit::DeliveryBook& audit_book() { return audit_book_; }
  const audit::DeliveryBook& audit_book() const { return audit_book_; }
  // Per-bucket content checksums (CRC32 over table state, bucket
  // mapping shared with the version stamps): the replica-
  // divergence primitive — two shards holding the same rows report
  // identical values, independent of iteration order (XOR of per-entry
  // CRCs seeded by the entry's identity).  The base reports a single
  // whole-shard checksum; bucket-granular kinds override.
  virtual std::vector<uint32_t> BucketChecksums() const { return {}; }

 protected:
  void NoteReplicaPush() {
    replica_pushes_.fetch_add(1, std::memory_order_relaxed);
  }

 public:

 protected:
  // One call per ProcessGet/ProcessAdd; bucket < 0 = whole-table op
  // (counts toward totals only — charging all 64 buckets would fake a
  // flat profile over the skew the per-key ops reveal).
  void NoteGet(int bucket) {
    if (!workload::Armed()) return;
    total_gets_.fetch_add(1, std::memory_order_relaxed);
    if (bucket >= 0)
      bucket_gets_[bucket % kVersionBuckets].fetch_add(
          1, std::memory_order_relaxed);
  }
  void NoteAdd(int bucket) {
    if (!workload::Armed()) return;
    total_adds_.fetch_add(1, std::memory_order_relaxed);
    if (bucket >= 0)
      bucket_adds_[bucket % kVersionBuckets].fetch_add(
          1, std::memory_order_relaxed);
  }
  // One touched key (matrix row / KV key): sketch offer + bucket load.
  void NoteKey(uint64_t hash, const std::string& label, int bucket,
               bool is_add) {
    if (!workload::Armed()) return;
    tracker_.Note(hash, label);
    auto& loads = is_add ? bucket_adds_ : bucket_gets_;
    if (bucket >= 0)
      loads[bucket % kVersionBuckets].fetch_add(
          1, std::memory_order_relaxed);
  }
  // Observed staleness at serve time: server version minus the version
  // the requester stamped into the Get (its last-seen stamp).  Recorded
  // into the per-table Dashboard histogram `workload.staleness.t<id>`
  // (1 unit = 1 version, via the µs-bucket ladder) — the measured
  // distribution to hold against `-max_staleness`.
  void NoteStaleness(int64_t request_version);
  // Update-health scan over a decoded add payload: L2^2 / Linf
  // accumulators + NaN/Inf counts; the FIRST NaN trips a flight-
  // recorder dump naming this table (a diverging model is a failure
  // whose post-mortem needs the recent ring, not a silent poisoning).
  void NoteAddHealth(const float* delta, size_t n);

 public:
  // Replication catch-up (docs/replication.md): adopt a primary's
  // snapshot version (max-merge, every bucket) so a freshly installed
  // backup's reply stamps never run BEHIND versions clients already
  // observed from the old primary.
  void AdvanceVersionTo(int64_t v) {
    int64_t cur = version_.load(std::memory_order_acquire);
    while (cur < v &&
           !version_.compare_exchange_weak(cur, v,
                                           std::memory_order_acq_rel)) {
    }
    for (auto& b : bucket_versions_) {
      int64_t bv = b.load(std::memory_order_acquire);
      while (bv < v &&
             !b.compare_exchange_weak(bv, v, std::memory_order_acq_rel)) {
      }
    }
  }

 protected:
  // bucket < 0 stamps EVERY bucket (whole-table adds).
  void BumpVersion(int64_t bucket = -1) {
    int64_t v = version_.fetch_add(1, std::memory_order_acq_rel) + 1;
    if (bucket < 0) {
      for (auto& b : bucket_versions_) b.store(v, std::memory_order_release);
    } else {
      bucket_versions_[bucket % kVersionBuckets].store(
          v, std::memory_order_release);
    }
  }
  static int RowBucket(int64_t row) {
    return static_cast<int>(((row % kVersionBuckets) + kVersionBuckets) %
                            kVersionBuckets);
  }

 private:
  std::atomic<int64_t> version_{0};
  std::atomic<int64_t> bucket_versions_[kVersionBuckets];

  // ---- workload accounting state (docs/observability.md) -------------
  int32_t obs_table_id_ = -1;
  std::atomic<int64_t> bucket_gets_[kVersionBuckets];
  std::atomic<int64_t> bucket_adds_[kVersionBuckets];
  std::atomic<int64_t> total_gets_{0};
  std::atomic<int64_t> total_adds_{0};
  workload::HotKeyTracker tracker_;
  std::atomic<int64_t> replica_pushes_{0};
  audit::DeliveryBook audit_book_;

  // ---- capacity accounting state (docs/observability.md) -------------
  std::atomic<int64_t> resident_bytes_{0};
  std::atomic<int64_t> resident_rows_{0};
  std::atomic<int64_t> bucket_bytes_[kVersionBuckets];
  mutable Mutex health_mu_;
  double add_l2sq_ GUARDED_BY(health_mu_) = 0.0;
  double add_linf_ GUARDED_BY(health_mu_) = 0.0;
  long long nan_count_ GUARDED_BY(health_mu_) = 0;
  long long inf_count_ GUARDED_BY(health_mu_) = 0;
  std::atomic<bool> nan_triggered_{false};
};

class ArrayServerTable : public ServerTable {
 public:
  ArrayServerTable(int64_t global_size, UpdaterType updater, int rank = 0,
                   int size = 1);
  void ProcessGet(const Message& req, Message* reply) override;
  void ProcessAdd(const Message& req) override;
  bool Store(Stream* out) const override;
  bool Load(Stream* in) override;
  std::vector<uint32_t> BucketChecksums() const override;
  void RecomputeCapacity() override;
  int64_t size() const {
    MutexLock lk(mu_);
    return static_cast<int64_t>(data_.size());
  }

 private:
  ShardRange range_;
  mutable Mutex mu_;
  std::vector<float> data_ GUARDED_BY(mu_);    // the local shard
  std::vector<float> slot0_ GUARDED_BY(mu_);
  UpdaterType updater_;
};

class MatrixServerTable : public ServerTable {
 public:
  MatrixServerTable(int64_t rows, int64_t cols, UpdaterType updater,
                    int rank = 0, int size = 1);
  void ProcessGet(const Message& req, Message* reply) override;
  void ProcessAdd(const Message& req) override;
  // Hot-key replica push (docs/embedding.md): this shard's current
  // top-K rows with their bucket versions, snapshotted under mu_ so a
  // concurrent add can neither tear a row nor out-date a stamp.
  void BuildReplica(Message* reply) override;
  bool Store(Stream* out) const override;
  bool Load(Stream* in) override;
  std::vector<uint32_t> BucketChecksums() const override;
  void RecomputeCapacity() override;
  int64_t rows() const { return range_.len(); }
  int64_t cols() const { return cols_; }

 private:
  int64_t global_rows_, cols_;
  ShardRange range_;           // the row block this rank owns
  mutable Mutex mu_;
  std::vector<float> data_ GUARDED_BY(mu_);  // range_.len()*cols, row-major
  std::vector<float> slot0_ GUARDED_BY(mu_);
  UpdaterType updater_;
};

// ---------------------------------------------------------------- worker
class WorkerTable;

// Handle for an in-flight async Get (reference WorkerTable::GetAsync +
// Waiter-handle Wait, SURVEY.md §2.10): the request is on the wire when
// the starting call returns, so the caller overlaps the round trip with
// compute — the AsyncBuffer double-buffer idiom (§2.24) expressed over
// the wire.  The caller's output buffer must stay alive and untouched
// until Wait() returns.  Wait() is RoundTrip's back half: true when
// every contacted shard replied, false on dead-shard ReplyError or
// `-rpc_timeout_ms` expiry — with the same INDETERMINATE contract (the
// buffer may be partially filled).  Idempotent.  Destroying an
// un-Wait()ed handle withdraws the request safely: late replies are
// dropped at the door, never touching the dead waiter or the buffer.
// The owning table must outlive the handle.
class AsyncGetHandle {
 public:
  ~AsyncGetHandle();
  bool Wait();

 private:
  friend class WorkerTable;
  AsyncGetHandle(WorkerTable* t, int64_t msg_id, int nreq,
                 std::shared_ptr<void> state)
      : table_(t), msg_id_(msg_id),
        waiter_(std::make_shared<Waiter>(nreq)), state_(std::move(state)) {}
  WorkerTable* table_;
  int64_t msg_id_;          // -1: empty request, trivially complete
  std::shared_ptr<Waiter> waiter_;  // shared with pending_ (see Notify)
  bool failed_ GUARDED_BY(table_->mu_) = false;  // written by Notify
  bool busy_ GUARDED_BY(table_->mu_) = false;    // ReplyBusy shed
  // Owner-thread state (only the thread driving Wait()/~ touches these;
  // no lock, so they carry no capability annotation).
  bool waited_ = false;
  bool ok_ = false;
  std::shared_ptr<void> state_;  // owns the consume plan (scatter map)
};
using AsyncGetPtr = std::unique_ptr<AsyncGetHandle>;

// Blocking stub; one instance per table per process.
class WorkerTable {
 public:
  explicit WorkerTable(int32_t table_id) : table_id_(table_id) {}
  virtual ~WorkerTable() = default;
  int32_t table_id() const { return table_id_; }

  // Called by the Worker actor when a reply for msg_id arrives.
  void Notify(int64_t msg_id, const Message& reply);

  // Clock boundary hook (Zoo::Barrier success): worker-side caches drop
  // entries here — peers' adds from the closed clock are now visible.
  virtual void OnClockInvalidate() {}

  // ---- serve layer (docs/serving.md) ---------------------------------
  // Highest server-side version stamp observed in ANY reply to this
  // worker stub — a free (no wire) lower bound on the server version,
  // refreshed by every Get/Add ack.
  int64_t last_version() const {
    return last_version_.load(std::memory_order_acquire);
  }
  // Cheap wire probe: fills *version with the max CURRENT version over
  // every server shard (`bucket >= 0` asks one bucket of a KV/matrix
  // table).  One tiny header-only round trip instead of a full fetch.
  // False on dead shard / deadline / busy-shed (see last_call_busy).
  bool QueryVersion(int64_t* version, int bucket = -1);
  // True when THIS THREAD's most recent blocking round trip (Get/Add/
  // QueryVersion/Wait) failed because a server SHED it under
  // `-server_inflight_max` backpressure (ReplyBusy) rather than dying
  // or timing out — the retryable case (C API rc -6 vs -3).
  static bool last_call_busy();

  // ---- wire codec (docs/wire_compression.md) -------------------------
  // Negotiated at table creation from `-wire_codec` (overridable per
  // table via MV_SetTableCodec) and stamped per message: dense Add
  // payloads ship 1-bit (sign + two scales, worker-side error feedback)
  // or sparse (nonzero index/value pairs, lossless, with per-message
  // raw fallback when not smaller); Get requests advertise the accept
  // set so large mostly-zero replies can come back sparse.
  void set_codec(Codec c) {
    codec_.store(static_cast<int32_t>(c), std::memory_order_release);
  }
  Codec wire_codec() const {
    return static_cast<Codec>(codec_.load(std::memory_order_acquire));
  }
  // msgflag:: bits for requests: raw always; non-raw tables also accept
  // the lossless sparse reply form (1-bit replies never happen — error
  // feedback needs a per-receiver residual the server does not hold).
  int32_t accept_flags() const {
    Codec c = wire_codec();
    int32_t f = msgflag::kAcceptRaw;
    if (c != Codec::kRaw) f |= msgflag::kAcceptSparse;
    if (c == Codec::kOneBit) f |= msgflag::kAccept1Bit;
    return f;
  }

  // ---- delivery audit (docs/observability.md "audit plane") ----------
  // Stamp an outbound RequestAdd headed for server shard `shard` with
  // the next seq range of that shard's stream (msgflag::kHasAudit).
  // Inside a FlushAdds window the range covers every collapsed logical
  // add (the agg accounting); otherwise one.  No-op disarmed.
  void StampAuditAdd(Message* req, int shard);
  // The acked-add ledger: per shard, last seq sent and last seq acked
  // (advanced by ReplyAdd acks in Notify — per-connection FIFO makes
  // an ack cover every earlier seq on the stream).
  audit::AckLedger& ack_ledger() { return ack_ledger_; }
  std::string AuditLedgerJson() const { return ack_ledger_.Json(); }

  // ---- add aggregation (docs/wire_compression.md) --------------------
  // With `-add_agg_ms`/`-add_agg_bytes` armed, ASYNC dense adds are
  // summed into a local per-table buffer and shipped as ONE
  // codec-encoded wire message per flush window.  Flush triggers: the
  // size/time bound, any Get/QueryVersion, any blocking or
  // differently-shaped add, Clock (the tick must ride BEHIND the adds
  // it announces), Barrier (via FlushPipelines) and shutdown — so
  // BSP/SSP visibility semantics are unchanged.  The time window is
  // checked lazily at the next table op (no flusher thread).
  void FlushAdds();

 protected:
  // Absorb an async dense add of n elements into the aggregation
  // buffer.  True = absorbed (nothing on the wire yet); false = the
  // aggregation feature is off and the caller sends normally.  An
  // incompatible buffered aggregate (different length or AddOption) is
  // flushed first; a full/expired buffer is flushed right after.
  bool MaybeAggregate(const float* delta, int64_t n, const AddOption& opt);

 public:
  // Introspection (mvtpu/ops.h): async adds absorbed into the
  // aggregation buffer but not yet shipped — the "agg buffer depth" of
  // an ops table report.
  int64_t agg_pending() {
    MutexLock lk(agg_mu_);
    return agg_count_;
  }
  // Capacity plane (docs/observability.md): bytes currently held by
  // the add-aggregation buffer (one delta-shaped float sum).
  int64_t agg_bytes() {
    MutexLock lk(agg_mu_);
    return static_cast<int64_t>(agg_sum_.size() * sizeof(float));
  }

 protected:
  // Subclass hook: ship `sum` (n elements) as one async add.
  virtual void SendAggregate(const float* sum, int64_t n,
                             const AddOption& opt) {
    (void)sum;
    (void)n;
    (void)opt;
  }
  // Append the delta payload blob to `req`, encoded per this table's
  // codec, stamping req->codec.  `elem_offset` locates the slice inside
  // the table's flat element space (the 1-bit error-feedback residual
  // is per element and spans the whole table, `table_elems` long).
  void AppendEncodedDelta(Message* req, const float* delta, int64_t n,
                          int64_t elem_offset, int64_t table_elems);

 protected:
  // Send all reqs (same msg_id) via the Zoo, block until each got its
  // reply; `consume` runs once per reply (serialized — one worker-actor
  // thread drains replies).  Returns false when a shard was unreachable
  // (a synthesized ReplyError arrived) or the `-rpc_timeout_ms` deadline
  // passed — the caller fails fast instead of hanging on a dead peer.
  bool RoundTrip(std::vector<MessagePtr> reqs,
                 void (*consume)(void*, const Message&), void* arg);

  // RoundTrip's front half: register the pending entry, put every req
  // on the wire, return the handle whose Wait() is the back half.
  // `state` keeps `arg` (the consume destination plan) alive for the
  // handle's lifetime.
  AsyncGetPtr StartRoundTrip(std::vector<MessagePtr> reqs,
                             void (*consume)(void*, const Message&),
                             void* arg, std::shared_ptr<void> state);

  int32_t table_id_;

 private:
  friend class AsyncGetHandle;
  Mutex mu_;
  struct Pending {
    // shared_ptr, not a raw pointer to the caller's frame: the waiter
    // must stay a live heap object for as long as a reply could touch
    // it (and TSan only tracks mutex death through free()).
    std::shared_ptr<Waiter> waiter;
    void (*consume)(void*, const Message&);
    void* arg;
    int remaining;
    bool* failed;
    bool* busy = nullptr;  // set when a shard answered ReplyBusy
  };
  // mvlint: MV018-exempt(one entry per in-flight round trip, drained
  // by Notify/Wait — bounded by caller concurrency, never by traffic)
  std::unordered_map<int64_t, Pending> pending_ GUARDED_BY(mu_);
  std::atomic<int64_t> last_version_{0};
  audit::AckLedger ack_ledger_;

  // Wire codec (set at registration; MV_SetTableCodec may retarget).
  std::atomic<int32_t> codec_{static_cast<int32_t>(Codec::kRaw)};

  // 1-bit error-feedback residual: per element over the WHOLE table's
  // flat space, lazily sized on first encode.  Worker-side state (the
  // reference keeps it with the sender), never on the wire.
  Mutex residual_mu_;
  std::vector<float> residual_ GUARDED_BY(residual_mu_);

  // Add-aggregation buffer: one delta-shaped sum + the option it rides
  // under.  Bounded by construction (one payload) and drained by the
  // flush triggers documented at FlushAdds().
  Mutex agg_mu_;
  std::vector<float> agg_sum_ GUARDED_BY(agg_mu_);
  AddOption agg_opt_ GUARDED_BY(agg_mu_);
  int64_t agg_count_ GUARDED_BY(agg_mu_) = 0;
  int64_t agg_first_ms_ GUARDED_BY(agg_mu_) = 0;
};

class ArrayWorkerTable : public WorkerTable {
 public:
  ArrayWorkerTable(int32_t table_id, int64_t global_size, int num_servers)
      : WorkerTable(table_id), global_(global_size),
        servers_(num_servers) {}
  bool Get(float* data, int64_t size);
  // Non-blocking Get: data fills in the background; see AsyncGetHandle.
  AsyncGetPtr GetAsync(float* data, int64_t size);
  bool Add(const float* delta, int64_t size, const AddOption& opt,
           bool blocking);

 protected:
  void SendAggregate(const float* sum, int64_t n,
                     const AddOption& opt) override;

 private:
  // The one sharded-send plan for Add and the aggregation flush.
  bool SendAdd(const float* delta, int64_t size, const AddOption& opt,
               bool blocking);
  int64_t global_;
  int servers_;
};

class MatrixWorkerTable : public WorkerTable {
 public:
  MatrixWorkerTable(int32_t table_id, int64_t rows, int64_t cols,
                    int num_servers = 1)
      : WorkerTable(table_id), rows_(rows), cols_(cols),
        servers_(num_servers) {}
  virtual bool GetAll(float* data);               // [rows*cols]
  virtual bool GetRows(const int32_t* row_ids, int64_t k,
                       float* data);              // [k*cols]
  // Non-blocking GetRows (see AsyncGetHandle).  row_ids are consumed
  // before this returns; `data` must live until Wait().  Deliberately
  // non-virtual: on a SparseMatrixWorkerTable this goes straight to the
  // wire — it neither reads nor installs into the row cache (an async
  // fill racing a clock invalidation could resurrect stale rows).
  AsyncGetPtr GetRowsAsync(const int32_t* row_ids, int64_t k, float* data);

  virtual bool AddAll(const float* delta, const AddOption& opt,
                      bool blocking);
  virtual bool AddRows(const int32_t* row_ids, int64_t k,
                       const float* delta, const AddOption& opt,
                       bool blocking);

  // ---- hot-key read replica (docs/embedding.md) ----------------------
  // With `-hotkey_replica` armed, GetRows consults a worker-local side
  // table of the servers' pushed top-K rows BEFORE the wire: a row is a
  // hit when the snapshot is inside `-replica_lease_ms` AND its pushed
  // bucket version satisfies last_version() - `-replica_max_staleness`
  // (version gating IS the invalidation: this worker's own add acks
  // advance last_version, staling every older entry at staleness 0).
  // Refresh = one RequestReplica round trip per shard ("push-on-pull":
  // the SERVER chooses what to replicate — its SpaceSaving top-K).
  bool RefreshReplica();
  void OnReplicaPush(const Message& reply);  // install one shard's push
  struct ReplicaStats {
    long long hits = 0;       // rows served from the replica
    long long misses = 0;     // rows that had to go to the wire
    long long rows = 0;       // rows currently held
    long long refreshes = 0;  // RequestReplica round trips
  };
  ReplicaStats replica_stats() const;
  void OnClockInvalidate() override;  // clock boundary: replica is void
  // Capacity plane (docs/observability.md): resident bytes of the
  // replica side table (rows x cols floats + per-entry overhead) —
  // reported as its OWN field so fleet capacity math never counts a
  // replicated row into the table's shard bytes.
  int64_t replica_bytes() const;

 protected:
  void SendAggregate(const float* sum, int64_t n,
                     const AddOption& opt) override;
  int64_t rows_, cols_;
  int servers_;

 private:
  // The one sharded-send plan for AddAll and the aggregation flush.
  bool SendAddAll(const float* delta, const AddOption& opt, bool blocking);
  // AddRows' send plan: the single-shard borrowed fast path, the
  // multi-shard borrowed run-iovec path (docs/embedding.md), the
  // sparse-codec staging path, and the plain staging fallback.
  bool SendAddRows(const int32_t* row_ids, int64_t k, const float* delta,
                   const AddOption& opt, bool blocking);
  // THE one owner-partitioning plan for GetRows/GetRowsAsync: fills
  // `positions` (caller slots per shard), zero-fills the output (the
  // out-of-range-id contract), returns the per-shard requests.  Both
  // paths must stay in lockstep — a divergence here silently breaks
  // one of them.
  std::vector<MessagePtr> PlanRowsGet(
      const int32_t* row_ids, int64_t k, float* data,
      std::vector<std::vector<int64_t>>* positions);
  // GetRows' wire body (the pre-replica fetch path); GetRows itself now
  // serves replica hits first and routes only the remainder here.
  bool FetchRowsWire(const int32_t* row_ids, int64_t k, float* data);
  // Refresh the replica when the snapshot aged past -replica_lease_ms.
  void MaybeRefreshReplica();
  // Drop replica entries for rows this worker just added (belt to the
  // version gate's braces — the ack that would stale them may race a
  // concurrent read).
  void InvalidateReplicaRows(const int32_t* row_ids, int64_t k);

  struct ReplicaRow {
    int64_t version = 0;        // pushed bucket version at snapshot
    std::vector<float> data;    // cols_ floats
  };
  mutable Mutex replica_mu_;
  // capacity: replica_bytes() gauge — the "capacity" report's
  // worker.replica_bytes field (rows bounded at 4x topk x shards)
  std::unordered_map<int32_t, ReplicaRow> replica_ GUARDED_BY(replica_mu_);
  int64_t replica_ts_ms_ GUARDED_BY(replica_mu_) = -1;  // -1: never
  std::atomic<long long> replica_hits_{0};
  std::atomic<long long> replica_misses_{0};
  std::atomic<long long> replica_refreshes_{0};
};

// Sparse variant (SURVEY.md §2.13, table/sparse_matrix_table.h): the
// worker keeps a row cache — repeated GetRows of hot rows (LightLDA's
// access pattern) skip the wire until the row is invalidated by this
// worker's own Add or by a clock boundary (Zoo::Barrier), when peers'
// adds become visible.  Mirrors tables/sparse_matrix_table.py: a dense
// [rows, cols] mirror + validity bitmap, lazily allocated.
class SparseMatrixWorkerTable : public MatrixWorkerTable {
 public:
  using MatrixWorkerTable::MatrixWorkerTable;
  bool GetRows(const int32_t* row_ids, int64_t k, float* data) override;
  bool AddAll(const float* delta, const AddOption& opt,
              bool blocking) override;
  bool AddRows(const int32_t* row_ids, int64_t k, const float* delta,
               const AddOption& opt, bool blocking) override;
  void OnClockInvalidate() override;

 private:
  Mutex cache_mu_;
  std::vector<uint8_t> valid_ GUARDED_BY(cache_mu_);   // lazily rows_
  std::vector<float> mirror_ GUARDED_BY(cache_mu_);    // lazily rows_*cols_
  // Bumped by every invalidation (own add, clock).  GetRows releases
  // cache_mu_ for the wire fetch and installs the result only if the
  // epoch is unchanged — a fetch that raced an invalidation must not
  // resurrect pre-add values into the cache.
  uint64_t cache_epoch_ GUARDED_BY(cache_mu_) = 0;
};

// ------------------------------------------------------------------- KV
// Hash-map table, string key -> float value (SURVEY.md §2.14,
// table/kv_table.h: KVWorkerTable::{Get,Add,raw} / KVServerTable).
// Keys shard by a FIXED hash (FNV-1a — std::hash is implementation-
// defined and the partition contract must agree across processes).
// Wire: keys blob = concatenated (u32 len, bytes) entries;
//   Get  req: [keys]                 reply: [float vals, request order,
//                                            missing keys read 0]
//   Add  req: [AddOption][keys][float vals]
inline uint64_t KVHash(const char* s, size_t n) {
  uint64_t h = 1469598103934665603ull;          // FNV-1a 64
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(s[i]);
    h *= 1099511628211ull;
  }
  return h;
}

Blob PackKeys(const std::vector<std::string>& keys);
std::vector<std::string> UnpackKeys(const Blob& b);

class KVServerTable : public ServerTable {
 public:
  explicit KVServerTable(UpdaterType updater) : updater_(updater) {}
  void ProcessGet(const Message& req, Message* reply) override;
  void ProcessAdd(const Message& req) override;
  bool Store(Stream* out) const override;
  bool Load(Stream* in) override;
  std::vector<uint32_t> BucketChecksums() const override;
  void RecomputeCapacity() override;
  size_t size() const;

 private:
  void RecomputeCapacityLocked() REQUIRES(mu_);
  mutable Mutex mu_;
  std::unordered_map<std::string, float> data_ GUARDED_BY(mu_);
  std::unordered_map<std::string, float> slot0_ GUARDED_BY(mu_);  // slots
  UpdaterType updater_;
};

class KVWorkerTable : public WorkerTable {
 public:
  KVWorkerTable(int32_t table_id, int num_servers)
      : WorkerTable(table_id), servers_(num_servers) {}
  // vals[i] receives the value of keys[i] (0 when absent); refreshes
  // the local cache — the reference worker's `raw` dict.
  bool Get(const std::vector<std::string>& keys, float* vals);
  bool Add(const std::vector<std::string>& keys, const float* deltas,
           const AddOption& opt, bool blocking);
  // Worker-side cache of the last Get'd values (reference `raw()`).
  // By value, under the lock: the old by-reference accessor handed out
  // an unsynchronized view a concurrent Get could rehash under the
  // reader (the first hole `make analyze` flagged in this layer).
  std::unordered_map<std::string, float> raw() const {
    MutexLock lk(cache_mu_);
    return cache_;
  }
  // Capacity plane: resident bytes of the raw() mirror (keys + values
  // + the KV entry-overhead constant the server books use).
  int64_t cache_bytes() const {
    MutexLock lk(cache_mu_);
    int64_t bytes = 0;
    for (const auto& kv : cache_)
      bytes += static_cast<int64_t>(kv.first.size()) +
               static_cast<int64_t>(sizeof(float)) +
               capacity::kKVEntryOverhead;
    return bytes;
  }

 private:
  int servers_;
  mutable Mutex cache_mu_;
  // capacity: cache_bytes() rides the "capacity" report's worker object
  std::unordered_map<std::string, float> cache_ GUARDED_BY(cache_mu_);
};

}  // namespace mvtpu
