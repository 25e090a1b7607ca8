// Shard replication + lease-triggered failover (docs/replication.md).
//
// With `-replication_factor=1` every server shard gets a BACKUP rank
// (chained assignment: shard i's backup is server i+1 mod n).  The
// primary re-ships every applied add to its backup as a ReplForward —
// decoded payload, origin rank and audit stamp preserved — so the
// backup's shard bytes, per-bucket CRC beacons, and per-origin audit
// watermarks track the primary's.  `-repl_sync=true` (the default)
// parks the client's ReplyAdd until the backup's ReplAck lands: an
// ACKED add is by construction applied on BOTH replicas, which is what
// makes "zero lost acked adds" a structural property of failover
// rather than a replay protocol.  `-repl_sync=false` acks immediately
// and only bounds the forward/ack gap at `-repl_lag_max` (measured by
// the `repl.lag` histogram).
//
// On lease expiry (symmetric dead-peer detection — every rank watches
// every peer, not just rank 0) the backup PROMOTES: it installs its
// backup shard as the serving shard, bumps the fleet routing epoch,
// and broadcasts the new shard→rank map; workers re-route in-flight
// retries through Zoo::server_rank() without a fleet restart.  A new
// rank joins the serving set the same way: whole-shard catch-up
// (ShardSnapshot — Store/Load at a snapshot version, audit watermarks
// included) followed by the same delta forwarding — a join is just
// replication plus a routing-epoch flip.
//
// This header holds the arm latches, counters, and the in-memory
// Stream the snapshot path serializes through; the routing epoch,
// backup-table registry, and promotion state machine live in Zoo.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>

#include "mvtpu/stream.h"

namespace mvtpu {
namespace repl {

// Latched from -replication_factor at Zoo::Start (MV_SetReplication
// toggles live for armed-vs-disarmed overhead A/Bs).  One relaxed
// atomic load when off — the ProcessAdd hot path's only cost.
void Arm(bool on);
bool Armed();

// Latched from -repl_sync: park client acks until the backup acked.
void ArmSync(bool on);
bool Sync();

struct Stats {
  long long forwards = 0;    // ReplForwards shipped (primary side)
  long long acks = 0;        // ReplAcks received (primary side)
  long long applied = 0;     // forwarded deltas applied (backup side)
  long long parked = 0;      // client acks parked for sync replication
  long long lag_waits = 0;   // async-mode stalls at -repl_lag_max
  long long snapshots = 0;   // ShardSnapshots served (primary side)
  long long catchups = 0;    // snapshots installed (backup side)
  long long promotions = 0;  // shards this rank promoted into serving
  long long epoch_flips = 0; // RoutingEpoch broadcasts adopted
  long long dup_skips = 0;   // replayed stamped adds skipped as dups
};
Stats GetStats();
void NoteForward();
void NoteAck();
void NoteApplied();
void NoteParked();
void NoteLagWait();
void NoteSnapshot();
void NoteCatchup();
void NotePromotion();
void NoteEpochFlip();
void NoteDupSkip();
void ResetStats();  // test/bench isolation

// In-memory byte stream: the ShardSnapshot path runs ServerTable::
// Store/Load over the wire instead of the filesystem.
class MemStream : public Stream {
 public:
  MemStream() = default;
  explicit MemStream(std::string bytes) : buf_(std::move(bytes)) {}
  size_t Write(const void* p, size_t n) override {
    buf_.append(static_cast<const char*>(p), n);
    return n;
  }
  size_t Read(void* p, size_t n) override {
    size_t take = buf_.size() - pos_ < n ? buf_.size() - pos_ : n;
    std::memcpy(p, buf_.data() + pos_, take);
    pos_ += take;
    return take;
  }
  bool Good() const override { return true; }
  const std::string& bytes() const { return buf_; }

 private:
  std::string buf_;
  size_t pos_ = 0;
};

}  // namespace repl
}  // namespace mvtpu
