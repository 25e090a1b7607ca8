// Zoo — the runtime registry/singleton: owns the actors and the
// transport, routes messages, registers tables, answers barrier.
// Capability parity with include/multiverso/zoo.h (SURVEY.md §2.2, §3.1).
//
// Placement note (TPU-native design): the TPU data plane is XLA
// collectives over ICI/DCN (the Python/JAX layer); this native runtime is
// the HOST control/parity plane — a real actor pipeline with a real TCP
// transport (net.h).  With no machine file it runs the reference's
// Role::ALL single-process degenerate mode; with `-machine_file=F
// -rank=N` it becomes N cooperating processes: tables shard across the
// server roles (arrays by contiguous chunk, matrices by row block), the
// worker stubs partition requests per shard owner, and rank 0's
// controller answers the barrier — the reference's §3.1–§3.3 call stacks
// across OS processes.
#pragma once

#include <atomic>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "mvtpu/actor.h"
#include "mvtpu/mutex.h"
#include "mvtpu/net.h"
#include "mvtpu/table.h"

namespace mvtpu {

class Waiter;

// Defined in c_api.cc: drops un-waited MV_GetAsync* tickets.  Zoo::Stop
// calls it before clearing the table registry the tickets point into.
void CApiReclaimAsyncGets();

class Zoo {
 public:
  static Zoo* Get();

  // argc/argv parsed through configure; spawns actors (+ transport when a
  // machine file names more than one process); idempotent.
  bool Start(int argc, const char* const* argv);
  void Stop();
  bool started() const { return started_.load(); }

  int rank() const { return rank_; }
  int size() const { return size_; }
  // Active wire engine name ("tcp" | "epoll" | "mpi" | "uring"), or
  // "local" when this is a single process with no transport
  // (docs/transport.md).  This is the EFFECTIVE engine: when
  // `-net_engine=uring` was requested but the kernel cannot run it,
  // Start degrades to epoll and this reports "epoll" (the health
  // report's `engine_requested`/`engine_fallback` fields record the
  // downgrade).
  const char* net_engine() const;
  // Anonymous serve-tier fan-in counters — nonzero only on the epoll
  // engine, the one that accepts non-rank client connections.
  Net::FanInStats FanIn() const;
  // Role bitmasks (reference Role enum): 1 = worker, 2 = server.
  // Static (machine-file) mode gives every rank both roles; dynamic
  // registration (-controller_endpoint/-role) can create worker-only or
  // server-only processes — tables shard across SERVER ranks only.
  static constexpr int kRoleWorker = 1;
  static constexpr int kRoleServer = 2;
  int num_workers() const { return static_cast<int>(worker_ranks_.size()); }
  int num_servers() const { return static_cast<int>(server_ranks_.size()); }
  // Index among the worker/server ranks, or -1 when this rank lacks the
  // role (matches the reference's worker_id/server_id semantics).
  int worker_id() const { return IndexIn(worker_ranks_, rank_); }
  int server_id() const { return IndexIn(server_ranks_, rank_); }
  // shard index -> global rank translation for the table layer.  With
  // replication armed this consults the VERSIONED ROUTING TABLE
  // (docs/replication.md): promotion/join bump the routing epoch and
  // re-point shards, so every request minted after the flip routes to
  // the live owner — the pre-replication behavior (server_ranks_[idx])
  // is the epoch-0 route.
  int server_rank(int idx) const;
  // Inverse over the ORIGINAL (registration-time) shard assignment —
  // the fallback attribution for replies carrying no shard hint.
  int server_index(int rank) const { return IndexIn(server_ranks_, rank); }

  // ---- shard replication + failover (docs/replication.md) ------------
  // Monotonic fleet routing epoch (0 = the registration-time route).
  int64_t RoutingEpoch() const {
    return routing_epoch_.load(std::memory_order_acquire);
  }
  std::vector<int> RouteOwners() const;
  std::vector<int> RouteBackups() const;
  // The shard index this rank BACKS (chained: server j backs shard
  // j-1 mod n), or -1 when replication is off / this rank backs none.
  int BackupShard() const;
  // The serving table instance for an inbound data-plane message: this
  // rank's own shard unless the message's shard hint names the shard
  // this rank backs (hedged backup reads pre-promotion, all traffic
  // post-promotion).
  ServerTable* RoutedServerTable(const Message& msg);
  ServerTable* backup_table(int32_t id);
  // Forward an applied add to the shard's backup rank (ReplForward).
  // Sync mode parks `*reply` (the client's prepared ReplyAdd) until
  // the backup's ReplAck and returns true — the caller must NOT send
  // it; async mode stalls at `-repl_lag_max` outstanding forwards.
  bool ForwardAddToBackup(const Message& req, MessagePtr* reply);
  void OnReplForward(MessagePtr msg);   // backup side, server actor
  void OnReplAck(MessagePtr msg);       // primary side, transport thread
  void OnShardSnapshot(MessagePtr msg); // both sides, server actor
  void OnRoutingEpoch(MessagePtr msg);  // transport thread, max-merge
  // Promote this rank's backup shard into serving for every shard
  // `dead_rank` owns; bumps + broadcasts the routing epoch.  Returns
  // the number of shards promoted (0 = this rank backs none of them).
  int PromoteFor(int dead_rank);
  // Elastic join: become shard `shard_idx`'s backup — create backup
  // tables from the registration specs, announce (epoch flip), then
  // pull whole-shard catch-up snapshots; deltas stream in behind the
  // snapshot on the same connection (FIFO).  Blocking; idempotent
  // (chaos re-runs re-pull the snapshots).
  bool JoinAsBackup(int shard_idx);
  std::string OpsReplicationJson();  // the "replication" OpsQuery kind

  // Blocks until every rank arrived; false when `-barrier_timeout_ms`
  // (default: infinite) expired or the barrier authority is unreachable.
  // On timeout the error names the unresponsive rank(s): rank 0 lists
  // the ranks that never announced arrival; other ranks name rank 0
  // (the authority whose release never came).
  bool Barrier();

  // ---- heartbeat / lease (docs/fault_tolerance.md) --------------------
  // With `-heartbeat_ms > 0` and size > 1, every non-zero rank sends a
  // Heartbeat to rank 0 each interval; rank 0's lease loop marks a peer
  // dead after `-heartbeat_timeout_ms` of silence (default 5 intervals),
  // logging the rank and counting Dashboard `hb.missed` — the job
  // LEARNS about the corpse instead of discovering it by hanging.
  void OnHeartbeat(int src_rank);      // controller actor inbound
  int DeadPeerCount();                 // rank 0: currently-expired leases
  std::vector<int> DeadPeers();

  // SSP (bounded staleness, SURVEY.md §2.9-bis): advance this worker's
  // clock and announce it to every server shard (async, FIFO behind this
  // clock's adds).  With `-staleness=s`, a server holds a worker's Get
  // while that worker is more than s ticks ahead of the slowest worker —
  // s=0 degenerates to per-clock rendezvous on read (BSP reads without
  // a full barrier); jobs that never Clock() are unaffected.
  void Clock();
  int64_t clock() const { return clock_; }
  // Server side: true = the get was parked until the SSP bound allows it
  // (the caller's handler must return without serving).
  bool MaybeHoldGet(MessagePtr& msg);
  void OnClockTick(int src_rank, int64_t clock);

  // ---- introspection plane (docs/observability.md, mvtpu/ops.h) ------
  // This rank's health verdict / per-table stats as JSON (the "health" /
  // "tables" sections of an OpsQuery report).
  std::string OpsHealthJson();
  std::string OpsTablesJson();
  // Workload plane (docs/observability.md): per-table hot-key top-K,
  // bucket-load skew ratio, observed staleness, and update-health
  // sentinels — the "hotkeys" OpsQuery kind / MV_HotKeys payload.
  // id >= 0 restricts to one table.
  std::string OpsHotKeysJson(int32_t id = -1);
  // Delivery-audit plane (docs/observability.md "audit plane"): per
  // table, the worker-side acked-add ledger (sent/acked per shard
  // stream) and the server-side delivery book (per-origin applied
  // watermark, dup/reorder/gap anomalies, pending out-of-order ranges)
  // plus per-bucket content checksums — the "audit" OpsQuery kind.
  std::string OpsAuditJson();
  // Capacity plane (docs/observability.md "capacity plane"): host proc
  // stats, arena/write-queue/registered byte gauges, and per-table
  // resident bytes per bucket + the bounded load-history ring — the
  // "capacity" OpsQuery kind, and tools/mvplan.py's input shape.
  std::string OpsCapacityJson();
  // Exact byte-accounting resync over every table shard (primary AND
  // backup) — the re-arm hook behind MV_SetCapacityTracking(1): drift
  // from disarmed inserts heals the moment tracking turns back on.
  void RecomputeCapacityAll();
  // Run a fleet-scope aggregation SYNCHRONOUSLY from this rank (the
  // same bounded fan-out an inbound fleet OpsQuery triggers) — the
  // engine-agnostic entry point: on the blocking tcp engine, where no
  // anonymous scraper can connect, a rank can still assemble the fleet
  // view itself.  Single-process fleets report just this rank.
  std::string FleetReport(const std::string& kind);
  // OpsQuery routing (transport reader / reactor threads — NEVER the
  // actor mailbox, so a wedged server still answers its scrape).  Local
  // scope replies inline; fleet scope (version == 1) fans out to every
  // peer on a bounded detached thread (-ops_fleet_timeout_ms, capped by
  // -ops_inflight_max) and merges, marking silent ranks.
  void HandleOpsQuery(MessagePtr msg);
  void OnOpsReply(MessagePtr msg);   // fleet fan-out responses

  // ---- serve backpressure (docs/serving.md) ---------------------------
  // Current server-actor mailbox backlog (the inflight gauge MV_Serve-
  // QueueDepth exposes); 0 when the runtime is down.
  int ServeQueueDepth();
  // With `-server_inflight_max=N` > 0: when the backlog still queued
  // behind the request being processed reaches N, answer `msg` with a
  // retryable ReplyBusy (no table work) and return true.  Gets and
  // version probes only — adds are never shed ("no lost adds").
  bool ShedIfOverloaded(MessagePtr& msg);
  // Tail plane (docs/serving.md "tail"): true when `msg` is a read
  // that was hedge-cancelled or is past its propagated deadline — the
  // caller drops it at dequeue (counted serve.hedge.cancelled /
  // serve.deadline.shed; an anonymous client's reactor admission slots
  // settle through the transport).  Reads only — never call for adds.
  bool DropServeRead(MessagePtr& msg);

  // Deliver to a LOCAL actor's mailbox.
  void SendTo(const std::string& actor_name, MessagePtr msg);

  // Deliver to msg->dst's `actor_name` actor — local mailbox when dst is
  // this rank (or unset), the TCP transport otherwise (the Communicator
  // routing of SURVEY.md §2.6; inbound routing is RouteInbound).
  void Deliver(const std::string& actor_name, MessagePtr msg);

  int64_t NextMsgId() { return next_msg_id_.fetch_add(1); }

  // ---- table registry -------------------------------------------------
  int32_t RegisterArrayTable(int64_t size);
  int32_t RegisterMatrixTable(int64_t rows, int64_t cols);
  int32_t RegisterSparseMatrixTable(int64_t rows, int64_t cols);

 private:
  template <typename WorkerT>
  int32_t RegisterMatrixTableImpl(int64_t rows, int64_t cols);

  // Registration-time shape record: backup shards (chained at
  // registration or created by a live JoinAsBackup) are built from the
  // same spec with the PRIMARY's shard index, so ShardOf ranges agree.
  struct TableSpec {
    enum Kind { kArray, kMatrix, kSparseMatrix, kKV };
    Kind kind;
    int64_t rows = 0, cols = 0;
  };
  std::unique_ptr<ServerTable> MakeShard(const TableSpec& spec, int sid,
                                         int nservers);
  // Append the spec + (when replication is armed) the chained backup
  // instance for one newly registered table.  Caller holds tables_mu_.
  void RegisterBackupShard(const TableSpec& spec) REQUIRES(tables_mu_);

 public:
  int32_t RegisterKVTable();
  ServerTable* server_table(int32_t id);
  WorkerTable* worker_table(int32_t id);
  ArrayWorkerTable* array_worker(int32_t id);
  MatrixWorkerTable* matrix_worker(int32_t id);
  KVWorkerTable* kv_worker(int32_t id);

  UpdaterType updater_type() const { return updater_type_; }

  // ---- barrier plumbing (internal) ------------------------------------
  // Arrive/release messages carry a per-rank ROUND number (msg_id):
  // after a timed-out round k, a late round-k release must not free the
  // retry's round-k+1 waiter.  round = -1 forces the release (local
  // failure paths that already latched barrier_failed_).
  void OnBarrierArrive(int src_rank, int64_t round);
  void OnBarrierRelease(int64_t round = -1);
  void OnFlushReply(int64_t msg_id);    // per-server flush ack

 private:
  Zoo() = default;

  static int IndexIn(const std::vector<int>& v, int rank) {
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i] == rank) return static_cast<int>(i);
    return -1;
  }

  void SetRoles(const std::vector<int>& roles);

  // Blocking: one RequestFlush per remote server shard, acked when that
  // server drained every earlier message on the same connection.
  // Always drains the add-aggregation buffers first (the flush marker
  // must ride behind the adds it certifies).
  bool FlushPipelines();

 public:
  // Drain every worker table's add-aggregation buffer onto the wire
  // (docs/wire_compression.md).  Called by FlushPipelines/Clock/Stop
  // and the MV_FlushAdds C API.
  void FlushWorkerAdds();

 private:

  void RouteInbound(Message&& m);       // transport reader threads

  // Atomic, not GUARDED_BY(mu_): started() is the C-API fast-path gate
  // (RequireStarted) and must not contend with Start/Stop.  It doubles
  // as the Stop latch — the first Stop flips it under mu_ and later
  // Stops return without touching the half-torn-down actors.
  std::atomic<bool> started_{false};
  Mutex mu_;              // lifecycle (Start/Stop) + actor pointers
  Mutex tables_mu_;       // table registry — actors query it mid-Stop, so
                          // it must never be held across a thread join
  std::atomic<int64_t> next_msg_id_{0};
  UpdaterType updater_type_ = UpdaterType::kDefault;

  // Phase-stable state (rank_, size_, role rank lists, net_,
  // updater_type_): written once during Start and cleared by the one
  // Stop that wins the started_ latch, both under mu_; every other
  // reader runs between Start and Stop where the values are immutable.
  // Deliberately NOT GUARDED_BY(mu_) — the hot paths (Deliver, shard
  // math, barrier fan-out) read them lock-free, and net_->Send must not
  // run under mu_ anyway.  The analyze build checks the mutex-guarded
  // state below; this block's discipline is the started_ protocol.
  int rank_ = 0;
  int size_ = 1;
  std::vector<int> worker_ranks_{0};   // ranks holding the worker role
  std::vector<int> server_ranks_{0};   // ranks holding the server role
  std::unique_ptr<Net> net_;  // TcpNet or MpiNet, per -net_type
  // Engine-degradation record (health plane): what `-net_engine` asked
  // for and whether Start had to fall back (uring probe failure →
  // epoll).  Set once in Start, read by OpsHealthJson.
  std::string engine_requested_;
  bool engine_fallback_ = false;

  std::unique_ptr<Actor> worker_actor_ GUARDED_BY(mu_);
  std::unique_ptr<Actor> server_actor_ GUARDED_BY(mu_);
  std::unique_ptr<Actor> controller_actor_ GUARDED_BY(mu_);

  std::vector<std::unique_ptr<ServerTable>> server_tables_
      GUARDED_BY(tables_mu_);
  std::vector<std::unique_ptr<WorkerTable>> worker_tables_
      GUARDED_BY(tables_mu_);

  // Barrier state: one outstanding barrier per rank; rank 0 tracks
  // arrivals PER RANK (a retry after an abandoned round must not double
  // count toward the quorum).  barrier_failed_ latches transport
  // failures so Barrier() reports them instead of a false release.
  // barrier_round_ is this rank's current round; barrier_rounds_ is the
  // rank-0 authority's record of each rank's latest announced round
  // (echoed in the release so stale releases are droppable).
  Mutex barrier_mu_;
  std::shared_ptr<Waiter> barrier_waiter_ GUARDED_BY(barrier_mu_);
  std::vector<bool> barrier_arrived_ GUARDED_BY(barrier_mu_);
  bool barrier_failed_ GUARDED_BY(barrier_mu_) = false;
  int64_t barrier_round_ GUARDED_BY(barrier_mu_) = 0;
  std::vector<int64_t> barrier_rounds_ GUARDED_BY(barrier_mu_);

  // SSP state: this rank's worker clock; server-side per-rank clock
  // vector + the gets parked until the staleness bound admits them.
  // Parks carry a deadline (rpc_timeout_ms at park time): a dead
  // straggler whose clock never advances must not grow held_gets_
  // without bound, so every park/tick event purges expired entries and
  // fails them fast with ReplyError (the caller sees rc=-3).
  std::atomic<int64_t> clock_{0};
  Mutex ssp_mu_;
  std::vector<int64_t> worker_clocks_ GUARDED_BY(ssp_mu_);
  std::vector<std::pair<int64_t, MessagePtr>> held_gets_
      GUARDED_BY(ssp_mu_);  // (deadline_ms, parked get)
  // Moves expired parks out for fail-fast replies.
  void PurgeExpiredHeldLocked(std::vector<MessagePtr>* expired)
      REQUIRES(ssp_mu_);
  void FailHeldGets(std::vector<MessagePtr> expired);
  bool HeldBySspLocked(int src) REQUIRES(ssp_mu_);  // admission predicate

  // Outstanding pipeline flushes (msg_id → waiter); acks notify under
  // flush_mu_ so a timed-out flush cannot race its waiter's teardown.
  Mutex flush_mu_;
  // mvlint: MV018-exempt(one waiter per outstanding FlushPipelines
  // round — bounded by caller concurrency, acks/timeouts drain it)
  std::unordered_map<int64_t, std::shared_ptr<Waiter>> flush_pending_
      GUARDED_BY(flush_mu_);

  // Fleet-scope OpsQuery state: msg_id -> collected per-rank payloads.
  // Fan-out threads are detached but counted (ops_inflight_); Stop
  // drains the counter bounded before tearing the transport down.
  struct OpsPending;
  void FleetOpsThread(int64_t id, Message query);
  // The shared fan-out+merge body of FleetOpsThread and FleetReport:
  // sends local-scope sub-queries under `id`, waits out the bounded
  // deadline, merges (rank labels / JSON ranks map, silent + dead
  // ranks explicit) and returns the report text.
  std::string FleetCollect(const std::string& kind, int64_t trace_id,
                           int64_t id);
  Mutex ops_mu_;
  // mvlint: MV018-exempt(bounded by -ops_inflight_max concurrent fleet
  // queries; the deadline wait erases each entry)
  std::unordered_map<int64_t, std::shared_ptr<OpsPending>> ops_pending_
      GUARDED_BY(ops_mu_);
  std::atomic<int> ops_inflight_{0};
  // Shed-storm detector (-shed_storm_threshold): consecutive sheds.
  std::atomic<long long> shed_streak_{0};
  std::atomic<bool> shed_storm_latched_{false};

  // Heartbeat/lease state.  The loop thread is started by Start (when
  // enabled) and joined by the Stop latch winner before actors die.
  // SYMMETRIC (docs/replication.md): every rank renews to every peer
  // and every rank scans its own lease table — a backup can trigger
  // promotion even when the corpse is rank 0 itself.
  void HeartbeatLoop();
  std::thread hb_thread_;
  std::atomic<bool> hb_running_{false};
  Mutex hb_mu_;
  std::vector<int64_t> hb_last_seen_ GUARDED_BY(hb_mu_);  // ms, all ranks
  std::vector<bool> hb_dead_ GUARDED_BY(hb_mu_);

  // ---- shard replication + failover state (docs/replication.md) ------
  // Versioned routing table: shard idx -> serving rank / backup rank.
  // Initialized from server_ranks_ at Start (epoch 0); promotion and
  // elastic joins mutate it under route_mu_ and broadcast the new map
  // tagged with the bumped epoch (receivers max-merge).
  std::atomic<int64_t> routing_epoch_{0};
  mutable Mutex route_mu_;
  std::vector<int> route_owner_ GUARDED_BY(route_mu_);
  std::vector<int> route_backup_ GUARDED_BY(route_mu_);
  int backup_shard_ GUARDED_BY(route_mu_) = -1;  // shard this rank backs
  std::vector<bool> promoted_ GUARDED_BY(route_mu_);  // by shard idx
  // Backup shard instances, parallel to server_tables_ (nullptr when
  // this rank backs nothing / the table predates a join).
  std::vector<std::unique_ptr<ServerTable>> backup_tables_
      GUARDED_BY(tables_mu_);
  std::vector<TableSpec> table_specs_ GUARDED_BY(tables_mu_);
  // Sync replication: client acks parked until the backup's ReplAck
  // (fwd msg_id -> prepared ReplyAdd), deadline-bounded so a dying
  // backup degrades to async acking instead of wedging clients.
  Mutex repl_mu_;
  struct ParkedAck {
    int64_t deadline_ms;
    MessagePtr reply;
  };
  // mvlint: MV018-exempt(deadline-bounded: ReleaseParkedAcks sweeps
  // expired parks every lease tick; outstanding count rides repl stats)
  std::unordered_map<int64_t, ParkedAck> parked_acks_ GUARDED_BY(repl_mu_);
  std::atomic<long long> repl_outstanding_{0};
  // Catch-up rendezvous: ShardSnapshot request msg_id -> waiter.
  // mvlint: MV018-exempt(one waiter per in-flight catch-up pull —
  // bounded by shard count, drained on reply/timeout)
  std::unordered_map<int64_t, std::shared_ptr<Waiter>> snapshot_pending_
      GUARDED_BY(repl_mu_);
  // Collision-free epoch allocation: epochs advance in strides of
  // kEpochStride with the bumping rank in the low bits, so two ranks
  // reacting to the same failure concurrently (a promotion here, a
  // backup-drop there) can never mint EQUAL epochs that then reject
  // each other's broadcast — the ordering is total and rank-salted.
  static constexpr int64_t kEpochStride = 1024;
  int64_t NextEpochLocked() REQUIRES(route_mu_) {
    int64_t e = (routing_epoch_.load(std::memory_order_relaxed) /
                     kEpochStride +
                 1) *
                    kEpochStride +
                rank_;
    routing_epoch_.store(e, std::memory_order_release);
    return e;
  }
  // Broadcast the current route map under `epoch` to every peer.
  void BroadcastRoutingEpoch(int64_t epoch, const std::vector<int>& owners,
                             const std::vector<int>& backups);
  // Drop serve-layer caches on a route flip (the epoch's clock-boundary
  // analog): snapshot under tables_mu_, invalidate outside it.
  void InvalidateWorkerCaches();
  // Release parked sync acks whose deadline passed (or all of them,
  // when the backup's lease expired) — the client must not wedge on a
  // dead backup; replication degrades, it never blocks the primary.
  void ReleaseParkedAcks(bool all);
  // Lease-expiry reaction: promote if the corpse owned our backed
  // shard; stop forwarding to it if it was our backup.
  void OnPeerDead(int rank);
};

}  // namespace mvtpu
