#include "mvtpu/configure.h"

#include <map>
#include <mutex>
#include <stdexcept>

#include "mvtpu/mutex.h"

namespace mvtpu {
namespace configure {

namespace {

enum class Kind { kBool, kInt, kDouble, kString };

struct Flag {
  Kind kind;
  std::string value;
  std::string dflt;
  std::string help;
};

Mutex g_mu;

// The registry map lives behind a function-local static (first use may
// precede any other global's ctor); REQUIRES is the enforcement point —
// the map itself is only reachable through these two accessors.
std::map<std::string, Flag>& Registry() REQUIRES(g_mu) {
  static std::map<std::string, Flag> r;
  return r;
}

void Define(const std::string& name, Kind kind, const std::string& dflt,
            const std::string& help) {
  MutexLock lk(g_mu);
  Registry()[name] = Flag{kind, dflt, dflt, help};
}

Flag& Find(const std::string& name) REQUIRES(g_mu) {
  auto it = Registry().find(name);
  if (it == Registry().end())
    throw std::invalid_argument("unknown flag: " + name);
  return it->second;
}

void Validate(Kind kind, const std::string& value) {
  size_t pos = 0;
  switch (kind) {
    case Kind::kBool:
      if (value != "true" && value != "false" && value != "1" && value != "0")
        throw std::invalid_argument("bad bool: " + value);
      break;
    case Kind::kInt:
      (void)std::stoll(value, &pos);
      if (pos != value.size()) throw std::invalid_argument("bad int: " + value);
      break;
    case Kind::kDouble:
      (void)std::stod(value, &pos);
      if (pos != value.size())
        throw std::invalid_argument("bad double: " + value);
      break;
    case Kind::kString:
      break;
  }
}

}  // namespace

void DefineBool(const std::string& n, bool d, const std::string& h) {
  Define(n, Kind::kBool, d ? "true" : "false", h);
}
void DefineInt(const std::string& n, long long d, const std::string& h) {
  Define(n, Kind::kInt, std::to_string(d), h);
}
void DefineDouble(const std::string& n, double d, const std::string& h) {
  Define(n, Kind::kDouble, std::to_string(d), h);
}
void DefineString(const std::string& n, const std::string& d,
                  const std::string& h) {
  Define(n, Kind::kString, d, h);
}

bool GetBool(const std::string& n) {
  MutexLock lk(g_mu);
  const std::string& v = Find(n).value;
  return v == "true" || v == "1";
}
long long GetInt(const std::string& n) {
  MutexLock lk(g_mu);
  return std::stoll(Find(n).value);
}
double GetDouble(const std::string& n) {
  MutexLock lk(g_mu);
  return std::stod(Find(n).value);
}
std::string GetString(const std::string& n) {
  MutexLock lk(g_mu);
  return Find(n).value;
}

bool Has(const std::string& n) {
  MutexLock lk(g_mu);
  return Registry().count(n) > 0;
}

void Set(const std::string& n, const std::string& value) {
  MutexLock lk(g_mu);
  Flag& f = Find(n);
  Validate(f.kind, value);
  f.value = value;
}

int ParseCmdFlags(int argc, const char* const* argv) {
  int parsed = 0;
  for (int i = 0; i < argc; ++i) {
    std::string a = argv[i] ? argv[i] : "";
    if (a.rfind("--", 0) == 0) a = a.substr(2);
    else if (a.rfind("-", 0) == 0) a = a.substr(1);
    else continue;  // non-flag argv entries are ignored (reference behavior)
    auto eq = a.find('=');
    if (eq == std::string::npos) continue;
    try {
      Set(a.substr(0, eq), a.substr(eq + 1));
      ++parsed;
    } catch (const std::invalid_argument&) {
      return -1;
    }
  }
  return parsed;
}

void Reset() {
  MutexLock lk(g_mu);
  for (auto& kv : Registry()) kv.second.value = kv.second.dflt;
}

// Contract-checked: tools/mvcontract.py (`make contract`) diffs these
// registrations against config.py and the docs/*.md flag tables — a
// flag shared with the Python plane must keep the same default.
void RegisterDefaults() {
  static std::once_flag once;
  std::call_once(once, [] {
    DefineBool("sync", false, "BSP (true) vs ASP (false) training");
    DefineString("updater_type", "default",
                 "default|sgd|adagrad|momentum|smooth_gradient|assign "
                 "(assign: w = delta, last-write-wins — the offload "
                 "bridge's bit-exact remote store, docs/host_bridge.md)");
    DefineString("machine_file", "",
                 "host:port per line; >1 line enables the TCP transport");
    DefineString("net_type", "tcp",
                 "tcp|mpi — wire transport (reference net.h NetLib). mpi "
                 "dlopen's libmpi: rank/size come from MPI (mpirun for "
                 ">1 node; isolated singleton otherwise), no machine "
                 "file needed");
    DefineString("net_engine", "epoll",
                 "tcp|epoll|mpi|uring — readiness model of the wire "
                 "transport (docs/transport.md).  epoll (default): one "
                 "event-loop reactor (plus -net_threads shards) drives "
                 "nonblocking sockets and accepts ANONYMOUS serve "
                 "clients; tcp: the blocking thread-per-connection "
                 "engine; mpi: the literal MPI wire (same as "
                 "-net_type=mpi); uring: the io_uring completion "
                 "engine — registered-buffer zero-copy receive, "
                 "zero-copy sends, multishot accept; degrades to epoll "
                 "(logged, health `effective_engine`) when the kernel "
                 "lacks io_uring");
    DefineInt("net_threads", 1,
              "epoll engine: number of reactor shards (event-loop "
              "threads); connections round-robin across them.  1 "
              "(default) is right below ~10k connections");
    DefineInt("net_arena_bytes", 262144,
              "epoll engine: receive-arena slab size per connection; "
              "frames assemble in the slab and decode zero-copy "
              "(Blob views).  Larger frames allocate exactly; smaller "
              "ones pack and the slab recycles once no view is alive");
    DefineInt("net_writeq_bytes", 67108864,
              "epoll engine: per-connection write-queue bound.  A slow "
              "reader fills it; senders then wait for drain up to "
              "-io_timeout_ms (the readiness-model twin of SO_SNDTIMEO) "
              "instead of ballooning memory.  <=0 unbounded");
    DefineInt("uring_depth", 256,
              "uring engine: submission-queue entries per reactor shard "
              "(clamped 8..4096; CQ sized 4x).  The depth bounds "
              "in-flight SQEs, not connections — a full SQ flushes and "
              "retries");
    DefineBool("uring_sqpoll", false,
               "uring engine: IORING_SETUP_SQPOLL — a kernel thread "
               "polls the submission queue, removing the submit syscall "
               "from the send path at the cost of a busy kernel thread "
               "per shard (needs CAP_SYS_NICE on older kernels; setup "
               "failure falls back to plain submission)");
    DefineInt("uring_reg_bufs", 16,
              "uring engine: fixed receive buffers registered with the "
              "kernel per shard (each -net_arena_bytes big, carved from "
              "the host arena).  Frames landing in one decode zero-copy "
              "end to end; 0 disables registration (heap fallback "
              "only).  Clamped 0..1024");
    DefineInt("uring_zc_bytes", 65536,
              "uring engine: frames with at least this many bytes left "
              "to send go out IORING_OP_SENDMSG_ZC (pages pinned until "
              "the kernel's notif completion) instead of a copying "
              "send.  <0 disables zero-copy sends");
    DefineInt("client_inflight_max", 64,
              "epoll engine: per-anonymous-client admission on top of "
              "-server_inflight_max — a client with this many "
              "unanswered Gets/probes is shed with ReplyBusy at the "
              "reactor, before the actor mailbox.  Adds are never "
              "shed.  <=0 disables");
    DefineInt("rank", 0, "this process's line index in machine_file");
    DefineString("controller_endpoint", "",
                 "dynamic registration: rank 0's host:port (no machine "
                 "file / -rank needed; reference Control_Register)");
    DefineBool("is_controller", false,
               "this process IS the registration controller (rank 0)");
    DefineInt("num_nodes", 0, "dynamic registration: total process count");
    DefineString("role", "all", "worker|server|all — this node's roles");
    DefineString("node_host", "127.0.0.1",
                 "dynamic registration: address peers reach this node at");
    DefineInt("port", 55555, "base port (transport parity flag)");
    DefineDouble("backup_worker_ratio", 0.0,
                 "sync-plane straggler slack: clock t counts as reached "
                 "once ceil((1-ratio)*workers) ticked it; the slowest "
                 "floor(ratio*workers) cannot park reads (their late "
                 "adds fold into the open clock)");
    DefineInt("staleness", 0,
              "SSP bound: a worker's Get is held while it runs more than "
              "this many MV_Clock() ticks ahead of the slowest worker "
              "(0 = per-clock rendezvous on read; clocks start equal so "
              "jobs that never call MV_Clock are unaffected)");
    DefineInt("rpc_timeout_ms", 30000,
              "blocking Get/Add deadline; <=0 waits forever");
    DefineInt("connect_retry_ms", 15000,
              "per-destination connect retry budget");
    DefineInt("barrier_timeout_ms", 0,
              "barrier deadline; <=0 (default) waits forever (BSP)");
    DefineInt("io_timeout_ms", 30000,
              "per-socket send deadline + mid-frame recv deadline: a "
              "peer that wedges mid-message errors out instead of "
              "parking the thread; <=0 disables");
    DefineInt("send_retries", 2,
              "bounded wire-send retries after a failed write "
              "(reconnect between attempts); 0 fails on first error");
    DefineInt("send_backoff_ms", 50,
              "base exponential backoff between send retries");
    DefineInt("heartbeat_ms", 0,
              "liveness lease interval: non-zero ranks announce to "
              "rank 0 every interval, rank 0 reports silent peers "
              "(Dashboard hb.missed); 0 (default) disables");
    DefineInt("heartbeat_timeout_ms", 0,
              "lease expiry; <=0 derives 5*heartbeat_ms");
    DefineInt("server_inflight_max", 0,
              "serve backpressure (docs/serving.md): when the server "
              "actor's mailbox backlog reaches this, incoming Gets and "
              "version probes are shed with a retryable ReplyBusy (C "
              "API rc -6) instead of growing the queue; adds are never "
              "shed.  0 (default) disables shedding");
    DefineString("wire_codec", "raw",
                 "payload codec for table wire traffic "
                 "(docs/wire_compression.md): raw|1bit|sparse.  1bit "
                 "ships dense adds as sign bits + two scales with "
                 "worker-side error feedback (~32x fewer payload "
                 "bytes); sparse ships nonzero (index,value) pairs "
                 "losslessly, falling back to raw per message when not "
                 "smaller.  Negotiated per table at creation; "
                 "MV_SetTableCodec retargets one table");
    DefineInt("add_agg_ms", 0,
              "worker-side add aggregation window (ms): async dense "
              "adds within the window sum locally and ship as ONE "
              "codec-encoded wire message.  Flushed by the window "
              "(checked at the next table op), -add_agg_bytes, any "
              "Get, blocking Add, Clock, Barrier, and shutdown — "
              "BSP/SSP visibility is unchanged.  0 (default) with "
              "add_agg_bytes=0 disables aggregation");
    DefineInt("add_agg_bytes", 0,
              "worker-side add aggregation size bound: flush once the "
              "absorbed payload bytes (adds x delta size) reach this. "
              "0 (default) with add_agg_ms=0 disables aggregation");
    DefineString("log_level", "info", "debug|info|error|fatal");
    DefineString("log_file", "", "optional log sink path");
    DefineBool("trace", false,
               "record per-op spans (worker Get/Add, server apply, wire "
               "send) with cross-rank trace ids; dump via MV_DumpSpans "
               "(docs/observability.md)");
    DefineString("trace_dir", "",
                 "introspection output dir (docs/observability.md): the "
                 "flight recorder dumps blackbox_rank<r>.json here on "
                 "failure triggers (barrier timeout, dead peer, shed "
                 "storm).  Empty (default) disables dumps; events still "
                 "accumulate in the in-memory ring");
    DefineInt("blackbox_events", 512,
              "flight-recorder ring capacity (lifecycle events kept in "
              "memory; dumped with recent spans + monitor totals on a "
              "trigger)");
    DefineInt("ops_fleet_timeout_ms", 2000,
              "fleet-scope OpsQuery fan-out deadline: rank answers with "
              "whatever peers replied by then, explicitly marking the "
              "silent ranks instead of hanging the scraper");
    DefineInt("ops_inflight_max", 4,
              "concurrent fleet-scope OpsQuery aggregations; excess "
              "queries are answered with a busy error document instead "
              "of spawning unbounded fan-out threads");
    DefineBool("hotkey_enabled", true,
               "workload observability (docs/observability.md): per-table "
               "hot-key sketches (space-saving top-K + count-min), "
               "per-bucket get/add load counters, observed-staleness "
               "histogram, and add L2/Linf + NaN/Inf health sentinels in "
               "the server hot path.  false compiles every hook down to "
               "one relaxed atomic check (MV_SetHotKeyTracking toggles "
               "live for A/B overhead measurement)");
    DefineBool("capacity_enabled", true,
               "capacity plane (docs/observability.md \"capacity "
               "plane\"): per-table resident-byte accounting (matrix "
               "rows, KV entries + key bytes, array spans) per bucket "
               "and per shard, recomputed incrementally on the hot "
               "path.  false compiles every growth hook down to one "
               "relaxed atomic check; MV_SetCapacityTracking toggles "
               "live (re-arming resyncs every shard exactly)");
    DefineInt("capacity_history_ms", 250,
              "minimum interval between capacity load-history windows: "
              "each \"capacity\" scrape at least this far from the "
              "last appends one (ts, gets, adds, bytes, per-bucket "
              "load) window to the bounded 64-window ring, so one "
              "scrape yields per-bucket load RATES (the placement "
              "advisor's input).  <= 0 records every scrape");
    DefineInt("hotkey_topk", 16,
              "capacity of the space-saving top-K hot-key sketch per "
              "server table (memory bound: this many monitored keys; "
              "every true heavy hitter with frequency > total/K is "
              "guaranteed monitored)");
    DefineBool("hotkey_replica", false,
               "hot-key read replica (docs/embedding.md): matrix worker "
               "stubs keep a side table of the servers' pushed "
               "SpaceSaving top-K rows and serve GetRows hits from it "
               "before the wire; invalidation rides the version-stamp "
               "protocol (an entry older than last_version - "
               "-replica_max_staleness misses).  Requires "
               "-hotkey_enabled (the push IS the top-K sketch); "
               "MV_SetHotKeyReplica toggles live");
    DefineInt("replica_lease_ms", 50,
              "hot-key replica snapshot lease: GetRows refreshes the "
              "pushed row set (one RequestReplica round trip per shard) "
              "once the snapshot ages past this; entries are never "
              "served from a snapshot older than the lease");
    DefineInt("replica_max_staleness", 0,
              "version distance a replica-served row may be behind the "
              "last observed apply (the worker's reply-stamp ledger); "
              "0 = a row older than ANY later observed add misses — "
              "staleness-0 reads after an acked add always refetch");
    DefineBool("arena_pin", true,
               "host bridge (docs/host_bridge.md): mlock(2) HostArena "
               "buffers so the scatter-gather send path never page-"
               "faults mid-write.  Best-effort — RLIMIT_MEMLOCK misses "
               "are counted in MV_ArenaStats, not fatal");
    DefineBool("wire_timing", true,
               "latency attribution (docs/observability.md): stamp a "
               "48-byte TimingTrail into request/reply wire headers "
               "(client enqueue/send, server recv/dequeue/apply_done/"
               "reply_send) and fold replies into lat.stage.* "
               "histograms + the per-peer NTP-style clock-offset "
               "estimator.  Version-tolerant: peers that never stamp "
               "are parsed exactly as before.  MV_SetWireTiming "
               "toggles live (the overhead A/B)");
    DefineInt("profile_hz", 0,
              "boot the SIGPROF sampling profiler at this rate "
              "(CPU-time sampling; folded stacks via MV_ProfilerDump "
              "land in the Chrome trace beside spans).  0 (default) "
              "boots disarmed; MV_SetProfiler toggles live.  97 Hz is "
              "the house rate — prime, so it cannot phase-lock with "
              "millisecond-periodic work");
    DefineInt("watchdog_stall_ms", 0,
              "stall watchdog (docs/observability.md \"health "
              "plane\"): flag any critical loop (epoll reactor "
              "shards, actors, heartbeat scan, host metrics flusher) "
              "that makes zero progress for this long while work is "
              "queued — dumps profiler folded stacks + a 'stall:' "
              "blackbox and bumps watchdog.stalls.  0 (default) "
              "disarms (every Bump is one relaxed load); must exceed "
              "the slowest legitimate loop period.  MV_SetWatchdog "
              "toggles live");
    DefineBool("audit", true,
               "delivery-audit plane (docs/observability.md \"audit "
               "plane\"): stamp every Add with a per-(worker, table, "
               "shard) seq range behind a wire flag, keep client "
               "acked-add ledgers + server per-origin applied "
               "watermarks with dup/reorder/gap anomaly rings, and "
               "serve the \"audit\" OpsQuery kind.  false compiles "
               "every site down to one relaxed atomic load "
               "(MV_SetAudit toggles live — the overhead A/B)");
    DefineInt("replication_factor", 0,
              "shard replication (docs/replication.md): 0 (default) = "
              "off — a dead server rank is fatal for its shard; 1 = "
              "every shard gets a backup rank (chained: shard i's "
              "backup is server i+1 mod n) fed by a primary->backup "
              "ReplForward delta stream, with lease-triggered "
              "promotion and routing-epoch re-pointing on failure");
    DefineBool("repl_sync", true,
               "sync replication: park the client's add ack until the "
               "backup's ReplAck, so \"acked\" means applied on BOTH "
               "replicas — zero lost acked adds across a failover by "
               "construction.  false = ack immediately and only bound "
               "the forward/ack gap at -repl_lag_max (faster, a "
               "just-acked add can die with the primary)");
    DefineInt("repl_lag_max", 64,
              "async replication lag bound: with -repl_sync=false, "
              "stall the apply path while this many forwards are "
              "unacked by the backup (measured by the repl.lag "
              "histogram; <=0 = unbounded)");
    DefineBool("promote_auto", true,
               "lease-triggered promotion: when a watched peer's "
               "heartbeat lease expires and this rank backs a shard "
               "the corpse owned, promote it automatically (false = "
               "operator-driven via MV_PromoteBackup / MsgType::"
               "Promote only)");
    DefineInt("audit_grace_ms", 2000,
              "delivery-audit gap grace window: an out-of-order "
              "pending range older than this fires the audit_gap "
              "flight-recorder trigger (a benign reorder drains in "
              "round-trip time; a real loss never does)");
    DefineInt("audit_ring", 64,
              "delivery-audit anomaly ring capacity per server table "
              "(recent dup/reorder/gap records with their seq ranges "
              "and origins, served in the \"audit\" report)");
    DefineInt("blackbox_keep", 4,
              "flight-recorder dump rotation: keep this many "
              "timestamped blackbox_rank<r>.<ts>.json archives per "
              "rank beside the canonical latest dump (a second "
              "trigger no longer overwrites the first dump's "
              "evidence); a manifest lists the retained dumps");
    DefineString("qos_classes", "bulk:1,gold:8",
                 "tail-at-scale QoS (docs/serving.md \"tail\"): tenant "
                 "classes and weights, 'name:weight,...'.  Class ids on "
                 "the wire are POSITIONAL indices into this list (both "
                 "sides must agree, like codec negotiation); weights "
                 "split -qos_inflight_max into guaranteed per-class "
                 "read budgets and set the borrow ratio for spare "
                 "capacity");
    DefineInt("qos_inflight_max", 0,
              "per-class weighted admission over anonymous serve reads "
              "at the reactor: total inflight read slots split across "
              "-qos_classes by weight (deficit-round-robin borrowing "
              "of spare capacity); a class at its share answers "
              "ReplyBusy while other classes keep flowing.  Adds and "
              "flushes are never shed.  0 (default) disables the gate "
              "(per-class counters still accrue)");
    DefineString("qos_class", "bulk",
                 "the tenant class THIS process's worker requests "
                 "declare in their QoS wire stamp (a name from "
                 "-qos_classes; unknown names map to class 0)");
    DefineBool("wire_deadline", true,
               "deadline propagation (docs/serving.md \"tail\"): stamp "
               "worker requests with their remaining -rpc_timeout_ms "
               "budget behind a version-tolerant wire flag; receivers "
               "drop a read already past its deadline at dequeue "
               "(serve.deadline.shed) instead of burning an apply slot. "
               "Adds are never deadline-shed.  false stamps nothing");
    DefineBool("replica_serve_reactor", true,
               "answer ANONYMOUS hot-key replica pulls (RequestReplica) "
               "at the epoll reactor instead of the actor mailbox — a "
               "bounded snapshot read under the shard lock, so a hedged "
               "read can win against a straggling apply clogging the "
               "mailbox (docs/serving.md \"tail\").  Rank-peer replica "
               "refreshes keep the mailbox path either way");
    DefineInt("shed_storm_threshold", 0,
              "flight-recorder trigger: this many CONSECUTIVE busy-sheds "
              "(-server_inflight_max) dump the black box once per storm "
              "(an admit resets the streak).  0 (default) disables");
  });
}

}  // namespace configure
}  // namespace mvtpu
