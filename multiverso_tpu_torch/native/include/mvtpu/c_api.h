// Flat extern-C surface for FFI bindings.
// Capability parity with include/multiverso/c_api.h (SURVEY.md §2.19):
// init/shutdown/barrier, ids, array + matrix tables with sync and async
// Add variants. float32 payloads (the reference's binding-facing type).
// All functions return 0 on success, negative on error, unless noted:
// -1 bad args / not started, -2 unknown handle, -3 unreachable peer or
// `-rpc_timeout_ms`/`-barrier_timeout_ms` deadline expired (fail-fast
// instead of hanging on a dead rank), -4 shard (de)serialization
// failed, -5 local stream open failed (an IO problem, NOT peer death),
// -6 a server SHED the request under `-server_inflight_max`
// backpressure (docs/serving.md) — retryable after backoff, and unlike
// -3 it is NOT indeterminate: the server did no work, -7 a *Borrowed
// call's buffer is not (entirely) inside a live HostArena buffer
// (docs/host_bridge.md) — nothing was sent.
// A -3 from a DEADLINE is indeterminate, not at-most-once: a slow
// server may still apply the Add after the caller gave up (a blind
// retry can double-apply), and a timed-out Get's output buffer may be
// partially filled.  Treat -3 as "state unknown": re-Get before
// deciding whether to re-Add.
// Contract-checked: tools/mvcontract.py (`make contract`) parses the
// rc map above and every prototype below, and diffs them against the
// ctypes binding and the Lua cdef — a new entry point must land with
// its Python side or tier-1 fails.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int MV_Init(int argc, const char* const* argv);
int MV_ShutDown();
int MV_Barrier();
// SSP (bounded staleness): advance this worker's clock.  With
// `-staleness=s`, a server holds this worker's Gets while it is more
// than s clocks ahead of the slowest worker (released as peers Clock;
// the rpc deadline still bounds the wait).  s=0 = read-side per-clock
// rendezvous (BSP reads without a barrier).
int MV_Clock();
int MV_NumWorkers();
int MV_WorkerId();
int MV_ServerId();

// Flags (reference configure surface).
int MV_SetFlag(const char* name, const char* value);

// Tables. handle := table id (>=0).
int MV_NewArrayTable(int64_t size, int32_t* handle);
int MV_GetArrayTable(int32_t handle, float* data, int64_t size);
int MV_AddArrayTable(int32_t handle, const float* delta, int64_t size);
int MV_AddAsyncArrayTable(int32_t handle, const float* delta, int64_t size);

int MV_NewMatrixTable(int64_t rows, int64_t cols, int32_t* handle);
// Sparse variant: worker-side row cache (hits skip the wire until this
// worker Adds the row or a barrier closes the clock).  Same Get/Add
// functions as the plain matrix table.
int MV_NewSparseMatrixTable(int64_t rows, int64_t cols, int32_t* handle);
int MV_GetMatrixTableAll(int32_t handle, float* data, int64_t size);
int MV_AddMatrixTableAll(int32_t handle, const float* delta, int64_t size);
int MV_AddAsyncMatrixTableAll(int32_t handle, const float* delta, int64_t size);
int MV_GetMatrixTableByRows(int32_t handle, float* data, const int32_t* row_ids,
                            int64_t num_rows, int64_t cols);
int MV_AddMatrixTableByRows(int32_t handle, const float* delta,
                            const int32_t* row_ids, int64_t num_rows,
                            int64_t cols);
int MV_AddAsyncMatrixTableByRows(int32_t handle, const float* delta,
                                 const int32_t* row_ids, int64_t num_rows,
                                 int64_t cols);

// Async Gets (reference WorkerTable::GetAsync + Wait, SURVEY.md §2.10):
// the pull is on the wire when the call returns; *wait_handle receives
// a ticket for MV_WaitGet, which blocks until every contacted shard
// replied (0), or returns -3 on dead shard / deadline — indeterminate
// like every -3 above (the buffer may be partially filled).  The output
// buffer must stay alive and untouched until MV_WaitGet returns, which
// also frees the ticket (a second wait on it returns -2).  A ticket the
// caller will never wait on MUST be released with MV_CancelGet before
// its output buffer dies — cancelling withdraws the in-flight request
// so a late shard reply cannot scatter into freed memory (the ctypes
// binding does this from the handle's destructor).  Tickets neither
// waited nor cancelled are reclaimed at MV_ShutDown.  On a sparse
// matrix table the async path goes straight to the wire (no row-cache
// read or install).
int MV_GetAsyncArrayTable(int32_t handle, float* data, int64_t size,
                          int32_t* wait_handle);
int MV_GetAsyncMatrixTableByRows(int32_t handle, float* data,
                                 const int32_t* row_ids, int64_t num_rows,
                                 int64_t cols, int32_t* wait_handle);
int MV_WaitGet(int32_t wait_handle);
int MV_CancelGet(int32_t wait_handle);  // 0, or -2 unknown/consumed

// ---- host-bridge fast path (docs/host_bridge.md) ---------------------
// Pinned buffer arena: recycled 64-byte-aligned host buffers whose
// bytes the *Borrowed calls below ship ZERO-COPY into the scatter-
// gather send path (Blob borrows instead of copies).  Ownership
// contract: a buffer is caller-held from MV_ArenaAcquire until
// MV_ArenaRelease; in-flight borrowed sends add native holds, and the
// buffer is recycled only when BOTH are gone — releasing mid-flight is
// always safe (the recycle defers), but MUTATING the bytes before the
// in-flight send drains is the caller's bug.  rc: 0, -1 bad args /
// allocation failure, -2 double release.
int MV_ArenaAcquire(int64_t bytes, void** ptr);
int MV_ArenaRelease(void* ptr);
// Arena accounting (any pointer may be NULL): live buffers, recycled
// free-list depth, total arena bytes, buffers with in-flight borrows,
// releases that had to defer behind a borrow, Acquires served from the
// free list, and buffers successfully mlock'd (-arena_pin).
int MV_ArenaStats(long long* buffers, long long* free_buffers,
                  long long* bytes, long long* in_flight,
                  long long* deferred, long long* recycled,
                  long long* pinned);

// Borrowed siblings of the Add/Get calls above: `delta`/`data` MUST lie
// inside a live arena buffer (rc -7 otherwise — the call does nothing;
// Borrowed calls fail loudly rather than silently copying).  Adds ship
// the caller's bytes straight into the sendmsg iovecs — no intermediate
// Blob copy; the arena defers the buffer's recycle until the wire (or
// the local server apply) is done with it.  Codec-encoded tables
// (1bit/sparse) and the add-aggregation buffer take ownership by
// copying exactly where they must mutate (copy-on-conflict).  Gets
// land replies directly in `data` as always; the Borrowed variants
// additionally validate the destination and — for the async forms —
// hold the arena buffer until MV_WaitGet/MV_CancelGet consumes the
// ticket, so an early MV_ArenaRelease cannot recycle a buffer a late
// shard reply could still scatter into.
int MV_AddArrayTableBorrowed(int32_t handle, const float* delta,
                             int64_t size);
int MV_AddAsyncArrayTableBorrowed(int32_t handle, const float* delta,
                                  int64_t size);
int MV_GetArrayTableBorrowed(int32_t handle, float* data, int64_t size);
int MV_GetAsyncArrayTableBorrowed(int32_t handle, float* data,
                                  int64_t size, int32_t* wait_handle);
int MV_AddMatrixTableAllBorrowed(int32_t handle, const float* delta,
                                 int64_t size);
int MV_AddAsyncMatrixTableAllBorrowed(int32_t handle, const float* delta,
                                      int64_t size);
int MV_AddMatrixTableByRowsBorrowed(int32_t handle, const float* delta,
                                    const int32_t* row_ids,
                                    int64_t num_rows, int64_t cols);
int MV_AddAsyncMatrixTableByRowsBorrowed(int32_t handle,
                                         const float* delta,
                                         const int32_t* row_ids,
                                         int64_t num_rows, int64_t cols);
int MV_GetAsyncMatrixTableByRowsBorrowed(int32_t handle, float* data,
                                         const int32_t* row_ids,
                                         int64_t num_rows, int64_t cols,
                                         int32_t* wait_handle);

// KV table (string key -> float value; SURVEY.md §2.14).  Batch calls
// take keys as concatenated NUL-FREE bytes with per-key lengths.
int MV_NewKVTable(int32_t* handle);
int MV_GetKV(int32_t handle, const char* key, float* value);
int MV_AddKV(int32_t handle, const char* key, float delta);
int MV_AddAsyncKV(int32_t handle, const char* key, float delta);
int MV_GetKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, float* values);
int MV_AddKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, const float* deltas);

// Per-call hyper-parameters for subsequent Add* on this thread
// (reference AddOption-in-message).
int MV_SetAddOption(float learning_rate, float momentum, float rho, float eps);

// Checkpoint one table to / from a local file.
int MV_StoreTable(int32_t handle, const char* path);
int MV_LoadTable(int32_t handle, const char* path);

// Dashboard report as a malloc'd C string; caller frees with MV_FreeString.
char* MV_DashboardReport();
void MV_FreeString(char* s);
// One monitor's hit count (0 when the monitor never fired) — how the
// chaos suite asserts `net.retries` / `net.dropped` / `hb.missed`.
int MV_QueryMonitor(const char* name, long long* count);

// ---- observability (docs/observability.md) ---------------------------
// EVERY Dashboard monitor in one call (the enumeration the Python
// metrics registry bridges instead of name-by-name MV_QueryMonitor):
// one line per monitor, tab-separated
//   name \t count \t total_s \t max_s \t b0,b1,...,b27
// where bucket i counts observations <= 1e-6 * 2^i seconds (the last
// bucket is +inf) — enough to reconstruct p50/p95/p99 host-side.
// malloc'd; caller frees with MV_FreeString.
char* MV_DumpMonitors(void);
// Span recording: with tracing on, every monitored op (worker Get/Add,
// server apply, wire send) records a wall-clock span tagged with a
// trace id that PROPAGATES through message headers — a worker Get and
// its server-side apply on another rank share the id.  `-trace=true`
// arms it at MV_Init; these toggle it at runtime.
int MV_SetTraceEnabled(int on);
// Pin this thread's trace id for subsequent ops (0 = auto per-op ids);
// lets a host-side tracer stitch native spans under its own span.
int MV_SetTraceId(long long trace_id);
// All recorded spans, one line each, tab-separated
//   name \t trace_id \t ts_us \t dur_us \t rank \t tid
// (ts_us is wall-clock, so per-rank dumps merge onto one timeline).
// malloc'd; caller frees with MV_FreeString.
char* MV_DumpSpans(void);
int MV_ClearSpans(void);

// ---- introspection plane (docs/observability.md; mvtpu/ops.h) --------
// This rank's ops report text — the SAME payload the wire serves for an
// in-band MsgType::OpsQuery.  kind: "metrics" (Prometheus exposition:
// the host-pushed registry rendering when present, else the native
// Dashboard with per-bucket exemplar trace ids) | "health" (JSON
// verdict: queue depth vs -server_inflight_max, lease state, fan-in
// counters) | "tables" (JSON per-table version / bucket-version spread /
// codec / agg depth).  malloc'd; caller frees with MV_FreeString.
char* MV_OpsReport(const char* kind);
// Push the host (Python) metrics registry's Prometheus rendering so
// in-band scrapes serve the full superset (the registry already
// bridges every native monitor).  The metrics flush thread calls this
// each interval.  NULL or empty clears the push (native fallback).
int MV_SetOpsHostMetrics(const char* prom_text);
// Push the host (Python) health evaluator's alert state (JSON object
// text) so the in-band `"alerts"` OpsQuery kind serves it under its
// "host" key beside the native watchdog table.  The health flush hook
// calls this each metrics flush.  NULL or empty clears the push
// (served as null).
int MV_SetOpsHostAlerts(const char* alerts_json);
// Flight recorder ("black box"): record one lifecycle event into the
// bounded in-memory ring (-blackbox_events), and/or trigger a dump of
// ring + recent spans + monitor totals to
// <trace_dir>/blackbox_rank<r>.json.  Native failure paths (barrier
// timeout, dead peer, shed storm) trigger automatically; these let the
// host layer add its own events/triggers (e.g. CheckpointCorrupt).
int MV_BlackboxEvent(const char* kind, const char* detail);
int MV_BlackboxTrigger(const char* reason);

// ---- workload observability (docs/observability.md) ------------------
// Per-table hot-key / shard-load report as JSON — the same payload the
// in-band `"hotkeys"` OpsQuery kind serves: for each server table,
// get/add totals, per-bucket load skew (max bucket / mean bucket),
// space-saving top-K hot keys with count-min estimates, observed-
// staleness stats, and the add L2/Linf + NaN/Inf health sentinels.
// handle >= 0 restricts to one table; < 0 reports every table.
// malloc'd; caller frees with MV_FreeString.
char* MV_HotKeys(int32_t handle);
// Numeric slice of the same accounting for one table (any output
// pointer may be NULL): served gets/adds, bucket-load skew ratio, the
// accumulated add L2 norm / max |element|, and NaN/Inf counts.  rc 0,
// -1 not started, -2 bad handle or no local shard on this rank.
int MV_TableLoadStats(int32_t handle, long long* gets, long long* adds,
                      double* skew_ratio, double* add_l2,
                      double* add_linf, long long* nan_count,
                      long long* inf_count);
// Toggle the workload accounting live (the `-hotkey_enabled` flag is
// the boot-time value): disarmed, every hot-path hook is one relaxed
// atomic check — the armed-vs-disarmed A/B behind the bench_skew
// overhead bar.
int MV_SetHotKeyTracking(int on);
// Fleet-scope ops report assembled BY THIS RANK over the rank wire
// (the same bounded fan-out + merge an inbound fleet OpsQuery runs) —
// works on every engine, including the blocking tcp engine that
// refuses anonymous scraper connections.  Any ops kind ("metrics" |
// "health" | "tables" | "hotkeys" | "latency" | "audit" |
// "replication" | "capacity" | "alerts").  malloc'd; caller frees
// with MV_FreeString.
char* MV_OpsFleetReport(const char* kind);

// ---- capacity plane (docs/observability.md "capacity plane") ---------
// This rank's capacity report as JSON — the same payload the in-band
// `"capacity"` OpsQuery kind serves: /proc/self process stats (RSS,
// VmHWM, open fds, uptime), arena + write-queue + registered byte
// gauges, and per table the shard's resident bytes/rows per bucket,
// per-bucket get/add load counters, the bounded load-history ring
// (rate curves), worker-side replica/agg/cache bytes as their OWN
// fields (never folded into shard counts), and backup-shard bytes.
// tools/mvplan.py bin-packs placement proposals over the fleet scrape.
// malloc'd; caller frees with MV_FreeString.
char* MV_CapacityReport(void);
// Toggle the byte accounting live (boot value: the `-capacity_enabled`
// flag).  Disarmed, every hot-path growth hook is one relaxed atomic
// check; re-arming resyncs every shard with an exact walk, so counters
// are accurate whenever tracking is on.
int MV_SetCapacityTracking(int on);

// ---- latency attribution plane (docs/observability.md) ---------------
// Toggle wire-header timing trails live (boot value: `-wire_timing`,
// default ON).  Armed, every worker request carries six monotonic
// stage stamps (client enqueue/send, server recv/dequeue/apply_done/
// reply_send); replies echo + extend the trail, and the client folds
// each round trip into lat.stage.{queue,wire_out,mailbox,apply,
// reactor,wire_back} + lat.total Dashboard histograms (exemplars
// included) and the per-peer clock-offset estimator.  The "latency"
// OpsQuery kind / MV_OpsReport("latency") serves the JSON breakdown.
int MV_SetWireTiming(int on);
// Toggle the delivery-audit plane live (boot value: `-audit`, default
// ON; docs/observability.md "audit plane").  Armed, every worker Add
// carries a per-(worker, table, shard) seq range behind a wire flag,
// ReplyAdd acks echo it into the client acked-add ledger, and server
// tables keep per-origin applied watermarks + dup/reorder/gap anomaly
// rings with an `audit_gap` flight-recorder trigger past
// `-audit_grace_ms`.  The "audit" OpsQuery kind / MV_OpsReport("audit")
// serves the JSON books; tools/mvaudit.py diffs them fleet-wide.
int MV_SetAudit(int on);
// Best current NTP-style clock-offset estimate for a peer rank:
// *offset_ns is how far the peer's monotonic clock runs ahead of this
// process's; *rtt_ns the minimum observed round trip backing it.
// Estimated from every timed request/reply AND the heartbeat
// echo.  rc 0; -1 not started / bad args; -2 no timed round trip to
// that rank completed yet.
int MV_ClockOffset(int rank, long long* offset_ns, long long* rtt_ns);
// Sampling profiler (SIGPROF, CPU-time): hz > 0 (re)arms at that rate,
// hz <= 0 stops.  Boot value: the `-profile_hz` flag.  rc 0, -1 when
// the timer/handler could not be installed.
int MV_SetProfiler(int hz);
// Folded-stack aggregation of everything sampled so far — one line per
// distinct stack, "outer;...;leaf count\n" (the flamegraph folded
// convention; multiverso_tpu_torch/profiler.py lands it in the Chrome trace
// beside the spans).  malloc'd; caller frees with MV_FreeString.
char* MV_ProfilerDump(void);
// Drop recorded samples (per-phase A/B runs, test isolation).
int MV_ProfilerClear(void);

// ---- health plane: stall watchdog (docs/observability.md) ------------
// Arm the native stall watchdog at `stall_ms` (<= 0 disarms; boot
// value: the `-watchdog_stall_ms` flag).  Armed, every critical loop
// (epoll reactor shards, actors, heartbeat scan, plus host loops via
// MV_WatchdogBump/Busy) that makes zero progress for stall_ms while
// work is queued gets flagged: `watchdog.stalls` bumps, a
// "stall: <loop> no progress for Nms, queue=D" blackbox event lands
// beside the profiler's folded stacks, and a blackbox dump triggers.
// stall_ms must exceed the slowest legitimate loop period.  rc 0.
int MV_SetWatchdog(int stall_ms);
// One unit of progress on a HOST loop (e.g. "py.flush", the Python
// metrics flusher) — registers the loop on first use; no-op disarmed.
int MV_WatchdogBump(const char* loop);
// Declare a host loop's queued work; 0 = idle (an idle loop cannot
// stall).  no-op disarmed.
int MV_WatchdogBusy(const char* loop, long long queued);
// Per-loop watchdog table as a JSON array — the same payload the
// `"alerts"` OpsQuery kind serves under "watchdog": loop name,
// progress, queued, stalls, stalled flag, seconds since progress.
// malloc'd; caller frees with MV_FreeString.
char* MV_WatchdogStats(void);

// ---- hot-key read replica (docs/embedding.md) ------------------------
// Toggle replica-served matrix row reads live (the `-hotkey_replica`
// flag is the boot value).  Armed, MatrixWorkerTable::GetRows consults
// a worker-local side table of the servers' pushed SpaceSaving top-K
// rows BEFORE the wire; invalidation rides the version-stamp protocol
// (entries older than last_version - `-replica_max_staleness` miss),
// and the snapshot re-pulls past `-replica_lease_ms`.
int MV_SetHotKeyReplica(int on);
// Force one replica refresh round trip (RequestReplica to every shard)
// for a matrix table.  rc 0, -1 not started, -2 not a matrix table,
// -3 dead shard / deadline, -6 shed (retryable).
int MV_ReplicaRefresh(int32_t handle);
// Replica ledger for a matrix table (any output pointer may be NULL):
// rows served from the replica (hits), rows that went to the wire
// (misses), rows currently held, refresh round trips, and this rank's
// server-side push count.  rc 0, -1 not started, -2 not a matrix table.
int MV_ReplicaStats(int32_t handle, long long* hits, long long* misses,
                    long long* rows, long long* refreshes,
                    long long* pushes);

// ---- serve layer (docs/serving.md) -----------------------------------
// Version probe: one header-only round trip filling *version with the
// max CURRENT version over every server shard of the table — the cheap
// alternative to a full fetch when a client must validate a cached
// copy.  Every server-side apply bumps the table's monotonic version
// (row/key adds bump per-bucket versions; replies stamp the version
// covering the data they serve).  rc: 0 / -1 / -2 / -3 / -6.
int MV_TableVersion(int32_t handle, long long* version);
// The highest version stamp observed in ANY reply to this process's
// worker stub (Get payloads and blocking-Add acks) — a FREE local
// lower bound on the server version, no wire traffic.
int MV_LastVersion(int32_t handle, long long* version);
// Native worker-side cache counters (the sparse matrix row cache):
// calls fully served from cache vs calls that paid a wire fetch
// (Dashboard serve.cache.hit / serve.cache.miss).
int MV_CacheStats(long long* hits, long long* misses);
// Current server-actor mailbox backlog — the queue-depth gauge behind
// `-server_inflight_max` shedding.  >= 0; -1 when not started.
int MV_ServeQueueDepth(void);

// ---- fault injection (mvtpu/fault.h; docs/fault_tolerance.md) --------
// Chaos hooks on the wire plane, deterministic under MV_SetFaultSeed.
// kinds: "drop" | "delay" | "dup" | "fail_send" (probability in [0,1]),
// plus "delay_ms" whose `rate` sets the injected delay length.
// MV_SetFaultN fires on exactly the next n matching ops instead of by
// probability.  All return 0, -1 on unknown kind / bad rate.  With no
// faults configured (the default) the hooks are a single atomic load.
int MV_SetFault(const char* kind, double rate);
int MV_SetFaultN(const char* kind, long long n);
int MV_SetFaultSeed(long long seed);
int MV_ClearFaults(void);

// Heartbeat failure detection (`-heartbeat_ms`): number of peers whose
// liveness lease is currently expired ON THIS RANK.  Lease watching is
// SYMMETRIC (docs/replication.md): every rank tracks every peer, so a
// backup can self-trigger promotion even when rank 0 is the corpse.
int MV_DeadPeerCount(void);

// ---- shard replication + failover (docs/replication.md) --------------
// Live toggle for the primary->backup forward stream (the bench's
// armed-vs-disarmed overhead A/B); the chained backup assignment
// itself is latched from -replication_factor at MV_Init.
int MV_SetReplication(int on);
// Current fleet routing epoch (0 = the registration-time shard map;
// every promotion/join bumps and broadcasts it).
long long MV_RoutingEpoch(void);
// The rank currently serving shard `shard_idx` per the routed map, or
// -1 when out of range.
int MV_ShardOwner(int shard_idx);
// The shard index this rank BACKS (chained or joined), -1 for none.
int MV_BackupShard(void);
// Promote this rank's backup shard(s) for `dead_rank` into serving —
// the operator-driven twin of lease-triggered auto-promotion.
// Returns the number of shards promoted.
int MV_PromoteBackup(int dead_rank);
// Elastic join: become shard `shard_idx`'s backup — creates backup
// instances, announces via a routing-epoch flip, and pulls whole-shard
// catch-up snapshots (blocking; idempotent, so chaos re-runs re-pull).
// 0 on success, -1 not started / refused, -3 catch-up failed.
int MV_ReplJoin(int shard_idx);
// Replication ledger: forwards/acks (primary side), applied (backup
// side), currently outstanding forwards, promotions + epoch flips,
// post-failover dup-skipped replays, and catch-up snapshot installs.
// Any output pointer may be NULL.
int MV_ReplicationStats(long long* forwards, long long* acks,
                        long long* applied, long long* outstanding,
                        long long* promotions, long long* epoch_flips,
                        long long* dup_skips, long long* catchups);

// ---- transport (docs/transport.md) -----------------------------------
// Active (EFFECTIVE) wire engine name: "tcp" | "epoll" | "mpi" |
// "uring", or "local" for a single process with no transport.  When
// `-net_engine=uring` was requested on a kernel that cannot run it,
// Start degrades to epoll and this reports "epoll".  malloc'd; caller
// frees with MV_FreeString.
char* MV_NetEngine(void);
// 1 when THIS kernel can run the io_uring engine (io_uring_setup plus
// every opcode the data plane needs), 0 otherwise.  Callable before
// MV_Init — it probes the kernel, not the session (the uring test
// suites gate on it).
int MV_UringSupported(void);
// Anonymous serve-tier fan-in counters: connections accepted without a
// rank identity (external serve clients), how many are currently
// connected, and how many of their requests the per-client admission
// gate (`-client_inflight_max`) answered ReplyBusy.  Nonzero only on
// the epoll engine; any output pointer may be NULL.
int MV_FanInStats(long long* accepted_total, long long* active_clients,
                  long long* client_shed);

// ---- wire data plane (docs/wire_compression.md) ----------------------
// Retarget one table's wire codec: "raw" | "1bit" (sign bits + two
// scales per message, worker-side error feedback so the quantization
// loss re-enters the next add) | "sparse" (lossless nonzero
// index/value pairs, per-message raw fallback when not smaller).
// Tables start on the `-wire_codec` flag's value.  -1 on an unknown
// codec name, -2 on a bad handle.
int MV_SetTableCodec(int32_t handle, const char* codec);
// Drain the add-aggregation buffer (`-add_agg_ms`/`-add_agg_bytes`) of
// one table — or of EVERY table when handle < 0 — onto the wire.
// Get/Clock/Barrier/shutdown flush implicitly; this is the explicit
// trigger ("Flush" in the aggregation contract).
int MV_FlushAdds(int32_t handle);
// Transport byte/message ledger: total wire bytes and frames this
// process sent/received (TcpNet + MpiNet, headers included).  The
// counters behind the Python `net.bytes{dir=...}`/`net.msgs` bridge;
// any output pointer may be NULL.
int MV_WireStats(long long* sent_bytes, long long* recv_bytes,
                 long long* sent_msgs, long long* recv_msgs);

#ifdef __cplusplus
}
#endif
