--- multiverso_tpu_torch Lua binding (LuaJIT FFI over the C API).
--
-- Capability parity with the reference's binding/lua/ Lua module
-- (SURVEY.md §2.33): init/shutdown/barrier, ids, and Array/Matrix table
-- handlers, loaded straight over libmvtpu.so's flat C surface
-- (native/include/mvtpu/c_api.h).  Usage:
--
--   package.path  = package.path .. ";<repo>/multiverso_tpu_torch/binding/lua/?.lua"
--   local mv = require("multiverso")
--   mv.init({"-updater_type=sgd"})
--   local t = mv.ArrayTableHandler:new(100)
--   t:add(delta)                  -- delta: Lua array or FFI float[]
--   local w = t:get()             -- FFI float[size]
--   mv.barrier()
--   mv.shutdown()
--
-- Error convention: C rc < 0 raises a Lua error naming the call and rc
-- (rc=-3 means an unreachable peer / expired deadline — see c_api.h).
--
-- Contract-checked: tools/mvcontract.py (`make contract`) diffs every
-- prototype in the cdef block below against c_api.h (a deliberate
-- subset, but each cdef'd signature must match exactly).

local ffi = require("ffi")

ffi.cdef[[
int MV_Init(int argc, const char* const* argv);
int MV_ShutDown();
int MV_Barrier();
int MV_Clock();
int MV_NumWorkers();
int MV_WorkerId();
int MV_ServerId();
int MV_SetFlag(const char* name, const char* value);
int MV_NewArrayTable(int64_t size, int32_t* handle);
int MV_GetArrayTable(int32_t handle, float* data, int64_t size);
int MV_AddArrayTable(int32_t handle, const float* delta, int64_t size);
int MV_AddAsyncArrayTable(int32_t handle, const float* delta, int64_t size);
int MV_NewMatrixTable(int64_t rows, int64_t cols, int32_t* handle);
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
int MV_GetAsyncArrayTable(int32_t handle, float* data, int64_t size,
                          int32_t* wait_handle);
int MV_GetAsyncMatrixTableByRows(int32_t handle, float* data,
                                 const int32_t* row_ids, int64_t num_rows,
                                 int64_t cols, int32_t* wait_handle);
int MV_WaitGet(int32_t wait_handle);
int MV_CancelGet(int32_t wait_handle);
int MV_ArenaAcquire(int64_t bytes, void** ptr);
int MV_ArenaRelease(void* ptr);
int MV_ArenaStats(long long* buffers, long long* free_buffers,
                  long long* bytes, long long* in_flight,
                  long long* deferred, long long* recycled,
                  long long* pinned);
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
int MV_NewKVTable(int32_t* handle);
int MV_GetKV(int32_t handle, const char* key, float* value);
int MV_AddKV(int32_t handle, const char* key, float delta);
int MV_AddAsyncKV(int32_t handle, const char* key, float delta);
int MV_GetKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, float* values);
int MV_AddKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, const float* deltas);
int MV_SetAddOption(float learning_rate, float momentum, float rho, float eps);
int MV_StoreTable(int32_t handle, const char* path);
int MV_LoadTable(int32_t handle, const char* path);
int MV_QueryMonitor(const char* name, long long* count);
int MV_TableVersion(int32_t handle, long long* version);
int MV_LastVersion(int32_t handle, long long* version);
int MV_CacheStats(long long* hits, long long* misses);
int MV_ServeQueueDepth(void);
int MV_SetTraceEnabled(int on);
int MV_SetTraceId(long long trace_id);
int MV_ClearSpans(void);
int MV_SetFault(const char* kind, double rate);
int MV_SetFaultN(const char* kind, long long n);
int MV_SetFaultSeed(long long seed);
int MV_ClearFaults(void);
int MV_DeadPeerCount(void);
int MV_SetReplication(int on);
long long MV_RoutingEpoch(void);
int MV_ShardOwner(int shard_idx);
int MV_BackupShard(void);
int MV_PromoteBackup(int dead_rank);
int MV_ReplJoin(int shard_idx);
int MV_ReplicationStats(long long* forwards, long long* acks,
                        long long* applied, long long* outstanding,
                        long long* promotions, long long* epoch_flips,
                        long long* dup_skips, long long* catchups);
int MV_SetTableCodec(int32_t handle, const char* codec);
int MV_FlushAdds(int32_t handle);
int MV_WireStats(long long* sent_bytes, long long* recv_bytes,
                 long long* sent_msgs, long long* recv_msgs);
char* MV_NetEngine(void);
int MV_UringSupported(void);
void MV_FreeString(char* s);
int MV_FanInStats(long long* accepted_total, long long* active_clients,
                  long long* client_shed);
char* MV_OpsReport(const char* kind);
int MV_SetOpsHostMetrics(const char* prom_text);
int MV_BlackboxEvent(const char* kind, const char* detail);
int MV_BlackboxTrigger(const char* reason);
char* MV_HotKeys(int32_t handle);
int MV_TableLoadStats(int32_t handle, long long* gets, long long* adds,
                      double* skew_ratio, double* add_l2,
                      double* add_linf, long long* nan_count,
                      long long* inf_count);
int MV_SetHotKeyTracking(int on);
char* MV_CapacityReport(void);
int MV_SetCapacityTracking(int on);
int MV_SetHotKeyReplica(int on);
int MV_ReplicaRefresh(int32_t handle);
int MV_ReplicaStats(int32_t handle, long long* hits, long long* misses,
                    long long* rows, long long* refreshes,
                    long long* pushes);
char* MV_OpsFleetReport(const char* kind);
int MV_SetWireTiming(int on);
int MV_SetAudit(int on);
int MV_ClockOffset(int rank, long long* offset_ns, long long* rtt_ns);
int MV_SetProfiler(int hz);
char* MV_ProfilerDump(void);
int MV_ProfilerClear(void);
int MV_SetOpsHostAlerts(const char* alerts_json);
int MV_SetWatchdog(int stall_ms);
int MV_WatchdogBump(const char* loop);
int MV_WatchdogBusy(const char* loop, long long queued);
char* MV_WatchdogStats(void);
]]

-- libmvtpu.so sits two directories up from this file (native/build/).
local function lib_path()
  local src = debug.getinfo(1, "S").source:sub(2)
  local here = src:match("(.*)/") or "."
  return here .. "/../../native/build/libmvtpu.so"
end

local C = ffi.load(os.getenv("MVTPU_NATIVE_LIB") or lib_path())

local mv = {}

local function check(rc, what)
  if rc < 0 then
    error(string.format("%s failed with rc=%d", what, rc))
  end
  return rc
end

--- Convert a Lua array (or pass through an FFI array) to float[n].
local function to_floats(data, n)
  if type(data) == "cdata" then return data end
  local buf = ffi.new("float[?]", n)
  for i = 1, n do buf[i - 1] = data[i] end
  return buf
end

local function to_ints(data, n)
  if type(data) == "cdata" then return data end
  local buf = ffi.new("int32_t[?]", n)
  for i = 1, n do buf[i - 1] = data[i] end
  return buf
end

--- init(args): args is an optional Lua array of "-flag=value" strings.
function mv.init(args)
  args = args or {}
  local argv = ffi.new("const char*[?]", #args)
  for i = 1, #args do argv[i - 1] = args[i] end
  check(C.MV_Init(#args, argv), "MV_Init")
end

function mv.shutdown() check(C.MV_ShutDown(), "MV_ShutDown") end
function mv.barrier() check(C.MV_Barrier(), "MV_Barrier") end
--- SSP clock tick (see c_api.h MV_Clock / the -staleness flag).
function mv.clock() check(C.MV_Clock(), "MV_Clock") end
function mv.num_workers() return C.MV_NumWorkers() end
function mv.worker_id() return C.MV_WorkerId() end
function mv.server_id() return C.MV_ServerId() end

function mv.set_flag(name, value)
  check(C.MV_SetFlag(name, tostring(value)), "MV_SetFlag")
end

function mv.set_add_option(lr, momentum, rho, eps)
  check(C.MV_SetAddOption(lr or 0.1, momentum or 0.9, rho or 0.9,
                          eps or 1e-8), "MV_SetAddOption")
end

--- Hit count of a Dashboard monitor (0 when it never fired) — e.g.
--- "net.retries" / "net.dropped" / "hb.missed" (docs/fault_tolerance.md).
function mv.query_monitor(name)
  local c = ffi.new("long long[1]")
  check(C.MV_QueryMonitor(name, c), "MV_QueryMonitor")
  return tonumber(c[0])
end

--- Serve layer (docs/serving.md): version probe — the table's current
--- max server-side version in ONE header-only round trip (the cheap
--- cache-validation alternative to a full fetch).  rc -6 = the server
--- shed the probe under -server_inflight_max backpressure (retryable).
function mv.table_version(handle)
  local v = ffi.new("long long[1]")
  check(C.MV_TableVersion(handle, v), "MV_TableVersion")
  return tonumber(v[0])
end

--- Highest version stamp observed in any reply to this process — a
--- free local lower bound on the server version (no wire traffic).
function mv.last_version(handle)
  local v = ffi.new("long long[1]")
  check(C.MV_LastVersion(handle, v), "MV_LastVersion")
  return tonumber(v[0])
end

--- Native worker-side row-cache counters: returns hits, misses.
function mv.cache_stats()
  local h = ffi.new("long long[1]")
  local m = ffi.new("long long[1]")
  check(C.MV_CacheStats(h, m), "MV_CacheStats")
  return tonumber(h[0]), tonumber(m[0])
end

--- Server-actor mailbox backlog (the -server_inflight_max gauge).
function mv.serve_queue_depth()
  return check(C.MV_ServeQueueDepth(), "MV_ServeQueueDepth")
end

--- Span tracing (docs/observability.md): arm native span recording
--- (worker ops, server applies, wire sends share cross-rank trace ids;
--- dump via the C API's MV_DumpSpans from the host-side tooling).
function mv.set_trace_enabled(on)
  check(C.MV_SetTraceEnabled(on and 1 or 0), "MV_SetTraceEnabled")
end

--- Pin this thread's trace id for subsequent ops (0 = auto per-op ids).
function mv.set_trace_id(id)
  check(C.MV_SetTraceId(id), "MV_SetTraceId")
end

function mv.clear_spans() check(C.MV_ClearSpans(), "MV_ClearSpans") end

--- Fault injection (chaos testing; docs/fault_tolerance.md): kind is
--- drop|delay|dup|fail_send with a per-op probability, or delay_ms to
--- set the injected delay length; set_fault_n fires on exactly the
--- next n ops.  Deterministic under set_fault_seed.
function mv.set_fault(kind, rate)
  check(C.MV_SetFault(kind, rate), "MV_SetFault")
end

function mv.set_fault_n(kind, n)
  check(C.MV_SetFaultN(kind, n), "MV_SetFaultN")
end

function mv.set_fault_seed(seed)
  check(C.MV_SetFaultSeed(seed), "MV_SetFaultSeed")
end

function mv.clear_faults() check(C.MV_ClearFaults(), "MV_ClearFaults") end

--- Peers with expired heartbeat leases on THIS rank (-heartbeat_ms;
--- lease watching is symmetric — docs/replication.md).
function mv.dead_peer_count() return C.MV_DeadPeerCount() end

--- Shard replication + failover (docs/replication.md).
function mv.set_replication(on)
  check(C.MV_SetReplication(on and 1 or 0), "MV_SetReplication")
end

function mv.routing_epoch() return tonumber(C.MV_RoutingEpoch()) end

--- Rank currently serving shard `idx` per the routed map (-1 = bad).
function mv.shard_owner(idx) return C.MV_ShardOwner(idx) end

--- The shard index this rank backs (-1 = none).
function mv.backup_shard() return C.MV_BackupShard() end

--- Operator-driven promotion of this rank's backup shard(s) for a
--- dead rank; returns the number of shards promoted.
function mv.promote_backup(dead_rank)
  return C.MV_PromoteBackup(dead_rank)
end

--- Elastic join: become shard `idx`'s backup (announce + catch-up).
function mv.repl_join(idx) check(C.MV_ReplJoin(idx), "MV_ReplJoin") end

--- Replication ledger: {forwards, acks, applied, outstanding,
--- promotions, epoch_flips, dup_skips, catchups}.
function mv.replication_stats()
  local f = ffi.new("long long[1]")
  local a = ffi.new("long long[1]")
  local ap = ffi.new("long long[1]")
  local o = ffi.new("long long[1]")
  local p = ffi.new("long long[1]")
  local e = ffi.new("long long[1]")
  local d = ffi.new("long long[1]")
  local c = ffi.new("long long[1]")
  check(C.MV_ReplicationStats(f, a, ap, o, p, e, d, c),
        "MV_ReplicationStats")
  return {forwards = tonumber(f[0]), acks = tonumber(a[0]),
          applied = tonumber(ap[0]), outstanding = tonumber(o[0]),
          promotions = tonumber(p[0]), epoch_flips = tonumber(e[0]),
          dup_skips = tonumber(d[0]), catchups = tonumber(c[0])}
end

--- Wire data plane (docs/wire_compression.md): retarget one table's
--- payload codec — "raw" | "1bit" (sign bits + scales with worker-side
--- error feedback) | "sparse" (lossless nonzero pairs).  Tables start
--- on the -wire_codec flag's value.
function mv.set_table_codec(handle, codec)
  check(C.MV_SetTableCodec(handle, codec), "MV_SetTableCodec")
end

--- Drain the add-aggregation buffer (-add_agg_ms/-add_agg_bytes) of one
--- table, or of every table when handle is nil/negative.
function mv.flush_adds(handle)
  check(C.MV_FlushAdds(handle or -1), "MV_FlushAdds")
end

--- Host-bridge arena (docs/host_bridge.md): acquire a recycled,
--- 64-byte-aligned, best-effort-pinned host buffer of `bytes` bytes as
--- an FFI void*.  Caller-held until mv.arena_release(ptr); borrowed
--- sends started from it defer the recycle past their in-flight window.
function mv.arena_acquire(bytes)
  local p = ffi.new("void*[1]")
  check(C.MV_ArenaAcquire(bytes, p), "MV_ArenaAcquire")
  return p[0]
end

--- Release an arena buffer (safe mid-flight: recycling defers behind
--- in-flight borrows; rc -2 on a double release raises).
function mv.arena_release(ptr)
  check(C.MV_ArenaRelease(ptr), "MV_ArenaRelease")
end

--- Arena counters: buffers, free_buffers, bytes, in_flight, deferred,
--- recycled, pinned (see MV_ArenaStats).
function mv.arena_stats()
  local v = {}
  for i = 1, 7 do v[i] = ffi.new("long long[1]") end
  check(C.MV_ArenaStats(v[1], v[2], v[3], v[4], v[5], v[6], v[7]),
        "MV_ArenaStats")
  local out = {}
  for i = 1, 7 do out[i] = tonumber(v[i][0]) end
  return unpack(out)
end

--- Borrowed fast-path siblings (docs/host_bridge.md): `data` must lie
--- inside a live arena buffer (rc -7 raises otherwise) — adds ship the
--- bytes zero-copy into the scatter-gather send path; async gets hold
--- the buffer until the ticket is consumed.
function mv.add_array_borrowed(handle, data, size, async)
  if async then
    check(C.MV_AddAsyncArrayTableBorrowed(handle, data, size),
          "MV_AddAsyncArrayTableBorrowed")
  else
    check(C.MV_AddArrayTableBorrowed(handle, data, size),
          "MV_AddArrayTableBorrowed")
  end
end

function mv.get_array_borrowed(handle, data, size)
  check(C.MV_GetArrayTableBorrowed(handle, data, size),
        "MV_GetArrayTableBorrowed")
  return data
end


function mv.add_matrix_all_borrowed(handle, data, size, async)
  if async then
    check(C.MV_AddAsyncMatrixTableAllBorrowed(handle, data, size),
          "MV_AddAsyncMatrixTableAllBorrowed")
  else
    check(C.MV_AddMatrixTableAllBorrowed(handle, data, size),
          "MV_AddMatrixTableAllBorrowed")
  end
end

function mv.add_matrix_rows_borrowed(handle, data, row_ids, k, cols,
                                     async)
  if async then
    check(C.MV_AddAsyncMatrixTableByRowsBorrowed(handle, data, row_ids,
                                                 k, cols),
          "MV_AddAsyncMatrixTableByRowsBorrowed")
  else
    check(C.MV_AddMatrixTableByRowsBorrowed(handle, data, row_ids, k,
                                            cols),
          "MV_AddMatrixTableByRowsBorrowed")
  end
end


--- Transport byte/frame ledger: returns sent_bytes, recv_bytes,
--- sent_msgs, recv_msgs over the native wire (headers included).
function mv.wire_stats()
  local sb = ffi.new("long long[1]")
  local rb = ffi.new("long long[1]")
  local sm = ffi.new("long long[1]")
  local rm = ffi.new("long long[1]")
  check(C.MV_WireStats(sb, rb, sm, rm), "MV_WireStats")
  return tonumber(sb[0]), tonumber(rb[0]), tonumber(sm[0]), tonumber(rm[0])
end

--- Active (effective) wire engine (docs/transport.md): "tcp" |
--- "epoll" | "mpi" | "uring", or "local" for a single process with no
--- transport.  A -net_engine=uring request on a kernel without
--- io_uring degrades to epoll and reports "epoll" here.
function mv.net_engine()
  local p = C.MV_NetEngine()
  local name = ffi.string(p)
  C.MV_FreeString(p)
  return name
end

--- True when this kernel can run the io_uring engine.  Probes the
--- kernel, not the session — callable before mv.init.
function mv.uring_supported()
  return C.MV_UringSupported() ~= 0
end

--- Anonymous serve-tier fan-in counters (epoll engine only): returns
--- accepted_total, active_clients, client_shed — non-rank client
--- connections accepted, currently connected, and requests shed by
--- the per-client admission gate (-client_inflight_max).
function mv.fanin_stats()
  local a = ffi.new("long long[1]")
  local c = ffi.new("long long[1]")
  local s = ffi.new("long long[1]")
  check(C.MV_FanInStats(a, c, s), "MV_FanInStats")
  return tonumber(a[0]), tonumber(c[0]), tonumber(s[0])
end

--- Live introspection (docs/observability.md): this rank's ops report —
--- "metrics" (Prometheus text with exemplar trace ids), "health"
--- (JSON verdict) or "tables" (JSON per-table stats); the same payload
--- the in-band wire scrape (MsgType::OpsQuery) serves.
function mv.ops_report(kind)
  local p = C.MV_OpsReport(kind or "health")
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

--- Push a host-rendered Prometheus document so in-band scrapes serve it
--- instead of the native-only fallback (empty string clears).
function mv.set_ops_host_metrics(text)
  check(C.MV_SetOpsHostMetrics(text or ""), "MV_SetOpsHostMetrics")
end

--- Flight recorder ("black box"): record one lifecycle event into the
--- bounded in-memory ring / dump ring + spans + monitor totals to
--- <trace_dir>/blackbox_rank<r>.json (native failure triggers — barrier
--- timeout, dead peer, shed storm — dump automatically).
function mv.blackbox_event(kind, detail)
  check(C.MV_BlackboxEvent(kind, detail or ""), "MV_BlackboxEvent")
end

function mv.blackbox_trigger(reason)
  check(C.MV_BlackboxTrigger(reason), "MV_BlackboxTrigger")
end

--- Workload plane (docs/observability.md): per-table hot-key / load
--- report as a JSON string (the in-band "hotkeys" OpsQuery payload).
--- handle >= 0 restricts to one table; nil/-1 reports every table.
function mv.hot_keys(handle)
  local p = C.MV_HotKeys(handle or -1)
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

--- Numeric workload slice for one table: gets, adds, skew_ratio,
--- add_l2, add_linf, nan_count, inf_count.
function mv.table_load_stats(handle)
  local g = ffi.new("long long[1]")
  local a = ffi.new("long long[1]")
  local sk = ffi.new("double[1]")
  local l2 = ffi.new("double[1]")
  local li = ffi.new("double[1]")
  local nn = ffi.new("long long[1]")
  local inf = ffi.new("long long[1]")
  check(C.MV_TableLoadStats(handle, g, a, sk, l2, li, nn, inf),
        "MV_TableLoadStats")
  return tonumber(g[0]), tonumber(a[0]), tonumber(sk[0]),
         tonumber(l2[0]), tonumber(li[0]), tonumber(nn[0]),
         tonumber(inf[0])
end

--- Toggle the workload accounting live (boot value: -hotkey_enabled).
function mv.set_hotkey_tracking(on)
  check(C.MV_SetHotKeyTracking(on and 1 or 0), "MV_SetHotKeyTracking")
end

--- Capacity plane (docs/observability.md "capacity plane"): this
--- rank's capacity report as a JSON string — proc stats, arena /
--- write-queue / registered byte gauges, per-table resident bytes per
--- bucket and the bounded load-history ring (the in-band "capacity"
--- OpsQuery payload; tools/mvplan.py plans over the fleet scrape).
function mv.capacity_report()
  local p = C.MV_CapacityReport()
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

--- Toggle the byte accounting live (boot value: -capacity_enabled);
--- re-arming resyncs every shard's counters with an exact walk.
function mv.set_capacity_tracking(on)
  check(C.MV_SetCapacityTracking(on and 1 or 0), "MV_SetCapacityTracking")
end

--- Toggle the hot-key read replica live (docs/embedding.md; boot
--- value: -hotkey_replica): matrix row gets consult the servers'
--- pushed top-K rows before the wire.
function mv.set_hotkey_replica(on)
  check(C.MV_SetHotKeyReplica(on and 1 or 0), "MV_SetHotKeyReplica")
end

--- Force one replica refresh round trip for a matrix table.
function mv.replica_refresh(handle)
  check(C.MV_ReplicaRefresh(handle), "MV_ReplicaRefresh")
end

--- Replica ledger for a matrix table: hits, misses, rows held,
--- refresh round trips, server-side pushes.
function mv.replica_stats(handle)
  local h = ffi.new("long long[1]")
  local m = ffi.new("long long[1]")
  local r = ffi.new("long long[1]")
  local f = ffi.new("long long[1]")
  local p = ffi.new("long long[1]")
  check(C.MV_ReplicaStats(handle, h, m, r, f, p), "MV_ReplicaStats")
  return tonumber(h[0]), tonumber(m[0]), tonumber(r[0]),
         tonumber(f[0]), tonumber(p[0])
end

--- Toggle wire-header timing trails live (latency attribution;
--- boot value: -wire_timing, docs/observability.md "latency plane").
function mv.set_wire_timing(on)
  check(C.MV_SetWireTiming(on and 1 or 0), "MV_SetWireTiming")
end

--- Toggle the delivery-audit plane live (acked-add ledgers, applied
--- watermarks, dup/reorder/gap anomaly rings; boot value: -audit,
--- docs/observability.md "audit plane").  mv.ops_report("audit")
--- serves the JSON books.
function mv.set_audit(on)
  check(C.MV_SetAudit(on and 1 or 0), "MV_SetAudit")
end

--- Best NTP-style clock-offset estimate for a peer rank: returns
--- offset_ns (peer clock ahead of ours), rtt_ns — or nil when no
--- timed round trip to that rank completed yet.
function mv.clock_offset(rank)
  local off = ffi.new("long long[1]")
  local rtt = ffi.new("long long[1]")
  local rc = C.MV_ClockOffset(rank, off, rtt)
  if rc == -2 then return nil end
  check(rc, "MV_ClockOffset")
  return tonumber(off[0]), tonumber(rtt[0])
end

--- (Re)arm the SIGPROF sampling profiler at hz (CPU-time sampling);
--- hz <= 0 stops it.  Boot value: the -profile_hz flag.
function mv.set_profiler(hz)
  check(C.MV_SetProfiler(hz or 97), "MV_SetProfiler")
end

--- Folded-stack aggregation of everything sampled so far (one
--- "outer;...;leaf count" line per distinct stack).
function mv.profiler_dump()
  local p = C.MV_ProfilerDump()
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

--- Drop recorded profiler samples (per-phase A/B runs).
function mv.profiler_clear()
  check(C.MV_ProfilerClear(), "MV_ProfilerClear")
end

--- Push this host's health-plane alert document (JSON from the rule
--- evaluator) so the in-band "alerts" ops scrape serves it alongside
--- the native watchdog stats (empty/nil clears).
function mv.set_ops_host_alerts(text)
  check(C.MV_SetOpsHostAlerts(text or ""), "MV_SetOpsHostAlerts")
end

--- Arm the native stall watchdog (docs/observability.md): a loop that
--- reports queued work but makes no progress for stall_ms dumps folded
--- stacks into the blackbox.  0 disarms.
function mv.set_watchdog(stall_ms)
  check(C.MV_SetWatchdog(stall_ms or 0), "MV_SetWatchdog")
end

--- Record forward progress on a named host-side loop.
function mv.watchdog_bump(loop)
  check(C.MV_WatchdogBump(loop), "MV_WatchdogBump")
end

--- Report how much work a named loop currently has queued (0 = idle;
--- idle loops are never flagged as stalled).
function mv.watchdog_busy(loop, queued)
  check(C.MV_WatchdogBusy(loop, queued or 0), "MV_WatchdogBusy")
end

--- Per-loop watchdog stats as a JSON array (progress, queued, stalls,
--- stalled flag, seconds since last progress).
function mv.watchdog_stats()
  local p = C.MV_WatchdogStats()
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

--- Fleet-scope ops report assembled by THIS rank over the rank wire
--- (works on every engine, anonymous ingress or not).
function mv.ops_fleet_report(kind)
  local p = C.MV_OpsFleetReport(kind or "health")
  local text = ffi.string(p)
  C.MV_FreeString(p)
  return text
end

-- Shared async-get handle (MV_GetAsync* wait tickets): wait() joins the
-- pull and returns the filled buffer; a FAILED wait replays its error
-- on retry (MV_WaitGet consumes the ticket either way, so re-calling
-- it would report a bogus rc=-2).  cancel() withdraws an un-waited
-- pull; wait() after cancel() raises instead of returning the unfilled
-- buffer.  The buffer carries an ffi.gc finalizer so a handle dropped
-- without wait()/cancel() withdraws its ticket BEFORE LuaJIT frees the
-- buffer a late shard reply would scatter into (the c_api.h buffer-
-- lifetime contract; mirrors the ctypes binding's __del__).
local function make_async_get(ticket, buf)
  local h = { _ticket = ticket, _done = false, _cancelled = false }
  h._buf = ffi.gc(buf, function()
    if not h._done and not h._cancelled then C.MV_CancelGet(ticket) end
  end)
  function h.wait()
    if h._cancelled then error("async get was cancelled", 2) end
    if not h._done then
      h._done = true
      local ok, err = pcall(check, C.MV_WaitGet(h._ticket), "MV_WaitGet")
      if not ok then h._err = err end
    end
    if h._err then error(h._err, 0) end
    return h._buf
  end
  function h.cancel()
    if not h._done and not h._cancelled then
      h._cancelled = true
      C.MV_CancelGet(h._ticket)
    end
  end
  return h
end

-- ---------------------------------------------------------------- Array

--- Async borrowed gets (docs/host_bridge.md): defined after
--- make_async_get so the wrappers close over the local.
function mv.get_array_async_borrowed(handle, data, size)
  local t = ffi.new("int32_t[1]")
  check(C.MV_GetAsyncArrayTableBorrowed(handle, data, size, t),
        "MV_GetAsyncArrayTableBorrowed")
  return make_async_get(t[0], data)
end

function mv.get_matrix_rows_async_borrowed(handle, data, row_ids, k,
                                           cols)
  local t = ffi.new("int32_t[1]")
  check(C.MV_GetAsyncMatrixTableByRowsBorrowed(handle, data, row_ids, k,
                                               cols, t),
        "MV_GetAsyncMatrixTableByRowsBorrowed")
  return make_async_get(t[0], data)
end

mv.ArrayTableHandler = {}
mv.ArrayTableHandler.__index = mv.ArrayTableHandler

function mv.ArrayTableHandler:new(size)
  local h = ffi.new("int32_t[1]")
  check(C.MV_NewArrayTable(size, h), "MV_NewArrayTable")
  return setmetatable({ handle = h[0], size = size }, self)
end

function mv.ArrayTableHandler:get()
  local buf = ffi.new("float[?]", self.size)
  check(C.MV_GetArrayTable(self.handle, buf, self.size), "MV_GetArrayTable")
  return buf
end

function mv.ArrayTableHandler:add(delta, opts)
  local buf = to_floats(delta, self.size)
  if opts and opts.async then
    check(C.MV_AddAsyncArrayTable(self.handle, buf, self.size),
          "MV_AddAsyncArrayTable")
  else
    check(C.MV_AddArrayTable(self.handle, buf, self.size),
          "MV_AddArrayTable")
  end
end

--- Non-blocking get: returns a handle whose wait() blocks for the
--- replies and returns the buffer (async pull in flight meanwhile —
--- see c_api.h MV_GetAsync*).  The buffer is owned by the handle; call
--- cancel() instead of dropping an un-waited handle.
function mv.ArrayTableHandler:get_async()
  local buf = ffi.new("float[?]", self.size)
  local w = ffi.new("int32_t[1]")
  check(C.MV_GetAsyncArrayTable(self.handle, buf, self.size, w),
        "MV_GetAsyncArrayTable")
  return make_async_get(w[0], buf)
end

function mv.ArrayTableHandler:store(path)
  check(C.MV_StoreTable(self.handle, path), "MV_StoreTable")
end

function mv.ArrayTableHandler:load(path)
  check(C.MV_LoadTable(self.handle, path), "MV_LoadTable")
end

-- --------------------------------------------------------------- Matrix

mv.MatrixTableHandler = {}
mv.MatrixTableHandler.__index = mv.MatrixTableHandler

function mv.MatrixTableHandler:new(rows, cols)
  local h = ffi.new("int32_t[1]")
  check(C.MV_NewMatrixTable(rows, cols, h), "MV_NewMatrixTable")
  return setmetatable({ handle = h[0], rows = rows, cols = cols }, self)
end

function mv.MatrixTableHandler:get()
  local n = self.rows * self.cols
  local buf = ffi.new("float[?]", n)
  check(C.MV_GetMatrixTableAll(self.handle, buf, n), "MV_GetMatrixTableAll")
  return buf
end

function mv.MatrixTableHandler:add(delta, opts)
  local n = self.rows * self.cols
  local buf = to_floats(delta, n)
  if opts and opts.async then
    check(C.MV_AddAsyncMatrixTableAll(self.handle, buf, n),
          "MV_AddAsyncMatrixTableAll")
  else
    check(C.MV_AddMatrixTableAll(self.handle, buf, n),
          "MV_AddMatrixTableAll")
  end
end

-- Sparse variant: worker-side row cache, same handler methods.
mv.SparseMatrixTableHandler = {}

function mv.SparseMatrixTableHandler:new(rows, cols)
  local h = ffi.new("int32_t[1]")
  check(C.MV_NewSparseMatrixTable(rows, cols, h), "MV_NewSparseMatrixTable")
  return setmetatable({ handle = h[0], rows = rows, cols = cols },
                      mv.MatrixTableHandler)
end

--- #x raises on cdata, so FFI-array callers must pass the count.
local function row_count(row_ids, k)
  if k then return k end
  assert(type(row_ids) ~= "cdata",
         "pass the row count when row_ids is an FFI array")
  return #row_ids
end

function mv.MatrixTableHandler:get_rows(row_ids, k)
  k = row_count(row_ids, k)
  local ids = to_ints(row_ids, k)
  local buf = ffi.new("float[?]", k * self.cols)
  check(C.MV_GetMatrixTableByRows(self.handle, buf, ids, k, self.cols),
        "MV_GetMatrixTableByRows")
  return buf
end

--- Non-blocking row pull; see ArrayTableHandler:get_async.
function mv.MatrixTableHandler:get_rows_async(row_ids, k)
  k = row_count(row_ids, k)
  local ids = to_ints(row_ids, k)
  local buf = ffi.new("float[?]", k * self.cols)
  local w = ffi.new("int32_t[1]")
  check(C.MV_GetAsyncMatrixTableByRows(self.handle, buf, ids, k,
                                       self.cols, w),
        "MV_GetAsyncMatrixTableByRows")
  return make_async_get(w[0], buf)
end

function mv.MatrixTableHandler:add_rows(row_ids, delta, opts, k)
  k = row_count(row_ids, k)
  local ids = to_ints(row_ids, k)
  local buf = to_floats(delta, k * self.cols)
  if opts and opts.async then
    check(C.MV_AddAsyncMatrixTableByRows(self.handle, buf, ids, k,
                                         self.cols),
          "MV_AddAsyncMatrixTableByRows")
  else
    check(C.MV_AddMatrixTableByRows(self.handle, buf, ids, k, self.cols),
          "MV_AddMatrixTableByRows")
  end
end

-- ------------------------------------------------------------------- KV

mv.KVTableHandler = {}
mv.KVTableHandler.__index = mv.KVTableHandler

function mv.KVTableHandler:new()
  local h = ffi.new("int32_t[1]")
  check(C.MV_NewKVTable(h), "MV_NewKVTable")
  return setmetatable({ handle = h[0] }, self)
end

--- get("key") -> number; absent keys read 0.
function mv.KVTableHandler:get(key)
  local v = ffi.new("float[1]")
  check(C.MV_GetKV(self.handle, key, v), "MV_GetKV")
  return v[0]
end

--- add("key", delta [, {async=true}])
function mv.KVTableHandler:add(key, delta, opts)
  if opts and opts.async then
    check(C.MV_AddAsyncKV(self.handle, key, delta), "MV_AddAsyncKV")
  else
    check(C.MV_AddKV(self.handle, key, delta), "MV_AddKV")
  end
end

--- Pack a Lua array of strings into (concatenated bytes, int32 lens).
local function pack_keys(keys)
  local blob = table.concat(keys)
  local lens = ffi.new("int32_t[?]", #keys)
  for i = 1, #keys do lens[i - 1] = #keys[i] end
  return blob, lens
end

--- get_batch({"k1", "k2", ...}) -> float[n] (absent keys read 0).
function mv.KVTableHandler:get_batch(keys)
  local blob, lens = pack_keys(keys)
  local vals = ffi.new("float[?]", #keys)
  check(C.MV_GetKVBatch(self.handle, blob, lens, #keys, vals),
        "MV_GetKVBatch")
  return vals
end

--- add_batch({"k1", ...}, deltas): deltas is a Lua array or float[n].
function mv.KVTableHandler:add_batch(keys, deltas)
  local blob, lens = pack_keys(keys)
  local buf = to_floats(deltas, #keys)
  check(C.MV_AddKVBatch(self.handle, blob, lens, #keys, buf),
        "MV_AddKVBatch")
end

function mv.KVTableHandler:store(path)
  check(C.MV_StoreTable(self.handle, path), "MV_StoreTable")
end

function mv.KVTableHandler:load(path)
  check(C.MV_LoadTable(self.handle, path), "MV_LoadTable")
end

return mv
