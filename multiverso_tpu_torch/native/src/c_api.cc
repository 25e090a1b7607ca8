#include "mvtpu/c_api.h"

#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <unordered_map>

#include "mvtpu/audit.h"
#include "mvtpu/codec.h"
#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/fault.h"
#include "mvtpu/host_arena.h"
#include "mvtpu/latency.h"
#include "mvtpu/profiler.h"
#include "mvtpu/repl.h"
#include "mvtpu/mutex.h"
#include "mvtpu/ops.h"
#include "mvtpu/sketch.h"
#include "mvtpu/stream.h"
#include "mvtpu/uring_net.h"
#include "mvtpu/watchdog.h"
#include "mvtpu/zoo.h"

using mvtpu::AddOption;
using mvtpu::Mutex;
using mvtpu::MutexLock;
using mvtpu::Zoo;

namespace {
thread_local AddOption g_add_option;

int RequireStarted() { return Zoo::Get()->started() ? 0 : -1; }

// Failure rc for a blocking table round trip: -6 when a server SHED it
// under -server_inflight_max (retryable, no work done), -3 otherwise
// (dead shard / deadline — indeterminate; see the header contract).
int FailRc() { return mvtpu::WorkerTable::last_call_busy() ? -6 : -3; }

// Outstanding MV_GetAsync* tickets.  Tickets index AsyncGetHandles so
// the FFI surface stays integer-only; MV_WaitGet consumes the entry.
// Borrowed async gets (docs/host_bridge.md) additionally park an arena
// hold with the ticket: the destination buffer cannot be recycled while
// a late shard reply could still scatter into it — the hold drops when
// Wait/Cancel consumes the ticket (or at shutdown reclaim).
struct GetTicket {
  mvtpu::AsyncGetPtr h;
  std::shared_ptr<void> arena_hold;  // null on non-borrowed gets
};
Mutex g_gets_mu;
std::unordered_map<int32_t, GetTicket>& Gets() REQUIRES(g_gets_mu) {
  static auto* m = new std::unordered_map<int32_t, GetTicket>();
  return *m;
}
int32_t g_next_get_ticket GUARDED_BY(g_gets_mu) = 1;

int32_t StashGet(mvtpu::AsyncGetPtr h,
                 std::shared_ptr<void> arena_hold = nullptr) {
  MutexLock lk(g_gets_mu);
  int32_t t = g_next_get_ticket++;
  Gets()[t] = GetTicket{std::move(h), std::move(arena_hold)};
  return t;
}

// Validate a *Borrowed pointer window and mint its arena hold: fills
// `hold` and returns 0, or returns -7 (not a live arena buffer / the
// window overruns it) with nothing minted.
int ArenaHoldFor(const void* p, size_t bytes, void** base,
                 std::shared_ptr<void>* hold) {
  if (!p) return -1;
  void* b = mvtpu::HostArena::Get()->BufferOf(p, bytes);
  if (!b) return -7;
  *hold = mvtpu::HostArena::Get()->BorrowHold(b);
  if (!*hold) return -7;
  if (base) *base = b;
  return 0;
}
}  // namespace

namespace mvtpu {
// Called by Zoo::Stop(): un-waited tickets must not outlive the tables
// their handles point into (~AsyncGetHandle dereferences the table).
void CApiReclaimAsyncGets() {
  MutexLock lk(g_gets_mu);
  Gets().clear();
}
}  // namespace mvtpu

extern "C" {

int MV_Init(int argc, const char* const* argv) {
  return Zoo::Get()->Start(argc, argv) ? 0 : -1;
}

int MV_ShutDown() {
  Zoo::Get()->Stop();
  return 0;
}

int MV_Barrier() {
  if (RequireStarted()) return -1;
  return Zoo::Get()->Barrier() ? 0 : -3;  // -3: timeout / peer death
}

int MV_Clock() {
  if (RequireStarted()) return -1;
  Zoo::Get()->Clock();
  return 0;
}

int MV_NumWorkers() { return Zoo::Get()->num_workers(); }
int MV_WorkerId() { return Zoo::Get()->worker_id(); }
int MV_ServerId() { return Zoo::Get()->server_id(); }

int MV_SetFlag(const char* name, const char* value) {
  mvtpu::configure::RegisterDefaults();
  try {
    mvtpu::configure::Set(name, value);
  } catch (const std::invalid_argument&) {
    return -1;
  }
  return 0;
}

int MV_NewArrayTable(int64_t size, int32_t* handle) {
  if (RequireStarted() || size <= 0 || !handle) return -1;
  *handle = Zoo::Get()->RegisterArrayTable(size);
  return 0;
}

int MV_GetArrayTable(int32_t handle, float* data, int64_t size) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  return t->Get(data, size) ? 0 : FailRc();
}

static int AddArray(int32_t handle, const float* delta, int64_t size,
                    bool blocking) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  return t->Add(delta, size, g_add_option, blocking) ? 0 : FailRc();
}

int MV_AddArrayTable(int32_t h, const float* d, int64_t n) {
  return AddArray(h, d, n, true);
}
int MV_AddAsyncArrayTable(int32_t h, const float* d, int64_t n) {
  return AddArray(h, d, n, false);
}

int MV_NewMatrixTable(int64_t rows, int64_t cols, int32_t* handle) {
  if (RequireStarted() || rows <= 0 || cols <= 0 || !handle) return -1;
  *handle = Zoo::Get()->RegisterMatrixTable(rows, cols);
  return 0;
}

int MV_NewSparseMatrixTable(int64_t rows, int64_t cols, int32_t* handle) {
  if (RequireStarted() || rows <= 0 || cols <= 0 || !handle) return -1;
  *handle = Zoo::Get()->RegisterSparseMatrixTable(rows, cols);
  return 0;
}

int MV_GetMatrixTableAll(int32_t handle, float* data, int64_t /*size*/) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  return t->GetAll(data) ? 0 : FailRc();
}

static int AddMatrixAll(int32_t handle, const float* delta, bool blocking) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  return t->AddAll(delta, g_add_option, blocking) ? 0 : FailRc();
}

int MV_AddMatrixTableAll(int32_t h, const float* d, int64_t) {
  return AddMatrixAll(h, d, true);
}
int MV_AddAsyncMatrixTableAll(int32_t h, const float* d, int64_t) {
  return AddMatrixAll(h, d, false);
}

int MV_GetMatrixTableByRows(int32_t handle, float* data,
                            const int32_t* row_ids, int64_t num_rows,
                            int64_t /*cols*/) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  return t->GetRows(row_ids, num_rows, data) ? 0 : FailRc();
}

static int AddMatrixRows(int32_t handle, const float* delta,
                         const int32_t* row_ids, int64_t num_rows,
                         bool blocking) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  return t->AddRows(row_ids, num_rows, delta, g_add_option, blocking)
             ? 0
             : FailRc();
}

int MV_AddMatrixTableByRows(int32_t h, const float* d, const int32_t* ids,
                            int64_t k, int64_t) {
  return AddMatrixRows(h, d, ids, k, true);
}
int MV_AddAsyncMatrixTableByRows(int32_t h, const float* d, const int32_t* ids,
                                 int64_t k, int64_t) {
  return AddMatrixRows(h, d, ids, k, false);
}

int MV_GetAsyncArrayTable(int32_t handle, float* data, int64_t size,
                          int32_t* wait_handle) {
  if (RequireStarted() || !data || !wait_handle || size < 0) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  *wait_handle = StashGet(t->GetAsync(data, size));
  return 0;
}

int MV_GetAsyncMatrixTableByRows(int32_t handle, float* data,
                                 const int32_t* row_ids, int64_t num_rows,
                                 int64_t /*cols*/, int32_t* wait_handle) {
  if (RequireStarted() || !data || !row_ids || !wait_handle ||
      num_rows < 0)
    return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  *wait_handle = StashGet(t->GetRowsAsync(row_ids, num_rows, data));
  return 0;
}

int MV_WaitGet(int32_t wait_handle) {
  GetTicket t;
  {
    MutexLock lk(g_gets_mu);
    auto it = Gets().find(wait_handle);
    if (it == Gets().end()) return -2;
    t = std::move(it->second);
    Gets().erase(it);
  }
  // Wait outside the registry lock; the ticket's arena hold (borrowed
  // gets) drops when `t` dies — AFTER every shard reply landed.
  return t.h->Wait() ? 0 : FailRc();
}

int MV_CancelGet(int32_t wait_handle) {
  GetTicket t;
  {
    MutexLock lk(g_gets_mu);
    auto it = Gets().find(wait_handle);
    if (it == Gets().end()) return -2;
    t = std::move(it->second);
    Gets().erase(it);
  }
  // ~AsyncGetHandle withdraws the pending entry (under the table's
  // lock), so a late reply is dropped at the door instead of scattering
  // into an output buffer the caller is about to free; only then does
  // the ticket's arena hold release the destination for recycling.
  return 0;
}

// ---- host-bridge fast path (docs/host_bridge.md) ---------------------

int MV_ArenaAcquire(int64_t bytes, void** ptr) {
  if (bytes <= 0 || !ptr) return -1;
  void* p = mvtpu::HostArena::Get()->Acquire(static_cast<size_t>(bytes));
  if (!p) return -1;
  *ptr = p;
  return 0;
}

int MV_ArenaRelease(void* ptr) {
  if (!ptr) return -1;
  return mvtpu::HostArena::Get()->Release(ptr);
}

int MV_ArenaStats(long long* buffers, long long* free_buffers,
                  long long* bytes, long long* in_flight,
                  long long* deferred, long long* recycled,
                  long long* pinned) {
  auto st = mvtpu::HostArena::Get()->GetStats();
  if (buffers) *buffers = st.buffers;
  if (free_buffers) *free_buffers = st.free_buffers;
  if (bytes) *bytes = st.bytes;
  if (in_flight) *in_flight = st.in_flight;
  if (deferred) *deferred = st.deferred;
  if (recycled) *recycled = st.recycled;
  if (pinned) *pinned = st.pinned;
  return 0;
}

static int AddArrayBorrowed(int32_t handle, const float* delta,
                            int64_t size, bool blocking) {
  if (RequireStarted() || size <= 0) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  std::shared_ptr<void> hold;
  size_t bytes = static_cast<size_t>(size) * sizeof(float);
  int rc = ArenaHoldFor(delta, bytes, nullptr, &hold);
  if (rc) return rc;
  mvtpu::BorrowScope scope(delta, bytes, std::move(hold));
  return t->Add(delta, size, g_add_option, blocking) ? 0 : FailRc();
}

int MV_AddArrayTableBorrowed(int32_t h, const float* d, int64_t n) {
  return AddArrayBorrowed(h, d, n, true);
}
int MV_AddAsyncArrayTableBorrowed(int32_t h, const float* d, int64_t n) {
  return AddArrayBorrowed(h, d, n, false);
}

int MV_GetArrayTableBorrowed(int32_t handle, float* data, int64_t size) {
  if (RequireStarted() || size <= 0) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  // Destination validation + hold for the call's duration: the blocking
  // Get returns only after every shard landed, so the hold's job is the
  // -7 contract (an un-acquired / overrun destination fails loudly).
  std::shared_ptr<void> hold;
  int rc = ArenaHoldFor(data, static_cast<size_t>(size) * sizeof(float),
                        nullptr, &hold);
  if (rc) return rc;
  return t->Get(data, size) ? 0 : FailRc();
}

int MV_GetAsyncArrayTableBorrowed(int32_t handle, float* data,
                                  int64_t size, int32_t* wait_handle) {
  if (RequireStarted() || !data || !wait_handle || size < 0) return -1;
  auto* t = Zoo::Get()->array_worker(handle);
  if (!t) return -2;
  std::shared_ptr<void> hold;
  int rc = ArenaHoldFor(data, static_cast<size_t>(size) * sizeof(float),
                        nullptr, &hold);
  if (rc) return rc;
  *wait_handle = StashGet(t->GetAsync(data, size), std::move(hold));
  return 0;
}

static int AddMatrixAllBorrowed(int32_t handle, const float* delta,
                                int64_t size, bool blocking) {
  if (RequireStarted() || size <= 0) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  std::shared_ptr<void> hold;
  size_t bytes = static_cast<size_t>(size) * sizeof(float);
  int rc = ArenaHoldFor(delta, bytes, nullptr, &hold);
  if (rc) return rc;
  mvtpu::BorrowScope scope(delta, bytes, std::move(hold));
  return t->AddAll(delta, g_add_option, blocking) ? 0 : FailRc();
}

int MV_AddMatrixTableAllBorrowed(int32_t h, const float* d, int64_t n) {
  return AddMatrixAllBorrowed(h, d, n, true);
}
int MV_AddAsyncMatrixTableAllBorrowed(int32_t h, const float* d,
                                      int64_t n) {
  return AddMatrixAllBorrowed(h, d, n, false);
}

static int AddMatrixRowsBorrowed(int32_t handle, const float* delta,
                                 const int32_t* row_ids, int64_t num_rows,
                                 int64_t cols, bool blocking) {
  if (RequireStarted() || !row_ids || num_rows <= 0 || cols <= 0)
    return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  std::shared_ptr<void> hold;
  size_t bytes = static_cast<size_t>(num_rows * cols) * sizeof(float);
  int rc = ArenaHoldFor(delta, bytes, nullptr, &hold);
  if (rc) return rc;
  mvtpu::BorrowScope scope(delta, bytes, std::move(hold));
  return t->AddRows(row_ids, num_rows, delta, g_add_option, blocking)
             ? 0
             : FailRc();
}

int MV_AddMatrixTableByRowsBorrowed(int32_t h, const float* d,
                                    const int32_t* ids, int64_t k,
                                    int64_t cols) {
  return AddMatrixRowsBorrowed(h, d, ids, k, cols, true);
}
int MV_AddAsyncMatrixTableByRowsBorrowed(int32_t h, const float* d,
                                         const int32_t* ids, int64_t k,
                                         int64_t cols) {
  return AddMatrixRowsBorrowed(h, d, ids, k, cols, false);
}

int MV_GetAsyncMatrixTableByRowsBorrowed(int32_t handle, float* data,
                                         const int32_t* row_ids,
                                         int64_t num_rows, int64_t cols,
                                         int32_t* wait_handle) {
  if (RequireStarted() || !data || !row_ids || !wait_handle ||
      num_rows < 0 || cols <= 0)
    return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  std::shared_ptr<void> hold;
  int rc = ArenaHoldFor(data,
                        static_cast<size_t>(num_rows * cols) *
                            sizeof(float),
                        nullptr, &hold);
  if (rc) return rc;
  *wait_handle =
      StashGet(t->GetRowsAsync(row_ids, num_rows, data), std::move(hold));
  return 0;
}

int MV_NewKVTable(int32_t* handle) {
  if (RequireStarted() || !handle) return -1;
  *handle = Zoo::Get()->RegisterKVTable();
  return 0;
}

namespace {

std::vector<std::string> SplitKeys(const char* keys, const int32_t* lens,
                                   int64_t k) {
  std::vector<std::string> out;
  out.reserve(static_cast<size_t>(k));
  const char* p = keys;
  for (int64_t i = 0; i < k; ++i) {
    out.emplace_back(p, static_cast<size_t>(lens[i]));
    p += lens[i];
  }
  return out;
}

}  // namespace

int MV_GetKV(int32_t handle, const char* key, float* value) {
  if (RequireStarted() || !key || !value) return -1;
  auto* t = Zoo::Get()->kv_worker(handle);
  if (!t) return -2;
  return t->Get({std::string(key)}, value) ? 0 : FailRc();
}

static int AddKV(int32_t handle, const char* key, float delta,
                 bool blocking) {
  if (RequireStarted() || !key) return -1;
  auto* t = Zoo::Get()->kv_worker(handle);
  if (!t) return -2;
  return t->Add({std::string(key)}, &delta, g_add_option, blocking) ? 0 : FailRc();
}

int MV_AddKV(int32_t h, const char* key, float delta) {
  return AddKV(h, key, delta, true);
}
int MV_AddAsyncKV(int32_t h, const char* key, float delta) {
  return AddKV(h, key, delta, false);
}

int MV_GetKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, float* values) {
  if (RequireStarted() || !keys || !key_lens || !values || num_keys < 0)
    return -1;
  auto* t = Zoo::Get()->kv_worker(handle);
  if (!t) return -2;
  return t->Get(SplitKeys(keys, key_lens, num_keys), values) ? 0 : FailRc();
}

int MV_AddKVBatch(int32_t handle, const char* keys, const int32_t* key_lens,
                  int64_t num_keys, const float* deltas) {
  if (RequireStarted() || !keys || !key_lens || !deltas || num_keys < 0)
    return -1;
  auto* t = Zoo::Get()->kv_worker(handle);
  if (!t) return -2;
  return t->Add(SplitKeys(keys, key_lens, num_keys), deltas, g_add_option,
                true)
             ? 0
             : FailRc();
}

int MV_SetAddOption(float learning_rate, float momentum, float rho,
                    float eps) {
  g_add_option.learning_rate = learning_rate;
  g_add_option.momentum = momentum;
  g_add_option.rho = rho;
  g_add_option.eps = eps;
  return 0;
}

int MV_StoreTable(int32_t handle, const char* path) {
  if (RequireStarted()) return -1;
  // Validity via the worker stub (exists on every rank for every id);
  // the server shard may legitimately be null on worker-only ranks.
  if (!Zoo::Get()->worker_table(handle)) return -2;
  // Collective on EVERY rank: the leading barrier flushes pending adds
  // (and must run before the no-shard early-out, or a worker-only rank
  // returning early would strand the server ranks inside it); the
  // trailing barrier fences the snapshot — no rank's post-store adds
  // can land before every shard finished writing.
  if (!Zoo::Get()->Barrier()) return -3;
  int rc = 0;
  auto* t = Zoo::Get()->server_table(handle);
  if (t) {  // worker-only rank: joined the collective, no shard
    auto s = mvtpu::StreamFactory::Open(path, "wb");
    if (!s) rc = -5;                          // local IO, not peer death
    else if (!t->Store(s.get())) rc = -4;
  }
  if (!Zoo::Get()->Barrier()) return rc ? rc : -3;
  return rc;
}

int MV_LoadTable(int32_t handle, const char* path) {
  if (RequireStarted()) return -1;
  if (!Zoo::Get()->worker_table(handle)) return -2;
  if (!Zoo::Get()->Barrier()) return -3;
  int rc = 0;
  auto* t = Zoo::Get()->server_table(handle);
  if (t) {  // worker-only rank: joined the collective, no shard
    auto s = mvtpu::StreamFactory::Open(path, "rb");
    if (!s) rc = -5;                          // local IO, not peer death
    else if (!t->Load(s.get())) rc = -4;
  }
  // Trailing fence: no rank reads/writes restored state before every
  // shard finished loading.
  if (!Zoo::Get()->Barrier()) return rc ? rc : -3;
  return rc;
}

namespace {
char* MallocString(const std::string& r) {
  char* out = static_cast<char*>(malloc(r.size() + 1));
  std::memcpy(out, r.c_str(), r.size() + 1);
  return out;
}
}  // namespace

char* MV_DashboardReport() {
  return MallocString(mvtpu::Dashboard::Report());
}

char* MV_DumpMonitors(void) {
  return MallocString(mvtpu::Dashboard::Dump());
}

int MV_SetTraceEnabled(int on) {
  mvtpu::Dashboard::SetTraceEnabled(on != 0);
  return 0;
}

int MV_SetTraceId(long long trace_id) {
  mvtpu::Dashboard::SetThreadTraceId(static_cast<int64_t>(trace_id));
  return 0;
}

char* MV_DumpSpans(void) {
  return MallocString(mvtpu::Dashboard::DumpSpans());
}

int MV_ClearSpans(void) {
  mvtpu::Dashboard::ClearSpans();
  return 0;
}

void MV_FreeString(char* s) { free(s); }

int MV_QueryMonitor(const char* name, long long* count) {
  if (!name || !count) return -1;
  long long c = 0;
  double total = 0.0;
  *count = mvtpu::Dashboard::Query(name, &c, &total) ? c : 0;
  return 0;
}

int MV_SetFault(const char* kind, double rate) {
  return mvtpu::Fault::Set(kind, rate);
}

int MV_SetFaultN(const char* kind, long long n) {
  return mvtpu::Fault::SetBudget(kind, n);
}

int MV_SetFaultSeed(long long seed) {
  mvtpu::Fault::SetSeed(static_cast<uint64_t>(seed));
  return 0;
}

int MV_ClearFaults(void) {
  mvtpu::Fault::Clear();
  return 0;
}

int MV_DeadPeerCount(void) { return Zoo::Get()->DeadPeerCount(); }

// ---- shard replication + failover (docs/replication.md) --------------

int MV_SetReplication(int on) {
  mvtpu::repl::Arm(on != 0);
  return 0;
}

long long MV_RoutingEpoch(void) { return Zoo::Get()->RoutingEpoch(); }

int MV_ShardOwner(int shard_idx) {
  if (RequireStarted()) return -1;
  if (shard_idx < 0 || shard_idx >= Zoo::Get()->num_servers()) return -1;
  return Zoo::Get()->server_rank(shard_idx);
}

int MV_BackupShard(void) {
  if (RequireStarted()) return -1;
  return Zoo::Get()->BackupShard();
}

int MV_PromoteBackup(int dead_rank) {
  if (RequireStarted()) return -1;
  return Zoo::Get()->PromoteFor(dead_rank);
}

int MV_ReplJoin(int shard_idx) {
  if (RequireStarted()) return -1;
  return Zoo::Get()->JoinAsBackup(shard_idx) ? 0 : -3;
}

int MV_ReplicationStats(long long* forwards, long long* acks,
                        long long* applied, long long* outstanding,
                        long long* promotions, long long* epoch_flips,
                        long long* dup_skips, long long* catchups) {
  auto st = mvtpu::repl::GetStats();
  if (forwards) *forwards = st.forwards;
  if (acks) *acks = st.acks;
  if (applied) *applied = st.applied;
  if (outstanding) *outstanding = st.forwards - st.acks;
  if (promotions) *promotions = st.promotions;
  if (epoch_flips) *epoch_flips = st.epoch_flips;
  if (dup_skips) *dup_skips = st.dup_skips;
  if (catchups) *catchups = st.catchups;
  return 0;
}

// ---- transport (docs/transport.md) -----------------------------------

char* MV_NetEngine(void) {
  return MallocString(Zoo::Get()->net_engine());
}

int MV_UringSupported(void) {
  return mvtpu::uring::Probe(nullptr) ? 1 : 0;
}

int MV_FanInStats(long long* accepted_total, long long* active_clients,
                  long long* client_shed) {
  auto st = Zoo::Get()->FanIn();
  if (accepted_total) *accepted_total = st.accepted_total;
  if (active_clients) *active_clients = st.active_clients;
  if (client_shed) *client_shed = st.client_shed;
  return 0;
}

// ---- wire data plane (docs/wire_compression.md) ----------------------

int MV_SetTableCodec(int32_t handle, const char* codec) {
  if (RequireStarted() || !codec) return -1;
  if (!mvtpu::codec::IsCodecName(codec)) return -1;
  auto* t = Zoo::Get()->worker_table(handle);
  if (!t) return -2;
  t->set_codec(mvtpu::codec::FromName(codec));
  return 0;
}

int MV_FlushAdds(int32_t handle) {
  if (RequireStarted()) return -1;
  if (handle < 0) {
    Zoo::Get()->FlushWorkerAdds();
    return 0;
  }
  auto* t = Zoo::Get()->worker_table(handle);
  if (!t) return -2;
  t->FlushAdds();
  return 0;
}

int MV_WireStats(long long* sent_bytes, long long* recv_bytes,
                 long long* sent_msgs, long long* recv_msgs) {
  long long c = 0;
  double total = 0.0;
  bool have = mvtpu::Dashboard::Query("net.bytes.sent", &c, &total);
  if (sent_bytes) *sent_bytes = have ? static_cast<long long>(total) : 0;
  if (sent_msgs) *sent_msgs = have ? c : 0;
  c = 0;
  total = 0.0;
  have = mvtpu::Dashboard::Query("net.bytes.recv", &c, &total);
  if (recv_bytes) *recv_bytes = have ? static_cast<long long>(total) : 0;
  if (recv_msgs) *recv_msgs = have ? c : 0;
  return 0;
}

// ---- introspection plane (docs/observability.md) ---------------------

char* MV_OpsReport(const char* kind) {
  return MallocString(mvtpu::ops::LocalReport(kind ? kind : "health"));
}

// ---- latency attribution plane (docs/observability.md) ---------------

int MV_SetWireTiming(int on) {
  mvtpu::latency::Arm(on != 0);
  return 0;
}

// ---- delivery-audit plane (docs/observability.md "audit plane") ------

int MV_SetAudit(int on) {
  mvtpu::audit::Arm(on != 0);
  return 0;
}

int MV_ClockOffset(int rank, long long* offset_ns, long long* rtt_ns) {
  if (rank < 0) return -1;
  int64_t off = 0, rtt = 0;
  if (!mvtpu::latency::PeerOffset(rank, &off, &rtt)) return -2;
  if (offset_ns) *offset_ns = off;
  if (rtt_ns) *rtt_ns = rtt;
  return 0;
}

int MV_SetProfiler(int hz) {
  return mvtpu::profiler::Start(hz) ? 0 : -1;
}

char* MV_ProfilerDump(void) {
  return MallocString(mvtpu::profiler::DumpFolded());
}

int MV_ProfilerClear(void) {
  mvtpu::profiler::Clear();
  return 0;
}

int MV_SetOpsHostMetrics(const char* prom_text) {
  mvtpu::ops::SetHostMetrics(prom_text ? prom_text : "");
  return 0;
}

int MV_SetOpsHostAlerts(const char* alerts_json) {
  mvtpu::ops::SetHostAlerts(alerts_json ? alerts_json : "");
  return 0;
}

// ---- health plane: stall watchdog (docs/observability.md) ------------

int MV_SetWatchdog(int stall_ms) {
  mvtpu::watchdog::Arm(stall_ms);
  return 0;
}

int MV_WatchdogBump(const char* loop) {
  if (!loop) return -1;
  mvtpu::watchdog::Bump(loop);
  return 0;
}

int MV_WatchdogBusy(const char* loop, long long queued) {
  if (!loop) return -1;
  mvtpu::watchdog::Busy(loop, queued);
  return 0;
}

char* MV_WatchdogStats(void) {
  return MallocString(mvtpu::watchdog::StatsJson());
}

int MV_BlackboxEvent(const char* kind, const char* detail) {
  if (!kind) return -1;
  mvtpu::ops::BlackboxEvent(kind, detail ? detail : "");
  return 0;
}

int MV_BlackboxTrigger(const char* reason) {
  if (!reason) return -1;
  mvtpu::ops::BlackboxTrigger(reason);
  return 0;
}

// ---- workload observability (docs/observability.md) ------------------

char* MV_HotKeys(int32_t handle) {
  return MallocString(Zoo::Get()->OpsHotKeysJson(handle));
}

int MV_TableLoadStats(int32_t handle, long long* gets, long long* adds,
                      double* skew_ratio, double* add_l2,
                      double* add_linf, long long* nan_count,
                      long long* inf_count) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->server_table(handle);
  if (!t) return -2;  // bad handle, or no local shard on this rank
  auto load = t->Load();
  if (gets) *gets = load.gets;
  if (adds) *adds = load.adds;
  if (skew_ratio) *skew_ratio = load.skew_ratio;
  if (add_l2) *add_l2 = load.add_l2;
  if (add_linf) *add_linf = load.add_linf;
  if (nan_count) *nan_count = load.nan_count;
  if (inf_count) *inf_count = load.inf_count;
  return 0;
}

int MV_SetHotKeyTracking(int on) {
  mvtpu::workload::Arm(on != 0);
  return 0;
}

// ---- capacity plane (docs/observability.md "capacity plane") ---------

char* MV_CapacityReport(void) {
  return MallocString(Zoo::Get()->OpsCapacityJson());
}

int MV_SetCapacityTracking(int on) {
  bool was = mvtpu::capacity::Armed();
  mvtpu::capacity::Arm(on != 0);
  // Re-arming RESYNCS every shard's byte counters with an exact walk:
  // inserts that landed while disarmed left the incremental books
  // stale, and "armed" must mean "accurate".
  if (on && !was && Zoo::Get()->started())
    Zoo::Get()->RecomputeCapacityAll();
  return 0;
}

char* MV_OpsFleetReport(const char* kind) {
  return MallocString(
      Zoo::Get()->FleetReport(kind ? kind : "health"));
}

// ---- hot-key read replica (docs/embedding.md) ------------------------

int MV_SetHotKeyReplica(int on) {
  mvtpu::workload::ArmReplica(on != 0);
  return 0;
}

int MV_ReplicaRefresh(int32_t handle) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  return t->RefreshReplica() ? 0 : FailRc();
}

int MV_ReplicaStats(int32_t handle, long long* hits, long long* misses,
                    long long* rows, long long* refreshes,
                    long long* pushes) {
  if (RequireStarted()) return -1;
  auto* t = Zoo::Get()->matrix_worker(handle);
  if (!t) return -2;
  auto s = t->replica_stats();
  if (hits) *hits = s.hits;
  if (misses) *misses = s.misses;
  if (rows) *rows = s.rows;
  if (refreshes) *refreshes = s.refreshes;
  if (pushes) {
    auto* st = Zoo::Get()->server_table(handle);
    *pushes = st ? st->replica_pushes() : 0;
  }
  return 0;
}

// ---- serve layer (docs/serving.md) -----------------------------------

int MV_TableVersion(int32_t handle, long long* version) {
  if (RequireStarted() || !version) return -1;
  auto* t = Zoo::Get()->worker_table(handle);
  if (!t) return -2;
  int64_t v = 0;
  if (!t->QueryVersion(&v)) return FailRc();
  *version = v;
  return 0;
}

int MV_LastVersion(int32_t handle, long long* version) {
  if (RequireStarted() || !version) return -1;
  auto* t = Zoo::Get()->worker_table(handle);
  if (!t) return -2;
  *version = t->last_version();
  return 0;
}

int MV_CacheStats(long long* hits, long long* misses) {
  if (!hits || !misses) return -1;
  long long c = 0;
  double total = 0.0;
  *hits = mvtpu::Dashboard::Query("serve.cache.hit", &c, &total) ? c : 0;
  *misses = mvtpu::Dashboard::Query("serve.cache.miss", &c, &total) ? c : 0;
  return 0;
}

int MV_ServeQueueDepth(void) {
  if (RequireStarted()) return -1;
  return Zoo::Get()->ServeQueueDepth();
}

}  // extern "C"
