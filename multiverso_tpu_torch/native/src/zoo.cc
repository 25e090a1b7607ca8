#include "mvtpu/zoo.h"

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <functional>
#include <map>
#include <sstream>
#include <tuple>
#include <type_traits>

#include "mvtpu/audit.h"
#include "mvtpu/capacity.h"
#include "mvtpu/codec.h"
#include "mvtpu/configure.h"
#include "mvtpu/host_arena.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/fault.h"
#include "mvtpu/latency.h"
#include "mvtpu/log.h"
#include "mvtpu/profiler.h"
#include "mvtpu/mpi_net.h"
#include "mvtpu/ops.h"
#include "mvtpu/repl.h"
#include "mvtpu/qos.h"
#include "mvtpu/sketch.h"
#include "mvtpu/uring_net.h"
#include "mvtpu/waiter.h"
#include "mvtpu/watchdog.h"

namespace mvtpu {

namespace {

std::string JoinInts(const std::vector<int>& v) {
  std::string out;
  for (int x : v) {
    if (!out.empty()) out += ',';
    out += std::to_string(x);
  }
  return out;
}

// Adopt a wire message's trace id as this thread's span context for the
// scope (restored on exit).  No-op when tracing is off or id == 0.
class TraceScope {
 public:
  explicit TraceScope(int64_t trace_id) {
    if (trace_id != 0 && Dashboard::TraceEnabled()) {
      prev_ = Dashboard::ThreadTraceId();
      Dashboard::SetThreadTraceId(trace_id);
      set_ = true;
    }
  }
  ~TraceScope() {
    if (set_) Dashboard::SetThreadTraceId(prev_);
  }

 private:
  bool set_ = false;
  int64_t prev_ = 0;
};

// The actor chain worker → server → controller carries barrier messages
// so every request enqueued before the barrier is processed before it
// completes (the flush guarantee); across processes the server leg
// forwards to rank 0's controller over TCP.
class WorkerActor : public Actor {
 public:
  WorkerActor() : Actor(actor::kWorker) {
    RegisterHandler(MsgType::RequestGet, [](MessagePtr& m) {
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::RequestAdd, [](MessagePtr& m) {
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::RequestFlush, [](MessagePtr& m) {
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::RequestVersion, [](MessagePtr& m) {
      // Serve-layer probe: same worker->server leg as Get.
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::RequestReplica, [](MessagePtr& m) {
      // Hot-key replica pull (docs/embedding.md): same leg as Get.
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::ClockTick, [](MessagePtr& m) {
      // Outbound SSP tick: same worker->server leg as Get/Add, so the
      // per-connection FIFO keeps it behind this clock's adds.
      Zoo::Get()->Deliver(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::ReplyFlush, [](MessagePtr& m) {
      Zoo::Get()->OnFlushReply(m->msg_id);
    });
    RegisterHandler(MsgType::ControlBarrier, [](MessagePtr& m) {
      // Local pipeline flush leg: worker → (local) server.
      Zoo::Get()->SendTo(actor::kServer, std::move(m));
    });
    RegisterHandler(MsgType::ReplyGet, [](MessagePtr& m) {
      // Sparse-encoded reply payload (docs/wire_compression.md): decode
      // before the table's consume sees it — a malformed payload is
      // dropped here, never scattered into a caller's buffer.
      if (m->codec != Codec::kRaw && !codec::DecodeInPlace(m.get())) {
        Log::Error("ReplyGet for table %d: malformed %s payload dropped",
                   m->table_id, codec::Name(m->codec));
        return;
      }
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
    RegisterHandler(MsgType::ReplyAdd, [](MessagePtr& m) {
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
    RegisterHandler(MsgType::ReplyError, [](MessagePtr& m) {
      // Synthesized by Deliver when a request's peer was unreachable:
      // unblocks the pending RoundTrip with an error.
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
    RegisterHandler(MsgType::ReplyVersion, [](MessagePtr& m) {
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
    RegisterHandler(MsgType::ReplyReplica, [](MessagePtr& m) {
      // The pending RefreshReplica's consume installs the pushed rows.
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
    RegisterHandler(MsgType::ReplyBusy, [](MessagePtr& m) {
      // Server shed the request under -server_inflight_max: fail the
      // pending round trip as BUSY (retryable; rc -6 at the C API).
      Zoo::Get()->worker_table(m->table_id)->Notify(m->msg_id, *m);
    });
  }
};

class ServerActor : public Actor {
 public:
  ServerActor() : Actor(actor::kServer) {
    RegisterHandler(MsgType::RequestGet, [](MessagePtr& m) {
      // Latency trail (docs/observability.md): the dequeue stamp closes
      // the mailbox stage — taken BEFORE the shed/SSP checks so a shed
      // or park is attributed to the mailbox, not the apply.
      latency::StampDequeue(m.get());
      // Shard-hint routing (docs/replication.md): a promoted rank
      // serves TWO shards of a table; reads whose hint names the
      // backed shard are also served pre-promotion (the hedge's true
      // backup target).
      auto* table = Zoo::Get()->RoutedServerTable(*m);
      if (!table) {  // misrouted: this rank has no server role/shard
        Log::Error("RequestGet for table %d on non-server rank",
                   m->table_id);
        return;
      }
      // Tail plane (docs/serving.md "tail"): a deadline-expired or
      // hedge-cancelled get is dropped at dequeue — nobody is waiting
      // for the answer, so it must not burn an apply slot.
      if (Zoo::Get()->DropServeRead(m)) return;
      // Serve backpressure: shed BEFORE any table work so an overloaded
      // server drains its backlog at ReplyBusy speed (docs/serving.md).
      if (Zoo::Get()->ShedIfOverloaded(m)) return;
      // SSP: park the get while its sender runs too far ahead of the
      // slowest worker; OnClockTick re-delivers it here when admitted.
      if (Zoo::Get()->MaybeHoldGet(m)) return;
      auto reply = std::make_unique<Message>();
      reply->type = MsgType::ReplyGet;
      reply->table_id = m->table_id;
      reply->msg_id = m->msg_id;
      reply->trace_id = m->trace_id;  // span id rides the full round trip
      reply->shard = m->shard;  // reassembly key: src rank is ambiguous
      reply->src = Zoo::Get()->rank();
      reply->dst = m->src;
      // Adopt the requester's span id for the handler's duration so the
      // server-side ProcessGet monitor's span (and any send it triggers)
      // correlates with the worker's Get across ranks.
      TraceScope scope(m->trace_id);
      // Seeded apply-path slowdown (docs/fault_tolerance.md): sleeps
      // INSIDE the dequeue->apply_done stage so the latency plane can
      // prove it names `apply`, not the wire (latdoctor acceptance).
      if (Fault::Enabled()) {
        int64_t d = Fault::ApplyDelayMs();
        if (d > 0) {
          Dashboard::Record("fault.apply_delay", 0.0);
          std::this_thread::sleep_for(std::chrono::milliseconds(d));
        }
      }
      table->ProcessGet(*m, reply.get());
      latency::StampReply(*m, reply.get());
      // Reply-codec negotiation: a requester that advertised
      // kAcceptSparse gets a lossless sparse payload when smaller.
      codec::MaybeEncodeReply(reply.get(), m->flags);
      Zoo::Get()->Deliver(actor::kWorker, std::move(reply));
    });
    RegisterHandler(MsgType::RequestVersion, [](MessagePtr& m) {
      // Serve-layer probe: answer with the current table (or bucket)
      // version — a header-only reply, no payload, no table lock.
      latency::StampDequeue(m.get());
      auto* table = Zoo::Get()->RoutedServerTable(*m);
      if (!table) {
        Log::Error("RequestVersion for table %d on non-server rank",
                   m->table_id);
        return;
      }
      if (Zoo::Get()->DropServeRead(m)) return;
      if (Zoo::Get()->ShedIfOverloaded(m)) return;
      auto reply = std::make_unique<Message>();
      reply->type = MsgType::ReplyVersion;
      reply->table_id = m->table_id;
      reply->msg_id = m->msg_id;
      reply->trace_id = m->trace_id;
      reply->shard = m->shard;
      reply->src = Zoo::Get()->rank();
      reply->dst = m->src;
      reply->version = m->version >= 0
                           ? table->bucket_version(
                                 static_cast<int>(m->version))
                           : table->version();
      latency::StampReply(*m, reply.get());
      Zoo::Get()->Deliver(actor::kWorker, std::move(reply));
    });
    RegisterHandler(MsgType::RequestReplica, [](MessagePtr& m) {
      // Hot-key replica push (docs/embedding.md): answer with this
      // shard's current SpaceSaving top-K rows + bucket versions.  A
      // read, so it sheds under backpressure exactly like a Get —
      // never competes with adds.
      latency::StampDequeue(m.get());
      auto* table = Zoo::Get()->RoutedServerTable(*m);
      if (!table) {
        Log::Error("RequestReplica for table %d on non-server rank",
                   m->table_id);
        return;
      }
      if (Zoo::Get()->DropServeRead(m)) return;
      if (Zoo::Get()->ShedIfOverloaded(m)) return;
      auto reply = std::make_unique<Message>();
      reply->type = MsgType::ReplyReplica;
      reply->table_id = m->table_id;
      reply->msg_id = m->msg_id;
      reply->trace_id = m->trace_id;
      reply->shard = m->shard;
      reply->src = Zoo::Get()->rank();
      reply->dst = m->src;
      TraceScope scope(m->trace_id);
      table->BuildReplica(reply.get());
      latency::StampReply(*m, reply.get());
      Zoo::Get()->Deliver(actor::kWorker, std::move(reply));
    });
    RegisterHandler(MsgType::ClockTick, [](MessagePtr& m) {
      Zoo::Get()->OnClockTick(m->src, m->msg_id);
    });
    RegisterHandler(MsgType::RequestAdd, [](MessagePtr& m) {
      latency::StampDequeue(m.get());
      auto* table = Zoo::Get()->RoutedServerTable(*m);
      if (!table) {
        Log::Error("RequestAdd for table %d on non-server rank",
                   m->table_id);
        return;
      }
      // Codec-encoded delta payload: decode to raw floats BEFORE
      // ProcessAdd, so the table layer (and its updaters/version
      // stamps) are codec-oblivious.  Malformed payloads are dropped —
      // feeding garbage deltas to an updater would corrupt the shard.
      if (m->codec != Codec::kRaw && !codec::DecodeInPlace(m.get())) {
        Log::Error("RequestAdd for table %d: malformed %s payload "
                   "dropped", m->table_id, codec::Name(m->codec));
        return;
      }
      TraceScope scope(m->trace_id);  // correlate apply with the Add
      if (Fault::Enabled()) {
        int64_t d = Fault::ApplyDelayMs();
        if (d > 0) {
          Dashboard::Record("fault.apply_delay", 0.0);
          std::this_thread::sleep_for(std::chrono::milliseconds(d));
        }
        // Seeded SILENT server-side discard (docs/observability.md
        // "audit plane"): the add vanishes after the wire delivered it
        // — no apply, no book entry, no ack.  The one failure class
        // retry/agg cannot absorb; exists so the audit plane's gap
        // detection has a real loss to catch (make audit-demo).
        if (Fault::DiscardApply()) {
          Dashboard::Record("fault.discard_apply", 0.0);
          return;
        }
      }
      // Replication makes stamped adds IDEMPOTENT (docs/replication.md):
      // a post-failover retry of a seq the promoted shard already
      // received as a ReplForward must ack without re-applying — the
      // retried delta would otherwise double-count.  Only with
      // replication armed: the base contract keeps dup deliveries
      // visible as dup-applies (docs/observability.md "audit plane").
      bool dup_skip =
          repl::Armed() && audit::Armed() && m->has_audit() &&
          table->audit_book().Covers(m->src, m->audit.seq_lo,
                                     m->audit.seq_hi);
      if (dup_skip) {
        table->audit_book().NoteDupSkipped(m->src, m->audit.seq_lo,
                                           m->audit.seq_hi);
        repl::NoteDupSkip();
        Dashboard::Record("repl.dup_skip", 0.0);
      } else {
        table->ProcessAdd(*m);
        // Delivery audit: book the applied seq range AFTER the apply so
        // the watermark never runs ahead of table state.
        table->NoteAuditApply(*m);
      }
      MessagePtr reply;
      if (m->msg_id >= 0) {  // blocking add wants an ack
        reply = std::make_unique<Message>();
        reply->type = MsgType::ReplyAdd;
        reply->table_id = m->table_id;
        reply->msg_id = m->msg_id;
        reply->trace_id = m->trace_id;
        reply->shard = m->shard;
        reply->src = Zoo::Get()->rank();
        reply->dst = m->src;
        // The ack carries the post-apply version: a write-through
        // client learns its own add's version for free (serving.md).
        reply->version = table->version();
        // Echo the audit stamp so the origin's acked-add ledger can
        // advance its watermark (docs/observability.md "audit plane").
        // The acked BOUND is the book's per-origin watermark, not the
        // request's seq_hi: under per-connection FIFO they are equal,
        // but across a failover a hole — an attempt that died with
        // the old primary — must never be covered by a later ack, or
        // the auditor would read a real (benign) gap as a LOST ACKED
        // ADD (docs/replication.md).
        if (m->has_audit()) {
          reply->flags |= msgflag::kHasAudit;
          reply->audit = m->audit;
          if (audit::Armed()) {
            int64_t wm = table->audit_book().Watermark(m->src);
            reply->audit.seq_hi = wm;
          }
        }
        latency::StampReply(*m, reply.get());
      }
      // Primary→backup delta stream (docs/replication.md): re-ship the
      // decoded add; sync mode parks the ack until the backup's
      // ReplAck, making "acked" mean "applied on both replicas".  An
      // already-applied dup is not re-forwarded (the backup saw it).
      if (!dup_skip && Zoo::Get()->ForwardAddToBackup(*m, &reply))
        return;  // ack parked; OnReplAck releases it
      if (reply) Zoo::Get()->Deliver(actor::kWorker, std::move(reply));
    });
    RegisterHandler(MsgType::ReplForward, [](MessagePtr& m) {
      Zoo::Get()->OnReplForward(std::move(m));
    });
    RegisterHandler(MsgType::ShardSnapshot, [](MessagePtr& m) {
      Zoo::Get()->OnShardSnapshot(std::move(m));
    });
    RegisterHandler(MsgType::RequestFlush, [](MessagePtr& m) {
      // Reaching here means every earlier message on the requester's
      // connection was processed — ack so its Barrier can proceed.
      auto reply = std::make_unique<Message>();
      reply->type = MsgType::ReplyFlush;
      reply->msg_id = m->msg_id;
      reply->src = Zoo::Get()->rank();
      reply->dst = m->src;
      Zoo::Get()->Deliver(actor::kWorker, std::move(reply));
    });
    RegisterHandler(MsgType::ControlBarrier, [](MessagePtr& m) {
      m->dst = 0;  // the controller authority lives on rank 0
      Zoo::Get()->Deliver(actor::kController, std::move(m));
    });
  }
};

class ControllerActor : public Actor {
 public:
  ControllerActor() : Actor(actor::kController) {
    RegisterHandler(MsgType::ControlBarrier, [](MessagePtr& m) {
      Zoo::Get()->OnBarrierArrive(m->src, m->msg_id);
    });
    RegisterHandler(MsgType::ControlBarrierReply, [](MessagePtr& m) {
      Zoo::Get()->OnBarrierRelease(m->msg_id);
    });
    RegisterHandler(MsgType::Heartbeat, [](MessagePtr& m) {
      // Symmetric leases (docs/replication.md): every rank renews to
      // every peer, so src==0 is now ambiguous — rank 0's own renewal
      // ships WITHOUT a trail; a trail-carrying src==0 frame is rank
      // 0's ECHO of our timed heartbeat, an NTP sample for the rank-0
      // clock offset (docs/observability.md), nothing lease-related.
      if (m->src == 0 && m->has_timing() && Zoo::Get()->rank() != 0) {
        latency::OnReply(*m, 0);
        return;
      }
      latency::StampDequeue(m.get());
      Zoo::Get()->OnHeartbeat(m->src);
      if (m->has_timing() && Zoo::Get()->rank() == 0) {
        // Echo the trail back so the announcing rank can close the
        // NTP round trip over the heartbeat RTT (the lease wire).
        auto echo = std::make_unique<Message>();
        echo->type = MsgType::Heartbeat;
        echo->src = Zoo::Get()->rank();
        echo->dst = m->src;
        latency::StampReply(*m, echo.get());
        Zoo::Get()->Deliver(actor::kController, std::move(echo));
      }
    });
    RegisterHandler(MsgType::Promote, [](MessagePtr& m) {
      // Operator/controller promotion nudge (docs/replication.md):
      // the same path lease expiry triggers automatically.
      Zoo::Get()->PromoteFor(static_cast<int>(m->version));
    });
  }
};

}  // namespace

static int64_t NowMs();

Zoo* Zoo::Get() {
  static Zoo zoo;
  return &zoo;
}

bool Zoo::Start(int argc, const char* const* argv) {
  MutexLock lk(mu_);
  if (started_) return true;
  configure::RegisterDefaults();
  if (configure::ParseCmdFlags(argc, argv) < 0) return false;
  std::string upd = configure::GetString("updater_type");
  if (!IsUpdaterName(upd)) {
    Log::Error("unknown updater_type '%s'", upd.c_str());
    return false;
  }
  updater_type_ = UpdaterFromName(upd);
  std::string lvl = configure::GetString("log_level");
  Log::SetLevel(lvl == "debug" ? LogLevel::kDebug
                : lvl == "error" ? LogLevel::kError
                : lvl == "fatal" ? LogLevel::kFatal
                                 : LogLevel::kInfo);
  Log::ResetLogFile(configure::GetString("log_file"));

  rank_ = 0;
  size_ = 1;
  worker_ranks_ = {0};
  server_ranks_ = {0};
  std::string machine_file = configure::GetString("machine_file");
  std::string ctrl = configure::GetString("controller_endpoint");
  std::string net_type = configure::GetString("net_type");
  if (net_type != "tcp" && net_type != "mpi") {
    Log::Error("unknown -net_type '%s' (expected tcp|mpi)",
               net_type.c_str());
    return false;
  }
  // Readiness-model seam (docs/transport.md): -net_engine picks the
  // transport engine.  `epoll` (the default) and `tcp` are the two TCP
  // engines behind MakeRankTransport; `mpi` forces the MPI wire (the
  // legacy -net_type=mpi spelling still works and wins).
  std::string engine = configure::GetString("net_engine");
  if (engine != "tcp" && engine != "epoll" && engine != "mpi" &&
      engine != "uring") {
    Log::Error("unknown -net_engine '%s' (expected tcp|epoll|mpi|uring)",
               engine.c_str());
    return false;
  }
  engine_requested_ = engine;
  engine_fallback_ = false;
  if (engine == "uring") {
    // Capability probe (docs/transport.md "io_uring data plane"): the
    // uring engine needs io_uring_setup plus a handful of opcodes.  A
    // kernel that can't run it degrades to epoll — same message
    // semantics, just the readiness model — with the reason logged and
    // the downgrade visible in the health report (`effective_engine`).
    std::string why;
    if (!uring::Probe(&why)) {
      Log::Info("-net_engine=uring unavailable (%s): falling back to "
                "epoll", why.c_str());
      ops::BlackboxEvent("lifecycle",
                         "net_engine fallback uring->epoll: " + why);
      engine = "epoll";
      engine_fallback_ = true;
    }
  }
  if (net_type == "mpi" || engine == "mpi") {
    // Literal MPI wire (reference net/mpi_net.h, SURVEY §2.17): rank and
    // size come from MPI itself — machine_file / -rank / registration
    // are TCP-mode concepts and are ignored.  Every rank is
    // worker + server (the reference's MPI static mode, Role::All).
    auto mpi = std::make_unique<MpiNet>();
    if (!mpi->Init([this](Message&& m) { RouteInbound(std::move(m)); }))
      return false;
    rank_ = mpi->rank();
    size_ = mpi->size();
    std::string role_str = configure::GetString("role");
    if (role_str != "all")
      Log::Info("-net_type=mpi ignores -role=%s: MPI static mode runs "
                "every rank as worker+server (use the registration "
                "transport for split roles)", role_str.c_str());
    SetRoles(std::vector<int>(size_, kRoleWorker | kRoleServer));
    net_ = std::move(mpi);
  } else if (!ctrl.empty()) {
    // Dynamic registration (reference Control_Register, SURVEY §2.7):
    // no machine file, no -rank — the controller assigns ranks and
    // broadcasts the node table; roles can differ per process.
    std::string role_str = configure::GetString("role");
    if (role_str != "worker" && role_str != "server" && role_str != "all") {
      // A typo must not silently become a full worker+server node (it
      // would host an unintended shard and shift every worker_id).
      Log::Error("unknown -role '%s' (expected worker|server|all)",
                 role_str.c_str());
      return false;
    }
    int role = role_str == "worker" ? kRoleWorker
               : role_str == "server" ? kRoleServer
                                      : (kRoleWorker | kRoleServer);
    int num = static_cast<int>(configure::GetInt("num_nodes"));
    std::vector<std::string> endpoints;
    std::vector<int> roles;
    bool ok;
    if (configure::GetBool("is_controller")) {
      rank_ = 0;
      ok = TcpNet::RegisterController(ctrl, num, role, &endpoints, &roles,
                                      configure::GetInt("rpc_timeout_ms"));
    } else {
      std::string me = configure::GetString("node_host") + ":" +
                       std::to_string(configure::GetInt("port"));
      ok = TcpNet::RegisterWithController(
          ctrl, me, role, configure::GetInt("connect_retry_ms"),
          &endpoints, &roles, &rank_);
    }
    if (!ok) {
      Log::Error("dynamic registration failed (controller=%s)",
                 ctrl.c_str());
      return false;
    }
    size_ = static_cast<int>(endpoints.size());
    SetRoles(roles);
    if (size_ > 1) {
      auto wire = MakeRankTransport(engine);
      if (!wire ||
          !wire->Init(endpoints, rank_,
                      [this](Message&& m) { RouteInbound(std::move(m)); },
                      configure::GetInt("connect_retry_ms")))
        return false;
      net_ = std::move(wire);
    }
  } else if (!machine_file.empty()) {
    auto endpoints = TcpNet::ParseMachineFile(machine_file);
    if (endpoints.size() > 1) {
      rank_ = static_cast<int>(configure::GetInt("rank"));
      size_ = static_cast<int>(endpoints.size());
      // Static mode: every rank is worker + server (reference Role::All).
      SetRoles(std::vector<int>(size_, kRoleWorker | kRoleServer));
      auto wire = MakeRankTransport(engine);
      if (!wire ||
          !wire->Init(endpoints, rank_,
                      [this](Message&& m) { RouteInbound(std::move(m)); },
                      configure::GetInt("connect_retry_ms")))
        return false;
      net_ = std::move(wire);
    }
  }

  worker_actor_ = std::make_unique<WorkerActor>();
  server_actor_ = std::make_unique<ServerActor>();
  controller_actor_ = std::make_unique<ControllerActor>();
  worker_actor_->Start();
  server_actor_->Start();
  controller_actor_->Start();
  if (size_ > 1 && configure::GetInt("heartbeat_ms") > 0) {
    {
      MutexLock hlk(hb_mu_);
      hb_last_seen_.assign(static_cast<size_t>(size_), NowMs());
      hb_dead_.assign(static_cast<size_t>(size_), false);
    }
    hb_running_ = true;
    hb_thread_ = std::thread([this] { HeartbeatLoop(); });
  }
  // Observability: rank-salt span ids (and the pid column of span
  // dumps); `-trace=true` arms span recording from the first op.
  Dashboard::SetTraceRank(rank_);
  // Workload plane (docs/observability.md): latch the hot-key/load
  // accounting arm switch from the flag (MV_SetHotKeyTracking toggles
  // it live for armed-vs-disarmed overhead A/Bs).
  workload::Arm(configure::GetBool("hotkey_enabled"));
  workload::ArmReplica(configure::GetBool("hotkey_replica"));
  // Capacity plane (docs/observability.md "capacity plane"): -capacity_
  // enabled latches the byte accounting; MV_SetCapacityTracking toggles
  // live (re-arming resyncs every shard's counters).
  capacity::Arm(configure::GetBool("capacity_enabled"));
  capacity::ResetHistory();
  // Byte gauges into the shared registry (the "capacity" report's
  // gauges object): the arena and the engine write queues are the two
  // native non-table byte holders; Python-plane caches register into
  // the metrics-side mirror (multiverso_tpu_torch/capacity.py).
  capacity::RegisterGauge("host_arena.bytes", [] {
    return HostArena::Get()->GetStats().bytes;
  });
  capacity::RegisterGauge("net.writeq_bytes", [this]() -> long long {
    return net_ ? net_->QueuedBytes() : 0;
  });
  // Receive-side mirror of the write-queue gauge: reassembly slabs on
  // the epoll engine, registered buffer pools + heap fallback slabs on
  // the uring engine (transport memory mvplan placement math must see).
  capacity::RegisterGauge("net.rx_arena_bytes", [this]() -> long long {
    return net_ ? net_->RxArenaBytes() : 0;
  });
  // Delivery-audit plane (docs/observability.md "audit plane"): -audit
  // latches the seq stamping + server books; MV_SetAudit toggles live.
  audit::Arm(configure::GetBool("audit"));
  // Shard replication (docs/replication.md): -replication_factor arms
  // the primary→backup forward stream (factor 1, chained assignment);
  // meaningful only with >1 server rank.  The routing table starts at
  // epoch 0 = the registration-time shard map.
  repl::Arm(configure::GetInt("replication_factor") > 0 &&
            num_servers() > 1);
  repl::ArmSync(configure::GetBool("repl_sync"));
  {
    MutexLock rlk(route_mu_);
    routing_epoch_.store(0, std::memory_order_release);
    route_owner_ = server_ranks_;
    route_backup_.assign(server_ranks_.size(), -1);
    promoted_.assign(server_ranks_.size(), false);
    backup_shard_ = -1;
    int n = static_cast<int>(server_ranks_.size());
    if (repl::Armed() && n > 1) {
      // Chained assignment: shard i's backup is server i+1 mod n, so
      // server j backs shard j-1 mod n.
      for (int i = 0; i < n; ++i)
        route_backup_[i] = server_ranks_[(i + 1) % n];
      int sid = server_id();
      if (sid >= 0) backup_shard_ = (sid - 1 + n) % n;
    }
  }
  // Tail plane (docs/serving.md "tail"): latch the tenant classes,
  // per-class admission budgets, and deadline-stamp switch.
  qos::Configure();
  qos::Reset();
  // Latency plane (docs/observability.md): -wire_timing latches the
  // header-trail stamping; -profile_hz boots the SIGPROF sampler.
  latency::Arm(configure::GetBool("wire_timing"));
  if (configure::GetInt("profile_hz") > 0)
    profiler::Start(static_cast<int>(configure::GetInt("profile_hz")));
  // Health plane (docs/observability.md "health plane"): the stall
  // watchdog's checker boots AFTER the loops it watches exist; its
  // stall dump reuses the profiler's folded stacks when armed.
  if (configure::GetInt("watchdog_stall_ms") > 0)
    watchdog::Arm(static_cast<int>(configure::GetInt("watchdog_stall_ms")));
  if (configure::GetBool("trace")) Dashboard::SetTraceEnabled(true);
  started_ = true;
  ops::BlackboxEvent("lifecycle",
                     "start rank " + std::to_string(rank_) + "/" +
                         std::to_string(size_) + " engine=" + net_engine());
  Log::Info("mvtpu native runtime started (rank %d/%d, updater=%s, "
            "engine=%s)", rank_, size_, upd.c_str(), net_engine());
  return true;
}

const char* Zoo::net_engine() const {
  // Phase-stable like net_ itself (set by Start, cleared by the Stop
  // latch winner); "local" = single process, no wire at all.
  return net_ ? net_->engine() : "local";
}

Net::FanInStats Zoo::FanIn() const {
  return net_ ? net_->FanIn() : Net::FanInStats{};
}

void Zoo::Stop() {
  {
    // First Stop wins the latch; a concurrent second Stop returns here
    // instead of re-joining/resetting actors mid-teardown (a UB hole
    // the thread-safety annotations flagged: both callers used to pass
    // the old started_ check before either cleared it).
    MutexLock lk(mu_);
    if (!started_.exchange(false)) return;
  }
  // Cross-process: no rank may tear down while peers still need its
  // server shard — rendezvous first (also flushes every pipeline,
  // aggregated adds included).  Single-process: drain the aggregation
  // buffers directly so no absorbed add dies with the runtime.
  if (size_ > 1) Barrier();
  else FlushWorkerAdds();
  ops::BlackboxEvent("lifecycle", "stop rank " + std::to_string(rank_));
  // Watchdog off FIRST: the loops it watches are about to be joined,
  // and a legitimately-exiting loop must never read as a stall.
  watchdog::Arm(0);
  if (configure::GetInt("profile_hz") > 0) profiler::Stop();
  // Lease loop dies before the transport it sends through.
  if (hb_running_.exchange(false)) {
    if (hb_thread_.joinable()) hb_thread_.join();
  }
  // Detached fleet-ops aggregation threads send through net_ — give
  // them a bounded window to finish before the transport dies (their
  // deadline is -ops_fleet_timeout_ms, so this drain is bounded too).
  for (int i = 0; i < 500 && ops_inflight_.load() > 0; ++i)
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  // Un-waited async-get tickets hold pointers into the worker tables —
  // reclaim them before the registry dies (c_api.cc).
  CApiReclaimAsyncGets();
  // Join OUTSIDE mu_ (a draining handler may SendTo, which takes mu_):
  // snapshot the pointers under the lock, stop through the snapshots —
  // only the latch winner reaches here, so the pointees are stable.
  // Pipeline order so queued async adds apply before teardown.
  Actor* worker;
  Actor* server;
  Actor* controller;
  Net* net;
  {
    MutexLock lk(mu_);
    worker = worker_actor_.get();
    server = server_actor_.get();
    controller = controller_actor_.get();
    net = net_.get();
  }
  if (worker) worker->Stop();
  if (server) server->Stop();
  if (controller) controller->Stop();
  if (net) net->Stop();
  // Capacity gauges die with the runtime they read (a scrape after
  // Stop must not chase a dead transport).
  capacity::UnregisterGauge("net.rx_arena_bytes");
  capacity::UnregisterGauge("net.writeq_bytes");
  capacity::UnregisterGauge("host_arena.bytes");
  capacity::ResetHistory();
  MutexLock lk(mu_);
  worker_actor_.reset();
  server_actor_.reset();
  controller_actor_.reset();
  net_.reset();
  {
    MutexLock tlk(tables_mu_);
    server_tables_.clear();
    worker_tables_.clear();
    backup_tables_.clear();
    table_specs_.clear();
  }
  {
    MutexLock rlk(route_mu_);
    route_owner_.clear();
    route_backup_.clear();
    promoted_.clear();
    backup_shard_ = -1;
    routing_epoch_.store(0, std::memory_order_release);
  }
  {
    MutexLock plk(repl_mu_);
    parked_acks_.clear();
    snapshot_pending_.clear();
  }
  repl_outstanding_.store(0);
  rank_ = 0;
  size_ = 1;
  worker_ranks_ = {0};
  server_ranks_ = {0};
  {
    MutexLock blk(barrier_mu_);
    barrier_arrived_.clear();
    barrier_failed_ = false;
  }
  {
    MutexLock hlk(hb_mu_);
    hb_last_seen_.clear();
    hb_dead_.clear();
  }
  Log::Info("%s", Dashboard::Report().c_str());
}

void Zoo::FlushWorkerAdds() {
  // Drain every table's add-aggregation buffer onto the wire
  // (docs/wire_compression.md).  Pointers copied out of tables_mu_
  // before the flush runs: FlushAdds takes the table's own agg lock and
  // enqueues sends — doing that under tables_mu_ could deadlock against
  // a service path that needs the registry.
  std::vector<WorkerTable*> snapshot;
  {
    MutexLock lk(tables_mu_);
    for (auto& t : worker_tables_)
      if (t) snapshot.push_back(t.get());
  }
  for (auto* t : snapshot) t->FlushAdds();
}

bool Zoo::FlushPipelines() {
  // Aggregated adds first: the RequestFlush below must ride BEHIND them
  // on every connection, so "flush acked" still means "adds applied" —
  // the invariant Barrier's BSP guarantee stands on.
  FlushWorkerAdds();
  if (!net_) return true;
  // Targets follow the ROUTED shard map (docs/replication.md): after a
  // promotion the dead rank owns nothing, so the flush drains the live
  // owners instead of latching barrier_failed_ on a corpse forever.
  std::vector<int> targets;
  for (int s = 0; s < num_servers(); ++s) {
    int r = server_rank(s);
    if (r != rank_ &&
        std::find(targets.begin(), targets.end(), r) == targets.end())
      targets.push_back(r);
  }
  if (targets.empty()) return true;
  int64_t id = NextMsgId();
  auto waiter = std::make_shared<Waiter>(static_cast<int>(targets.size()));
  {
    MutexLock lk(flush_mu_);
    flush_pending_[id] = waiter;
  }
  for (int s : targets) {
    auto msg = std::make_unique<Message>();
    msg->type = MsgType::RequestFlush;
    msg->msg_id = id;
    msg->src = rank_;
    msg->dst = s;
    SendTo(actor::kWorker, std::move(msg));
  }
  bool ok = waiter->WaitFor(configure::GetInt("rpc_timeout_ms"));
  MutexLock lk(flush_mu_);
  flush_pending_.erase(id);
  if (!ok)
    Log::Error("Zoo::FlushPipelines: timed out (rank %d)", rank_);
  return ok;
}

void Zoo::OnFlushReply(int64_t msg_id) {
  MutexLock lk(flush_mu_);
  auto it = flush_pending_.find(msg_id);
  if (it != flush_pending_.end()) it->second->Notify();
}

bool Zoo::Barrier() {
  Monitor mon("Zoo::Barrier");
  {
    MutexLock lk(barrier_mu_);
    barrier_failed_ = false;  // fresh round; flush may re-latch it
  }
  // First drain this rank's async pipeline INTO EVERY REMOTE SHARD:
  // barrier-arrive rides the connection to rank 0 only, so without this
  // an async add to a third rank could still be in flight when the
  // release lands (observed at n=4).
  bool flushed = FlushPipelines();
  auto waiter = std::make_shared<Waiter>(1);
  int64_t round;
  {
    MutexLock lk(barrier_mu_);
    barrier_waiter_ = waiter;
    // OR, don't assign: a dead shard latched barrier_failed_ during the
    // flush (Deliver's RequestFlush case) and that must survive.
    barrier_failed_ = barrier_failed_ || !flushed;
    round = ++barrier_round_;
  }
  auto msg = std::make_unique<Message>();
  msg->type = MsgType::ControlBarrier;
  msg->msg_id = round;  // round tag: lets stale releases be dropped
  msg->src = rank_;
  msg->dst = 0;
  SendTo(actor::kWorker, std::move(msg));
  // Default (<=0) waits forever — BSP semantics; a deadline turns a dead
  // peer into an error return instead of a hang (the release message may
  // still arrive later: OnBarrierRelease tolerates a cleared waiter).
  bool ok = waiter->WaitFor(configure::GetInt("barrier_timeout_ms"));
  if (!ok) {
    // Name the unresponsive rank(s): the authority knows exactly who
    // never announced arrival; everyone else can only name the silent
    // authority.  Dead-lease info (heartbeats) rides along when on.
    std::string who;
    if (rank_ == 0) {
      MutexLock lk(barrier_mu_);
      for (int r = 0; r < size_; ++r) {
        bool arrived = r < static_cast<int>(barrier_arrived_.size()) &&
                       barrier_arrived_[r];
        if (!arrived) who += (who.empty() ? "" : ",") + std::to_string(r);
      }
    } else {
      who = "0 (barrier authority)";
    }
    Log::Error("Zoo::Barrier: rank %d timed out after %lld ms waiting "
               "for rank(s) %s",
               rank_,
               static_cast<long long>(
                   configure::GetInt("barrier_timeout_ms")),
               who.c_str());
    for (int r : DeadPeers())
      Log::Error("Zoo::Barrier: rank %d's heartbeat lease is expired "
                 "(likely dead)", r);
    // Flight-recorder trigger (docs/observability.md): a barrier that
    // timed out is exactly the moment a post-mortem needs the recent
    // spans/events — dump the black box naming the missing rank(s).
    ops::BlackboxTrigger("barrier_timeout: waiting for rank(s) " + who);
  }
  bool failed;
  {
    MutexLock lk(barrier_mu_);
    barrier_waiter_.reset();
    failed = barrier_failed_;
  }
  if (ok && !failed) {
    // Clock boundary: peers' adds are applied — drop worker-side row
    // caches (SparseMatrixWorkerTable) so post-barrier Gets see them.
    // Pointers copied OUT of tables_mu_ before the hooks run: a hook
    // takes its cache lock, which another thread may hold across a
    // blocking fetch whose service path needs tables_mu_ — invoking
    // under the lock would close that cycle into a deadlock.  (Tables
    // are never unregistered, so the copied pointers stay valid.)
    std::vector<WorkerTable*> snapshot;
    {
      MutexLock lk(tables_mu_);
      for (auto& t : worker_tables_)
        if (t) snapshot.push_back(t.get());
    }
    for (auto* t : snapshot) t->OnClockInvalidate();
  }
  return ok && !failed;
}

void Zoo::OnBarrierArrive(int src_rank, int64_t round) {
  std::vector<std::pair<int, int64_t>> release;  // (rank, its round)
  {
    MutexLock lk(barrier_mu_);
    if (barrier_arrived_.size() != static_cast<size_t>(size_))
      barrier_arrived_.assign(size_, false);
    if (barrier_rounds_.size() != static_cast<size_t>(size_))
      barrier_rounds_.assign(size_, 0);
    if (src_rank < 0 || src_rank >= size_) return;
    // Track the rank's LATEST round even on a duplicate arrive: a retry
    // after an abandoned round re-announces with round k+1, and the
    // eventual release must echo that so the retry's waiter accepts it.
    if (round > barrier_rounds_[src_rank]) barrier_rounds_[src_rank] = round;
    // Per-rank, not per-message: a retry after an abandoned (timed-out)
    // round must not double-count toward the quorum.
    if (barrier_arrived_[src_rank]) return;
    barrier_arrived_[src_rank] = true;
    // Elastic membership (docs/replication.md): with replication armed
    // a peer whose heartbeat lease is expired is EXCUSED from the
    // quorum — the fleet rendezvouses without the corpse instead of
    // timing out, which is what lets survivors keep running (and shut
    // down cleanly) after a failover.  Without replication the old
    // strict quorum stands: a silent rank is an error, not a member
    // change.
    for (int r = 0; r < size_; ++r) {
      if (barrier_arrived_[r]) continue;
      if (repl::Armed()) {
        MutexLock hlk(hb_mu_);
        if (r < static_cast<int>(hb_dead_.size()) && hb_dead_[r]) {
          Log::Info("Zoo::Barrier: excusing dead-leased rank %d from "
                    "the quorum", r);
          continue;
        }
      }
      return;
    }
    barrier_arrived_.assign(size_, false);
    for (int r = 0; r < size_; ++r)
      release.emplace_back(r, barrier_rounds_[r]);
  }
  // Remote releases FIRST, the local one last: the local release wakes
  // this rank's Barrier() caller, and anything it does next (e.g. the
  // chaos suite arming a fault) must not race releases still queued for
  // the wire.
  for (auto& [r, r_round] : release) {
    if (r == rank_) continue;
    Message reply;
    reply.type = MsgType::ControlBarrierReply;
    reply.msg_id = r_round;  // echo the receiver's announced round
    reply.src = rank_;
    reply.dst = r;
    net_->Send(r, reply);
  }
  for (auto& [r, r_round] : release)
    if (r == rank_) OnBarrierRelease(r_round);
}

void Zoo::OnBarrierRelease(int64_t round) {
  MutexLock lk(barrier_mu_);
  // round >= 0: a wire release — drop it unless it matches the waiter's
  // current round (a late round-k release after a timeout must not free
  // the round-k+1 rendezvous).  round < 0: local failure path, always
  // releases (barrier_failed_ is already latched).
  if (round >= 0 && round != barrier_round_) {
    Log::Debug("Zoo::OnBarrierRelease: dropping stale release "
               "(round %lld, current %lld)",
               static_cast<long long>(round),
               static_cast<long long>(barrier_round_));
    return;
  }
  if (barrier_waiter_) barrier_waiter_->Notify();
}

void Zoo::HeartbeatLoop() {
  const int64_t interval = configure::GetInt("heartbeat_ms");
  int64_t timeout = configure::GetInt("heartbeat_timeout_ms");
  if (timeout <= 0) timeout = 5 * interval;
  // SYMMETRIC lease renewal (docs/replication.md): every rank —
  // rank 0 included — announces to EVERY peer, so every survivor can
  // detect any corpse, rank 0 itself included (the old rank-0-only
  // watch left a backup blind exactly when the lease authority was
  // the one that died).  ONE SENDER THREAD PER PEER: a send to a dead
  // peer blocks in the transport's reconnect/backoff for whole lease
  // windows, and a single shared sender stalling there would starve
  // the renewals every LIVE peer's lease depends on — the mutual
  // false-dead cascade the failover chaos scenario caught.  The
  // rank→0 renewal keeps its timing trail: rank 0's echo closes an
  // NTP offset sample (docs/observability.md); renewals to other
  // peers ship bare.  A failed send is already logged by the
  // transport; the lease simply expires on the peer's side.
  std::vector<std::thread> senders;
  for (int peer = 0; peer < size_; ++peer) {
    if (peer == rank_) continue;
    senders.emplace_back([this, peer, interval] {
      // Stop clears hb_running_ before it joins this sender: a send
      // caught reconnecting to a peer that already left gives up then.
      transport::SetConnectGuard(&hb_running_);
      while (hb_running_) {
        for (int64_t slept = 0; slept < interval && hb_running_;
             slept += 20)
          std::this_thread::sleep_for(std::chrono::milliseconds(
              std::min<int64_t>(20, interval - slept)));
        if (!hb_running_) break;
        Message hb;
        hb.type = MsgType::Heartbeat;
        hb.src = rank_;
        hb.dst = peer;
        if (peer == 0) {
          latency::StampEnqueue(&hb);
          latency::StampSend(&hb);
        }
        if (net_) net_->Send(peer, hb);
      }
    });
  }
  // Watchdog (docs/observability.md "health plane"): the lease scan is
  // permanently "busy" while running — a wedged scan means every peer
  // death goes undetected.  -watchdog_stall_ms must therefore exceed
  // -heartbeat_ms (the scan's legitimate period).
  watchdog::Busy("hb.lease", 1);
  while (hb_running_) {
    // Sleep in small steps so Stop never waits a full interval.
    for (int64_t slept = 0; slept < interval && hb_running_; slept += 20)
      std::this_thread::sleep_for(std::chrono::milliseconds(
          std::min<int64_t>(20, interval - slept)));
    if (!hb_running_) break;
    watchdog::Bump("hb.lease");
    // Scan the leases (every rank, not just rank 0).  A peer
    // transitions to dead ONCE per outage (hb.missed counts outages,
    // not scans) and recovers when a late heartbeat arrives.  With
    // replication armed the expiry is no longer report-only: the
    // backup promotes (docs/replication.md); otherwise eviction/
    // replacement stays the operator's call.
    int64_t now = NowMs();
    std::vector<int> newly_dead;
    {
      MutexLock lk(hb_mu_);
      for (int r = 0; r < size_; ++r) {
        if (r == rank_) continue;
        bool silent = now - hb_last_seen_[r] > timeout;
        if (silent && !hb_dead_[r]) {
          hb_dead_[r] = true;
          Dashboard::Record("hb.missed", 0.0);
          Log::Error("heartbeat: rank %d silent for over %lld ms — lease "
                     "expired, reporting peer dead",
                     r, static_cast<long long>(timeout));
          newly_dead.push_back(r);
        }
      }
    }
    // Blackbox dump OUTSIDE hb_mu_ (it reads zoo state): a dead peer is
    // a first-class failure trigger (docs/observability.md).
    for (int r : newly_dead) {
      ops::BlackboxTrigger("dead_peer: rank " + std::to_string(r) +
                           " silent past the heartbeat lease");
      OnPeerDead(r);
    }
    // Sync-replication hygiene: a parked ack whose backup never
    // answered must not wedge the client past its deadline.
    ReleaseParkedAcks(/*all=*/false);
  }
  watchdog::Busy("hb.lease", 0);  // clean exit is idle, not a stall
  for (auto& t : senders) t.join();
}

void Zoo::OnHeartbeat(int src_rank) {
  MutexLock lk(hb_mu_);
  if (src_rank < 0 || src_rank >= static_cast<int>(hb_last_seen_.size()))
    return;
  hb_last_seen_[src_rank] = NowMs();
  if (hb_dead_[src_rank]) {
    hb_dead_[src_rank] = false;
    Log::Info("heartbeat: rank %d is back — lease renewed", src_rank);
  }
}

int Zoo::DeadPeerCount() {
  MutexLock lk(hb_mu_);
  int n = 0;
  for (bool d : hb_dead_) n += d ? 1 : 0;
  return n;
}

std::vector<int> Zoo::DeadPeers() {
  MutexLock lk(hb_mu_);
  std::vector<int> out;
  for (size_t r = 0; r < hb_dead_.size(); ++r)
    if (hb_dead_[r]) out.push_back(static_cast<int>(r));
  return out;
}

// ---- shard replication + failover (docs/replication.md) ---------------

int Zoo::server_rank(int idx) const {
  MutexLock lk(route_mu_);
  if (idx >= 0 && idx < static_cast<int>(route_owner_.size()))
    return route_owner_[idx];
  return (idx >= 0 && idx < static_cast<int>(server_ranks_.size()))
             ? server_ranks_[idx]
             : 0;
}

std::vector<int> Zoo::RouteOwners() const {
  MutexLock lk(route_mu_);
  return route_owner_;
}

std::vector<int> Zoo::RouteBackups() const {
  MutexLock lk(route_mu_);
  return route_backup_;
}

int Zoo::BackupShard() const {
  MutexLock lk(route_mu_);
  return backup_shard_;
}

ServerTable* Zoo::backup_table(int32_t id) {
  MutexLock lk(tables_mu_);
  return (id >= 0 && id < static_cast<int32_t>(backup_tables_.size()))
             ? backup_tables_[id].get()
             : nullptr;
}

ServerTable* Zoo::RoutedServerTable(const Message& msg) {
  // LOCK ORDER: route_mu_ is released before the table registry lookup
  // (never nest tables_mu_ under it).
  int hint = msg.shard;
  if (hint >= 0 && hint != server_id()) {
    bool backed;
    {
      MutexLock lk(route_mu_);
      backed = backup_shard_ == hint ||
               (hint < static_cast<int>(promoted_.size()) &&
                promoted_[hint]);
    }
    if (backed) {
      ServerTable* bt = backup_table(msg.table_id);
      if (bt) return bt;
    }
  }
  return server_table(msg.table_id);
}

bool Zoo::ForwardAddToBackup(const Message& m, MessagePtr* reply) {
  if (!repl::Armed()) return false;
  int shard = m.shard >= 0 ? m.shard : server_id();
  int backup = -1;
  {
    MutexLock lk(route_mu_);
    if (shard < 0 || shard >= static_cast<int>(route_backup_.size()))
      return false;
    if (route_owner_[shard] != rank_) return false;  // not the primary
    backup = route_backup_[shard];
  }
  if (backup < 0 || backup == rank_ || !net_) return false;
  // Lease check (defense in depth): a stale adopted map may still name
  // a dead backup — forwarding there would park the apply thread in
  // the transport's reconnect backoff for whole lease windows.
  {
    MutexLock lk(hb_mu_);
    if (backup < static_cast<int>(hb_dead_.size()) && hb_dead_[backup])
      return false;
  }
  // Bounded-lag backpressure (async mode): the apply thread stalls
  // while the forward/ack gap exceeds -repl_lag_max, deadline-bounded
  // so a dying backup degrades instead of wedging the shard.  Sync
  // mode needs no gap bound — every client add parks on its own ack.
  int64_t lag_max = configure::GetInt("repl_lag_max");
  if (!repl::Sync() && lag_max > 0 &&
      repl_outstanding_.load() >= lag_max) {
    repl::NoteLagWait();
    Dashboard::Record("repl.lag_wait", 0.0);
    int64_t deadline = NowMs() + 2000;
    while (repl_outstanding_.load() >= lag_max && NowMs() < deadline)
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  int64_t fwd_id = NextMsgId();
  Message fwd;
  fwd.type = MsgType::ReplForward;
  fwd.table_id = m.table_id;
  fwd.msg_id = fwd_id;
  fwd.trace_id = m.trace_id;
  fwd.shard = shard;
  fwd.version = m.src;  // ORIGIN rank: the backup books its watermark
  fwd.src = rank_;
  fwd.dst = backup;
  if (m.has_audit()) {
    fwd.flags |= msgflag::kHasAudit;
    fwd.audit = m.audit;
  }
  fwd.data = m.data;  // decoded payload; shallow blob copies share bytes
  bool parked = false;
  if (reply && *reply && repl::Sync()) {
    // Park BEFORE the send so a lightning-fast ReplAck can never race
    // an unparked reply; a failed send takes it right back out.
    int64_t t = configure::GetInt("rpc_timeout_ms");
    MutexLock lk(repl_mu_);
    parked_acks_[fwd_id] =
        ParkedAck{NowMs() + (t > 0 ? t / 2 : 2000), std::move(*reply)};
    parked = true;
    repl::NoteParked();
  }
  repl_outstanding_.fetch_add(1);
  repl::NoteForward();
  // Replication-lag ledger on the µs-bucket ladder (1 unit = 1
  // outstanding forward) — the bounded-lag gauge the staleness
  // histogram discipline measures (docs/observability.md).
  Dashboard::Record("repl.lag",
                    static_cast<double>(repl_outstanding_.load()) * 1e-6);
  Dashboard::Record("repl.forward", 0.0);
  if (!net_->Send(backup, fwd)) {
    repl_outstanding_.fetch_add(-1);
    if (parked) {
      MutexLock lk(repl_mu_);
      auto it = parked_acks_.find(fwd_id);
      if (it != parked_acks_.end()) {
        *reply = std::move(it->second.reply);
        parked_acks_.erase(it);
        parked = false;
      }
    }
  }
  return parked;
}

void Zoo::OnReplForward(MessagePtr msg) {
  latency::StampDequeue(msg.get());
  int primary = msg->src;
  int origin = static_cast<int>(msg->version);
  ServerTable* bt = nullptr;
  {
    bool mine;
    {
      MutexLock lk(route_mu_);
      mine = backup_shard_ == msg->shard;
    }
    if (mine) bt = backup_table(msg->table_id);
  }
  if (!bt) {
    Dashboard::Record("repl.forward_orphan", 0.0);
    Log::Error("ReplForward for table %d shard %d: no backup instance",
               msg->table_id, msg->shard);
    return;
  }
  TraceScope scope(msg->trace_id);
  // Apply under the ORIGIN's identity so the backup's delivery book
  // carries the same per-origin watermark the primary's does — what
  // lets mvaudit diff primary vs backup and post-failover retries
  // dedup against the promoted shard.
  msg->src = origin;
  bt->ProcessAdd(*msg);
  bt->NoteAuditApply(*msg);
  repl::NoteApplied();
  Dashboard::Record("repl.apply", 0.0);
  if (!net_) return;
  Message ack;
  ack.type = MsgType::ReplAck;
  ack.table_id = msg->table_id;
  ack.msg_id = msg->msg_id;
  ack.shard = msg->shard;
  ack.src = rank_;
  ack.dst = primary;
  net_->Send(primary, ack);
}

void Zoo::OnReplAck(MessagePtr msg) {
  repl_outstanding_.fetch_add(-1);
  repl::NoteAck();
  MessagePtr parked;
  {
    MutexLock lk(repl_mu_);
    auto it = parked_acks_.find(msg->msg_id);
    if (it != parked_acks_.end()) {
      parked = std::move(it->second.reply);
      parked_acks_.erase(it);
    }
  }
  // Sync replication: "acked" now means applied on BOTH replicas.
  // Runs ON THE REACTOR THREAD (RouteInbound): never Deliver at a
  // lease-dead destination from here — the transport's reconnect
  // backoff would stall the reactor for whole lease windows, starving
  // heartbeat receipt into false-positive expiries (observed as a
  // live peer's lease flapping right after a real kill).
  if (!parked) return;
  int dst = parked->dst;
  {
    MutexLock lk(hb_mu_);
    if (dst >= 0 && dst < static_cast<int>(hb_dead_.size()) &&
        hb_dead_[dst])
      return;  // the client is a corpse; nothing waits for this ack
  }
  Deliver(actor::kWorker, std::move(parked));
}

void Zoo::OnShardSnapshot(MessagePtr msg) {
  latency::StampDequeue(msg.get());
  if (msg->data.empty()) {
    // Request: serve a whole-shard snapshot of the shard we own under
    // this hint.  Runs on the server actor, so it serializes against
    // ProcessAdd — every later delta reaches the requester as a
    // ReplForward BEHIND this reply on the same connection (FIFO).
    auto* table = RoutedServerTable(*msg);
    if (!table) {
      Log::Error("ShardSnapshot request for table %d on non-server rank",
                 msg->table_id);
      return;
    }
    repl::MemStream ms;
    if (!table->Store(&ms)) {
      Log::Error("ShardSnapshot: Store failed for table %d",
                 msg->table_id);
      return;
    }
    auto marks = table->audit_book().ExportWatermarks();
    std::vector<int64_t> wm;
    wm.reserve(marks.size() * 2);
    for (const auto& [o, mark] : marks) {
      wm.push_back(o);
      wm.push_back(mark);
    }
    auto reply = std::make_unique<Message>();
    reply->type = MsgType::ShardSnapshot;
    reply->table_id = msg->table_id;
    reply->msg_id = msg->msg_id;
    reply->trace_id = msg->trace_id;
    reply->shard = msg->shard;
    reply->version = table->version();
    reply->src = rank_;
    reply->dst = msg->src;
    reply->data.emplace_back(ms.bytes().data(), ms.bytes().size());
    if (!wm.empty())
      reply->data.emplace_back(wm.data(), wm.size() * sizeof(int64_t));
    repl::NoteSnapshot();
    Dashboard::Record("repl.snapshot", 0.0);
    Deliver(actor::kServer, std::move(reply));
    return;
  }
  // Reply: install the snapshot into our backup instance.  Forwards
  // already applied before the install are INSIDE the snapshot (the
  // primary serialized it after them); forwards sent after it arrive
  // behind this frame — either way the bytes converge.
  bool mine;
  {
    MutexLock lk(route_mu_);
    mine = backup_shard_ == msg->shard;
  }
  ServerTable* bt = mine ? backup_table(msg->table_id) : nullptr;
  if (!bt) {
    Log::Error("ShardSnapshot reply for table %d shard %d: no backup "
               "instance", msg->table_id, msg->shard);
  } else {
    repl::MemStream ms(
        std::string(msg->data[0].data(), msg->data[0].size()));
    if (!bt->Load(&ms)) {
      Log::Error("ShardSnapshot: install failed for table %d",
                 msg->table_id);
    } else {
      if (msg->data.size() > 1) {
        const int64_t* wm = msg->data[1].As<int64_t>();
        size_t n = msg->data[1].count<int64_t>() / 2;
        std::vector<std::pair<int, int64_t>> marks;
        marks.reserve(n);
        for (size_t i = 0; i < n; ++i)
          marks.emplace_back(static_cast<int>(wm[2 * i]), wm[2 * i + 1]);
        bt->audit_book().ImportWatermarks(marks);
      }
      // Adopt the primary's version so post-promotion reply stamps
      // never run BEHIND what clients already observed (stale cache
      // hits would otherwise look fresh).
      bt->AdvanceVersionTo(msg->version);
      repl::NoteCatchup();
      Dashboard::Record("repl.catchup", 0.0);
    }
  }
  std::shared_ptr<Waiter> w;
  {
    MutexLock lk(repl_mu_);
    auto it = snapshot_pending_.find(msg->msg_id);
    if (it != snapshot_pending_.end()) w = it->second;
  }
  if (w) w->Notify();
}

void Zoo::BroadcastRoutingEpoch(int64_t epoch,
                                const std::vector<int>& owners,
                                const std::vector<int>& backups) {
  if (!net_) return;
  std::vector<int32_t> own(owners.begin(), owners.end());
  std::vector<int32_t> bak(backups.begin(), backups.end());
  for (int r = 0; r < size_; ++r) {
    if (r == rank_) continue;
    Message m;
    m.type = MsgType::RoutingEpoch;
    m.msg_id = epoch;
    m.src = rank_;
    m.dst = r;
    m.data.emplace_back(own.data(), own.size() * sizeof(int32_t));
    m.data.emplace_back(bak.data(), bak.size() * sizeof(int32_t));
    net_->Send(r, m);  // a dead peer's failure is already logged
  }
}

void Zoo::OnRoutingEpoch(MessagePtr msg) {
  if (msg->data.size() < 2) return;
  int64_t epoch = msg->msg_id;
  const int32_t* own = msg->data[0].As<int32_t>();
  size_t n = msg->data[0].count<int32_t>();
  const int32_t* bak = msg->data[1].As<int32_t>();
  if (msg->data[1].count<int32_t>() < n || n == 0) return;
  bool adopted = false;
  {
    MutexLock lk(route_mu_);
    // Max-merge: only a NEWER epoch flips the route (stale broadcasts
    // from slow paths are dropped, the version-gate discipline).
    if (epoch > routing_epoch_.load(std::memory_order_relaxed)) {
      route_owner_.assign(own, own + n);
      route_backup_.assign(bak, bak + n);
      // Local lease knowledge beats the adopted map: never re-instate
      // a backup this rank already watched die (forwarding there would
      // wedge the apply thread in reconnect backoff).
      {
        MutexLock hlk(hb_mu_);
        for (size_t s = 0; s < route_backup_.size(); ++s) {
          int b = route_backup_[s];
          if (b >= 0 && b < static_cast<int>(hb_dead_.size()) &&
              hb_dead_[b])
            route_backup_[s] = -1;
        }
      }
      if (promoted_.size() < n) promoted_.resize(n, false);
      // Recompute local identity from the map (a join may have moved
      // the backup slot); a shard we PROMOTED stays ours regardless.
      backup_shard_ = -1;
      for (size_t s = 0; s < n; ++s)
        if (bak[s] == rank_) backup_shard_ = static_cast<int>(s);
      if (backup_shard_ < 0)
        for (size_t s = 0; s < promoted_.size(); ++s)
          if (promoted_[s]) backup_shard_ = static_cast<int>(s);
      routing_epoch_.store(epoch, std::memory_order_release);
      adopted = true;
    }
  }
  if (adopted) {
    repl::NoteEpochFlip();
    Dashboard::Record("repl.epoch_flip", 0.0);
    Log::Info("replication: adopted routing epoch %lld from rank %d",
              static_cast<long long>(epoch), msg->src);
    // The flip is a cache boundary: worker-side serve caches may hold
    // rows stamped by the dead primary — drop them like a clock tick.
    InvalidateWorkerCaches();
  }
}

int Zoo::PromoteFor(int dead) {
  if (!repl::Armed()) return 0;
  std::vector<int> owners, backups, shards;
  int64_t epoch = 0;
  {
    MutexLock lk(route_mu_);
    for (size_t s = 0; s < route_owner_.size(); ++s) {
      if (route_owner_[s] == dead && route_backup_[s] == rank_) {
        route_owner_[s] = rank_;
        route_backup_[s] = -1;  // chain repair = a future JoinAsBackup
        if (promoted_.size() <= s) promoted_.resize(s + 1, false);
        promoted_[s] = true;
        shards.push_back(static_cast<int>(s));
      }
    }
    if (shards.empty()) return 0;
    epoch = NextEpochLocked();
    owners = route_owner_;
    backups = route_backup_;
  }
  for (int s : shards) {
    repl::NotePromotion();
    Dashboard::Record("repl.promoted", 0.0);
    Log::Info("replication: promoted shard %d (rank %d dead) at epoch "
              "%lld", s, dead, static_cast<long long>(epoch));
    ops::BlackboxEvent(
        "replication", "promote: shard " + std::to_string(s) +
                           " after rank " + std::to_string(dead) +
                           " lease expiry, epoch " + std::to_string(epoch));
  }
  BroadcastRoutingEpoch(epoch, owners, backups);
  InvalidateWorkerCaches();
  return static_cast<int>(shards.size());
}

void Zoo::InvalidateWorkerCaches() {
  // The Barrier/Clock snapshot discipline: pointers copied OUT of
  // tables_mu_ before the hooks run (they take per-table locks).
  std::vector<WorkerTable*> snapshot;
  {
    MutexLock lk(tables_mu_);
    for (auto& t : worker_tables_)
      if (t) snapshot.push_back(t.get());
  }
  for (auto* t : snapshot) t->OnClockInvalidate();
}

void Zoo::ReleaseParkedAcks(bool all) {
  std::vector<MessagePtr> release;
  int64_t now = NowMs();
  {
    MutexLock lk(repl_mu_);
    for (auto it = parked_acks_.begin(); it != parked_acks_.end();) {
      if (all || now >= it->second.deadline_ms) {
        release.push_back(std::move(it->second.reply));
        it = parked_acks_.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (auto& r : release) {
    // Degraded ack: the backup never confirmed, but the add IS applied
    // on the primary — the client must not wedge on a dying backup.
    // The replication report carries the degradation instead.  A
    // lease-dead client's ack is dropped outright: delivering it
    // would park THIS thread in the transport's reconnect backoff.
    Dashboard::Record("repl.park_timeout", 0.0);
    int dst = r->dst;
    {
      MutexLock lk(hb_mu_);
      if (dst >= 0 && dst < static_cast<int>(hb_dead_.size()) &&
          hb_dead_[dst])
        continue;
    }
    Deliver(actor::kWorker, std::move(r));
  }
}

void Zoo::OnPeerDead(int r) {
  if (!repl::Armed()) return;
  // Confirm the corpse before the (irreversible) route surgery: a
  // transient stall can expire a LIVE peer's lease for one beat, and
  // promoting on a flap would mint a split-brain epoch.  One extra
  // heartbeat interval of silence is cheap against the lease window;
  // a recovered peer clears hb_dead_ on its next renewal and we walk
  // away.
  int64_t confirm = configure::GetInt("heartbeat_ms");
  std::this_thread::sleep_for(
      std::chrono::milliseconds(std::max<int64_t>(confirm, 50)));
  {
    MutexLock lk(hb_mu_);
    if (r >= 0 && r < static_cast<int>(hb_dead_.size()) && !hb_dead_[r])
      return;  // lease recovered: a flap, not a corpse
  }
  // ONE route pass, ONE epoch bump, ONE broadcast: clearing the
  // corpse's backup slots and promoting its shards must ship as a
  // single map — a promote-only broadcast would re-instate the dead
  // rank as a backup on every adopter, and primaries would then block
  // their apply threads forwarding at a corpse.
  bool promote = configure::GetBool("promote_auto");
  std::vector<int> owners, backups, shards;
  bool dropped_mine = false, changed = false;
  int64_t epoch = 0;
  {
    MutexLock lk(route_mu_);
    for (size_t s = 0; s < route_backup_.size(); ++s) {
      if (route_backup_[s] == r) {
        route_backup_[s] = -1;  // never forward at a corpse
        if (route_owner_[s] == rank_) dropped_mine = true;
        changed = true;
      }
    }
    if (promote) {
      for (size_t s = 0; s < route_owner_.size(); ++s) {
        if (route_owner_[s] == r && backup_shard_ == static_cast<int>(s)) {
          route_owner_[s] = rank_;
          route_backup_[s] = -1;  // chain repair = a future join
          if (promoted_.size() <= s) promoted_.resize(s + 1, false);
          promoted_[s] = true;
          shards.push_back(static_cast<int>(s));
          changed = true;
        }
      }
    }
    if (!changed) return;
    epoch = NextEpochLocked();
    owners = route_owner_;
    backups = route_backup_;
  }
  for (int s : shards) {
    repl::NotePromotion();
    Dashboard::Record("repl.promoted", 0.0);
    Log::Info("replication: promoted shard %d (rank %d dead) at epoch "
              "%lld", s, r, static_cast<long long>(epoch));
    ops::BlackboxEvent(
        "replication", "promote: shard " + std::to_string(s) +
                           " after rank " + std::to_string(r) +
                           " lease expiry, epoch " + std::to_string(epoch));
  }
  if (dropped_mine) {
    Log::Error("replication: backup rank %d dead — shard unreplicated "
               "until a new backup joins", r);
    ReleaseParkedAcks(/*all=*/true);
  }
  BroadcastRoutingEpoch(epoch, owners, backups);
  InvalidateWorkerCaches();
}

bool Zoo::JoinAsBackup(int shard) {
  if (!started_.load() || size_ <= 1 || !repl::Armed() || !net_)
    return false;
  int primary = -1;
  int64_t epoch = 0;
  std::vector<int> owners, backups;
  {
    MutexLock lk(route_mu_);
    if (shard < 0 || shard >= static_cast<int>(route_owner_.size()))
      return false;
    if (backup_shard_ >= 0 && backup_shard_ != shard)
      return false;  // factor 1: one backed shard per rank
    primary = route_owner_[shard];
    if (primary == rank_) return false;
    route_backup_[shard] = rank_;
    backup_shard_ = shard;
    epoch = NextEpochLocked();
    owners = route_owner_;
    backups = route_backup_;
  }
  // Backup instances first (a forward must never find no table), then
  // the announce (the primary starts forwarding on adoption), then the
  // snapshots — deltas between announce and snapshot are either inside
  // the snapshot or arrive behind it (FIFO), so the bytes converge.
  int32_t ntables;
  {
    MutexLock lk(tables_mu_);
    ntables = static_cast<int32_t>(table_specs_.size());
    if (backup_tables_.size() < table_specs_.size())
      backup_tables_.resize(table_specs_.size());
    for (size_t i = 0; i < table_specs_.size(); ++i) {
      if (!backup_tables_[i]) {
        backup_tables_[i] =
            MakeShard(table_specs_[i], shard, num_servers());
        if (backup_tables_[i])
          backup_tables_[i]->set_table_id(static_cast<int32_t>(i));
      }
    }
  }
  BroadcastRoutingEpoch(epoch, owners, backups);
  bool ok = true;
  for (int32_t id = 0; id < ntables; ++id) {
    int64_t mid = NextMsgId();
    auto waiter = std::make_shared<Waiter>(1);
    {
      MutexLock lk(repl_mu_);
      snapshot_pending_[mid] = waiter;
    }
    Message req;
    req.type = MsgType::ShardSnapshot;
    req.table_id = id;
    req.msg_id = mid;
    req.shard = shard;
    req.src = rank_;
    req.dst = primary;
    bool sent = net_->Send(primary, req);
    if (!sent || !waiter->WaitFor(configure::GetInt("rpc_timeout_ms")))
      ok = false;
    MutexLock lk(repl_mu_);
    snapshot_pending_.erase(mid);
  }
  if (ok)
    ops::BlackboxEvent("replication",
                       "join: rank " + std::to_string(rank_) +
                           " now backs shard " + std::to_string(shard) +
                           ", epoch " + std::to_string(epoch));
  return ok;
}

std::string Zoo::OpsReplicationJson() {
  auto owners = RouteOwners();
  auto backups = RouteBackups();
  std::vector<int> promoted;
  {
    MutexLock lk(route_mu_);
    for (size_t s = 0; s < promoted_.size(); ++s)
      if (promoted_[s]) promoted.push_back(static_cast<int>(s));
  }
  auto st = repl::GetStats();
  std::ostringstream os;
  os << "{\"rank\":" << rank_ << ",\"armed\":"
     << (repl::Armed() ? "true" : "false") << ",\"sync\":"
     << (repl::Sync() ? "true" : "false") << ",\"epoch\":"
     << RoutingEpoch() << ",\"backup_shard\":" << BackupShard();
  os << ",\"owners\":[" << JoinInts(owners) << "]";
  os << ",\"backups\":[" << JoinInts(backups) << "]";
  os << ",\"promoted\":[" << JoinInts(promoted) << "]";
  os << ",\"outstanding\":" << repl_outstanding_.load();
  os << ",\"stats\":{\"forwards\":" << st.forwards << ",\"acks\":"
     << st.acks << ",\"applied\":" << st.applied << ",\"parked\":"
     << st.parked << ",\"lag_waits\":" << st.lag_waits
     << ",\"snapshots\":" << st.snapshots << ",\"catchups\":"
     << st.catchups << ",\"promotions\":" << st.promotions
     << ",\"epoch_flips\":" << st.epoch_flips << ",\"dup_skips\":"
     << st.dup_skips << "}}";
  return os.str();
}

std::unique_ptr<ServerTable> Zoo::MakeShard(const TableSpec& spec,
                                            int sid, int nservers) {
  switch (spec.kind) {
    case TableSpec::kArray:
      return std::make_unique<ArrayServerTable>(spec.rows, updater_type_,
                                                sid, nservers);
    case TableSpec::kMatrix:
    case TableSpec::kSparseMatrix:
      // Both matrix kinds share the server shard (the sparse flavor is
      // a worker-side cache, zoo.cc registration note).
      return std::make_unique<MatrixServerTable>(
          spec.rows, spec.cols, updater_type_, sid, nservers);
    case TableSpec::kKV:
      return std::make_unique<KVServerTable>(updater_type_);
  }
  return nullptr;
}

void Zoo::RegisterBackupShard(const TableSpec& spec) {
  int32_t id = static_cast<int32_t>(table_specs_.size());
  table_specs_.push_back(spec);
  int bs = -1;
  {
    MutexLock lk(route_mu_);
    bs = backup_shard_;
  }
  std::unique_ptr<ServerTable> bt;
  if (repl::Armed() && bs >= 0)
    bt = MakeShard(spec, bs, num_servers());
  if (bt) bt->set_table_id(id);
  backup_tables_.push_back(std::move(bt));
}

void Zoo::Clock() {
  int64_t c = ++clock_;
  // Aggregated adds belong to the clock being closed: flush them BEFORE
  // the tick ships, so the per-connection FIFO keeps "min worker clock
  // >= c implies clock-c adds applied" true under aggregation.
  FlushWorkerAdds();
  // A tick is the SSP read boundary: cached rows fetched before it
  // would be served as hits FOREVER — never reaching the server where
  // MaybeHoldGet enforces `-staleness` — so the bound would silently
  // not hold.  Invalidate like Barrier does (snapshot under tables_mu_,
  // call outside — OnClockInvalidate takes the table's own lock).
  {
    std::vector<WorkerTable*> snapshot;
    {
      MutexLock lk(tables_mu_);
      for (auto& t : worker_tables_)
        if (t) snapshot.push_back(t.get());
    }
    for (auto* t : snapshot) t->OnClockInvalidate();
  }
  // Announce to every server shard, async.  Per-connection FIFO puts the
  // tick BEHIND this clock's adds on the same connection, which is what
  // makes "min worker clock >= c" mean those adds are applied.
  for (int s = 0; s < num_servers(); ++s) {
    auto msg = std::make_unique<Message>();
    msg->type = MsgType::ClockTick;
    msg->msg_id = c;
    msg->src = rank_;
    msg->dst = server_rank(s);
    SendTo(actor::kWorker, std::move(msg));
  }
}

static int64_t NowMs() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void Zoo::PurgeExpiredHeldLocked(std::vector<MessagePtr>* expired) {
  int64_t now = NowMs();
  auto keep = held_gets_.begin();
  for (auto& [deadline, m] : held_gets_) {
    if (deadline > 0 && now >= deadline)
      expired->push_back(std::move(m));
    else
      *keep++ = {deadline, std::move(m)};
  }
  held_gets_.erase(keep, held_gets_.end());
}

void Zoo::FailHeldGets(std::vector<MessagePtr> expired) {
  // A dead straggler's clock may never advance: fail the parked get
  // fast (the caller's RoundTrip sees ReplyError -> rc=-3) instead of
  // leaking it — the SSP analog of Deliver's dead-peer synthesis.
  for (auto& m : expired) {
    Log::Error("SSP: held get from rank %d expired (straggler stuck?)",
               m->src);
    auto err = std::make_unique<Message>();
    err->type = MsgType::ReplyError;
    err->table_id = m->table_id;
    err->msg_id = m->msg_id;
    err->src = rank_;
    err->dst = m->src;
    Deliver(actor::kWorker, std::move(err));
  }
}

bool Zoo::HeldBySspLocked(int src) {
  // Admission predicate (ssp_mu_ held): src runs more than `staleness`
  // ticks ahead of the QUORUM clock.  With -backup_worker_ratio=0 (the
  // default) the quorum is every worker, so the quorum clock is the
  // slowest worker's — plain sync semantics.  With ratio r > 0
  // (reference include/multiverso/server.h sync variant, SURVEY §2.9)
  // the slowest floor(r·N) workers are backup slack: clock t counts as
  // reached once ceil((1-r)·N) workers ticked it, so a straggler
  // beyond the allowance cannot park the fleet's reads.  Its late adds
  // are NOT dropped — they apply on arrival, i.e. fold into whichever
  // clock is then open (the reference's fold-into-next-clock).
  int64_t s = configure::GetInt("staleness");
  if (worker_clocks_.size() != static_cast<size_t>(size_))
    worker_clocks_.assign(size_, 0);
  if (src < 0 || src >= size_) return false;
  int64_t mine = worker_clocks_[src];
  double ratio = configure::GetDouble("backup_worker_ratio");
  if (ratio <= 0.0) {
    // Default path, run per admission check on the server hot path:
    // allocation-free single-pass min (quorum == all workers).
    int64_t slowest = mine;
    for (int r : worker_ranks_)
      slowest = std::min(slowest, worker_clocks_[r]);
    return mine - slowest > s;
  }
  std::vector<int64_t> clocks;
  clocks.reserve(worker_ranks_.size());
  for (int r : worker_ranks_) clocks.push_back(worker_clocks_[r]);
  if (clocks.empty()) return false;
  int n = static_cast<int>(clocks.size());
  int quorum = std::min(
      n, std::max(1, static_cast<int>(std::ceil((1.0 - ratio) * n))));
  // The quorum-th FASTEST worker's clock = the highest clock at least
  // `quorum` workers have reached.
  std::nth_element(clocks.begin(), clocks.begin() + (quorum - 1),
                   clocks.end(), std::greater<int64_t>());
  int64_t quorum_clock = clocks[quorum - 1];
  return mine - quorum_clock > s;
}

bool Zoo::MaybeHoldGet(MessagePtr& msg) {
  std::vector<MessagePtr> expired;
  bool held = false;
  {
    MutexLock lk(ssp_mu_);
    PurgeExpiredHeldLocked(&expired);
    if (HeldBySspLocked(msg->src)) {
      int64_t t = configure::GetInt("rpc_timeout_ms");
      held_gets_.emplace_back(t > 0 ? NowMs() + t : 0, std::move(msg));
      held = true;
    }
  }
  FailHeldGets(std::move(expired));
  return held;
}

void Zoo::OnClockTick(int src_rank, int64_t clock) {
  std::vector<MessagePtr> admit;
  std::vector<MessagePtr> expired;
  {
    MutexLock lk(ssp_mu_);
    PurgeExpiredHeldLocked(&expired);
    if (worker_clocks_.size() != static_cast<size_t>(size_))
      worker_clocks_.assign(size_, 0);
    if (src_rank >= 0 && src_rank < size_) {
      worker_clocks_[src_rank] =
          std::max(worker_clocks_[src_rank], clock);
      // Admission decided IN PLACE: only now-admitted gets re-deliver
      // (through the server mailbox, so the normal handler reruns).
      // Still-held gets KEEP their original park deadline — a blanket
      // release-and-repark would refresh deadlines on every tick and a
      // dead straggler's parks would never expire while live workers
      // keep ticking.
      auto keep = held_gets_.begin();
      for (auto& [deadline, m] : held_gets_) {
        if (!HeldBySspLocked(m->src))
          admit.push_back(std::move(m));
        else
          *keep++ = {deadline, std::move(m)};
      }
      held_gets_.erase(keep, held_gets_.end());
    }
  }
  FailHeldGets(std::move(expired));
  for (auto& m : admit) SendTo(actor::kServer, std::move(m));
}

void Zoo::SetRoles(const std::vector<int>& roles) {
  worker_ranks_.clear();
  server_ranks_.clear();
  for (size_t r = 0; r < roles.size(); ++r) {
    if (roles[r] & kRoleWorker) worker_ranks_.push_back(static_cast<int>(r));
    if (roles[r] & kRoleServer) server_ranks_.push_back(static_cast<int>(r));
  }
  if (server_ranks_.empty())
    Log::Error("no server-role rank registered — tables have no shards");
}

int Zoo::ServeQueueDepth() {
  MutexLock lk(mu_);
  return server_actor_ ? static_cast<int>(server_actor_->QueueSize()) : 0;
}

bool Zoo::DropServeRead(MessagePtr& msg) {
  // Tail plane (docs/serving.md "tail"): reads only — the two dequeue
  // drop reasons that mean "nobody is waiting for this answer".
  bool cancelled = qos::Cancelled(msg->src, msg->msg_id);
  bool expired = !cancelled && qos::ShedExpired(*msg);
  if (!cancelled && !expired) return false;
  Log::Debug("serve: dropping %s read from %d at dequeue (msg %lld)",
             cancelled ? "cancelled" : "deadline-expired", msg->src,
             static_cast<long long>(msg->msg_id));
  // An anonymous client's dropped read settles its reactor admission
  // slots here — no reply will ever route back to release them.
  if (transport::IsClientRank(msg->src) && net_)
    net_->SettleClient(msg->src);
  return true;
}

bool Zoo::ShedIfOverloaded(MessagePtr& msg) {
  int64_t max_inflight = configure::GetInt("server_inflight_max");
  if (max_inflight <= 0) return false;
  int depth = ServeQueueDepth();
  // Depth histogram in the µs-bucket Dashboard (1 unit = 1 µs): bucket
  // i ≈ depth 2^i, so the Dump shows the backlog distribution and
  // `serve.queue_depth`'s total/count is the mean depth per sample.
  Dashboard::Record("serve.queue_depth", depth * 1e-6);
  if (depth < max_inflight) {
    // An admit ends the shed streak: the storm detector counts
    // CONSECUTIVE sheds, re-arming once the server breathes again.
    shed_streak_.store(0);
    shed_storm_latched_.store(false);
    return false;
  }
  Dashboard::Record("serve.shed", 0.0);
  int64_t storm = configure::GetInt("shed_storm_threshold");
  long long streak = shed_streak_.fetch_add(1) + 1;
  if (storm > 0 && streak >= storm &&
      !shed_storm_latched_.exchange(true))
    ops::BlackboxTrigger("shed_storm: " + std::to_string(streak) +
                         " consecutive busy-sheds at queue depth " +
                         std::to_string(depth));
  auto reply = std::make_unique<Message>();
  reply->type = MsgType::ReplyBusy;
  reply->table_id = msg->table_id;
  reply->msg_id = msg->msg_id;
  reply->trace_id = msg->trace_id;
  reply->src = rank_;
  reply->dst = msg->src;
  latency::StampReply(*msg, reply.get());
  Deliver(actor::kWorker, std::move(reply));
  return true;
}

// ---- introspection plane (docs/observability.md) ----------------------

std::string Zoo::OpsHealthJson() {
  std::ostringstream os;
  bool up = started_.load();
  os << "{\"started\":" << (up ? "true" : "false");
  if (!up) {
    os << ",\"ready\":false,\"healthy\":false}";
    return os.str();
  }
  int64_t inflight_max = configure::GetInt("server_inflight_max");
  int depth = ServeQueueDepth();
  bool overloaded = inflight_max > 0 && depth >= inflight_max;
  auto dead = DeadPeers();
  auto fanin = FanIn();
  os << ",\"rank\":" << rank_ << ",\"size\":" << size_;
  os << ",\"engine\":\"" << net_engine() << "\"";
  // Engine-degradation record: `engine` above is the EFFECTIVE engine;
  // these say what was asked for and whether Start downgraded (uring
  // probe failure -> epoll).  mvtop/mvdoctor surface the mismatch.
  os << ",\"engine_requested\":\""
     << (engine_requested_.empty() ? net_engine()
                                   : engine_requested_.c_str())
     << "\"";
  os << ",\"engine_fallback\":" << (engine_fallback_ ? "true" : "false");
  os << ",\"workers\":" << num_workers() << ",\"servers\":"
     << num_servers();
  os << ",\"is_server\":" << (server_id() >= 0 ? "true" : "false");
  os << ",\"clock\":" << clock_.load();
  os << ",\"serve_queue_depth\":" << depth;
  os << ",\"server_inflight_max\":" << inflight_max;
  os << ",\"dead_peers\":[" << JoinInts(dead) << "]";
  os << ",\"clients\":" << fanin.active_clients;
  os << ",\"clients_accepted\":" << fanin.accepted_total;
  os << ",\"client_shed\":" << fanin.client_shed;
  os << ",\"blackbox_triggers\":" << ops::BlackboxTriggerCount();
  // Host-level process stats (docs/observability.md "capacity plane"):
  // RSS / peak RSS / open fds / uptime from /proc/self, so a health
  // scrape answers "is this host running out of memory or fds" without
  // a second probe.
  {
    capacity::ProcStats proc = capacity::Proc();
    char num[64];
    os << ",\"rss_bytes\":" << proc.rss_bytes;
    os << ",\"vm_hwm_bytes\":" << proc.vm_hwm_bytes;
    os << ",\"open_fds\":" << proc.open_fds;
    std::snprintf(num, sizeof(num), "%.3f", proc.uptime_s);
    os << ",\"uptime_s\":" << num;
  }
  // Readiness: the runtime answers requests at all; health: it is not
  // drowning (queue within the shed bound) and, on the lease authority,
  // the fleet has no expired peers.
  os << ",\"ready\":true";
  os << ",\"healthy\":" << (!overloaded && dead.empty() ? "true" : "false");
  os << "}";
  return os.str();
}

std::string Zoo::OpsTablesJson() {
  // Snapshot pointers under tables_mu_, read stats OUTSIDE it: the
  // accessors take per-table locks, and tables are never unregistered.
  std::vector<std::pair<WorkerTable*, ServerTable*>> snapshot;
  {
    MutexLock lk(tables_mu_);
    for (size_t i = 0; i < worker_tables_.size(); ++i)
      snapshot.emplace_back(
          worker_tables_[i].get(),
          i < server_tables_.size() ? server_tables_[i].get() : nullptr);
  }
  std::ostringstream os;
  os << "[";
  for (size_t i = 0; i < snapshot.size(); ++i) {
    auto [wt, st] = snapshot[i];
    if (i) os << ',';
    os << "{\"id\":" << i;
    if (wt) {
      os << ",\"codec\":\"" << codec::Name(wt->wire_codec()) << "\"";
      os << ",\"last_version\":" << wt->last_version();
      os << ",\"agg_pending\":" << wt->agg_pending();
      // Hot-key replica side-table entries are their OWN field, NEVER
      // folded into the shard row count below: a replicated row is a
      // COPY of a row some shard already owns, and capacity math that
      // summed both would count it twice after a replica install
      // (the double-count bugfix; regression-tested with an armed
      // replica in tests/test_capacity.py).
      if (auto* mw = dynamic_cast<MatrixWorkerTable*>(wt))
        os << ",\"replica_rows\":" << mw->replica_stats().rows;
    }
    if (st) {
      // Shard-resident entries only (matrix rows / KV entries / array
      // elements) — the capacity plane's row count.
      auto cap = st->Capacity();
      os << ",\"rows\":" << cap.rows;
      os << ",\"resident_bytes\":" << cap.bytes;
      int64_t v = st->version();
      int64_t lo = v, hi = 0;
      for (int b = 0; b < ServerTable::kVersionBuckets; ++b) {
        int64_t bv = st->bucket_version(b);
        lo = std::min(lo, bv);
        hi = std::max(hi, bv);
      }
      os << ",\"version\":" << v;
      os << ",\"bucket_version_min\":" << lo;
      os << ",\"bucket_version_max\":" << hi;
      os << ",\"bucket_version_spread\":" << (hi - lo);
      // Workload plane (docs/observability.md): load totals, skew,
      // observed staleness, and update-health sentinels ride the same
      // report so mvtop's table view needs one scrape, not two.
      auto load = st->Load();
      char num[64];
      os << ",\"gets\":" << load.gets << ",\"adds\":" << load.adds;
      std::snprintf(num, sizeof(num), "%.6g", load.skew_ratio);
      os << ",\"skew_ratio\":" << num;
      os << ",\"bucket_load_max\":" << load.bucket_load_max;
      std::snprintf(num, sizeof(num), "%.6g", load.bucket_load_mean);
      os << ",\"bucket_load_mean\":" << num;
      std::snprintf(num, sizeof(num), "%.6g", load.add_l2);
      os << ",\"add_l2\":" << num;
      std::snprintf(num, sizeof(num), "%.6g", load.add_linf);
      os << ",\"add_linf\":" << num;
      os << ",\"nan_count\":" << load.nan_count;
      os << ",\"inf_count\":" << load.inf_count;
      os << ",\"staleness_count\":" << load.staleness_count;
      std::snprintf(num, sizeof(num), "%.6g", load.staleness_mean);
      os << ",\"staleness_mean\":" << num;
    } else {
      os << ",\"shard\":null";
    }
    os << "}";
  }
  os << "]";
  return os.str();
}

struct Zoo::OpsPending {
  std::shared_ptr<Waiter> waiter;
  Mutex mu;
  std::map<int, std::string> replies GUARDED_BY(mu);  // rank -> payload
};

void Zoo::HandleOpsQuery(MessagePtr msg) {
  if (msg->src < 0 || msg->src == rank_) return;  // no route back
  if (msg->version != 1) {
    // Local scope: build + answer right here (transport reader thread —
    // the epoll engine answers even earlier, at the reactor).
    auto reply = std::make_unique<Message>();
    ops::BuildReply(*msg, reply.get());
    reply->src = rank_;
    reply->dst = msg->src;
    Deliver(actor::kWorker, std::move(reply));
    return;
  }
  // Fleet scope: bounded fan-out on a detached (but counted) thread —
  // the deadline wait must never park a transport/reactor thread.
  int cap = static_cast<int>(
      std::max<int64_t>(1, configure::GetInt("ops_inflight_max")));
  if (ops_inflight_.load() >= cap) {
    auto reply = std::make_unique<Message>();
    std::string busy = "{\"error\":\"ops busy: " + std::to_string(cap) +
                       " fleet queries already in flight\"}";
    reply->type = MsgType::OpsReply;
    reply->msg_id = msg->msg_id;
    reply->trace_id = msg->trace_id;
    reply->version = 1;
    reply->src = rank_;
    reply->dst = msg->src;
    reply->data.emplace_back(busy.data(), busy.size());
    Deliver(actor::kWorker, std::move(reply));
    return;
  }
  ops_inflight_.fetch_add(1);
  // Deep-copy the query OUT of the receive arena before detaching (the
  // kind blob may be a Blob::View into a reactor slab).
  Message q;
  q.src = msg->src;
  q.msg_id = msg->msg_id;
  q.trace_id = msg->trace_id;
  q.version = msg->version;
  if (!msg->data.empty()) {
    Blob kind;
    kind.CopyFrom(msg->data[0]);
    q.data.push_back(kind);
  }
  int64_t id = NextMsgId();
  std::thread([this, id, q]() mutable {
    FleetOpsThread(id, std::move(q));
    ops_inflight_.fetch_add(-1);
  }).detach();
}

void Zoo::OnOpsReply(MessagePtr msg) {
  std::shared_ptr<OpsPending> p;
  {
    MutexLock lk(ops_mu_);
    auto it = ops_pending_.find(msg->msg_id);
    if (it == ops_pending_.end()) return;  // past the deadline: dropped
    p = it->second;
  }
  std::string text;
  if (!msg->data.empty())
    text.assign(msg->data[0].data(), msg->data[0].size());
  {
    MutexLock lk(p->mu);
    p->replies[msg->src] = std::move(text);
  }
  p->waiter->Notify();
}

namespace {
// Inject a rank label into one Prometheus exposition line:
//   name{a="b"} v      ->  name{rank="0",a="b"} v
//   name v # {...} e   ->  name{rank="0"} v # {...} e
// Comment lines return "" (a fleet merge keeps data lines only — the
// per-rank # TYPE duplicates would be invalid exposition).
std::string InjectRankLabel(const std::string& line, int rank) {
  if (line.empty() || line[0] == '#') return "";
  std::string label = "rank=\"" + std::to_string(rank) + "\"";
  size_t space = line.find(' ');
  size_t brace = line.find('{');
  if (brace != std::string::npos &&
      (space == std::string::npos || brace < space))
    return line.substr(0, brace + 1) + label + "," +
           line.substr(brace + 1);
  if (space == std::string::npos) return line;  // malformed: keep as-is
  return line.substr(0, space) + "{" + label + "}" + line.substr(space);
}
}  // namespace

std::string Zoo::OpsHotKeysJson(int32_t id) {
  // Snapshot pointers under tables_mu_, read stats OUTSIDE it (the
  // accessors take per-table/tracker locks; tables never unregister).
  std::vector<ServerTable*> snapshot;
  std::vector<WorkerTable*> workers;
  {
    MutexLock lk(tables_mu_);
    for (auto& t : server_tables_)
      snapshot.push_back(t.get());
    for (auto& t : worker_tables_)
      workers.push_back(t.get());
  }
  std::ostringstream os;
  os << "[";
  bool first = true;
  for (size_t i = 0; i < snapshot.size(); ++i) {
    if (id >= 0 && static_cast<size_t>(id) != i) continue;
    ServerTable* st = snapshot[i];
    if (!first) os << ',';
    first = false;
    os << "{\"id\":" << i;
    if (!st) {
      os << ",\"shard\":null}";
      continue;
    }
    auto load = st->Load();
    char num[64];
    os << ",\"gets\":" << load.gets << ",\"adds\":" << load.adds;
    std::snprintf(num, sizeof(num), "%.6g", load.skew_ratio);
    os << ",\"skew_ratio\":" << num;
    os << ",\"bucket_load_max\":" << load.bucket_load_max;
    std::snprintf(num, sizeof(num), "%.6g", load.bucket_load_mean);
    os << ",\"bucket_load_mean\":" << num;
    std::snprintf(num, sizeof(num), "%.6g", load.add_l2);
    os << ",\"add_l2\":" << num;
    std::snprintf(num, sizeof(num), "%.6g", load.add_linf);
    os << ",\"add_linf\":" << num;
    os << ",\"nan_count\":" << load.nan_count;
    os << ",\"inf_count\":" << load.inf_count;
    os << ",\"staleness_count\":" << load.staleness_count;
    std::snprintf(num, sizeof(num), "%.6g", load.staleness_mean);
    os << ",\"staleness_mean\":" << num;
    os << ",\"armed\":" << (workload::Armed() ? "true" : "false");
    // Hot-key replica plane (docs/embedding.md): this shard's push
    // count plus the co-located worker stub's replica hit ledger (in
    // static mode every rank carries both roles, so the pair describes
    // the rank's full replica participation).
    os << ",\"replica\":{\"armed\":"
       << (workload::ReplicaArmed() ? "true" : "false");
    os << ",\"pushes\":" << st->replica_pushes();
    auto* mw = i < workers.size()
                   ? dynamic_cast<MatrixWorkerTable*>(workers[i])
                   : nullptr;
    if (mw) {
      auto rs = mw->replica_stats();
      os << ",\"hits\":" << rs.hits << ",\"misses\":" << rs.misses
         << ",\"rows\":" << rs.rows << ",\"refreshes\":" << rs.refreshes;
    }
    os << "}";
    os << ",\"hotkeys\":" << st->HotKeysJson();
    os << "}";
  }
  os << "]";
  return os.str();
}

std::string Zoo::OpsAuditJson() {
  // Snapshot pointers under tables_mu_, read books OUTSIDE it (the
  // accessors take per-book locks; tables never unregister).
  std::vector<std::tuple<WorkerTable*, ServerTable*, ServerTable*>>
      snapshot;
  {
    MutexLock lk(tables_mu_);
    for (size_t i = 0; i < worker_tables_.size(); ++i)
      snapshot.emplace_back(
          worker_tables_[i].get(),
          i < server_tables_.size() ? server_tables_[i].get() : nullptr,
          i < backup_tables_.size() ? backup_tables_[i].get() : nullptr);
  }
  int bshard = BackupShard();
  std::ostringstream os;
  os << "{\"rank\":" << rank_ << ",\"armed\":"
     << (audit::Armed() ? "true" : "false")
     << ",\"backup_shard\":" << bshard << ",\"tables\":[";
  auto emit_sums = [&os](ServerTable* t) {
    os << "[";
    auto sums = t->BucketChecksums();
    for (size_t b = 0; b < sums.size(); ++b) {
      if (b) os << ',';
      os << sums[b];
    }
    os << "]";
  };
  for (size_t i = 0; i < snapshot.size(); ++i) {
    auto [wt, st, bt] = snapshot[i];
    if (i) os << ',';
    os << "{\"id\":" << i;
    if (wt) os << ",\"worker\":" << wt->AuditLedgerJson();
    if (st) {
      // A gap with no follow-up traffic must still fire its grace
      // deadline — the scrape IS the periodic sweep.
      st->audit_book().CheckGaps(static_cast<int32_t>(i));
      os << ",\"server\":" << st->audit_book().Json();
      os << ",\"checksums\":";
      emit_sums(st);
    } else {
      os << ",\"server\":null";
    }
    if (bt) {
      // Replication plane (docs/replication.md): the backed shard's
      // book + beacons, so mvaudit can diff primary vs backup —
      // identical rows must report identical bucket checksums.
      bt->audit_book().CheckGaps(static_cast<int32_t>(i));
      os << ",\"backup\":" << bt->audit_book().Json();
      os << ",\"backup_checksums\":";
      emit_sums(bt);
    }
    os << "}";
  }
  os << "]}";
  return os.str();
}

std::string Zoo::OpsCapacityJson() {
  // Snapshot pointers under tables_mu_, read stats OUTSIDE it (the
  // accessors take per-table locks; tables never unregister).
  std::vector<std::tuple<WorkerTable*, ServerTable*, ServerTable*>>
      snapshot;
  {
    MutexLock lk(tables_mu_);
    for (size_t i = 0; i < worker_tables_.size(); ++i)
      snapshot.emplace_back(
          worker_tables_[i].get(),
          i < server_tables_.size() ? server_tables_[i].get() : nullptr,
          i < backup_tables_.size() ? backup_tables_[i].get() : nullptr);
  }
  // History windows record at most once per -capacity_history_ms, all
  // tables together (one shared clock keeps windows aligned), so a
  // watch-mode scraper accumulates the rate curve as a side effect.
  bool record = capacity::HistoryDue();
  std::ostringstream os;
  os << "{\"rank\":" << rank_;
  os << ",\"armed\":" << (capacity::Armed() ? "true" : "false");
  os << ",\"server_id\":" << server_id();
  os << ",\"servers\":" << num_servers();
  os << ",\"proc\":" << capacity::ProcJson();
  {
    HostArena::Stats a = HostArena::Get()->GetStats();
    os << ",\"arena\":{\"buffers\":" << a.buffers
       << ",\"free_buffers\":" << a.free_buffers
       << ",\"bytes\":" << a.bytes << ",\"in_flight\":" << a.in_flight
       << ",\"deferred\":" << a.deferred << "}";
  }
  os << ",\"net\":{\"engine\":\"" << net_engine()
     << "\",\"writeq_bytes\":" << (net_ ? net_->QueuedBytes() : 0)
     << ",\"rx_arena_bytes\":" << (net_ ? net_->RxArenaBytes() : 0) << "}";
  os << ",\"gauges\":" << capacity::GaugesJson();
  os << ",\"tables\":[";
  for (size_t i = 0; i < snapshot.size(); ++i) {
    auto [wt, st, bt] = snapshot[i];
    if (i) os << ',';
    os << "{\"id\":" << i;
    if (st) {
      auto cap = st->Capacity();
      int64_t bucket_gets[capacity::kLoadBuckets];
      int64_t bucket_adds[capacity::kLoadBuckets];
      st->BucketLoads(bucket_gets, bucket_adds);
      os << ",\"shard\":{\"resident_bytes\":" << cap.bytes
         << ",\"rows\":" << cap.rows;
      os << ",\"gets\":" << st->total_gets()
         << ",\"adds\":" << st->total_adds();
      auto emit_i64 = [&os](const char* name, const int64_t* v, int n) {
        os << ",\"" << name << "\":[";
        for (int b = 0; b < n; ++b) {
          if (b) os << ',';
          os << v[b];
        }
        os << "]";
      };
      auto bb = st->BucketBytes();
      emit_i64("bucket_bytes", bb.data(),
               static_cast<int>(bb.size()));
      emit_i64("bucket_gets", bucket_gets, capacity::kLoadBuckets);
      emit_i64("bucket_adds", bucket_adds, capacity::kLoadBuckets);
      os << "}";
      if (record) {
        int64_t load[capacity::kLoadBuckets];
        for (int b = 0; b < capacity::kLoadBuckets; ++b)
          load[b] = bucket_gets[b] + bucket_adds[b];
        capacity::RecordHistory(static_cast<int32_t>(i),
                                st->total_gets(), st->total_adds(),
                                cap.bytes, load);
      }
      os << ",\"history\":"
         << capacity::HistoryJson(static_cast<int32_t>(i));
    } else {
      os << ",\"shard\":null";
    }
    if (bt) os << ",\"backup_bytes\":" << bt->Capacity().bytes;
    if (wt) {
      os << ",\"worker\":{\"agg_bytes\":" << wt->agg_bytes();
      // Side-table bytes are their OWN fields (never folded into the
      // shard count — the replica double-count fix).
      if (auto* mw = dynamic_cast<MatrixWorkerTable*>(wt)) {
        auto rs = mw->replica_stats();
        os << ",\"replica_rows\":" << rs.rows
           << ",\"replica_bytes\":" << mw->replica_bytes();
      }
      if (auto* kw = dynamic_cast<KVWorkerTable*>(wt))
        os << ",\"cache_bytes\":" << kw->cache_bytes();
      os << "}";
    }
    os << "}";
  }
  os << "]}";
  return os.str();
}

void Zoo::RecomputeCapacityAll() {
  std::vector<ServerTable*> tables;
  {
    MutexLock lk(tables_mu_);
    for (auto& t : server_tables_)
      if (t) tables.push_back(t.get());
    for (auto& t : backup_tables_)
      if (t) tables.push_back(t.get());
  }
  for (auto* t : tables) t->RecomputeCapacity();
}

std::string Zoo::FleetReport(const std::string& kind) {
  // Synchronous fleet aggregation from THIS rank — the engine-agnostic
  // twin of an inbound fleet-scope OpsQuery (on the blocking tcp
  // engine no anonymous scraper can connect, but a rank can still
  // assemble the fleet view itself over the rank wire).
  if (!started_.load()) return "{\"error\":\"not started\"}";
  ops_inflight_.fetch_add(1);  // Stop drains us before the wire dies
  std::string out = FleetCollect(kind, Dashboard::ThreadTraceId(),
                                 NextMsgId());
  ops_inflight_.fetch_add(-1);
  return out;
}

void Zoo::FleetOpsThread(int64_t id, Message query) {
  std::string kind = "health";
  if (!query.data.empty() && query.data[0].size() > 0)
    kind.assign(query.data[0].data(), query.data[0].size());

  std::string merged = FleetCollect(kind, query.trace_id, id);

  auto reply = std::make_unique<Message>();
  reply->type = MsgType::OpsReply;
  reply->msg_id = query.msg_id;
  reply->trace_id = query.trace_id;
  reply->version = 1;
  reply->src = rank_;
  reply->dst = query.src;
  reply->data.emplace_back(merged.data(), merged.size());
  Deliver(actor::kWorker, std::move(reply));
}

std::string Zoo::FleetCollect(const std::string& kind, int64_t trace_id,
                              int64_t id) {
  std::vector<int> targets;
  for (int r = 0; r < size_; ++r)
    if (r != rank_) targets.push_back(r);

  auto pending = std::make_shared<OpsPending>();
  pending->waiter =
      std::make_shared<Waiter>(static_cast<int>(targets.size()));
  if (!targets.empty()) {
    {
      MutexLock lk(ops_mu_);
      ops_pending_[id] = pending;
    }
    for (int r : targets) {
      auto sub = std::make_unique<Message>();
      sub->type = MsgType::OpsQuery;
      sub->msg_id = id;
      sub->trace_id = trace_id;
      sub->version = 0;  // local scope at the peer
      sub->src = rank_;
      sub->dst = r;
      sub->data.emplace_back(kind.data(), kind.size());
      if (net_) net_->Send(r, *sub);
    }
    pending->waiter->WaitFor(configure::GetInt("ops_fleet_timeout_ms"));
    MutexLock lk(ops_mu_);
    ops_pending_.erase(id);
  }

  std::map<int, std::string> replies;
  {
    MutexLock lk(pending->mu);
    replies = pending->replies;
  }
  replies[rank_] = ops::LocalReport(kind);
  std::vector<int> silent;
  for (int r : targets)
    if (!replies.count(r)) silent.push_back(r);
  std::vector<int> dead = DeadPeers();

  std::ostringstream os;
  if (kind == "metrics") {
    // Per-rank labels on every series; silent ranks are explicit
    // zero-valued mv_ops_rank_up series, never just missing data.
    os << "# fleet scrape from rank " << rank_ << " (" << replies.size()
       << "/" << size_ << " ranks)\n";
    for (auto& [r, text] : replies) {
      std::istringstream in(text);
      std::string line;
      while (std::getline(in, line)) {
        std::string labeled = InjectRankLabel(line, r);
        if (!labeled.empty()) os << labeled << '\n';
      }
    }
    for (int r = 0; r < size_; ++r)
      os << "mv_ops_rank_up{rank=\"" << r << "\"} "
         << (replies.count(r) ? 1 : 0) << '\n';
    for (int r : dead)
      os << "mv_ops_rank_dead{rank=\"" << r << "\"} 1\n";
  } else {
    os << "{\"scope\":\"fleet\",\"kind\":\"" << kind
       << "\",\"aggregator\":" << rank_ << ",\"size\":" << size_;
    os << ",\"silent\":[" << JoinInts(silent) << "]";
    os << ",\"dead\":[" << JoinInts(dead) << "]";
    os << ",\"ranks\":{";
    bool first = true;
    for (int r = 0; r < size_; ++r) {
      if (!first) os << ',';
      first = false;
      os << "\"" << r << "\":";
      auto it = replies.find(r);
      os << (it == replies.end() ? std::string("null") : it->second);
    }
    os << "}}";
  }
  return os.str();
}

void Zoo::SendTo(const std::string& actor_name, MessagePtr msg) {
  // Snapshot the pointer AND push under mu_ so a concurrent Stop cannot
  // free the actor between the lookup and the mailbox push.
  MutexLock lk(mu_);
  Actor* a = nullptr;
  if (actor_name == actor::kWorker) a = worker_actor_.get();
  else if (actor_name == actor::kServer) a = server_actor_.get();
  else if (actor_name == actor::kController) a = controller_actor_.get();
  if (!a) {
    Log::Error("SendTo: unknown or stopped actor '%s'", actor_name.c_str());
    return;
  }
  a->Receive(std::move(msg));
}

void Zoo::Deliver(const std::string& actor_name, MessagePtr msg) {
  // Latency trail: the transport hand-off stamp (requests close the
  // client queue stage, replies open the wire_back stage) — taken for
  // local deliveries too, so a single process still attributes its
  // mailbox and apply stages.
  latency::StampSend(msg.get());
  if (msg->dst < 0 || msg->dst == rank_ || !net_) {
    SendTo(actor_name, std::move(msg));
    return;
  }
  if (net_->Send(msg->dst, *msg)) return;
  // Unreachable peer: fail blocking callers fast instead of hanging.
  switch (msg->type) {
    case MsgType::RequestGet:
    case MsgType::RequestAdd:
    case MsgType::RequestVersion: {
      if (msg->msg_id < 0) return;  // async add: nothing waits
      auto err = std::make_unique<Message>();
      err->type = MsgType::ReplyError;
      err->table_id = msg->table_id;
      err->msg_id = msg->msg_id;
      err->src = msg->dst;          // "from" the dead shard
      err->dst = rank_;
      SendTo(actor::kWorker, std::move(err));
      break;
    }
    case MsgType::RequestFlush: {
      // Dead shard: nothing to drain there — ack so Barrier proceeds,
      // but latch the failure so it reports false.
      {
        MutexLock lk(barrier_mu_);
        barrier_failed_ = true;
      }
      OnFlushReply(msg->msg_id);
      break;
    }
    case MsgType::ControlBarrier: {
      // Rank 0 unreachable: latch the failure, then release the local
      // waiter so Barrier() returns FALSE immediately instead of either
      // hanging or (worse) reporting a successful rendezvous.
      Log::Error("Zoo::Deliver: barrier authority (rank 0) unreachable");
      {
        MutexLock lk(barrier_mu_);
        barrier_failed_ = true;
      }
      OnBarrierRelease();
      break;
    }
    default:
      // Reply to a dead requester / release to a dead peer: that
      // process's state is gone — drop, the log already has the error.
      break;
  }
}

void Zoo::RouteInbound(Message&& m) {
  auto msg = std::make_unique<Message>(std::move(m));
  switch (msg->type) {
    case MsgType::RequestGet:
    case MsgType::RequestAdd:
    case MsgType::RequestFlush:
    case MsgType::RequestVersion:
    case MsgType::RequestReplica:
    case MsgType::ClockTick:
      SendTo(actor::kServer, std::move(msg));
      break;
    case MsgType::ReplyGet:
    case MsgType::ReplyAdd:
    case MsgType::ReplyFlush:
    case MsgType::ReplyVersion:
    case MsgType::ReplyReplica:
    case MsgType::ReplyBusy:
      SendTo(actor::kWorker, std::move(msg));
      break;
    case MsgType::ControlBarrier:
    case MsgType::ControlBarrierReply:
    case MsgType::Heartbeat:
      SendTo(actor::kController, std::move(msg));
      break;
    // Introspection plane: NEVER through the actor mailbox — a wedged
    // server must still answer its scrape.  (On the epoll engine the
    // reactor already answered local-scope queries before inbound_;
    // only fleet-scope queries and fan-out replies reach here.)
    // Hedge-cancel token (docs/serving.md "tail"): consumed at the
    // transport layer, never the mailbox — on the epoll engine the
    // reactor already ate it; this is the blocking/MPI engines' path.
    case MsgType::RequestCancel:
      qos::NoteCancel(msg->src, msg->msg_id);
      break;
    // Replication plane (docs/replication.md): forwards + snapshots go
    // through the server actor (serialized with applies); acks and
    // routing-epoch flips are consumed at the transport layer so a
    // primary's apply thread waiting on its backup can always make
    // progress, and promotions are controller-plane.
    case MsgType::ReplForward:
    case MsgType::ShardSnapshot:
      SendTo(actor::kServer, std::move(msg));
      break;
    case MsgType::ReplAck:
      OnReplAck(std::move(msg));
      break;
    case MsgType::RoutingEpoch:
      OnRoutingEpoch(std::move(msg));
      break;
    case MsgType::Promote:
      SendTo(actor::kController, std::move(msg));
      break;
    case MsgType::OpsQuery:
      HandleOpsQuery(std::move(msg));
      break;
    case MsgType::OpsReply:
      OnOpsReply(std::move(msg));
      break;
    default:
      Log::Error("RouteInbound: unhandled message type %d",
                 static_cast<int>(msg->type));
  }
}

namespace {
// Table-creation codec negotiation (docs/wire_compression.md): every
// new worker stub starts on the `-wire_codec` default; MV_SetTableCodec
// can retarget one table afterwards.
Codec DefaultCodec() {
  return configure::Has("wire_codec")
             ? codec::FromName(configure::GetString("wire_codec"))
             : Codec::kRaw;
}
}  // namespace

int32_t Zoo::RegisterArrayTable(int64_t size) {
  MutexLock lk(tables_mu_);
  int32_t id = static_cast<int32_t>(server_tables_.size());
  // Shards live on server-role ranks only; a worker-only rank registers
  // a null server slot (ids must line up across every rank).
  int sid = server_id();
  server_tables_.push_back(
      sid < 0 ? nullptr
              : std::make_unique<ArrayServerTable>(size, updater_type_,
                                                   sid, num_servers()));
  if (server_tables_.back()) server_tables_.back()->set_table_id(id);
  RegisterBackupShard(TableSpec{TableSpec::kArray, size, 0});
  worker_tables_.push_back(
      std::make_unique<ArrayWorkerTable>(id, size, num_servers()));
  worker_tables_.back()->set_codec(DefaultCodec());
  return id;
}

// Both matrix kinds share the server shard (only requested rows ever
// ride the wire); the sparse table's value-add is purely the
// WORKER-side row cache, so registration differs only in the
// worker-table type.
template <typename WorkerT>
int32_t Zoo::RegisterMatrixTableImpl(int64_t rows, int64_t cols) {
  MutexLock lk(tables_mu_);
  int32_t id = static_cast<int32_t>(server_tables_.size());
  int sid = server_id();
  server_tables_.push_back(
      sid < 0 ? nullptr
              : std::make_unique<MatrixServerTable>(
                    rows, cols, updater_type_, sid, num_servers()));
  if (server_tables_.back()) server_tables_.back()->set_table_id(id);
  RegisterBackupShard(TableSpec{
      std::is_same<WorkerT, SparseMatrixWorkerTable>::value
          ? TableSpec::kSparseMatrix
          : TableSpec::kMatrix,
      rows, cols});
  worker_tables_.push_back(
      std::make_unique<WorkerT>(id, rows, cols, num_servers()));
  worker_tables_.back()->set_codec(DefaultCodec());
  return id;
}

int32_t Zoo::RegisterMatrixTable(int64_t rows, int64_t cols) {
  return RegisterMatrixTableImpl<MatrixWorkerTable>(rows, cols);
}

int32_t Zoo::RegisterSparseMatrixTable(int64_t rows, int64_t cols) {
  return RegisterMatrixTableImpl<SparseMatrixWorkerTable>(rows, cols);
}

int32_t Zoo::RegisterKVTable() {
  MutexLock lk(tables_mu_);
  int32_t id = static_cast<int32_t>(server_tables_.size());
  int sid = server_id();
  server_tables_.push_back(
      sid < 0 ? nullptr
              : std::make_unique<KVServerTable>(updater_type_));
  if (server_tables_.back()) server_tables_.back()->set_table_id(id);
  RegisterBackupShard(TableSpec{TableSpec::kKV, 0, 0});
  worker_tables_.push_back(
      std::make_unique<KVWorkerTable>(id, num_servers()));
  worker_tables_.back()->set_codec(DefaultCodec());
  return id;
}

ServerTable* Zoo::server_table(int32_t id) {
  MutexLock lk(tables_mu_);
  return (id >= 0 && id < static_cast<int32_t>(server_tables_.size()))
             ? server_tables_[id].get()
             : nullptr;
}

WorkerTable* Zoo::worker_table(int32_t id) {
  MutexLock lk(tables_mu_);
  return (id >= 0 && id < static_cast<int32_t>(worker_tables_.size()))
             ? worker_tables_[id].get()
             : nullptr;
}

ArrayWorkerTable* Zoo::array_worker(int32_t id) {
  return dynamic_cast<ArrayWorkerTable*>(worker_table(id));
}

MatrixWorkerTable* Zoo::matrix_worker(int32_t id) {
  return dynamic_cast<MatrixWorkerTable*>(worker_table(id));
}

KVWorkerTable* Zoo::kv_worker(int32_t id) {
  return dynamic_cast<KVWorkerTable*>(worker_table(id));
}

}  // namespace mvtpu
