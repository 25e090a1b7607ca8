// Transport — the pluggable wire seam (docs/transport.md).
//
// The reference selects its transport (MPI vs ZMQ) behind one
// NetInterface (include/multiverso/net.h, SURVEY.md §2.17-2.18); this
// header is that seam grown one axis further: besides the WIRE (TCP vs
// MPI) the runtime now also picks the READINESS MODEL.  `-net_engine`
// chooses between
//
//   tcp    — TcpNet (net.h): blocking sockets, one reader thread per
//            accepted connection.  Simple, fine for a fixed rank fleet.
//   epoll  — EpollNet (epoll_net.h): an event-driven reactor (one epoll
//            loop, optionally `-net_threads` shards) driving
//            non-blocking sockets through per-connection read/write
//            state machines.  Scales to thousands of connections and is
//            the only engine that accepts ANONYMOUS (non-rank) serve
//            clients.  The default for TCP fleets.
//   mpi    — MpiNet (mpi_net.h): the literal MPI wire; rank/size come
//            from MPI itself, so it keeps its own Init shape.
//   uring  — UringNet (uring_net.h): the io_uring proactor — completion-
//            driven I/O, receive buffers registered with the kernel over
//            HostArena slabs, multishot accept for the anonymous tier,
//            zero-copy send completions.  Same message semantics as
//            epoll; zoo.cc degrades to epoll (with a logged reason and
//            an `effective_engine` health field) when the kernel lacks
//            io_uring.
#pragma once

#include <atomic>
#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <vector>

#include "mvtpu/message.h"

namespace mvtpu {

// What the Zoo needs from a transport.
class Net {
 public:
  using InboundFn = std::function<void(Message&&)>;

  virtual ~Net() = default;

  // Serialize + ship to the peer; false on a dead/unreachable rank.
  virtual bool Send(int dst_rank, const Message& msg) = 0;
  virtual void Stop() = 0;
  virtual int rank() const = 0;
  virtual int size() const = 0;
  virtual const char* engine() const = 0;

  // Anonymous serve-tier fan-in counters (docs/transport.md): clients
  // are connections that carry no rank identity — only the epoll engine
  // accepts them; every other engine reports zeros.
  struct FanInStats {
    long long accepted_total = 0;  // anonymous connections ever accepted
    long long active_clients = 0;  // currently connected
    long long client_shed = 0;     // requests answered ReplyBusy by the
                                   // per-client admission gate
  };
  virtual FanInStats FanIn() const { return {}; }

  // Settle one per-client admission slot for an anonymous client whose
  // request was DROPPED server-side (deadline-expired or hedge-
  // cancelled read: no reply will ever route back to release it).
  // No-op on engines without anonymous clients.
  virtual void SettleClient(int client_rank) { (void)client_rank; }

  // Capacity plane (docs/observability.md): total bytes currently
  // parked on this engine's outbound write queues.  Only the epoll
  // engine queues frames (blocking engines hold none); the capacity
  // report's `net.writeq_bytes` gauge reads this.
  virtual long long QueuedBytes() const { return 0; }

  // Capacity plane (docs/observability.md): bytes currently held in
  // receive-side arenas — per-connection reassembly slabs on the epoll
  // engine, the registered buffer pool + heap fallback slabs on the
  // uring engine.  The `net.rx_arena_bytes` gauge reads this; blocking
  // engines buffer on the stack and report zero.
  virtual long long RxArenaBytes() const { return 0; }
};

namespace transport {

// Anonymous clients have no endpoint to connect back to, so the reactor
// assigns each accepted non-rank connection a PSEUDO-RANK at/above this
// base and routes Send(pseudo_rank) back over the accepted socket.
// Real ranks are always far below it, so routing stays a range check.
inline constexpr int kClientRankBase = 1 << 20;

inline bool IsClientRank(int r) { return r >= kClientRankBase; }

// A sender thread may tie its connect retries to a flag of its own: once
// the flag reads false, the engines' connect loops and send retries give
// up at their next step instead of spending the whole `connect_retry_ms`
// budget.  The heartbeat's per-peer senders tie theirs to the lease
// loop's running flag, so a shutdown never waits out a departed peer's
// reconnect budget; every other thread keeps the whole budget.
inline thread_local const std::atomic<bool>* tls_connect_guard = nullptr;

inline void SetConnectGuard(const std::atomic<bool>* keep_going) {
  tls_connect_guard = keep_going;
}

inline bool ConnectAbandoned() {
  const std::atomic<bool>* g = tls_connect_guard;
  return g != nullptr && !g->load(std::memory_order_acquire);
}

}  // namespace transport

// Machine-file/registration transports share one Init shape: endpoints
// are rank-indexed "host:port" strings, `rank` is this process's index,
// and every decoded inbound message is handed to `fn` (from reader or
// reactor threads).  MpiNet is NOT one of these — it derives rank/size
// from MPI itself.
class RankTransport : public Net {
 public:
  virtual bool Init(const std::vector<std::string>& endpoints, int rank,
                    InboundFn fn, int64_t connect_retry_ms = 15000) = 0;
};

// `-net_engine` factory ("tcp" | "epoll" | "uring"); nullptr on an
// unknown name.  "uring" requires uring::Probe() (uring_net.h) — the
// zoo checks it first and degrades to epoll with a logged reason.
std::unique_ptr<RankTransport> MakeRankTransport(const std::string& engine);

}  // namespace mvtpu
