// EpollNet — the event-driven transport engine (docs/transport.md).
//
// One epoll loop (plus optional `-net_threads` shards) drives every
// socket non-blocking through per-connection read/write state machines:
//
//  - READ: frames reassemble incrementally (a peer may deliver one byte
//    per readiness event) into a reusable receive ARENA; a completed
//    frame is decoded ZERO-COPY — Message blobs are views into the
//    arena slab (Blob::View), and the slab is recycled once no view is
//    left alive.  A connection dropping mid-frame discards the partial.
//  - WRITE: sends enqueue scatter-gather frames (header scratch + blob
//    refs, no payload copy) on a bounded per-connection write queue
//    drained by the reactor under EPOLLOUT — a short write just waits
//    for the next readiness instead of tearing the connection down
//    (TcpNet's retry-by-reconnect).  A full queue backpressures the
//    sender (bounded by `-io_timeout_ms`).
//  - ACCEPT: rank peers identify themselves with a tiny Hello first
//    frame (sent by ConnectToRank pre-reactor; only a valid Hello
//    grants rank identity and the large rank frame bound).  Besides
//    them, the reactor accepts ANONYMOUS serve clients (connections
//    opening with anything other than a rank Hello).  Each is
//    assigned a pseudo-rank >= transport::kClientRankBase; replies
//    route back over the accepted socket, and a per-client admission
//    gate (`-client_inflight_max`) sheds Gets/probes with ReplyBusy on
//    top of the server-wide `-server_inflight_max`.
//
// Selected by `-net_engine=epoll` (the default for TCP fleets).
#pragma once

#include <atomic>
#include <cstdint>
#include <deque>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "mvtpu/message.h"
#include "mvtpu/mutex.h"
#include "mvtpu/transport.h"

namespace mvtpu {

class EpollNet : public RankTransport {
 public:
  ~EpollNet() override { Stop(); }

  bool Init(const std::vector<std::string>& endpoints, int rank,
            InboundFn fn, int64_t connect_retry_ms = 15000) override;

  // Fault-injection + bounded-retry semantics match TcpNet::Send
  // (drop/delay/dup per logical message, fail_send per attempt,
  // net.retries/net.dropped/... counters); delivery itself is a queue
  // append + reactor wake, so the caller never blocks on the socket —
  // only on the write-queue backpressure bound.
  bool Send(int dst_rank, const Message& msg) override;

  void Stop() override;

  int rank() const override { return rank_; }
  int size() const override { return static_cast<int>(endpoints_.size()); }
  const char* engine() const override { return "epoll"; }
  FanInStats FanIn() const override;
  void SettleClient(int client_rank) override;
  // Capacity plane (docs/observability.md): bytes currently parked
  // across every connection's bounded write queue — the
  // `net.writeq_bytes` gauge of the "capacity" ops report.
  long long QueuedBytes() const override {
    return wq_bytes_total_.load(std::memory_order_relaxed);
  }
  // Receive-arena footprint: sum of every connection's live slab —
  // the `net.rx_arena_bytes` gauge (transport memory that was invisible
  // to mvtop --capacity / mvplan before it).
  long long RxArenaBytes() const override {
    return rx_arena_total_.load(std::memory_order_relaxed);
  }

 private:
  struct PendingFrame;
  struct Conn;
  struct Shard;

  void ReactorLoop(Shard* s);
  // Adopt pending connection registrations + write-queue arms.  Called
  // at the top of every reactor cycle AND whenever the wake eventfd is
  // drained mid-batch — consuming a wake without re-adopting would
  // strand the sender's hand-off for a full epoll_wait cycle (the
  // lost-wakeup tail spike the latency plane attributed to wire_back).
  void AdoptHandoffs(Shard* s);
  void HandleAccept(Shard* s);
  void HandleReadable(Shard* s, const std::shared_ptr<Conn>& c);
  // Drain the write queue as far as the socket accepts.  Returns false
  // on a hard write error (the caller closes the connection).
  bool DrainWrites(const std::shared_ptr<Conn>& c, bool* empty);
  void CloseConn(Shard* s, const std::shared_ptr<Conn>& c,
                 const char* why);
  // Decode + route one completed arena frame; false on a malformed
  // frame or a shed whose busy-reply could not be queued.
  bool FinishFrame(Shard* s, const std::shared_ptr<Conn>& c);

  bool SendAttempt(int dst_rank, const Message& msg);
  std::shared_ptr<Conn> ResolveConn(int dst_rank);
  std::shared_ptr<Conn> ConnectToRank(int dst_rank);
  // may_block=false for reactor-originated sends (synthesized busy
  // replies): the reactor drains the queues, so it must never wait on
  // one — a full queue drops the reply instead of deadlocking the
  // shard.
  bool Enqueue(const std::shared_ptr<Conn>& c, const Message& msg,
               bool may_block = true);
  void WakeShard(Shard* s);
  void ArmWrite(const std::shared_ptr<Conn>& c);

  std::vector<std::string> endpoints_;
  int rank_ = 0;
  InboundFn inbound_;
  int64_t connect_retry_ms_ = 15000;

  std::atomic<bool> running_{false};
  std::atomic<bool> stopping_{false};
  std::atomic<int> listen_fd_{-1};
  std::atomic<int> next_shard_{0};
  std::atomic<int> next_client_{0};

  // Fan-in counters (FanIn()).
  std::atomic<long long> accepted_total_{0};
  std::atomic<long long> active_clients_{0};
  std::atomic<long long> client_shed_{0};
  // Engine-wide write-queue depth in bytes (sum of per-conn wq_bytes,
  // maintained beside every wq mutation — QueuedBytes()).
  std::atomic<long long> wq_bytes_total_{0};
  // Engine-wide receive-arena bytes (sum of per-conn slab sizes,
  // maintained beside every slab allocation/close — RxArenaBytes()).
  std::atomic<long long> rx_arena_total_{0};

  std::vector<std::unique_ptr<Shard>> shards_;

  // Connection registry.  rank_conns_ holds the lazy outbound
  // connection per peer rank; client_conns_ maps pseudo-rank ->
  // accepted anonymous connection; all_conns_ is the teardown roster.
  Mutex conns_mu_;
  std::vector<std::shared_ptr<Conn>> rank_conns_ GUARDED_BY(conns_mu_);
  std::unordered_map<int, std::shared_ptr<Conn>> client_conns_
      GUARDED_BY(conns_mu_);
  std::vector<std::shared_ptr<Conn>> all_conns_ GUARDED_BY(conns_mu_);

  Mutex stop_mu_;  // serializes Stop vs Stop
};

}  // namespace mvtpu
