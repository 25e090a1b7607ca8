// UringNet — the io_uring completion-driven transport engine
// (docs/transport.md "io_uring data plane").
//
// Where EpollNet asks the kernel "which sockets are READY" and then
// issues the read/write itself, UringNet hands the kernel the whole
// operation up front and consumes COMPLETIONS: per shard one io_uring
// (SQ/CQ rings mmap'd, driven with raw syscalls — the container has no
// liburing) on which every recv, send, accept and timer is an in-flight
// SQE.  The message semantics are exactly EpollNet's — same Hello
// identify, same anonymous serve tier with pseudo-ranks and per-client
// admission, same fault/retry Send contract, same frame caps and
// 8-aligned arena packing — only the readiness model changed:
//
//  - RECEIVE: each shard registers a pool of `-uring_reg_bufs` fixed
//    buffers (IORING_REGISTER_BUFFERS) carved from HostArena slabs.
//    Frame bodies land via IORING_OP_READ_FIXED straight into a
//    registered slab and decode ZERO-COPY through Blob::Borrow — the
//    borrow's keepalive is the RegSlab handle, so the buffer index
//    returns to the pool only when the last consumer view dies (the
//    two-hold recycle discipline, with the kernel as one of the
//    holders).  When the pool runs dry or a frame outgrows a slab the
//    conn falls back to plain IORING_OP_RECV into a heap slab decoded
//    with Blob::View — correctness never depends on registration.
//  - SEND: frames queue on the same bounded per-conn write queue; the
//    reactor submits one gather IORING_OP_SENDMSG at a time per conn
//    over the frame's scatter segments.  Payloads at/above
//    `-uring_zc_bytes` use IORING_OP_SENDMSG_ZC when the kernel has it:
//    the frame's buffers stay pinned (a zc_holds ref per in-flight
//    zero-copy send) until the kernel's F_NOTIF completion says the
//    pages are no longer referenced.
//  - ACCEPT: one multishot IORING_OP_ACCEPT services the listen socket
//    (downgrading to re-armed single-shot on old kernels); the wake
//    eventfd is watched by a multishot POLL_ADD; a periodic
//    IORING_OP_TIMEOUT gives the loop the 200 ms heartbeat the epoll
//    engine gets from its epoll_wait timeout (running_ checks +
//    watchdog cadence).
//
// Selected by `-net_engine=uring`.  zoo.cc calls uring::Probe() first
// and degrades to epoll with a logged reason (and an `effective_engine`
// health field) when the kernel cannot run this engine.
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

namespace uring {

// Can this kernel run the uring engine?  Checks io_uring_setup plus
// IORING_REGISTER_PROBE support for every opcode the data plane needs
// (READ_FIXED, RECV, SENDMSG, ACCEPT, POLL_ADD, TIMEOUT).  On false,
// `reason` (if non-null) says why — the zoo logs it and degrades to
// epoll.  MVTPU_URING_FORCE_UNSUPPORTED=1 in the environment forces a
// false (the fallback regression test's hook; an env var, not a flag,
// so the knob stays off the wire/flag-parity surface).
bool Probe(std::string* reason);

}  // namespace uring

class UringNet : public RankTransport {
 public:
  // Out of line: members hold unique_ptr<Shard> with Shard defined in
  // the .cc only.
  ~UringNet() override;

  bool Init(const std::vector<std::string>& endpoints, int rank,
            InboundFn fn, int64_t connect_retry_ms = 15000) override;

  // Fault-injection + bounded-retry semantics match EpollNet::Send
  // exactly (drop/delay/dup/fail_send, net.retries/net.dropped/...);
  // delivery is a queue append + eventfd wake — the caller blocks only
  // on the write-queue backpressure bound, never the socket.
  bool Send(int dst_rank, const Message& msg) override;

  void Stop() override;

  int rank() const override { return rank_; }
  int size() const override { return static_cast<int>(endpoints_.size()); }
  const char* engine() const override { return "uring"; }
  FanInStats FanIn() const override;
  void SettleClient(int client_rank) override;
  long long QueuedBytes() const override {
    return wq_bytes_total_.load(std::memory_order_relaxed);
  }
  // Receive-arena footprint (`net.rx_arena_bytes`): the registered
  // buffer pools (counted whole — the engine holds them for its
  // lifetime) plus every conn's live heap-fallback slab.
  long long RxArenaBytes() const override {
    return rx_arena_total_.load(std::memory_order_relaxed);
  }

 private:
  struct PendingFrame;
  struct RegPool;
  struct RegSlab;
  struct Conn;
  struct Shard;

  // ---- ring plumbing (all reactor-thread-only per shard)
  bool SetupRing(Shard* s, unsigned depth, bool sqpoll);
  void TeardownRing(Shard* s);
  void* GetSqe(Shard* s);  // io_uring_sqe*, null if SQ full past a flush
  int SubmitPending(Shard* s, bool wait);
  unsigned DrainCqes(Shard* s);
  void ProcessCqe(Shard* s, uint64_t user_data, int32_t res,
                  uint32_t flags);

  void ReactorLoop(Shard* s);
  void AdoptHandoffs(Shard* s);
  void ArmWake(Shard* s);
  void ArmAccept(Shard* s);
  void ArmTimeout(Shard* s);
  void ArmRecv(Shard* s, const std::shared_ptr<Conn>& c);
  // Submit (or re-submit after a partial) the head-of-queue frame.
  void PumpSend(Shard* s, const std::shared_ptr<Conn>& c);
  void OnAccepted(Shard* s, int fd);
  void OnRecv(Shard* s, const std::shared_ptr<Conn>& c, int32_t res);
  void OnSent(Shard* s, const std::shared_ptr<Conn>& c, int32_t res,
              uint32_t cqe_flags, uint32_t zc_seq, bool zc);
  // Choose where the announced frame assembles (registered slab vs
  // heap fallback) honoring the 8-aligned rewind/append/alloc rules.
  void PlaceFrame(Shard* s, const std::shared_ptr<Conn>& c, size_t need);
  bool FinishFrame(Shard* s, const std::shared_ptr<Conn>& c);
  // Two-phase teardown: Retire() stops new I/O and shuts the socket
  // down; the conn finalizes (close + erase) once its in-flight SQEs
  // have all completed (pending_ops == 0).
  void RetireConn(Shard* s, const std::shared_ptr<Conn>& c,
                  const char* why);
  void FinalizeConn(Shard* s, const std::shared_ptr<Conn>& c);

  bool SendAttempt(int dst_rank, const Message& msg);
  std::shared_ptr<Conn> ResolveConn(int dst_rank);
  std::shared_ptr<Conn> ConnectToRank(int dst_rank);
  bool Enqueue(const std::shared_ptr<Conn>& c, const Message& msg,
               bool may_block = true);
  void WakeShard(Shard* s);

  std::vector<std::string> endpoints_;
  int rank_ = 0;
  InboundFn inbound_;
  int64_t connect_retry_ms_ = 15000;

  std::atomic<bool> running_{false};
  std::atomic<bool> stopping_{false};
  std::atomic<int> listen_fd_{-1};
  std::atomic<int> next_shard_{0};
  std::atomic<int> next_client_{0};
  std::atomic<uint32_t> next_conn_id_{1};
  // SENDMSG_ZC support, probed at Init; cleared engine-wide the first
  // time the kernel answers EINVAL/EOPNOTSUPP (the frame resubmits as
  // a plain SENDMSG — degradation, never data loss).
  std::atomic<bool> zc_ok_{false};
  // `-uring_zc_bytes`: frames at/above this many remaining bytes send
  // zero-copy (negative disables).  Read once at Init.
  int64_t zc_bytes_ = 65536;

  std::atomic<long long> accepted_total_{0};
  std::atomic<long long> active_clients_{0};
  std::atomic<long long> client_shed_{0};
  std::atomic<long long> wq_bytes_total_{0};
  std::atomic<long long> rx_arena_total_{0};

  std::vector<std::unique_ptr<Shard>> shards_;

  Mutex conns_mu_;
  std::vector<std::shared_ptr<Conn>> rank_conns_ GUARDED_BY(conns_mu_);
  std::unordered_map<int, std::shared_ptr<Conn>> client_conns_
      GUARDED_BY(conns_mu_);
  std::vector<std::shared_ptr<Conn>> all_conns_ GUARDED_BY(conns_mu_);

  Mutex stop_mu_;  // serializes Stop vs Stop
};

// Factory for the `-net_engine=uring` arm of MakeRankTransport.
std::unique_ptr<RankTransport> MakeUringTransport();

}  // namespace mvtpu
