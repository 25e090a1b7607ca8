// TcpNet — point-to-point transport between runtime processes.
// Capability parity with include/multiverso/net/zmq_net.h (SURVEY.md
// §2.18): peers come from a machine file (one "host:port" per line, line
// index = rank), frames are length-prefixed serialized Messages, and the
// receive side hands decoded messages to a router callback.  Plain POSIX
// TCP instead of libzmq: same dealer-style lazy connect, no external
// dependency.
#pragma once

#include <atomic>
#include <cstdint>
#include <functional>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "mvtpu/message.h"
#include "mvtpu/mutex.h"
#include "mvtpu/transport.h"

namespace mvtpu {

// The wire-transport interface itself (class Net + RankTransport) lives
// in mvtpu/transport.h — the `-net_engine` seam.  TcpNet here is the
// blocking thread-per-connection engine; EpollNet (epoll_net.h) the
// event-driven reactor; MpiNet (mpi_net.h) the literal MPI wire.
class TcpNet : public RankTransport {
 public:
  using InboundFn = Net::InboundFn;

  ~TcpNet() override { Stop(); }

  // Parse a machine file into "host:port" endpoints; empty on error.
  static std::vector<std::string> ParseMachineFile(const std::string& path);

  // One length-prefixed Message frame over a raw fd (used by the
  // dynamic-registration handshake, which runs before the transport,
  // and by the transport's own ReadLoop/Send).  The frame is written
  // SCATTER-GATHER (sendmsg over header + per-blob iovecs): the payload
  // blobs go to the kernel in place — no full-message Serialize() copy
  // on the send path (the frame layout is identical to Serialize()'s,
  // so RecvFramed/Deserialize are unchanged).  `max_bytes <= 0` means
  // the transport-wide frame cap; the handshake passes a tight bound so
  // a hostile/garbled registration connection cannot force a huge
  // allocation on the controller.
  static bool SendFramed(int fd, const Message& msg);
  // `body_timeout_ms > 0` bounds the read of a frame's BODY once its
  // length prefix arrived (an idle connection may block forever on the
  // prefix — that is legitimate; a peer that stalls mid-frame is not).
  // `frame_bytes` (optional) receives the frame's byte count — the
  // receive-side feed for the net.bytes.recv counter.
  static bool RecvFramed(int fd, Message* msg, int64_t max_bytes = 0,
                         int64_t body_timeout_ms = 0,
                         int64_t* frame_bytes = nullptr);

  // Dynamic registration (reference src/controller.cpp Control_Register,
  // SURVEY.md §2.7/§3.1): the controller listens on `ctrl_endpoint`,
  // collects `num_nodes - 1` ControlRegister messages (each carrying the
  // registrant's endpoint + role bitmask), assigns ranks in arrival
  // order, and answers every registrant with the full node table.
  // Registrants block until the table arrives.  On success: endpoints
  // and roles are rank-indexed, *my_rank is set (controller == 0), and
  // every registration socket is closed — the regular transport then
  // starts from the returned table.
  // `timeout_ms` bounds the whole collection (a crashed registrant must
  // not hang MV_Init forever); silent clients are bounded per-read.
  static bool RegisterController(const std::string& ctrl_endpoint,
                                 int num_nodes, int my_role,
                                 std::vector<std::string>* endpoints,
                                 std::vector<int>* roles,
                                 int64_t timeout_ms = 30000);
  static bool RegisterWithController(const std::string& ctrl_endpoint,
                                     const std::string& my_endpoint,
                                     int my_role, int64_t retry_ms,
                                     std::vector<std::string>* endpoints,
                                     std::vector<int>* roles, int* my_rank);

  // Bind + listen on endpoints[rank]'s port, start the accept loop,
  // deliver every inbound message to `fn` (called from reader threads).
  // `connect_retry_ms` bounds each lazy-connect's retry budget.
  bool Init(const std::vector<std::string>& endpoints, int rank,
            InboundFn fn, int64_t connect_retry_ms = 15000) override;

  // Frame + write to the peer (lazy connect with retries — peers start
  // in any order; scatter-gather, so the payload is never copied into a
  // contiguous wire buffer first).  A failed write is retried up to
  // `-send_retries` times with exponential backoff (`-send_backoff_ms`
  // base), reconnecting between attempts; writes are bounded by
  // `-io_timeout_ms` (SO_SNDTIMEO) so a wedged peer cannot park the
  // sender forever.  Fault-injection hooks (mvtpu/fault.h) sit on this
  // path: drop/delay/duplicate per logical message, fail per attempt.
  // Dashboard counters: net.retries, net.dropped.  Returns false on a
  // dead peer (after the retry budget).
  bool Send(int dst_rank, const Message& msg) override;

  void Stop() override;

  int rank() const override { return rank_; }
  int size() const override { return static_cast<int>(endpoints_.size()); }
  const char* engine() const override { return "tcp"; }

 private:
  void AcceptLoop();
  void ReadLoop(int fd);
  int ConnectTo(int dst_rank);
  // One connect-if-needed + framed-write attempt (no retry).  The retry
  // loop re-invokes this with the same Message — the iovec set is
  // rebuilt per attempt, so a partial write on a torn-down connection
  // never leaks into the next one.
  bool SendAttempt(int dst_rank, const Message& msg);

  std::vector<std::string> endpoints_;
  int rank_ = 0;
  InboundFn inbound_;
  int64_t connect_retry_ms_ = 15000;

  // listen_fd_/running_ are atomics, not mutex-guarded: AcceptLoop
  // blocks inside ::accept() holding no lock while Stop() shuts the fd
  // down from another thread to unblock it — the flags must be readable
  // concurrently with that teardown (TSan-verified, round 5).
  std::atomic<int> listen_fd_{-1};
  std::thread accept_thread_;
  Mutex readers_mu_;
  std::vector<std::thread> readers_ GUARDED_BY(readers_mu_);
  std::vector<int> accepted_fds_ GUARDED_BY(readers_mu_);

  // Per-destination locks: send_mus_[i] guards send_fds_[i] (lazy
  // connect install + framed write).  A per-ELEMENT capability is
  // beyond the annotation language, so the pairing is enforced by
  // review + TSan; the vectors themselves are sized once in Init.
  std::vector<int> send_fds_;
  std::vector<std::unique_ptr<Mutex>> send_mus_;

  std::atomic<bool> running_{false};
  Mutex mu_;  // serializes Stop vs ConnectTo's retry-abort check
};

}  // namespace mvtpu
