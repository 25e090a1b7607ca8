// mvlint: reactor-context — this file runs inside the epoll event loop:
// every socket op must be nonblocking (MSG_DONTWAIT / SOCK_NONBLOCK),
// enforced by mvlint rule MV009 (docs/transport.md).
#include "mvtpu/epoll_net.h"

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstring>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/fault.h"
#include "mvtpu/latency.h"
#include "mvtpu/log.h"
#include "mvtpu/net.h"
#include "mvtpu/ops.h"
#include "mvtpu/qos.h"
#include "mvtpu/uring_net.h"
#include "mvtpu/watchdog.h"

namespace mvtpu {

namespace {

bool SplitHostPort(const std::string& ep, std::string* host, int* port) {
  auto colon = ep.rfind(':');
  if (colon == std::string::npos) return false;
  *host = ep.substr(0, colon);
  try {
    *port = std::stoi(ep.substr(colon + 1));
  } catch (...) {
    return false;
  }
  return *port > 0 && *port < 65536;
}

int64_t FlagOr(const char* name, int64_t dflt) {
  return mvtpu::configure::Has(name) ? mvtpu::configure::GetInt(name)
                                     : dflt;
}

bool SetNonBlocking(int fd) {
  int fl = ::fcntl(fd, F_GETFL, 0);
  return fl >= 0 && ::fcntl(fd, F_SETFL, fl | O_NONBLOCK) == 0;
}

void SetNoDelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Frame caps: rank peers may ship table shards (the TcpNet bound); an
// anonymous/unidentified connection is untrusted — its frames are serve
// requests (tiny), so a garbled or hostile client cannot force a huge
// arena allocation.
constexpr int64_t kMaxRankFrameBytes = int64_t{1} << 40;
constexpr int64_t kMaxClientFrameBytes = int64_t{1} << 26;  // 64 MiB
constexpr size_t kDefaultSlabBytes = 256 << 10;

#if defined(__SANITIZE_THREAD__)
#define MVTPU_TSAN 1
#elif defined(__has_feature)
#if __has_feature(thread_sanitizer)
#define MVTPU_TSAN 1
#endif
#endif

// True when the reactor may REWIND the slab and overwrite it: no Blob
// view is left alive.  The consumer's last read of a view is ordered
// before our overwrite by (a) the view's shared_ptr release decrement
// (acq_rel in libstdc++) and (b) the acquire FENCE below pairing with
// it after the relaxed use_count() observation (atomics.fences) — the
// bare use_count() == 1 check alone carries no happens-before edge
// (TSan caught exactly that on the ssp_tput sweep).  TSan does not
// model fences, so under it the fast path is compiled out (a fresh
// slab is allocated instead of rewinding) rather than suppressed.
bool SlabExclusive(const std::shared_ptr<std::vector<char>>& slab) {
#ifdef MVTPU_TSAN
  (void)slab;
  return false;
#else
  if (slab.use_count() != 1) return false;
  std::atomic_thread_fence(std::memory_order_acquire);
  return true;
#endif
}

}  // namespace

// One queued outbound frame: the interleaved scratch (length prefix +
// wire header + per-blob length prefixes) plus refcounted blob handles —
// the payload bytes are gather-written from the Message's own buffers,
// never copied into a contiguous wire image (the send contract,
// now preserved across partial writes by `done`).
struct EpollNet::PendingFrame {
  struct Head {
    int64_t frame_len;
    WireHeader h;
  } head;
  std::vector<int64_t> lens;
  Message msg;        // shallow blob copies keep the payload alive
  int64_t total = 0;  // prefix + frame bytes
  int64_t done = 0;   // bytes already on the wire

  explicit PendingFrame(const Message& m) : msg(m) {
    head.frame_len = m.WireBytes();
    m.FillWireHeader(&head.h);
    lens.resize(m.data.size());
    for (size_t i = 0; i < m.data.size(); ++i)
      lens[i] = static_cast<int64_t>(m.data[i].size());
    total = head.frame_len + static_cast<int64_t>(sizeof(int64_t));
  }

  // Segment view for gather writes: [head][len0][blob0][len1][blob1]...
  // Fills iovecs starting `done` bytes into the frame; returns count.
  size_t FillIov(iovec* iov, size_t max_iov) {
    size_t n = 0;
    int64_t skip = done;
    auto push = [&](const void* base, size_t len) {
      if (n >= max_iov || len == 0) return;
      if (skip >= static_cast<int64_t>(len)) {
        skip -= static_cast<int64_t>(len);
        return;
      }
      iov[n].iov_base = const_cast<char*>(
          static_cast<const char*>(base) + skip);
      iov[n].iov_len = len - static_cast<size_t>(skip);
      skip = 0;
      ++n;
    };
    push(&head, sizeof(head));
    // Latency trail rides between header and blob prefixes (message.cc
    // Serialize order); head.frame_len already counts it (WireBytes).
    if (msg.has_timing()) push(&msg.timing, sizeof(TimingTrail));
    // Delivery-audit stamp rides after the trail (same Serialize
    // order); head.frame_len counts it via WireBytes().
    if (msg.has_audit()) push(&msg.audit, sizeof(AuditStamp));
    // QoS/deadline stamp rides after the audit stamp (same order).
    if (msg.has_qos()) push(&msg.qos, sizeof(QosStamp));
    for (size_t i = 0; i < msg.data.size(); ++i) {
      push(&lens[i], sizeof(int64_t));
      push(msg.data[i].data(), msg.data[i].size());
    }
    return n;
  }
};

struct EpollNet::Conn {
  int fd = -1;
  int shard = 0;
  bool accepted = false;
  // rank, pseudo-rank (>= transport::kClientRankBase), or -1 for an
  // accepted connection whose first message has not arrived yet.
  std::atomic<int> peer{-1};

  // ---- read state machine: touched ONLY by the owning shard's reactor
  // thread, so it needs no lock.
  char len_buf[sizeof(int64_t)] = {0};
  size_t len_got = 0;
  int64_t body_len = -1;  // -1: reading the length prefix
  size_t body_got = 0;
  // Receive arena: frames assemble in `slab` at slab_off; completed
  // frames stay referenced by Blob views until the table layer drops
  // them, at which point use_count()==1 lets the reactor rewind and
  // reuse the slab instead of allocating.
  std::shared_ptr<std::vector<char>> slab;
  size_t slab_off = 0;
  size_t slab_used = 0;
  // Bytes of `slab` currently counted in rx_arena_total_ (reactor-thread
  // only, like the slab itself) — the net.rx_arena_bytes gauge.
  size_t slab_tracked = 0;

  // Per-client admission (reactor increments on forwarded requests;
  // Send decrements when the reply goes out).
  std::atomic<long long> inflight{0};
  // Tenant class (docs/serving.md "tail"): latched from the first
  // frame carrying a QoS stamp (-1 until declared; effective class 0 =
  // the first -qos_classes entry).  A connection property so replies
  // can settle the right class budget without carrying the stamp back.
  std::atomic<int> qos_class{-1};

  Mutex mu;
  CondVar can_write;  // backpressure + drain-on-stop waiters
  // capacity: wq_bytes_total_ gauge — the "capacity" report's
  // net.writeq_bytes field (bounded at -net_writeq_bytes per conn)
  std::deque<PendingFrame> wq GUARDED_BY(mu);
  int64_t wq_bytes GUARDED_BY(mu) = 0;
  bool want_out GUARDED_BY(mu) = false;  // EPOLLOUT armed
  bool closed GUARDED_BY(mu) = false;
};

struct EpollNet::Shard {
  int epfd = -1;
  int wake_fd = -1;
  int idx = 0;  // position in shards_ — names the watchdog loop
  std::thread thread;
  // Hand-off queues: Send/accept threads push, the reactor pops.
  Mutex mu;
  std::vector<std::shared_ptr<Conn>> to_register GUARDED_BY(mu);
  std::vector<std::shared_ptr<Conn>> to_arm GUARDED_BY(mu);
  // fd -> conn, reactor-thread-only after registration.
  std::unordered_map<int, std::shared_ptr<Conn>> conns;
};

bool EpollNet::Init(const std::vector<std::string>& endpoints, int rank,
                    InboundFn fn, int64_t connect_retry_ms) {
  endpoints_ = endpoints;
  rank_ = rank;
  inbound_ = std::move(fn);
  connect_retry_ms_ = connect_retry_ms;
  {
    MutexLock lk(conns_mu_);
    rank_conns_.assign(endpoints_.size(), nullptr);
  }

  std::string host;
  int port = 0;
  if (rank_ < 0 || rank_ >= static_cast<int>(endpoints_.size()) ||
      !SplitHostPort(endpoints_[rank_], &host, &port)) {
    Log::Error("EpollNet: bad rank %d / endpoint list (%zu entries)",
               rank_, endpoints_.size());
    return false;
  }

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return false;
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(lfd, 1024) < 0 || !SetNonBlocking(lfd)) {
    Log::Error("EpollNet: cannot listen on port %d", port);
    ::close(lfd);
    return false;
  }
  listen_fd_ = lfd;

  int nshards = static_cast<int>(
      std::min<int64_t>(16, std::max<int64_t>(1, FlagOr("net_threads", 1))));
  running_ = true;
  stopping_ = false;
  // Two passes: EVERY shard exists in shards_ before ANY reactor thread
  // runs — shard 0's reactor accepts connections immediately, and its
  // round-robin placement (next_shard_ % shards_.size()) must see the
  // full, immutable shard vector, never a vector mid-growth.
  for (int i = 0; i < nshards; ++i) {
    auto s = std::make_unique<Shard>();
    s->idx = i;
    s->epfd = ::epoll_create1(0);
    s->wake_fd = ::eventfd(0, EFD_NONBLOCK);
    if (s->epfd < 0 || s->wake_fd < 0) {
      Log::Error("EpollNet: epoll/eventfd creation failed");
      running_ = false;
      if (s->epfd >= 0) ::close(s->epfd);
      if (s->wake_fd >= 0) ::close(s->wake_fd);
      ::close(lfd);
      listen_fd_ = -1;
      for (auto& sh : shards_) {
        ::close(sh->epfd);
        ::close(sh->wake_fd);
      }
      shards_.clear();
      return false;
    }
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = s->wake_fd;
    ::epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wake_fd, &ev);
    if (i == 0) {
      epoll_event lev{};
      lev.events = EPOLLIN;
      lev.data.fd = lfd;
      ::epoll_ctl(s->epfd, EPOLL_CTL_ADD, lfd, &lev);
    }
    shards_.push_back(std::move(s));
  }
  for (auto& s : shards_) {
    Shard* raw = s.get();
    s->thread = std::thread([this, raw] { ReactorLoop(raw); });
  }
  Log::Info("EpollNet: rank %d/%zu listening on :%d (%d shard%s)", rank_,
            endpoints_.size(), port, nshards, nshards == 1 ? "" : "s");
  return true;
}

void EpollNet::WakeShard(Shard* s) {
  uint64_t one = 1;
  ssize_t n = ::write(s->wake_fd, &one, sizeof(one));
  (void)n;  // EAGAIN means a wake is already pending — good enough
}

void EpollNet::AdoptHandoffs(Shard* s) {
  std::vector<std::shared_ptr<Conn>> regs, arms;
  {
    MutexLock lk(s->mu);
    regs.swap(s->to_register);
    arms.swap(s->to_arm);
  }
  for (auto& c : regs) {
    s->conns[c->fd] = c;
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = c->fd;
    ::epoll_ctl(s->epfd, EPOLL_CTL_ADD, c->fd, &ev);
  }
  for (auto& c : arms) {
    auto it = s->conns.find(c->fd);
    if (it == s->conns.end() || it->second != c) continue;
    bool empty = true;
    if (!DrainWrites(c, &empty)) {
      CloseConn(s, c, "write error");
      continue;
    }
    if (!empty) ArmWrite(c);  // EPOLLOUT resumes the drain
  }
}

void EpollNet::ReactorLoop(Shard* s) {
  constexpr int kMaxEvents = 128;
  epoll_event events[kMaxEvents];
  // Watchdog (docs/observability.md "health plane"): one Bump per
  // drained event batch; "busy" while a batch is in hand.  A reactor
  // that stops draining with events pending — the lost-wakeup class of
  // bug — shows as "reactor.<shard> no progress" with a nonzero queue.
  const std::string wd_name = "reactor." + std::to_string(s->idx);
  while (running_) {
    int n = ::epoll_wait(s->epfd, events, kMaxEvents, 200);
    if (!running_) break;
    if (n < 0) {
      if (errno == EINTR) continue;
      break;
    }
    watchdog::Busy(wd_name, n);
    // Adopt hand-offs first so a just-connected peer's events register
    // before we sleep again.
    AdoptHandoffs(s);
    for (int i = 0; i < n; ++i) {
      int fd = events[i].data.fd;
      uint32_t what = events[i].events;
      if (fd == s->wake_fd) {
        uint64_t junk;
        while (::read(s->wake_fd, &junk, sizeof(junk)) > 0) {
        }
        // Re-adopt AFTER draining the eventfd: a sender that enqueued
        // between this batch's top-of-loop adoption and the drain just
        // had its wake CONSUMED — without this, its frame would sit in
        // the hand-off queue for a full epoll_wait cycle (a ~200 ms
        // tail spike on quiet paced traffic; the tail bench caught it
        // as a wire_back stage stall).
        AdoptHandoffs(s);
        continue;
      }
      if (fd == listen_fd_.load()) {
        HandleAccept(s);
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;  // closed earlier this batch
      std::shared_ptr<Conn> c = it->second;
      if (what & (EPOLLHUP | EPOLLERR)) {
        // Flush whatever the peer managed to send before the hangup,
        // then tear down (a mid-frame partial is discarded).
        HandleReadable(s, c);
        auto again = s->conns.find(fd);
        if (again != s->conns.end() && again->second == c)
          CloseConn(s, c, (what & EPOLLERR) ? "socket error" : "hangup");
        continue;
      }
      if (what & EPOLLOUT) {
        bool empty = true;
        if (!DrainWrites(c, &empty)) {
          CloseConn(s, c, "write error");
          continue;
        }
        if (empty) {
          // Disarm EPOLLOUT so an idle connection stops waking us.
          MutexLock lk(c->mu);
          if (c->wq.empty() && c->want_out) {
            c->want_out = false;
            epoll_event ev{};
            ev.events = EPOLLIN;
            ev.data.fd = c->fd;
            ::epoll_ctl(s->epfd, EPOLL_CTL_MOD, c->fd, &ev);
          }
        }
      }
      if (what & EPOLLIN) HandleReadable(s, c);
    }
    watchdog::Bump(wd_name);
    watchdog::Busy(wd_name, 0);
  }
}

void EpollNet::HandleAccept(Shard* s) {
  (void)s;
  while (true) {
    int fd = ::accept4(listen_fd_.load(), nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) return;  // EAGAIN: drained
    SetNoDelay(fd);
    auto c = std::make_shared<Conn>();
    c->fd = fd;
    c->accepted = true;
    c->shard = next_shard_.fetch_add(1) %
               static_cast<int>(shards_.size());
    {
      MutexLock lk(conns_mu_);
      all_conns_.push_back(c);
    }
    Shard* target = shards_[static_cast<size_t>(c->shard)].get();
    {
      MutexLock lk(target->mu);
      target->to_register.push_back(c);
    }
    WakeShard(target);
  }
}

void EpollNet::HandleReadable(Shard* s, const std::shared_ptr<Conn>& c) {
  const size_t slab_bytes = static_cast<size_t>(
      FlagOr("net_arena_bytes", static_cast<int64_t>(kDefaultSlabBytes)));
  while (true) {
    if (c->body_len < 0) {
      // Length prefix, possibly one byte at a time.
      ssize_t r = ::recv(c->fd, c->len_buf + c->len_got,
                         sizeof(c->len_buf) - c->len_got, MSG_DONTWAIT);
      if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
        CloseConn(s, c, r == 0 ? "peer closed" : "read error");
        return;
      }
      if (r < 0) return;  // EAGAIN
      c->len_got += static_cast<size_t>(r);
      if (c->len_got < sizeof(c->len_buf)) continue;
      int64_t len;
      std::memcpy(&len, c->len_buf, sizeof(len));
      // PER FRAME, not per readable batch: a rank peer identifies
      // itself with its tiny Hello first frame (FinishFrame sets
      // c->peer mid-loop), and the very next frame — possibly a
      // shard-sized payload — must already enjoy the rank bound.
      const int64_t max_frame =
          (c->accepted && c->peer.load() < 0) ||
                  transport::IsClientRank(c->peer.load())
              ? kMaxClientFrameBytes
              : kMaxRankFrameBytes;
      if (len <= 0 || len > max_frame) {
        CloseConn(s, c, "bad frame length");
        return;
      }
      // Arena placement: rewind a slab nothing references any more;
      // append into leftover space otherwise; allocate only when the
      // live region leaves no room.  Pack offsets 8-ALIGNED: the
      // previous frame's payload may still be read through a Blob view
      // on another thread while this recv writes the next frame, and
      // adjacent unaligned frames would share an 8-byte granule (a
      // false-sharing data race TSan rightly halts on).
      c->slab_used = (c->slab_used + 7) & ~size_t{7};
      size_t need = static_cast<size_t>(len);
      if (c->slab && SlabExclusive(c->slab)) {
        if (c->slab->size() < need)
          c->slab->resize(std::max(need, slab_bytes));
        c->slab_used = 0;
      } else if (!c->slab ||
                 c->slab->size() < c->slab_used + need) {
        // Addition, never subtraction: an exact-fit frame leaves an
        // odd-sized slab whose aligned slab_used can EXCEED size() —
        // size()-slab_used would underflow to "plenty of room" and the
        // next recv would write past the buffer.
        c->slab = std::make_shared<std::vector<char>>(
            std::max(need, slab_bytes));
        c->slab_used = 0;
      }
      c->slab_off = c->slab_used;
      c->body_len = len;
      c->body_got = 0;
      c->len_got = 0;
      // Capacity plane: keep the rx-arena gauge in step with whatever
      // the placement above allocated/resized (a replaced slab's old
      // bytes leave the gauge with its last view, not here — the gauge
      // tracks what the ENGINE holds).
      size_t sz = c->slab->size();
      if (sz != c->slab_tracked) {
        rx_arena_total_.fetch_add(
            static_cast<long long>(sz) -
                static_cast<long long>(c->slab_tracked),
            std::memory_order_relaxed);
        c->slab_tracked = sz;
      }
    }
    // Frame body straight into the arena slab.
    size_t want = static_cast<size_t>(c->body_len) - c->body_got;
    ssize_t r = ::recv(c->fd, c->slab->data() + c->slab_off + c->body_got,
                       want, MSG_DONTWAIT);
    if (r == 0 || (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
      // Mid-frame disconnect: the partial frame dies with the
      // connection — nothing was delivered upstream.
      CloseConn(s, c, r == 0 ? "peer closed mid-frame" : "read error");
      return;
    }
    if (r < 0) return;  // EAGAIN
    c->body_got += static_cast<size_t>(r);
    if (c->body_got < static_cast<size_t>(c->body_len)) continue;
    if (!FinishFrame(s, c)) {
      CloseConn(s, c, "malformed frame");
      return;
    }
  }
}

bool EpollNet::FinishFrame(Shard* s, const std::shared_ptr<Conn>& c) {
  (void)s;
  size_t len = static_cast<size_t>(c->body_len);
  Dashboard::Record(
      "net.bytes.recv",
      static_cast<double>(c->body_len +
                          static_cast<int64_t>(sizeof(int64_t))));
  Message m;
  bool ok = Message::DeserializeView(c->slab, c->slab_off, len, &m);
  c->slab_used = c->slab_off + len;
  c->body_len = -1;
  c->body_got = 0;
  if (!ok) return false;
  // Latency trail: frame-complete AT THE REACTOR — the stamp the
  // mailbox stage starts from (docs/observability.md).
  latency::StampRecv(&m);
  // Deadline propagation (docs/serving.md "tail"): convert the wire
  // budget into a local-clock deadline while the recv boundary is hot.
  qos::AdoptDeadline(&m);

  int peer = c->peer.load();
  if (c->accepted && peer < 0) {
    // First frame identifies the connection: a fleet peer announces
    // itself with a Hello carrying its rank in src (sent by
    // ConnectToRank before any payload, so the identifying frame is
    // always tiny and always first); ANY other opening frame — valid
    // src or not — is an anonymous serve client, which gets a
    // pseudo-rank so replies can route back over this socket.  A
    // client forging a rank in src therefore neither impersonates a
    // fleet member nor unlocks the rank frame bound.
    if (m.type == MsgType::Hello && m.src >= 0 &&
        m.src < static_cast<int>(endpoints_.size())) {
      peer = m.src;
      c->peer = peer;
    } else {
      peer = transport::kClientRankBase + next_client_.fetch_add(1);
      c->peer = peer;
      accepted_total_.fetch_add(1);
      active_clients_.fetch_add(1);
      MutexLock lk(conns_mu_);
      client_conns_[peer] = c;
    }
  }
  // The identify frame is transport-internal: consumed here, never
  // forwarded upstream (stray Hellos on an identified connection are
  // dropped the same way).
  if (m.type == MsgType::Hello) return true;
  if (m.type == MsgType::RequestCancel) {
    // Hedge-cancel token (docs/serving.md "tail"): consumed AT THE
    // REACTOR like Hello/OpsQuery — never the mailbox, so it OVERTAKES
    // the FIFO the loser read is parked in.  Fire-and-forget:
    // uncounted by admission, no reply.
    qos::NoteCancel(transport::IsClientRank(peer) ? peer : m.src,
                    m.msg_id);
    Dashboard::Record("serve.hedge.cancel_noted", 0.0);
    return true;
  }
  if (m.type == MsgType::OpsQuery) {
    // Introspection scrape (docs/observability.md): answered AT THE
    // REACTOR, exactly like a synthesized busy reply — it must never
    // touch the actor mailbox (a wedged server still reports health),
    // and reactor-originated sends never block (may_block=false: a
    // full write queue drops the reply; the scraper's deadline covers
    // it).  Uncounted by the per-client admission gate, like Hello.
    if (transport::IsClientRank(peer)) m.src = peer;
    if (m.version != 1) {
      Message reply;
      ops::BuildReply(m, &reply);
      reply.src = rank_;
      reply.dst = m.src;
      // The reactor IS this query's actor+applier: close the mailbox
      // and apply stages here so a timed scrape still attributes.
      latency::StampDequeue(&m);
      latency::StampReply(m, &reply);
      latency::StampSend(&reply);
      return Enqueue(c, reply, /*may_block=*/false);
    }
    // Fleet scope: the zoo fans out on a bounded detached thread —
    // the hand-off itself (thread spawn) is reactor-safe.
    if (inbound_) inbound_(std::move(m));
    return true;
  }
  if (transport::IsClientRank(peer)) {
    // Anonymous client: the pseudo-rank IS the reply address.
    m.src = peer;
    // Tenant class declaration (docs/serving.md "tail"): latched from
    // the first QoS-stamped frame; later stamps may retarget it.
    if (m.has_qos()) c->qos_class.store(m.qos.klass);
    int qc = c->qos_class.load();
    if (qc < 0) qc = 0;  // undeclared = the first -qos_classes entry
    bool counted =
        m.type == MsgType::RequestGet || m.type == MsgType::RequestVersion ||
        m.type == MsgType::RequestReplica ||
        m.type == MsgType::RequestFlush ||
        (m.type == MsgType::RequestAdd && m.msg_id >= 0);
    bool readlike = counted && m.type != MsgType::RequestAdd &&
                    m.type != MsgType::RequestFlush;
    auto reply_busy = [&]() {
      Message busy;
      busy.type = MsgType::ReplyBusy;
      busy.table_id = m.table_id;
      busy.msg_id = m.msg_id;
      busy.trace_id = m.trace_id;
      busy.src = rank_;
      busy.dst = peer;
      latency::StampDequeue(&m);
      latency::StampReply(m, &busy);
      latency::StampSend(&busy);
      // Reactor thread: never block on our own write queue.
      return Enqueue(c, busy, /*may_block=*/false);
    };
    // Deadline shed (docs/serving.md "tail"): a read that arrives
    // already past its propagated budget is dropped outright — the
    // caller stopped waiting, so neither a mailbox slot nor a busy
    // reply is owed.  Adds/flushes are never deadline-shed.
    if (readlike && qos::ShedExpired(m)) return true;
    int64_t cap = FlagOr("client_inflight_max", 64);
    if (cap > 0 && readlike && c->inflight.load() >= cap) {
      // Per-client admission on top of -server_inflight_max: shed
      // Gets/probes (never adds) without touching the actor mailbox.
      client_shed_.fetch_add(1);
      Dashboard::Record("serve.client_shed", 0.0);
      return reply_busy();
    }
    // Per-tenant weighted admission (docs/serving.md "tail"): reads
    // compete for per-class inflight budgets — a bulk herd at its
    // share answers ReplyBusy here while gold reads keep flowing.
    if (readlike && !qos::TryAdmit(qc)) return reply_busy();
    // Hedge fast path: answer an anonymous hot-key replica pull AT THE
    // REACTOR — a bounded snapshot read under the shard lock, so a
    // hedged read can win while a straggling apply clogs the actor
    // mailbox.  The admission slot settles synchronously (the reply is
    // queued before we return); per-client inflight never counts it,
    // matching the may_block=false no-settle rule in Enqueue.
    if (m.type == MsgType::RequestReplica &&
        (!mvtpu::configure::Has("replica_serve_reactor") ||
         mvtpu::configure::GetBool("replica_serve_reactor"))) {
      Message reply;
      ops::BuildReplicaReply(m, &reply);
      reply.src = rank_;
      reply.dst = peer;
      latency::StampDequeue(&m);
      latency::StampReply(m, &reply);
      latency::StampSend(&reply);
      qos::Release(qc);
      return Enqueue(c, reply, /*may_block=*/false);
    }
    if (counted) c->inflight.fetch_add(1);
  }
  if (inbound_) inbound_(std::move(m));
  return true;
}

bool EpollNet::DrainWrites(const std::shared_ptr<Conn>& c, bool* empty) {
  constexpr size_t kMaxIov = 64;
  iovec iov[kMaxIov];
  MutexLock lk(c->mu);
  while (!c->wq.empty()) {
    PendingFrame& f = c->wq.front();
    msghdr mh{};
    mh.msg_iov = iov;
    mh.msg_iovlen = f.FillIov(iov, kMaxIov);
    ssize_t w = ::sendmsg(c->fd, &mh, MSG_NOSIGNAL | MSG_DONTWAIT);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        *empty = false;
        return true;  // short write: EPOLLOUT resumes exactly here
      }
      *empty = false;
      return false;
    }
    f.done += w;
    if (f.done < f.total) continue;  // more segments than kMaxIov
    // Frame fully on the wire: only now does the byte ledger count it.
    Dashboard::Record("net.bytes.sent", static_cast<double>(f.total));
    c->wq_bytes -= f.total;
    wq_bytes_total_.fetch_add(-f.total, std::memory_order_relaxed);
    c->wq.pop_front();
    c->can_write.NotifyAll();
  }
  *empty = true;
  return true;
}

void EpollNet::ArmWrite(const std::shared_ptr<Conn>& c) {
  MutexLock lk(c->mu);
  if (c->want_out || c->closed) return;
  c->want_out = true;
  epoll_event ev{};
  ev.events = EPOLLIN | EPOLLOUT;
  ev.data.fd = c->fd;
  ::epoll_ctl(shards_[static_cast<size_t>(c->shard)]->epfd, EPOLL_CTL_MOD,
              c->fd, &ev);
}

void EpollNet::CloseConn(Shard* s, const std::shared_ptr<Conn>& c,
                         const char* why) {
  int peer = c->peer.load();
  Log::Debug("EpollNet: closing connection (peer %d): %s", peer, why);
  ::epoll_ctl(s->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  s->conns.erase(c->fd);
  rx_arena_total_.fetch_add(-static_cast<long long>(c->slab_tracked),
                            std::memory_order_relaxed);
  c->slab_tracked = 0;
  {
    MutexLock lk(c->mu);
    c->closed = true;
    if (!c->wq.empty())
      Log::Error("EpollNet: dropping %zu queued frame(s) to peer %d (%s)",
                 c->wq.size(), peer, why);
    c->wq.clear();
    wq_bytes_total_.fetch_add(-c->wq_bytes, std::memory_order_relaxed);
    c->wq_bytes = 0;
    c->can_write.NotifyAll();
  }
  ::close(c->fd);
  MutexLock lk(conns_mu_);
  if (transport::IsClientRank(peer)) {
    if (client_conns_.erase(peer)) active_clients_.fetch_add(-1);
  } else if (peer >= 0 &&
             peer < static_cast<int>(rank_conns_.size()) &&
             rank_conns_[static_cast<size_t>(peer)] == c) {
    rank_conns_[static_cast<size_t>(peer)] = nullptr;
  }
  for (auto it = all_conns_.begin(); it != all_conns_.end(); ++it)
    if (*it == c) {
      all_conns_.erase(it);
      break;
    }
}

std::shared_ptr<EpollNet::Conn> EpollNet::ConnectToRank(int dst_rank) {
  std::string host;
  int port = 0;
  if (!SplitHostPort(endpoints_[static_cast<size_t>(dst_rank)], &host,
                     &port))
    return nullptr;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                    &res) != 0 ||
      !res)
    return nullptr;
  // Peers start in any order: blocking connect with the same retry
  // budget as TcpNet — only the ESTABLISHED socket goes non-blocking
  // into the reactor.
  int fd = -1;
  int attempts = static_cast<int>(
      std::max<int64_t>(1, connect_retry_ms_ / 100));
  for (int attempt = 0; attempt < attempts; ++attempt) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    // Pre-reactor blocking handshake: this runs on the SENDER's thread
    // (never the reactor); only the established socket enters the event
    // loop, nonblocking.
    if (::connect(fd, res->ai_addr,  // mvlint: MV009-exempt(pre-reactor)
                  res->ai_addrlen) == 0)
      break;
    ::close(fd);
    fd = -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    if (!running_ || stopping_) break;
  }
  ::freeaddrinfo(res);
  if (fd < 0) return nullptr;
  SetNoDelay(fd);
  // Identify before payload: the accept side caps UNIDENTIFIED
  // connections at the small anonymous-client frame bound, so the first
  // frame on a fresh rank connection must be this tiny Hello — after
  // the reactor consumes it, subsequent frames get the rank bound.
  // Still the sender's thread, still the blocking socket (it goes
  // nonblocking into the reactor only below).
  Message hello;
  hello.type = MsgType::Hello;
  hello.src = rank_;
  hello.dst = dst_rank;
  Blob hello_body = hello.Serialize();
  int64_t hello_len = static_cast<int64_t>(hello_body.size());
  std::vector<char> hello_wire(sizeof(hello_len) + hello_body.size());
  std::memcpy(hello_wire.data(), &hello_len, sizeof(hello_len));
  std::memcpy(hello_wire.data() + sizeof(hello_len), hello_body.data(),
              hello_body.size());
  size_t hello_sent = 0;
  while (hello_sent < hello_wire.size()) {
    ssize_t w = ::send(  // mvlint: MV009-exempt(pre-reactor handshake)
        fd, hello_wire.data() + hello_sent, hello_wire.size() - hello_sent,
        MSG_NOSIGNAL);
    if (w <= 0) {
      ::close(fd);
      return nullptr;
    }
    hello_sent += static_cast<size_t>(w);
  }
  if (!SetNonBlocking(fd)) {
    ::close(fd);
    return nullptr;
  }
  auto c = std::make_shared<Conn>();
  c->fd = fd;
  c->peer = dst_rank;
  c->shard = next_shard_.fetch_add(1) % static_cast<int>(shards_.size());
  return c;
}

std::shared_ptr<EpollNet::Conn> EpollNet::ResolveConn(int dst_rank) {
  if (transport::IsClientRank(dst_rank)) {
    MutexLock lk(conns_mu_);
    auto it = client_conns_.find(dst_rank);
    return it == client_conns_.end() ? nullptr : it->second;
  }
  {
    MutexLock lk(conns_mu_);
    auto& slot = rank_conns_[static_cast<size_t>(dst_rank)];
    if (slot) return slot;
  }
  auto fresh = ConnectToRank(dst_rank);
  if (!fresh) return nullptr;
  std::shared_ptr<Conn> winner;
  {
    MutexLock lk(conns_mu_);
    auto& slot = rank_conns_[static_cast<size_t>(dst_rank)];
    if (!slot) {
      slot = fresh;
      all_conns_.push_back(fresh);
    }
    winner = slot;
  }
  if (winner == fresh) {
    Shard* target = shards_[static_cast<size_t>(fresh->shard)].get();
    {
      MutexLock lk(target->mu);
      target->to_register.push_back(fresh);
    }
    WakeShard(target);
  } else {
    ::close(fresh->fd);  // raced: another sender connected first
  }
  return winner;
}

bool EpollNet::Enqueue(const std::shared_ptr<Conn>& c, const Message& msg,
                       bool may_block) {
  // A reply headed back to an anonymous client settles one admission
  // slot — BEFORE any failure exit below, so a reply dying on a full
  // write queue or a just-closed connection still releases it (a leak
  // here would permanently shed the client once leaks eat the whole
  // cap).  Reactor-synthesized busy replies (may_block=false) answer
  // requests that were never counted, so they settle nothing.
  if (may_block && transport::IsClientRank(c->peer.load()) &&
      (msg.type == MsgType::ReplyGet || msg.type == MsgType::ReplyAdd ||
       msg.type == MsgType::ReplyVersion ||
       msg.type == MsgType::ReplyReplica ||
       msg.type == MsgType::ReplyBusy || msg.type == MsgType::ReplyFlush ||
       msg.type == MsgType::ReplyError)) {
    long long now = c->inflight.fetch_add(-1);
    if (now <= 0) c->inflight.fetch_add(1);  // floor at zero
    // A read reply also settles its tenant-class admission slot (adds/
    // flushes were never class-admitted; Release floors per class).
    if (msg.type != MsgType::ReplyAdd && msg.type != MsgType::ReplyFlush) {
      int qc = c->qos_class.load();
      qos::Release(qc < 0 ? 0 : qc);
    }
  }
  const int64_t cap = FlagOr("net_writeq_bytes", 64 << 20);
  const int64_t timeout_ms = FlagOr("io_timeout_ms", 30000);
  {
    MutexLock lk(c->mu);
    if (c->closed) return false;
    // Backpressure: a slow reader fills the bounded queue; the sender
    // waits for drain up to the io deadline instead of ballooning
    // memory — the readiness-model twin of SO_SNDTIMEO.  may_block is
    // false for REACTOR-originated sends (synthesized busy replies):
    // the reactor is the only thread that drains queues, so waiting
    // here would deadlock the shard — a full queue drops the reply
    // instead (the client's rpc deadline covers it).
    if (cap > 0 && c->wq_bytes >= cap) {
      if (!may_block) {
        Dashboard::Record("net.reply_dropped", 0.0);
        return false;
      }
      auto deadline = std::chrono::system_clock::now() +
                      std::chrono::milliseconds(
                          timeout_ms > 0 ? timeout_ms : 30000);
      while (c->wq_bytes >= cap && !c->closed) {
        if (!c->can_write.WaitUntil(c->mu, deadline)) break;
      }
      if (c->closed || c->wq_bytes >= cap) {
        Log::Error("EpollNet: write queue to peer %d full (%lld bytes) "
                   "past the io deadline",
                   c->peer.load(),
                   static_cast<long long>(c->wq_bytes));
        return false;
      }
    }
    c->wq.emplace_back(msg);
    c->wq_bytes += c->wq.back().total;
    wq_bytes_total_.fetch_add(c->wq.back().total,
                              std::memory_order_relaxed);
  }
  Shard* target = shards_[static_cast<size_t>(c->shard)].get();
  {
    MutexLock lk(target->mu);
    target->to_arm.push_back(c);
  }
  WakeShard(target);
  return true;
}

bool EpollNet::SendAttempt(int dst_rank, const Message& msg) {
  // Injected wire failure (chaos suite): consumes a retry attempt just
  // like a real failed write on the blocking engine.
  if (Fault::Enabled() && Fault::FailSendAttempt()) {
    Dashboard::Record("fault.fail_send", 0.0);
    Log::Error("EpollNet: send to rank %d failed (injected)", dst_rank);
    return false;
  }
  std::shared_ptr<Conn> c = ResolveConn(dst_rank);
  if (!c) {
    Log::Error("EpollNet: cannot reach rank %d%s", dst_rank,
               transport::IsClientRank(dst_rank) ? " (client gone)" : "");
    return false;
  }
  return Enqueue(c, msg);
}

bool EpollNet::Send(int dst_rank, const Message& msg) {
  bool is_client = transport::IsClientRank(dst_rank);
  if (!is_client &&
      (dst_rank < 0 || dst_rank >= static_cast<int>(endpoints_.size())))
    return false;
  if (!running_) return false;
  Monitor mon("Net::Send", msg.trace_id);

  bool duplicate = false;
  if (Fault::Enabled()) {
    int64_t delay_ms = 0;
    switch (Fault::OnSend(&delay_ms)) {
      case Fault::Action::kDrop:
        Dashboard::Record("net.dropped", 0.0);
        return true;
      case Fault::Action::kDelay:
        Dashboard::Record("net.delayed", 0.0);
        std::this_thread::sleep_for(std::chrono::milliseconds(delay_ms));
        break;
      case Fault::Action::kDuplicate:
        duplicate = true;
        break;
      case Fault::Action::kNone:
        break;
    }
  }

  const int retries =
      static_cast<int>(std::max<int64_t>(0, FlagOr("send_retries", 2)));
  int64_t backoff_ms = std::max<int64_t>(1, FlagOr("send_backoff_ms", 50));
  for (int attempt = 0; attempt <= retries; ++attempt) {
    if (attempt > 0) {
      Dashboard::Record("net.retries", 0.0);
      std::this_thread::sleep_for(std::chrono::milliseconds(backoff_ms));
      backoff_ms *= 2;
      if (!running_) return false;
    }
    if (SendAttempt(dst_rank, msg)) {
      if (duplicate) {
        Dashboard::Record("net.duplicated", 0.0);
        SendAttempt(dst_rank, msg);
      }
      return true;
    }
  }
  Log::Error("EpollNet: send to rank %d failed after %d attempt(s)",
             dst_rank, retries + 1);
  return false;
}

void EpollNet::SettleClient(int client_rank) {
  // An anonymous client's read was DROPPED server-side (deadline shed /
  // hedge cancel): no reply will route back through Enqueue, so the
  // per-client and per-class slots settle here instead of leaking
  // until the client is permanently shed at cap.
  std::shared_ptr<Conn> c;
  {
    MutexLock lk(conns_mu_);
    auto it = client_conns_.find(client_rank);
    if (it == client_conns_.end()) return;  // client gone: slots died too
    c = it->second;
  }
  long long now = c->inflight.fetch_add(-1);
  if (now <= 0) c->inflight.fetch_add(1);  // floor at zero
  int qc = c->qos_class.load();
  qos::Release(qc < 0 ? 0 : qc);
}

Net::FanInStats EpollNet::FanIn() const {
  FanInStats st;
  st.accepted_total = accepted_total_.load();
  st.active_clients = active_clients_.load();
  st.client_shed = client_shed_.load();
  return st;
}

void EpollNet::Stop() {
  {
    // `stopping_` is the Stop-vs-Stop latch (running_ stays true
    // through the multi-second grace drain below, so testing it alone
    // would let a second caller race the first into thread.join() —
    // UB on the same std::thread — and double-close the epoll fds).
    // `running_` remains the reactor-exit flag.
    MutexLock lk(stop_mu_);
    if (!running_ || stopping_) return;
    stopping_ = true;
  }
  // Graceful drain: give the reactor a bounded window to flush queued
  // frames (a peer's exit/flush message must not die in our queue).
  int64_t grace_ms = std::min<int64_t>(FlagOr("io_timeout_ms", 30000),
                                       5000);
  auto deadline = std::chrono::system_clock::now() +
                  std::chrono::milliseconds(std::max<int64_t>(grace_ms, 1));
  std::vector<std::shared_ptr<Conn>> snapshot;
  {
    MutexLock lk(conns_mu_);
    snapshot = all_conns_;
  }
  for (auto& c : snapshot) {
    MutexLock lk(c->mu);
    while (!c->wq.empty() && !c->closed) {
      if (!c->can_write.WaitUntil(c->mu, deadline)) break;
    }
  }
  running_ = false;
  int lfd = listen_fd_.exchange(-1);
  if (lfd >= 0) ::close(lfd);
  for (auto& s : shards_) WakeShard(s.get());
  for (auto& s : shards_)
    if (s->thread.joinable()) s->thread.join();
  {
    MutexLock lk(conns_mu_);
    for (auto& c : all_conns_) {
      MutexLock clk(c->mu);
      if (!c->closed) {
        c->closed = true;
        ::close(c->fd);
      }
      c->wq.clear();
      c->wq_bytes = 0;
      c->can_write.NotifyAll();
    }
    all_conns_.clear();
    client_conns_.clear();
    rank_conns_.clear();
  }
  wq_bytes_total_.store(0, std::memory_order_relaxed);
  rx_arena_total_.store(0, std::memory_order_relaxed);
  for (auto& s : shards_) {
    ::close(s->epfd);
    ::close(s->wake_fd);
  }
  shards_.clear();
}

// `-net_engine` factory (transport.h): the readiness-model seam.
std::unique_ptr<RankTransport> MakeRankTransport(const std::string& engine) {
  if (engine == "epoll") return std::make_unique<EpollNet>();
  if (engine == "tcp") return std::make_unique<TcpNet>();
  if (engine == "uring") return MakeUringTransport();
  return nullptr;
}

}  // namespace mvtpu
