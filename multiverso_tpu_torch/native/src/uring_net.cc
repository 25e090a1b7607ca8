// mvlint: reactor-context — this file runs inside the io_uring
// completion loop.  The completion model never issues a blocking socket
// call from the reactor (the kernel owns the waiting), but the
// pre-reactor connect/Hello handshake below uses the same blocking
// socket discipline as epoll_net.cc and carries the same MV009
// exemptions; and every CQE drain is BATCH-BOUNDED, enforced by mvlint
// rule MV019 (docs/transport.md).
#include "mvtpu/uring_net.h"

#include <arpa/inet.h>
#include <errno.h>
#include <linux/io_uring.h>
#include <linux/time_types.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/syscall.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdlib>
#include <cstring>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/fault.h"
#include "mvtpu/host_arena.h"
#include "mvtpu/latency.h"
#include "mvtpu/log.h"
#include "mvtpu/net.h"
#include "mvtpu/ops.h"
#include "mvtpu/qos.h"
#include "mvtpu/watchdog.h"

namespace mvtpu {

namespace {

// ---- uapi supplements: the container's linux/io_uring.h predates the
// zero-copy send and multishot-accept uapi, but the RUNNING kernel has
// both — define the constants locally and let runtime probing (not the
// compile-time header) decide what is actually used.
constexpr uint8_t kOpSendmsgZc = 48;      // IORING_OP_SENDMSG_ZC (5.19+)
constexpr uint32_t kCqeFNotif = 1u << 3;  // IORING_CQE_F_NOTIF
constexpr uint16_t kAcceptMultishot = 1u << 0;  // IORING_ACCEPT_MULTISHOT
constexpr uint16_t kProbeOpSupported = 1u << 0;  // IO_URING_OP_SUPPORTED

// user_data encoding: [63:56] op kind, [55:32] zero-copy sequence,
// [31:0] connection id.  Conn IDs are monotonic — NEVER the fd — so a
// stale CQE for a torn-down connection can't alias a reused descriptor.
enum : uint8_t {
  kKindWake = 1,
  kKindAccept = 2,
  kKindTimeout = 3,
  kKindRecv = 4,
  kKindSend = 5,
  kKindSendZc = 6,
};

constexpr uint64_t MakeUd(uint8_t kind, uint32_t zc_seq, uint32_t conn_id) {
  return (static_cast<uint64_t>(kind) << 56) |
         (static_cast<uint64_t>(zc_seq & 0xffffffu) << 32) | conn_id;
}

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

void SetNoDelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

bool AddrIsLoopback(const sockaddr* sa) {
  if (sa->sa_family == AF_INET) {
    const auto* in4 = reinterpret_cast<const sockaddr_in*>(sa);
    return (ntohl(in4->sin_addr.s_addr) >> 24) == 127;
  }
  if (sa->sa_family == AF_INET6) {
    const auto* in6 = reinterpret_cast<const sockaddr_in6*>(sa);
    if (IN6_IS_ADDR_LOOPBACK(&in6->sin6_addr)) return true;
    return IN6_IS_ADDR_V4MAPPED(&in6->sin6_addr) &&
           in6->sin6_addr.s6_addr[12] == 127;
  }
  return false;
}

bool PeerIsLoopback(int fd) {
  sockaddr_storage ss;
  socklen_t sl = sizeof(ss);
  if (::getpeername(fd, reinterpret_cast<sockaddr*>(&ss), &sl) != 0)
    return false;
  return AddrIsLoopback(reinterpret_cast<const sockaddr*>(&ss));
}

// Frame caps — identical to EpollNet: rank peers may ship table shards,
// unidentified/anonymous connections are capped small.
constexpr int64_t kMaxRankFrameBytes = int64_t{1} << 40;
constexpr int64_t kMaxClientFrameBytes = int64_t{1} << 26;  // 64 MiB
constexpr size_t kDefaultSlabBytes = 256 << 10;
constexpr size_t kMaxIov = 64;

#if defined(__SANITIZE_THREAD__)
#define MVTPU_TSAN 1
#elif defined(__has_feature)
#if __has_feature(thread_sanitizer)
#define MVTPU_TSAN 1
#endif
#endif

// Same rewind discipline as EpollNet::SlabExclusive: use_count()==1
// plus an acquire fence pairing with the consumer's shared_ptr release;
// compiled out under TSan (which does not model fences) in favor of a
// fresh allocation.
template <typename T>
bool HandleExclusive(const std::shared_ptr<T>& h) {
#ifdef MVTPU_TSAN
  (void)h;
  return false;
#else
  if (h.use_count() != 1) return false;
  std::atomic_thread_fence(std::memory_order_acquire);
  return true;
#endif
}

int UringSetup(unsigned entries, io_uring_params* p) {
  return static_cast<int>(::syscall(__NR_io_uring_setup, entries, p));
}

int UringEnter(int fd, unsigned to_submit, unsigned min_complete,
               unsigned flags) {
  return static_cast<int>(::syscall(__NR_io_uring_enter, fd, to_submit,
                                    min_complete, flags, nullptr,
                                    size_t{0}));
}

int UringRegister(int fd, unsigned opcode, void* arg, unsigned nr_args) {
  return static_cast<int>(
      ::syscall(__NR_io_uring_register, fd, opcode, arg, nr_args));
}

// One-shot opcode support check (its own tiny ring, torn down before
// returning): io_uring reports per-opcode support via REGISTER_PROBE.
bool KernelSupportsOp(uint8_t op, std::string* reason) {
  io_uring_params p{};
  int fd = UringSetup(4, &p);
  if (fd < 0) {
    if (reason)
      *reason = std::string("io_uring_setup: ") + ::strerror(errno);
    return false;
  }
  // io_uring_probe ends in a flexible array member (ops[]) in newer
  // kernel headers, so it cannot be nested in a struct with a member
  // after it: the probe and its 64 op slots share one aligned buffer.
  alignas(io_uring_probe) unsigned char
      pb_buf[sizeof(io_uring_probe) + 64 * sizeof(io_uring_probe_op)];
  std::memset(pb_buf, 0, sizeof(pb_buf));
  auto* probe = reinterpret_cast<io_uring_probe*>(pb_buf);
  int rc = UringRegister(fd, IORING_REGISTER_PROBE, probe, 64);
  ::close(fd);
  if (rc < 0) {
    if (reason)
      *reason = std::string("IORING_REGISTER_PROBE: ") + ::strerror(errno);
    return false;
  }
  if (op >= probe->ops_len ||
      !(probe->ops[op].flags & kProbeOpSupported)) {
    if (reason)
      *reason = "kernel lacks io_uring opcode " + std::to_string(op);
    return false;
  }
  return true;
}

}  // namespace

namespace uring {

bool Probe(std::string* reason) {
  const char* force = ::getenv("MVTPU_URING_FORCE_UNSUPPORTED");
  if (force != nullptr && force[0] == '1') {
    if (reason)
      *reason = "forced unsupported (MVTPU_URING_FORCE_UNSUPPORTED=1)";
    return false;
  }
  // Every opcode the data plane cannot run without.  SENDMSG_ZC is
  // deliberately absent — it degrades to plain SENDMSG per send.
  const uint8_t need[] = {IORING_OP_READ_FIXED, IORING_OP_POLL_ADD,
                          IORING_OP_SENDMSG,    IORING_OP_TIMEOUT,
                          IORING_OP_ACCEPT,     IORING_OP_RECV};
  for (uint8_t op : need)
    if (!KernelSupportsOp(op, reason)) return false;
  return true;
}

}  // namespace uring

// Identical layout + gather semantics to EpollNet::PendingFrame (the
// no-copy send contract); held by shared_ptr here because a frame
// must outlive its queue slot while the kernel references its pages
// (the in-flight `sending` hold and the zero-copy `zc_holds` pins).
struct UringNet::PendingFrame {
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
    if (msg.has_timing()) push(&msg.timing, sizeof(TimingTrail));
    if (msg.has_audit()) push(&msg.audit, sizeof(AuditStamp));
    if (msg.has_qos()) push(&msg.qos, sizeof(QosStamp));
    for (size_t i = 0; i < msg.data.size(); ++i) {
      push(&lens[i], sizeof(int64_t));
      push(msg.data[i].data(), msg.data[i].size());
    }
    return n;
  }
};

// Per-shard pool of fixed receive buffers: `-uring_reg_bufs` HostArena
// buffers registered once with IORING_REGISTER_BUFFERS.  The pool is
// held by shared_ptr from the Shard AND from every outstanding RegSlab,
// so the HostArena caller-holds release only after the engine is down
// AND the last consumer view has died — never under an in-flight DMA.
struct UringNet::RegPool {
  std::vector<char*> bases;
  size_t cap = 0;
  Mutex mu;
  std::vector<int> free_list GUARDED_BY(mu);

  ~RegPool() {
    for (char* b : bases) HostArena::Get()->Release(b);
  }

  int TryTake() {
    MutexLock lk(mu);
    if (free_list.empty()) return -1;
    int idx = free_list.back();
    free_list.pop_back();
    return idx;
  }
  void Put(int idx) {
    MutexLock lk(mu);
    free_list.push_back(idx);
  }
};

// One leased registered buffer.  The conn holds it while frames
// assemble; Blob::Borrow keepalives are aliases of the same handle, so
// the destructor — wherever the LAST view drops — returns the buffer
// index to the pool for the next conn.
struct UringNet::RegSlab {
  char* base;
  size_t cap;
  int index;
  std::shared_ptr<RegPool> pool;

  RegSlab(char* b, size_t c, int i, std::shared_ptr<RegPool> p)
      : base(b), cap(c), index(i), pool(std::move(p)) {}
  ~RegSlab() { pool->Put(index); }

  static std::shared_ptr<RegSlab> Take(const std::shared_ptr<RegPool>& p) {
    int idx = p->TryTake();
    if (idx < 0) return nullptr;
    return std::make_shared<RegSlab>(p->bases[static_cast<size_t>(idx)],
                                     p->cap, idx, p);
  }
};

struct UringNet::Conn {
  int fd = -1;
  int shard = 0;
  uint32_t id = 0;
  bool accepted = false;
  std::atomic<int> peer{-1};

  // ---- read state machine: owning shard's reactor thread only.
  char len_buf[sizeof(int64_t)] = {0};
  size_t len_got = 0;
  int64_t body_len = -1;  // -1: reading the length prefix
  size_t body_got = 0;
  // The frame's home is EITHER a registered slab (zero-copy READ_FIXED
  // + Blob::Borrow) or a heap fallback slab (plain RECV + Blob::View);
  // frame_in_reg says which one the CURRENT frame assembles in.
  std::shared_ptr<RegSlab> reg;
  std::shared_ptr<std::vector<char>> heap;
  bool frame_in_reg = false;
  size_t slab_off = 0;
  size_t slab_used = 0;
  // Heap-slab bytes counted in rx_arena_total_ (registered pool bytes
  // are counted once, engine-wide, at Init).
  size_t heap_tracked = 0;

  // ---- in-flight op accounting: reactor-only.  At most ONE recv and
  // ONE send SQE outstanding per conn; close is two-phase (RetireConn
  // shuts the socket down, FinalizeConn runs at pending_ops == 0).
  bool recv_armed = false;
  bool send_armed = false;
  int pending_ops = 0;
  bool closing = false;
  // The frame BATCH the in-flight send references (survives a wq
  // teardown), plus a pin per un-notified zero-copy send: the kernel
  // reads these pages AFTER sendmsg completes, until the F_NOTIF CQE.
  std::vector<std::shared_ptr<PendingFrame>> sending;
  iovec iov[kMaxIov];
  msghdr mh {};
  uint32_t zc_next = 1;
  std::unordered_map<uint32_t, std::vector<std::shared_ptr<PendingFrame>>>
      zc_holds;
  // Loopback peers never take the SENDMSG_ZC path: MSG_ZEROCOPY over
  // loopback is copied by the kernel anyway and the notification is
  // deferred until the RECEIVER consumes the skb — measured ~2x slower
  // than plain SENDMSG at the 64 KiB frame point, pure overhead.
  bool peer_loopback = false;

  std::atomic<long long> inflight{0};
  std::atomic<int> qos_class{-1};

  Mutex mu;
  CondVar can_write;  // backpressure + drain-on-stop waiters
  // capacity: wq_bytes_total_ gauge — the "capacity" report's
  // net.writeq_bytes; bounded per conn by -net_writeq_bytes.
  std::deque<std::shared_ptr<PendingFrame>> wq GUARDED_BY(mu);
  int64_t wq_bytes GUARDED_BY(mu) = 0;
  bool closed GUARDED_BY(mu) = false;
};

struct UringNet::Shard {
  int idx = 0;
  int ring_fd = -1;
  int wake_fd = -1;
  std::thread thread;

  // ---- mmap'd rings: reactor-owned after setup (Stop touches them
  // only after thread.join()).
  void* sq_ring = nullptr;
  void* cq_ring = nullptr;
  size_t sq_ring_sz = 0;
  size_t cq_ring_sz = 0;
  bool single_mmap = false;
  io_uring_sqe* sqes = nullptr;
  size_t sqes_sz = 0;
  unsigned* sq_head = nullptr;
  unsigned* sq_tail = nullptr;
  unsigned* sq_flags = nullptr;
  unsigned* sq_array = nullptr;
  unsigned sq_mask = 0;
  unsigned sq_entries = 0;
  unsigned sq_tail_local = 0;
  unsigned sq_pending = 0;
  unsigned* cq_head = nullptr;
  unsigned* cq_tail = nullptr;
  io_uring_cqe* cqes = nullptr;
  unsigned cq_mask = 0;
  bool sqpoll = false;

  bool wake_armed = false;
  bool accept_armed = false;
  bool timeout_armed = false;
  // Downgrade latches: old kernels without multishot answer -EINVAL
  // once; after that the op re-arms single-shot.
  bool poll_multishot = true;
  bool accept_multishot = true;
  // Stable across the in-flight TIMEOUT op (the kernel copies it at
  // prep, but keeping it pinned costs nothing and survives uapi drift).
  struct __kernel_timespec tick_ts {};

  std::shared_ptr<RegPool> pool;

  Mutex mu;
  std::vector<std::shared_ptr<Conn>> to_register GUARDED_BY(mu);
  std::vector<std::shared_ptr<Conn>> to_arm GUARDED_BY(mu);
  // conn-id -> conn; reactor-thread-only after registration.
  std::unordered_map<uint32_t, std::shared_ptr<Conn>> conns;
};

UringNet::~UringNet() { Stop(); }

// ---------------------------------------------------------------- ring

bool UringNet::SetupRing(Shard* s, unsigned depth, bool sqpoll) {
  io_uring_params p{};
  p.flags = IORING_SETUP_CQSIZE;
  p.cq_entries = depth * 4;  // CQ headroom: multishot ops fan out CQEs
  if (sqpoll) {
    p.flags |= IORING_SETUP_SQPOLL;
    p.sq_thread_idle = 1000;
  }
  int fd = UringSetup(depth, &p);
  if (fd < 0 && sqpoll) {
    Log::Info("UringNet: SQPOLL setup failed (%s) — plain submission",
              ::strerror(errno));
    std::memset(&p, 0, sizeof(p));
    p.flags = IORING_SETUP_CQSIZE;
    p.cq_entries = depth * 4;
    sqpoll = false;
    fd = UringSetup(depth, &p);
  }
  if (fd < 0) {
    Log::Error("UringNet: io_uring_setup failed: %s", ::strerror(errno));
    return false;
  }
  s->ring_fd = fd;
  s->sqpoll = sqpoll;
  s->sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  s->cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
  s->single_mmap = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
  if (s->single_mmap)
    s->sq_ring_sz = s->cq_ring_sz = std::max(s->sq_ring_sz, s->cq_ring_sz);
  s->sq_ring = ::mmap(nullptr, s->sq_ring_sz, PROT_READ | PROT_WRITE,
                      MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQ_RING);
  if (s->sq_ring == MAP_FAILED) {
    s->sq_ring = nullptr;
    TeardownRing(s);
    return false;
  }
  if (s->single_mmap) {
    s->cq_ring = s->sq_ring;
  } else {
    s->cq_ring = ::mmap(nullptr, s->cq_ring_sz, PROT_READ | PROT_WRITE,
                        MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_CQ_RING);
    if (s->cq_ring == MAP_FAILED) {
      s->cq_ring = nullptr;
      TeardownRing(s);
      return false;
    }
  }
  s->sqes_sz = p.sq_entries * sizeof(io_uring_sqe);
  s->sqes = static_cast<io_uring_sqe*>(
      ::mmap(nullptr, s->sqes_sz, PROT_READ | PROT_WRITE,
             MAP_SHARED | MAP_POPULATE, fd, IORING_OFF_SQES));
  if (s->sqes == MAP_FAILED) {
    s->sqes = nullptr;
    TeardownRing(s);
    return false;
  }
  char* sqr = static_cast<char*>(s->sq_ring);
  char* cqr = static_cast<char*>(s->cq_ring);
  s->sq_head = reinterpret_cast<unsigned*>(sqr + p.sq_off.head);
  s->sq_tail = reinterpret_cast<unsigned*>(sqr + p.sq_off.tail);
  s->sq_flags = reinterpret_cast<unsigned*>(sqr + p.sq_off.flags);
  s->sq_array = reinterpret_cast<unsigned*>(sqr + p.sq_off.array);
  s->sq_mask = *reinterpret_cast<unsigned*>(sqr + p.sq_off.ring_mask);
  s->sq_entries = p.sq_entries;
  s->sq_tail_local = *s->sq_tail;
  s->cq_head = reinterpret_cast<unsigned*>(cqr + p.cq_off.head);
  s->cq_tail = reinterpret_cast<unsigned*>(cqr + p.cq_off.tail);
  s->cq_mask = *reinterpret_cast<unsigned*>(cqr + p.cq_off.ring_mask);
  s->cqes = reinterpret_cast<io_uring_cqe*>(cqr + p.cq_off.cqes);
  return true;
}

void UringNet::TeardownRing(Shard* s) {
  if (s->ring_fd >= 0 && s->pool)
    UringRegister(s->ring_fd, IORING_UNREGISTER_BUFFERS, nullptr, 0);
  if (s->sqes) ::munmap(s->sqes, s->sqes_sz);
  if (s->cq_ring && !s->single_mmap) ::munmap(s->cq_ring, s->cq_ring_sz);
  if (s->sq_ring) ::munmap(s->sq_ring, s->sq_ring_sz);
  s->sqes = nullptr;
  s->sq_ring = nullptr;
  s->cq_ring = nullptr;
  if (s->ring_fd >= 0) ::close(s->ring_fd);
  s->ring_fd = -1;
  if (s->wake_fd >= 0) ::close(s->wake_fd);
  s->wake_fd = -1;
}

void* UringNet::GetSqe(Shard* s) {
  // SQ-full is transient — a flush hands the window back — so the
  // retry here is BOUNDED, not while(true): a wedged SQPOLL thread
  // must surface as a conn error, not a hung reactor.
  for (int tries = 0; tries < 1000; ++tries) {
    unsigned head = __atomic_load_n(s->sq_head, __ATOMIC_ACQUIRE);
    if (s->sq_tail_local - head < s->sq_entries) {
      io_uring_sqe* sqe = &s->sqes[s->sq_tail_local & s->sq_mask];
      std::memset(sqe, 0, sizeof(*sqe));
      s->sq_array[s->sq_tail_local & s->sq_mask] =
          s->sq_tail_local & s->sq_mask;
      ++s->sq_tail_local;
      ++s->sq_pending;
      return sqe;
    }
    SubmitPending(s, /*wait=*/false);
  }
  return nullptr;
}

int UringNet::SubmitPending(Shard* s, bool wait) {
  __atomic_store_n(s->sq_tail, s->sq_tail_local, __ATOMIC_RELEASE);
  unsigned to_submit = s->sq_pending;
  unsigned flags = 0;
  if (s->sqpoll) {
    // The kernel thread consumes the SQ by itself; enter() is only a
    // wakeup (when it idled) or a completion wait.
    s->sq_pending = 0;
    to_submit = 0;
    if (__atomic_load_n(s->sq_flags, __ATOMIC_ACQUIRE) &
        IORING_SQ_NEED_WAKEUP)
      flags |= IORING_ENTER_SQ_WAKEUP;
    if (!wait && flags == 0) return 0;
  }
  if (wait) flags |= IORING_ENTER_GETEVENTS;
  while (true) {
    int r = UringEnter(s->ring_fd, to_submit, wait ? 1u : 0u, flags);
    if (r >= 0) {
      if (!s->sqpoll) s->sq_pending = to_submit - static_cast<unsigned>(r);
      return r;
    }
    if (errno == EINTR) continue;
    if (errno == EAGAIN || errno == EBUSY) {
      // CQ backed up: the caller's drain is what frees it — yield
      // briefly so a wait-mode call doesn't spin hot.
      if (wait)
        std::this_thread::sleep_for(std::chrono::microseconds(100));
      return -1;
    }
    Log::Error("UringNet: io_uring_enter failed: %s", ::strerror(errno));
    return -1;
  }
}

unsigned UringNet::DrainCqes(Shard* s) {
  // Bounded batch (mvlint MV019): cap CQEs consumed per call so a peer
  // that can keep the CQ non-empty cannot starve the running_ check —
  // leftovers satisfy the next cycle's GETEVENTS immediately.
  constexpr unsigned kCqeBatch = 256;
  unsigned head = __atomic_load_n(s->cq_head, __ATOMIC_RELAXED);
  unsigned n = 0;
  while (n < kCqeBatch) {
    unsigned tail = __atomic_load_n(s->cq_tail, __ATOMIC_ACQUIRE);
    if (head == tail) break;
    const io_uring_cqe* cqe = &s->cqes[head & s->cq_mask];
    // Copy out BEFORE advancing head: the kernel owns the entry again
    // the instant the head store lands.
    uint64_t ud = cqe->user_data;
    int32_t res = cqe->res;
    uint32_t fl = cqe->flags;
    ++head;
    __atomic_store_n(s->cq_head, head, __ATOMIC_RELEASE);
    ProcessCqe(s, ud, res, fl);
    ++n;
  }
  return n;
}

// ---------------------------------------------------------- arming ops

void UringNet::ArmWake(Shard* s) {
  if (s->wake_armed || !running_) return;
  auto* sqe = static_cast<io_uring_sqe*>(GetSqe(s));
  if (!sqe) return;  // timeout tick retries
  sqe->opcode = IORING_OP_POLL_ADD;
  sqe->fd = s->wake_fd;
  if (s->poll_multishot) sqe->len = IORING_POLL_ADD_MULTI;
  sqe->poll32_events = POLLIN;
  sqe->user_data = MakeUd(kKindWake, 0, 0);
  s->wake_armed = true;
}

void UringNet::ArmAccept(Shard* s) {
  if (s->accept_armed || !running_) return;
  int lfd = listen_fd_.load();
  if (lfd < 0) return;
  auto* sqe = static_cast<io_uring_sqe*>(GetSqe(s));
  if (!sqe) return;
  sqe->opcode = IORING_OP_ACCEPT;
  sqe->fd = lfd;
  if (s->accept_multishot) sqe->ioprio = kAcceptMultishot;
  sqe->user_data = MakeUd(kKindAccept, 0, 0);
  s->accept_armed = true;
}

void UringNet::ArmTimeout(Shard* s) {
  if (s->timeout_armed || !running_) return;
  auto* sqe = static_cast<io_uring_sqe*>(GetSqe(s));
  if (!sqe) return;
  // The loop's 200 ms heartbeat: epoll_wait's timeout argument,
  // recast as an operation (running_ checks + watchdog cadence + a
  // retry tick for transiently unarmable ops).
  s->tick_ts.tv_sec = 0;
  s->tick_ts.tv_nsec = 200 * 1000 * 1000;
  sqe->opcode = IORING_OP_TIMEOUT;
  sqe->fd = -1;
  sqe->addr = reinterpret_cast<uint64_t>(&s->tick_ts);
  sqe->len = 1;
  sqe->user_data = MakeUd(kKindTimeout, 0, 0);
  s->timeout_armed = true;
}

void UringNet::ArmRecv(Shard* s, const std::shared_ptr<Conn>& c) {
  if (c->recv_armed || c->closing || !running_) return;
  auto* sqe = static_cast<io_uring_sqe*>(GetSqe(s));
  if (!sqe) {
    RetireConn(s, c, "submission queue exhausted");
    return;
  }
  if (c->body_len < 0) {
    // Length prefix — possibly one byte at a time (dribble peers).
    sqe->opcode = IORING_OP_RECV;
    sqe->fd = c->fd;
    sqe->addr = reinterpret_cast<uint64_t>(c->len_buf + c->len_got);
    sqe->len = static_cast<uint32_t>(sizeof(c->len_buf) - c->len_got);
  } else {
    size_t want = static_cast<size_t>(c->body_len) - c->body_got;
    if (c->frame_in_reg) {
      // Zero-copy landing: the kernel writes straight into the
      // registered slab — no per-op pin/unpin, no bounce buffer.
      sqe->opcode = IORING_OP_READ_FIXED;
      sqe->fd = c->fd;
      sqe->addr = reinterpret_cast<uint64_t>(c->reg->base + c->slab_off +
                                             c->body_got);
      sqe->len = static_cast<uint32_t>(want);
      sqe->buf_index = static_cast<uint16_t>(c->reg->index);
    } else {
      sqe->opcode = IORING_OP_RECV;
      sqe->fd = c->fd;
      sqe->addr = reinterpret_cast<uint64_t>(c->heap->data() + c->slab_off +
                                             c->body_got);
      sqe->len = static_cast<uint32_t>(want);
    }
  }
  sqe->user_data = MakeUd(kKindRecv, 0, c->id);
  c->recv_armed = true;
  ++c->pending_ops;
}

void UringNet::PumpSend(Shard* s, const std::shared_ptr<Conn>& c) {
  if (c->send_armed || c->closing || !running_) return;
  // Gather MULTIPLE queued frames into one SENDMSG: TCP is a byte
  // stream and the frame boundaries are the length prefixes already
  // inside the iovecs, so batching is free.  The readiness engine
  // amortizes syscalls by draining its write queue in a sendmsg loop
  // per wake; one ring roundtrip per frame here would halve streaming
  // throughput (measured on the wire_bench put burst).  A frame with
  // more segments than the remaining iov slots is covered PARTIALLY —
  // its tail goes out next pump, exactly like a short write.
  c->sending.clear();
  size_t niov = 0;
  int64_t remaining = 0;
  {
    MutexLock lk(c->mu);
    for (const auto& f : c->wq) {
      if (niov >= kMaxIov) break;
      size_t n = f->FillIov(c->iov + niov, kMaxIov - niov);
      if (n == 0) break;
      niov += n;
      remaining += f->total - f->done;
      c->sending.push_back(f);
    }
  }
  if (c->sending.empty()) return;
  auto* sqe = static_cast<io_uring_sqe*>(GetSqe(s));
  if (!sqe) {
    c->sending.clear();
    RetireConn(s, c, "submission queue exhausted");
    return;
  }
  std::memset(&c->mh, 0, sizeof(c->mh));
  c->mh.msg_iov = c->iov;
  c->mh.msg_iovlen = niov;
  const bool zc = zc_ok_.load(std::memory_order_relaxed) &&
                  !c->peer_loopback && remaining >= zc_bytes_;
  sqe->opcode =
      zc ? kOpSendmsgZc : static_cast<uint8_t>(IORING_OP_SENDMSG);
  sqe->fd = c->fd;
  sqe->addr = reinterpret_cast<uint64_t>(&c->mh);
  sqe->len = 1;
  sqe->msg_flags = MSG_NOSIGNAL;
  uint32_t seq = 0;
  if (zc) {
    seq = c->zc_next++ & 0xffffffu;
    if (seq == 0) seq = c->zc_next++ & 0xffffffu;
    // Pin until F_NOTIF: the kernel references these pages AFTER the
    // send's result CQE — releasing on result would hand a recycled
    // buffer to a DMA still reading it.
    c->zc_holds[seq] = c->sending;
  }
  sqe->user_data = MakeUd(zc ? kKindSendZc : kKindSend, seq, c->id);
  c->send_armed = true;
  c->pending_ops += zc ? 2 : 1;  // result CQE (+ notif CQE when zc)
}

// ------------------------------------------------------------ reactor

void UringNet::WakeShard(Shard* s) {
  uint64_t one = 1;
  ssize_t n = ::write(s->wake_fd, &one, sizeof(one));
  (void)n;  // EAGAIN means a wake is already pending — good enough
}

void UringNet::AdoptHandoffs(Shard* s) {
  std::vector<std::shared_ptr<Conn>> regs, arms;
  {
    MutexLock lk(s->mu);
    regs.swap(s->to_register);
    arms.swap(s->to_arm);
  }
  for (auto& c : regs) {
    s->conns[c->id] = c;
    ArmRecv(s, c);
  }
  for (auto& c : arms) {
    auto it = s->conns.find(c->id);
    if (it == s->conns.end() || it->second != c) continue;
    PumpSend(s, c);
  }
}

void UringNet::ReactorLoop(Shard* s) {
  // Watchdog (docs/observability.md "health plane"): one Bump per
  // drained completion batch, "busy" while a batch is in hand — the
  // same contract the epoll reactor keeps, under a distinct loop name.
  const std::string wd_name = "uring." + std::to_string(s->idx);
  ArmWake(s);
  if (s->idx == 0) ArmAccept(s);
  ArmTimeout(s);
  while (running_) {
    SubmitPending(s, /*wait=*/true);
    if (!running_) break;
    unsigned avail = __atomic_load_n(s->cq_tail, __ATOMIC_ACQUIRE) -
                     __atomic_load_n(s->cq_head, __ATOMIC_RELAXED);
    watchdog::Busy(wd_name, static_cast<int>(avail));
    // Adopt hand-offs first so a just-connected peer's recv arms
    // before we wait again (the eventfd CQE also re-adopts, mirroring
    // the epoll engine's consumed-wake fix).
    AdoptHandoffs(s);
    DrainCqes(s);
    watchdog::Bump(wd_name);
    watchdog::Busy(wd_name, 0);
  }
}

void UringNet::ProcessCqe(Shard* s, uint64_t ud, int32_t res,
                          uint32_t fl) {
  const uint8_t kind = static_cast<uint8_t>(ud >> 56);
  const uint32_t seq = static_cast<uint32_t>((ud >> 32) & 0xffffffu);
  const uint32_t id = static_cast<uint32_t>(ud & 0xffffffffu);
  switch (kind) {
    case kKindWake: {
      if (!(fl & IORING_CQE_F_MORE)) s->wake_armed = false;
      if (res == -EINVAL && s->poll_multishot) {
        s->poll_multishot = false;  // old kernel: single-shot poll
        ArmWake(s);
        return;
      }
      uint64_t junk;
      while (::read(s->wake_fd, &junk, sizeof(junk)) > 0) {
      }
      // Adopt AFTER draining the eventfd — a sender enqueueing between
      // the loop-top adoption and this drain just had its wake
      // consumed (the epoll engine's lost-wakeup fix, verbatim).
      AdoptHandoffs(s);
      ArmWake(s);
      return;
    }
    case kKindAccept: {
      if (!(fl & IORING_CQE_F_MORE)) s->accept_armed = false;
      if (res >= 0) {
        OnAccepted(s, res);
      } else if (res == -EINVAL && s->accept_multishot) {
        s->accept_multishot = false;  // old kernel: re-armed single-shot
      } else if (res != -EAGAIN && res != -EINTR &&
                 res != -ECONNABORTED) {
        return;  // listen socket gone (Stop) — do not re-arm
      }
      ArmAccept(s);
      return;
    }
    case kKindTimeout: {
      s->timeout_armed = false;
      AdoptHandoffs(s);
      // Retry tick for ops a transiently-full SQ left unarmed.
      ArmWake(s);
      if (s->idx == 0) ArmAccept(s);
      ArmTimeout(s);
      return;
    }
    default:
      break;
  }
  auto it = s->conns.find(id);
  if (it == s->conns.end()) return;  // conn finalized earlier
  std::shared_ptr<Conn> c = it->second;
  switch (kind) {
    case kKindRecv:
      OnRecv(s, c, res);
      break;
    case kKindSend:
      OnSent(s, c, res, fl, 0, /*zc=*/false);
      break;
    case kKindSendZc:
      OnSent(s, c, res, fl, seq, /*zc=*/true);
      break;
    default:
      break;
  }
}

void UringNet::OnAccepted(Shard* s, int fd) {
  SetNoDelay(fd);
  auto c = std::make_shared<Conn>();
  c->fd = fd;
  c->peer_loopback = PeerIsLoopback(fd);
  c->accepted = true;
  c->id = next_conn_id_.fetch_add(1);
  c->shard = next_shard_.fetch_add(1) % static_cast<int>(shards_.size());
  {
    MutexLock lk(conns_mu_);
    all_conns_.push_back(c);
  }
  Shard* target = shards_[static_cast<size_t>(c->shard)].get();
  if (target == s) {
    s->conns[c->id] = c;
    ArmRecv(s, c);
  } else {
    {
      MutexLock lk(target->mu);
      target->to_register.push_back(c);
    }
    WakeShard(target);
  }
}

void UringNet::PlaceFrame(Shard* s, const std::shared_ptr<Conn>& c,
                          size_t need) {
  const size_t slab_bytes = static_cast<size_t>(
      FlagOr("net_arena_bytes", static_cast<int64_t>(kDefaultSlabBytes)));
  // 8-ALIGNED packing, same rationale as the epoll arena: the previous
  // frame may still be read through views while the next lands.
  c->slab_used = (c->slab_used + 7) & ~size_t{7};
  if (c->frame_in_reg && c->reg) {
    if (HandleExclusive(c->reg)) {
      if (need <= c->reg->cap) {
        c->slab_used = 0;  // rewind: nothing references the slab
        return;
      }
    } else if (c->slab_used + need <= c->reg->cap) {
      return;  // append into leftover registered space
    }
    // Registered slabs have a FIXED capacity — a frame that doesn't
    // fit moves the conn to a new home; the index returns to the pool
    // when the last view dies.
    c->reg.reset();
  } else if (!c->frame_in_reg && c->heap) {
    if (HandleExclusive(c->heap)) {
      if (c->heap->size() < need)
        c->heap->resize(std::max(need, slab_bytes));
      c->slab_used = 0;
      size_t sz = c->heap->size();
      if (sz != c->heap_tracked) {
        rx_arena_total_.fetch_add(static_cast<long long>(sz) -
                                      static_cast<long long>(c->heap_tracked),
                                  std::memory_order_relaxed);
        c->heap_tracked = sz;
      }
      return;
    }
    // Addition, never subtraction (the epoll engine's underflow
    // lesson): aligned slab_used can EXCEED size() after an exact fit.
    if (c->heap->size() >= c->slab_used + need) return;
  }
  // Fresh home: prefer a registered slab — zero-copy receive — and
  // fall back to heap when the pool is dry or the frame outgrows it.
  if (s->pool) {
    auto reg = RegSlab::Take(s->pool);
    if (reg && need <= reg->cap) {
      rx_arena_total_.fetch_add(-static_cast<long long>(c->heap_tracked),
                                std::memory_order_relaxed);
      c->heap_tracked = 0;
      c->heap.reset();
      c->reg = std::move(reg);
      c->frame_in_reg = true;
      c->slab_used = 0;
      return;
    }
    // An undersized lease bounces straight back to the pool here
    // (RegSlab destructor) — no conn ever holds a slab it can't use.
  }
  c->reg.reset();
  c->frame_in_reg = false;
  c->heap =
      std::make_shared<std::vector<char>>(std::max(need, slab_bytes));
  c->slab_used = 0;
  size_t sz = c->heap->size();
  rx_arena_total_.fetch_add(static_cast<long long>(sz) -
                                static_cast<long long>(c->heap_tracked),
                            std::memory_order_relaxed);
  c->heap_tracked = sz;
}

void UringNet::OnRecv(Shard* s, const std::shared_ptr<Conn>& c,
                      int32_t res) {
  c->recv_armed = false;
  --c->pending_ops;
  if (c->closing) {
    if (c->pending_ops == 0) FinalizeConn(s, c);
    return;
  }
  if (res == 0 || (res < 0 && res != -EAGAIN && res != -EINTR)) {
    RetireConn(s, c,
               res == 0
                   ? (c->body_len < 0 ? "peer closed" : "peer closed mid-frame")
                   : "read error");
    return;
  }
  if (res < 0) {  // -EAGAIN/-EINTR: just re-arm
    ArmRecv(s, c);
    return;
  }
  if (c->body_len < 0) {
    c->len_got += static_cast<size_t>(res);
    if (c->len_got == sizeof(c->len_buf)) {
      int64_t len;
      std::memcpy(&len, c->len_buf, sizeof(len));
      // PER FRAME cap selection, exactly like the epoll engine: the
      // Hello may identify the conn mid-stream and the very next
      // frame must already enjoy the rank bound.
      const int64_t max_frame =
          (c->accepted && c->peer.load() < 0) ||
                  transport::IsClientRank(c->peer.load())
              ? kMaxClientFrameBytes
              : kMaxRankFrameBytes;
      if (len <= 0 || len > max_frame) {
        RetireConn(s, c, "bad frame length");
        return;
      }
      PlaceFrame(s, c, static_cast<size_t>(len));
      c->slab_off = c->slab_used;
      c->body_len = len;
      c->body_got = 0;
      c->len_got = 0;
    }
  } else {
    c->body_got += static_cast<size_t>(res);
    if (c->body_got == static_cast<size_t>(c->body_len)) {
      if (!FinishFrame(s, c)) {
        RetireConn(s, c, "malformed frame");
        return;
      }
    }
  }
  ArmRecv(s, c);
}

void UringNet::OnSent(Shard* s, const std::shared_ptr<Conn>& c,
                      int32_t res, uint32_t fl, uint32_t seq, bool zc) {
  if (zc && (fl & kCqeFNotif)) {
    // The kernel dropped its last page reference for this send: the
    // frame (and the arena/table buffers under its iovecs) may now be
    // recycled.
    c->zc_holds.erase(seq);
    --c->pending_ops;
    if (c->closing && c->pending_ops == 0) FinalizeConn(s, c);
    return;
  }
  c->send_armed = false;
  --c->pending_ops;
  std::vector<std::shared_ptr<PendingFrame>> batch = std::move(c->sending);
  c->sending.clear();
  if (zc && !(fl & IORING_CQE_F_MORE)) {
    // No notif will follow (errored send): release the pin here.
    c->zc_holds.erase(seq);
    --c->pending_ops;
  }
  if (c->closing) {
    if (c->pending_ops == 0) FinalizeConn(s, c);
    return;
  }
  if (res < 0) {
    if (zc && (res == -EINVAL || res == -EOPNOTSUPP)) {
      // Engine-wide degradation, no data loss: the frame is still at
      // the queue head and resubmits as a plain SENDMSG.
      if (zc_ok_.exchange(false))
        Log::Info("UringNet: kernel rejected SENDMSG_ZC (%s) — "
                  "falling back to copying sends",
                  ::strerror(-res));
      PumpSend(s, c);
      return;
    }
    if (res == -EAGAIN || res == -EINTR) {
      PumpSend(s, c);
      return;
    }
    RetireConn(s, c, "write error");
    return;
  }
  {
    // Distribute the written bytes across the batch IN ORDER — the
    // iovecs were laid out front-to-back, so a short write leaves a
    // fully-sent prefix, one partial frame, and untouched tails that
    // all stay queued for the next pump.
    MutexLock lk(c->mu);
    int64_t left = res;
    for (const auto& f : batch) {
      if (left <= 0) break;
      const int64_t take = std::min<int64_t>(left, f->total - f->done);
      f->done += take;
      left -= take;
      if (f->done >= f->total) {
        Dashboard::Record("net.bytes.sent", static_cast<double>(f->total));
        if (!c->wq.empty() && c->wq.front() == f) {
          c->wq_bytes -= f->total;
          wq_bytes_total_.fetch_add(-f->total, std::memory_order_relaxed);
          c->wq.pop_front();
        }
      }
    }
    c->can_write.NotifyAll();
  }
  PumpSend(s, c);
}

bool UringNet::FinishFrame(Shard* s, const std::shared_ptr<Conn>& c) {
  size_t len = static_cast<size_t>(c->body_len);
  Dashboard::Record(
      "net.bytes.recv",
      static_cast<double>(c->body_len +
                          static_cast<int64_t>(sizeof(int64_t))));
  Message m;
  bool ok;
  if (c->frame_in_reg) {
    // Zero-copy decode over registered memory: blobs BORROW the slab
    // bytes, the keepalive is the RegSlab lease itself — the buffer
    // index returns to the pool when the last consumer drops.
    ok = Message::DeserializeBorrow(c->reg->base + c->slab_off, c->slab_off,
                                    len, std::shared_ptr<void>(c->reg), &m);
  } else {
    ok = Message::DeserializeView(c->heap, c->slab_off, len, &m);
  }
  c->slab_used = c->slab_off + len;
  c->body_len = -1;
  c->body_got = 0;
  if (!ok) return false;
  latency::StampRecv(&m);
  qos::AdoptDeadline(&m);

  // From here on the semantics are EpollNet::FinishFrame verbatim —
  // Hello identify, anonymous pseudo-ranks, reactor-answered cancel/
  // ops/busy, per-client + per-tenant admission (docs/transport.md).
  int peer = c->peer.load();
  if (c->accepted && peer < 0) {
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
  if (m.type == MsgType::Hello) return true;
  if (m.type == MsgType::RequestCancel) {
    qos::NoteCancel(transport::IsClientRank(peer) ? peer : m.src,
                    m.msg_id);
    Dashboard::Record("serve.hedge.cancel_noted", 0.0);
    return true;
  }
  if (m.type == MsgType::OpsQuery) {
    if (transport::IsClientRank(peer)) m.src = peer;
    if (m.version != 1) {
      Message reply;
      ops::BuildReply(m, &reply);
      reply.src = rank_;
      reply.dst = m.src;
      latency::StampDequeue(&m);
      latency::StampReply(m, &reply);
      latency::StampSend(&reply);
      return Enqueue(c, reply, /*may_block=*/false);
    }
    if (inbound_) inbound_(std::move(m));
    return true;
  }
  if (transport::IsClientRank(peer)) {
    m.src = peer;
    if (m.has_qos()) c->qos_class.store(m.qos.klass);
    int qc = c->qos_class.load();
    if (qc < 0) qc = 0;
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
      return Enqueue(c, busy, /*may_block=*/false);
    };
    if (readlike && qos::ShedExpired(m)) return true;
    int64_t cap = FlagOr("client_inflight_max", 64);
    if (cap > 0 && readlike && c->inflight.load() >= cap) {
      client_shed_.fetch_add(1);
      Dashboard::Record("serve.client_shed", 0.0);
      return reply_busy();
    }
    if (readlike && !qos::TryAdmit(qc)) return reply_busy();
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
  (void)s;
  if (inbound_) inbound_(std::move(m));
  return true;
}

void UringNet::RetireConn(Shard* s, const std::shared_ptr<Conn>& c,
                          const char* why) {
  if (c->closing) return;
  c->closing = true;
  int peer = c->peer.load();
  Log::Debug("UringNet: closing connection (peer %d): %s", peer, why);
  // Force the kernel's in-flight recv/send on this socket to complete
  // (0 / ECONNRESET) without touching the submission queue; the fd
  // itself closes in FinalizeConn once the last CQE lands — closing it
  // now could let a reused descriptor meet a stale op.
  ::shutdown(c->fd, SHUT_RDWR);
  rx_arena_total_.fetch_add(-static_cast<long long>(c->heap_tracked),
                            std::memory_order_relaxed);
  c->heap_tracked = 0;
  {
    MutexLock lk(c->mu);
    c->closed = true;
    if (!c->wq.empty())
      Log::Error("UringNet: dropping %zu queued frame(s) to peer %d (%s)",
                 c->wq.size(), peer, why);
    c->wq.clear();
    wq_bytes_total_.fetch_add(-c->wq_bytes, std::memory_order_relaxed);
    c->wq_bytes = 0;
    c->can_write.NotifyAll();
  }
  {
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
  if (c->pending_ops == 0) FinalizeConn(s, c);
}

void UringNet::FinalizeConn(Shard* s, const std::shared_ptr<Conn>& c) {
  ::close(c->fd);
  c->sending.clear();
  c->zc_holds.clear();
  c->reg.reset();
  c->heap.reset();
  s->conns.erase(c->id);
}

// ------------------------------------------------------------- control

bool UringNet::Init(const std::vector<std::string>& endpoints, int rank,
                    InboundFn fn, int64_t connect_retry_ms) {
  std::string why;
  if (!uring::Probe(&why)) {
    // The zoo probes before constructing us; this guards direct users.
    Log::Error("UringNet: io_uring unavailable: %s", why.c_str());
    return false;
  }
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
    Log::Error("UringNet: bad rank %d / endpoint list (%zu entries)",
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
      ::listen(lfd, 1024) < 0) {
    Log::Error("UringNet: cannot listen on port %d", port);
    ::close(lfd);
    return false;
  }
  listen_fd_ = lfd;

  const unsigned depth = static_cast<unsigned>(std::min<int64_t>(
      4096, std::max<int64_t>(8, FlagOr("uring_depth", 256))));
  const bool sqpoll = mvtpu::configure::Has("uring_sqpoll") &&
                      mvtpu::configure::GetBool("uring_sqpoll");
  const int64_t reg_bufs = std::min<int64_t>(
      1024, std::max<int64_t>(0, FlagOr("uring_reg_bufs", 16)));
  zc_bytes_ = FlagOr("uring_zc_bytes", 64 << 10);
  zc_ok_ = zc_bytes_ >= 0 && KernelSupportsOp(kOpSendmsgZc, nullptr);
  const size_t slab_bytes = std::max<size_t>(
      4096, static_cast<size_t>(FlagOr(
                "net_arena_bytes", static_cast<int64_t>(kDefaultSlabBytes))));

  int nshards = static_cast<int>(
      std::min<int64_t>(16, std::max<int64_t>(1, FlagOr("net_threads", 1))));
  running_ = true;
  stopping_ = false;
  // Two passes, like the epoll engine: every shard exists before any
  // reactor thread runs (round-robin placement reads shards_.size()).
  for (int i = 0; i < nshards; ++i) {
    auto s = std::make_unique<Shard>();
    s->idx = i;
    s->wake_fd = ::eventfd(0, EFD_NONBLOCK);
    if (s->wake_fd < 0 || !SetupRing(s.get(), depth, sqpoll)) {
      Log::Error("UringNet: shard %d setup failed", i);
      running_ = false;
      TeardownRing(s.get());
      ::close(lfd);
      listen_fd_ = -1;
      for (auto& sh : shards_) TeardownRing(sh.get());
      shards_.clear();
      return false;
    }
    // Registered receive pool: best-effort — a failed registration
    // (RLIMIT_MEMLOCK, exhausted arena) leaves the shard on the heap
    // fallback path, never broken.
    if (reg_bufs > 0) {
      auto pool = std::make_shared<RegPool>();
      pool->cap = slab_bytes;
      std::vector<iovec> iovs;
      for (int64_t b = 0; b < reg_bufs; ++b) {
        void* base = HostArena::Get()->Acquire(slab_bytes);
        if (base == nullptr) break;
        pool->bases.push_back(static_cast<char*>(base));
        iovs.push_back({base, slab_bytes});
      }
      if (!iovs.empty() &&
          UringRegister(s->ring_fd, IORING_REGISTER_BUFFERS, iovs.data(),
                        static_cast<unsigned>(iovs.size())) == 0) {
        {
          MutexLock lk(pool->mu);
          for (size_t b = 0; b < iovs.size(); ++b)
            pool->free_list.push_back(static_cast<int>(b));
        }
        s->pool = pool;
        rx_arena_total_.fetch_add(
            static_cast<long long>(iovs.size() * slab_bytes),
            std::memory_order_relaxed);
      } else {
        Log::Info("UringNet: shard %d running without registered buffers "
                  "(%s)",
                  i, iovs.empty() ? "arena dry" : ::strerror(errno));
      }
    }
    shards_.push_back(std::move(s));
  }
  for (auto& s : shards_) {
    Shard* raw = s.get();
    s->thread = std::thread([this, raw] { ReactorLoop(raw); });
  }
  Log::Info("UringNet: rank %d/%zu listening on :%d (%d shard%s, depth %u,"
            "%s%s %lld reg buf%s/shard)",
            rank_, endpoints_.size(), port, nshards,
            nshards == 1 ? "" : "s", depth,
            shards_[0]->sqpoll ? " sqpoll," : "",
            zc_ok_.load() ? " zc," : "",
            static_cast<long long>(reg_bufs), reg_bufs == 1 ? "" : "s");
  return true;
}

std::shared_ptr<UringNet::Conn> UringNet::ConnectToRank(int dst_rank) {
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
  // budget as TcpNet/EpollNet — the socket stays in blocking mode even
  // afterwards (the completion model needs no O_NONBLOCK; io_uring
  // parks the op internally).
  int fd = -1;
  int attempts = static_cast<int>(
      std::max<int64_t>(1, connect_retry_ms_ / 100));
  for (int attempt = 0; attempt < attempts; ++attempt) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    // Pre-reactor blocking handshake on the SENDER's thread.
    if (::connect(fd, res->ai_addr,  // mvlint: MV009-exempt(pre-reactor)
                  res->ai_addrlen) == 0)
      break;
    ::close(fd);
    fd = -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    if (!running_ || stopping_ || transport::ConnectAbandoned()) break;
  }
  ::freeaddrinfo(res);
  if (fd < 0) return nullptr;
  SetNoDelay(fd);
  // Identify before payload: tiny Hello first, same as the epoll
  // engine — the accept side caps unidentified conns small.
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
  auto c = std::make_shared<Conn>();
  c->fd = fd;
  c->peer_loopback = PeerIsLoopback(fd);
  c->peer = dst_rank;
  c->id = next_conn_id_.fetch_add(1);
  c->shard = next_shard_.fetch_add(1) % static_cast<int>(shards_.size());
  return c;
}

std::shared_ptr<UringNet::Conn> UringNet::ResolveConn(int dst_rank) {
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

bool UringNet::Enqueue(const std::shared_ptr<Conn>& c, const Message& msg,
                       bool may_block) {
  // Admission settle-before-failure, verbatim from EpollNet::Enqueue:
  // a reply dying on a full queue still releases the client's slot.
  if (may_block && transport::IsClientRank(c->peer.load()) &&
      (msg.type == MsgType::ReplyGet || msg.type == MsgType::ReplyAdd ||
       msg.type == MsgType::ReplyVersion ||
       msg.type == MsgType::ReplyReplica ||
       msg.type == MsgType::ReplyBusy || msg.type == MsgType::ReplyFlush ||
       msg.type == MsgType::ReplyError)) {
    long long now = c->inflight.fetch_add(-1);
    if (now <= 0) c->inflight.fetch_add(1);  // floor at zero
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
        Log::Error("UringNet: write queue to peer %d full (%lld bytes) "
                   "past the io deadline",
                   c->peer.load(),
                   static_cast<long long>(c->wq_bytes));
        return false;
      }
    }
    auto pf = std::make_shared<PendingFrame>(msg);
    c->wq_bytes += pf->total;
    wq_bytes_total_.fetch_add(pf->total, std::memory_order_relaxed);
    c->wq.push_back(std::move(pf));
  }
  Shard* target = shards_[static_cast<size_t>(c->shard)].get();
  // Wake coalescing: a non-empty handoff list means an earlier enqueue
  // already signalled the eventfd and the reactor has not adopted yet —
  // the push and the reactor's swap are serialized by the shard mutex,
  // so that pending wake covers this entry too.  Under a send burst
  // this drops the per-frame eventfd write syscall (one core: syscalls
  // ARE the budget); a wake is only ever skipped when one is provably
  // still in flight, never lost.
  bool need_wake;
  {
    MutexLock lk(target->mu);
    need_wake = target->to_arm.empty();
    target->to_arm.push_back(c);
  }
  if (need_wake) WakeShard(target);
  return true;
}

bool UringNet::SendAttempt(int dst_rank, const Message& msg) {
  if (Fault::Enabled() && Fault::FailSendAttempt()) {
    Dashboard::Record("fault.fail_send", 0.0);
    Log::Error("UringNet: send to rank %d failed (injected)", dst_rank);
    return false;
  }
  std::shared_ptr<Conn> c = ResolveConn(dst_rank);
  if (!c) {
    Log::Error("UringNet: cannot reach rank %d%s", dst_rank,
               transport::IsClientRank(dst_rank) ? " (client gone)" : "");
    return false;
  }
  return Enqueue(c, msg);
}

bool UringNet::Send(int dst_rank, const Message& msg) {
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
      if (!running_ || transport::ConnectAbandoned()) return false;
    }
    if (SendAttempt(dst_rank, msg)) {
      if (duplicate) {
        Dashboard::Record("net.duplicated", 0.0);
        SendAttempt(dst_rank, msg);
      }
      return true;
    }
  }
  Log::Error("UringNet: send to rank %d failed after %d attempt(s)",
             dst_rank, retries + 1);
  return false;
}

void UringNet::SettleClient(int client_rank) {
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

Net::FanInStats UringNet::FanIn() const {
  FanInStats st;
  st.accepted_total = accepted_total_.load();
  st.active_clients = active_clients_.load();
  st.client_shed = client_shed_.load();
  return st;
}

void UringNet::Stop() {
  {
    // Same Stop-vs-Stop latch as the epoll engine.
    MutexLock lk(stop_mu_);
    if (!running_ || stopping_) return;
    stopping_ = true;
  }
  // Graceful drain: bounded window for queued frames to flush.
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
  // Reactor threads are gone: this thread owns every shard.  Quiesce
  // the kernel's in-flight socket ops BEFORE releasing the memory they
  // write into: shutdown forces each recv/send to complete, and the
  // bounded reap below consumes the completions (FinalizeConn erases
  // each conn at pending_ops == 0).
  for (auto& s : shards_) {
    for (auto& kv : s->conns) {
      auto& c = kv.second;
      if (c->closing) continue;
      c->closing = true;
      ::shutdown(c->fd, SHUT_RDWR);
      rx_arena_total_.fetch_add(-static_cast<long long>(c->heap_tracked),
                                std::memory_order_relaxed);
      c->heap_tracked = 0;
      MutexLock lk(c->mu);
      c->closed = true;
      c->wq.clear();
      wq_bytes_total_.fetch_add(-c->wq_bytes, std::memory_order_relaxed);
      c->wq_bytes = 0;
      c->can_write.NotifyAll();
    }
    auto reap_deadline = std::chrono::steady_clock::now() +
                         std::chrono::milliseconds(500);
    while (!s->conns.empty() &&
           std::chrono::steady_clock::now() < reap_deadline) {
      SubmitPending(s.get(), /*wait=*/false);
      if (DrainCqes(s.get()) == 0 && !s->conns.empty())
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
      // Finalize any conn whose last CQE already landed earlier.
      for (auto it = s->conns.begin(); it != s->conns.end();) {
        auto c = it->second;
        ++it;
        if (c->pending_ops == 0) FinalizeConn(s.get(), c);
      }
    }
    if (!s->conns.empty()) {
      // Safety valve: ops the kernel never completed within the reap
      // window keep their buffers pinned forever rather than freed
      // under a possible late DMA (HostArena never unmaps, so even the
      // pool path cannot fault — this guards the heap slabs).
      Log::Error("UringNet: %zu connection(s) with in-flight kernel ops "
                 "at teardown — retaining their buffers",
                 s->conns.size());
      static Mutex retain_mu;
      static std::vector<std::shared_ptr<void>>* retained =
          new std::vector<std::shared_ptr<void>>();
      MutexLock lk(retain_mu);
      for (auto& kv : s->conns) {
        ::close(kv.second->fd);
        retained->push_back(kv.second);
      }
      if (s->pool) retained->push_back(s->pool);
      s->conns.clear();
    }
    TeardownRing(s.get());
  }
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
  shards_.clear();
}

std::unique_ptr<RankTransport> MakeUringTransport() {
  return std::make_unique<UringNet>();
}

}  // namespace mvtpu
