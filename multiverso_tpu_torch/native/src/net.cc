#include "mvtpu/net.h"

#include <arpa/inet.h>
#include <limits.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstring>
#include <fstream>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/fault.h"
#include "mvtpu/latency.h"
#include "mvtpu/qos.h"
#include "mvtpu/log.h"

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

// Gather-write the whole iovec set (sendmsg with MSG_NOSIGNAL — the
// scatter-gather replacement for the old contiguous WriteAll path).
// Mutates the vector in place to advance past partial writes — callers
// pass a scratch copy.
bool WriteVAll(int fd, std::vector<iovec>* iov) {
  size_t idx = 0;
#ifdef IOV_MAX
  const size_t max_iov = IOV_MAX;
#else
  const size_t max_iov = 1024;
#endif
  while (idx < iov->size()) {
    msghdr mh{};
    mh.msg_iov = iov->data() + idx;
    mh.msg_iovlen = std::min(iov->size() - idx, max_iov);
    ssize_t w = ::sendmsg(fd, &mh, MSG_NOSIGNAL);
    if (w <= 0) return false;
    size_t left = static_cast<size_t>(w);
    while (left > 0 && idx < iov->size()) {
      iovec& v = (*iov)[idx];
      if (left >= v.iov_len) {
        left -= v.iov_len;
        ++idx;
      } else {
        v.iov_base = static_cast<char*>(v.iov_base) + left;
        v.iov_len -= left;
        left = 0;
      }
    }
  }
  return true;
}

bool ReadAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Deadline-bounded ReadAll: a peer that stalls mid-frame (crashed after
// the length prefix, wedged NIC) must not park the reader thread
// forever.  timeout_ms <= 0 keeps the plain blocking read.
bool ReadAllDeadline(int fd, void* buf, size_t n, int64_t timeout_ms) {
  if (timeout_ms <= 0) return ReadAll(fd, buf, n);
  char* p = static_cast<char*>(buf);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (n > 0) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    if (left <= 0) return false;
    pollfd pfd{fd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(std::min<int64_t>(left, 500)));
    if (pr < 0) return false;
    if (pr == 0) continue;
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// Flags may not be registered when TcpNet is driven standalone (tests,
// the registration handshake before Zoo::Start finishes).
int64_t FlagOr(const char* name, int64_t dflt) {
  return mvtpu::configure::Has(name) ? mvtpu::configure::GetInt(name)
                                     : dflt;
}

}  // namespace

std::vector<std::string> TcpNet::ParseMachineFile(const std::string& path) {
  std::vector<std::string> eps;
  std::ifstream in(path);
  if (!in) return eps;
  std::string line;
  while (std::getline(in, line)) {
    // strip whitespace and comments
    auto hash = line.find('#');
    if (hash != std::string::npos) line = line.substr(0, hash);
    size_t b = line.find_first_not_of(" \t\r");
    if (b == std::string::npos) continue;
    size_t e = line.find_last_not_of(" \t\r");
    eps.push_back(line.substr(b, e - b + 1));
  }
  return eps;
}

namespace {
// Transport-wide frame cap (table shard payloads).  The registration
// handshake passes RecvFramed a much tighter bound — its frames are
// tiny, and a garbled/hostile connection must not be able to force a
// huge allocation on the controller.
constexpr int64_t kMaxFrameBytes = int64_t{1} << 40;
}  // namespace

bool TcpNet::SendFramed(int fd, const Message& msg) {
  // Scatter-gather framing: the kernel reads the payload blobs in place
  // — the only bytes assembled host-side are the tiny prefix/header/
  // per-blob-length scratch.  Layout must stay identical to
  // Message::Serialize() (RecvFramed decodes both the same way).
  int64_t frame = msg.WireBytes();
  struct {
    int64_t frame_len;
    WireHeader h;
  } head;
  head.frame_len = frame;
  msg.FillWireHeader(&head.h);
  std::vector<int64_t> lens(msg.data.size());
  std::vector<iovec> iov;
  iov.reserve(2 + 2 * msg.data.size());
  iov.push_back({&head, sizeof(head)});
  // Latency trail (docs/observability.md): rides between the header and
  // the blob prefixes when stamped — WireBytes() already counts it.
  if (msg.has_timing())
    iov.push_back({const_cast<TimingTrail*>(&msg.timing),
                   sizeof(TimingTrail)});
  // Delivery-audit stamp rides after the trail (message.cc Serialize
  // order); WireBytes() already counts it.
  if (msg.has_audit())
    iov.push_back({const_cast<AuditStamp*>(&msg.audit),
                   sizeof(AuditStamp)});
  // QoS/deadline stamp rides after the audit stamp (same order).
  if (msg.has_qos())
    iov.push_back({const_cast<QosStamp*>(&msg.qos), sizeof(QosStamp)});
  for (size_t i = 0; i < msg.data.size(); ++i) {
    lens[i] = static_cast<int64_t>(msg.data[i].size());
    iov.push_back({&lens[i], sizeof(int64_t)});
    if (msg.data[i].size())
      iov.push_back({const_cast<char*>(msg.data[i].data()),
                     msg.data[i].size()});
  }
  return WriteVAll(fd, &iov);
}

bool TcpNet::RecvFramed(int fd, Message* msg, int64_t max_bytes,
                        int64_t body_timeout_ms, int64_t* frame_bytes) {
  if (max_bytes <= 0) max_bytes = kMaxFrameBytes;
  int64_t len = 0;
  // The prefix read may block indefinitely — an idle connection is
  // healthy.  Once a frame STARTED, the rest must arrive within the
  // deadline or the connection is declared dead.
  if (!ReadAll(fd, &len, sizeof(len)) || len <= 0 || len > max_bytes)
    return false;
  Blob buf(static_cast<size_t>(len));
  if (!ReadAllDeadline(fd, buf.data(), buf.size(), body_timeout_ms))
    return false;
  *msg = Message::Deserialize(buf);
  if (frame_bytes) *frame_bytes = len + static_cast<int64_t>(sizeof(len));
  return true;
}

namespace {

// Node-table wire format inside ControlReply: blob0 = int32 assigned
// rank, blob1 = int32 roles[num], blob2 = '\n'-joined endpoints.
Blob PackEndpoints(const std::vector<std::string>& endpoints) {
  std::string joined;
  for (const auto& e : endpoints) {
    joined += e;
    joined += '\n';
  }
  return Blob(joined.data(), joined.size());
}

std::vector<std::string> UnpackEndpoints(const Blob& b) {
  std::vector<std::string> out;
  std::string cur;
  for (size_t i = 0; i < b.size(); ++i) {
    char c = b.data()[i];
    if (c == '\n') {
      out.push_back(cur);
      cur.clear();
    } else {
      cur += c;
    }
  }
  return out;
}

}  // namespace

bool TcpNet::RegisterController(const std::string& ctrl_endpoint,
                                int num_nodes, int my_role,
                                std::vector<std::string>* endpoints,
                                std::vector<int>* roles,
                                int64_t timeout_ms) {
  std::string host;
  int port = 0;
  if (num_nodes < 1 || !SplitHostPort(ctrl_endpoint, &host, &port))
    return false;
  endpoints->assign(num_nodes, "");
  roles->assign(num_nodes, 0);
  (*endpoints)[0] = ctrl_endpoint;
  (*roles)[0] = my_role;
  if (num_nodes == 1) return true;

  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (lfd < 0) return false;
  int one = 1;
  ::setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(lfd, 64) < 0) {
    Log::Error("RegisterController: cannot listen on %s",
               ctrl_endpoint.c_str());
    ::close(lfd);
    return false;
  }
  // Ranks assigned in arrival order, 1..num_nodes-1.  The collection is
  // deadline-bounded (poll on the listener) and each accepted client is
  // read under SO_RCVTIMEO so a silent connection cannot park the
  // single-threaded loop and starve real registrants.
  std::vector<int> fds;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  for (int next = 1; next < num_nodes;) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                    deadline - std::chrono::steady_clock::now())
                    .count();
    if (left <= 0) {
      Log::Error("RegisterController: %d/%d nodes after %lld ms", next - 1,
                 num_nodes - 1, static_cast<long long>(timeout_ms));
      break;
    }
    pollfd pfd{lfd, POLLIN, 0};
    int pr = ::poll(&pfd, 1, static_cast<int>(std::min<int64_t>(left, 500)));
    if (pr < 0) break;
    if (pr == 0) continue;
    int fd = ::accept(lfd, nullptr, nullptr);
    if (fd < 0) break;
    timeval tv{5, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    Message reg;
    if (!RecvFramed(fd, &reg, int64_t{1} << 20) ||
        reg.type != MsgType::ControlRegister ||
        reg.data.size() < 2) {
      ::close(fd);
      continue;
    }
    (*endpoints)[next] = std::string(reg.data[0].data(), reg.data[0].size());
    (*roles)[next] = *reg.data[1].As<int32_t>();
    fds.push_back(fd);
    ++next;
  }
  ::close(lfd);
  if (static_cast<int>(fds.size()) != num_nodes - 1) {
    for (int fd : fds) ::close(fd);
    return false;
  }
  bool ok = true;
  std::vector<int32_t> roles32(roles->begin(), roles->end());
  for (size_t i = 0; i < fds.size(); ++i) {
    Message reply;
    reply.type = MsgType::ControlReply;
    int32_t rank = static_cast<int32_t>(i + 1);
    reply.data.emplace_back(&rank, sizeof(rank));
    reply.data.emplace_back(roles32.data(), roles32.size() * sizeof(int32_t));
    reply.data.push_back(PackEndpoints(*endpoints));
    ok = SendFramed(fds[i], reply) && ok;
    ::close(fds[i]);
  }
  Log::Info("controller: %d nodes registered", num_nodes);
  return ok;
}

bool TcpNet::RegisterWithController(const std::string& ctrl_endpoint,
                                    const std::string& my_endpoint,
                                    int my_role, int64_t retry_ms,
                                    std::vector<std::string>* endpoints,
                                    std::vector<int>* roles, int* my_rank) {
  std::string host;
  int port = 0;
  if (!SplitHostPort(ctrl_endpoint, &host, &port)) return false;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                    &res) != 0 ||
      !res)
    return false;
  int fd = -1;
  int attempts = static_cast<int>(std::max<int64_t>(1, retry_ms / 100));
  for (int a = 0; a < attempts; ++a) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
  }
  ::freeaddrinfo(res);
  if (fd < 0) {
    Log::Error("RegisterWithController: cannot reach %s",
               ctrl_endpoint.c_str());
    return false;
  }
  Message reg;
  reg.type = MsgType::ControlRegister;
  reg.data.emplace_back(my_endpoint.data(), my_endpoint.size());
  int32_t role32 = my_role;
  reg.data.emplace_back(&role32, sizeof(role32));
  Message reply;
  bool ok = SendFramed(fd, reg) &&
            RecvFramed(fd, &reply, int64_t{1} << 20) &&
            reply.type == MsgType::ControlReply && reply.data.size() >= 3;
  if (ok) {
    *my_rank = *reply.data[0].As<int32_t>();
    size_t n = reply.data[1].count<int32_t>();
    roles->assign(reply.data[1].As<int32_t>(),
                  reply.data[1].As<int32_t>() + n);
    *endpoints = UnpackEndpoints(reply.data[2]);
    ok = endpoints->size() == n && *my_rank > 0 &&
         *my_rank < static_cast<int>(n);
    // The assigned slot must be OUR endpoint: a controller bug or a
    // crossed reply would otherwise make this node answer for another
    // rank's address and misroute every message sent to it.
    if (ok && (*endpoints)[*my_rank] != my_endpoint) {
      Log::Error("RegisterWithController: assigned rank %d maps to "
                 "endpoint %s, but this node registered %s",
                 *my_rank, (*endpoints)[*my_rank].c_str(),
                 my_endpoint.c_str());
      ok = false;
    }
  }
  ::close(fd);
  return ok;
}

bool TcpNet::Init(const std::vector<std::string>& endpoints, int rank,
                  InboundFn fn, int64_t connect_retry_ms) {
  endpoints_ = endpoints;
  rank_ = rank;
  inbound_ = std::move(fn);
  connect_retry_ms_ = connect_retry_ms;
  send_fds_.assign(endpoints_.size(), -1);
  send_mus_.clear();
  for (size_t i = 0; i < endpoints_.size(); ++i)
    send_mus_.push_back(std::make_unique<Mutex>());

  std::string host;
  int port = 0;
  if (rank_ < 0 || rank_ >= static_cast<int>(endpoints_.size()) ||
      !SplitHostPort(endpoints_[rank_], &host, &port)) {
    Log::Error("TcpNet: bad rank %d / endpoint list (%zu entries)", rank_,
               endpoints_.size());
    return false;
  }

  listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
  if (listen_fd_ < 0) return false;
  int one = 1;
  ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      ::listen(listen_fd_, 64) < 0) {
    Log::Error("TcpNet: cannot listen on port %d", port);
    ::close(listen_fd_);
    listen_fd_ = -1;
    return false;
  }
  running_ = true;
  accept_thread_ = std::thread([this] { AcceptLoop(); });
  Log::Info("TcpNet: rank %d/%zu listening on :%d", rank_,
            endpoints_.size(), port);
  return true;
}

void TcpNet::AcceptLoop() {
  while (true) {
    int fd = ::accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) return;  // listen_fd_ closed by Stop
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    MutexLock lk(readers_mu_);
    if (!running_) {
      ::close(fd);
      return;
    }
    accepted_fds_.push_back(fd);
    readers_.emplace_back([this, fd] { ReadLoop(fd); });
  }
}

void TcpNet::ReadLoop(int fd) {
  const int64_t body_timeout = FlagOr("io_timeout_ms", 30000);
  while (true) {
    Message m;
    int64_t frame_bytes = 0;
    if (!RecvFramed(fd, &m, 0, body_timeout, &frame_bytes)) {
      ::close(fd);
      return;
    }
    // Wire-byte ledger (docs/wire_compression.md): count = messages,
    // total = bytes (1 unit = 1 byte) — MV_WireStats / the Python
    // net.bytes{dir=recv} bridge read both from this one monitor.
    Dashboard::Record("net.bytes.recv", static_cast<double>(frame_bytes));
    // Latency trail: frame-complete stamp (the reader thread is this
    // engine's "reactor" boundary) — requests only, stamp-if-zero.
    latency::StampRecv(&m);
    // Tail plane: adopt the propagated deadline at the recv boundary.
    qos::AdoptDeadline(&m);
    if (inbound_) inbound_(std::move(m));
  }
}

int TcpNet::ConnectTo(int dst_rank) {
  std::string host;
  int port = 0;
  if (!SplitHostPort(endpoints_[dst_rank], &host, &port)) return -1;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (::getaddrinfo(host.c_str(), std::to_string(port).c_str(), &hints,
                    &res) != 0 ||
      !res)
    return -1;
  // Peers start in any order: retry within the configured budget.
  int fd = -1;
  int attempts = static_cast<int>(std::max<int64_t>(
      1, connect_retry_ms_ / 100));
  for (int attempt = 0; attempt < attempts; ++attempt) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) break;
    if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      // Bounded writes: a peer that stops draining its socket (wedged,
      // SIGSTOPped) turns ::send into a deadline error instead of an
      // indefinite block — the write-side half of the recv deadline.
      int64_t io_ms = FlagOr("io_timeout_ms", 30000);
      if (io_ms > 0) {
        timeval tv{static_cast<time_t>(io_ms / 1000),
                   static_cast<suseconds_t>((io_ms % 1000) * 1000)};
        ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
      }
      break;
    }
    ::close(fd);
    fd = -1;
    std::this_thread::sleep_for(std::chrono::milliseconds(100));
    {
      MutexLock lk(mu_);
      if (!running_) break;
    }
  }
  ::freeaddrinfo(res);
  return fd;
}

bool TcpNet::SendAttempt(int dst_rank, const Message& msg) {
  // Connect OUTSIDE the per-destination send mutex: the retry loop can
  // take seconds, and holding the mutex through it would stall Stop()
  // (which closes fds under the same mutex) and serialize every sender
  // to this rank behind the retries.
  bool need_connect;
  {
    MutexLock lk(*send_mus_[dst_rank]);
    need_connect = send_fds_[dst_rank] < 0;
  }
  if (need_connect) {
    int nfd = ConnectTo(dst_rank);
    MutexLock lk(*send_mus_[dst_rank]);
    if (send_fds_[dst_rank] < 0) {
      send_fds_[dst_rank] = nfd;       // install (may still be -1)
    } else if (nfd >= 0) {
      ::close(nfd);                    // raced: another sender connected
    }
  }
  MutexLock lk(*send_mus_[dst_rank]);
  int fd = send_fds_[dst_rank];
  if (fd < 0) {
    Log::Error("TcpNet: cannot reach rank %d (%s)", dst_rank,
               endpoints_[dst_rank].c_str());
    return false;
  }
  // Injected wire failure (chaos suite): indistinguishable from a real
  // failed write downstream of here — the connection is torn down and
  // the retry loop, if any budget remains, reconnects.
  if (Fault::Enabled() && Fault::FailSendAttempt()) {
    Dashboard::Record("fault.fail_send", 0.0);
    ::close(fd);
    send_fds_[dst_rank] = -1;
    Log::Error("TcpNet: send to rank %d failed (injected)", dst_rank);
    return false;
  }
  if (!SendFramed(fd, msg)) {
    ::close(fd);
    send_fds_[dst_rank] = -1;
    Log::Error("TcpNet: send to rank %d failed", dst_rank);
    return false;
  }
  // Per successful write attempt (retries resend the frame — those
  // bytes really crossed the wire too): count = messages, total = bytes.
  Dashboard::Record("net.bytes.sent",
                    static_cast<double>(msg.WireBytes() +
                                        static_cast<int64_t>(sizeof(int64_t))));
  return true;
}

bool TcpNet::Send(int dst_rank, const Message& msg) {
  if (dst_rank < 0 || dst_rank >= static_cast<int>(endpoints_.size()))
    return false;
  // Wire-send latency (with percentile buckets via MV_DumpMonitors);
  // the span shares the message's trace id, so a merged trace shows the
  // hop that carried a Get between its worker and server spans.
  Monitor mon("Net::Send", msg.trace_id);
  // No Serialize() here: SendAttempt gather-writes the message's blobs
  // in place (header + iovecs), so the old full-payload copy — and the
  // allocation behind it — is gone from the hot path entirely.

  bool duplicate = false;
  if (Fault::Enabled()) {
    int64_t delay_ms = 0;
    switch (Fault::OnSend(&delay_ms)) {
      case Fault::Action::kDrop:
        // The message silently vanishes (a lossy wire): the caller sees
        // success and the reply deadline upstream turns it into -3.
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

  // Bounded retry with exponential backoff: a transient failure (peer
  // restarting, injected fault, send buffer deadline) is retried after
  // reconnecting; a genuinely dead peer exhausts the budget and fails.
  const int retries =
      static_cast<int>(std::max<int64_t>(0, FlagOr("send_retries", 2)));
  int64_t backoff_ms = std::max<int64_t>(1, FlagOr("send_backoff_ms", 50));
  for (int attempt = 0; attempt <= retries; ++attempt) {
    if (attempt > 0) {
      Dashboard::Record("net.retries", 0.0);
      std::this_thread::sleep_for(std::chrono::milliseconds(backoff_ms));
      backoff_ms *= 2;
      MutexLock lk(mu_);
      if (!running_) return false;
    }
    if (SendAttempt(dst_rank, msg)) {
      if (duplicate) {
        // Second copy best-effort: a duplicating wire does not get to
        // also claim a delivery failure.
        Dashboard::Record("net.duplicated", 0.0);
        SendAttempt(dst_rank, msg);
      }
      return true;
    }
  }
  Log::Error("TcpNet: send to rank %d failed after %d attempt(s)",
             dst_rank, retries + 1);
  return false;
}

void TcpNet::Stop() {
  {
    MutexLock lk(mu_);
    if (!running_ && listen_fd_ < 0) return;
    running_ = false;
  }
  if (listen_fd_ >= 0) {
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    listen_fd_ = -1;
  }
  if (accept_thread_.joinable()) accept_thread_.join();
  for (size_t i = 0; i < send_fds_.size(); ++i) {
    MutexLock lk(*send_mus_[i]);
    if (send_fds_[i] >= 0) {
      ::shutdown(send_fds_[i], SHUT_RDWR);
      ::close(send_fds_[i]);
      send_fds_[i] = -1;
    }
  }
  std::vector<std::thread> readers;
  {
    MutexLock lk(readers_mu_);
    // Unblock readers stuck in recv() even if the peer never closes.
    for (int fd : accepted_fds_) ::shutdown(fd, SHUT_RDWR);
    accepted_fds_.clear();
    readers.swap(readers_);
  }
  for (auto& t : readers)
    if (t.joinable()) t.join();
}

}  // namespace mvtpu
