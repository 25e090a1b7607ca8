#include "mvtpu/latency.h"

#include <algorithm>
#include <atomic>
#include <chrono>
#include <map>
#include <sstream>

#include "mvtpu/dashboard.h"
#include "mvtpu/mutex.h"

namespace mvtpu {
namespace latency {

namespace {

std::atomic<bool> g_armed{true};

bool IsReplyType(MsgType t) {
  switch (t) {
    case MsgType::ReplyGet:
    case MsgType::ReplyAdd:
    case MsgType::ReplyError:
    case MsgType::ReplyFlush:
    case MsgType::ReplyVersion:
    case MsgType::ReplyBusy:
    case MsgType::ReplyReplica:
    case MsgType::OpsReply:
      return true;
    default:
      return false;
  }
}

// Per-peer clock filter: a bounded window of (rtt, offset) samples from
// timed round trips; the minimum-RTT sample wins (NTP's clock filter —
// queueing delay inflates RTT and, asymmetrically, offset error).
constexpr int kWindow = 8;

struct PeerClock {
  int64_t rtt[kWindow];
  int64_t off[kWindow];
  int next = 0;
  long long samples = 0;
};

Mutex g_mu;
std::map<int, PeerClock> g_peers GUARDED_BY(g_mu);

void UpdateOffset(int rank, int64_t offset_ns, int64_t rtt_ns) {
  MutexLock lk(g_mu);
  PeerClock& pc = g_peers[rank];
  int slot = pc.next;
  pc.rtt[slot] = rtt_ns;
  pc.off[slot] = offset_ns;
  pc.next = (pc.next + 1) % kWindow;
  ++pc.samples;
}

bool BestLocked(const PeerClock& pc, int64_t* offset_ns,
                int64_t* rtt_ns) REQUIRES(g_mu) {
  if (pc.samples == 0) return false;
  int n = static_cast<int>(std::min<long long>(pc.samples, kWindow));
  int best = 0;
  for (int i = 1; i < n; ++i)
    if (pc.rtt[i] < pc.rtt[best]) best = i;
  if (offset_ns) *offset_ns = pc.off[best];
  if (rtt_ns) *rtt_ns = pc.rtt[best];
  return true;
}

void RecordStage(const char* name, int64_t dur_ns) {
  // Clamp at zero: a residual offset error can push a cross-clock stage
  // a few microseconds negative; a negative latency is never data.
  Dashboard::Record(name,
                    static_cast<double>(std::max<int64_t>(dur_ns, 0)) * 1e-9);
}

}  // namespace

int64_t NowNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void Arm(bool on) { g_armed.store(on, std::memory_order_relaxed); }
bool Armed() { return g_armed.load(std::memory_order_relaxed); }

void StampEnqueue(Message* m) {
  if (!Armed()) return;
  m->flags |= msgflag::kHasTiming;
  m->timing.t[TimingTrail::kEnqueue] = NowNs();
}

void StampSend(Message* m) {
  if (!m->has_timing()) return;
  // The heartbeat echo keeps its request MsgType but is reply-shaped
  // (its apply stamp is set) — it must fill the reply-send slot, not
  // clobber the origin rank's send stamp with this rank's clock.
  int slot = (IsReplyType(m->type) ||
              m->timing.t[TimingTrail::kApplyDone] != 0)
                 ? TimingTrail::kReplySend
                 : TimingTrail::kSend;
  if (m->timing.t[slot] == 0) m->timing.t[slot] = NowNs();
}

void StampRecv(Message* m) {
  if (!m->has_timing() || IsReplyType(m->type)) return;
  // Reply-shaped heartbeat echoes carry a foreign-rank trail: their
  // recv boundary is the client receipt OnReply takes itself.
  if (m->timing.t[TimingTrail::kApplyDone] != 0) return;
  if (m->timing.t[TimingTrail::kRecv] == 0)
    m->timing.t[TimingTrail::kRecv] = NowNs();
}

void StampDequeue(Message* m) {
  if (!m->has_timing()) return;
  if (m->timing.t[TimingTrail::kDequeue] == 0)
    m->timing.t[TimingTrail::kDequeue] = NowNs();
}

void StampReply(const Message& req, Message* reply) {
  if (!req.has_timing()) return;
  reply->timing = req.timing;
  reply->flags |= msgflag::kHasTiming;
  reply->timing.t[TimingTrail::kApplyDone] = NowNs();
}

void OnReply(const Message& reply, int peer_rank) {
  if (!reply.has_timing()) return;
  const int64_t* t = reply.timing.t;
  int64_t t_enq = t[TimingTrail::kEnqueue];
  int64_t t_send = t[TimingTrail::kSend];
  int64_t t_recv = t[TimingTrail::kRecv];
  int64_t t_deq = t[TimingTrail::kDequeue];
  int64_t t_apply = t[TimingTrail::kApplyDone];
  int64_t t_reply = t[TimingTrail::kReplySend];
  int64_t now = NowNs();

  // NTP sample first, so this very reply's stages use the freshest
  // offset window: offset = ((t2-t1) + (t5-t6))/2, rtt = round trip
  // minus the server's hold time.
  bool remote = t_send != 0 && t_recv != 0 && t_reply != 0;
  if (remote) {
    int64_t offset = ((t_recv - t_send) + (t_reply - now)) / 2;
    int64_t rtt = (now - t_send) - (t_reply - t_recv);
    if (rtt >= 0) UpdateOffset(peer_rank, offset, rtt);
  }
  int64_t off = 0;
  {
    MutexLock lk(g_mu);
    auto it = g_peers.find(peer_rank);
    if (it != g_peers.end()) BestLocked(it->second, &off, nullptr);
  }

  if (t_enq && t_send) RecordStage("lat.stage.queue", t_send - t_enq);
  if (remote) {
    RecordStage("lat.stage.wire_out", (t_recv - off) - t_send);
    if (t_deq) RecordStage("lat.stage.mailbox", t_deq - t_recv);
  } else if (t_send && t_deq) {
    // Local delivery (or an old-transport hop that never stamped recv):
    // the whole send->dequeue leg is the mailbox wait.
    RecordStage("lat.stage.mailbox", t_deq - t_send);
  }
  if (t_deq && t_apply) RecordStage("lat.stage.apply", t_apply - t_deq);
  if (t_apply && t_reply)
    RecordStage("lat.stage.reactor", t_reply - t_apply);
  if (t_reply)
    RecordStage("lat.stage.wire_back",
                remote ? now - (t_reply - off) : now - t_reply);
  if (t_enq) RecordStage("lat.total", now - t_enq);
}

bool PeerOffset(int rank, int64_t* offset_ns, int64_t* rtt_ns,
                long long* samples) {
  MutexLock lk(g_mu);
  auto it = g_peers.find(rank);
  if (it == g_peers.end()) return false;
  if (samples) *samples = it->second.samples;
  return BestLocked(it->second, offset_ns, rtt_ns);
}

std::string OffsetsJson() {
  MutexLock lk(g_mu);
  std::ostringstream os;
  os << "[";
  bool first = true;
  for (const auto& [rank, pc] : g_peers) {
    int64_t off = 0, rtt = 0;
    if (!BestLocked(pc, &off, &rtt)) continue;
    if (!first) os << ',';
    first = false;
    os << "{\"rank\":" << rank << ",\"offset_ns\":" << off
       << ",\"rtt_ns\":" << rtt << ",\"samples\":" << pc.samples << "}";
  }
  os << "]";
  return os.str();
}

void Reset() {
  MutexLock lk(g_mu);
  g_peers.clear();
}

}  // namespace latency
}  // namespace mvtpu
