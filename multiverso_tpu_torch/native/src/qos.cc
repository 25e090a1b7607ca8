#include "mvtpu/qos.h"

#include <algorithm>
#include <deque>
#include <sstream>
#include <unordered_set>
#include <vector>

#include "mvtpu/configure.h"
#include "mvtpu/dashboard.h"
#include "mvtpu/latency.h"
#include "mvtpu/log.h"
#include "mvtpu/mutex.h"

namespace mvtpu {
namespace qos {

namespace {

struct Class {
  std::string name;
  long long weight = 1;
  long long budget = 0;     // guaranteed inflight slots
  long long inflight = 0;
  long long deficit = 0;    // borrow credit (WDRR)
  long long admits = 0;
  long long sheds = 0;
  long long deadline_sheds = 0;
};

struct State {
  std::vector<Class> classes;
  long long cap = 0;          // -qos_inflight_max; <=0 disables admission
  long long max_weight = 1;   // deficit quantum: one borrow per round
  int my_class = 0;           // -qos_class resolved to an id
  bool stamp = true;          // -wire_deadline
  long long deadline_sheds = 0;
  long long cancels_noted = 0;
  long long cancelled = 0;
  // Bounded hedge-cancel registry: tokens are consumed once; the
  // oldest is evicted past capacity (a stale token for a request that
  // already completed is harmless — msg ids are never reused).
  std::deque<uint64_t> cancel_fifo;
  std::unordered_set<uint64_t> cancel_set;
};

constexpr size_t kCancelCap = 1024;

Mutex g_mu;
State& S() REQUIRES(g_mu) {
  static State* s = new State();
  return *s;
}

uint64_t CancelKey(int32_t src, int64_t msg_id) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(src)) << 32) ^
         (static_cast<uint64_t>(msg_id) * 0x9e3779b97f4a7c15ull);
}

std::string FlagStr(const char* name, const char* dflt) {
  return configure::Has(name) ? configure::GetString(name) : dflt;
}

int64_t FlagInt(const char* name, int64_t dflt) {
  return configure::Has(name) ? configure::GetInt(name) : dflt;
}

bool FlagBool(const char* name, bool dflt) {
  return configure::Has(name) ? configure::GetBool(name) : dflt;
}

// Parse "name:weight,name:weight" (bad entries skipped with a log, a
// weightless "name" gets weight 1); guarantees at least one class.
std::vector<Class> ParseClasses(const std::string& spec) {
  std::vector<Class> out;
  std::istringstream in(spec);
  std::string tok;
  while (std::getline(in, tok, ',')) {
    if (tok.empty()) continue;
    Class c;
    auto colon = tok.find(':');
    c.name = tok.substr(0, colon);
    if (colon != std::string::npos) {
      try {
        c.weight = std::max(1ll, static_cast<long long>(
                                     std::stoll(tok.substr(colon + 1))));
      } catch (...) {
        Log::Error("qos: bad weight in -qos_classes entry '%s' (using 1)",
                   tok.c_str());
      }
    }
    if (!c.name.empty()) out.push_back(std::move(c));
  }
  if (out.empty()) out.push_back(Class{"bulk", 1, 0, 0, 0, 0, 0, 0});
  return out;
}

int ClampClassLocked(int klass) REQUIRES(g_mu) {
  if (klass < 0 || klass >= static_cast<int>(S().classes.size())) return 0;
  return klass;
}

}  // namespace

void Configure() {
  MutexLock lk(g_mu);
  State& s = S();
  s.classes = ParseClasses(FlagStr("qos_classes", "bulk:1,gold:8"));
  s.cap = FlagInt("qos_inflight_max", 0);
  s.stamp = FlagBool("wire_deadline", true);
  long long wsum = 0;
  s.max_weight = 1;
  for (auto& c : s.classes) {
    wsum += c.weight;
    s.max_weight = std::max(s.max_weight, c.weight);
  }
  // Guaranteed share: cap * weight / sum(weights), floored at one slot
  // so a low-weight class is throttled, never starved outright.
  for (auto& c : s.classes)
    c.budget = s.cap > 0
                   ? std::max(1ll, s.cap * c.weight / std::max(1ll, wsum))
                   : 0;
  s.my_class = 0;
  std::string mine = FlagStr("qos_class", "bulk");
  for (size_t i = 0; i < s.classes.size(); ++i)
    if (s.classes[i].name == mine) s.my_class = static_cast<int>(i);
}

void Reset() {
  MutexLock lk(g_mu);
  State& s = S();
  for (auto& c : s.classes) {
    c.inflight = c.deficit = c.admits = c.sheds = c.deadline_sheds = 0;
  }
  s.deadline_sheds = s.cancels_noted = s.cancelled = 0;
  s.cancel_fifo.clear();
  s.cancel_set.clear();
}

int NumClasses() {
  MutexLock lk(g_mu);
  return static_cast<int>(S().classes.size());
}

int ClassId(const std::string& name) {
  MutexLock lk(g_mu);
  auto& cls = S().classes;
  for (size_t i = 0; i < cls.size(); ++i)
    if (cls[i].name == name) return static_cast<int>(i);
  return -1;
}

std::string ClassName(int klass) {
  MutexLock lk(g_mu);
  auto& cls = S().classes;
  if (klass < 0 || klass >= static_cast<int>(cls.size())) return "?";
  return cls[static_cast<size_t>(klass)].name;
}

bool TryAdmit(int klass) {
  std::string name;
  bool admitted;
  {
    MutexLock lk(g_mu);
    State& s = S();
    klass = ClampClassLocked(klass);
    Class& c = s.classes[static_cast<size_t>(klass)];
    name = c.name;
    if (s.cap <= 0) {
      // Admission disabled: admit (and count — the mvtop view still
      // shows per-class traffic shape with the gate off).
      ++c.admits;
      admitted = true;
    } else if (c.inflight < c.budget) {
      // Guaranteed share.
      ++c.inflight;
      ++c.admits;
      admitted = true;
    } else {
      long long total = 0;
      for (auto& k : s.classes) total += k.inflight;
      if (total < s.cap) {
        // Spare capacity: borrow in weight proportion — each failed
        // guaranteed-share pass earns `weight` credit, one borrow
        // costs the max weight, so gold borrows 8x as often as bulk
        // under gold:8,bulk:1.
        c.deficit += c.weight;
        if (c.deficit >= s.max_weight) {
          c.deficit -= s.max_weight;
          ++c.inflight;
          ++c.admits;
          admitted = true;
        } else {
          ++c.sheds;
          admitted = false;
        }
      } else {
        ++c.sheds;
        admitted = false;
      }
    }
  }
  Dashboard::Record(
      (admitted ? "serve.qos.admit." : "serve.qos.shed.") + name, 0.0);
  return admitted;
}

void Release(int klass) {
  MutexLock lk(g_mu);
  State& s = S();
  if (s.cap <= 0) return;  // nothing was held
  klass = ClampClassLocked(klass);
  Class& c = s.classes[static_cast<size_t>(klass)];
  if (c.inflight > 0) --c.inflight;
}

void StampRequest(Message* m) {
  bool stamp;
  int my_class;
  {
    MutexLock lk(g_mu);
    stamp = S().stamp;
    my_class = S().my_class;
  }
  if (!stamp) return;
  int64_t timeout_ms =
      configure::Has("rpc_timeout_ms") ? configure::GetInt("rpc_timeout_ms")
                                       : 0;
  if (timeout_ms <= 0) return;  // unbounded caller: no deadline to carry
  m->flags |= msgflag::kHasQos;
  m->qos.klass = my_class;
  m->qos.budget_ns = timeout_ms * 1000000;
}

void AdoptDeadline(Message* m) {
  if (!m->has_qos() || m->qos.budget_ns <= 0) {
    m->qos_deadline_ns = 0;
    return;
  }
  int64_t remaining = m->qos.budget_ns;
  // Wire-time correction (the clock-offset machinery): with a
  // timing trail and a per-peer offset estimate, the budget already
  // spent crossing the wire comes off the remaining allowance.  No
  // estimate (anonymous clients stamp no rank) = conservative zero.
  if (m->has_timing() && m->timing.t[TimingTrail::kSend] != 0 &&
      m->timing.t[TimingTrail::kRecv] != 0) {
    int64_t offset = 0, rtt = 0;
    if (m->src >= 0 && latency::PeerOffset(m->src, &offset, &rtt)) {
      int64_t wire_ns = (m->timing.t[TimingTrail::kRecv] - offset) -
                        m->timing.t[TimingTrail::kSend];
      if (wire_ns > 0) remaining -= wire_ns;
    }
  }
  m->qos_deadline_ns = latency::NowNs() + std::max<int64_t>(remaining, 0);
}

bool ShedExpired(const Message& m) {
  if (m.qos_deadline_ns == 0 || latency::NowNs() < m.qos_deadline_ns)
    return false;
  std::string name;
  {
    MutexLock lk(g_mu);
    State& s = S();
    int klass = ClampClassLocked(m.qos.klass);
    Class& c = s.classes[static_cast<size_t>(klass)];
    ++c.deadline_sheds;
    ++s.deadline_sheds;
    name = c.name;
  }
  Dashboard::Record("serve.deadline.shed", 0.0);
  Dashboard::Record("serve.deadline.shed." + name, 0.0);
  return true;
}

long long DeadlineSheds() {
  MutexLock lk(g_mu);
  return S().deadline_sheds;
}

void NoteCancel(int32_t src, int64_t msg_id) {
  uint64_t key = CancelKey(src, msg_id);
  MutexLock lk(g_mu);
  State& s = S();
  ++s.cancels_noted;
  if (s.cancel_set.insert(key).second) {
    s.cancel_fifo.push_back(key);
    while (s.cancel_fifo.size() > kCancelCap) {
      s.cancel_set.erase(s.cancel_fifo.front());
      s.cancel_fifo.pop_front();
    }
  }
}

bool Cancelled(int32_t src, int64_t msg_id) {
  uint64_t key = CancelKey(src, msg_id);
  bool hit;
  {
    MutexLock lk(g_mu);
    State& s = S();
    hit = s.cancel_set.erase(key) > 0;
    if (hit) ++s.cancelled;
    // The FIFO entry stays until evicted — a set miss there is cheap.
  }
  if (hit) Dashboard::Record("serve.hedge.cancelled", 0.0);
  return hit;
}

std::string Json() {
  MutexLock lk(g_mu);
  State& s = S();
  std::ostringstream os;
  os << "{\"inflight_max\":" << s.cap << ",\"classes\":[";
  for (size_t i = 0; i < s.classes.size(); ++i) {
    const Class& c = s.classes[i];
    if (i) os << ',';
    os << "{\"name\":\"" << c.name << "\",\"weight\":" << c.weight
       << ",\"budget\":" << c.budget << ",\"inflight\":" << c.inflight
       << ",\"admits\":" << c.admits << ",\"sheds\":" << c.sheds
       << ",\"deadline_sheds\":" << c.deadline_sheds << "}";
  }
  os << "],\"deadline_shed\":" << s.deadline_sheds
     << ",\"cancels_noted\":" << s.cancels_noted
     << ",\"cancelled\":" << s.cancelled << "}";
  return os.str();
}

}  // namespace qos
}  // namespace mvtpu
