#include "mvtpu/fault.h"

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <string>

#include "mvtpu/mutex.h"

namespace mvtpu {

namespace {

struct Knob {
  double rate = 0.0;      // probability per op
  long long budget = 0;   // deterministic: fire on the next `budget` ops
};

struct State {
  Knob drop;
  Knob delay;
  Knob dup;
  Knob fail_send;
  Knob apply_delay;
  Knob discard_apply;
  int64_t delay_ms = 50;
  uint64_t rng = 0x9e3779b97f4a7c15ull;
};

Mutex g_mu;
State& S() REQUIRES(g_mu) {
  static State* s = new State();
  return *s;
}
// Fast-path gate, kept in sync with the knobs under g_mu.  Relaxed is
// enough: a sender racing a Set/Clear may act on the old verdict for
// one message, which injection semantics tolerate by construction.
std::atomic<bool> g_enabled{false};

uint64_t NextRand() REQUIRES(g_mu) {
  // xorshift64* — tiny, seedable, good enough for injection decisions.
  uint64_t x = S().rng;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  S().rng = x;
  return x * 0x2545f4914f6cdd1dull;
}

bool Fire(Knob* k) REQUIRES(g_mu) {
  if (k->budget > 0) {
    --k->budget;
    return true;
  }
  if (k->rate > 0.0) {
    double u = static_cast<double>(NextRand() >> 11) * (1.0 / 9007199254740992.0);
    return u < k->rate;
  }
  return false;
}

Knob* Find(const char* kind) REQUIRES(g_mu) {
  if (!kind) return nullptr;
  std::string k(kind);
  if (k == "drop") return &S().drop;
  if (k == "delay") return &S().delay;
  if (k == "dup") return &S().dup;
  if (k == "fail_send") return &S().fail_send;
  if (k == "apply_delay") return &S().apply_delay;
  if (k == "discard_apply") return &S().discard_apply;
  return nullptr;
}

void Recompute() REQUIRES(g_mu) {
  State& s = S();
  auto live = [](const Knob& k) { return k.rate > 0.0 || k.budget > 0; };
  g_enabled.store(live(s.drop) || live(s.delay) || live(s.dup) ||
                      live(s.fail_send) || live(s.apply_delay) ||
                      live(s.discard_apply),
                  std::memory_order_relaxed);
}

double EnvRate(const char* name) {
  const char* v = getenv(name);
  return v ? atof(v) : 0.0;
}

// One-shot env pickup: the chaos Makefile target and multi-process
// scenarios configure child ranks through the environment because they
// have no C-API call site before MV_Init.
void InitFromEnvLocked() REQUIRES(g_mu) {
  static bool done = false;
  if (done) return;
  done = true;
  State& s = S();
  if (const char* v = getenv("MVTPU_FAULT_SEED"))
    s.rng = static_cast<uint64_t>(atoll(v)) | 1ull;
  s.drop.rate = EnvRate("MVTPU_FAULT_DROP");
  s.delay.rate = EnvRate("MVTPU_FAULT_DELAY");
  s.dup.rate = EnvRate("MVTPU_FAULT_DUP");
  s.fail_send.rate = EnvRate("MVTPU_FAULT_FAIL_SEND");
  s.apply_delay.rate = EnvRate("MVTPU_FAULT_APPLY_DELAY");
  s.discard_apply.rate = EnvRate("MVTPU_FAULT_DISCARD_APPLY");
  if (const char* v = getenv("MVTPU_FAULT_DELAY_MS")) s.delay_ms = atoll(v);
  Recompute();
}

struct EnvInit {
  EnvInit() {
    MutexLock lk(g_mu);
    InitFromEnvLocked();
  }
};
EnvInit g_env_init;

}  // namespace

bool Fault::Enabled() { return g_enabled.load(std::memory_order_relaxed); }

Fault::Action Fault::OnSend(int64_t* delay_ms) {
  if (!Enabled()) return Action::kNone;
  MutexLock lk(g_mu);
  if (Fire(&S().drop)) {
    Recompute();
    return Action::kDrop;
  }
  if (Fire(&S().delay)) {
    if (delay_ms) *delay_ms = S().delay_ms;
    Recompute();
    return Action::kDelay;
  }
  if (Fire(&S().dup)) {
    Recompute();
    return Action::kDuplicate;
  }
  return Action::kNone;
}

int64_t Fault::ApplyDelayMs() {
  if (!Enabled()) return 0;
  MutexLock lk(g_mu);
  if (!Fire(&S().apply_delay)) return 0;
  int64_t ms = S().delay_ms;
  Recompute();
  return ms;
}

bool Fault::DiscardApply() {
  if (!Enabled()) return false;
  MutexLock lk(g_mu);
  bool fire = Fire(&S().discard_apply);
  if (fire) Recompute();
  return fire;
}

bool Fault::FailSendAttempt() {
  if (!Enabled()) return false;
  MutexLock lk(g_mu);
  bool fire = Fire(&S().fail_send);
  if (fire) Recompute();
  return fire;
}

int Fault::Set(const char* kind, double rate) {
  MutexLock lk(g_mu);
  if (kind && strcmp(kind, "delay_ms") == 0) {
    S().delay_ms = static_cast<int64_t>(rate);
    return 0;
  }
  Knob* k = Find(kind);
  if (!k || rate < 0.0 || rate > 1.0) return -1;
  k->rate = rate;
  Recompute();
  return 0;
}

int Fault::SetBudget(const char* kind, long long n) {
  MutexLock lk(g_mu);
  Knob* k = Find(kind);
  if (!k || n < 0) return -1;
  k->budget = n;
  Recompute();
  return 0;
}

void Fault::SetSeed(uint64_t seed) {
  MutexLock lk(g_mu);
  S().rng = seed | 1ull;  // xorshift state must be nonzero
}

void Fault::Clear() {
  MutexLock lk(g_mu);
  State& s = S();
  s.drop = Knob{};
  s.delay = Knob{};
  s.dup = Knob{};
  s.fail_send = Knob{};
  s.apply_delay = Knob{};
  s.discard_apply = Knob{};
  Recompute();
}

}  // namespace mvtpu
