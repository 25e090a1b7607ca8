// Fault — deterministic fault-injection hooks for the wire plane.
// The chaos suite (tests/test_fault.py, docs/fault_tolerance.md) scripts
// transport failures through this seam instead of hoping for real ones:
// drop / delay / duplicate a logical send, or fail individual write
// attempts so the retry/backoff path in TcpNet::Send is exercised on
// demand.  Configured through the C API (MV_SetFault*) or environment
// (MVTPU_FAULT_SEED, MVTPU_FAULT_{DROP,DELAY,DUP,FAIL_SEND},
// MVTPU_FAULT_DELAY_MS), deterministic under a seed.  Disabled (the
// default) the hooks are one relaxed atomic load — no behavior change,
// no counters.
#pragma once

#include <cstdint>

namespace mvtpu {

class Fault {
 public:
  enum class Action { kNone, kDrop, kDelay, kDuplicate };

  // Fast-path gate: false means every hook below is a no-op.
  static bool Enabled();

  // Consult once per LOGICAL message about to ship.  kDelay also fills
  // *delay_ms.  The caller owns acting on the verdict (and counting it
  // in the Dashboard at the site, so counter names stay with the code
  // they describe).
  static Action OnSend(int64_t* delay_ms);

  // Consult once per WRITE ATTEMPT: true = simulate a wire failure
  // (the caller treats it exactly like a failed ::send), which is what
  // drives the retry-then-succeed chaos scenario.
  static bool FailSendAttempt();

  // Consult once per server-side APPLY (ProcessGet/ProcessAdd): the
  // returned milliseconds (0 = none) are slept INSIDE the apply stage,
  // so the latency-attribution plane (docs/observability.md) can prove
  // it pins a seeded slowdown on `lat.stage.apply` rather than the
  // wire — the latdoctor acceptance scenario.  kind "apply_delay";
  // the shared "delay_ms" knob sets the length.
  static int64_t ApplyDelayMs();

  // Consult once per server-side RequestAdd: true = SILENTLY discard
  // the delivered add before it is applied or booked — the seeded
  // "real loss" the delivery-audit plane (docs/observability.md
  // "audit plane") must detect as an audit_gap; retry cannot absorb it
  // because the wire delivery succeeded.  kind "discard_apply".
  static bool DiscardApply();

  // kind: drop | delay | dup | fail_send (probability per op in [0,1]);
  // delay_ms sets the injected delay length.  Returns 0, -1 on unknown
  // kind / bad rate.
  static int Set(const char* kind, double rate);
  // Deterministic alternative to a probability: fire on exactly the
  // next n matching ops, then stop.  Same kinds as Set.
  static int SetBudget(const char* kind, long long n);
  static void SetSeed(uint64_t seed);
  static void Clear();  // back to fully disabled
};

}  // namespace mvtpu
