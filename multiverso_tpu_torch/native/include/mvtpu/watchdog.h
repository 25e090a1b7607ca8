// Stall watchdog — mechanical detection of a wedged critical loop
// (docs/observability.md "health plane").
//
// Every critical loop (epoll reactor shards, actor mailboxes, the
// heartbeat/lease scan, the Python metrics flusher via the C API)
// Bump()s a per-loop progress counter each iteration and declares its
// queued work with Busy().  A low-rate checker thread flags any loop
// that made ZERO progress for -watchdog_stall_ms while work was
// queued: it records `watchdog.stalls`, lands a
// "stall: <loop> no progress for Nms, queue=D" blackbox event plus the
// sampling profiler's folded stacks (so the dump names WHERE the loop
// is stuck, not just THAT it is stuck), and fires a blackbox trigger.
// This is the class of bug the reactor lost-wakeup was — an alive
// process whose event loop silently stopped draining — caught by a
// counter instead of a human.
//
// Idle is innocent: a loop with nothing queued never stalls, so a
// quiet fleet costs nothing and alerts nothing.  Disarmed (the
// default, -watchdog_stall_ms=0) every call is one relaxed atomic
// load.  -watchdog_stall_ms must exceed the slowest legitimate loop
// period (the heartbeat scan ticks at -hb_interval_ms) or steady-state
// cadence reads as a stall.
#pragma once

#include <string>

namespace mvtpu {
namespace watchdog {

// Arm the checker at `stall_ms` (<= 0 disarms and joins the checker).
// The checker period is stall_ms/4 clamped to [10ms, 1s], so detection
// lands within stall_ms + one checker period.  Idempotent.
void Arm(int stall_ms);
bool Armed();

// One unit of progress on `loop` (registers the loop on first use).
void Bump(const std::string& loop);

// Declare `loop`'s queued work; 0 = idle (an idle loop cannot stall).
void Busy(const std::string& loop, long long queued);

// JSON array, one object per registered loop:
//   {"loop":..,"progress":n,"queued":n,"stalls":n,"stalled":bool,
//    "age_s":s,"stalled_s":s}
// — the "watchdog" section of the "alerts" OpsQuery report.
std::string StatsJson();

// Total stalls flagged since Arm/Reset (testing, ops).
long long StallCount();

// Test isolation: disarm and drop every registered loop.
void Reset();

}  // namespace watchdog
}  // namespace mvtpu
