// Always-on sampling profiler (docs/observability.md "latency plane").
//
// A SIGPROF/ITIMER_PROF sampler in the classic gprof shape: the signal
// fires on whichever thread is burning CPU, the handler captures a raw
// backtrace into a preallocated lock-free ring (no malloc, no locks —
// the handler is async-signal-safe by construction), and Dump()
// aggregates + symbolizes off the hot path into folded-stack lines
//
//   sym_outer;sym_inner;sym_leaf <count>
//
// that the Python layer renders into the Chrome trace beside the span
// timeline (multiverso_tpu_torch/profiler.py).  Because ITIMER_PROF counts
// CPU time, an idle serve tier costs literally zero samples; a busy one
// pays ~one backtrace per sampling period — the bench_latency
// `profiler_overhead_pct < 1` bar holds at the default 97 Hz with room
// to spare.  97 (prime) rather than 100 so the sampler cannot phase-
// lock with millisecond-periodic work and alias it in or out.
#pragma once

#include <string>

namespace mvtpu {
namespace profiler {

// Start sampling at `hz` (<= 0 stops).  Idempotent; restarting with a
// new rate rearms the timer but keeps the ring.  Returns false when the
// timer/handler could not be installed.
bool Start(int hz);
void Stop();
bool Running();

// Folded-stack aggregation of everything sampled so far:
//   one line per distinct stack, "outer;...;leaf count\n", innermost
//   frame LAST (the flamegraph.pl / speedscope folded convention).
// Symbolized via dladdr; address-only frames render as hex.
std::string DumpFolded();

// {"running":bool,"hz":n,"samples":n,"dropped":n} — the "profiler"
// section of the "latency" OpsQuery report.
std::string StatusJson();

// Drop every recorded sample (test isolation / per-phase A-B runs).
void Clear();

}  // namespace profiler
}  // namespace mvtpu
