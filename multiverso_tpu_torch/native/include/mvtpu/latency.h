// Latency attribution plane (docs/observability.md "latency plane").
//
// Answers *where* a slow request spent its time: the wire header's
// TimingTrail (mvtpu/message.h) carries six monotonic-clock stamps —
// client enqueue, client send, server frame-complete, server actor
// dequeue, apply done, reply send — and the client, on reply receipt,
// folds the trail into per-stage Dashboard histograms:
//
//   lat.stage.queue      enqueue -> transport (client mailbox + handler)
//   lat.stage.wire_out   client send -> server frame-complete (*)
//   lat.stage.mailbox    frame-complete -> actor dequeue (incl. SSP park)
//   lat.stage.apply      dequeue -> table work done
//   lat.stage.reactor    apply done -> reply handed to the transport
//   lat.stage.wire_back  reply send -> client receipt (*)
//   lat.total            enqueue -> client receipt (end to end)
//
// (*) cross-rank stages span two clocks; they are corrected by the
// per-peer clock offset this module estimates NTP-style from every
// timed round trip (request/reply AND the heartbeat, whose echo
// carries a trail): offset = ((t_recv - t_send) + (t_reply - t_now))/2,
// with the minimum-RTT sample of a bounded window winning (the classic
// clock filter — congested samples carry the most offset error).
// Offset-corrected stage sums telescope back to lat.total exactly, so
// "stages sum to the end-to-end latency" is a checkable invariant.
//
// Stamping costs one steady_clock read per boundary and 48 wire bytes
// per message; `-wire_timing=false` (or MV_SetWireTiming) compiles the
// whole plane down to one relaxed atomic load per site.
#pragma once

#include <cstdint>
#include <string>

#include "mvtpu/message.h"

namespace mvtpu {
namespace latency {

// Monotonic nanoseconds (std::chrono::steady_clock) — NEVER wall clock:
// the offset estimator assumes each rank's stamps share one monotonic
// timebase (mvlint MV014 polices the Python mirror).
int64_t NowNs();

// Arm switch: latched from -wire_timing at Zoo::Start, toggled live by
// MV_SetWireTiming.  Disarmed, every stamp below is one relaxed load.
void Arm(bool on);
bool Armed();

// ---- stamping (no-op when disarmed / the message has no trail) -------
// Mint the trail on a fresh request: sets msgflag::kHasTiming + the
// enqueue stamp.  Called by the worker-side request builders.
void StampEnqueue(Message* m);
// Transport hand-off stamp: requests fill kSend, replies (and any
// message whose apply stamp is already set — the heartbeat echo)
// fill kReplySend.  Stamp-once: a retry does not refresh it.
void StampSend(Message* m);
// Receiver-side stamps, stamp-if-zero so a duplicated or re-delivered
// message keeps its FIRST boundary crossing (SSP re-delivery folds the
// park time into lat.stage.mailbox, where it belongs).
void StampRecv(Message* m);     // frame complete (reactor / reader)
void StampDequeue(Message* m);  // actor handler entry
// Server reply hand-off: copy the request's trail into the reply, set
// its timing flag, and stamp kApplyDone — a reply only ever carries a
// trail when the request did (old clients are never handed one).
void StampReply(const Message& req, Message* reply);

// ---- client-side attribution ----------------------------------------
// Fold a timed reply into the stage histograms and feed the peer's
// clock-offset estimator.  `peer_rank` is the server rank whose clock
// stamped the middle of the trail.  Safe on trail-less replies (no-op).
void OnReply(const Message& reply, int peer_rank);

// Best current offset estimate for a peer: *offset_ns is how far the
// PEER's monotonic clock sits ahead of ours; false when no timed round
// trip to that peer completed yet.
bool PeerOffset(int rank, int64_t* offset_ns, int64_t* rtt_ns,
                long long* samples = nullptr);

// JSON array of every estimated peer offset — the "offsets" section of
// the "latency" OpsQuery report.
std::string OffsetsJson();

// Test isolation: drop every offset estimate (histograms live in the
// Dashboard and reset with it).
void Reset();

}  // namespace latency
}  // namespace mvtpu
