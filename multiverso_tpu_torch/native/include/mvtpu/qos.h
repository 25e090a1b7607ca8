// Tail-at-scale serve-tier QoS plane (docs/serving.md "tail").
//
// Three mechanisms, all behind version-tolerant wire stamps:
//
// 1. **Per-tenant weighted admission** — anonymous serve clients declare
//    a tenant class (a QosStamp in the wire header; the class id is a
//    POSITIONAL index into `-qos_classes`, e.g. "bulk:1,gold:8"), and
//    the epoll reactor's admission path becomes weighted deficit-round-
//    robin over per-class inflight budgets: each class owns
//    `cap * weight / sum(weights)` of the `-qos_inflight_max` read
//    slots outright, and spare capacity is borrowed in weight
//    proportion via per-class deficit credit.  A bulk herd at its cap
//    answers ReplyBusy at the reactor while gold reads keep flowing;
//    adds and flushes are never shed.  Per-class admit/shed counters
//    land in the Dashboard (serve.qos.{admit,shed}.<class>) and thus
//    the "metrics" ops kind.
//
// 2. **Deadline propagation** — requests carry their remaining deadline
//    budget (QosStamp::budget_ns, stamped from the caller's timeout);
//    the receiver converts it to a local monotonic deadline at frame
//    receipt (wire time corrected via the per-peer clock-offset
//    estimate when one exists), and the reactor + server actor drop an
//    already-expired read at dequeue (serve.deadline.shed[.<class>])
//    instead of burning an apply slot on an answer nobody is waiting
//    for.  Adds are never deadline-shed.
//
// 3. **Hedge-cancel registry** — a hedged read's loser is cancelled
//    with a fire-and-forget RequestCancel token consumed AT THE
//    REACTOR (it overtakes the mailbox FIFO the loser is parked in);
//    the actor drops a cancelled read at dequeue
//    (serve.hedge.cancelled).
//
// Disarmed (`-qos_inflight_max=0`, no stamps on the wire), every hook
// below is a relaxed load or a no-op — the <1% fast-path bar.
#pragma once

#include <cstdint>
#include <string>

#include "mvtpu/message.h"

namespace mvtpu {
namespace qos {

// (Re)latch the class table + budgets from the flags (-qos_classes,
// -qos_inflight_max, -qos_class, -wire_deadline).  Called by Zoo::Start
// so per-process flag choices win; safe to call again (test isolation —
// counters reset).
void Configure();
// Drop counters + inflight + cancel registry (test isolation).
void Reset();

int NumClasses();
// Positional class id for a name in -qos_classes; -1 when unknown.
int ClassId(const std::string& name);
// Name for a class id ("?" when out of range).
std::string ClassName(int klass);

// Weighted deficit-round-robin admission over per-class inflight read
// budgets.  True (and the slot held) when admitted; false = shed with
// ReplyBusy.  Always true when -qos_inflight_max <= 0 (disabled).
// Counts serve.qos.admit.<class> / serve.qos.shed.<class>.
bool TryAdmit(int klass);
// Settle one admitted read slot (reply sent, or the read was dropped
// at dequeue).  Floors at zero per class.
void Release(int klass);

// ---- deadline propagation --------------------------------------------
// Worker-side: stamp the request's class (-qos_class) and remaining
// budget (from -rpc_timeout_ms) behind msgflag::kHasQos.  No-op when
// -wire_deadline=false or the timeout is unbounded.
void StampRequest(Message* m);
// Receiver-side (transport recv path, right after latency::StampRecv):
// convert the wire budget into a local monotonic deadline in
// m->qos_deadline_ns, correcting for wire time via the per-peer clock
// offset when the timing trail + an offset estimate exist.
void AdoptDeadline(Message* m);
// True when the message's adopted deadline has passed — the caller
// drops the read and must Release() its admission slot if it held one.
// Counts serve.deadline.shed and serve.deadline.shed.<class>.
bool ShedExpired(const Message& m);
// Deadline sheds observed so far (the mvtop/latdoctor surface).
long long DeadlineSheds();

// ---- hedge-cancel registry -------------------------------------------
// Note a fire-and-forget cancel token for (src, msg_id); bounded ring —
// the oldest token is evicted past capacity.
void NoteCancel(int32_t src, int64_t msg_id);
// Consume a token: true exactly once per noted (src, msg_id).
bool Cancelled(int32_t src, int64_t msg_id);

// {"classes":[{name,weight,budget,inflight,admits,sheds,
//   deadline_sheds}...],"inflight_max":N,"deadline_shed":N,
//  "cancels_noted":N,"cancelled":N} — the "latency" ops kind's "qos"
// section (mvtop --qos renders it).
std::string Json();

}  // namespace qos
}  // namespace mvtpu
