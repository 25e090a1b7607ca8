#include "mvtpu/actor.h"

#include "mvtpu/log.h"
#include "mvtpu/watchdog.h"

namespace mvtpu {

Actor::~Actor() { Stop(); }

void Actor::Start() {
  if (running_) return;
  running_ = true;
  thread_ = std::thread(&Actor::Main, this);
}

void Actor::Stop() {
  if (!running_) return;
  running_ = false;
  mailbox_.Exit();
  if (thread_.joinable()) thread_.join();
}

void Actor::Main() {
  // Watchdog (docs/observability.md "health plane"): each dispatched
  // message is one unit of progress; queued = this message plus
  // whatever is still in the mailbox.  A handler that never returns —
  // the wedged-server-actor class of bug — shows as "actor.<name>
  // no progress" with a nonzero queue.
  const std::string wd_name = "actor." + name_;
  MessagePtr msg;
  while (mailbox_.Pop(&msg)) {
    if (!msg) continue;
    if (msg->type == MsgType::Exit) break;
    auto it = handlers_.find(msg->type);
    if (it == handlers_.end()) {
      Log::Error("actor %s: no handler for msg type %d", name_.c_str(),
                 static_cast<int>(msg->type));
      continue;
    }
    watchdog::Busy(wd_name, static_cast<long long>(mailbox_.Size()) + 1);
    it->second(msg);
    watchdog::Bump(wd_name);
    watchdog::Busy(wd_name, 0);
  }
  watchdog::Busy(wd_name, 0);
}

}  // namespace mvtpu
