// Actor — named mailbox + own thread + per-message-type handlers.
// Capability parity with include/multiverso/actor.h (SURVEY.md §2.3).
#pragma once

#include <functional>
#include <map>
#include <string>
#include <thread>

#include "mvtpu/message.h"
#include "mvtpu/mt_queue.h"

namespace mvtpu {

namespace actor {
inline constexpr const char* kWorker = "worker";
inline constexpr const char* kServer = "server";
inline constexpr const char* kCommunicator = "communicator";
inline constexpr const char* kController = "controller";
}  // namespace actor

class Actor {
 public:
  explicit Actor(std::string name) : name_(std::move(name)) {}
  virtual ~Actor();

  const std::string& name() const { return name_; }

  void Start();          // spawn the mailbox-drain thread
  void Stop();           // push Exit, join
  void Receive(MessagePtr msg) { mailbox_.Push(std::move(msg)); }
  // Mailbox backlog (messages queued behind the one being processed) —
  // the serve layer's inflight measure (-server_inflight_max).
  size_t QueueSize() const { return mailbox_.Size(); }

 protected:
  using Handler = std::function<void(MessagePtr&)>;
  void RegisterHandler(MsgType type, Handler h) { handlers_[type] = std::move(h); }

 private:
  void Main();

  std::string name_;
  MtQueue<MessagePtr> mailbox_;
  std::map<MsgType, Handler> handlers_;
  std::thread thread_;
  bool running_ = false;
};

}  // namespace mvtpu
