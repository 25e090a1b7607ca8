// Waiter — counted latch used to block Get/Add until replies arrive.
// Capability parity with include/multiverso/util/waiter.h (SURVEY.md §2.23).
#pragma once

#include <chrono>
#include <cstdint>

#include "mvtpu/mutex.h"

namespace mvtpu {

class Waiter {
 public:
  explicit Waiter(int count = 1) : count_(count) {}

  void Wait() {
    MutexLock lk(mu_);
    while (count_ > 0) cv_.Wait(mu_);
  }

  // Deadline wait: true when the count reached zero, false on timeout.
  // timeout_ms <= 0 means wait forever (the reference's only mode).
  bool WaitFor(int64_t timeout_ms) {
    if (timeout_ms <= 0) {
      Wait();
      return true;
    }
    auto deadline = std::chrono::system_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    MutexLock lk(mu_);
    while (count_ > 0) {
      if (!cv_.WaitUntil(mu_, deadline)) return count_ <= 0;
    }
    return true;
  }

  void Notify() {
    // notify_all runs WHILE holding mu_: the waiting caller (RoundTrip,
    // Barrier) may drop its reference right after observing count_<=0,
    // so notifying after the unlock could run on a destroyed object.
    // Waiters are heap-allocated (shared_ptr) by every caller: TSan's
    // mutex shadow state is flushed on free, whereas a stack slot
    // reused by the next call's waiter resurrects the old mutex
    // identity in gcc-10's libtsan.
    MutexLock lk(mu_);
    --count_;
    cv_.NotifyAll();
  }

  void Reset(int count) {
    MutexLock lk(mu_);
    count_ = count;
  }

 private:
  Mutex mu_;
  CondVar cv_;
  int count_ GUARDED_BY(mu_);
};

}  // namespace mvtpu
