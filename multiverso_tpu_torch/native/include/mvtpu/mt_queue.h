// MtQueue — blocking MPMC queue; every actor's mailbox.
// Capability parity with include/multiverso/util/mt_queue.h (SURVEY.md §2.22).
#pragma once

#include <deque>
#include <utility>

#include "mvtpu/mutex.h"

namespace mvtpu {

template <typename T>
class MtQueue {
 public:
  void Push(T item) {
    {
      MutexLock lk(mu_);
      q_.push_back(std::move(item));
    }
    cv_.NotifyOne();
  }

  // Blocks until an item arrives or Exit() is called.
  // Returns false iff exited and drained.
  bool Pop(T* out) {
    MutexLock lk(mu_);
    while (q_.empty() && !exit_) cv_.Wait(mu_);
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    return true;
  }

  bool TryPop(T* out) {
    MutexLock lk(mu_);
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    return true;
  }

  void Exit() {
    {
      MutexLock lk(mu_);
      exit_ = true;
    }
    cv_.NotifyAll();
  }

  size_t Size() const {
    MutexLock lk(mu_);
    return q_.size();
  }

 private:
  mutable Mutex mu_;
  CondVar cv_;
  std::deque<T> q_ GUARDED_BY(mu_);
  bool exit_ GUARDED_BY(mu_) = false;
};

}  // namespace mvtpu
