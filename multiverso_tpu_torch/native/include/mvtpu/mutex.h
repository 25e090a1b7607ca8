// Annotated mutex/condvar shims — the lock vocabulary of the runtime.
//
// Thin zero-cost wrappers over std::mutex/std::condition_variable that
// carry the clang thread-safety capability attributes
// (thread_annotations.h).  libstdc++'s std::mutex is unannotated, so
// locking it directly would leave `clang++ -Wthread-safety` with
// nothing to check; every runtime mutex goes through these instead.
#pragma once

#include <chrono>
#include <condition_variable>
#include <mutex>

#include "mvtpu/thread_annotations.h"

namespace mvtpu {

class CAPABILITY("mutex") Mutex {
 public:
  Mutex() = default;
  Mutex(const Mutex&) = delete;
  Mutex& operator=(const Mutex&) = delete;

  void Lock() ACQUIRE() { mu_.lock(); }
  void Unlock() RELEASE() { mu_.unlock(); }

 private:
  friend class CondVar;
  std::mutex mu_;
};

// RAII scope lock (std::lock_guard with a SCOPED_CAPABILITY attribute,
// so the analysis knows the capability is held for the block).
class SCOPED_CAPABILITY MutexLock {
 public:
  explicit MutexLock(Mutex& mu) ACQUIRE(mu) : mu_(mu) { mu_.Lock(); }
  ~MutexLock() RELEASE() { mu_.Unlock(); }
  MutexLock(const MutexLock&) = delete;
  MutexLock& operator=(const MutexLock&) = delete;

 private:
  Mutex& mu_;
};

// Condition variable over Mutex.  Waits REQUIRE the mutex held and
// return with it held; there is deliberately no predicate overload —
// callers loop `while (!cond) cv.Wait(mu);` under their MutexLock so
// every guarded read in the condition stays visible to the analysis
// (a predicate lambda would be analyzed as an unlocked function).
class CondVar {
 public:
  void Wait(Mutex& mu) REQUIRES(mu) NO_THREAD_SAFETY_ANALYSIS {
    // adopt/release: hand the already-held mutex to the condvar, take
    // it back on wake — net effect "still held", which the analysis
    // cannot see through (hence the suppression; REQUIRES is still
    // enforced at every call site).
    std::unique_lock<std::mutex> lk(mu.mu_, std::adopt_lock);
    cv_.wait(lk);
    lk.release();
  }

  // False on deadline expiry, true when notified (spurious wakes
  // included — callers re-check their condition either way).
  //
  // system_clock, NOT a steady_clock wait_for: libstdc++'s wait_for
  // rides pthread_cond_clockwait (CLOCK_MONOTONIC), which gcc-10's
  // libtsan does not intercept — TSan then misses the wait's internal
  // unlock/relock and reports a bogus "double lock of a mutex" against
  // the next notifier.  system_clock goes through the intercepted
  // pthread_cond_timedwait.  Cost: a wall-clock jump can stretch or
  // shrink one in-flight deadline.
  bool WaitUntil(Mutex& mu, std::chrono::system_clock::time_point deadline)
      REQUIRES(mu) NO_THREAD_SAFETY_ANALYSIS {
    std::unique_lock<std::mutex> lk(mu.mu_, std::adopt_lock);
    auto st = cv_.wait_until(lk, deadline);
    lk.release();
    return st != std::cv_status::timeout;
  }

  void NotifyOne() { cv_.notify_one(); }
  void NotifyAll() { cv_.notify_all(); }

 private:
  std::condition_variable cv_;
};

}  // namespace mvtpu
