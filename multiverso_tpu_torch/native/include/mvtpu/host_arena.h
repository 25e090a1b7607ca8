// HostArena — pinned, recycled, 64-byte-aligned host buffers for the
// zero-copy numpy<->Blob handoff (docs/host_bridge.md).
//
// The arena is the ownership authority of the host-bridge fast path: a
// buffer handed out by Acquire() has TWO kinds of holds —
//
//   - the CALLER hold (Acquire -> Release): the binding / application
//     owns the bytes and may read or write them;
//   - NATIVE borrows (BorrowHold copies): in-flight messages whose
//     Blobs borrow the bytes straight into the scatter-gather send path
//     instead of copying (Blob::Borrow).
//
// A buffer returns to the free list only when BOTH are gone.  A caller
// releasing a buffer while a borrowed send is still in flight does not
// free or recycle anything — the recycle is DEFERRED until the last
// borrow drops (the release hook fires when the last shallow Blob copy
// dies), so a late wire write can never read recycled memory.  This is
// the "mutate/free mid-flight" contract: Release() is always safe;
// actually MUTATING a borrowed buffer before its borrows drop is the
// caller's bug (the Python HostArena only re-hands out recycled
// buffers, so respecting Acquire/Release makes mutation safe too).
//
// Buffers are 64-byte aligned (cache-line / AVX-512 friendly, and MV008
// contiguity holds by construction for arrays built over them) and
// best-effort pinned with mlock(2) under `-arena_pin` — pinning failure
// (RLIMIT_MEMLOCK) is counted, not fatal.  Freed buffers are retained
// for reuse: the arena's footprint is the high-water mark of
// simultaneously live buffers, never traffic.
#pragma once

#include <cstddef>
#include <map>
#include <memory>

#include "mvtpu/mutex.h"

namespace mvtpu {

class HostArena {
 public:
  static HostArena* Get();

  // A recycled (or fresh) buffer of capacity >= bytes, 64-byte aligned,
  // caller-held until Release().  nullptr only on allocation failure.
  void* Acquire(size_t bytes);

  // Drop the caller hold.  rc 0 ok (recycled now, or deferred behind
  // in-flight borrows); -1 unknown pointer; -2 already released.
  int Release(void* ptr);

  // Base pointer of the LIVE (caller-held) arena buffer fully
  // containing [p, p+len); nullptr when p is not arena memory, the
  // window overruns its buffer, or the buffer was already released —
  // the validity gate of every *Borrowed C API call.
  void* BufferOf(const void* p, size_t len);

  // A shared native hold on `base` (an Acquire'd buffer's base
  // pointer).  Copies keep the buffer off the free list; the last drop
  // recycles it iff the caller hold is gone.  This is the keepalive a
  // borrowed Blob carries (Blob::Borrow).
  std::shared_ptr<void> BorrowHold(void* base);

  struct Stats {
    long long buffers = 0;       // live buffers (caller-held or borrowed)
    long long free_buffers = 0;  // recycled, ready for Acquire
    long long bytes = 0;         // total arena bytes (live + free)
    long long in_flight = 0;     // buffers with active native borrows
    long long deferred = 0;      // releases deferred behind a borrow (total)
    long long recycled = 0;      // Acquires served from the free list
    long long pinned = 0;        // buffers mlock'd (best-effort)
  };
  Stats GetStats();

 private:
  struct Buf {
    size_t cap = 0;
    bool caller_held = false;
    int borrows = 0;
    bool pinned = false;
  };

  void DropBorrow(void* base);
  void Recycle(char* base, Buf* b) REQUIRES(mu_);

  Mutex mu_;
  std::map<char*, Buf> bufs_ GUARDED_BY(mu_);        // by base address
  std::multimap<size_t, char*> free_ GUARDED_BY(mu_);  // by capacity
  Stats stats_ GUARDED_BY(mu_);
};

}  // namespace mvtpu
