#include "mvtpu/host_arena.h"

#include <stdlib.h>
#include <sys/mman.h>

#include "mvtpu/configure.h"

namespace mvtpu {

namespace {

constexpr size_t kAlign = 64;

size_t RoundCap(size_t bytes) {
  if (bytes == 0) bytes = 1;
  return (bytes + kAlign - 1) / kAlign * kAlign;
}

bool PinEnabled() {
  // Flags may not be registered when the arena is driven standalone
  // (unit tests acquire before MV_Init).
  return configure::Has("arena_pin") ? configure::GetBool("arena_pin")
                                     : true;
}

}  // namespace

HostArena* HostArena::Get() {
  static auto* a = new HostArena();
  return a;
}

void* HostArena::Acquire(size_t bytes) {
  size_t cap = RoundCap(bytes);
  {
    MutexLock lk(mu_);
    // First fit with bounded waste: a recycled buffer serves requests
    // down to half its capacity, so size-class drift cannot strand a
    // large buffer behind a stream of tiny Acquires (or vice versa).
    auto it = free_.lower_bound(cap);
    if (it != free_.end() && it->first <= cap * 2) {
      char* base = it->second;
      free_.erase(it);
      Buf& b = bufs_[base];
      b.caller_held = true;
      ++stats_.recycled;
      --stats_.free_buffers;
      ++stats_.buffers;
      return base;
    }
  }
  void* p = nullptr;
  if (posix_memalign(&p, kAlign, cap) != 0) return nullptr;
  Buf b;
  b.cap = cap;
  b.caller_held = true;
  // Best-effort pin: RLIMIT_MEMLOCK commonly forbids large mlocks in
  // unprivileged containers — a miss costs the page-fault/migration
  // guarantee, never correctness, so it is counted rather than fatal.
  if (PinEnabled() && mlock(p, cap) == 0) b.pinned = true;
  MutexLock lk(mu_);
  if (b.pinned) ++stats_.pinned;
  stats_.bytes += static_cast<long long>(cap);
  ++stats_.buffers;
  bufs_[static_cast<char*>(p)] = b;
  return p;
}

void HostArena::Recycle(char* base, Buf* b) {
  free_.emplace(b->cap, base);
  ++stats_.free_buffers;
  --stats_.buffers;
}

int HostArena::Release(void* ptr) {
  MutexLock lk(mu_);
  auto it = bufs_.find(static_cast<char*>(ptr));
  if (it == bufs_.end()) return -1;
  if (!it->second.caller_held) return -2;
  it->second.caller_held = false;
  if (it->second.borrows == 0) {
    Recycle(it->first, &it->second);
  } else {
    // In-flight borrowed send: the recycle waits for the last borrow
    // (DropBorrow) — the caller's Release is still correct and cheap.
    ++stats_.deferred;
  }
  return 0;
}

void* HostArena::BufferOf(const void* p, size_t len) {
  const char* cp = static_cast<const char*>(p);
  MutexLock lk(mu_);
  auto it = bufs_.upper_bound(const_cast<char*>(cp));
  if (it == bufs_.begin()) return nullptr;
  --it;
  const Buf& b = it->second;
  if (!b.caller_held) return nullptr;
  if (cp < it->first || cp + len > it->first + b.cap) return nullptr;
  return it->first;
}

void HostArena::DropBorrow(void* base) {
  MutexLock lk(mu_);
  auto it = bufs_.find(static_cast<char*>(base));
  if (it == bufs_.end()) return;
  if (--it->second.borrows == 0) {
    --stats_.in_flight;
    if (!it->second.caller_held) Recycle(it->first, &it->second);
  }
}

std::shared_ptr<void> HostArena::BorrowHold(void* base) {
  {
    MutexLock lk(mu_);
    auto it = bufs_.find(static_cast<char*>(base));
    if (it == bufs_.end()) return nullptr;
    if (it->second.borrows++ == 0) ++stats_.in_flight;
  }
  return std::shared_ptr<void>(
      base, [](void* b) { HostArena::Get()->DropBorrow(b); });
}

HostArena::Stats HostArena::GetStats() {
  MutexLock lk(mu_);
  return stats_;
}

}  // namespace mvtpu
