// Blob — ref-counted byte buffer with typed views.
// Capability parity with the reference's include/multiverso/blob.h
// (SURVEY.md §2.4): the unit of message payload. Implemented fresh on
// shared_ptr instead of a hand-rolled refcount.
#pragma once

#include <cstddef>
#include <cstring>
#include <memory>
#include <vector>

namespace mvtpu {

class Blob {
 public:
  Blob() = default;
  explicit Blob(size_t size) : data_(std::make_shared<std::vector<char>>(size)) {}
  Blob(const void* src, size_t size)
      : data_(std::make_shared<std::vector<char>>(size)) {
    std::memcpy(data_->data(), src, size);
  }

  // Zero-copy view into a shared slab (the receive-arena path,
  // docs/transport.md): shares ownership of `owner` but exposes only
  // [off, off+len).  The slab cannot be freed or overwritten while any
  // view is alive — the arena checks use_count() before reusing it —
  // so a view is as safe as an owning Blob, without the copy.
  static Blob View(std::shared_ptr<std::vector<char>> owner, size_t off,
                   size_t len) {
    Blob b;
    b.data_ = std::move(owner);
    b.off_ = off;
    b.len_ = len;
    b.is_view_ = true;
    return b;
  }

  // Borrowed EXTERNAL memory (the host-bridge send path,
  // docs/host_bridge.md): a non-owning window over caller-owned bytes —
  // a HostArena buffer — with a release hook.  `keepalive`'s deleter
  // fires when the last shallow copy of this blob dies (the message was
  // sent / locally processed and destroyed), which is how the arena
  // learns the wire is done with the buffer.  The bytes must stay alive
  // and UNCHANGED until then; the arena defers recycling to make the
  // caller's Release() unconditionally safe.  Paths that must mutate or
  // outlive the payload (codec encode, aggregation) never borrow — they
  // produce fresh owning blobs (copy-on-conflict).
  static Blob Borrow(const void* ptr, size_t len,
                     std::shared_ptr<void> keepalive) {
    Blob b;
    b.ext_ = static_cast<const char*>(ptr);
    b.len_ = len;
    b.keepalive_ = std::move(keepalive);
    return b;
  }
  bool borrowed() const { return ext_ != nullptr; }

  size_t size() const {
    if (ext_) return len_;
    return is_view_ ? len_ : (data_ ? data_->size() : 0);
  }
  char* data() {
    if (ext_) return const_cast<char*>(ext_);
    return data_ ? data_->data() + (is_view_ ? off_ : 0) : nullptr;
  }
  const char* data() const {
    if (ext_) return ext_;
    return data_ ? data_->data() + (is_view_ ? off_ : 0) : nullptr;
  }

  template <typename T>
  T* As() { return reinterpret_cast<T*>(data()); }
  template <typename T>
  const T* As() const { return reinterpret_cast<const T*>(data()); }
  template <typename T>
  size_t count() const { return size() / sizeof(T); }

  // Shallow copy shares the buffer (the reference Blob's refcount
  // semantics); CopyFrom deep-copies (views and borrows flatten to
  // owning blobs — the borrow's keepalive drops here).
  void CopyFrom(const Blob& other) {
    data_ = std::make_shared<std::vector<char>>(
        other.data(), other.data() + other.size());
    off_ = 0;
    len_ = 0;
    is_view_ = false;
    ext_ = nullptr;
    keepalive_.reset();
  }

 private:
  std::shared_ptr<std::vector<char>> data_;
  size_t off_ = 0;   // view window (is_view_ only)
  size_t len_ = 0;   // view / borrow length
  bool is_view_ = false;
  const char* ext_ = nullptr;        // borrowed external base (or null)
  std::shared_ptr<void> keepalive_;  // borrow release hook (host_arena.h)
};

}  // namespace mvtpu
