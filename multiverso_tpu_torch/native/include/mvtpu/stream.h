// Byte streams for checkpoints — local filesystem flavor.
// Capability parity with include/multiverso/io/ (SURVEY.md §2.27); the
// HDFS flavor is delegated to the Python layer's fsspec seam.
#pragma once

#include <cstdio>
#include <memory>
#include <string>

namespace mvtpu {

class Stream {
 public:
  virtual ~Stream() = default;
  virtual size_t Write(const void* buf, size_t size) = 0;
  virtual size_t Read(void* buf, size_t size) = 0;
  virtual bool Good() const = 0;
};

class LocalStream : public Stream {
 public:
  LocalStream(const std::string& path, const char* mode);
  ~LocalStream() override;
  size_t Write(const void* buf, size_t size) override;
  size_t Read(void* buf, size_t size) override;
  bool Good() const override { return f_ != nullptr; }

 private:
  FILE* f_ = nullptr;
};

class StreamFactory {
 public:
  // "file:///path" or plain path → LocalStream; unknown scheme → nullptr.
  static std::unique_ptr<Stream> Open(const std::string& uri, const char* mode);
};

}  // namespace mvtpu
