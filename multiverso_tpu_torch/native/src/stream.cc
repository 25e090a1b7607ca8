#include "mvtpu/stream.h"

#include <sys/stat.h>

#include <string>

namespace mvtpu {

namespace {
// mkdir -p for the parent directory of `path`.
void EnsureParent(const std::string& path) {
  auto slash = path.find_last_of('/');
  if (slash == std::string::npos) return;
  std::string dir = path.substr(0, slash);
  std::string cur;
  size_t i = 0;
  while (i <= dir.size()) {
    if (i == dir.size() || dir[i] == '/') {
      cur = dir.substr(0, i);
      if (!cur.empty()) mkdir(cur.c_str(), 0755);
    }
    ++i;
  }
}
}  // namespace

LocalStream::LocalStream(const std::string& path, const char* mode) {
  if (mode && (mode[0] == 'w' || mode[0] == 'a')) EnsureParent(path);
  f_ = fopen(path.c_str(), mode);
}

LocalStream::~LocalStream() {
  if (f_) fclose(f_);
}

size_t LocalStream::Write(const void* buf, size_t size) {
  return f_ ? fwrite(buf, 1, size, f_) : 0;
}

size_t LocalStream::Read(void* buf, size_t size) {
  return f_ ? fread(buf, 1, size, f_) : 0;
}

std::unique_ptr<Stream> StreamFactory::Open(const std::string& uri,
                                            const char* mode) {
  std::string path = uri;
  auto pos = uri.find("://");
  if (pos != std::string::npos) {
    std::string scheme = uri.substr(0, pos);
    if (scheme != "file") return nullptr;
    path = uri.substr(pos + 3);
  }
  auto s = std::make_unique<LocalStream>(path, mode);
  if (!s->Good()) return nullptr;
  return s;
}

}  // namespace mvtpu
