#include "mvtpu/log.h"

#include <atomic>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <ctime>

#include "mvtpu/mutex.h"

namespace mvtpu {

namespace {
Mutex g_mu;
// Atomic: the level gate runs before taking g_mu on every log call and
// SetLevel may race an in-flight Emit.
std::atomic<LogLevel> g_level{LogLevel::kInfo};
FILE* g_file GUARDED_BY(g_mu) = nullptr;

void Emit(LogLevel level, const char* tag, const char* fmt, va_list ap) {
  if (level < g_level.load(std::memory_order_relaxed)) return;
  MutexLock lk(g_mu);
  char ts[32];
  time_t now = time(nullptr);
  struct tm tmv;
  localtime_r(&now, &tmv);
  strftime(ts, sizeof(ts), "%H:%M:%S", &tmv);
  va_list ap2;
  va_copy(ap2, ap);
  fprintf(stderr, "[%s %s mvtpu] ", tag, ts);
  vfprintf(stderr, fmt, ap);
  fputc('\n', stderr);
  if (g_file) {
    fprintf(g_file, "[%s %s mvtpu] ", tag, ts);
    vfprintf(g_file, fmt, ap2);
    fputc('\n', g_file);
    fflush(g_file);
  }
  va_end(ap2);
}
}  // namespace

void Log::SetLevel(LogLevel level) {
  g_level.store(level, std::memory_order_relaxed);
}

void Log::ResetLogFile(const std::string& path) {
  MutexLock lk(g_mu);
  if (g_file) fclose(g_file);
  g_file = path.empty() ? nullptr : fopen(path.c_str(), "a");
}

#define MVTPU_LOG_BODY(level, tag)      \
  va_list ap;                           \
  va_start(ap, fmt);                    \
  Emit(level, tag, fmt, ap);            \
  va_end(ap)

void Log::Debug(const char* fmt, ...) { MVTPU_LOG_BODY(LogLevel::kDebug, "D"); }
void Log::Info(const char* fmt, ...) { MVTPU_LOG_BODY(LogLevel::kInfo, "I"); }
void Log::Error(const char* fmt, ...) { MVTPU_LOG_BODY(LogLevel::kError, "E"); }

void Log::Fatal(const char* fmt, ...) {
  MVTPU_LOG_BODY(LogLevel::kFatal, "F");
  abort();
}

}  // namespace mvtpu
