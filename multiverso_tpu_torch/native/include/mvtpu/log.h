// Leveled logger with optional file sink.
// Capability parity with include/multiverso/util/log.h (SURVEY.md §2.21).
#pragma once

#include <string>

namespace mvtpu {

enum class LogLevel : int { kDebug = 0, kInfo = 1, kError = 2, kFatal = 3 };

class Log {
 public:
  static void SetLevel(LogLevel level);
  static void ResetLogFile(const std::string& path);  // "" = stderr only
  static void Debug(const char* fmt, ...);
  static void Info(const char* fmt, ...);
  static void Error(const char* fmt, ...);
  // Logs and aborts (reference Fatal semantics).
  [[noreturn]] static void Fatal(const char* fmt, ...);
};

}  // namespace mvtpu
