// Flag registry + "-name=value" command-line parsing.
// Capability parity with include/multiverso/util/configure.h (SURVEY.md
// §2.20): the reference's MV_DEFINE_* macro system, rebuilt as a typed
// registry. Known reference flags (sync, updater_type, machine_file, port,
// backup_worker_ratio, log_level, log_file) are pre-registered.
#pragma once

#include <string>

namespace mvtpu {
namespace configure {

void DefineBool(const std::string& name, bool dflt, const std::string& help);
void DefineInt(const std::string& name, long long dflt, const std::string& help);
void DefineDouble(const std::string& name, double dflt, const std::string& help);
void DefineString(const std::string& name, const std::string& dflt,
                  const std::string& help);

bool GetBool(const std::string& name);
long long GetInt(const std::string& name);
double GetDouble(const std::string& name);
std::string GetString(const std::string& name);

bool Has(const std::string& name);
// Accepts "-name=value" / "--name=value"; returns number parsed,
// -1 on first unknown flag or bad value.
int ParseCmdFlags(int argc, const char* const* argv);
void Set(const std::string& name, const std::string& value);  // throws std::invalid_argument
void Reset();  // restore every flag to its default

void RegisterDefaults();

}  // namespace configure
}  // namespace mvtpu
