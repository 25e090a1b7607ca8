// Server-side updaters applied per Add.
// Capability parity with include/multiverso/updater/ (SURVEY.md §2.16):
// default(add)/sgd/adagrad/momentum/smooth_gradient selected by
// -updater_type, hyper-parameters carried per call in AddOption.
// Math matches the Python/JAX updaters bit-for-bit in float32 so the two
// control planes are interchangeable.
#pragma once

#include <cmath>
#include <cstddef>
#include <string>
#include <vector>

namespace mvtpu {

struct AddOption {
  float learning_rate = 0.1f;
  float momentum = 0.9f;
  float rho = 0.9f;
  float eps = 1e-8f;
  int32_t worker_id = -1;
};

enum class UpdaterType : int { kDefault = 0, kSGD, kAdaGrad, kMomentum,
                               kSmoothGradient,
                               // assign: w = delta (last-write-wins) — the
                               // "put" of the offload bridge
                               // (docs/host_bridge.md): remotely stored
                               // optimizer/embedding state round-trips
                               // bit-exactly because the server stores the
                               // pushed float32 bits verbatim instead of
                               // accumulating into them.
                               kAssign };

inline int NumSlots(UpdaterType t) {
  return (t == UpdaterType::kAdaGrad || t == UpdaterType::kMomentum ||
          t == UpdaterType::kSmoothGradient)
             ? 1
             : 0;
}

// Returns kDefault for unknown names (caller validates via IsUpdaterName).
UpdaterType UpdaterFromName(const std::string& name);
bool IsUpdaterName(const std::string& name);

// Apply `delta[0..n)` to `w[offset..offset+n)` with per-element state slot.
void ApplyUpdate(UpdaterType t, const AddOption& opt, float* w, float* slot0,
                 const float* delta, size_t n);

}  // namespace mvtpu
