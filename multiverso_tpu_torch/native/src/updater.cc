#include "mvtpu/updater.h"

namespace mvtpu {

UpdaterType UpdaterFromName(const std::string& name) {
  if (name == "sgd") return UpdaterType::kSGD;
  if (name == "adagrad") return UpdaterType::kAdaGrad;
  if (name == "momentum") return UpdaterType::kMomentum;
  if (name == "smooth_gradient") return UpdaterType::kSmoothGradient;
  if (name == "assign") return UpdaterType::kAssign;
  return UpdaterType::kDefault;
}

bool IsUpdaterName(const std::string& name) {
  return name == "default" || name == "add" || name == "sgd" ||
         name == "adagrad" || name == "momentum" ||
         name == "smooth_gradient" || name == "assign";
}

void ApplyUpdate(UpdaterType t, const AddOption& opt, float* w, float* slot0,
                 const float* delta, size_t n) {
  const float lr = opt.learning_rate;
  switch (t) {
    case UpdaterType::kDefault:
      for (size_t i = 0; i < n; ++i) w[i] += delta[i];
      break;
    case UpdaterType::kSGD:
      for (size_t i = 0; i < n; ++i) w[i] -= lr * delta[i];
      break;
    case UpdaterType::kAdaGrad:
      for (size_t i = 0; i < n; ++i) {
        slot0[i] += delta[i] * delta[i];
        w[i] -= lr * delta[i] / (sqrtf(slot0[i]) + opt.eps);
      }
      break;
    case UpdaterType::kMomentum:
      for (size_t i = 0; i < n; ++i) {
        slot0[i] = opt.momentum * slot0[i] + lr * delta[i];
        w[i] -= slot0[i];
      }
      break;
    case UpdaterType::kSmoothGradient:
      for (size_t i = 0; i < n; ++i) {
        slot0[i] = opt.rho * slot0[i] + (1.0f - opt.rho) * delta[i];
        w[i] -= lr * slot0[i];
      }
      break;
    case UpdaterType::kAssign:
      // Stored bits == pushed bits: the offload bridge's bit-exactness
      // contract (docs/host_bridge.md) rests on this memcpy semantics.
      for (size_t i = 0; i < n; ++i) w[i] = delta[i];
      break;
  }
}

}  // namespace mvtpu
