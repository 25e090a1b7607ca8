// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu): the mask, the row reductions, the
// shared-memory cap and the plain-C error helper every library exports.
// The designs themselves are in hopper.cuh (bf16) and hopper_f32.cuh
// (float32 as three bf16 planes).
//
// Conventions shared with multiverso_tpu/ops/flash_attention.py:
//   q, k, v, do are [bh, T, D] row-major in T (float or bf16), q arrives
//   PRE-SCALED by the softmax scale; lse and delta are [bh, T] float.
//   Scores, softmax statistics and accumulators are float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace mvt {

constexpr float kNeg = -1e30f;  // finite mask sentinel, as in the JAX kernel
// Dynamic shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

// True where a (query, key) pair is excluded: beyond either length, or
// above the diagonal under the causal mask.
__device__ __forceinline__ bool masked_out(int qp, int kp, int tq, int tk,
                                           int causal) {
  return kp >= tk || qp >= tq || (causal && kp > qp);
}

// Reduction over the TPR consecutive lanes that share one row.
template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

using bf16 = __nv_bfloat16;

// Sets the dynamic shared-memory cap of one kernel instantiation once,
// then launches nothing itself; returns the CUDA error code.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace mvt

// dtype codes shared with the Python wrapper.
#define MVT_DTYPE_F32 0
#define MVT_DTYPE_BF16 1
// Return code for a dtype or head dim the library was not built for.
#define MVT_UNSUPPORTED (-1)
// Return code for a TMA descriptor the driver refused (hopper.cuh).
#define MVT_TMA_REFUSED (-2)
// Return code for a float32 launch given no scratch for its bf16 planes
// (hopper_f32.cuh).
#define MVT_NO_SCRATCH (-3)
// Return code for a float32 launch whose scratch is smaller than its planes
// (hopper_f32.cuh).
#define MVT_SCRATCH_SHORT (-4)

extern "C" const char* mvt_error_string(int code) {
  if (code == MVT_UNSUPPORTED) return "unsupported dtype or head dim";
  if (code == MVT_TMA_REFUSED) {
    return "TMA descriptor refused (pointer not 16-byte aligned or shape "
           "out of range)";
  }
  if (code == MVT_NO_SCRATCH) {
    return "float32 launch given no scratch for its bf16 planes";
  }
  if (code == MVT_SCRATCH_SHORT) {
    return "float32 launch given less scratch than its bf16 planes take";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
