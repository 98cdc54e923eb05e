// Shared helpers for the port's kernels: element loads in fp32, the
// masking constant of the TPU kernels, the shared-memory opt-in and the C
// entry-point conventions.
//
// Every entry point is `extern "C"`, takes raw pointers and the CUDA stream
// as void*, launches on that stream, never synchronizes, and returns the
// cudaGetLastError() of its launch (0 = launched).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// the TPU kernels mask with a finite -2e38, not -inf, and then zero the
// probabilities of masked keys explicitly; the port does the same
#define REPRO_NEG_INF (-2.0e38f)

// dtype codes shared with the Python wrappers
enum ReproDtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_from_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, int64_t i,
                                               float v) {
  p[i] = __float2bfloat16(v);
}

// dynamic shared memory a block may opt in to on sm_90 (227 KiB)
constexpr int kMaxSmemOptIn = 232448;

// Lets one kernel take up to kMaxSmemOptIn bytes of dynamic shared memory:
// cudaFuncSetAttribute once per device, not on every launch.  Keep one
// (function-local static) per kernel.
struct SmemOptIn {
  static constexpr int kMaxDevices = 64;
  std::atomic<bool> done[kMaxDevices];

  template <typename Kernel>
  cudaError_t operator()(Kernel* kernel) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
      return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemOptIn);
    if (e == cudaSuccess && dev < kMaxDevices) done[dev].store(true);
    return e;
  }
};

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
