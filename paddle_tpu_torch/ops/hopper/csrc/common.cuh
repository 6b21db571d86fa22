// Shared helpers for the Hopper kernels: element conversions and the dtype
// codes the Python wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DtypeCode { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The last error of this thread's launches, as cudaError_t (0 on success).
// Each entry point returns it right after its launch; the wrapper raises.
#define RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())

#define DEFINE_ERROR_STRING()                                       \
  extern "C" const char* kernel_error_string(int code) {           \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
