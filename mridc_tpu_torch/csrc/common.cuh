// Shared helpers of the port's kernels: storage-type loads and stores (every
// kernel computes in float32 whatever it stores), and the error string that
// the Python wrappers print when a launch returns a nonzero cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mridc {

template <typename T>
__device__ __forceinline__ float ld(const T* p);

template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }

template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ void st(T* p, float v);

template <>
__device__ __forceinline__ void st<float>(float* p, float v) { *p = v; }

template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

inline int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace mridc

extern "C" const char* mridc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
