// Shared helpers of the port's kernels: storage-type loads and stores (every
// kernel computes in float32 whatever it stores), products at float32
// accuracy on the TF32 tensor cores (3xTF32), and the error string that the
// Python wrappers print when a launch returns a nonzero cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mridc {

// ---- 3xTF32: float32 accuracy from TF32 mma.sync --------------------------
// Each operand is split into a TF32 hi part and a TF32 lo part (x - hi,
// rounded again), and each product taken as hi*lo + lo*hi + hi*hi; lo*lo lies
// below float32's rounding.

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ Split neg(Split s) { return {s.hi ^ 0x80000000u, s.lo ^ 0x80000000u}; }

// d += a*b, one m16n8k8 TF32 product with float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a*b as hi*lo + lo*hi + hi*hi (the small terms first); a and b in the
// m16n8k8 fragment layouts
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4], Split b0, Split b1) {
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

// ---- storage types ---------------------------------------------------------

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
