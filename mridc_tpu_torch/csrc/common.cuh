// Shared helpers of the port's kernels: storage-type loads and stores (every
// kernel computes in float32 whatever it stores), cp.async copies into shared
// memory, ldmatrix and the bf16 mma.sync product, products at float32
// accuracy on the TF32 tensor cores (3xTF32), the cached one-wave launch setup
// of the persistent kernels, and the error string that the Python wrappers
// print when a launch returns a nonzero cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace mridc {

// ---- launch setup -----------------------------------------------------------

constexpr int MAX_DYNAMIC_SMEM = 232448;  // shared memory a block can opt in to on Hopper

// blocks of one full wave of ``kernel`` at ``smem`` bytes of dynamic shared
// memory (as many as fit on every SM); queried once per (kernel, smem, device)
// and cached, so a launch costs no host query. The kernel's dynamic
// shared-memory limit is set to the most a block can have, not to ``smem``:
// one kernel runs at several sizes, and a later, smaller setup must not lower
// the limit that a cached, larger one launches with.
inline cudaError_t wave(const void* kernel, int threads, size_t smem, int device, int* cap) {
  using Key = std::tuple<const void*, size_t, int>;
  static std::mutex mu;
  static std::map<Key, int> cache;
  const Key key{kernel, smem, device};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *cap = it->second;
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  *cap = sms * (per_sm > 0 ? per_sm : 1);
  cache.emplace(key, *cap);
  return cudaSuccess;
}

// ---- asynchronous copies into shared memory --------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// 16 (8, 4) bytes from device to shared memory, asynchronously; zeros when
// ``valid`` is false (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bf16 tensor cores -------------------------------------------------------

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// which lands in r[j] in the mma fragment layout (``trans``: transposed)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a*b, one m16n8k16 bf16 product with float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// A cheaper split for kernels bound by their splits: hi is x with its 13 low
// bits cleared (TF32 by truncation) and lo = x - hi, exact, passed with its
// low bits set: the tensor core reads the top 19 bits of a .tf32 operand, so
// lo is truncated too. Two operations, where cvt.rna.tf32.f32 compiles to a
// sequence of several on Hopper. |lo| < 2^-10 |x|, so the truncations and the
// dropped lo*lo keep a product's error below ~3 * 2^-20 of its magnitude.
__device__ __forceinline__ Split split_trunc(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

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
