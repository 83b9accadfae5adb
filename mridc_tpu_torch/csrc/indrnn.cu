// K3: the IndRNN cell with a 1x1 input kernel, forward.
//
// Stands for mridc_tpu/nn/rnn_cells.py:88-109 IndRNNCell.__call__
//   h'[p, o] = relu(sum_i x[p, i] * W[o, i] + b[o] + u[o] * h[p, o])
// over the P = B*H*W pixels of channels-last [P, CI] and [P, F] tensors. In
// eager PyTorch that is five passes (1x1 conv, bias, u*h, add, relu); here it is
// one read of x and h and one write of h'.
//
// What bounds it on an H100: memory. At F = CI = 64 in float32 the cell moves
// 3*P*F*4 bytes (79 MB per 320x320 slice) for 2*P*F*CI flops, below the card's
// float32 flop-per-byte ratio.
//
// Design: W sits in shared memory for the life of a block, which walks over
// tiles of 64 pixels (grid-stride, so W is staged once per block, not once per
// tile) and stages each tile's x rows in shared memory.
//   float32: a block of 4*F threads; each thread accumulates 4 output channels
//   of 4 pixels on the CUDA cores (one 16-byte load of W and four broadcast
//   loads of x per input channel).
//   bfloat16: four warps, 16 pixels each, run the [64, CI] x [CI, F] product on
//   the tensor cores (mma.sync m16n8k16, float32 accumulate); needs CI % 16 == 0
//   and F % 8 == 0, F <= 128.
// Either way bias, recurrence and relu are applied in registers before the
// one store. The wrapper passes W, b and u as float32 holding values already
// rounded to the storage type, as the JAX package casts them to compute_dtype.
#include "common.cuh"

using namespace mridc;

namespace {

constexpr int TP = 64;     // pixels per tile
constexpr int LANES = 16;  // pixel lanes per block; each lane owns 4 pixels of a tile

__global__ void indrnn_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                                  const float* __restrict__ w, const float* __restrict__ bias,
                                  const float* __restrict__ u, float* __restrict__ out, int P, int CI, int F) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;           // [CI][F]
  float* xs = smem + CI * F;  // [TP][CI]
  const int G = F / 4;
  const int tid = threadIdx.x, g = tid % G, lane = tid / G;

  for (int e = tid; e < CI * F; e += blockDim.x) {
    const int o = e / CI, i = e - o * CI;
    ws[i * F + o] = w[e];
  }
  float bj[4], uj[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bj[j] = bias != nullptr ? bias[4 * g + j] : 0.f;
    uj[j] = u[4 * g + j];
  }

  const int tiles = (P + TP - 1) / TP;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * TP;
    const int n = min(TP, P - p0) * CI;
    __syncthreads();  // W staged; the previous tile's reads of xs are done
    for (int e = tid; e < TP * CI; e += blockDim.x) xs[e] = e < n ? x[(size_t)p0 * CI + e] : 0.f;
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
    for (int i = 0; i < CI; ++i) {
      const float4 w4 = *reinterpret_cast<const float4*>(ws + i * F + 4 * g);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float xv = xs[(lane + LANES * k) * CI + i];
        acc[k][0] = fmaf(xv, w4.x, acc[k][0]);
        acc[k][1] = fmaf(xv, w4.y, acc[k][1]);
        acc[k][2] = fmaf(xv, w4.z, acc[k][2]);
        acc[k][3] = fmaf(xv, w4.w, acc[k][3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + lane + LANES * k;
      if (p >= P) continue;
      const size_t base = (size_t)p * F + 4 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[k][j] + bj[j] + uj[j] * h[base + j];
        out[base + j] = v < 0.f ? 0.f : v;  // relu that keeps a NaN
      }
    }
  }
}

// grid size for a grid-stride kernel: one wave of as many blocks as fit
template <typename K>
cudaError_t wave(K kernel, int threads, size_t smem, int tiles, int* grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return err;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  *grid = tiles < cap ? tiles : cap;
  return cudaSuccess;
}

// ---- bfloat16: tensor cores -----------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;  // 4 warps x 16 pixels = one 64-pixel tile
constexpr int MAX_NT = 16;    // F <= 128: n tiles of 8 output channels

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// smem: W as bf16 [F][CI+8] (B = W^T column-major), x tile as bf16 [64][CI+8]
// (A row-major); the +8 row padding spreads the fragment loads over the banks
template <int NT>
__global__ void __launch_bounds__(THREADS) indrnn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ h,
                                                              const float* __restrict__ w,
                                                              const float* __restrict__ bias,
                                                              const float* __restrict__ u, bf16* __restrict__ out,
                                                              int P, int CI) {
  constexpr int F = NT * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lds = CI + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* xs = ws + F * lds;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;

  for (int e = tid; e < F * CI; e += THREADS) ws[(e / CI) * lds + e % CI] = __float2bfloat16(w[e]);
  float bj[NT][2], uj[NT][2];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = 8 * n + 2 * t4 + j;
      bj[n][j] = bias != nullptr ? bias[o] : 0.f;
      uj[n][j] = u[o];
    }

  const int tiles = (P + 63) / 64;
  const int vec = CI / 8;  // 16-byte vectors per pixel row
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * 64;
    __syncthreads();  // W staged; the previous tile's fragment loads are done
    for (int e = tid; e < 64 * vec; e += THREADS) {
      const int pp = e / vec, q = e % vec;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p0 + pp < P) v = *reinterpret_cast<const uint4*>(x + (size_t)(p0 + pp) * CI + 8 * q);
      *reinterpret_cast<uint4*>(xs + pp * lds + 8 * q) = v;
    }
    __syncthreads();

    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
    for (int kk = 0; kk < CI; kk += 16) {
      const bf16* pa = xs + (warp * 16 + g) * lds + kk + 2 * t4;
      const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * lds), ld32(pa + 8), ld32(pa + 8 * lds + 8)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* pb = ws + (8 * n + g) * lds + kk + 2 * t4;
        mma(acc[n], a, ld32(pb), ld32(pb + 8));
      }
    }
    // accumulator register j of n tile n: pixel warp*16+g (+8 for j >= 2),
    // output channel 8n+2*t4+(j&1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + warp * 16 + g + 8 * half;
      if (p >= P) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const size_t base = (size_t)p * F + 8 * n + 2 * t4;
        const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + base));
        float v0 = acc[n][2 * half] + bj[n][0] + uj[n][0] * hv.x;
        float v1 = acc[n][2 * half + 1] + bj[n][1] + uj[n][1] * hv.y;
        v0 = v0 < 0.f ? 0.f : v0;  // relu that keeps a NaN
        v1 = v1 < 0.f ? 0.f : v1;
        *reinterpret_cast<__nv_bfloat162*>(out + base) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int NT>
int launch_bf16(const void* x, const void* h, const void* w, const void* bias, const void* u, void* out, int P,
                int CI, void* stream) {
  const size_t smem = (size_t)(NT * 8 + 64) * (CI + 8) * sizeof(bf16);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = wave(indrnn_bf16_kernel<NT>, THREADS, smem, (P + 63) / 64, &grid);
  if (err != cudaSuccess) return (int)err;
  indrnn_bf16_kernel<NT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)h, (const float*)w, (const float*)bias, (const float*)u, (bf16*)out, P, CI);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int k3_indrnn_f32(const void* x, const void* h, const void* w, const void* bias, const void* u,
                             void* out, int P, int CI, int F, void* stream) {
  if (P <= 0 || CI <= 0 || F <= 0 || F % 4 != 0 || 4 * F > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(CI * F + TP * CI) * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = wave(indrnn_f32_kernel, 4 * F, smem, (P + TP - 1) / TP, &grid);
  if (err != cudaSuccess) return (int)err;
  indrnn_f32_kernel<<<grid, 4 * F, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)h, (const float*)w,
                                                                 (const float*)bias, (const float*)u, (float*)out, P,
                                                                 CI, F);
  return (int)cudaGetLastError();
}

extern "C" int k3_indrnn_bf16(const void* x, const void* h, const void* w, const void* bias, const void* u,
                              void* out, int P, int CI, int F, void* stream) {
  if (P <= 0 || CI <= 0 || CI % 16 != 0 || F <= 0 || F % 8 != 0 || F > 8 * tc::MAX_NT)
    return (int)cudaErrorInvalidValue;
  switch (F / 8) {
#define MRIDC_NT(n) \
  case n:           \
    return tc::launch_bf16<n>(x, h, w, bias, u, out, P, CI, stream);
    MRIDC_NT(1) MRIDC_NT(2) MRIDC_NT(3) MRIDC_NT(4) MRIDC_NT(5) MRIDC_NT(6) MRIDC_NT(7) MRIDC_NT(8)
    MRIDC_NT(9) MRIDC_NT(10) MRIDC_NT(11) MRIDC_NT(12) MRIDC_NT(13) MRIDC_NT(14) MRIDC_NT(15) MRIDC_NT(16)
#undef MRIDC_NT
  }
  return (int)cudaErrorInvalidValue;
}
