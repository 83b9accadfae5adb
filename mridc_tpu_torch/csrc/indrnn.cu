// K3: the IndRNN cell with a 1x1 input kernel, forward.
//
// Stands for mridc_tpu/nn/rnn_cells.py:88-109 IndRNNCell.__call__
//   h'[p, o] = relu(sum_i x[p, i] * W[o, i] + b[o] + u[o] * h[p, o])
// over the P = B*H*W pixels of channels-last [P, CI] and [P, F] tensors. In
// eager PyTorch that is five passes (1x1 conv, bias, u*h, add, relu); here it is
// one read of x and h and one write of h'.
//
// What bounds it on an H100: memory. At F = CI = 64 in float32 the cell moves
// 3*P*F*4 bytes (79 MB per 320x320 slice) for 2*P*F*CI flops. At the data
// sheet's 3xTF32 rate (495/3 TFLOP/s) the product would take a fifth of the
// bytes' time; on mma.sync the product, epilogue and stores alone measured
// about as long as the copies alone (tools/torch_k3_f32_variants.py), so the
// design overlaps the two.
//
// float32 design: a persistent grid of one wave of 4-warp blocks, two per SM
// at the main path's widths.
//   - W is split once per block into TF32 hi and lo parts and kept in shared
//     memory in the m16n8k8 B-fragment layout: one 16-byte load gives a
//     thread both k-halves of its fragment, hi and lo.
//   - The block walks over tiles of TP pixels. STAGES shared-memory stages
//     hold each tile's x and h rows, brought in by cp.async (16-byte
//     copies; 4-byte ones when CI % 4 != 0), zero-filled past P and past CI,
//     so the next tile's loads are in flight during this tile's MMAs, and
//     the other block's stages during this block's barriers.
//   - The product runs on the tensor cores as 3xTF32 (mma.sync m16n8k8, each
//     operand split into hi + lo, hi*lo + lo*hi + hi*hi): float32 accuracy.
//     wgmma, the route to the card's full TF32 rate, is later work.
//   - The epilogue reads h from the staged tile, applies bias, recurrence and
//     relu in registers, writes h' over h in the stage, and the block stores
//     the tile (contiguous in device memory) with 16-byte stores.
//   - Warps split a tile's pixels in rows of 16 and its output channels.
//     TP is 64, or 32 or 16 when a wider W and tile do not fit shared memory.
// bfloat16 design: four warps, 16 pixels each, run the [64, CI] x [CI, F]
// product on the tensor cores (mma.sync m16n8k16, float32 accumulate) from a
// W and an x tile staged in shared memory; needs CI % 16 == 0 and F % 8 == 0,
// F <= 128. Bias, recurrence and relu are applied in registers before the one
// store.
// The wrapper passes W, b and u as float32 holding values already rounded to
// the storage type, as the JAX package casts them to compute_dtype. The launch
// setup (shared-memory attribute, blocks of one wave) is computed once per
// kernel, shared-memory size and device, and cached.
#include "common.cuh"

using namespace mridc;

namespace {

constexpr size_t MAX_SMEM = 232448;  // shared memory a block can opt in to on Hopper

// ---- float32: 3xTF32 tensor cores, cp.async ring ---------------------------

namespace f32 {

constexpr int THREADS = 128;  // 4 warps
// Tiles in shared memory per block: one computed, one in flight. With 64-pixel
// tiles two such blocks fit on an SM (109 KB each at 64 -> 64), and the two
// keep 64 KB of loads in flight there while the other computes. A third stage
// takes 145 KB, so only one block fits per SM: its barriers then stall the
// SM's copies and MMAs together, and it runs 1.5x slower on an H100. Deeper
// rings of narrower tiles keep two blocks per SM but run slower still (32
// pixels x 3 or 4 stages 1.55x, 16 x 6 stages 2.9x;
// tools/torch_k3_f32_variants.py).
constexpr int STAGES = 2;

__host__ __device__ inline int round8(int n) { return (n + 7) / 8 * 8; }

// Shared-memory layout, in 4-byte words. Row strides keep the fragment loads
// free of bank conflicts: x rows cip + 4 words (A fragments: rows g, columns
// t4); W rows of 16-byte entries with a stride of 4 (mod 8) entries (B
// fragments); h rows fp + 8 words (8-byte epilogue accesses).
struct Layout {
  int cip, fp;  // CI and F rounded up to the mma's 8
  int ldx, ldh, ldw;  // row strides: x and h in words, W in 16-byte entries
  int stage;          // words per stage: TP rows of x, then TP rows of h

  __host__ __device__ Layout(int CI, int F, int TP) {
    cip = round8(CI);
    fp = round8(F);
    ldx = cip + 4;
    ldh = fp + 8;
    ldw = cip / 2 + ((cip / 2) % 8 == 0 ? 4 : 0);
    stage = TP * (ldx + ldh);
  }
  // W entries, then bias and u, then the stages
  __host__ __device__ size_t bytes() const {
    return (size_t)fp * ldw * 16 + 2 * (size_t)fp * 4 + (size_t)STAGES * stage * 4;
  }
};

// X16: CI % 4 == 0, so x rows copy as 16-byte vectors
template <int TP, bool X16>
__global__ void __launch_bounds__(THREADS) indrnn_f32_kernel(const float* __restrict__ x, const float* __restrict__ h,
                                                             const float* __restrict__ w,
                                                             const float* __restrict__ bias,
                                                             const float* __restrict__ u, float* __restrict__ out,
                                                             int P, int CI, int F) {
  constexpr int WM = TP / 16, WN = THREADS / 32 / WM;  // warps along pixels x along output channels
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(CI, F, TP);
  uint4* ws = reinterpret_cast<uint4*>(smem_raw);  // [fp][ldw] {hi, lo of W[o][i]; hi, lo of W[o][i+4]}
  float* bs = reinterpret_cast<float*>(ws + (size_t)L.fp * L.ldw);
  float* us = bs + L.fp;
  float* stages = us + L.fp;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int wm = (warp % WM) * 16;
  const int nt = L.fp / 8, nper = (nt + WN - 1) / WN;
  const int n_lo = (warp / WM) * nper, n_hi = min(nt, n_lo + nper);  // this warp's n tiles

  // W in the B-fragment layout: entry (o, 4*ks + t) holds W[o][8ks+t] and
  // W[o][8ks+t+4], each as TF32 hi and lo; zeros past F and CI
  const int half = L.cip / 2;
  for (int e = tid; e < L.fp * half; e += THREADS) {
    const int o = e / half, r = e - o * half, i = 8 * (r / 4) + r % 4;
    const bool row = o < F;
    const Split s0 = split(row && i < CI ? w[(size_t)o * CI + i] : 0.f);
    const Split s1 = split(row && i + 4 < CI ? w[(size_t)o * CI + i + 4] : 0.f);
    ws[o * L.ldw + r] = make_uint4(s0.hi, s0.lo, s1.hi, s1.lo);
  }
  for (int o = tid; o < L.fp; o += THREADS) {
    bs[o] = o < F && bias != nullptr ? bias[o] : 0.f;
    us[o] = o < F ? u[o] : 0.f;
  }
  // x columns CI..cip-1 stay zero: no copy writes them
  if (L.cip > CI) {
    const int pad = L.cip - CI;
    for (int e = tid; e < STAGES * TP * pad; e += THREADS) {
      const int row = e / pad;  // over all stages' x rows
      stages[(row / TP) * L.stage + (row % TP) * L.ldx + CI + e % pad] = 0.f;
    }
  }

  const int tiles = (P + TP - 1) / TP;
  // copies of tile t's x and h rows into stage s (rows past P zero-filled)
  auto issue = [&](int t, int s) {
    if (t < tiles) {
      const int p0 = t * TP, rows = min(TP, P - p0);
      float* xs = stages + s * L.stage;
      float* hs = xs + TP * L.ldx;
      if (X16) {
        const int n = CI / 4;
        Walk k(tid, THREADS, n);
        for (int e = tid; e < TP * n; e += THREADS, k.next()) {
          const bool ok = k.r < rows;
          cp_async16(xs + k.r * L.ldx + 4 * k.q, ok ? x + (size_t)p0 * CI + 4 * e : x, ok);
        }
      } else {
        Walk k(tid, THREADS, CI);
        for (int e = tid; e < TP * CI; e += THREADS, k.next()) {
          const bool ok = k.r < rows;
          cp_async4(xs + k.r * L.ldx + k.q, ok ? x + (size_t)p0 * CI + e : x, ok);
        }
      }
      const int n = F / 4;
      Walk k(tid, THREADS, n);
      for (int e = tid; e < TP * n; e += THREADS, k.next()) {
        const bool ok = k.r < rows;
        cp_async16(hs + k.r * L.ldh + 4 * k.q, ok ? h + (size_t)p0 * F + 4 * e : h, ok);
      }
    }
    cp_async_commit();  // one group per tile, empty past the last: the waits count tiles
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(blockIdx.x + s * gridDim.x, s);

  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int s = i % STAGES;
    __syncthreads();  // W staged; the stage refilled below was stored out by every thread
    issue(t + (STAGES - 1) * gridDim.x, (i + STAGES - 1) % STAGES);
    cp_async_wait<STAGES - 1>();  // this thread's copies of tile t have landed
    __syncthreads();              // and every thread's

    const float* xs = stages + s * L.stage;
    float* hs = stages + s * L.stage + TP * L.ldx;
    for (int c0 = n_lo; c0 < n_hi; c0 += 8) {  // chunks of up to 8 n tiles (64 channels)
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
      for (int kk = 0; kk < L.cip; kk += 8) {
        // A fragments: rows wm+g (+8), columns kk+t4 (+4)
        const float* pa = xs + (wm + g) * L.ldx + kk + t4;
        const Split a[4] = {split(pa[0]), split(pa[8 * L.ldx]), split(pa[4]), split(pa[8 * L.ldx + 4])};
        // B fragments: column (o) 8(c0+n)+g, rows (i) kk+t4 (+4), as
        // {hi, lo, hi, lo}
        const uint4* pb = ws + g * L.ldw + kk / 2 + t4;
        uint4 b[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) b[n] = pb[8 * (c0 + n) * L.ldw];
        // 3xTF32 as three passes over the n tiles (hi*lo, lo*hi, hi*hi), so
        // that consecutive MMAs are independent: mma3 per n tile would issue
        // three dependent ones back to back
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n].y, b[n].w);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[n].x, b[n].z);
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (c0 + n < n_hi) mma_tf32(acc[n], a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[n].x, b[n].z);
      }
      // accumulator register j of n tile n: pixel wm+g (+8 for j >= 2),
      // output channel 8(c0+n)+2*t4+(j&1); h' overwrites h in the stage
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int o = 8 * (c0 + n) + 2 * t4;
        if (c0 + n >= n_hi || o >= F) continue;  // F is even: o < F means o+1 < F
        const float2 bv = *reinterpret_cast<const float2*>(bs + o);
        const float2 uv = *reinterpret_cast<const float2*>(us + o);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2* ph = reinterpret_cast<float2*>(hs + (wm + g + 8 * hf) * L.ldh + o);
          const float2 hv = *ph;
          float v0 = acc[n][2 * hf] + bv.x + uv.x * hv.x;
          float v1 = acc[n][2 * hf + 1] + bv.y + uv.y * hv.y;
          v0 = v0 < 0.f ? 0.f : v0;  // relu that keeps a NaN
          v1 = v1 < 0.f ? 0.f : v1;
          *ph = make_float2(v0, v1);
        }
      }
    }
    __syncthreads();

    // the tile's rows are contiguous in device memory: 16-byte stores
    const int p0 = t * TP, n = F / 4, m = min(TP, P - p0) * n;
    Walk k(tid, THREADS, n);
    for (int e = tid; e < m; e += THREADS, k.next())
      *reinterpret_cast<float4*>(out + (size_t)p0 * F + 4 * e) =
          *reinterpret_cast<const float4*>(hs + k.r * L.ldh + 4 * k.q);
  }
  cp_async_wait<0>();
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, float*, int, int, int);

template <int TP>
Kernel pick(bool x16) {
  return x16 ? &indrnn_f32_kernel<TP, true> : &indrnn_f32_kernel<TP, false>;
}

int launch(const void* x, const void* h, const void* w, const void* bias, const void* u, void* out, int P, int CI,
           int F, int device, void* stream) {
  // the widest pixel tile whose stages and W fit a block's shared memory; at
  // 16 pixels that holds in-channels up to 344, 184 and 88 at 64, 128 and 256
  // out-channels (projects/ uses 64 and 128), and wider cells are refused
  int tp = 64;
  while (tp >= 16 && Layout(CI, F, tp).bytes() > MAX_SMEM) tp /= 2;
  if (tp < 16) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(CI, F, tp).bytes();
  const bool x16 = CI % 4 == 0;
  const Kernel kernel = tp == 64 ? pick<64>(x16) : tp == 32 ? pick<32>(x16) : pick<16>(x16);
  int cap = 0;
  const cudaError_t err = wave((const void*)kernel, THREADS, smem, device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + tp - 1) / tp;
  kernel<<<tiles < cap ? tiles : cap, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)h, (const float*)w, (const float*)bias, (const float*)u, (float*)out, P, CI, F);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---- bfloat16: tensor cores -----------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;  // 4 warps x 16 pixels = one 64-pixel tile
constexpr int MAX_NT = 16;    // F <= 128: n tiles of 8 output channels

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
        mma_bf16(acc[n], a, ld32(pb), ld32(pb + 8));
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
                int CI, int device, void* stream) {
  const size_t smem = (size_t)(NT * 8 + 64) * (CI + 8) * sizeof(bf16);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int cap = 0;
  const cudaError_t err = wave((const void*)indrnn_bf16_kernel<NT>, THREADS, smem, device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + 63) / 64;
  indrnn_bf16_kernel<NT><<<tiles < cap ? tiles : cap, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)h, (const float*)w, (const float*)bias, (const float*)u, (bf16*)out, P, CI);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// ``device`` is the index of the device that owns the stream (the current one)
extern "C" int k3_indrnn_f32(const void* x, const void* h, const void* w, const void* bias, const void* u,
                             void* out, int P, int CI, int F, int device, void* stream) {
  if (P <= 0 || CI <= 0 || F <= 0 || F % 4 != 0 || F > 256) return (int)cudaErrorInvalidValue;
  return f32::launch(x, h, w, bias, u, out, P, CI, F, device, stream);
}

extern "C" int k3_indrnn_bf16(const void* x, const void* h, const void* w, const void* bias, const void* u,
                              void* out, int P, int CI, int F, int device, void* stream) {
  if (P <= 0 || CI <= 0 || CI % 16 != 0 || F <= 0 || F % 8 != 0 || F > 8 * tc::MAX_NT)
    return (int)cudaErrorInvalidValue;
  switch (F / 8) {
#define MRIDC_NT(n) \
  case n:           \
    return tc::launch_bf16<n>(x, h, w, bias, u, out, P, CI, device, stream);
    MRIDC_NT(1) MRIDC_NT(2) MRIDC_NT(3) MRIDC_NT(4) MRIDC_NT(5) MRIDC_NT(6) MRIDC_NT(7) MRIDC_NT(8)
    MRIDC_NT(9) MRIDC_NT(10) MRIDC_NT(11) MRIDC_NT(12) MRIDC_NT(13) MRIDC_NT(14) MRIDC_NT(15) MRIDC_NT(16)
#undef MRIDC_NT
  }
  return (int)cudaErrorInvalidValue;
}
