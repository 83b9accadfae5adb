// K3 backward: the gradients of the IndRNN cell with a 1x1 input kernel.
//
// Stands for the backward that jax.grad takes through
// mridc_tpu/nn/rnn_cells.py:88-109 IndRNNCell.__call__,
//   h'[p, o] = relu(sum_i x[p, i] * W[o, i] + b[o] + u[o] * h[p, o]),
// over the P = B*H*W pixels of channels-last [P, CI] and [P, F] tensors. With
// g' = g * [h' > 0] (the mask read from the saved output, so relu'(0) = 0 as
// in jax.nn.relu):
//   dx = g' W      [P, CI]        dh = u * g'    [P, F]
//   dW = g'^T x    [F, CI]        db = sum_p g'  [F]      du = sum_p h * g'  [F]
//
// What bounds it on an H100: memory. At F = CI = 64 it reads x, h, h' and g
// and writes dx and dh, six [P, 64] tensors (1.9 GB in bf16 at the training
// batch of 24 slices of 320x320), for 4*P*F*CI flops of products.
//
// Design (first version; simple and right before fast):
//   - one fused pass: a persistent grid of blocks walks over tiles of TP
//     pixels. A block stages the tile's x (float32, zero-padded to CI rounded
//     up to 4), g' and h in shared memory beside W, writes dh as it stages,
//     then forms dx = g' W from shared memory (4 x 4 register tiles, CUDA-core
//     FMAs) and adds g'^T x into dW accumulators it keeps in registers for its
//     whole life (NMT 4 x 4 tiles a thread), db and du in a register a channel;
//   - each block writes its partial dW, db and du once, and a second kernel
//     sums the partials over the blocks in block order: the result does not
//     depend on scheduling, so it is the same from run to run;
//   - products and sums run in float32 whatever the storage type, and the
//     bf16 outputs dx and dh are rounded once. mma.sync for the two products
//     is later work.
#include "common.cuh"

using namespace mridc;

namespace {

constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // shared memory a block can opt in to on Hopper
constexpr int MAX_NMT = 8;           // dW register tiles a thread: F * round4(CI) <= 16 * 256 * 8

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// floats of shared memory: W [F][cip], x [TP][cip], g' [TP][F], h [TP][F]
__host__ __device__ inline size_t smem_floats(int CI, int F, int TP) {
  const int cip = round4(CI);
  return (size_t)F * cip + (size_t)TP * cip + 2 * (size_t)TP * F;
}

template <typename T, int NMT>
__global__ void __launch_bounds__(THREADS) indrnn_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ h, const T* __restrict__ hn, const T* __restrict__ g,
    const float* __restrict__ w, const float* __restrict__ u, T* __restrict__ dx, T* __restrict__ dh,
    float* __restrict__ part, int P, int CI, int F, int TP) {
  extern __shared__ __align__(16) float smem[];
  const int cip = round4(CI), c4 = cip / 4;
  float* ws = smem;                        // [F][cip]
  float* xs = ws + (size_t)F * cip;        // [TP][cip]
  float* gs = xs + (size_t)TP * cip;       // [TP][F]
  float* hs = gs + (size_t)TP * F;         // [TP][F]
  const int tid = threadIdx.x;

  for (int e = tid; e < F * cip; e += THREADS) {
    const int o = e / cip, i = e - o * cip;
    ws[e] = i < CI ? w[(size_t)o * CI + i] : 0.f;
  }

  // dW register tiles: tile m = tid + THREADS * k covers W[4*(m / c4) .. +3][4*(m % c4) .. +3]
  const int mtiles = (F / 4) * c4;
  float acc_w[NMT][4][4];
#pragma unroll
  for (int k = 0; k < NMT; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc_w[k][r][c] = 0.f;
  float acc_b = 0.f, acc_u = 0.f;

  const int tiles = (P + TP - 1) / TP;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int p0 = t * TP, rows = min(TP, P - p0);
    __syncthreads();  // W staged; the previous tile's reads of xs, gs and hs are done
    for (int e = tid; e < TP * F; e += THREADS) {
      const int r = e / F, o = e - r * F;
      float gp = 0.f, hv = 0.f;
      if (r < rows) {
        const size_t q = (size_t)(p0 + r) * F + o;
        gp = ld(hn + q) > 0.f ? ld(g + q) : 0.f;
        hv = ld(h + q);
        if (dh != nullptr) st(dh + q, u[o] * gp);
      }
      gs[e] = gp;
      hs[e] = hv;
    }
    for (int e = tid; e < TP * cip; e += THREADS) {
      const int r = e / cip, i = e - r * cip;
      xs[e] = r < rows && i < CI ? ld(x + (size_t)(p0 + r) * CI + i) : 0.f;
    }
    __syncthreads();

    // dx = g' W: 4 pixels x 4 in-channels a register tile
    if (dx != nullptr) {
      for (int m = tid; m < (TP / 4) * c4; m += THREADS) {
        const int pr = 4 * (m / c4), ic = 4 * (m % c4);
        float acc[4][4] = {};
        for (int o = 0; o < F; ++o) {
          const float4 wv = *reinterpret_cast<const float4*>(ws + (size_t)o * cip + ic);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float a = gs[(pr + r) * F + o];
            acc[r][0] += a * wv.x;
            acc[r][1] += a * wv.y;
            acc[r][2] += a * wv.z;
            acc[r][3] += a * wv.w;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (pr + r >= rows) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (ic + c < CI) st(dx + (size_t)(p0 + pr + r) * CI + ic + c, acc[r][c]);
        }
      }
    }

    // dW += g'^T x over the tile's pixels (rows past P are zeros)
#pragma unroll
    for (int k = 0; k < NMT; ++k) {
      const int m = tid + THREADS * k;
      if (m >= mtiles) continue;
      const int oc = 4 * (m / c4), ic = 4 * (m % c4);
      for (int r = 0; r < rows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(gs + r * F + oc);
        const float4 b = *reinterpret_cast<const float4*>(xs + r * cip + ic);
        const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc_w[k][i][j] += av[i] * bv[j];
      }
    }

    // db and du: one channel a thread
    if (tid < F) {
      for (int r = 0; r < rows; ++r) {
        const float gp = gs[r * F + tid];
        acc_b += gp;
        acc_u += hs[r * F + tid] * gp;
      }
    }
  }

  // this block's partials: [F * CI] dW, then [F] db, then [F] du
  float* pb = part + (size_t)blockIdx.x * ((size_t)F * CI + 2 * F);
#pragma unroll
  for (int k = 0; k < NMT; ++k) {
    const int m = tid + THREADS * k;
    if (m >= mtiles) continue;
    const int oc = 4 * (m / c4), ic = 4 * (m % c4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ic + j < CI) pb[(size_t)(oc + i) * CI + ic + j] = acc_w[k][i][j];
  }
  if (tid < F) {
    pb[(size_t)F * CI + tid] = acc_b;
    pb[(size_t)F * CI + F + tid] = acc_u;
  }
}

// out[e] = sum over blocks, in block order, of part[block][e]
__global__ void reduce_partials_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += part[(size_t)k * n + e];
  out[e] = s;
}

// the widest pixel tile (64, 32 or 16) whose shared memory fits; 0 if none
int pick_tp(int CI, int F) {
  for (int tp = 64; tp >= 16; tp /= 2)
    if (smem_floats(CI, F, tp) * 4 <= MAX_SMEM) return tp;
  return 0;
}

template <typename T, int NMT>
int launch_nmt(const void* x, const void* h, const void* hn, const void* g, const void* w, const void* u, void* dx,
               void* dh, void* part, int P, int CI, int F, int TP, int blocks, void* stream) {
  const auto kernel = &indrnn_bwd_kernel<T, NMT>;
  const size_t smem = smem_floats(CI, F, TP) * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>((const T*)x, (const T*)h, (const T*)hn, (const T*)g,
                                                          (const float*)w, (const float*)u, (T*)dx, (T*)dh,
                                                          (float*)part, P, CI, F, TP);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* h, const void* hn, const void* g, const void* w, const void* u, void* dx,
           void* dh, void* part, void* sums, int P, int CI, int F, int blocks, void* stream) {
  if (P <= 0 || CI <= 0 || F <= 0 || F % 4 != 0 || F > THREADS || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int mtiles = (F / 4) * (round4(CI) / 4), tp = pick_tp(CI, F);
  if (tp == 0 || mtiles > THREADS * MAX_NMT) return (int)cudaErrorInvalidValue;
  const int nmt = (mtiles + THREADS - 1) / THREADS;
  int err;
  if (nmt <= 1)
    err = launch_nmt<T, 1>(x, h, hn, g, w, u, dx, dh, part, P, CI, F, tp, blocks, stream);
  else if (nmt <= 2)
    err = launch_nmt<T, 2>(x, h, hn, g, w, u, dx, dh, part, P, CI, F, tp, blocks, stream);
  else if (nmt <= 4)
    err = launch_nmt<T, 4>(x, h, hn, g, w, u, dx, dh, part, P, CI, F, tp, blocks, stream);
  else
    err = launch_nmt<T, 8>(x, h, hn, g, w, u, dx, dh, part, P, CI, F, tp, blocks, stream);
  if (err != 0) return err;
  const int n = F * CI + 2 * F;
  reduce_partials_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>((const float*)part, (float*)sums,
                                                                             blocks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x [P, CI], h, h' (the forward's output) and g [P, F], channels last; W
// [F, CI] and u [F] as float32. Writes dx [P, CI] and dh [P, F] (either may be
// null: not needed) and sums [F*CI + 2F] = (dW, db, du) as float32, through
// part [blocks][F*CI + 2F] of scratch; ``blocks`` is the persistent grid.
extern "C" int k3_indrnn_bwd_f32(const void* x, const void* h, const void* hn, const void* g, const void* w,
                                 const void* u, void* dx, void* dh, void* part, void* sums, int P, int CI, int F,
                                 int blocks, void* stream) {
  return launch<float>(x, h, hn, g, w, u, dx, dh, part, sums, P, CI, F, blocks, stream);
}

extern "C" int k3_indrnn_bwd_bf16(const void* x, const void* h, const void* hn, const void* g, const void* w,
                                  const void* u, void* dx, void* dh, void* part, void* sums, int P, int CI, int F,
                                  int blocks, void* stream) {
  return launch<__nv_bfloat16>(x, h, hn, g, w, u, dx, dh, part, sums, P, CI, F, blocks, stream);
}
