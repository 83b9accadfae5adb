// K4: the edge pad and the bias-and-activation epilogue around every
// ConvNonlinear conv, forward and backward.
//
// Stands for the chain that XLA fuses around mridc_tpu/nn/layers.py:261-297
// ConvNonlinear.__call__: jnp.pad(x, mode="edge") (:279) into the operand of a
// VALID conv, and the conv's bias with nn.relu or nn.leaky_relu (:280-296) into
// its output fusion (RecurrentVarNet's edge pads too,
// mridc_tpu/models/recon/rvn.py:53,74,97). The conv itself stays cuDNN's. In
// eager PyTorch the pad was five strided slice copies (and under autograd a
// clone of the whole gradient per copy), the bias one more pass after cuDNN
// and the activation another; here each is one read and one write.
//
// Layout: a tensor is [N, H, W, C] with C the fastest axis. A channels_last
// [B, C, H, W] activation is that with N = B; a contiguous one is N = B*C,
// C = 1. The bias and activation kernels take channels_last tensors, [P, C]
// with P = B*H*W pixels.
//
//   k4_edge_pad_{f32,bf16}: out[n, oi, oj] = x[n, clamp(oi - p), clamp(oj - p)],
//     a copy of bytes (both dtypes take the same kernel).
//   k4_edge_pad_bwd_{f32,bf16}: a gather. dx[n, i, j] sums g over the output
//     rows that row i was copied to ([0, p] for i = 0, [H-1+p, H-1+2p] for
//     i = H-1, i + p otherwise; [0, 2p] if H = 1) times the columns j was
//     copied to: one term inside, p+1 on a border, (p+1)^2 at a corner. The
//     sum runs in float32 in row-major order over (output row, output column)
//     and is rounded once; no atomics, so the result is deterministic.
//   k4_bias_act_{f32,bf16}: out = act(round(y + b)), the sum in float32
//     rounded once to the storage type, then relu (s > 0 ? s : 0), leaky relu
//     (s > 0 ? s : 0.01 s, rounded) or none: ATen's add_ and then relu or
//     leaky_relu, bit for bit.
//   k4_bias_act_bwd_{f32,bf16}: g_y = g * act'(out), with the JAX package's
//     gradient at a tie (relu: out > 0; leaky relu: out >= 0 passes g, else
//     0.01 g, rounded), and db = sum over pixels of g_y in float32: one row of
//     partials a block, each block's rows summed by thread in row order and
//     the threads' sums in row-group order, then the blocks' rows summed in
//     block order by a second kernel (as K3's backward does): fixed order,
//     deterministic.
//
// What bounds them on an H100: memory. Each reads its inputs once and writes
// its outputs once (the pad's backward reads a halo entry once more for each
// pixel it was copied from, a share of 4p/W of the bytes); there is no
// arithmetic to speak of. The design: one block per output row for the pad
// (no division per pixel beyond one per vector), a grid-stride loop for the
// epilogue, and 16-byte loads and stores over C wherever the channel width
// and the pointers allow (8, 4 or 2 bytes, or one element, otherwise).
#include <initializer_list>

#include "common.cuh"

using namespace mridc;

namespace {

constexpr int THREADS = 256;
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2;
constexpr float LEAKY_SLOPE = 0.01f;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_f(const T* p, float (&f)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = ld<T>(&pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_f(T* p, const float (&f)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) st<T>(&pk.v[k], f[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// x rounded to the storage type T and read back as float32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  T t;
  st<T>(&t, x);
  return ld<T>(&t);
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// ---- edge pad ----------------------------------------------------------------

// one block per output row (n, oi); R is the unit of the copy, Q units a pixel
template <typename R>
__global__ void __launch_bounds__(THREADS) edge_pad_kernel(const R* __restrict__ x, R* __restrict__ out, int H,
                                                           int W, int Q, int pad) {
  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int row = blockIdx.x;
  const int n = row / Hp, oi = row - n * Hp;
  const R* src = x + ((size_t)n * H + clampi(oi - pad, H - 1)) * W * Q;
  R* dst = out + (size_t)row * Wp * Q;
  const int m = Wp * Q;
  for (int v = threadIdx.x; v < m; v += blockDim.x) {
    const int oj = v / Q, q = v - oj * Q;
    dst[v] = src[clampi(oj - pad, W - 1) * Q + q];
  }
}

// one block per row (n, i) of dx; V elements a vector, Q vectors a pixel
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) edge_pad_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int H,
                                                               int W, int Q, int pad) {
  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int row = blockIdx.x;
  const int n = row / H, i = row - n * H;
  const int r0 = i == 0 ? 0 : i + pad, r1 = i == H - 1 ? H - 1 + 2 * pad : i + pad;
  const T* gn = g + (size_t)n * Hp * Wp * Q * V;
  T* d = dx + (size_t)row * W * Q * V;
  const int m = W * Q;
  for (int v = threadIdx.x; v < m; v += blockDim.x) {
    const int j = v / Q, q = v - j * Q;
    const int c0 = j == 0 ? 0 : j + pad, c1 = j == W - 1 ? W - 1 + 2 * pad : j + pad;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int oi = r0; oi <= r1; ++oi) {
      for (int oj = c0; oj <= c1; ++oj) {
        float f[V];
        load_f<T, V>(gn + (((size_t)oi * Wp + oj) * Q + q) * V, f);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += f[k];
      }
    }
    store_f<T, V>(d + (size_t)v * V, acc);
  }
}

// ---- bias and activation -------------------------------------------------------

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bias_act_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                                                           T* __restrict__ out, int nvec, int Q, int act) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < nvec; k += gridDim.x * blockDim.x) {
    const int c = (k % Q) * V;
    float f[V];
    load_f<T, V>(y + (size_t)k * V, f);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float s = bias != nullptr ? round_to<T>(f[e] + ld<T>(bias + c + e)) : f[e];
      if (act == ACT_RELU) s = s > 0.f || s != s ? s : 0.f;  // NaN passes, as ATen's and XLA's max do
      else if (act == ACT_LEAKY) s = s > 0.f ? s : s * LEAKY_SLOPE;
      f[e] = s;
    }
    store_f<T, V>(out + (size_t)k * V, f);
  }
}

// block b takes rows [b * rpb, (b + 1) * rpb) of P; thread t the vector
// column t % Q of the rows t / Q, t / Q + R, ... (R = blockDim / Q); g_y is
// written where ``gy`` is given, and the block's sums over its rows go to row
// b of ``part`` where that is given
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bias_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out,
                                                               T* __restrict__ gy, float* __restrict__ part, int P,
                                                               int Q, int act, int rpb) {
  extern __shared__ float sums[];  // [R][Q * V]
  const int R = blockDim.x / Q;
  const int t = threadIdx.x, q = t % Q, r = t / Q;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  const int row0 = blockIdx.x * rpb, row1 = min(P, row0 + rpb);
  if (r < R) {
    for (int row = row0 + r; row < row1; row += R) {
      const size_t off = ((size_t)row * Q + q) * V;
      float gv[V];
      load_f<T, V>(g + off, gv);
      if (act != ACT_NONE) {
        float ov[V];
        load_f<T, V>(out + off, ov);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          if (act == ACT_RELU) gv[e] = ov[e] > 0.f ? gv[e] : 0.f;
          else gv[e] = ov[e] >= 0.f ? gv[e] : round_to<T>(gv[e] * LEAKY_SLOPE);
        }
      }
      if (gy != nullptr) store_f<T, V>(gy + off, gv);
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] += gv[e];
    }
  }
  if (part == nullptr) return;
  const int C = Q * V;
  if (r < R) {
#pragma unroll
    for (int e = 0; e < V; ++e) sums[r * C + q * V + e] = acc[e];
  }
  __syncthreads();
  for (int c = t; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < R; ++k) s += sums[k * C + c];
    part[(size_t)blockIdx.x * C + c] = s;
  }
}

__global__ void bias_grad_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int blocks, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < blocks; ++k) s += part[(size_t)k * n + e];
  out[e] = s;
}

// ---- launchers -------------------------------------------------------------------

// the widest copy unit (16, 8, 4 or 2 bytes) that divides ``bytes`` and to
// which every pointer is aligned; ``unit`` bytes at the least
int vector_bytes(long long bytes, int unit, std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= (uintptr_t)p;
  for (int vb = 16; vb > unit; vb /= 2)
    if (bytes % vb == 0 && any % vb == 0) return vb;
  return unit;
}

int threads_for(long long units) { return units >= THREADS ? THREADS : (int)((units + 31) / 32 * 32); }

int edge_pad(const void* x, void* out, int N, int H, int W, int C, int pad, int elt, cudaStream_t st) {
  const long long row = (long long)C * elt;
  const long long Hp = H + 2LL * pad, Wp = W + 2LL * pad;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || pad < 0 || N * Hp > 0x7fffffffLL || N * Hp * Wp * row > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  const int vb = vector_bytes(row, elt, {x, out});
  const int Q = (int)(row / vb);
  if (Wp * Q > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(N * Hp));
  const int threads = threads_for(Wp * Q);
  switch (vb) {
    case 16: edge_pad_kernel<uint4><<<grid, threads, 0, st>>>((const uint4*)x, (uint4*)out, H, W, Q, pad); break;
    case 8: edge_pad_kernel<uint2><<<grid, threads, 0, st>>>((const uint2*)x, (uint2*)out, H, W, Q, pad); break;
    case 4:
      edge_pad_kernel<unsigned int><<<grid, threads, 0, st>>>((const unsigned int*)x, (unsigned int*)out, H, W, Q,
                                                               pad);
      break;
    default:
      edge_pad_kernel<unsigned short><<<grid, threads, 0, st>>>((const unsigned short*)x, (unsigned short*)out, H,
                                                                 W, Q, pad);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int edge_pad_bwd(const T* g, T* dx, int N, int H, int W, int C, int pad, cudaStream_t st) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || pad < 0 || (long long)N * H > 0x7fffffffLL ||
      (long long)W * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vb = vector_bytes((long long)C * sizeof(T), sizeof(T), {g, dx});
  const int V = vb / (int)sizeof(T), Q = C / V;
  const dim3 grid((unsigned)((long long)N * H));
  const int threads = threads_for((long long)W * Q);
  switch (V) {
    case 8: edge_pad_bwd_kernel<T, 8><<<grid, threads, 0, st>>>(g, dx, H, W, Q, pad); break;
    case 4: edge_pad_bwd_kernel<T, 4><<<grid, threads, 0, st>>>(g, dx, H, W, Q, pad); break;
    case 2: edge_pad_bwd_kernel<T, 2><<<grid, threads, 0, st>>>(g, dx, H, W, Q, pad); break;
    default: edge_pad_bwd_kernel<T, 1><<<grid, threads, 0, st>>>(g, dx, H, W, Q, pad);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bias_act(const T* y, const T* bias, T* out, int P, int C, int act, cudaStream_t st) {
  if (P <= 0 || C <= 0 || act < ACT_NONE || act > ACT_LEAKY || (long long)P * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vb = vector_bytes((long long)C * sizeof(T), sizeof(T), {y, out});
  const int V = vb / (int)sizeof(T), Q = C / V;
  const int nvec = P * Q;
  const long long want = ((long long)nvec + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 8192 ? want : 8192);
  const int threads = threads_for(nvec);
  switch (V) {
    case 8: bias_act_kernel<T, 8><<<blocks, threads, 0, st>>>(y, bias, out, nvec, Q, act); break;
    case 4: bias_act_kernel<T, 4><<<blocks, threads, 0, st>>>(y, bias, out, nvec, Q, act); break;
    case 2: bias_act_kernel<T, 2><<<blocks, threads, 0, st>>>(y, bias, out, nvec, Q, act); break;
    default: bias_act_kernel<T, 1><<<blocks, threads, 0, st>>>(y, bias, out, nvec, Q, act);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bias_act_bwd(const T* g, const T* out, T* gy, float* part, float* db, int P, int C, int act, int blocks,
                 cudaStream_t st) {
  if (P <= 0 || C <= 0 || act < ACT_NONE || act > ACT_LEAKY || blocks <= 0 || (long long)P * C > 0x7fffffffLL ||
      (act != ACT_NONE && (out == nullptr || gy == nullptr)) || ((part == nullptr) != (db == nullptr)) ||
      (gy == nullptr && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int vb = vector_bytes((long long)C * sizeof(T), sizeof(T), {g, out, gy});
  const int V = vb / (int)sizeof(T), Q = C / V;
  if (Q > THREADS) return (int)cudaErrorInvalidValue;
  const int rpb = (int)(((long long)P + blocks - 1) / blocks);
  const size_t smem = (size_t)(THREADS / Q) * C * sizeof(float);
  switch (V) {
    case 8: bias_act_bwd_kernel<T, 8><<<blocks, THREADS, smem, st>>>(g, out, gy, part, P, Q, act, rpb); break;
    case 4: bias_act_bwd_kernel<T, 4><<<blocks, THREADS, smem, st>>>(g, out, gy, part, P, Q, act, rpb); break;
    case 2: bias_act_bwd_kernel<T, 2><<<blocks, THREADS, smem, st>>>(g, out, gy, part, P, Q, act, rpb); break;
    default: bias_act_bwd_kernel<T, 1><<<blocks, THREADS, smem, st>>>(g, out, gy, part, P, Q, act, rpb);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  bias_grad_sum_kernel<<<blocks_for(C, THREADS), THREADS, 0, st>>>(part, db, blocks, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, C] -> out [N, H + 2 pad, W + 2 pad, C]
extern "C" int k4_edge_pad_f32(const void* x, void* out, int N, int H, int W, int C, int pad, void* stream) {
  return edge_pad(x, out, N, H, W, C, pad, 4, (cudaStream_t)stream);
}

extern "C" int k4_edge_pad_bf16(const void* x, void* out, int N, int H, int W, int C, int pad, void* stream) {
  return edge_pad(x, out, N, H, W, C, pad, 2, (cudaStream_t)stream);
}

// g [N, H + 2 pad, W + 2 pad, C] -> dx [N, H, W, C]
extern "C" int k4_edge_pad_bwd_f32(const void* g, void* dx, int N, int H, int W, int C, int pad, void* stream) {
  return edge_pad_bwd<float>((const float*)g, (float*)dx, N, H, W, C, pad, (cudaStream_t)stream);
}

extern "C" int k4_edge_pad_bwd_bf16(const void* g, void* dx, int N, int H, int W, int C, int pad, void* stream) {
  return edge_pad_bwd<__nv_bfloat16>((const __nv_bfloat16*)g, (__nv_bfloat16*)dx, N, H, W, C, pad,
                                     (cudaStream_t)stream);
}

// y [P, C], bias [C] (or null) -> out [P, C]; act 0 none, 1 relu, 2 leaky relu
extern "C" int k4_bias_act_f32(const void* y, const void* bias, void* out, int P, int C, int act, void* stream) {
  return bias_act<float>((const float*)y, (const float*)bias, (float*)out, P, C, act, (cudaStream_t)stream);
}

extern "C" int k4_bias_act_bf16(const void* y, const void* bias, void* out, int P, int C, int act, void* stream) {
  return bias_act<__nv_bfloat16>((const __nv_bfloat16*)y, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, P, C,
                                 act, (cudaStream_t)stream);
}

// g, out [P, C] -> g_y [P, C] (null: not written, act must then be none) and,
// with part [blocks, C] and db [C] (both or neither), db in float32
extern "C" int k4_bias_act_bwd_f32(const void* g, const void* out, void* gy, void* part, void* db, int P, int C,
                                   int act, int blocks, void* stream) {
  return bias_act_bwd<float>((const float*)g, (const float*)out, (float*)gy, (float*)part, (float*)db, P, C, act,
                             blocks, (cudaStream_t)stream);
}

extern "C" int k4_bias_act_bwd_bf16(const void* g, const void* out, void* gy, void* part, void* db, int P, int C,
                                    int act, int blocks, void* stream) {
  return bias_act_bwd<__nv_bfloat16>((const __nv_bfloat16*)g, (const __nv_bfloat16*)out, (__nv_bfloat16*)gy,
                                     (float*)part, (float*)db, P, C, act, blocks, (cudaStream_t)stream);
}
