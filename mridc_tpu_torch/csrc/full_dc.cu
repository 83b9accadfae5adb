// K2: the full-mask likelihood gradient of one RIM step, forward and backward,
// as stages around cuFFT.
//
// Stands for mridc_tpu/nn/dc.py:81-101 log_likelihood_gradient
//   pred_k = fftshift(FFT2(ifftshift(s_c * eta)))
//   r_c    = fftshift(IFFT2(ifftshift(m * (pred_k - y))))
//   out    = [eta, sum_c conj(s_c) * r_c / sigma^2]
// and, through the load and reduce stages, for sens_reduce (:59-71), the SENSE
// init and the psf1d data term z0. The two transforms stay with cuFFT
// (torch.fft on complex64), as the JAX package leaves them to XLA.
//
// What bounds it on an H100: memory. Each stage streams coil tensors once:
// about 91 MB of elementwise traffic per slice per step at 15 coils and 320x320,
// besides the FFTs. At B=8 one coil tensor is 98.3 MB, twice the 50 MB L2, so
// every coil stream comes from and goes to HBM; eta, g and the mask (one
// [B, H, W] plane, 1/15 of a coil tensor's traffic) are reused by every coil.
//
// Design: the centering shifts never become copies. With sh = n/2 on a centered
// axis (0 otherwise), ifftshift reads index (i + sh) mod n and fftshift reads
// (i + n - sh) mod n.
//   (a) expand:   X[c, i] = s_c[ifs(i)] * eta[ifs(i)]  -- the input ifftshift folded
//                 into the read index; X feeds the forward FFT.
//   (b) residual: K[c, k] = m[ifs(k)] * (K[c, k] - y_c[ifs(k)]) in place on the FFT
//                 output. The output fftshift of the forward transform and the
//                 input ifftshift of the inverse cancel exactly for any n, so m
//                 and y are read at the shifted index and K at its own.
//   (load)        Q[c, k] = m[ifs(k)] * y_c[ifs(k)] (m optional): the shifted,
//                 masked k-space that feeds a lone inverse FFT (sens_reduce).
//   (c) reduce:   out[i] = sum_c conj(s_c[i]) * P[c, fs(i)] / sigma^2 with the
//                 output fftshift folded into the read index, written as
//                 [eta, grad] or, without eta, as grad alone.
// Backward. The map eta -> grad is S^H F^-1 M F S / sigma^2, Hermitian in every
// normalisation and centering mode, so for an upstream g [B, H, W, 4] the
// eta-gradient is g[..., :2] + S^H F^-1 M F S g[..., 2:] / sigma^2: the chain
// with y = 0.
//   (a) expand reads g's channels 2:4 in place (eta_stride 2 in float2s);
//   (mask)        K[c, k] *= m[ifs(k)] in place on the FFT output;
//   (reduce_acc)  out[i] = g[i, :2] + sum_c conj(s_c[i]) * P[c, fs(i)] / sigma^2,
//                 [B, H, W, 2].
// Expand, load and mask: one thread takes one pixel of one row of one example
// (rows and columns from a 2D grid, no division), holds eta's (or the mask's)
// pixel in a register and walks a group of COILS_PER_THREAD coils, issuing
// UNROLL coil loads before the first is used: 8 bytes a coil, 24 in flight a
// thread. Mask works in place on one pointer: a group's loads, then its stores.
// eta and the mask are read through the read-only path (__ldg). The coil
// tensors keep the default cache policy: at the configs' B=1 a coil tensor
// (12.3 MB) stays in L2 for the FFT or reduce that reads it next. Streaming
// hints (ld/st.global.cs), tried, sped some of the chains around these stages
// and slowed others, at B=1 and at B=8 (tools/torch_k2_variants.py). Each
// output element is one complex product (expand) or one real-times-complex
// product (load, mask), the products of their plain versions in
// kernels/k2_full_dc.py: a multiply, not a select, so that a NaN or an inf of
// the k-space stays one under a zero of the mask, as in the JAX package.
// Residual and both reduces are one thread per element. Float32 only: the JAX
// package runs the full DC in float32 whatever dc_dtype says.
//
// The maps' gradient (learned sensitivity maps; it replaces no TPU kernel: the
// JAX package leaves it to XLA's autodiff of nn/dc.py). For an upstream of
// the chain, each coil's gradient is one or two products of a coil image that
// the chain already formed with the conjugate of an image-sized tensor:
//   (sens_grad)   ds_c[i] = scale * (A_c[fs(i)] * conj(b[i]) + A'_c[fs(i)] * conj(b'[i]))
//                 and, with the maps given, sum[i] = acc[i] + scale * sum_c conj(s_c[i]) * A_c[fs(i)]
// (A, A': inverse-FFT outputs read at the fftshifted index, as reduce reads
// them; b, b', acc: pixels eta_stride float2s apart, so g's channels are read
// in place). full_dc: A = F^-1 M F(s g[..., 2:]) (the d_eta chain's), b = eta,
// A' = the forward's residual image (recomputed), b' = g[..., 2:], acc = g,
// scale 1 / sigma^2: d_eta and the maps' gradient in one pass. sens_expand:
// A = F^H(M g), b = x, the sum is d_x. sens_reduce: A = F^-1(M k), b = g, no
// sum. normal_op: as full_dc with y = 0 and no acc. One thread a pixel walks
// the coils; memory-bound like the stages above: per coil and pixel A, A', s
// in and ds out (32 bytes).
#include "common.cuh"

using namespace mridc;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int wrap(int i, int s, int n) {
  i += s;
  return i >= n ? i - n : i;
}

// ---- expand, load and mask: one pixel of a row a thread, a group of coils ----

constexpr int TX = 32, TY = 8;       // block: TX pixels of a row by TY rows
constexpr int COILS_PER_THREAD = 3;  // the coil group a thread walks
constexpr int UNROLL = 3;            // coil loads issued before the first is used

// out[c] = op(in[c]) for the n coils from in and out, HW float2s apart
template <typename Op>
__device__ __forceinline__ void coil_run(const float2* __restrict__ in, float2* __restrict__ out, size_t HW, int n,
                                         Op op) {
  for (int c = 0; c < n; c += UNROLL) {
    float2 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u < n) v[u] = in[(size_t)(c + u) * HW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u < n) out[(size_t)(c + u) * HW] = op(v[u]);
  }
}

// io[c] = op(io[c]) in place for the n coils from io, HW float2s apart: a
// group's loads, then its stores (coil_run's in and out are __restrict__, and
// one tensor passed as both would alias them)
template <typename Op>
__device__ __forceinline__ void coil_run_in_place(float2* __restrict__ io, size_t HW, int n, Op op) {
  for (int c = 0; c < n; c += UNROLL) {
    float2 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u < n) v[u] = io[(size_t)(c + u) * HW];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (c + u < n) io[(size_t)(c + u) * HW] = op(v[u]);
  }
}

// a thread's work: pixel (i, j) of example b, coils c0 .. c0 + COILS_PER_THREAD
// - 1 (fewer in the last group)
struct Unit {
  int b, c0, i, j;
};

// grid: (ceil(W / TX), ceil(H / TY), B * groups), block (TX, TY); false past the edge
__device__ __forceinline__ bool unit_of(int H, int W, int groups, Unit* u) {
  u->j = blockIdx.x * TX + threadIdx.x;
  u->i = blockIdx.y * TY + threadIdx.y;
  u->b = blockIdx.z / groups;
  u->c0 = (blockIdx.z - u->b * groups) * COILS_PER_THREAD;
  return u->i < H && u->j < W;
}

// X[b, c, i, j] = s[b, c, ifs(i, j)] * eta[b, ifs(i, j)] over unit u; eta's pixels lie es float2s apart
__device__ __forceinline__ void expand_unit(const Unit& u, const float2* __restrict__ eta,
                                            const float2* __restrict__ sens, float2* __restrict__ X, int C, int H,
                                            int W, int sh_h, int sh_w, int es) {
  const size_t HW = (size_t)H * W, src = (size_t)wrap(u.i, sh_h, H) * W + wrap(u.j, sh_w, W);
  const float2 e = __ldg(eta + ((size_t)u.b * HW + src) * es);
  const size_t plane = ((size_t)u.b * C + u.c0) * HW;
  coil_run(sens + plane + src, X + plane + (size_t)u.i * W + u.j, HW, min(C - u.c0, COILS_PER_THREAD),
           [&](float2 s) { return make_float2(e.x * s.x - e.y * s.y, e.x * s.y + e.y * s.x); });
}

__global__ void __launch_bounds__(TX * TY) expand_kernel(const float2* __restrict__ eta,
                                                         const float2* __restrict__ sens, float2* __restrict__ X,
                                                         int C, int H, int W, int sh_h, int sh_w, int es,
                                                         int groups) {
  Unit u;
  if (unit_of(H, W, groups, &u)) expand_unit(u, eta, sens, X, C, H, W, sh_h, sh_w, es);
}

__global__ void residual_kernel(float2* __restrict__ K, const float2* __restrict__ y,
                                const float* __restrict__ mask, int C, int H, int W, int sh_h, int sh_w) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int bc = blockIdx.y, b = bc / C;
  const int i = p / W, j = p - i * W;
  const size_t src = (size_t)wrap(i, sh_h, H) * W + wrap(j, sh_w, W);
  const float m = mask[(size_t)b * H * W + src];
  const float2 yv = y[(size_t)bc * H * W + src];
  float2* k = K + (size_t)bc * H * W + p;
  const float2 kv = *k;
  *k = make_float2(m * (kv.x - yv.x), m * (kv.y - yv.y));
}

// Q[b, c, i, j] = m[b, ifs(i, j)] * y[b, c, ifs(i, j)] over unit u, or the shifted copy without a mask
__device__ __forceinline__ void load_unit(const Unit& u, const float2* __restrict__ y, const float* __restrict__ mask,
                                          float2* __restrict__ Q, int C, int H, int W, int sh_h, int sh_w) {
  const size_t HW = (size_t)H * W, src = (size_t)wrap(u.i, sh_h, H) * W + wrap(u.j, sh_w, W);
  const size_t plane = ((size_t)u.b * C + u.c0) * HW;
  const float2* in = y + plane + src;
  float2* out = Q + plane + (size_t)u.i * W + u.j;
  const int n = min(C - u.c0, COILS_PER_THREAD);
  if (mask == nullptr) {
    coil_run(in, out, HW, n, [](float2 q) { return q; });
    return;
  }
  const float m = __ldg(mask + (size_t)u.b * HW + src);
  coil_run(in, out, HW, n, [&](float2 q) { return make_float2(m * q.x, m * q.y); });
}

__global__ void __launch_bounds__(TX * TY) load_kernel(const float2* __restrict__ y, const float* __restrict__ mask,
                                                       float2* __restrict__ Q, int C, int H, int W, int sh_h,
                                                       int sh_w, int groups) {
  Unit u;
  if (unit_of(H, W, groups, &u)) load_unit(u, y, mask, Q, C, H, W, sh_h, sh_w);
}

// K[b, c, i, j] *= m[b, ifs(i, j)] in place over unit u
__device__ __forceinline__ void mask_unit(const Unit& u, float2* __restrict__ K, const float* __restrict__ mask, int C,
                                          int H, int W, int sh_h, int sh_w) {
  const size_t HW = (size_t)H * W, src = (size_t)wrap(u.i, sh_h, H) * W + wrap(u.j, sh_w, W);
  const float m = __ldg(mask + (size_t)u.b * HW + src);
  coil_run_in_place(K + ((size_t)u.b * C + u.c0) * HW + (size_t)u.i * W + u.j, HW, min(C - u.c0, COILS_PER_THREAD),
                    [&](float2 k) { return make_float2(m * k.x, m * k.y); });
}

__global__ void __launch_bounds__(TX * TY) mask_kernel(float2* __restrict__ K, const float* __restrict__ mask, int C,
                                                       int H, int W, int sh_h, int sh_w, int groups) {
  Unit u;
  if (unit_of(H, W, groups, &u)) mask_unit(u, K, mask, C, H, W, sh_h, sh_w);
}

// sum_c conj(s_c[p]) * P[c, fs(p)] / sigma^2 of example b
__device__ __forceinline__ float2 coil_sum(const float2* __restrict__ P, const float2* __restrict__ sens, int b,
                                           int C, int H, int W, int p, int sh_h, int sh_w, float inv_sigma2) {
  const int i = p / W, j = p - i * W;
  const size_t src = (size_t)wrap(i, H - sh_h, H) * W + wrap(j, W - sh_w, W);
  const size_t HW = (size_t)H * W;
  float gr = 0.f, gi = 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t base = ((size_t)b * C + c) * HW;
    const float2 r = P[base + src];
    const float2 s = sens[base + p];
    gr += r.x * s.x + r.y * s.y;
    gi += r.y * s.x - r.x * s.y;
  }
  return make_float2(gr * inv_sigma2, gi * inv_sigma2);
}

// grid: (ceil(H*W / THREADS), B)
__global__ void reduce_kernel(const float2* __restrict__ P, const float2* __restrict__ sens,
                              const float2* __restrict__ eta, float* __restrict__ out, int C, int H, int W,
                              int sh_h, int sh_w, float inv_sigma2) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int b = blockIdx.y;
  const size_t HW = (size_t)H * W;
  const float2 gs = coil_sum(P, sens, b, C, H, W, p, sh_h, sh_w, inv_sigma2);
  const float gr = gs.x, gi = gs.y;
  if (eta != nullptr) {
    const float2 e = eta[(size_t)b * HW + p];
    reinterpret_cast<float4*>(out)[(size_t)b * HW + p] = make_float4(e.x, e.y, gr, gi);
  } else {
    reinterpret_cast<float2*>(out)[(size_t)b * HW + p] = make_float2(gr, gi);
  }
}

__global__ void reduce_acc_kernel(const float2* __restrict__ P, const float2* __restrict__ sens,
                                  const float4* __restrict__ g, float2* __restrict__ out, int C, int H, int W,
                                  int sh_h, int sh_w, float inv_sigma2) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int b = blockIdx.y;
  const size_t o = (size_t)b * H * W + p;
  const float2 gs = coil_sum(P, sens, b, C, H, W, p, sh_h, sh_w, inv_sigma2);
  const float4 gv = g[o];
  out[o] = make_float2(gv.x + gs.x, gv.y + gs.y);
}

// grid: (ceil(H*W / THREADS), B); a2/b2, sens/sum and acc optional (null)
__global__ void sens_grad_kernel(const float2* __restrict__ A, const float2* __restrict__ bv, int bs,
                                 const float2* __restrict__ A2, const float2* __restrict__ b2v, int b2s,
                                 const float2* __restrict__ sens, const float2* __restrict__ acc, int acc_s,
                                 float2* __restrict__ ds, float2* __restrict__ sum, int C, int H, int W, int sh_h,
                                 int sh_w, float scale) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int b = blockIdx.y;
  const int i = p / W, j = p - i * W;
  const size_t HW = (size_t)H * W, o = (size_t)b * HW + p;
  const size_t src = (size_t)wrap(i, H - sh_h, H) * W + wrap(j, W - sh_w, W);
  const float2 e = bv[o * bs];
  const float2 e2 = A2 != nullptr ? b2v[o * b2s] : make_float2(0.f, 0.f);
  float gr = 0.f, gi = 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t base = ((size_t)b * C + c) * HW;
    const float2 a = A[base + src];
    // a * conj(e) [+ a2 * conj(e2)]
    float dr = a.x * e.x + a.y * e.y, di = a.y * e.x - a.x * e.y;
    if (A2 != nullptr) {
      const float2 a2 = A2[base + src];
      dr += a2.x * e2.x + a2.y * e2.y;
      di += a2.y * e2.x - a2.x * e2.y;
    }
    ds[base + p] = make_float2(dr * scale, di * scale);
    if (sens != nullptr) {
      const float2 s = sens[base + p];
      gr += a.x * s.x + a.y * s.y;
      gi += a.y * s.x - a.x * s.y;
    }
  }
  if (sum == nullptr) return;
  float2 out = make_float2(gr * scale, gi * scale);
  if (acc != nullptr) {
    const float2 av = acc[o * acc_s];
    out.x += av.x;
    out.y += av.y;
  }
  sum[o] = out;
}

bool bad(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || (long long)B * C > 65535 || (long long)H * W > (1LL << 30);
}

// expand's, load's and mask's grid and coil groups, or false where the operands do not fit it
bool unit_grid(int B, int C, int H, int W, int sh_h, int sh_w, dim3* grid, int* groups) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || (long long)H * W > (1LL << 30)) return false;
  if (sh_h < 0 || sh_h >= H || sh_w < 0 || sh_w >= W) return false;
  *groups = (C + COILS_PER_THREAD - 1) / COILS_PER_THREAD;
  const long long gx = ((long long)W + TX - 1) / TX, gy = ((long long)H + TY - 1) / TY, gz = (long long)B * *groups;
  if (gy > 65535 || gz > 65535) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)gz);
  return true;
}

}  // namespace

// eta_stride: float2s from one pixel of eta to the next (1: [B, H, W, 2];
// 2: channels 2:4 of a [B, H, W, 4] gradient, eta pointing at channel 2)
extern "C" int k2_expand(const void* eta, const void* sens, void* X, int B, int C, int H, int W, int sh_h,
                         int sh_w, int eta_stride, void* stream) {
  dim3 grid;
  int groups = 0;
  if (eta_stride < 1 || !unit_grid(B, C, H, W, sh_h, sh_w, &grid, &groups)) return (int)cudaErrorInvalidValue;
  expand_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>((const float2*)eta, (const float2*)sens, (float2*)X,
                                                                 C, H, W, sh_h, sh_w, eta_stride, groups);
  return (int)cudaGetLastError();
}

extern "C" int k2_residual(void* K, const void* y, const void* mask, int B, int C, int H, int W, int sh_h,
                           int sh_w, void* stream) {
  if (bad(B, C, H, W) || mask == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B * C);
  residual_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((float2*)K, (const float2*)y, (const float*)mask,
                                                              C, H, W, sh_h, sh_w);
  return (int)cudaGetLastError();
}

extern "C" int k2_load(const void* y, const void* mask, void* Q, int B, int C, int H, int W, int sh_h, int sh_w,
                       void* stream) {
  dim3 grid;
  int groups = 0;
  if (!unit_grid(B, C, H, W, sh_h, sh_w, &grid, &groups)) return (int)cudaErrorInvalidValue;
  load_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>((const float2*)y, (const float*)mask, (float2*)Q, C, H,
                                                               W, sh_h, sh_w, groups);
  return (int)cudaGetLastError();
}

extern "C" int k2_reduce(const void* P, const void* sens, const void* eta, void* out, int B, int C, int H, int W,
                         int sh_h, int sh_w, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B);
  reduce_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float2*)P, (const float2*)sens,
                                                            (const float2*)eta, (float*)out, C, H, W, sh_h,
                                                            sh_w, inv_sigma2);
  return (int)cudaGetLastError();
}

extern "C" int k2_mask(void* K, const void* mask, int B, int C, int H, int W, int sh_h, int sh_w, void* stream) {
  dim3 grid;
  int groups = 0;
  if (mask == nullptr || !unit_grid(B, C, H, W, sh_h, sh_w, &grid, &groups)) return (int)cudaErrorInvalidValue;
  mask_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>((float2*)K, (const float*)mask, C, H, W, sh_h, sh_w,
                                                               groups);
  return (int)cudaGetLastError();
}

// g [B, H, W, 4] -> out [B, H, W, 2]
extern "C" int k2_reduce_acc(const void* P, const void* sens, const void* g, void* out, int B, int C, int H, int W,
                             int sh_h, int sh_w, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B);
  reduce_acc_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float2*)P, (const float2*)sens,
                                                                (const float4*)g, (float2*)out, C, H, W, sh_h,
                                                                sh_w, inv_sigma2);
  return (int)cudaGetLastError();
}

// A [B, C, H, W] complex (FFT order), b (pixels b_stride float2s apart), A2/b2
// optional, sens [B, C, H, W, 2] and sum [B, H, W, 2] optional together, acc
// optional (acc_stride float2s a pixel) -> ds [B, C, H, W, 2] (and sum)
extern "C" int k2_sens_grad(const void* A, const void* b, int b_stride, const void* A2, const void* b2, int b2_stride,
                            const void* sens, const void* acc, int acc_stride, void* ds, void* sum, int B, int C,
                            int H, int W, int sh_h, int sh_w, float scale, void* stream) {
  if (bad(B, C, H, W) || A == nullptr || b == nullptr || ds == nullptr || b_stride < 1 ||
      (A2 != nullptr && (b2 == nullptr || b2_stride < 1)) || ((sens == nullptr) != (sum == nullptr)) ||
      (acc != nullptr && (sum == nullptr || acc_stride < 1)) || sh_h < 0 || sh_h >= H || sh_w < 0 || sh_w >= W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B);
  sens_grad_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float2*)A, (const float2*)b, b_stride, (const float2*)A2, (const float2*)b2, b2_stride,
      (const float2*)sens, (const float2*)acc, acc_stride, (float2*)ds, (float2*)sum, C, H, W, sh_h, sh_w, scale);
  return (int)cudaGetLastError();
}
