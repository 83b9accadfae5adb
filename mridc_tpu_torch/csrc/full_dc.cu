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
// besides the FFTs.
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
// One thread per element, float32 only: the JAX package runs the full DC in
// float32 whatever dc_dtype says.
#include "common.cuh"

using namespace mridc;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int wrap(int i, int s, int n) {
  i += s;
  return i >= n ? i - n : i;
}

// grid: (ceil(H*W / THREADS), B*C); eta's pixels lie es float2s apart
__global__ void expand_kernel(const float2* __restrict__ eta, const float2* __restrict__ sens,
                              float2* __restrict__ X, int C, int H, int W, int sh_h, int sh_w, int es) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int bc = blockIdx.y, b = bc / C;
  const int i = p / W, j = p - i * W;
  const size_t src = (size_t)wrap(i, sh_h, H) * W + wrap(j, sh_w, W);
  const float2 s = sens[(size_t)bc * H * W + src];
  const float2 e = eta[((size_t)b * H * W + src) * es];
  X[(size_t)bc * H * W + p] = make_float2(e.x * s.x - e.y * s.y, e.x * s.y + e.y * s.x);
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

__global__ void mask_kernel(float2* __restrict__ K, const float* __restrict__ mask, int C, int H, int W, int sh_h,
                            int sh_w) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int bc = blockIdx.y, b = bc / C;
  const int i = p / W, j = p - i * W;
  const float m = mask[(size_t)b * H * W + (size_t)wrap(i, sh_h, H) * W + wrap(j, sh_w, W)];
  float2* k = K + (size_t)bc * H * W + p;
  const float2 kv = *k;
  *k = make_float2(m * kv.x, m * kv.y);
}

__global__ void load_kernel(const float2* __restrict__ y, const float* __restrict__ mask,
                            float2* __restrict__ Q, int C, int H, int W, int sh_h, int sh_w) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= H * W) return;
  const int bc = blockIdx.y, b = bc / C;
  const int i = p / W, j = p - i * W;
  const size_t src = (size_t)wrap(i, sh_h, H) * W + wrap(j, sh_w, W);
  float2 v = y[(size_t)bc * H * W + src];
  if (mask != nullptr) {
    const float m = mask[(size_t)b * H * W + src];
    v = make_float2(m * v.x, m * v.y);
  }
  Q[(size_t)bc * H * W + p] = v;
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

bool bad(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || (long long)B * C > 65535 || (long long)H * W > (1LL << 30);
}

}  // namespace

// eta_stride: float2s from one pixel of eta to the next (1: [B, H, W, 2];
// 2: channels 2:4 of a [B, H, W, 4] gradient, eta pointing at channel 2)
extern "C" int k2_expand(const void* eta, const void* sens, void* X, int B, int C, int H, int W, int sh_h,
                         int sh_w, int eta_stride, void* stream) {
  if (bad(B, C, H, W) || eta_stride < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B * C);
  expand_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float2*)eta, (const float2*)sens,
                                                            (float2*)X, C, H, W, sh_h, sh_w, eta_stride);
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
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B * C);
  load_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const float2*)y, (const float*)mask, (float2*)Q, C,
                                                          H, W, sh_h, sh_w);
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
  if (bad(B, C, H, W) || mask == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks_for((long long)H * W, THREADS), B * C);
  mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((float2*)K, (const float*)mask, C, H, W, sh_h, sh_w);
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
