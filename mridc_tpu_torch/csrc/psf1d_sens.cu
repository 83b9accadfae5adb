// K1's maps gradient: the gradient of the psf1d likelihood gradient with
// respect to the coil sensitivity maps, and d_eta in the same pass.
//
// It replaces no TPU kernel: the JAX package differentiates
// mridc_tpu/nn/dc.py:162-179 log_likelihood_gradient_psf1d (with apply_psf1d
// :144-159) with XLA's autodiff, which the learned sensitivity maps
// (mridc_tpu/nn/sens.py) need. With G = g[..., 2:] / sigma^2 for an upstream
// g [B, H, W, 4] of out = [eta, (sum_c conj(s_c) A(s_c eta) - z0) / sigma^2],
// A the Hermitian [W, W] operator of psf1d_gauss_mats along W:
//   u_c   = A(s_c eta),   v_c = A(s_c g[..., 2:])
//   ds_c  = (u_c * conj(g[..., 2:]) + v_c * conj(eta)) / sigma^2   [B, C, H, W, 2]
//   d_eta = g[..., :2] + sum_c conj(s_c) v_c / sigma^2             [B, H, W, 2]
// d_eta is what K1's backward kernel writes; here it comes from the same v_c,
// so a step whose maps take a gradient launches this kernel instead of that
// one, and the operator is read once for both.
//
// What bounds it on an H100: operations. Two complex [W, W] products per coil
// row in the Gauss form (three real products each): 12 * C * H * W^2 per
// slice, 4.7e10 at B=8, 15 coils and 320x320, against ~0.4 GB of traffic.
//
// Design (a first, simple version on the CUDA cores, float32 accumulation):
// one block of 256 threads takes 32 rows h by 64 columns u of one example and
// walks the coils; for each coil it walks v in chunks of 16, staging the
// three operator planes [64 u x 16 v] (read again for every coil, from L2)
// and x = s_c eta, y = s_c g[..., 2:4] for its rows, formed in float32 from
// the operands and kept in the Gauss planes (re + im, im, re), in shared
// memory. A thread holds 2 rows by 4 columns: per v it reads three float4 of
// the operator and three float2 of each of x and y (broadcast across the
// warp) for 48 FMAs, so that shared-memory reads and FMAs roughly balance.
// The coil epilogue writes ds_c and adds conj(s_c) v_c into d_eta's sums in
// registers, in coil order: no atomics, the same result from run to run.
// Float32 and bfloat16 operands (one template), any H and W; the tensor-core
// version (K1's tiles with the operator kept on chip across the coils) is
// later work.
#include "common.cuh"

using namespace mridc;

namespace {

constexpr int TR = 32;       // rows h a block
constexpr int TU = 64;       // output columns u a block
constexpr int TK = 16;       // v a staged chunk
constexpr int THREADS = 256;  // 16 column groups x 16 row pairs
constexpr int RPT = 2;       // rows a thread
constexpr int CPT = 4;       // columns a thread (one float4 of each operator plane)
constexpr int CU = TU + 4;   // padded operator row: the transposing stores hit 2 banks at most
constexpr int CR = TR + 2;   // padded x/y row

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sens_kernel(const T* __restrict__ g, const T* __restrict__ eta, const T* __restrict__ sens,
                const T* __restrict__ mats, T* __restrict__ ds, T* __restrict__ d_eta, int C, int H, int W,
                float inv_sigma2) {
  __shared__ __align__(16) float Cs[3][TK][CU];  // operator planes (Cr, Cr + Ci, Ci - Cr) as [v][u]
  __shared__ __align__(16) float Xs[3][TK][CR];  // x = s_c eta as (xr + xi, xi, xr), [v][h]
  __shared__ __align__(16) float Ys[3][TK][CR];  // y = s_c g[..., 2:4] likewise
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h0 = blockIdx.y * TR, u0 = blockIdx.x * TU;
  const size_t HW = (size_t)H * W;
  const T* mats_b = mats + (size_t)b * 3 * W * W;
  const T* eta_b = eta + (size_t)b * HW * 2;
  const T* g_b = g + (size_t)b * HW * 4;
  float de[RPT][CPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) de[i][j][0] = de[i][j][1] = 0.f;

  for (int c = 0; c < C; ++c) {
    const T* s_c = sens + ((size_t)b * C + c) * HW * 2;
    float ax[3][RPT][CPT], ay[3][RPT][CPT];
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) ax[p][i][j] = ay[p][i][j] = 0.f;

    for (int v0 = 0; v0 < W; v0 += TK) {
      __syncthreads();  // the previous chunk's reads are done
      // the operator tile: v fastest in device memory
      for (int e = tid; e < 3 * TU * TK; e += THREADS) {
        const int plane = e / (TU * TK), r = e - plane * (TU * TK), uu = r / TK, vv = r - uu * TK;
        const int u = u0 + uu, v = v0 + vv;
        Cs[plane][vv][uu] = (u < W && v < W) ? ld(mats_b + ((size_t)plane * W + u) * W + v) : 0.f;
      }
      // x and y at the block's rows
      for (int e = tid; e < TR * TK; e += THREADS) {
        const int hh = e / TK, vv = e - hh * TK, h = h0 + hh, v = v0 + vv;
        float xr = 0.f, xi = 0.f, yr = 0.f, yi = 0.f;
        if (h < H && v < W) {
          const size_t px = (size_t)h * W + v;
          const float sr = ld(s_c + px * 2), si = ld(s_c + px * 2 + 1);
          const float er = ld(eta_b + px * 2), ei = ld(eta_b + px * 2 + 1);
          const float gr = ld(g_b + px * 4 + 2), gi = ld(g_b + px * 4 + 3);
          xr = sr * er - si * ei;
          xi = sr * ei + si * er;
          yr = sr * gr - si * gi;
          yi = sr * gi + si * gr;
        }
        Xs[0][vv][hh] = xr + xi;
        Xs[1][vv][hh] = xi;
        Xs[2][vv][hh] = xr;
        Ys[0][vv][hh] = yr + yi;
        Ys[1][vv][hh] = yi;
        Ys[2][vv][hh] = yr;
      }
      __syncthreads();
#pragma unroll 4
      for (int vv = 0; vv < TK; ++vv) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float4 cv = *reinterpret_cast<const float4*>(&Cs[p][vv][tx * CPT]);
          const float2 xv = *reinterpret_cast<const float2*>(&Xs[p][vv][ty * RPT]);
          const float2 yv = *reinterpret_cast<const float2*>(&Ys[p][vv][ty * RPT]);
          const float cc[CPT] = {cv.x, cv.y, cv.z, cv.w};
          const float xx[RPT] = {xv.x, xv.y}, yy[RPT] = {yv.x, yv.y};
#pragma unroll
          for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              ax[p][i][j] = fmaf(cc[j], xx[i], ax[p][i][j]);
              ay[p][i][j] = fmaf(cc[j], yy[i], ay[p][i][j]);
            }
        }
      }
    }

    // coil epilogue: ds_c, and conj(s_c) v_c into d_eta's sums
    T* ds_c = ds + ((size_t)b * C + c) * HW * 2;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int h = h0 + ty * RPT + i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int u = u0 + tx * CPT + j;
        if (h >= H || u >= W) continue;
        const size_t px = (size_t)h * W + u;
        const float ur = ax[0][i][j] - ax[1][i][j], ui = ax[0][i][j] + ax[2][i][j];
        const float vr = ay[0][i][j] - ay[1][i][j], vi = ay[0][i][j] + ay[2][i][j];
        const float er = ld(eta_b + px * 2), ei = ld(eta_b + px * 2 + 1);
        const float gr = ld(g_b + px * 4 + 2), gi = ld(g_b + px * 4 + 3);
        const float sr = ld(s_c + px * 2), si = ld(s_c + px * 2 + 1);
        // u * conj(g[..., 2:]) + v * conj(eta)
        st(ds_c + px * 2, (ur * gr + ui * gi + vr * er + vi * ei) * inv_sigma2);
        st(ds_c + px * 2 + 1, (ui * gr - ur * gi + vi * er - vr * ei) * inv_sigma2);
        de[i][j][0] += sr * vr + si * vi;
        de[i][j][1] += sr * vi - si * vr;
      }
    }
  }

  T* d_eta_b = d_eta + (size_t)b * HW * 2;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int h = h0 + ty * RPT + i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int u = u0 + tx * CPT + j;
      if (h >= H || u >= W) continue;
      const size_t px = (size_t)h * W + u;
      st(d_eta_b + px * 2, ld(g_b + px * 4) + de[i][j][0] * inv_sigma2);
      st(d_eta_b + px * 2 + 1, ld(g_b + px * 4 + 1) + de[i][j][1] * inv_sigma2);
    }
  }
}

template <typename T>
int launch_sens(const void* g, const void* eta, const void* sens, const void* mats, void* ds, void* d_eta, int B,
                int C, int H, int W, float inv_sigma2, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535 || (H + TR - 1) / TR > 65535 ||
      (long long)H * W > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TU - 1) / TU, (H + TR - 1) / TR, B);
  sens_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>((const T*)g, (const T*)eta, (const T*)sens,
                                                             (const T*)mats, (T*)ds, (T*)d_eta, C, H, W,
                                                             inv_sigma2);
  return (int)cudaGetLastError();
}

}  // namespace

// g [B, H, W, 4], eta [B, H, W, 2], sens [B, C, H, W, 2], mats [B, 3, W, W] -> ds [B, C, H, W, 2],
// d_eta [B, H, W, 2], all in one dtype
extern "C" int k1_psf1d_sens_f32(const void* g, const void* eta, const void* sens, const void* mats, void* ds,
                                 void* d_eta, int B, int C, int H, int W, float inv_sigma2, void* stream) {
  return launch_sens<float>(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
}

extern "C" int k1_psf1d_sens_bf16(const void* g, const void* eta, const void* sens, const void* mats, void* ds,
                                  void* d_eta, int B, int C, int H, int W, float inv_sigma2, void* stream) {
  return launch_sens<__nv_bfloat16>(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
}
