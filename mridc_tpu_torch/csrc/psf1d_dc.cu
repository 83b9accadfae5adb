// K1: the psf1d likelihood gradient of one RIM step, forward.
//
// Stands for mridc_tpu/nn/dc.py:162-179 log_likelihood_gradient_psf1d (with
// apply_psf1d :144-159), a chain that XLA fuses on the TPU:
//   out[b, h, u] = [eta, (sum_c conj(s_c[h, u]) * sum_v C[b, u, v] s_c[h, v] eta[h, v] - z0[h, u]) / sigma^2]
// as [B, H, W, 4], where C is the per-example complex [W, W] operator of
// psf1d_gauss_mats.
//
// What bounds it on an H100: operations. The product costs 8*C*H*W^2 flops per
// slice (3.9 GFLOP at 15 coils and 320x320) against about (C+3)*H*W*2 values
// of traffic (~16 MB in float32), far above the card's flop-per-byte ratio.
//
// Design: one block per (tile of output columns u, tile of rows h, example b).
// The block loops over coils and, inside, over tiles of v. It forms s_c*eta for
// its rows on the fly into shared memory, stages the matching tile of C, and
// accumulates the complex product on the tensor cores in float32. After each
// coil it multiplies by conj(s_c) at its own (h, u) and adds into a coil sum
// held in registers, so the [B, C, H, W, 2] coil tensor is never written. C
// arrives in the Gauss form of psf1d_gauss_mats (Cr, Cr+Ci, Ci-Cr); staging
// reads the first two and forms Ci = (Cr+Ci) - Cr. The complex multiply-add
// is four real products, xr*Cr + xi*(-Ci) and xi*Cr + xr*Ci, with the -Ci
// fragment made by flipping sign bits. Staging reads 16-byte vectors (when the
// row length allows) into registers one tile ahead, so the next tile's loads
// are in flight during this tile's MMAs.
//   float32 storage: mma.sync m16n8k8 in TF32, each operand split into a TF32
//   hi and a TF32 lo part and each real product taken as hi*lo + lo*hi + hi*hi,
//   which keeps float32 accuracy (lo*lo lies below float32's rounding).
//   bfloat16 storage: mma.sync m16n8k16 on bf16 operands; s_c*eta and Ci are
//   rounded to bf16 once, when staged.
// TMA staging and wgmma are later work.
#include "common.cuh"

using namespace mridc;

namespace {

template <typename T>
__device__ __forceinline__ void write_out(const T* eta_b, const T* z0_b, T* out_b, size_t p, float gr, float gi,
                                          float inv_sigma2) {
  T* o = out_b + p * 4;
  o[0] = eta_b[p * 2];
  o[1] = eta_b[p * 2 + 1];
  st(o + 2, (gr - ld(z0_b + p * 2)) * inv_sigma2);
  st(o + 3, (gi - ld(z0_b + p * 2 + 1)) * inv_sigma2);
}

__device__ __forceinline__ int clamp_n(int n, int cap) { return n < 0 ? 0 : (n > cap ? cap : n); }

// ---- float32: tensor cores, three TF32 products per real product -----------

namespace tf32 {

constexpr int TM = 32;        // rows h per block
constexpr int TN = 64;        // output columns u per block
constexpr int TK = 16;        // v per staged tile (two k8 steps)
constexpr int LDS = TK + 4;   // smem row stride in floats: fragment loads hit 32 banks
constexpr int THREADS = 128;  // 4 warps: 2 (h) x 2 (u), 16 x 32 outputs each

// 4 consecutive floats from global memory, the first n valid (zeros after);
// one 16-byte load when the row layout keeps it aligned
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

// One v-tile's global data in registers, loaded one tile ahead: each thread
// owns two 2-value chunks of the x tile (eta and s_c, complex) and two 4-value
// chunks of each C tile.
struct Stage {
  float4 eta[2], sens[2], cr[2], cs[2];
};

__global__ void __launch_bounds__(THREADS) psf1d_dc_f32_kernel(
    const float* __restrict__ eta, const float* __restrict__ sens, const float* __restrict__ mats,
    const float* __restrict__ z0, float* __restrict__ out, int C, int H, int W, float inv_sigma2) {
  __shared__ __align__(16) float xr_s[TM][LDS];  // A = x[h][v], row-major
  __shared__ __align__(16) float xi_s[TM][LDS];
  __shared__ __align__(16) float cr_s[TN][LDS];  // B = C[u][v]: C^T column-major
  __shared__ __align__(16) float ci_s[TN][LDS];

  const int b = blockIdx.z, h0 = blockIdx.y * TM, u0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const size_t HW = (size_t)H * W;
  const bool vec = W % 4 == 0;  // 16-byte loads stay aligned on every row
  const float* eta_b = eta + (size_t)b * HW * 2;
  const float* cr_g = mats + (size_t)b * 3 * W * W;
  const float* cs_g = cr_g + (size_t)W * W;
  const int nv = (W + TK - 1) / TK, iters = C * nv;

  auto load = [&](Stage& st, int it) {
    const int c = it / nv, v0 = (it % nv) * TK;
    const float* s_bc = sens + ((size_t)b * C + c) * HW * 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = tid + THREADS * k;
      const int h = h0 + (q >> 3), v = v0 + 2 * (q & 7);
      const int n = h < H ? 2 * clamp_n(W - v, 2) : 0;
      const size_t o = ((size_t)(h < H ? h : 0) * W + v) * 2;
      st.eta[k] = load4(eta_b + o, n, vec);
      st.sens[k] = load4(s_bc + o, n, vec);
      const int u = u0 + (q >> 2), vc = v0 + 4 * (q & 3);
      const int m = u < W ? clamp_n(W - vc, 4) : 0;
      const size_t oc = (size_t)(u < W ? u : 0) * W + vc;
      st.cr[k] = load4(cr_g + oc, m, vec);
      st.cs[k] = load4(cs_g + oc, m, vec);
    }
  };
  auto store = [&](const Stage& st) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = tid + THREADS * k;
      const float4 e = st.eta[k], s = st.sens[k];  // (re, im, re, im)
      *reinterpret_cast<float2*>(&xr_s[q >> 3][2 * (q & 7)]) =
          make_float2(e.x * s.x - e.y * s.y, e.z * s.z - e.w * s.w);
      *reinterpret_cast<float2*>(&xi_s[q >> 3][2 * (q & 7)]) =
          make_float2(e.x * s.y + e.y * s.x, e.z * s.w + e.w * s.z);
      const float4 r = st.cr[k], cs = st.cs[k];
      *reinterpret_cast<float4*>(&cr_s[q >> 2][4 * (q & 3)]) = r;
      *reinterpret_cast<float4*>(&ci_s[q >> 2][4 * (q & 3)]) =
          make_float4(cs.x - r.x, cs.y - r.y, cs.z - r.z, cs.w - r.w);  // Ci = (Cr+Ci) - Cr
    }
  };

  float gr[4][4], gi[4][4], ar[4][4], ai[4][4];  // [n tile][accumulator register]
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) gr[n][j] = gi[n][j] = ar[n][j] = ai[n][j] = 0.f;

  Stage st;
  load(st, 0);
  for (int it = 0; it < iters; ++it) {
    store(st);
    __syncthreads();
    if (it + 1 < iters) load(st, it + 1);  // in flight during this tile's MMAs
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      // A fragments: rows wm+g (+8), columns kk+t4 (+4)
      const int r0 = wm + g, k0 = kk + t4;
      const Split a_r[4] = {split(xr_s[r0][k0]), split(xr_s[r0 + 8][k0]), split(xr_s[r0][k0 + 4]),
                            split(xr_s[r0 + 8][k0 + 4])};
      const Split a_i[4] = {split(xi_s[r0][k0]), split(xi_s[r0 + 8][k0]), split(xi_s[r0][k0 + 4]),
                            split(xi_s[r0 + 8][k0 + 4])};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // B fragments: column (u) wn+8n+g, rows (v) kk+t4 (+4)
        const int c0 = wn + 8 * n + g;
        const Split br0 = split(cr_s[c0][k0]), br1 = split(cr_s[c0][k0 + 4]);
        const Split bi0 = split(ci_s[c0][k0]), bi1 = split(ci_s[c0][k0 + 4]);
        mma3(ar[n], a_r, br0, br1);
        mma3(ar[n], a_i, neg(bi0), neg(bi1));  // - xi * Ci
        mma3(ai[n], a_i, br0, br1);
        mma3(ai[n], a_r, bi0, bi1);
      }
    }
    __syncthreads();

    if (it % nv == nv - 1) {
      // coil sum of conj(s_c) * (C s_c eta); accumulator register j of n tile n
      // sits at row wm+g (+8 for j >= 2), column wn+8n+2*t4+(j&1)
      const float* s_bc = sens + ((size_t)b * C + it / nv) * HW * 2;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = h0 + wm + g + (j >= 2 ? 8 : 0), u = u0 + wn + 8 * n + 2 * t4 + (j & 1);
          if (h < H && u < W) {
            const float2 sv = *reinterpret_cast<const float2*>(s_bc + ((size_t)h * W + u) * 2);
            gr[n][j] += sv.x * ar[n][j] + sv.y * ai[n][j];
            gi[n][j] += sv.x * ai[n][j] - sv.y * ar[n][j];
          }
          ar[n][j] = ai[n][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + wm + g + (j >= 2 ? 8 : 0), u = u0 + wn + 8 * n + 2 * t4 + (j & 1);
      if (h >= H || u >= W) continue;
      write_out(eta_b, z0 + (size_t)b * HW * 2, out + (size_t)b * HW * 4, (size_t)h * W + u, gr[n][j], gi[n][j],
                inv_sigma2);
    }
}

}  // namespace tf32

// ---- bfloat16: tensor cores -----------------------------------------------

namespace tc {

constexpr int TM = 32;        // rows h per block
constexpr int TN = 64;        // output columns u per block
constexpr int TK = 32;        // v per staged tile (two k16 steps)
constexpr int LDS = TK + 8;   // smem row stride in bf16: 20 words, so fragment loads hit 32 banks
constexpr int THREADS = 128;  // 4 warps: 2 (h) x 2 (u), 16 x 32 outputs each

using bf16 = __nv_bfloat16;

// bf16 pairs packed in 32-bit words (lower address in the low half)
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 8 consecutive bf16 from global memory, the first n of them valid (zeros
// after); one 16-byte load when the row layout keeps it aligned
__device__ __forceinline__ uint4 load8(const bf16* p, int n, bool vec) {
  if (vec && n >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (2 * i < n ? (uint32_t)q[2 * i] : 0u) | ((2 * i + 1 < n ? (uint32_t)q[2 * i + 1] : 0u) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One v-tile's global data, held in registers from its load (issued before
// the previous tile's MMAs) to its conversion into shared memory. Each thread
// owns two 4-value chunks of the x tile (eta and s_c) and two 8-value chunks of
// each C tile.
struct Stage {
  uint4 eta[2], sens[2], cr[2], cs[2];
};

__global__ void __launch_bounds__(THREADS) psf1d_dc_bf16_kernel(
    const bf16* __restrict__ eta, const bf16* __restrict__ sens, const bf16* __restrict__ mats,
    const bf16* __restrict__ z0, bf16* __restrict__ out, int C, int H, int W, float inv_sigma2) {
  __shared__ __align__(16) bf16 xr_s[TM][LDS];  // A = x[h][v], row-major
  __shared__ __align__(16) bf16 xi_s[TM][LDS];
  __shared__ __align__(16) bf16 cr_s[TN][LDS];  // B = C[u][v]: C^T column-major
  __shared__ __align__(16) bf16 ci_s[TN][LDS];

  const int b = blockIdx.z, h0 = blockIdx.y * TM, u0 = blockIdx.x * TN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const size_t HW = (size_t)H * W;
  const bool vec = W % 8 == 0;  // 16-byte loads stay aligned on every row
  const bf16* eta_b = eta + (size_t)b * HW * 2;
  const bf16* cr_g = mats + (size_t)b * 3 * W * W;
  const bf16* cs_g = cr_g + (size_t)W * W;
  const int nv = (W + TK - 1) / TK, iters = C * nv;

  auto load = [&](Stage& st, int it) {
    const int c = it / nv, v0 = (it % nv) * TK;
    const bf16* s_bc = sens + ((size_t)b * C + c) * HW * 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = tid + THREADS * k;
      const int h = h0 + (q >> 3), v = v0 + 4 * (q & 7);
      const int n = h < H ? 2 * clamp_n(W - v, 4) : 0;
      const size_t o = ((size_t)(h < H ? h : 0) * W + v) * 2;
      st.eta[k] = load8(eta_b + o, n, vec);
      st.sens[k] = load8(s_bc + o, n, vec);
      const int u = u0 + (q >> 2), vc = v0 + 8 * (q & 3);
      const int m = u < W ? clamp_n(W - vc, 8) : 0;
      const size_t oc = (size_t)(u < W ? u : 0) * W + vc;
      st.cr[k] = load8(cr_g + oc, m, vec);
      st.cs[k] = load8(cs_g + oc, m, vec);
    }
  };
  auto store = [&](const Stage& st) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int q = tid + THREADS * k;
      const uint32_t e[4] = {st.eta[k].x, st.eta[k].y, st.eta[k].z, st.eta[k].w};  // (re, im) per word
      const uint32_t s[4] = {st.sens[k].x, st.sens[k].y, st.sens[k].z, st.sens[k].w};
      float xr[4], xi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xr[i] = lo(e[i]) * lo(s[i]) - hi(e[i]) * hi(s[i]);
        xi[i] = lo(e[i]) * hi(s[i]) + hi(e[i]) * lo(s[i]);
      }
      *reinterpret_cast<uint2*>(&xr_s[q >> 3][4 * (q & 7)]) = make_uint2(pack(xr[0], xr[1]), pack(xr[2], xr[3]));
      *reinterpret_cast<uint2*>(&xi_s[q >> 3][4 * (q & 7)]) = make_uint2(pack(xi[0], xi[1]), pack(xi[2], xi[3]));
      const uint32_t r[4] = {st.cr[k].x, st.cr[k].y, st.cr[k].z, st.cr[k].w};
      const uint32_t c[4] = {st.cs[k].x, st.cs[k].y, st.cs[k].z, st.cs[k].w};
      uint32_t ci[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ci[i] = pack(lo(c[i]) - lo(r[i]), hi(c[i]) - hi(r[i]));  // Ci = (Cr+Ci) - Cr
      *reinterpret_cast<uint4*>(&cr_s[q >> 2][8 * (q & 3)]) = st.cr[k];
      *reinterpret_cast<uint4*>(&ci_s[q >> 2][8 * (q & 3)]) = make_uint4(ci[0], ci[1], ci[2], ci[3]);
    }
  };

  float gr[4][4], gi[4][4], ar[4][4], ai[4][4];  // [n tile][accumulator register]
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) gr[n][j] = gi[n][j] = ar[n][j] = ai[n][j] = 0.f;

  Stage st;
  load(st, 0);
  for (int it = 0; it < iters; ++it) {
    store(st);
    __syncthreads();
    if (it + 1 < iters) load(st, it + 1);  // in flight during this tile's MMAs
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      // A fragments: rows wm+g and wm+g+8, columns kk+2*t4 (+1) and +8
      const bf16* pr = &xr_s[wm + g][kk + 2 * t4];
      const bf16* pi = &xi_s[wm + g][kk + 2 * t4];
      const uint32_t a_r[4] = {ld32(pr), ld32(pr + 8 * LDS), ld32(pr + 8), ld32(pr + 8 * LDS + 8)};
      const uint32_t a_i[4] = {ld32(pi), ld32(pi + 8 * LDS), ld32(pi + 8), ld32(pi + 8 * LDS + 8)};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        // B fragments: column (u) wn+8n+g, rows (v) kk+2*t4 (+1) and +8
        const bf16* qr = &cr_s[wn + 8 * n + g][kk + 2 * t4];
        const bf16* qi = &ci_s[wn + 8 * n + g][kk + 2 * t4];
        const uint32_t br0 = ld32(qr), br1 = ld32(qr + 8);
        const uint32_t bi0 = ld32(qi), bi1 = ld32(qi + 8);
        mma(ar[n], a_r, br0, br1);
        mma(ar[n], a_i, bi0 ^ 0x80008000u, bi1 ^ 0x80008000u);  // - xi * Ci
        mma(ai[n], a_i, br0, br1);
        mma(ai[n], a_r, bi0, bi1);
      }
    }
    __syncthreads();

    if (it % nv == nv - 1) {
      // coil sum of conj(s_c) * (C s_c eta); accumulator register j of n tile n
      // sits at row wm+g (+8 for j >= 2), column wn+8n+2*t4+(j&1)
      const bf16* s_bc = sens + ((size_t)b * C + it / nv) * HW * 2;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int h = h0 + wm + g + (j >= 2 ? 8 : 0), u = u0 + wn + 8 * n + 2 * t4 + (j & 1);
          if (h < H && u < W) {
            const size_t o = ((size_t)h * W + u) * 2;
            const float sr = __bfloat162float(s_bc[o]), si = __bfloat162float(s_bc[o + 1]);
            gr[n][j] += sr * ar[n][j] + si * ai[n][j];
            gi[n][j] += sr * ai[n][j] - si * ar[n][j];
          }
          ar[n][j] = ai[n][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = h0 + wm + g + (j >= 2 ? 8 : 0), u = u0 + wn + 8 * n + 2 * t4 + (j & 1);
      if (h >= H || u >= W) continue;
      write_out(eta_b, z0 + (size_t)b * HW * 2, out + (size_t)b * HW * 4, (size_t)h * W + u, gr[n][j], gi[n][j],
                inv_sigma2);
    }
}

}  // namespace tc

bool bad(int B, int C, int H, int W) { return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535; }

}  // namespace

extern "C" int k1_psf1d_dc_f32(const void* eta, const void* sens, const void* mats, const void* z0, void* out,
                               int B, int C, int H, int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + tf32::TN - 1) / tf32::TN, (H + tf32::TM - 1) / tf32::TM, B);
  tf32::psf1d_dc_f32_kernel<<<grid, tf32::THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)eta, (const float*)sens, (const float*)mats, (const float*)z0, (float*)out, C, H, W, inv_sigma2);
  return (int)cudaGetLastError();
}

extern "C" int k1_psf1d_dc_bf16(const void* eta, const void* sens, const void* mats, const void* z0, void* out,
                                int B, int C, int H, int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  using tc::bf16;
  const dim3 grid((W + tc::TN - 1) / tc::TN, (H + tc::TM - 1) / tc::TM, B);
  tc::psf1d_dc_bf16_kernel<<<grid, tc::THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)eta, (const bf16*)sens, (const bf16*)mats, (const bf16*)z0, (bf16*)out, C, H, W, inv_sigma2);
  return (int)cudaGetLastError();
}
