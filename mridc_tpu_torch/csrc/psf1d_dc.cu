// K1: the psf1d likelihood gradient of one RIM step, forward and backward.
//
// Stands for mridc_tpu/nn/dc.py:162-179 log_likelihood_gradient_psf1d (with
// apply_psf1d :144-159), a chain that XLA fuses on the TPU:
//   out[b, h, u] = [eta, (A(eta)[h, u] - z0[h, u]) / sigma^2]
//   A(eta)[h, u] = sum_c conj(s_c[h, u]) * sum_v C[b, u, v] s_c[h, v] eta[h, v]
// as [B, H, W, 4], where C is the per-example complex [W, W] operator of
// psf1d_gauss_mats. A is Hermitian in every normalisation and centering mode
// (C = F^-1 diag(m) F with real m, the shifts are permutations), so the
// gradient for an upstream g [B, H, W, 4] (what jax.grad takes through the
// same chain) is d_eta = g[..., :2] + A(g[..., 2:]) / sigma^2: the same tiles
// with g's channels 2:4 read as eta and an epilogue that adds g[..., :2]
// ([B, H, W, 2] out). Both passes are one template (BWD).
//
// What bounds it on an H100: operations. The product costs 6*C*H*W^2 flops per
// slice in the Gauss form (2.9 GFLOP at 15 coils and 320x320) against about
// (C+3)*H*W*2 values of traffic (~16 MB in float32), far above the card's
// flop-per-byte ratio. Inside the card the limits are the L2-to-SM traffic of
// s_c, which every tile of output columns reads again, and the shared-memory
// traffic of the mma.sync fragments.
//
// float32 (tf32 below): a persistent grid of one wave walks tiles of 32 rows
// h by 32 columns u (16 by 32 where 320 < W <= 416), one block of 8 warps an
// SM.
//   - The operator stays on chip across the coils: a tile stages its 32 rows
//     of all three planes for every v once (123 KB at W = 320, dynamic shared
//     memory) and eta's rows once (82 KB; g's channels 2:4 in the backward),
//     then loops over the coils streaming only s_c. L2-to-SM traffic at B=8
//     falls from ~1.97 GB to ~1.26 GB (chip_smoke.py prints both).
//   - The complex product is the Gauss form of apply_psf1d over the planes
//     as delivered: A planes (xr + xi, xi, xr), B planes (Cr, Cr + Ci,
//     Ci - Cr), three accumulator sets combined into re and im in the coil
//     epilogue. Each real product is 3xTF32 (hi*lo + lo*hi + hi*hi on
//     mma.sync m16n8k8): 9 MMAs a 16 x 8 x 8 piece, where the four-product
//     form takes 12. Fragments are split into TF32 hi and lo once per load:
//     an A split feeds 12 MMAs (3 in each of a warp's 4 n tiles), a B split 3.
//     A split is two operations (split_trunc: hi truncated, lo = x - hi read
//     to its top 19 bits by the tensor core); with cvt.rna, which compiles to
//     a sequence of several, the splits and not the products bounded the kernel
//     (1.28 against 0.79 ms at B=8 on an H100, PERF.md).
//   - Warp w takes row group w / KP (16 rows) and K phase w % KP (KP = 4, or
//     8 for 16-row tiles): every KP-th 8-deep chunk of v, for every coil,
//     over all 32 columns. It streams its rows of s_c through its own
//     3-chunk cp.async ring (2 at W > 384) and forms x = s_c * eta in
//     registers straight into its A fragments. No __syncthreads runs inside
//     a tile's coil loop: a __syncwarp per chunk; block barriers only where
//     a tile starts (operator and eta staged) and ends.
//   - The coil sum stays in float32 registers: each warp adds conj(s_c)
//     times its phase's partial products in coil order (s_c at its pixels
//     loaded from L2 as the coil starts); at the tile's end the K phases'
//     sums are added in phase order through shared memory. No atomics: the
//     same result from run to run.
//   - Widths no 16-row tile holds (W > 416) take the wide route, the first
//     version's kernel (tf32::wide): the launcher picks the route by shape.
//   - What bounds it on an H100 at B=8: the MMAs with their A splits alone
//     take ~0.47 ms and the rest of the work (copies, loads, splits, coil
//     epilogues) ~0.51 ms; they overlap only in part, to ~0.78 ms. 800 tiles
//     run in 7 rounds of 132 SMs for 6.06 of work.
//   - mma.sync, not wgmma: a wgmma B operand is read from shared memory as
//     32-bit TF32 words, so 3xTF32 would need hi and lo planes of every
//     operator plane resident (246 KB at W = 320 for 32 rows), which does
//     not fit beside eta; the splits stay in registers.
//
// bfloat16 (tc below): a persistent grid of one wave walks tiles of 64 rows h
// by 64 columns u (64 by 32 where 320 < W <= 480), one block of 8 warps an SM.
//   - The operator stays on chip across the coils: a tile stages its 64 rows
//     of C for every v once (82 KB at W = 320, dynamic shared memory), and
//     eta's 64 rows once (80 KB); then it loops over the coils staging only
//     s_c. The L2-to-SM traffic of a call falls about 3x (chip_smoke.py
//     prints it beside the first version's).
//   - Four products over (Cr, Ci), Ci = (Cr+Ci) - Cr formed once per tile and
//     rounded to bf16 again: a fragment feeds two products, so a product
//     loads two thirds of the shared-memory bytes of the Gauss form's. The
//     Gauss form (three products over the planes as delivered, as
//     apply_psf1d computes) needs a third plane of C, which leaves no room
//     for 64 x 64 tiles; at equal tiles the two ran within 5% of each other
//     on an H100, and the wider tile won by 1.8x (PERF.md).
//   - Warp pair q owns rows 16q .. 16q + 15, its two warps the left and right
//     32 columns. Each pair streams its rows of s_c through its own ring of
//     32-column chunks (16-byte cp.async, 4-byte at a ragged W), the next
//     chunk in flight during this one; its warps form x = s_c*eta of 8 rows
//     each in float32 from the staged bf16 values, round it once into the
//     planes (xr, xi), and meet at a 64-thread named barrier. No block barrier
//     runs inside a tile, so one pair's copies and conversion overlap
//     another's products, and two warps share each SM sub-partition.
//   - Products on mma.sync m16n8k16 bf16 with float32 accumulate, fragments
//     by ldmatrix from rows padded by 16 bytes (no bank conflicts).
//   - After each coil a warp multiplies its accumulators by conj(s_c) at its
//     pixels, kept in shared memory from the chunks that cover the tile's
//     columns, and adds them into a coil sum in float32 registers, in coil
//     order: no atomics, the same result from run to run.
//   - Outputs go out as 16-byte (forward) or 8-byte (backward) pairs of pixels.
//   - Widths no 64 x 32 tile holds (W > 480) take the wide route, the first
//     version's kernel (tc::wide, 32 x 64 tiles, the operator staged in
//     32-deep chunks for every coil): the launcher picks the route by shape.
//   - mma.sync, not wgmma: on an H100 the product alone (no copies, no
//     conversion) takes ~0.15 ms at B=8, 4.6x its four products' time at
//     the card's bf16 peak; wgmma with TMA-fed, warp-specialised stages is
//     the next step.
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

// backward epilogue: d_eta = g[..., :2] + A(g[..., 2:]) / sigma^2
template <typename T>
__device__ __forceinline__ void write_bwd(const T* g_b, T* out_b, size_t p, float gr, float gi, float inv_sigma2) {
  st(out_b + p * 2, ld(g_b + p * 4) + gr * inv_sigma2);
  st(out_b + p * 2 + 1, ld(g_b + p * 4 + 1) + gi * inv_sigma2);
}

__device__ __forceinline__ int clamp_n(int n, int cap) { return n < 0 ? 0 : (n > cap ? cap : n); }

// ---- float32: 3xTF32 tensor cores -------------------------------------------

namespace tf32 {

// The wide route: the first version's design, one block per 32 rows h x 64
// columns u x example, for the widths whose operator rows no on-chip tile
// holds (W > 416).
// It loops over coils and, inside, over 16-deep tiles of v, staging s_c*eta
// and the operator tile (again for every coil) through registers, with a
// block barrier on each side of each tile's four real products (12 MMAs a
// 16 x 8 x 8 piece).
namespace wide {

constexpr int TM = 32;        // rows h per block
constexpr int TN = 64;        // output columns u per block
constexpr int TK = 16;        // v per staged tile (two k8 steps)
constexpr int LDS = TK + 4;   // smem row stride in floats: fragment loads hit 32 banks
constexpr int THREADS = 128;  // 4 warps: 2 (h) x 2 (u), 16 x 32 outputs each
constexpr int SMEM = (2 * TM + 2 * TN) * LDS * 4;  // static shared memory, bytes

// 4 consecutive floats from global memory, the first n valid (zeros after);
// one 16-byte load when the row layout keeps it aligned
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}

// eta at pixels pix and pix + 1 (the first n / 2 valid): 16 bytes of a
// [.., 2] eta, or (backward) channels 2:4 of g [.., 4], two 8-byte loads
template <bool BWD>
__device__ __forceinline__ float4 load_eta(const float* e, size_t pix, int n, bool vec) {
  if (!BWD) return load4(e + pix * 2, n, vec);
  const float* p = e + pix * 4 + 2;
  const float2 a = n > 0 ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
  const float2 c = n > 2 ? *reinterpret_cast<const float2*>(p + 4) : make_float2(0.f, 0.f);
  return make_float4(a.x, a.y, c.x, c.y);
}

// One v-tile's global data in registers, loaded one tile ahead: each thread
// owns two 2-value chunks of the x tile (eta and s_c, complex) and two 4-value
// chunks of each C tile.
struct Stage {
  float4 eta[2], sens[2], cr[2], cs[2];
};

template <bool BWD>
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
  const float* eta_b = eta + (size_t)b * HW * (BWD ? 4 : 2);  // backward: g
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
      const size_t pix = (size_t)(h < H ? h : 0) * W + v;
      st.eta[k] = load_eta<BWD>(eta_b, pix, n, vec);
      st.sens[k] = load4(s_bc + pix * 2, n, vec);
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
    for (int kk = 0; kk < TK; kk += 8) {  // wide
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
      if (BWD)
        write_bwd(eta_b, out + (size_t)b * HW * 2, (size_t)h * W + u, gr[n][j], gi[n][j], inv_sigma2);
      else
        write_out(eta_b, z0 + (size_t)b * HW * 2, out + (size_t)b * HW * 4, (size_t)h * W + u, gr[n][j],
                  gi[n][j], inv_sigma2);
    }
}

}  // namespace wide

// The on-chip route (see the file's head): tiles of TM = 16 * RG rows h by
// TN = 32 columns u, 8 warps; warp w takes row group w / KP and K phase
// w % KP (KP = 8 / RG), the chunks of 8 v whose index in the coil is the
// phase mod KP, over all 32 columns.
constexpr int KW = 8;                // v per chunk: one k8 step
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int TN = 32, NT = TN / 8;  // columns u per tile; n tiles per warp

// Shared memory of a tile of TM rows and S ring stages at width
// W, in floats: eta [TM][2 kp] (complex, every v), the operator [3][TN][kp]
// (planes Cr, Cr+Ci, Ci-Cr as delivered; rows u, every v), then each warp's
// ring [S][16][2 KW] of raw s_c. kp is W rounded up to 32, zeros past W.
// Rows are not padded but swizzled (eta_sw, op_sw). At the tile's end the
// operator and the rings hold the K phases' coil sums (``scratch``).
struct Layout {
  int kp;
  size_t op, ring, floats;

  __host__ __device__ Layout(int TM, int S, int W) {
    kp = (W + 31) / 32 * 32;
    op = (size_t)TM * 2 * kp;
    ring = op + (size_t)3 * TN * kp;
    floats = ring + (size_t)WARPS * S * 16 * 2 * KW;
    const size_t scratch = op + (size_t)(WARPS - TM / 16) * 32 * 8 * NT;
    if (scratch > floats) floats = scratch;
  }
  __host__ __device__ size_t bytes() const { return floats * 4; }
};

// word of v in operator row r: the 64-bit B fragment loads of a half warp
// (rows g = 0..3) fall 8 words apart mod 32, on 32 distinct banks
__device__ __forceinline__ int op_sw(int r, int v) { return v ^ ((r & 3) << 3); }
// word of complex pixel v in eta row r: the 128-bit A loads of a quarter warp
// (rows 2q, 2q + 1) fall 16 words apart mod 32
__device__ __forceinline__ int eta_sw(int r, int v) { return (2 * v) ^ ((r & 1) << 4); }

// the complex pixels (h, u) and (h, u + 1) of one [H, W] complex plane ``p``
// as (re, im, re, im), zeros where outside; one 16-byte load when W is even
__device__ __forceinline__ float4 load_pair(const float* p, int h, int u, int H, int W) {
  if (h >= H || u >= W) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* q = p + ((size_t)h * W + u) * 2;
  if (W % 2 == 0) return __ldg(reinterpret_cast<const float4*>(q));
  const float2 a = __ldg(reinterpret_cast<const float2*>(q));
  const float2 c = u + 1 < W ? __ldg(reinterpret_cast<const float2*>(q + 2)) : make_float2(0.f, 0.f);
  return make_float4(a.x, a.y, c.x, c.y);
}

// The Gauss form (the file's head): k1 = Cr (xr + xi), k2 = (Cr + Ci) xi,
// k3 = (Ci - Cr) xr, re = k1 - k2, im = k1 + k3. Inside each k8 step the
// pixels v0 + 2 t4 and v0 + 2 t4 + 1 stand for k = t4 and t4 + 4 of the
// fragment layout (a permutation of v applied to A and B alike), so that a
// lane's B fragment is one 64-bit load and its A pixels one 128-bit load per
// row.
template <bool BWD, int RG, int S>
__global__ void __launch_bounds__(THREADS, 1) psf1d_dc_f32_kernel(
    const float* __restrict__ eta, const float* __restrict__ sens, const float* __restrict__ mats,
    const float* __restrict__ z0, float* __restrict__ out, int B, int C, int H, int W, float inv_sigma2) {
  constexpr int TM = 16 * RG, KP = WARPS / RG;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* const smem = reinterpret_cast<float*>(smem_f32);
  const Layout L(TM, S, W);
  const size_t plane = (size_t)TN * L.kp;  // floats of one operator plane
  const int kp = L.kp;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int rg = warp / KP, kph = warp % KP;  // row group, K phase
  float* const eta_s = smem;                                                    // [TM][2 kp]
  float* const op_s = smem + L.op;                                              // [3][TN][kp]
  float* const ring = smem + L.ring + (size_t)warp * S * 16 * 2 * KW;           // [S][16][2 KW]
  const size_t HW = (size_t)H * W;
  const bool vec4 = W % 4 == 0;  // 16-byte copies of operator rows stay aligned
  const bool even = W % 2 == 0;  // 16-byte copies of complex pixel pairs stay aligned
  const int nk = (W + KW - 1) / KW;
  const int mk = nk > kph ? (nk - kph + KP - 1) / KP : 0;  // this warp's chunks a coil
  const int nh = (H + TM - 1) / TM, nu = (W + TN - 1) / TN, units = B * nh * nu;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int u0 = (unit % nu) * TN, h0 = (unit / nu % nh) * TM, b = unit / (nu * nh);
    const int hw = h0 + 16 * rg;  // this warp's first row
    const float* eta_b = eta + (size_t)b * HW * (BWD ? 4 : 2);  // backward: g
    const float* s_b = sens + (size_t)b * C * HW * 2;
    const float* m_b = mats + (size_t)b * 3 * W * W;
    __syncthreads();  // the previous tile is done with shared memory

    // one group: the operator's rows u0.. of the three planes and eta's rows
    // (g's channels 2:4 in the backward), for every v, zeros past W and H
    for (int e = tid; e < 3 * TN * (kp / 4); e += THREADS) {
      const int p = e / (TN * (kp / 4)), r = e / (kp / 4) % TN, v = 4 * (e % (kp / 4)), u = u0 + r;
      float* dst = op_s + p * plane + (size_t)r * kp;
      const float* src = m_b + (size_t)p * W * W + (size_t)u * W + v;
      if (vec4) {
        const bool ok = u < W && v < W;
        cp_async16(dst + op_sw(r, v), ok ? src : m_b, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = u < W && v + j < W;
          cp_async4(dst + op_sw(r, v + j), ok ? src + j : m_b, ok);
        }
      }
    }
    for (int e = tid; e < TM * (kp / 2); e += THREADS) {
      const int r = e / (kp / 2), v = 2 * (e % (kp / 2)), h = h0 + r;
      float* dst = eta_s + (size_t)r * 2 * kp;
      const float* src = eta_b + ((size_t)h * W + v) * (BWD ? 4 : 2) + (BWD ? 2 : 0);
      if (!BWD && even) {
        const bool ok = h < H && v < W;
        cp_async16(dst + eta_sw(r, v), ok ? src : eta_b, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = h < H && v + j < W;
          cp_async8(dst + eta_sw(r, v + j), ok ? src + j * (BWD ? 4 : 2) : eta_b, ok);
        }
      }
    }
    cp_async_commit();

    // this warp's next chunk of raw s_c (coil ic, chunk kph + ij * KP of the
    // coil: 16 rows x 8 pixels) into its ring slot is, zeros past H and W;
    // one group per call, empty past the last chunk
    int ic = mk > 0 ? 0 : C, ij = 0, is = 0;
    auto copy_next = [&]() {
      if (ic < C) {  // s_c copies
        const float* s_c = s_b + (size_t)ic * HW * 2;
        const int v0 = (kph + ij * KP) * KW;
        float* slot = ring + (size_t)is * 16 * 2 * KW;
        if (even) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = lane + 32 * k, h = hw + e / 4, v = v0 + 2 * (e % 4);  // row e / 4, pixels 2 (e % 4), +1
            const bool ok = h < H && v < W;
            cp_async16(slot + 4 * e, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = lane + 32 * k, h = hw + e / 8, v = v0 + e % 8;  // row e / 8, pixel e % 8
            const bool ok = h < H && v < W;
            cp_async8(slot + 2 * e, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        }
        if (++ij == mk) ij = 0, ++ic;
        is = is + 1 == S ? 0 : is + 1;
      }
      cp_async_commit();
    };

    // acc[p][n][j]: plane p's product, n tile n, accumulator register j at row
    // g (+8 for j >= 2) of the warp's rows, column 8n + 2 t4 + (j & 1); gr/gi
    // the coil sum; sv the coil's s_c at those pixels (fetched as the coil starts)
    float acc[3][NT][4], gr[NT][4], gi[NT][4];
    float4 sv[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) gr[n][j] = gi[n][j] = acc[0][n][j] = acc[1][n][j] = acc[2][n][j] = 0.f;

    for (int t = 0; t < S - 1; ++t) copy_next();
    cp_async_wait<S - 2>();
    __syncthreads();  // every thread's copies of the operator and eta (and its chunk 0) have landed
    for (int c = 0; c < (mk > 0 ? C : 0); ++c) {
      const float* s_c = s_b + (size_t)c * HW * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) sv[n][hf] = load_pair(s_c, hw + g + 8 * hf, u0 + 8 * n + 2 * t4, H, W);
      for (int jc = 0; jc < mk; ++jc) {
        if (c + jc > 0) {
          cp_async_wait<S - 2>();  // this chunk has landed (this lane's copies) ...
          __syncwarp();            // ... every lane's, and every lane is done with the slot refilled below
        }
        const float* slot = ring + (size_t)((c * mk + jc) % S) * 16 * 2 * KW;
        copy_next();
        const int v0 = (kph + jc * KP) * KW;
        Split a[3][4];  // A fragments of the planes (xr + xi, xi, xr)
        {
          float xr[4], xi[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {  // rows g and g + 8: pixels v0 + 2 t4 (j = hf), v0 + 2 t4 + 1 (j = 2 + hf)
            const int r = 16 * rg + g + 8 * hf;
            const float4 s = *reinterpret_cast<const float4*>(slot + (g + 8 * hf) * 2 * KW + 4 * t4);
            const float4 e = *reinterpret_cast<const float4*>(eta_s + (size_t)r * 2 * kp + eta_sw(r, v0 + 2 * t4));
            xr[hf] = e.x * s.x - e.y * s.y;
            xi[hf] = e.x * s.y + e.y * s.x;
            xr[2 + hf] = e.z * s.z - e.w * s.w;
            xi[2 + hf] = e.z * s.w + e.w * s.z;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[0][j] = split_trunc(xr[j] + xi[j]);
            a[1][j] = split_trunc(xi[j]);
            a[2][j] = split_trunc(xr[j]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int r = 8 * n + g;  // operator row (u) in the tile
          const float* b = op_s + (size_t)r * kp + op_sw(r, v0 + 2 * t4);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const float2 bv = *reinterpret_cast<const float2*>(b + p * plane);
            mma3(acc[p][n], a[p], split_trunc(bv.x), split_trunc(bv.y));
          }
        }
      }
      // coil done: add conj(s_c) * (re, im), re = k1 - k2, im = k1 + k3
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 s = sv[n][j >> 1];
          const float sr = j & 1 ? s.z : s.x, si = j & 1 ? s.w : s.y;
          const float re = acc[0][n][j] - acc[1][n][j], im = acc[0][n][j] + acc[2][n][j];
          gr[n][j] += sr * re + si * im;
          gi[n][j] += sr * im - si * re;
          acc[0][n][j] = acc[1][n][j] = acc[2][n][j] = 0.f;
        }
    }
    cp_async_wait<0>();  // the empty groups past the last chunk

    // the K phases' coil sums, added in phase order by phase 0's warps
    // (element-major: a warp's 32 lanes write 32 consecutive words)
    __syncthreads();  // every warp is done with the operator and its ring
    float* const scratch = smem + L.op;  // [KP - 1][RG][8 NT][32]
    if (kph > 0) {
      float* dst = scratch + (size_t)((kph - 1) * RG + rg) * 8 * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[(4 * n + j) * 32] = gr[n][j];
          dst[(4 * NT + 4 * n + j) * 32] = gi[n][j];
        }
    }
    __syncthreads();
    if (kph > 0) continue;
    for (int k = 1; k < KP; ++k) {
      const float* src = scratch + (size_t)((k - 1) * RG + rg) * 8 * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gr[n][j] += src[(4 * n + j) * 32];
          gi[n][j] += src[(4 * NT + 4 * n + j) * 32];
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 16 * rg + g + 8 * (j >> 1), h = h0 + r, u = u0 + 8 * n + 2 * t4 + (j & 1);
        if (h >= H || u >= W) continue;
        const size_t p = (size_t)h * W + u;
        if (BWD) {  // d_eta = g[..., :2] + A(g[..., 2:]) / sigma^2
          const float2 gv = __ldg(reinterpret_cast<const float2*>(eta_b + p * 4));
          *reinterpret_cast<float2*>(out + ((size_t)b * HW + p) * 2) =
              make_float2(gv.x + gr[n][j] * inv_sigma2, gv.y + gi[n][j] * inv_sigma2);
        } else {  // [eta, (A(eta) - z0) / sigma^2]
          const float2 ev = *reinterpret_cast<const float2*>(eta_s + (size_t)r * 2 * kp + eta_sw(r, u));
          const float2 zv = __ldg(reinterpret_cast<const float2*>(z0 + ((size_t)b * HW + p) * 2));
          *reinterpret_cast<float4*>(out + ((size_t)b * HW + p) * 4) =
              make_float4(ev.x, ev.y, (gr[n][j] - zv.x) * inv_sigma2, (gi[n][j] - zv.y) * inv_sigma2);
        }
      }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, float*, int, int, int, int, float);

constexpr int ON_CHIP = 0, WIDE = 1;  // routes

// a route's kernel (null for the wide route, launched on its own grid) and
// its shared memory at width W
struct Setup {
  Kernel kernel;
  int threads, tm, tn, route;
  size_t smem;

  bool fits() const { return smem <= (size_t)MAX_DYNAMIC_SMEM; }
  // blocks of one wave (cached; the first call sets the shared-memory limit)
  cudaError_t cap(int device, int* blocks) const { return wave((const void*)kernel, threads, smem, device, blocks); }
  int units(int B, int H, int W) const { return B * ((H + tm - 1) / tm) * ((W + tn - 1) / tn); }
};

template <bool BWD, int RG, int S>
Setup make(int W) {
  return {&psf1d_dc_f32_kernel<BWD, RG, S>, THREADS, 16 * RG, TN, ON_CHIP, Layout(16 * RG, S, W).bytes()};
}

// The route by shape alone: 32 x 32 tiles with rings of 3 chunks where their
// shared memory fits (W <= 320), then 16 x 32 tiles with 3 (W <= 384) or 2
// (W <= 416) stages; wider W takes the wide route.
template <bool BWD>
Setup pick(int W) {
  const Setup tiles[] = {make<BWD, 2, 3>(W), make<BWD, 1, 3>(W), make<BWD, 1, 2>(W)};
  for (const Setup& s : tiles)
    if (s.fits()) return s;
  return {nullptr, wide::THREADS, wide::TM, wide::TN, WIDE, (size_t)wide::SMEM};
}
}  // namespace tf32

// ---- bfloat16: tensor cores, the operator held on chip across the coils ------

namespace tc {

using bf16 = __nv_bfloat16;

// The complex product is four real products over (Cr, Ci), with Ci =
// (Cr+Ci) - Cr formed once per tile and rounded to bf16 a second time: two
// planes of the operator and of x, two accumulator sets, each fragment
// feeding two products.
constexpr int TK = 32;      // v per chunk: two k16 steps
constexpr int LX = TK + 8;  // x plane row stride: the 8 rows of an ldmatrix phase hit distinct banks
constexpr int STAGES = 2;   // raw s_c chunks a warp pair has in flight: the next one during this one
constexpr int PAIRS = 4, THREADS = 64 * PAIRS, TM = 16 * PAIRS;  // a pair of warps owns 16 rows of the tile
constexpr uint32_t SIGN2 = 0x80008000u;

// Shared memory of a tile of TM rows h by TN columns u at width W, in bf16
// elements: the operator [2][TN][lk] (Cr, Ci; rows u, every v) and eta
// [TM][kp] complex (every v), shared by the warps; then per warp pair its
// ring of raw s_c chunks [STAGES][16][TK] complex, its x planes
// [2 buffers][2][16][LX] (xr, xi) and its s_c at the tile's columns [16][le]
// (the epilogue's conj(s_c)). Every region starts on 16 bytes.
struct Layout {
  int kp;       // W rounded up to TK: the chunks' v range, zeros past W
  int lk;       // operator row stride kp + 8 (kp % 32 == 0: rows 4 words apart mod 16, no bank conflicts)
  int le;       // s_c row stride 2 TN + 16: rows 8 words apart mod 32, a half-warp's 8-byte reads hit 32 banks
  size_t eta, pair0, x, es, per_pair, elems;  // x and es: offsets inside a pair's region

  __host__ __device__ Layout(int TN, int W) {
    kp = (W + TK - 1) / TK * TK;
    lk = kp + 8;
    le = 2 * TN + 16;
    eta = (size_t)2 * TN * lk;
    pair0 = eta + (size_t)TM * kp * 2;
    x = (size_t)STAGES * 16 * TK * 2;
    es = x + (size_t)2 * 2 * 16 * LX;
    per_pair = es + (size_t)16 * le;
    elems = pair0 + PAIRS * per_pair;
  }
  __host__ __device__ size_t bytes() const { return elems * 2; }
};

// a bf16 (re, im) pair packed in a 32-bit word (re in the low half)
__device__ __forceinline__ float re_of(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float im_of(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the complex pixels (h, u) and (h, u + 1) of one [H, W] complex plane ``p``
// as two words, zeros where outside; one 8-byte load when W is even
__device__ __forceinline__ uint2 load_pair(const bf16* p, int h, int u, int H, int W) {
  uint2 r = make_uint2(0u, 0u);
  if (h >= H || u >= W) return r;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p + ((size_t)h * W + u) * 2);
  if (W % 2 == 0) return *reinterpret_cast<const uint2*>(q);
  r.x = q[0];
  if (u + 1 < W) r.y = q[1];
  return r;
}

// the 64 threads of warp pair ``pair`` wait for each other (named barrier 1 + pair)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// The wide route: the first version's design, one block of 4 warps per 32
// rows h x 64 columns u x example, for the widths whose operator rows no
// on-chip tile holds (W > 480). The tile keeps no [W, W] operator row on
// chip: it loops over coils and, inside, over 32-deep chunks of v, staging
// x = s_c*eta (formed in float32, rounded once to bf16) and the chunk's rows
// of the operator (Cr, and Ci = (Cr+Ci) - Cr rounded once, again for every
// coil) through registers, loaded one chunk ahead, with a block barrier on
// each side of each chunk's four real products. Its shared memory (20 KB,
// static) does not depend on W, so every W has a route. The rounding points,
// the float32 accumulation and the coil sum in coil order are the on-chip
// kernel's; only the order of the v sums differs.
namespace wide {

constexpr int TM = 32;        // rows h per block
constexpr int TN = 64;        // output columns u per block
constexpr int TK = 32;        // v per staged chunk (two k16 steps)
constexpr int LDS = TK + 8;   // shared-memory row stride in bf16: 20 words, fragment loads hit 32 banks
constexpr int THREADS = 128;  // 4 warps: 2 (h) x 2 (u), 16 x 32 outputs each
constexpr int SMEM = (2 * TM + 2 * TN) * LDS * 2;  // static shared memory, bytes

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

// eta at pixels pix .. pix + 3 (the first n / 2 valid): 16 bytes of a
// [.., 2] eta, or (backward) channels 2:4 of g [.., 4], four 4-byte loads
template <bool BWD>
__device__ __forceinline__ uint4 load_eta(const bf16* e, size_t pix, int n, bool vec) {
  if (!BWD) return load8(e + pix * 2, n, vec);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = 2 * i < n ? ld32(e + (pix + i) * 4 + 2) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One chunk's global data in registers, from its load (issued before the
// previous chunk's MMAs) to its conversion into shared memory: each thread
// owns two 4-pixel pieces of the x chunk (eta and s_c) and two 8-value
// pieces of each operator plane.
struct Stage {
  uint4 eta[2], sens[2], cr[2], cs[2];
};

template <bool BWD>
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
  const bf16* eta_b = eta + (size_t)b * HW * (BWD ? 4 : 2);  // backward: g
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
      const size_t pix = (size_t)(h < H ? h : 0) * W + v;
      st.eta[k] = load_eta<BWD>(eta_b, pix, n, vec);
      st.sens[k] = load8(s_bc + pix * 2, n, vec);
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
        xr[i] = re_of(e[i]) * re_of(s[i]) - im_of(e[i]) * im_of(s[i]);
        xi[i] = re_of(e[i]) * im_of(s[i]) + im_of(e[i]) * re_of(s[i]);
      }
      *reinterpret_cast<uint2*>(&xr_s[q >> 3][4 * (q & 7)]) = make_uint2(pack(xr[0], xr[1]), pack(xr[2], xr[3]));
      *reinterpret_cast<uint2*>(&xi_s[q >> 3][4 * (q & 7)]) = make_uint2(pack(xi[0], xi[1]), pack(xi[2], xi[3]));
      const uint32_t r[4] = {st.cr[k].x, st.cr[k].y, st.cr[k].z, st.cr[k].w};
      const uint32_t c[4] = {st.cs[k].x, st.cs[k].y, st.cs[k].z, st.cs[k].w};
      uint32_t ci[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ci[i] = pack(re_of(c[i]) - re_of(r[i]), im_of(c[i]) - im_of(r[i]));
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
    if (it + 1 < iters) load(st, it + 1);  // in flight during this chunk's MMAs
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
        mma_bf16(ar[n], a_r, br0, br1);
        mma_bf16(ar[n], a_i, bi0 ^ SIGN2, bi1 ^ SIGN2);  // - xi * Ci
        mma_bf16(ai[n], a_i, br0, br1);
        mma_bf16(ai[n], a_r, bi0, bi1);
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
      if (BWD)
        write_bwd(eta_b, out + (size_t)b * HW * 2, (size_t)h * W + u, gr[n][j], gi[n][j], inv_sigma2);
      else
        write_out(eta_b, z0 + (size_t)b * HW * 2, out + (size_t)b * HW * 4, (size_t)h * W + u, gr[n][j],
                  gi[n][j], inv_sigma2);
    }
}

}  // namespace wide

// A tile is TM = 64 rows h by TN = 16 * WN columns u. Warp pair q owns rows
// 16q .. 16q + 15; its warps take the left and right WN n tiles. Between the
// block barriers at a tile's start (the operator and eta staged) the pairs
// run apart: each keeps its own ring of s_c chunks, its warps copy and form
// x for 8 rows each and meet at a 64-thread barrier, so one pair's copies
// and conversion overlap another's products, and two warps share each SM
// sub-partition's tensor core. The grid walks the
// tiles (b, h-tile, u-tile), u-tile fastest, so the blocks that run together
// share their rows' s_c in L2.
template <bool BWD, int WN>
__global__ void __launch_bounds__(THREADS) psf1d_dc_bf16_kernel(
    const bf16* __restrict__ eta, const bf16* __restrict__ sens, const bf16* __restrict__ mats,
    const bf16* __restrict__ z0, bf16* __restrict__ out, int B, int C, int H, int W, float inv_sigma2) {
  constexpr int TN = 16 * WN;
  static_assert(WN % 2 == 0, "B fragments come in pairs of n tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(TN, W);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t4 = lane & 3;
  const int pair = warp / 2, half = warp % 2, wn = half * 8 * WN;
  bf16* const op_s = reinterpret_cast<bf16*>(smem_raw);                 // [2][TN][lk]
  bf16* const eta_s = op_s + L.eta;                                      // [TM][kp] complex
  bf16* const ring = op_s + L.pair0 + pair * L.per_pair;                // [STAGES][16][TK] complex
  bf16* const x_s = ring + L.x;                                          // [2][2][16][LX]
  bf16* const es_s = ring + L.es;                                        // [16][le]: s_c at the tile's columns
  const size_t HW = (size_t)H * W;
  const bool vec = W % 8 == 0;  // 16-byte copies stay aligned on every row
  const int kp = L.kp, lk = L.lk, le = L.le, nk = kp / TK, iters = C * nk;
  const int nh = (H + TM - 1) / TM, nu = (W + TN - 1) / TN, units = B * nh * nu;
  // ldmatrix row addresses, lanes 8j..8j+7 for matrix j: A (x rows h, v
  // contiguous) takes (row, v) offsets (+0, +0), (+8, +0), (+0, +8), (+8, +8)
  // into a0..a3; B (operator rows u, v contiguous) takes (+0, +0), (+0, +8),
  // (+8, +0), (+8, +8): b0, b1 of n tile n, then of n tile n + 1
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int u0 = (unit % nu) * TN, h0 = (unit / nu % nh) * TM, b = unit / (nu * nh);
    const int hp = h0 + 16 * pair;  // this pair's first row
    const bf16* eta_b = eta + (size_t)b * HW * (BWD ? 4 : 2);  // backward: g
    const bf16* s_b = sens + (size_t)b * C * HW * 2;
    const bf16* m_b = mats + (size_t)b * 3 * W * W;
    __syncthreads();  // the previous tile is done with shared memory

    // one group: the operator's rows u0.. (planes Cr and Cr+Ci as delivered)
    // and eta's rows, zeros past W and H. A ragged W (odd rows) stages the
    // operator with plain loads.
    for (int r = warp; r < TN; r += 2 * PAIRS) {
      const int u = u0 + r;
      for (int v = 8 * lane; v < kp; v += 8 * 32)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          bf16* dst = op_s + ((size_t)p * TN + r) * lk + v;
          const bf16* src = m_b + (size_t)p * W * W + (size_t)u * W + v;
          if (vec) {
            const bool ok = u < W && v < W;
            cp_async16(dst, ok ? src : m_b, ok);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) dst[j] = u < W && v + j < W ? src[j] : __float2bfloat16(0.f);
          }
        }
    }
    for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
      const int h = h0 + r;
      bf16* dst = eta_s + (size_t)r * kp * 2;
      if (!BWD && vec) {
        for (int v = 4 * lane; v < kp; v += 4 * 32) {
          const bool ok = h < H && v < W;
          cp_async16(dst + 2 * v, ok ? eta_b + ((size_t)h * W + v) * 2 : eta_b, ok);
        }
      } else {  // 4 bytes a pixel: eta [.., 2] at a ragged W, or channels 2:4 of g [.., 4]
        for (int v = lane; v < kp; v += 32) {
          const bool ok = h < H && v < W;
          const bf16* src = eta_b + ((size_t)h * W + v) * (BWD ? 4 : 2) + (BWD ? 2 : 0);
          cp_async4(dst + 2 * v, ok ? src : eta_b, ok);
        }
      }
    }
    cp_async_commit();

    // this warp's 8 of its pair's rows of raw s_c of chunk i (coil i / nk, v
    // from (i % nk) * TK) into the pair's ring slot i % STAGES, zeros past H
    // and W; one group per chunk, empty past the last
    auto issue = [&](int i) {
      if (i < iters) {
        const bf16* s_c = s_b + (size_t)(i / nk) * HW * 2;
        const int v0 = (i % nk) * TK;
        bf16* slot = ring + (size_t)(i % STAGES) * 16 * TK * 2;
        if (vec) {
#pragma unroll
          for (int e = half * 8 * (TK / 4) + lane; e < (half + 1) * 8 * (TK / 4); e += 32) {
            const int h = hp + e / (TK / 4), v = v0 + 4 * (e % (TK / 4));
            const bool ok = h < H && v < W;
            cp_async16(slot + (size_t)e * 8, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        } else {
          for (int e = half * 8 * TK + lane; e < (half + 1) * 8 * TK; e += 32) {
            const int h = hp + e / TK, v = v0 + e % TK;
            const bool ok = h < H && v < W;
            cp_async4(slot + (size_t)e * 2, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        }
      }
      cp_async_commit();
    };

    // x = s_c * eta of chunk i for this warp's 8 rows into x buffer i % 2,
    // formed in float32 from the staged bf16 values and rounded once into the
    // planes (xr, xi), 4 pixels a step. s_c at the tile's columns is kept for
    // the epilogue.
    auto convert = [&](int i) {
      const bf16* slot = ring + (size_t)(i % STAGES) * 16 * TK * 2;
      bf16* xb = x_s + (size_t)(i % 2) * 2 * 16 * LX;
      const int v0 = (i % nk) * TK;
#pragma unroll
      for (int e = half * 8 * (TK / 4) + lane; e < (half + 1) * 8 * (TK / 4); e += 32) {
        const int r = e / (TK / 4), c4 = 4 * (e % (TK / 4));
        const uint4 sv = *reinterpret_cast<const uint4*>(slot + (size_t)e * 8);
        const uint4 ev = *reinterpret_cast<const uint4*>(eta_s + ((size_t)(16 * pair + r) * kp + v0 + c4) * 2);
        const int ue = v0 + c4 - u0;
        if (ue >= 0 && ue < TN) *reinterpret_cast<uint4*>(es_s + (size_t)r * le + 2 * ue) = sv;
        const uint32_t s4[4] = {sv.x, sv.y, sv.z, sv.w}, e4[4] = {ev.x, ev.y, ev.z, ev.w};
        float xr[4], xi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          xr[j] = re_of(e4[j]) * re_of(s4[j]) - im_of(e4[j]) * im_of(s4[j]);
          xi[j] = re_of(e4[j]) * im_of(s4[j]) + im_of(e4[j]) * re_of(s4[j]);
        }
        const size_t o = (size_t)r * LX + c4;
        *reinterpret_cast<uint2*>(xb + o) = make_uint2(pack(xr[0], xr[1]), pack(xr[2], xr[3]));
        *reinterpret_cast<uint2*>(xb + 16 * LX + o) = make_uint2(pack(xi[0], xi[1]), pack(xi[2], xi[3]));
      }
    };

    // accumulator register j of n tile n: row g (+8 for j >= 2) of the pair's
    // rows, column wn+8n+2*t4+(j&1); acc[0], acc[1] this coil's re and im,
    // gr/gi the coil sum
    float acc[2][WN][4], gr[WN][4], gi[WN][4];
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) gr[n][j] = gi[n][j] = acc[0][n][j] = acc[1][n][j] = 0.f;

    for (int i = 0; i < STAGES - 1; ++i) issue(i);
    for (int i = -1; i < iters; ++i) {
      cp_async_wait<STAGES - 2>();  // chunk i + 1 (at i = -1 also the operator and eta) has landed
      if (i < 0) {
        __syncthreads();  // every thread's copies of the operator and eta
        // Ci = (Cr+Ci) - Cr in plane 1, in place
        for (int r = warp; r < TN; r += 2 * PAIRS)
          for (int v = 2 * lane; v < kp; v += 2 * 32) {
            __nv_bfloat162* c1 = reinterpret_cast<__nv_bfloat162*>(op_s + ((size_t)TN + r) * lk + v);
            const __nv_bfloat162 c0 = *reinterpret_cast<const __nv_bfloat162*>(op_s + (size_t)r * lk + v);
            *c1 = __floats2bfloat162_rn(__low2float(*c1) - __low2float(c0), __high2float(*c1) - __high2float(c0));
          }
        __syncthreads();
      } else {
        pair_sync(pair);  // x of chunk i complete; both warps' reads of x buffer i - 1 are done
      }
      issue(i + STAGES);  // into the slot chunk i was converted from
      if (i >= 0) {
        const int kc = i % nk;
        const bf16* xb = x_s + (size_t)(i % 2) * 2 * 16 * LX;
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16) {
          uint32_t a[2][4];
#pragma unroll
          for (int p = 0; p < 2; ++p) ldsm4(a[p], xb + ((size_t)p * 16 + a_row) * LX + kk + a_col);
#pragma unroll
          for (int n = 0; n < WN; n += 2) {
            uint32_t bq[2][4];
#pragma unroll
            for (int p = 0; p < 2; ++p)
              ldsm4(bq[p], op_s + ((size_t)p * TN + wn + 8 * n + b_row) * lk + kc * TK + kk + b_col);
#pragma unroll
            for (int j = 0; j < 2; ++j) {  // re += xr Cr - xi Ci, im += xr Ci + xi Cr
              mma_bf16(acc[0][n + j], a[0], bq[0][2 * j], bq[0][2 * j + 1]);
              mma_bf16(acc[0][n + j], a[1], bq[1][2 * j] ^ SIGN2, bq[1][2 * j + 1] ^ SIGN2);
              mma_bf16(acc[1][n + j], a[0], bq[1][2 * j], bq[1][2 * j + 1]);
              mma_bf16(acc[1][n + j], a[1], bq[0][2 * j], bq[0][2 * j + 1]);
            }
          }
        }

        if (kc == nk - 1) {  // coil done: add conj(s_c) * (C s_c eta), in coil order
#pragma unroll
          for (int n = 0; n < WN; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const uint2 s =
                  *reinterpret_cast<const uint2*>(es_s + (size_t)(g + 8 * hf) * le + 2 * (wn + 8 * n + 2 * t4));
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * hf + jj;
                const uint32_t sw = jj ? s.y : s.x;
                const float re = acc[0][n][j], im = acc[1][n][j];
                gr[n][j] += re_of(sw) * re + im_of(sw) * im;
                gi[n][j] += re_of(sw) * im - im_of(sw) * re;
                acc[0][n][j] = acc[1][n][j] = 0.f;
              }
            }
          pair_sync(pair);  // both warps' reads of es are done before the conversion below may rewrite it
        }
      }
      if (i + 1 < iters) convert(i + 1);  // overlaps the products issued above
    }
    cp_async_wait<0>();  // the empty groups past the last chunk

    // outputs at (h, u) and (h, u + 1): 16 (forward) or 8 (backward) bytes a
    // pair when W is even (then u + 1 < W too), else a pixel at a time
    const bool even_w = W % 2 == 0;
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * pair + g + 8 * hf, h = h0 + r, u = u0 + wn + 8 * n + 2 * t4;
        if (h >= H || u >= W) continue;
        const size_t p = (size_t)h * W + u;
        const float gr0 = gr[n][2 * hf], gr1 = gr[n][2 * hf + 1], gi0 = gi[n][2 * hf], gi1 = gi[n][2 * hf + 1];
        if (BWD) {  // d_eta = g[..., :2] + A(g[..., 2:]) / sigma^2
          const uint32_t* gq = reinterpret_cast<const uint32_t*>(eta_b + p * 4);  // g: words (0:2, 2:4) a pixel
          uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)b * HW * 2 + p * 2);
          if (even_w) {
            const uint4 gv = *reinterpret_cast<const uint4*>(gq);
            *reinterpret_cast<uint2*>(o) =
                make_uint2(pack(re_of(gv.x) + gr0 * inv_sigma2, im_of(gv.x) + gi0 * inv_sigma2),
                           pack(re_of(gv.z) + gr1 * inv_sigma2, im_of(gv.z) + gi1 * inv_sigma2));
          } else {
            o[0] = pack(re_of(gq[0]) + gr0 * inv_sigma2, im_of(gq[0]) + gi0 * inv_sigma2);
            if (u + 1 < W) o[1] = pack(re_of(gq[2]) + gr1 * inv_sigma2, im_of(gq[2]) + gi1 * inv_sigma2);
          }
        } else {  // [eta, (A(eta) - z0) / sigma^2]
          const uint2 ev = *reinterpret_cast<const uint2*>(eta_s + ((size_t)r * kp + u) * 2);
          const uint2 zv = load_pair(z0 + (size_t)b * HW * 2, h, u, H, W);
          uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)b * HW * 4 + p * 4);
          const uint32_t w1 = pack((gr0 - re_of(zv.x)) * inv_sigma2, (gi0 - im_of(zv.x)) * inv_sigma2);
          const uint32_t w3 = pack((gr1 - re_of(zv.y)) * inv_sigma2, (gi1 - im_of(zv.y)) * inv_sigma2);
          if (even_w) {
            *reinterpret_cast<uint4*>(o) = make_uint4(ev.x, w1, ev.y, w3);
          } else {
            *reinterpret_cast<uint2*>(o) = make_uint2(ev.x, w1);
            if (u + 1 < W) *reinterpret_cast<uint2*>(o + 2) = make_uint2(ev.y, w3);
          }
        }
      }
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, int, int, int, int, float);

constexpr int ON_CHIP = 0, WIDE = 1;  // routes

// a route's kernel (null for the wide route, launched on its own grid) and
// its shared memory at width W
struct Setup {
  Kernel kernel;
  int threads, tm, tn, route;
  size_t smem;

  bool fits() const { return smem <= (size_t)MAX_DYNAMIC_SMEM; }
  // blocks of one wave (cached; the first call sets the shared-memory limit)
  cudaError_t cap(int device, int* blocks) const { return wave((const void*)kernel, threads, smem, device, blocks); }
  int units(int B, int H, int W) const { return B * ((H + tm - 1) / tm) * ((W + tn - 1) / tn); }
};

template <bool BWD, int WN>
Setup make(int W) {
  return {&psf1d_dc_bf16_kernel<BWD, WN>, THREADS, TM, 16 * WN, ON_CHIP, Layout(16 * WN, W).bytes()};
}

// The route by shape alone: 64 x 64 tiles; 64 x 32 where their shared memory
// would not fit (W > 320, up to W = 480); wider W takes the wide route.
template <bool BWD>
Setup pick(int W) {
  const Setup tiles[] = {make<BWD, 4>(W), make<BWD, 2>(W)};
  for (const Setup& s : tiles)
    if (s.fits()) return s;
  return {nullptr, wide::THREADS, wide::TM, wide::TN, WIDE, (size_t)wide::SMEM};
}

}  // namespace tc

bool bad(int B, int C, int H, int W) { return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535; }

// the wide routes' grid (both dtypes): one block a 32 x 64 tile
static_assert(tf32::wide::TM == tc::wide::TM && tf32::wide::TN == tc::wide::TN, "one wide grid");
dim3 wide_grid(int B, int H, int W) {
  return dim3((W + tf32::wide::TN - 1) / tf32::wide::TN, (H + tf32::wide::TM - 1) / tf32::wide::TM, B);
}

template <bool BWD>
int launch_f32(const void* eta, const void* sens, const void* mats, const void* z0, void* out, int B, int C, int H,
               int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  const tf32::Setup s = tf32::pick<BWD>(W);
  if (s.route == tf32::WIDE) {
    tf32::wide::psf1d_dc_f32_kernel<BWD><<<wide_grid(B, H, W), s.threads, 0, (cudaStream_t)stream>>>(
        (const float*)eta, (const float*)sens, (const float*)mats, (const float*)z0, (float*)out, C, H, W,
        inv_sigma2);
    return (int)cudaGetLastError();
  }
  int device = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = s.cap(device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int units = s.units(B, H, W);
  s.kernel<<<units < cap ? units : cap, s.threads, s.smem, (cudaStream_t)stream>>>(
      (const float*)eta, (const float*)sens, (const float*)mats, (const float*)z0, (float*)out, B, C, H, W,
      inv_sigma2);
  return (int)cudaGetLastError();
}

template <bool BWD>
int launch_bf16(const void* eta, const void* sens, const void* mats, const void* z0, void* out, int B, int C, int H,
                int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  using tc::bf16;
  const tc::Setup s = tc::pick<BWD>(W);
  if (s.route == tc::WIDE) {
    tc::wide::psf1d_dc_bf16_kernel<BWD><<<wide_grid(B, H, W), s.threads, 0, (cudaStream_t)stream>>>(
        (const bf16*)eta, (const bf16*)sens, (const bf16*)mats, (const bf16*)z0, (bf16*)out, C, H, W, inv_sigma2);
    return (int)cudaGetLastError();
  }
  int device = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = s.cap(device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int units = s.units(B, H, W);
  s.kernel<<<units < cap ? units : cap, s.threads, s.smem, (cudaStream_t)stream>>>(
      (const bf16*)eta, (const bf16*)sens, (const bf16*)mats, (const bf16*)z0, (bf16*)out, B, C, H, W, inv_sigma2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k1_psf1d_dc_f32(const void* eta, const void* sens, const void* mats, const void* z0, void* out,
                               int B, int C, int H, int W, float inv_sigma2, void* stream) {
  return launch_f32<false>(eta, sens, mats, z0, out, B, C, H, W, inv_sigma2, stream);
}

extern "C" int k1_psf1d_dc_bf16(const void* eta, const void* sens, const void* mats, const void* z0, void* out,
                                int B, int C, int H, int W, float inv_sigma2, void* stream) {
  return launch_bf16<false>(eta, sens, mats, z0, out, B, C, H, W, inv_sigma2, stream);
}

// backward: g [B, H, W, 4] -> d_eta [B, H, W, 2]
extern "C" int k1_psf1d_dc_bwd_f32(const void* g, const void* sens, const void* mats, void* out, int B, int C, int H,
                                   int W, float inv_sigma2, void* stream) {
  return launch_f32<true>(g, sens, mats, nullptr, out, B, C, H, W, inv_sigma2, stream);
}

extern "C" int k1_psf1d_dc_bwd_bf16(const void* g, const void* sens, const void* mats, void* out, int B, int C,
                                    int H, int W, float inv_sigma2, void* stream) {
  return launch_bf16<true>(g, sens, mats, nullptr, out, B, C, H, W, inv_sigma2, stream);
}

// Writes info[0..6] for k1_psf1d_dc_bf16 (bwd 0) or k1_psf1d_dc_bwd_bf16 (bwd 1)
// at [B, H, W] on ``device``: blocks of the grid, shared memory a block in
// bytes, blocks an SM, threads a block, tile rows h, tile columns u, and the
// route (0: on chip, a persistent grid of one wave, at most one block a tile;
// 1: wide, the first version's kernel, one block a tile). Every W has a route.
extern "C" int k1_psf1d_dc_bf16_setup(int bwd, int B, int H, int W, int device, int* info) {
  const tc::Setup s = bwd ? tc::pick<true>(W) : tc::pick<false>(W);
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (bad(B, 1, H, W)) return (int)cudaSuccess;
  int cap = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (s.route == tc::WIDE) {
    const dim3 grid = wide_grid(B, H, W);
    const void* kernel =
        bwd ? (const void*)tc::wide::psf1d_dc_bf16_kernel<true> : (const void*)tc::wide::psf1d_dc_bf16_kernel<false>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.threads, 0);
    info[0] = (int)(grid.x * grid.y * grid.z);
  } else {
    err = s.cap(device, &cap);
    const int units = s.units(B, H, W);
    info[0] = units < cap ? units : cap;
    per_sm = cap / (sms > 0 ? sms : 1);
  }
  if (err != cudaSuccess) return (int)err;
  info[1] = (int)s.smem;
  info[2] = per_sm;
  info[3] = s.threads;
  info[4] = s.tm;
  info[5] = s.tn;
  info[6] = s.route;
  return (int)cudaSuccess;
}

// Writes info[0..6] for k1_psf1d_dc_f32 (bwd 0) or k1_psf1d_dc_bwd_f32 (bwd 1)
// at [B, H, W] on ``device``: blocks of the grid, shared memory a block in
// bytes, blocks an SM, threads a block, tile rows h, tile columns u, and the
// route (0: on chip, a persistent grid of one wave, at most one block a tile;
// 1: wide, the first version's kernel, one block a tile). Every W has a route.
extern "C" int k1_psf1d_dc_f32_setup(int bwd, int B, int H, int W, int device, int* info) {
  const tf32::Setup s = bwd ? tf32::pick<true>(W) : tf32::pick<false>(W);
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (bad(B, 1, H, W)) return (int)cudaSuccess;
  int cap = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (s.route == tf32::WIDE) {
    const dim3 grid = wide_grid(B, H, W);
    const void* kernel =
        bwd ? (const void*)tf32::wide::psf1d_dc_f32_kernel<true> : (const void*)tf32::wide::psf1d_dc_f32_kernel<false>;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.threads, 0);
    info[0] = (int)(grid.x * grid.y * grid.z);
  } else {
    err = s.cap(device, &cap);
    const int units = s.units(B, H, W);
    info[0] = units < cap ? units : cap;
    per_sm = cap / (sms > 0 ? sms : 1);
  }
  if (err != cudaSuccess) return (int)err;
  info[1] = (int)s.smem;
  info[2] = per_sm;
  info[3] = s.threads;
  info[4] = s.tm;
  info[5] = s.tn;
  info[6] = s.route;
  return (int)cudaSuccess;
}
