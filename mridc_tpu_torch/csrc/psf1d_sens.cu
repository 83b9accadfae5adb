// K1's maps gradient: the gradient of the psf1d likelihood gradient with
// respect to the coil sensitivity maps, and d_eta in the same pass.
//
// It replaces no TPU kernel: the JAX package differentiates
// mridc_tpu/nn/dc.py:162-179 log_likelihood_gradient_psf1d (with apply_psf1d
// :144-159) with XLA's autodiff, which the learned sensitivity maps
// (mridc_tpu/nn/sens.py) need. With G = g[..., 2:] for an upstream g
// [B, H, W, 4] of out = [eta, (sum_c conj(s_c) A(s_c eta) - z0) / sigma^2],
// A the Hermitian [W, W] operator of psf1d_gauss_mats along W:
//   u_c   = A(s_c eta),   v_c = A(s_c G)
//   ds_c  = (u_c * conj(G) + v_c * conj(eta)) / sigma^2        [B, C, H, W, 2]
//   d_eta = g[..., :2] + sum_c conj(s_c) v_c / sigma^2         [B, H, W, 2]
// d_eta is what K1's backward kernel writes; here it comes from the same v_c,
// so a step whose maps take a gradient launches this kernel instead of that
// one, and the operator is read once for both.
//
// What bounds it on an H100: operations. Two complex [W, W] products per coil
// row in the Gauss form (three real products each): 12 * C * H * W^2 per
// slice, 4.7e10 at B=8, 15 coils and 320x320, against ~0.4 GB of traffic.
//
// The wide route, both dtypes at widths no on-chip tile holds (sens_kernel,
// the first version, on the CUDA cores with float32 accumulation): one block
// of 256 threads takes 32 rows h by 64 columns u of one example and walks the
// coils; for each coil it walks v in chunks of 16, staging the three operator
// planes [64 u x 16 v] (read again for every coil, from L2) and x = s_c eta,
// y = s_c G for its rows, formed in float32 from the operands and kept in
// the Gauss planes (re + im, im, re), in shared memory. A thread holds 2 rows
// by 4 columns: per v it reads three float4 of the operator and three float2
// of each of x and y (broadcast across the warp) for 48 FMAs. The coil
// epilogue writes ds_c and adds conj(s_c) v_c into d_eta's sums in
// registers, in coil order: no atomics, the same result from run to run.
//
// float32 (tf32 below, the on-chip route, W <= 320): 3xTF32 on mma.sync
// m16n8k8, as K1-f32's forward (psf1d_dc.cu, namespace tf32), with the
// operator held on chip across the coils.
//   - A persistent grid of one wave walks tiles of 16 rows h by 32 columns u,
//     one block of 8 warps an SM. A tile stages its rows of the three
//     operator planes as delivered (Cr, Cr+Ci, Ci-Cr) for every v once (123
//     KB at W = 320, dynamic shared memory) and eta's and G's 16 rows once
//     (82 KB), then streams only s_c. Past W = 320 these no longer fit.
//   - The coils are split across the warps, not v: warp w takes coils w,
//     w + 8, ..., each over the whole tile and the whole v depth, so u_c and
//     v_c of a coil lie in one warp's registers and ds_c needs no exchange
//     between warps. (A split of v would need a cross-warp sum for every
//     coil; a split of the two products, an exchange of ds_c's halves.) Each
//     warp streams its coils' rows of s_c through its own ring of 8-column
//     chunks (cp.async, two chunks in flight ahead of the one in use) and
//     meets only itself (__syncwarp) inside the coil loop.
//   - Per 8-deep step a warp forms x = s_c eta and y = s_c G in float32 at its
//     A fragments' pixels, splits the Gauss planes (re + im, im, re) of each
//     into TF32 hi and lo once (split_trunc), and splits each operator
//     fragment once for both products: 72 MMAs (hi*lo, lo*hi, hi*hi over two
//     products, three planes and four n tiles) for 48 A and 24 B splits. The
//     MMAs go to the six accumulators of an n tile in turn, so that no MMA
//     waits on the one before it.
//   - The coil epilogue runs in registers: a warp writes ds_c at its pixels
//     (s_c there read from L2, eta and G from shared memory) and adds
//     conj(s_c) v_c into its d_eta sums in float32, in its coils' order. At
//     the tile's end the warps' sums are added in warp order through shared
//     memory: no atomics, the same result from run to run.
//   - 15 coils over 8 warps leave one warp a coil short (15/16 of the
//     tile's warp time busy); at B=8 and 320x320, 1600 tiles take 13 rounds
//     of 132 SMs for 12.12 of work.
//   - tests/test_torch_port_k1.py emulates this arithmetic (the truncating
//     splits, the product order, the d_eta sums' order) and holds it to
//     chip_smoke.py's limit against the plain version and the JAX package.
//   - Widths no tile holds (W > 320) take the wide route: the launcher picks
//     the route by shape (k1_psf1d_sens_f32_setup reports it).
//   - mma.sync, not wgmma: a wgmma B operand is read from shared memory as
//     TF32 words, so 3xTF32 would need hi and lo planes of the operator
//     resident, twice its float32 bytes.
//
// bfloat16 (tc below, the on-chip route, W <= 352): the design of K1-bf16's
// forward tiles (psf1d_dc.cu, namespace tc) with two products a coil.
//   - The operator stays on chip across the coils: a persistent grid of one
//     wave walks tiles of 32 rows h by 64 columns u, one block of 8 warps an
//     SM. A tile stages its 64 rows of (Cr, Cr+Ci) for every v once (84 KB
//     at W = 320, dynamic shared memory), forms Ci = (Cr+Ci) - Cr in place,
//     rounded to bf16 again, and stages eta's and G's 32 rows once (82 KB).
//     Then it loops over the coils streaming only s_c: the first version
//     read the operator again from L2 for every coil.
//   - Row group q (warps 4q .. 4q+3) owns rows 16q .. 16q+15. It streams its
//     rows of s_c through its own ring of 32-column chunks (16-byte
//     cp.async, 4-byte at a ragged W), two chunks in flight ahead of the one
//     in use; each warp forms x = s_c eta and y = s_c G for 4 rows in float32
//     from the staged bf16 values and rounds them once into the planes (xr,
//     xi, yr, yi); the group meets at a 128-thread named barrier. No block
//     barrier runs inside a tile's coil loop.
//   - Both products on mma.sync m16n8k16 bf16 with float32 accumulate,
//     fragments by ldmatrix from rows padded by 16 bytes: warp (q, i) holds
//     u_c and v_c (re and im each) for the group's 16 rows by the tile's
//     columns 16i .. 16i+15, and each operator fragment feeds both the x and
//     the y product of the same rows: 16 MMAs for 6 ldmatrix a 16-deep step,
//     issued so that no MMA waits on the one before it.
//   - The coil epilogue runs in registers: a warp writes ds_c at its pixels,
//     reading s_c (kept in shared memory from the chunks that cover the
//     tile's columns), eta and G there from shared memory, and adds
//     conj(s_c) v_c into d_eta's float32 sums in coil order: no atomics, the
//     same result from run to run. d_eta goes out once, at the tile's end.
//   - x and y round once to bf16 (the first version keeps them in float32):
//     tests/test_torch_port_k1.py emulates this arithmetic and holds it to
//     chip_smoke.py's limit against the plain version and the JAX package.
//   - Widths no tile holds (W > 352) take the wide route, the first version's
//     kernel: the launcher picks the route by shape (k1_psf1d_sens_bf16_setup
//     reports it).
//   - mma.sync, not wgmma; TMA neither: a simple tensor-core kernel first.
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

// ---- bfloat16 on the tensor cores: the on-chip route -------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int TK = 32;      // v per chunk: two k16 steps
constexpr int LX = TK + 8;  // x/y plane row stride: the 8 rows of an ldmatrix phase hit distinct banks
constexpr int STAGES = 3;   // raw s_c chunks a row group has in flight: two ahead of the one in use
constexpr int GROUPS = 2, GROUP_WARPS = 4, GROUP_THREADS = 32 * GROUP_WARPS;
constexpr int THREADS = GROUPS * GROUP_THREADS, TM = 16 * GROUPS, TN = 16 * GROUP_WARPS;
constexpr uint32_t SIGN2 = 0x80008000u;

// Shared memory of a tile at width W, in bf16 elements: the operator
// [2][TN][lk] (Cr, Ci; rows u, every v), eta's and G's rows [TM][ke] complex
// (every v), shared by the warps; then per row group its ring of raw s_c
// chunks [STAGES][16][TK] complex, its x/y planes [2 buffers][4][16][LX]
// (xr, xi, yr, yi) and its s_c at the tile's columns [16][le]. Every region
// starts on 16 bytes.
struct Layout {
  int kp;  // W rounded up to TK: the chunks' v range, zeros past W
  int lk;  // operator row stride kp + 8 (kp % 32 == 0: rows 4 or 20 words apart mod 32, no bank conflicts)
  int ke;  // eta and G row stride 2 kp + 16: rows 8 words apart mod 32
  int le;  // s_c row stride 2 TN + 16: rows 8 words apart mod 32
  size_t eta, gg, group0, xy, es, per_group, elems;  // xy and es: offsets inside a group's region

  __host__ __device__ Layout(int W) {
    kp = (W + TK - 1) / TK * TK;
    lk = kp + 8;
    ke = 2 * kp + 16;
    le = 2 * TN + 16;
    eta = (size_t)2 * TN * lk;
    gg = eta + (size_t)TM * ke;
    group0 = gg + (size_t)TM * ke;
    xy = (size_t)STAGES * 16 * TK * 2;
    es = xy + (size_t)2 * 4 * 16 * LX;
    per_group = es + (size_t)16 * le;
    elems = group0 + GROUPS * per_group;
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

// the 128 threads of row group ``group`` wait for each other (named barrier 1 + group)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + group) : "memory");
}

// The grid walks the tiles (b, h-tile, u-tile), u-tile fastest, so the
// blocks that run together share their rows' s_c in L2.
__global__ void __launch_bounds__(THREADS, 1)
    sens_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ eta, const bf16* __restrict__ sens,
                     const bf16* __restrict__ mats, bf16* __restrict__ ds, bf16* __restrict__ d_eta, int B, int C,
                     int H, int W, float inv_sigma2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(W);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
  const int group = warp / GROUP_WARPS, quarter = warp % GROUP_WARPS, wn = 16 * quarter;
  bf16* const op_s = reinterpret_cast<bf16*>(smem_raw);            // [2][TN][lk]
  bf16* const eta_s = op_s + L.eta;                                 // [TM][ke]: eta, complex
  bf16* const g_s = op_s + L.gg;                                    // [TM][ke]: G = g[..., 2:4], complex
  bf16* const ring = op_s + L.group0 + group * L.per_group;        // [STAGES][16][TK] complex
  bf16* const xy_s = ring + L.xy;                                   // [2][4][16][LX]
  bf16* const es_s = ring + L.es;                                   // [16][le]: s_c at the tile's columns
  const size_t HW = (size_t)H * W;
  const bool vec = W % 8 == 0;  // 16-byte copies stay aligned on every row
  const bool even_w = W % 2 == 0;
  const int kp = L.kp, lk = L.lk, ke = L.ke, le = L.le, nk = kp / TK, iters = C * nk;
  const int nh = (H + TM - 1) / TM, nu = (W + TN - 1) / TN, units = B * nh * nu;
  // ldmatrix row addresses, lanes 8j..8j+7 for matrix j: A (x/y rows h, v
  // contiguous) takes (row, v) offsets (+0, +0), (+8, +0), (+0, +8), (+8, +8)
  // into a0..a3; B (operator rows u, v contiguous) takes (+0, +0), (+0, +8),
  // (+8, +0), (+8, +8): b0, b1 of n tile 0, then of n tile 1
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
  // this thread's 16-byte piece of its group's chunk: row pr (4 rows a warp), columns pc .. pc + 3
  const int piece = quarter * 32 + lane, pr = piece >> 3, pc = 4 * (piece & 7);

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int u0 = (unit % nu) * TN, h0 = (unit / nu % nh) * TM, b = unit / (nu * nh);
    const int hq = h0 + 16 * group;  // this group's first row
    const bf16* g_b = g + (size_t)b * HW * 4;
    const bf16* eta_b = eta + (size_t)b * HW * 2;
    const bf16* s_b = sens + (size_t)b * C * HW * 2;
    const bf16* m_b = mats + (size_t)b * 3 * W * W;
    __syncthreads();  // the previous tile is done with shared memory

    // one group: the operator's rows u0.. (planes Cr and Cr+Ci as delivered)
    // and eta's and G's rows, zeros past W and H. A ragged W (odd rows)
    // stages the operator with plain loads.
    for (int r = warp; r < TN; r += THREADS / 32) {
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
    for (int r = 4 * warp; r < 4 * warp + 4; ++r) {
      const int h = h0 + r;
      bf16* de = eta_s + (size_t)r * ke;
      bf16* dg = g_s + (size_t)r * ke;
      for (int v = (vec ? 4 : 1) * lane; v < kp; v += (vec ? 4 : 1) * 32) {
        const bool ok = h < H && v < W;
        const size_t px = (size_t)h * W + v;
        if (vec)
          cp_async16(de + 2 * v, ok ? eta_b + px * 2 : eta_b, ok);
        else
          cp_async4(de + 2 * v, ok ? eta_b + px * 2 : eta_b, ok);
      }
      for (int v = lane; v < kp; v += 32) {  // channels 2:4 of g: 4 bytes a pixel
        const bool ok = h < H && v < W;
        cp_async4(dg + 2 * v, ok ? g_b + ((size_t)h * W + v) * 4 + 2 : g_b, ok);
      }
    }
    cp_async_commit();

    // this thread's piece of its group's rows of raw s_c of chunk i (coil
    // i / nk, v from (i % nk) * TK) into the group's ring slot i % STAGES,
    // zeros past H and W; one group per chunk, empty past the last
    auto issue = [&](int i) {
      if (i < iters) {
        const bf16* s_c = s_b + (size_t)(i / nk) * HW * 2;
        const int v0 = (i % nk) * TK;
        bf16* slot = ring + (size_t)(i % STAGES) * 16 * TK * 2;
        if (vec) {
          const int h = hq + pr, v = v0 + pc;
          const bool ok = h < H && v < W;
          cp_async16(slot + (size_t)piece * 8, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
        } else {
#pragma unroll
          for (int e = quarter * 4 * TK + lane; e < (quarter + 1) * 4 * TK; e += 32) {
            const int h = hq + e / TK, v = v0 + e % TK;
            const bool ok = h < H && v < W;
            cp_async4(slot + (size_t)e * 2, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        }
      }
      cp_async_commit();
    };

    // x = s_c * eta and y = s_c * G of chunk i at this thread's piece into
    // x/y buffer i % 2, formed in float32 from the staged bf16 values and
    // rounded once into the planes (xr, xi, yr, yi). s_c at the tile's
    // columns is kept for the epilogue.
    auto convert = [&](int i) {
      const bf16* slot = ring + (size_t)(i % STAGES) * 16 * TK * 2;
      bf16* xb = xy_s + (size_t)(i % 2) * 4 * 16 * LX;
      const int v0 = (i % nk) * TK;
      const uint4 sv = *reinterpret_cast<const uint4*>(slot + (size_t)piece * 8);
      const size_t rowp = (size_t)(16 * group + pr) * ke + 2 * (v0 + pc);
      const uint4 ev = *reinterpret_cast<const uint4*>(eta_s + rowp);
      const uint4 gv = *reinterpret_cast<const uint4*>(g_s + rowp);
      const int ue = v0 + pc - u0;
      if (ue >= 0 && ue < TN) *reinterpret_cast<uint4*>(es_s + (size_t)pr * le + 2 * ue) = sv;
      const uint32_t s4[4] = {sv.x, sv.y, sv.z, sv.w}, e4[4] = {ev.x, ev.y, ev.z, ev.w};
      const uint32_t g4[4] = {gv.x, gv.y, gv.z, gv.w};
      float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float sr = re_of(s4[j]), si = im_of(s4[j]);
        xr[j] = re_of(e4[j]) * sr - im_of(e4[j]) * si;
        xi[j] = re_of(e4[j]) * si + im_of(e4[j]) * sr;
        yr[j] = re_of(g4[j]) * sr - im_of(g4[j]) * si;
        yi[j] = re_of(g4[j]) * si + im_of(g4[j]) * sr;
      }
      const size_t o = (size_t)pr * LX + pc;
      *reinterpret_cast<uint2*>(xb + o) = make_uint2(pack(xr[0], xr[1]), pack(xr[2], xr[3]));
      *reinterpret_cast<uint2*>(xb + 16 * LX + o) = make_uint2(pack(xi[0], xi[1]), pack(xi[2], xi[3]));
      *reinterpret_cast<uint2*>(xb + 32 * LX + o) = make_uint2(pack(yr[0], yr[1]), pack(yr[2], yr[3]));
      *reinterpret_cast<uint2*>(xb + 48 * LX + o) = make_uint2(pack(yi[0], yi[1]), pack(yi[2], yi[3]));
    };

    // accumulator register j of n tile n: row gq (+8 for j >= 2) of the
    // group's rows, column wn + 8n + 2*t4 + (j&1) of the tile; acc[0..3] this
    // coil's u_c re, u_c im, v_c re, v_c im; der/dei d_eta's coil sums
    float acc[4][2][4], der[2][4], dei[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        der[n][j] = dei[n][j] = 0.f;
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[p][n][j] = 0.f;
      }

    for (int i = 0; i < STAGES - 1; ++i) issue(i);
    for (int i = -1; i < iters; ++i) {
      cp_async_wait<STAGES - 2>();  // chunk i + 1 (at i = -1 also the operator, eta and G) has landed
      if (i < 0) {
        __syncthreads();  // every thread's copies of the operator, eta and G
        // Ci = (Cr+Ci) - Cr in plane 1, in place
        for (int r = warp; r < TN; r += THREADS / 32)
          for (int v = 2 * lane; v < kp; v += 2 * 32) {
            __nv_bfloat162* c1 = reinterpret_cast<__nv_bfloat162*>(op_s + ((size_t)TN + r) * lk + v);
            const __nv_bfloat162 c0 = *reinterpret_cast<const __nv_bfloat162*>(op_s + (size_t)r * lk + v);
            *c1 = __floats2bfloat162_rn(__low2float(*c1) - __low2float(c0), __high2float(*c1) - __high2float(c0));
          }
        __syncthreads();
      } else {
        group_sync(group);  // x/y of chunk i complete; every warp's reads of x/y buffer i - 1 are done
      }
      issue(i + STAGES);  // into the slot chunk i was converted from
      if (i >= 0) {
        const int kc = i % nk;
        const bf16* xb = xy_s + (size_t)(i % 2) * 4 * 16 * LX;
#pragma unroll
        for (int kk = 0; kk < TK; kk += 16) {
          uint32_t a[4][4], bq[2][4];
#pragma unroll
          for (int p = 0; p < 4; ++p) ldsm4(a[p], xb + ((size_t)p * 16 + a_row) * LX + kk + a_col);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm4(bq[p], op_s + ((size_t)p * TN + wn + b_row) * lk + kc * TK + kk + b_col);
          // u: re += xr Cr - xi Ci, im += xr Ci + xi Cr; v likewise from (yr, yi). The
          // MMAs issue in program order (asm volatile): the eight accumulators take
          // their first product, then their second, so that no MMA waits on the one
          // just before it.
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[0][n], a[0], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[1][n], a[0], bq[1][2 * n], bq[1][2 * n + 1]);
            mma_bf16(acc[2][n], a[2], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[3][n], a[2], bq[1][2 * n], bq[1][2 * n + 1]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[0][n], a[1], bq[1][2 * n] ^ SIGN2, bq[1][2 * n + 1] ^ SIGN2);
            mma_bf16(acc[1][n], a[1], bq[0][2 * n], bq[0][2 * n + 1]);
            mma_bf16(acc[2][n], a[3], bq[1][2 * n] ^ SIGN2, bq[1][2 * n + 1] ^ SIGN2);
            mma_bf16(acc[3][n], a[3], bq[0][2 * n], bq[0][2 * n + 1]);
          }
        }

        if (kc == nk - 1) {  // coil done: ds_c, and conj(s_c) v_c into d_eta's sums, in coil order
          bf16* ds_c = ds + ((size_t)b * C + i / nk) * HW * 2;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int r = gq + 8 * hf, ul = wn + 8 * n + 2 * t4, h = hq + r, u = u0 + ul;
              const uint2 sw = *reinterpret_cast<const uint2*>(es_s + (size_t)r * le + 2 * ul);
              const size_t rowp = (size_t)(16 * group + r) * ke + 2 * (u < kp ? u : 0);
              const uint2 ew = *reinterpret_cast<const uint2*>(eta_s + rowp);
              const uint2 gw = *reinterpret_cast<const uint2*>(g_s + rowp);
              uint32_t out[2];
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) {
                const int j = 2 * hf + jj;
                const uint32_t s1 = jj ? sw.y : sw.x, e1 = jj ? ew.y : ew.x, g1 = jj ? gw.y : gw.x;
                const float ur = acc[0][n][j], ui = acc[1][n][j], vr = acc[2][n][j], vi = acc[3][n][j];
                const float gr = re_of(g1), gi = im_of(g1), er = re_of(e1), ei = im_of(e1);
                out[jj] = pack((ur * gr + ui * gi + vr * er + vi * ei) * inv_sigma2,
                               (ui * gr - ur * gi + vi * er - vr * ei) * inv_sigma2);
                der[n][j] += re_of(s1) * vr + im_of(s1) * vi;
                dei[n][j] += re_of(s1) * vi - im_of(s1) * vr;
#pragma unroll
                for (int p = 0; p < 4; ++p) acc[p][n][j] = 0.f;
              }
              if (h < H && u < W) {
                uint32_t* o = reinterpret_cast<uint32_t*>(ds_c + ((size_t)h * W + u) * 2);
                if (even_w) {
                  *reinterpret_cast<uint2*>(o) = make_uint2(out[0], out[1]);
                } else {
                  o[0] = out[0];
                  if (u + 1 < W) o[1] = out[1];
                }
              }
            }
          group_sync(group);  // every warp's reads of es are done before the conversion below may rewrite it
        }
      }
      if (i + 1 < iters) convert(i + 1);  // overlaps the products issued above
    }
    cp_async_wait<0>();  // the empty groups past the last chunk

    // d_eta = g[..., :2] + sum_c conj(s_c) v_c / sigma^2 at (h, u) and (h, u + 1):
    // 8 bytes a pair when W is even (then u + 1 < W too), else a pixel at a time
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int h = hq + gq + 8 * hf, u = u0 + wn + 8 * n + 2 * t4;
        if (h >= H || u >= W) continue;
        const size_t p = (size_t)h * W + u;
        const uint32_t* gw = reinterpret_cast<const uint32_t*>(g_b + p * 4);  // words (0:2, 2:4) a pixel
        uint32_t* o = reinterpret_cast<uint32_t*>(d_eta + (size_t)b * HW * 2 + p * 2);
        const uint32_t w0 = pack(re_of(gw[0]) + der[n][2 * hf] * inv_sigma2, im_of(gw[0]) + dei[n][2 * hf] * inv_sigma2);
        if (even_w) {
          const uint32_t w1 = pack(re_of(gw[2]) + der[n][2 * hf + 1] * inv_sigma2,
                                   im_of(gw[2]) + dei[n][2 * hf + 1] * inv_sigma2);
          *reinterpret_cast<uint2*>(o) = make_uint2(w0, w1);
        } else {
          o[0] = w0;
          if (u + 1 < W)
            o[1] = pack(re_of(gw[2]) + der[n][2 * hf + 1] * inv_sigma2, im_of(gw[2]) + dei[n][2 * hf + 1] * inv_sigma2);
        }
      }
  }
}

constexpr int ON_CHIP = 0, WIDE = 1;  // routes

// the route at width W: the on-chip tile where its shared memory fits (W <= 352), else the wide route
inline int route(int W) { return Layout(W).bytes() <= (size_t)MAX_DYNAMIC_SMEM ? ON_CHIP : WIDE; }

inline int units(int B, int H, int W) { return B * ((H + TM - 1) / TM) * ((W + TN - 1) / TN); }

}  // namespace tc

// ---- float32 on 3xTF32 tensor cores: the on-chip route ----------------------

namespace tf32 {

constexpr int KW = 8;      // v per chunk: one k8 step
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int TM = 16;     // rows h a tile
constexpr int TN = 32;     // columns u a tile
constexpr int NT = TN / 8;  // n tiles of 8 columns a warp
constexpr int STAGES = 3;  // raw s_c chunks a warp has in flight: two ahead of the one in use

// Shared memory of a tile at width W, in floats: eta's and G's rows [TM][2
// kp] each (complex, every v), the operator [3][TN][kp] (planes Cr, Cr+Ci,
// Ci-Cr as delivered; rows u, every v), then each warp's ring
// [STAGES][16][2 KW] of raw s_c. kp is W rounded up to 32, zeros past W. Rows
// are swizzled, not padded (op_sw, row_sw). At the tile's end the region from
// eta's rows on holds the warps' d_eta sums ([WARPS][TN][32], ``scratch``).
struct Layout {
  int kp;
  size_t gg, op, ring, floats;

  __host__ __device__ explicit Layout(int W) {
    kp = (W + 31) / 32 * 32;
    gg = (size_t)TM * 2 * kp;
    op = 2 * gg;
    ring = op + (size_t)3 * TN * kp;
    floats = ring + (size_t)WARPS * STAGES * 16 * 2 * KW;
    const size_t scratch = (size_t)WARPS * TN * 32;
    if (scratch > floats) floats = scratch;
  }
  __host__ __device__ size_t bytes() const { return floats * 4; }
};

// word of v in operator row r: the 64-bit B fragment loads of a half warp
// (rows g = 0..3) fall 8 words apart mod 32, on 32 distinct banks
__device__ __forceinline__ int op_sw(int r, int v) { return v ^ ((r & 3) << 3); }
// word of complex pixel v in eta's or G's row r: the 128-bit A loads of a
// quarter warp (rows 2q, 2q + 1) fall 16 words apart mod 32
__device__ __forceinline__ int row_sw(int r, int v) { return (2 * v) ^ ((r & 1) << 4); }

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

// The Gauss form over the planes as delivered: A planes (xr + xi, xi, xr),
// B planes (Cr, Cr + Ci, Ci - Cr), k1 = Cr (xr + xi), k2 = (Cr + Ci) xi,
// k3 = (Ci - Cr) xr, re = k1 - k2, im = k1 + k3; y likewise. Inside each k8
// step the pixels v0 + 2 t4 and v0 + 2 t4 + 1 stand for k = t4 and t4 + 4 of
// the fragment layout (a permutation of v applied to A and B alike), so that
// a lane's B fragment is one 64-bit load and its A pixels one 128-bit load
// per row. The grid walks the tiles (b, h-tile, u-tile), u-tile fastest.
__global__ void __launch_bounds__(THREADS, 1)
    sens_f32_kernel(const float* __restrict__ g, const float* __restrict__ eta, const float* __restrict__ sens,
                    const float* __restrict__ mats, float* __restrict__ ds, float* __restrict__ d_eta, int B, int C,
                    int H, int W, float inv_sigma2) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* const smem = reinterpret_cast<float*>(smem_f32);
  const Layout L(W);
  const int kp = L.kp;
  const size_t plane = (size_t)TN * kp;  // floats of one operator plane
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
  float* const eta_s = smem;                                                // [TM][2 kp]
  float* const g_s = smem + L.gg;                                           // [TM][2 kp]: G = g[..., 2:4]
  float* const op_s = smem + L.op;                                          // [3][TN][kp]
  float* const ring = smem + L.ring + (size_t)warp * STAGES * 16 * 2 * KW;  // [STAGES][16][2 KW]
  const size_t HW = (size_t)H * W;
  const bool vec4 = W % 4 == 0;  // 16-byte copies of operator rows stay aligned
  const bool even = W % 2 == 0;  // 16-byte copies of complex pixel pairs stay aligned
  const int nk = (W + KW - 1) / KW;
  const int mine = warp < C ? (C - warp + WARPS - 1) / WARPS : 0;  // this warp's coils: warp, warp + 8, ...
  const int nh = (H + TM - 1) / TM, nu = (W + TN - 1) / TN, units = B * nh * nu;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int u0 = (unit % nu) * TN, h0 = (unit / nu % nh) * TM, b = unit / (nu * nh);
    const float* g_b = g + (size_t)b * HW * 4;
    const float* eta_b = eta + (size_t)b * HW * 2;
    const float* s_b = sens + (size_t)b * C * HW * 2;
    const float* m_b = mats + (size_t)b * 3 * W * W;
    __syncthreads();  // the previous tile is done with shared memory

    // one group: the operator's rows u0.. of the three planes and eta's and
    // G's rows, for every v, zeros past W and H
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
      const size_t o = (size_t)r * 2 * kp;
      const float* se = eta_b + ((size_t)h * W + v) * 2;
      const float* sg = g_b + ((size_t)h * W + v) * 4 + 2;
      if (even) {
        const bool ok = h < H && v < W;
        cp_async16(eta_s + o + row_sw(r, v), ok ? se : eta_b, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = h < H && v + j < W;
          cp_async8(eta_s + o + row_sw(r, v + j), ok ? se + 2 * j : eta_b, ok);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // channels 2:4 of g: 8 bytes a pixel
        const bool ok = h < H && v + j < W;
        cp_async8(g_s + o + row_sw(r, v + j), ok ? sg + 4 * j : g_b, ok);
      }
    }
    cp_async_commit();

    // this warp's next chunk of raw s_c (its coil ik, chunk ij of v: 16 rows
    // x 8 pixels) into ring slot is, zeros past H and W; one group per call,
    // empty past the last chunk
    int ik = 0, ij = 0, is = 0;
    auto copy_next = [&]() {
      if (ik < mine) {
        const float* s_c = s_b + (size_t)(warp + WARPS * ik) * HW * 2;
        const int v0 = ij * KW;
        float* slot = ring + (size_t)is * 16 * 2 * KW;
        if (even) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int e = lane + 32 * k, h = h0 + e / 4, v = v0 + 2 * (e % 4);  // row e / 4, pixels 2 (e % 4), +1
            const bool ok = h < H && v < W;
            cp_async16(slot + 4 * e, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = lane + 32 * k, h = h0 + e / 8, v = v0 + e % 8;  // row e / 8, pixel e % 8
            const bool ok = h < H && v < W;
            cp_async8(slot + 2 * e, ok ? s_c + ((size_t)h * W + v) * 2 : s_c, ok);
          }
        }
        if (++ij == nk) ij = 0, ++ik;
        is = is + 1 == STAGES ? 0 : is + 1;
      }
      cp_async_commit();
    };

    // der/dei[n][j]: this warp's d_eta sums at accumulator register j of n
    // tile n: row gq (+8 for j >= 2), column 8n + 2 t4 + (j & 1) of the tile
    float der[NT][4], dei[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) der[n][j] = dei[n][j] = 0.f;

    for (int t = 0; t < STAGES - 1; ++t) copy_next();
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // every thread's copies of the operator, eta and G (and its chunk 0) have landed
    int slot = 0;
    for (int k = 0; k < mine; ++k) {
      const int c = warp + WARPS * k;
      // acc[q][p][n][j]: product q (0: u_c from x, 1: v_c from y), Gauss plane p
      float acc[2][3][NT][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[q][p][n][j] = 0.f;

      for (int jc = 0; jc < nk; ++jc) {
        if (k + jc > 0) {
          cp_async_wait<STAGES - 2>();  // this chunk has landed (this lane's copies) ...
          __syncwarp();                 // ... every lane's, and every lane is done with the slot refilled below
        }
        const float* sl = ring + (size_t)slot * 16 * 2 * KW;
        slot = slot + 1 == STAGES ? 0 : slot + 1;
        copy_next();
        const int v0 = jc * KW;
        Split a[2][3][4];  // A fragments of x and y in the planes (re + im, im, re)
        {
          float xr[4], xi[4], yr[4], yi[4];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {  // rows gq and gq + 8: pixels v0 + 2 t4 (j = hf), v0 + 2 t4 + 1 (j = 2 + hf)
            const int r = gq + 8 * hf;
            const size_t o = (size_t)r * 2 * kp + row_sw(r, v0 + 2 * t4);
            const float4 s = *reinterpret_cast<const float4*>(sl + r * 2 * KW + 4 * t4);
            const float4 e = *reinterpret_cast<const float4*>(eta_s + o);
            const float4 q = *reinterpret_cast<const float4*>(g_s + o);
            xr[hf] = e.x * s.x - e.y * s.y;
            xi[hf] = e.x * s.y + e.y * s.x;
            xr[2 + hf] = e.z * s.z - e.w * s.w;
            xi[2 + hf] = e.z * s.w + e.w * s.z;
            yr[hf] = q.x * s.x - q.y * s.y;
            yi[hf] = q.x * s.y + q.y * s.x;
            yr[2 + hf] = q.z * s.z - q.w * s.w;
            yi[2 + hf] = q.z * s.w + q.w * s.z;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a[0][0][j] = split_trunc(xr[j] + xi[j]);
            a[0][1][j] = split_trunc(xi[j]);
            a[0][2][j] = split_trunc(xr[j]);
            a[1][0][j] = split_trunc(yr[j] + yi[j]);
            a[1][1][j] = split_trunc(yi[j]);
            a[1][2][j] = split_trunc(yr[j]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int r = 8 * n + gq;  // operator row (u) in the tile
          const float* bp = op_s + (size_t)r * kp + op_sw(r, v0 + 2 * t4);
          Split bs[3][2];  // each split feeds both products
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const float2 bv = *reinterpret_cast<const float2*>(bp + p * plane);
            bs[p][0] = split_trunc(bv.x);
            bs[p][1] = split_trunc(bv.y);
          }
          // mma3's terms (hi*lo, lo*hi, hi*hi) in turn over the n tile's six
          // accumulators: each accumulator sums them in mma3's order, and no
          // MMA waits on the one before it
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].hi, a[q][p][1].hi, a[q][p][2].hi, a[q][p][3].hi, bs[p][0].lo,
                       bs[p][1].lo);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].lo, a[q][p][1].lo, a[q][p][2].lo, a[q][p][3].lo, bs[p][0].hi,
                       bs[p][1].hi);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              mma_tf32(acc[q][p][n], a[q][p][0].hi, a[q][p][1].hi, a[q][p][2].hi, a[q][p][3].hi, bs[p][0].hi,
                       bs[p][1].hi);
        }
      }

      // coil done: ds_c at this lane's pixels, and conj(s_c) v_c into d_eta's sums
      const float* s_c = s_b + (size_t)c * HW * 2;
      float* ds_c = ds + ((size_t)b * C + c) * HW * 2;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = gq + 8 * hf, h = h0 + r, u = u0 + 8 * n + 2 * t4;
          const float4 sv = load_pair(s_c, h, u, H, W);
          const size_t o = (size_t)r * 2 * kp + row_sw(r, u);
          const float4 ev = *reinterpret_cast<const float4*>(eta_s + o);
          const float4 gv = *reinterpret_cast<const float4*>(g_s + o);
          float out[4];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * hf + jj;
            const float ur = acc[0][0][n][j] - acc[0][1][n][j], ui = acc[0][0][n][j] + acc[0][2][n][j];
            const float vr = acc[1][0][n][j] - acc[1][1][n][j], vi = acc[1][0][n][j] + acc[1][2][n][j];
            const float er = jj ? ev.z : ev.x, ei = jj ? ev.w : ev.y, gr = jj ? gv.z : gv.x, gi = jj ? gv.w : gv.y;
            const float sr = jj ? sv.z : sv.x, si = jj ? sv.w : sv.y;
            // u * conj(g[..., 2:]) + v * conj(eta)
            out[2 * jj] = (ur * gr + ui * gi + vr * er + vi * ei) * inv_sigma2;
            out[2 * jj + 1] = (ui * gr - ur * gi + vi * er - vr * ei) * inv_sigma2;
            der[n][j] += sr * vr + si * vi;
            dei[n][j] += sr * vi - si * vr;
          }
          if (h < H && u < W) {
            float* o4 = ds_c + ((size_t)h * W + u) * 2;
            if (even) {
              *reinterpret_cast<float4*>(o4) = make_float4(out[0], out[1], out[2], out[3]);
            } else {
              o4[0] = out[0];
              o4[1] = out[1];
              if (u + 1 < W) o4[2] = out[2], o4[3] = out[3];
            }
          }
        }
    }
    cp_async_wait<0>();  // the empty groups past the last chunk

    // d_eta = g[..., :2] + (the warps' sums added in warp order) / sigma^2
    // (element-major: a warp's 32 lanes write 32 consecutive words)
    __syncthreads();  // every warp is done with eta's and G's rows
    float* const scratch = smem;  // [WARPS][8 NT][32]
    {
      float* dst = scratch + (size_t)warp * 8 * NT * 32 + lane;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dst[(4 * n + j) * 32] = der[n][j];
          dst[(4 * NT + 4 * n + j) * 32] = dei[n][j];
        }
    }
    __syncthreads();
    for (int e = tid; e < 4 * NT * 32; e += THREADS) {
      const int l = e % 32, i = e / 32, n = i / 4, j = i % 4;  // lane l's accumulator register j of n tile n
      const int h = h0 + (l >> 2) + 8 * (j >> 1), u = u0 + 8 * n + 2 * (l & 3) + (j & 1);
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sr += scratch[((size_t)w * 8 * NT + i) * 32 + l];
        si += scratch[((size_t)w * 8 * NT + 4 * NT + i) * 32 + l];
      }
      if (h < H && u < W) {
        const size_t p = (size_t)h * W + u;
        const float2 gv = __ldg(reinterpret_cast<const float2*>(g_b + p * 4));
        *reinterpret_cast<float2*>(d_eta + ((size_t)b * HW + p) * 2) =
            make_float2(gv.x + sr * inv_sigma2, gv.y + si * inv_sigma2);
      }
    }
  }
}

// the route at width W: the on-chip tile where its shared memory fits (W <= 320), else the wide route
inline int route(int W) { return Layout(W).bytes() <= (size_t)MAX_DYNAMIC_SMEM ? tc::ON_CHIP : tc::WIDE; }

inline int units(int B, int H, int W) { return B * ((H + TM - 1) / TM) * ((W + TN - 1) / TN); }

}  // namespace tf32

bool bad(int B, int C, int H, int W) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || B > 65535 || (H + TR - 1) / TR > 65535 ||
         (long long)H * W > (1LL << 30);
}

dim3 wide_grid(int B, int H, int W) { return dim3((W + TU - 1) / TU, (H + TR - 1) / TR, B); }

template <typename T>
int launch_wide(const void* g, const void* eta, const void* sens, const void* mats, void* ds, void* d_eta, int B,
                int C, int H, int W, float inv_sigma2, void* stream) {
  sens_kernel<T><<<wide_grid(B, H, W), THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)eta, (const T*)sens, (const T*)mats, (T*)ds, (T*)d_eta, C, H, W, inv_sigma2);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* g, const void* eta, const void* sens, const void* mats, void* ds, void* d_eta, int B,
                int C, int H, int W, float inv_sigma2, void* stream) {
  if (tc::route(W) == tc::WIDE)
    return launch_wide<__nv_bfloat16>(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
  using tc::bf16;
  const size_t smem = tc::Layout(W).bytes();
  int device = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = wave((const void*)tc::sens_bf16_kernel, tc::THREADS, smem, device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int units = tc::units(B, H, W);
  tc::sens_bf16_kernel<<<units < cap ? units : cap, tc::THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)g, (const bf16*)eta, (const bf16*)sens, (const bf16*)mats, (bf16*)ds, (bf16*)d_eta, B, C, H, W,
      inv_sigma2);
  return (int)cudaGetLastError();
}

int launch_f32(const void* g, const void* eta, const void* sens, const void* mats, void* ds, void* d_eta, int B,
               int C, int H, int W, float inv_sigma2, void* stream) {
  if (tf32::route(W) == tc::WIDE)
    return launch_wide<float>(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
  const size_t smem = tf32::Layout(W).bytes();
  int device = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = wave((const void*)tf32::sens_f32_kernel, tf32::THREADS, smem, device, &cap);
  if (err != cudaSuccess) return (int)err;
  const int units = tf32::units(B, H, W);
  tf32::sens_f32_kernel<<<units < cap ? units : cap, tf32::THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)eta, (const float*)sens, (const float*)mats, (float*)ds, (float*)d_eta, B, C, H,
      W, inv_sigma2);
  return (int)cudaGetLastError();
}

}  // namespace

// g [B, H, W, 4], eta [B, H, W, 2], sens [B, C, H, W, 2], mats [B, 3, W, W] -> ds [B, C, H, W, 2],
// d_eta [B, H, W, 2], all in one dtype
extern "C" int k1_psf1d_sens_f32(const void* g, const void* eta, const void* sens, const void* mats, void* ds,
                                 void* d_eta, int B, int C, int H, int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  return launch_f32(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
}

extern "C" int k1_psf1d_sens_bf16(const void* g, const void* eta, const void* sens, const void* mats, void* ds,
                                  void* d_eta, int B, int C, int H, int W, float inv_sigma2, void* stream) {
  if (bad(B, C, H, W)) return (int)cudaErrorInvalidValue;
  return launch_bf16(g, eta, sens, mats, ds, d_eta, B, C, H, W, inv_sigma2, stream);
}

// Writes info[0..6] for k1_psf1d_sens_bf16 at [B, H, W] on ``device``: blocks
// of the grid, shared memory a block in bytes, blocks an SM, threads a block,
// tile rows h, tile columns u, and the route (0: on chip, a persistent grid
// of one wave, at most one block a tile; 1: wide, the first version's kernel,
// one block a tile). Every W has a route.
extern "C" int k1_psf1d_sens_bf16_setup(int B, int H, int W, int device, int* info) {
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (bad(B, 1, H, W)) return (int)cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int route = tc::route(W);
  if (route == tc::WIDE) {
    const dim3 grid = wide_grid(B, H, W);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)sens_kernel<__nv_bfloat16>, THREADS, 0);
    info[0] = (int)(grid.x * grid.y * grid.z);
    info[1] = (int)sizeof(float) * 3 * TK * (CU + 2 * CR);
    info[3] = THREADS;
    info[4] = TR;
    info[5] = TU;
  } else {
    const size_t smem = tc::Layout(W).bytes();
    int cap = 0;
    err = wave((const void*)tc::sens_bf16_kernel, tc::THREADS, smem, device, &cap);
    const int units = tc::units(B, H, W);
    info[0] = units < cap ? units : cap;
    per_sm = cap / (sms > 0 ? sms : 1);
    info[1] = (int)smem;
    info[3] = tc::THREADS;
    info[4] = tc::TM;
    info[5] = tc::TN;
  }
  if (err != cudaSuccess) return (int)err;
  info[2] = per_sm;
  info[6] = route;
  return (int)cudaSuccess;
}

// Writes info[0..6] for k1_psf1d_sens_f32 at [B, H, W] on ``device``, as
// k1_psf1d_sens_bf16_setup: the on-chip route takes 16 x 32 tiles up to W =
// 320, the wide route any W.
extern "C" int k1_psf1d_sens_f32_setup(int B, int H, int W, int device, int* info) {
  for (int i = 0; i < 7; ++i) info[i] = 0;
  if (bad(B, 1, H, W)) return (int)cudaSuccess;
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int route = tf32::route(W);
  if (route == tc::WIDE) {
    const dim3 grid = wide_grid(B, H, W);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, (const void*)sens_kernel<float>, THREADS, 0);
    info[0] = (int)(grid.x * grid.y * grid.z);
    info[1] = (int)sizeof(float) * 3 * TK * (CU + 2 * CR);
    info[3] = THREADS;
    info[4] = TR;
    info[5] = TU;
  } else {
    const size_t smem = tf32::Layout(W).bytes();
    int cap = 0;
    err = wave((const void*)tf32::sens_f32_kernel, tf32::THREADS, smem, device, &cap);
    const int units = tf32::units(B, H, W);
    info[0] = units < cap ? units : cap;
    per_sm = cap / (sms > 0 ? sms : 1);
    info[1] = (int)smem;
    info[3] = tf32::THREADS;
    info[4] = tf32::TM;
    info[5] = tf32::TN;
  }
  if (err != cudaSuccess) return (int)err;
  info[2] = per_sm;
  info[6] = route;
  return (int)cudaSuccess;
}
