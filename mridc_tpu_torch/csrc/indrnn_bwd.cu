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
// batch of 24 slices of 320x320), for 4*P*F*CI flops of products: 0.60 ms on
// the CUDA cores' float32 rate, above the bytes' 0.56 ms, and 0.04 ms on the
// bf16 tensor cores.
//
// Both dtypes: a persistent grid of one wave of blocks walks over tiles of
// pixels; each block keeps its share of dW, db and du in registers for its
// whole life and writes one partial, and a second kernel sums the partials
// over the blocks in block order, so the result does not depend on
// scheduling and is the same from run to run. The launch setup (shared-memory
// attribute, blocks of one wave) is computed once per kernel, shared-memory
// size and device, and cached; k3_indrnn_bwd_blocks gives the wrapper the
// grid, so that it can allocate the partials.
//
// float32 (a first version): the block stages the tile's x (float32,
// zero-padded to CI rounded up to 4), g' and h in shared memory beside W,
// writes dh as it stages, then forms dx = g' W from shared memory (4 x 4
// register tiles, CUDA-core FMAs) and adds g'^T x into dW register tiles (NMT
// 4 x 4 tiles a thread), db and du in a register a channel. Redesigning it
// (3xTF32 tensor cores, cp.async stages) is later work.
//
// bfloat16 design (tc below): both products on the tensor cores, mma.sync
// m16n8k16 bf16 with float32 accumulate. A product of two bf16 values is exact
// in float32, so the route changes only the order of the sums.
//   - Four warps, 64-pixel tiles. Two shared-memory stages hold a tile's x, g,
//     h and h' as bf16, brought in by 16-byte cp.async (zero-filled past P):
//     the next tile's copies are in flight while this tile computes. At 64 ->
//     64 channels a block takes 86 KB, so two blocks fit per SM; a third
//     stage would cost the second block, which made the float32 forward's
//     ring slower (tools/torch_k3_f32_variants.py).
//   - The staging epilogue forms g' = g [h' > 0] in place (exact in bf16),
//     writes dh = u g' rounded once with 16-byte stores, and sums db and du in
//     float32 registers, 8 channels a thread.
//   - dW += g'^T x takes the tile's pixels as the MMA's k. Both operands are
//     transposed reads of the staged rows (ldmatrix.trans). Warp w holds the
//     [16, CI] rows w, w+4 of dW (m tiles of 16 out-channels) in float32
//     registers.
//   - dx = g' W: warp w takes the tile's pixel rows 16w..16w+15; A is g' rows
//     (ldmatrix), B is W held once per block as bf16 (ldmatrix.trans). The
//     warp rounds its rows once into a staging buffer and stores them, which
//     are contiguous in device memory, with 16-byte stores.
//   - Rows of x, g and W are padded by 8 bf16 (16 bytes), so the eight rows of
//     an ldmatrix phase fall in distinct banks.
//   - Widths: CI % 16 == 0, F % 8 == 0 (F rounded up to 16 with zeros), and
//     dW in registers: CI <= 256 at F <= 64, CI <= 128 at F <= 128.
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

// ---- float32 launch ---------------------------------------------------------

namespace f32 {

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, const float*, float*,
                        float*, float*, int, int, int, int);

// the kernel, its pixel tile and shared memory for the widths; null if refused
Kernel pick(int CI, int F, int* tp, size_t* smem) {
  if (CI <= 0 || F <= 0 || F % 4 != 0 || F > THREADS) return nullptr;
  const int mtiles = (F / 4) * (round4(CI) / 4);
  *tp = pick_tp(CI, F);
  *smem = smem_floats(CI, F, *tp) * 4;
  if (*tp == 0 || mtiles > THREADS * MAX_NMT) return nullptr;
  const int nmt = (mtiles + THREADS - 1) / THREADS;
  return nmt <= 1 ? &indrnn_bwd_kernel<float, 1>
         : nmt <= 2 ? &indrnn_bwd_kernel<float, 2>
         : nmt <= 4 ? &indrnn_bwd_kernel<float, 4>
                    : &indrnn_bwd_kernel<float, 8>;
}

}  // namespace f32

// ---- bfloat16: tensor cores -------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;  // 4 warps x 16 pixel rows = one tile
constexpr int TP = 64;        // pixels a tile
constexpr int STAGES = 2;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Shared-memory layout, in bf16 elements: W [fp][lx], the dx staging rows
// [TP][lx], then STAGES stages of x [TP][lx], g [TP][lg], h [TP][F] and
// h' [TP][F]. Every region and row starts on 16 bytes.
struct Layout {
  int fp;      // F rounded up to the MMA's k of 16 (W rows and g columns past F are zeros)
  int lx, lg;  // row strides of x, W and dx, and of g: +8 spreads ldmatrix rows over the banks
  int stage;   // elements per stage

  __host__ __device__ Layout(int CI, int F) {
    fp = round16(F);
    lx = CI + 8;
    lg = fp + 8;
    stage = TP * (lx + lg + 2 * F);
  }
  __host__ __device__ size_t bytes() const {
    return 2 * ((size_t)fp * lx + (size_t)TP * lx + (size_t)STAGES * stage);
  }
};

// the TP rows of ``rows`` valid ones at ``src`` (n 16-byte vectors each,
// contiguous) into rows of stride ``ld`` at ``dst``; rows past ``rows`` zero
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src, int n, int rows) {
  const int dr = THREADS / n, dq = THREADS % n;
  int r = threadIdx.x / n, q = threadIdx.x % n;
  for (int e = threadIdx.x; e < TP * n; e += THREADS) {
    const bool ok = r < rows;
    cp_async16(dst + r * ld + 8 * q, ok ? src + 8 * e : src, ok);
    r += dr;
    q += dq;
    if (q >= n) {
      q -= n;
      ++r;
    }
  }
}

// MT: m tiles of dW a warp (16 out-channels each; F <= 64 * MT); NT: n tiles
// of dW and dx the registers hold (8 in-channels each; CI <= 8 * NT)
template <int MT, int NT>
__global__ void __launch_bounds__(THREADS) indrnn_bwd_bf16_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ h, const bf16* __restrict__ hn, const bf16* __restrict__ g,
    const bf16* __restrict__ w, const bf16* __restrict__ u, bf16* __restrict__ dx, bf16* __restrict__ dh,
    float* __restrict__ part, int P, int CI, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(CI, F);
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* dxs = ws + (size_t)L.fp * L.lx;
  bf16* stages = dxs + (size_t)TP * L.lx;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
  const int nt = CI / 8, mtiles = L.fp / 16;
  // ldmatrix row addresses: lanes 0-7, 8-15, 16-23, 24-31 address matrices
  // 0-3. Non-transposed A (rows m, k contiguous) and transposed B (rows k, n
  // contiguous) take matrices (+0, +0), (+8, +0), (+0, +8), (+8, +8) in (row,
  // column); transposed A (rows k, m contiguous) takes (+0, +0), (+0, +8),
  // (+8, +0), (+8, +8)
  const int row8 = (lane & 7) + ((lane >> 3) & 1) * 8, col8 = (lane >> 4) * 8;
  const int rowt = (lane & 7) + (lane >> 4) * 8, colt = ((lane >> 3) & 1) * 8;

  // zeros everywhere first: W rows and g columns past F stay zero (no copy
  // or store writes them), the products' k padding
  for (int e = tid; e < (int)(L.bytes() / 16); e += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int e = tid; e < F * nt; e += THREADS)
    *reinterpret_cast<uint4*>(ws + (e / nt) * L.lx + 8 * (e % nt)) = *reinterpret_cast<const uint4*>(w + 8 * e);

  // the staging epilogue: thread tid takes 8 channels (vector q) of the rows
  // r0, r0 + rstep, ...; the same channels on every tile
  const int nq = F / 8, rstep = THREADS / nq, q = tid % nq, r0 = tid / nq;
  const bool active = tid < rstep * nq;
  float uq[8], sb[8], su[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uq[j] = active ? __bfloat162float(u[8 * q + j]) : 0.f;
    sb[j] = su[j] = 0.f;
  }
  float acc_w[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_w[mi][n][j] = 0.f;

  const int tiles = (P + TP - 1) / TP;
  // copies of tile t into stage s, one group per tile (empty past the last)
  auto issue = [&](int t, int s) {
    if (t < tiles) {
      const size_t p0 = (size_t)t * TP;
      const int rows = min(TP, P - (int)p0);
      bf16* xs = stages + (size_t)s * L.stage;
      bf16* gs = xs + TP * L.lx;
      bf16* hs = gs + TP * L.lg;
      copy_rows(xs, L.lx, x + p0 * CI, nt, rows);
      copy_rows(gs, L.lg, g + p0 * F, nq, rows);
      copy_rows(hs, F, h + p0 * F, nq, rows);
      copy_rows(hs + TP * F, F, hn + p0 * F, nq, rows);
    }
    cp_async_commit();
  };

  issue(blockIdx.x, 0);
  for (int t = blockIdx.x, i = 0; t < tiles; t += gridDim.x, ++i) {
    const int s = i % STAGES, p0 = t * TP;
    cp_async_wait<0>();  // this thread's copies of tile t have landed
    __syncthreads();      // and every thread's; every thread is done with the other stage
    issue(t + gridDim.x, (s + 1) % STAGES);

    bf16* xs = stages + (size_t)s * L.stage;
    bf16* gs = xs + TP * L.lx;
    const bf16* hs = gs + TP * L.lg;
    const bf16* ns = hs + TP * F;

    // g' = g [h' > 0] in place (exact); dh = u g' rounded once; db, du
    if (active) {
      for (int r = r0; r < TP; r += rstep) {
        uint4 gv = *reinterpret_cast<const uint4*>(gs + r * L.lg + 8 * q);
        const uint4 hv = *reinterpret_cast<const uint4*>(hs + r * F + 8 * q);
        const uint4 nv = *reinterpret_cast<const uint4*>(ns + r * F + 8 * q);
        bf16* gb = reinterpret_cast<bf16*>(&gv);
        const bf16* hb = reinterpret_cast<const bf16*>(&hv);
        const bf16* nb = reinterpret_cast<const bf16*>(&nv);
        uint4 dv;
        bf16* dhb = reinterpret_cast<bf16*>(&dv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool on = __bfloat162float(nb[j]) > 0.f;
          const float gf = on ? __bfloat162float(gb[j]) : 0.f;
          gb[j] = __float2bfloat16(gf);  // exact: gf is a bf16 value or 0
          dhb[j] = __float2bfloat16(uq[j] * gf);
          sb[j] += gf;
          su[j] += __bfloat162float(hb[j]) * gf;
        }
        *reinterpret_cast<uint4*>(gs + r * L.lg + 8 * q) = gv;
        if (dh != nullptr && p0 + r < P) *reinterpret_cast<uint4*>(dh + (size_t)(p0 + r) * F + 8 * q) = dv;
      }
    }
    __syncthreads();  // g' complete

    // dW += g'^T x: m = out-channel (this warp's m tiles), n = in-channel,
    // k = the tile's pixels (rows past P are zeros)
#pragma unroll
    for (int kk = 0; kk < TP; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        if (warp + 4 * mi < mtiles) ldsm4_trans(a[mi], gs + (kk + rowt) * L.lg + 16 * (warp + 4 * mi) + colt);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        if (n >= nt) break;
        uint32_t b[4];
        ldsm4_trans(b, xs + (kk + row8) * L.lx + 8 * n + col8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          if (warp + 4 * mi >= mtiles) continue;
          mma_bf16(acc_w[mi][n], a[mi], b[0], b[1]);
          mma_bf16(acc_w[mi][n + 1], a[mi], b[2], b[3]);
        }
      }
    }

    // dx = g' W: m = this warp's 16 pixel rows, n = in-channel (8 n tiles at
    // a time), k = out-channel
    if (dx != nullptr) {
      const int pr = 16 * warp;
      for (int c0 = 0; c0 < nt; c0 += 8) {
        float acc[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
        for (int kk = 0; kk < L.fp; kk += 16) {
          uint32_t a[4];
          ldsm4(a, gs + (pr + row8) * L.lg + kk + col8);
#pragma unroll
          for (int n = 0; n < 8; n += 2) {
            if (c0 + n >= nt) break;
            uint32_t b[4];
            ldsm4_trans(b, ws + (kk + row8) * L.lx + 8 * (c0 + n) + col8);
            mma_bf16(acc[n], a, b[0], b[1]);
            mma_bf16(acc[n + 1], a, b[2], b[3]);
          }
        }
        // register j of n tile n: pixel pr+gq (+8 for j >= 2), in-channel
        // 8(c0+n)+2*t4+(j&1)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (c0 + n >= nt) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<__nv_bfloat162*>(dxs + (pr + gq + 8 * hf) * L.lx + 8 * (c0 + n) + 2 * t4) =
                __floats2bfloat162_rn(acc[n][2 * hf], acc[n][2 * hf + 1]);
        }
      }
      __syncwarp();
      // the warp's rows are contiguous in device memory: 16-byte stores
      const int m = min(16, P - p0 - pr) * nt;
      for (int e = lane; e < m; e += 32)
        *reinterpret_cast<uint4*>(dx + (size_t)(p0 + pr) * CI + 8 * e) =
            *reinterpret_cast<const uint4*>(dxs + (pr + e / nt) * L.lx + 8 * (e % nt));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: they hold the db/du reduction below

  // this block's partials: [F * CI] dW, then [F] db, then [F] du. Register j
  // of dW tile (mi, n): out-channel 16(warp+4mi)+gq (+8 for j >= 2),
  // in-channel 8n+2*t4+(j&1)
  float* pb = part + (size_t)blockIdx.x * ((size_t)F * CI + 2 * F);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    if (warp + 4 * mi >= mtiles) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = 16 * (warp + 4 * mi) + gq + 8 * hf;
        if (o < F)
          *reinterpret_cast<float2*>(pb + (size_t)o * CI + 8 * n + 2 * t4) =
              make_float2(acc_w[mi][n][2 * hf], acc_w[mi][n][2 * hf + 1]);
      }
    }
  }
  // db and du: each channel summed over its threads in thread order
  float* red = reinterpret_cast<float*>(stages);  // [THREADS][16]
  if (active) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[tid * 16 + j] = sb[j];
      red[tid * 16 + 8 + j] = su[j];
    }
  }
  __syncthreads();
  for (int o = tid; o < F; o += THREADS) {
    float b = 0.f, v = 0.f;
    for (int r = 0; r < rstep; ++r) {
      const int src = (r * nq + o / 8) * 16 + o % 8;
      b += red[src];
      v += red[src + 8];
    }
    pb[(size_t)F * CI + o] = b;
    pb[(size_t)F * CI + F + o] = v;
  }
}

using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*,
                        float*, int, int, int);

// the kernel for the widths (register tiles bucketed to powers of two); null
// if refused
Kernel pick(int CI, int F) {
  if (CI <= 0 || CI % 16 != 0 || F <= 0 || F % 8 != 0 || F > 128) return nullptr;
  const int nt = CI / 8;
  if (F <= 64)
    return nt <= 2    ? &indrnn_bwd_bf16_kernel<1, 2>
           : nt <= 4  ? &indrnn_bwd_bf16_kernel<1, 4>
           : nt <= 8  ? &indrnn_bwd_bf16_kernel<1, 8>
           : nt <= 16 ? &indrnn_bwd_bf16_kernel<1, 16>
           : nt <= 32 ? &indrnn_bwd_bf16_kernel<1, 32>
                      : nullptr;
  return nt <= 2    ? &indrnn_bwd_bf16_kernel<2, 2>
         : nt <= 4  ? &indrnn_bwd_bf16_kernel<2, 4>
         : nt <= 8  ? &indrnn_bwd_bf16_kernel<2, 8>
         : nt <= 16 ? &indrnn_bwd_bf16_kernel<2, 16>
                    : nullptr;
}

}  // namespace tc

// the launch of one dtype at given widths; ``ok`` false if the kernel does
// not take them
struct Setup {
  bool ok;
  tc::Kernel bf16_kernel;
  f32::Kernel f32_kernel;
  int threads, tp;
  size_t smem;

  Setup(bool is_bf16, int CI, int F) : bf16_kernel(nullptr), f32_kernel(nullptr) {
    if (is_bf16) {
      bf16_kernel = tc::pick(CI, F);
      threads = tc::THREADS;
      tp = tc::TP;
      smem = tc::Layout(CI, F).bytes();
      ok = bf16_kernel != nullptr && smem <= MAX_SMEM;
    } else {
      f32_kernel = f32::pick(CI, F, &tp, &smem);
      threads = THREADS;
      ok = f32_kernel != nullptr;
    }
  }
  // blocks of one wave (cached; the first call sets the shared-memory limit)
  cudaError_t cap(int device, int* blocks) const {
    const void* k = bf16_kernel != nullptr ? (const void*)bf16_kernel : (const void*)f32_kernel;
    return wave(k, threads, smem, device, blocks);
  }
};

// blocks of one wave, no more than the tiles; 0 if the widths are refused
cudaError_t grid(bool is_bf16, int P, int CI, int F, int device, int* blocks) {
  const Setup s(is_bf16, CI, F);
  int cap = 0;
  *blocks = 0;
  if (P <= 0 || !s.ok) return cudaSuccess;
  const cudaError_t err = s.cap(device, &cap);
  if (err != cudaSuccess) return err;
  const int tiles = (P + s.tp - 1) / s.tp;
  *blocks = tiles < cap ? tiles : cap;
  return cudaSuccess;
}

int launch(bool is_bf16, const void* x, const void* h, const void* hn, const void* g, const void* w, const void* u,
           void* dx, void* dh, void* part, void* sums, int P, int CI, int F, int blocks, int device, void* stream) {
  const Setup s(is_bf16, CI, F);
  int cap = 0;
  if (P <= 0 || blocks <= 0 || !s.ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = s.cap(device, &cap);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    using tc::bf16;
    const tc::Kernel kernel = s.bf16_kernel;
    kernel<<<blocks, s.threads, s.smem, st>>>((const bf16*)x, (const bf16*)h, (const bf16*)hn, (const bf16*)g,
                                              (const bf16*)w, (const bf16*)u, (bf16*)dx, (bf16*)dh, (float*)part, P,
                                              CI, F);
  } else {
    const f32::Kernel kernel = s.f32_kernel;
    kernel<<<blocks, s.threads, s.smem, st>>>((const float*)x, (const float*)h, (const float*)hn, (const float*)g,
                                              (const float*)w, (const float*)u, (float*)dx, (float*)dh, (float*)part,
                                              P, CI, F, s.tp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int n = F * CI + 2 * F;
  reduce_partials_kernel<<<blocks_for(n, 256), 256, 0, st>>>((const float*)part, (float*)sums, blocks, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Writes *blocks: the grid of k3_indrnn_bwd_{bf16 ? bf16 : f32} for P pixels
// and CI -> F channels on ``device`` (one wave, at most one block a tile), the
// rows of partials the caller allocates; 0 if the kernel does not take the
// widths.
extern "C" int k3_indrnn_bwd_blocks(int is_bf16, int P, int CI, int F, int device, int* blocks) {
  return (int)grid(is_bf16 != 0, P, CI, F, device, blocks);
}

// x [P, CI], h, h' (the forward's output) and g [P, F], channels last, W
// [F, CI] and u [F], all in the entry point's dtype. Writes dx [P, CI] and dh
// [P, F] (either may be null: not needed) and sums [F*CI + 2F] = (dW, db, du)
// as float32, through part [blocks][F*CI + 2F] of scratch; ``blocks`` from
// k3_indrnn_bwd_blocks; ``device`` is the index of the device that owns the
// stream.
extern "C" int k3_indrnn_bwd_f32(const void* x, const void* h, const void* hn, const void* g, const void* w,
                                 const void* u, void* dx, void* dh, void* part, void* sums, int P, int CI, int F,
                                 int blocks, int device, void* stream) {
  return launch(false, x, h, hn, g, w, u, dx, dh, part, sums, P, CI, F, blocks, device, stream);
}

extern "C" int k3_indrnn_bwd_bf16(const void* x, const void* h, const void* hn, const void* g, const void* w,
                                  const void* u, void* dx, void* dh, void* part, void* sums, int P, int CI, int F,
                                  int blocks, int device, void* stream) {
  return launch(true, x, h, hn, g, w, u, dx, dh, part, sums, P, CI, F, blocks, device, stream);
}
