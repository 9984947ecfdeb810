// EquiformerV2 S^2 grid activation in bf16 and its backward, fused, for
// Hopper (sm_90a), on the bf16 tensor cores.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _s2_act_fwd_kernel (called from _s2_act_call; public s2_grid_silu) for bf16
// h, with the TPU kernel's rounding: for every (edge, channel) column x of h
// [M, NC, C]
//
//   out[:, c] = bf16(from_eff @ bf16(silu(to_eff @ x)))     to_eff [G, NC], from_eff [NC, G]
//
// both tables rounded to bf16 (the TPU wrapper casts them to h's dtype), both
// products of bf16 values summed in f32 (jnp.dot with preferred_element_type
// f32, which is what mma.sync m16n8k16 bf16 with f32 accumulators computes).
// The [M, G, C] grid tensor never exists, in device memory or in shared
// memory.
//
// What bounds it on the H100: at the sampling shape (M = 25,600 edges, NC =
// 19, C = 64, G = 324) the two products are 40.3 GFLOP of bf16 values (0.041
// ms at the dense bf16 tensor rate), h in and out 0.12 GB (0.037 ms). The
// SiLU is the floor: 324 x 1.64 M sigmoids, one ex2 and one rcp each on the
// SFU (16 a clock per SM), 1.06 G operations, ~0.29 ms.
//
// The design: the flattened (edge, channel) columns are the products' M
// dimension.
// - A warp takes 32 columns (two m16 tiles) at a time. It copies their
//   X^T [cols, NC] into its own 2 KB of shared memory (64-byte rows by
//   coefficient, swizzled: mma::swz64), loads them once as A fragments with
//   ldmatrix.trans (NC zero-padded to 16 or 32, KS k-steps) and keeps them in
//   registers for the whole grid.
// - The grid runs in 16-point chunks (G padded to GP, a multiple of 16):
//   G^T[cols, 16] = X^T to^T (2 n8 tiles x KS k-steps), SiLU in f32 and
//   rounding to bf16, then out^T[cols, NC] += silu(G)^T from^T (NT n8 tiles,
//   NC padded to NT x 8). The two C fragments of a chunk, packed, are the A
//   fragment of the second product's k16 step, so the grid stays in
//   registers.
// - Both tables come from the wrapper already rounded and padded (ops/
//   kernels.py::s2_bf16_tables: to [GP][KS 16 + 8], from [NT 8][GP + 8],
//   rows of an odd number of 16-byte chunks) and are copied once a block
//   into shared memory; B fragments are ldmatrix loads of them.
// - The SiLU is g * rcp(1 + ex2(-g log2 e)) on the SFU (ex2.approx.ftz,
//   rcp.approx.ftz: the f32 kernel's __expf / __fdividef with no fix-ups);
//   f32, rounded to bf16 by cvt.rn.bf16x2.
// - Outputs go through the warp's tile (C fragments to bf16, transposed back
//   to coefficient rows) and leave as 16-byte stores along the channels when
//   C % 8 == 0 and h is 16-byte aligned, else one element at a time.
// - Persistent blocks of 8 warps, 2 an SM (ops/kernels.py::
//   s2_grid_silu_bf16_plan); warp w of block b takes tiles b 8 + w, then
//   every gridDim.x 8 further.
// Any M and C, NC <= 32: the four instances are (KS, NT) = (1, 1) for NC <=
// 8, (1, 2) to 16, (2, 3) to 24, (2, 4) to 32; columns past M C are zero
// and never stored.
//
// The backward (s2_grid_silu_bf16_bwd_mma) replaces the TPU kernel
// pallas_kernels.py::_s2_act_bwd_kernel (launched from _s2_act_bwd) for bf16
// h and dy, with its rounding: for every column, with the same bf16 tables,
//
//   g = to_eff @ x, dg = from_eff^T @ dy     (both summed in f32)
//   dx = bf16(to_eff^T @ bf16(dg * silu'(g)))   silu'(g) = s (1 + g (1 - s)), s = sigmoid(g)
//
// Its floor is the sigmoid on the SFU: one tanh.approx a grid point, ~0.095
// ms at the training shape h [12,80,20,19,64] (0.19 with the forward's ex2
// and rcp); the three products (45 GFLOP of bf16 values) take ~0.05 ms at
// the bf16 tensor rate. The design is the forward's with one more product:
// - A warp's 32 columns are loaded once as A fragments of both X^T and dY^T
//   (KS k16 steps each, two tiles of the warp's shared memory) and stay in
//   registers for the whole grid.
// - Per 16-point chunk: G^T = X^T to^T and dG^T = dY^T from (2 n8 tiles x
//   KS each), silu'(g) dg in f32 with the sigmoid from the SFU's
//   tanh.approx, rounded and packed into one A fragment, then dX^T += W^T
//   to[chunk, :] over NT n8 tiles in f32 registers.
// - One table blob serves the three products: `to` [GP][KS 16 + 8] by grid
//   point is the first product's B without .trans and the third's with it;
//   `from` [NT 8][GP + 8] by coefficient is the second's with .trans (a k16
//   step past its NT 8 rows, at NC <= 8 and 17-24, reads only its first 8
//   rows and takes zeros for the rest).
// - dX leaves through the warp's tile as the forward's output does.
// The sigmoid is s = 1/2 + tanh(g / 2) / 2 from tanh.approx.f32, one SFU
// operation where the forward's ex2 and rcp take two;
// scripts/variants_eqv2_bf16_mma.py times and checks ex2 and rcp here too.
//
// Measured (chip_smoke.py phase 25, scripts/variants_eqv2_bf16_mma.py;
// NVIDIA H100 80GB HBM3): PERF.md section 6, rows 6 bf16 and 7 bf16.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 32;  // columns a warp takes at a time: two m16 tiles

__host__ __device__ constexpr int to_stride(int ks) { return ks * 16 + 8; }  // 48 or 80 bytes a grid point
__host__ __device__ inline int from_stride(int gp) { return gp + 8; }        // gp a multiple of 16: odd chunks

__host__ __device__ inline long long table_bytes(int ks, int nt, int gp) {
  return 2LL * ((long long)gp * to_stride(ks) + (long long)nt * 8 * from_stride(gp));
}

__device__ __forceinline__ float silu(float g) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(g * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return g * r;
}

// dg silu'(g) in f32, silu'(g) = s (1 + g (1 - s)) with s = sigmoid(g) =
// 1/2 + tanh(g / 2) / 2 from the SFU (tanh.approx: |error| < 2^-11 of tanh)
__device__ __forceinline__ float dsilu_times(float g, float dg) {
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(0.5f * g));
  const float s = fmaf(0.5f, th, 0.5f);
  return dg * (s * fmaf(g, 1.f - s, 1.f));
}

// The warp's tile rows r < rows (coefficients) x 32 columns from col0 on: h
// [M, NC, C] read where r < NC and the column < ncols, else 0.
__device__ __forceinline__ void load_x(char* xs, const __nv_bfloat16* __restrict__ h, int rows, int NC, int C,
                                       long long col0, long long ncols, bool vec, int lane) {
  for (int i = lane; i < rows * 4; i += 32) {
    const int r = i / 4, c = i % 4;
    const long long col = col0 + 8 * c;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < NC && col < ncols) {
      if (vec && col + 8 <= ncols) {  // C % 8 == 0: the 8 columns lie in one edge's row
        const long long m = col / C;
        v = __ldg(reinterpret_cast<const uint4*>(h + (m * NC + r) * C + (col - m * C)));
      } else {
        uint16_t e[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          e[u] = 0;
          if (col + u < ncols) {
            const long long m = (col + u) / C;
            e[u] = __ldg(reinterpret_cast<const unsigned short*>(h + (m * NC + r) * C + (col + u - m * C)));
          }
        }
        v = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16, e[4] | (uint32_t)e[5] << 16,
                       e[6] | (uint32_t)e[7] << 16);
      }
    }
    *reinterpret_cast<uint4*>(xs + mma::swz64(r, c)) = v;
  }
}

// The warp's tile rows r < NC back to out [M, NC, C] for the columns < ncols.
__device__ __forceinline__ void store_out(const char* xs, __nv_bfloat16* __restrict__ out, int NC, int C,
                                          long long col0, long long ncols, bool vec, int lane) {
  for (int i = lane; i < NC * 4; i += 32) {
    const int r = i / 4, c = i % 4;
    const long long col = col0 + 8 * c;
    if (col >= ncols) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(xs + mma::swz64(r, c));
    if (vec && col + 8 <= ncols) {
      const long long m = col / C;
      *reinterpret_cast<uint4*>(out + (m * NC + r) * C + (col - m * C)) = v;
    } else {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (col + u < ncols) {
          const long long m = (col + u) / C;
          reinterpret_cast<unsigned short*>(out)[(m * NC + r) * C + (col + u - m * C)] =
              (unsigned short)(w[u / 2] >> (16 * (u % 2)));
        }
      }
    }
  }
}

// C fragments of the warp's 32 columns x NT n8 tiles -> bf16 into the tile as [coefficient][column]
template <int NT>
__device__ __forceinline__ void stage_out(char* xs, const float (&acc)[2][NT][4], int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 16 * mt + g + 8 * (i / 2), r = 8 * nt + 2 * t + i % 2;
        *reinterpret_cast<__nv_bfloat16*>(xs + mma::swz64(r, col / 8) + 2 * (col % 8)) =
            __float2bfloat16_rn(acc[mt][nt][i]);
      }
}

template <int KS, int NT>
__global__ void __launch_bounds__(kThreads, 2) s2_grid_silu_bf16_kernel(const __nv_bfloat16* __restrict__ h,
                                                                       const __nv_bfloat16* __restrict__ tables,
                                                                       __nv_bfloat16* __restrict__ out, long long M,
                                                                       int NC, int C, int GP, int vec) {
  constexpr int TS = to_stride(KS);
  const int FS = from_stride(GP);
  extern __shared__ uint4 smem16[];
  char* smem = reinterpret_cast<char*>(smem16);
  const int tbytes = (int)table_bytes(KS, NT, GP);
  for (int i = threadIdx.x; i < tbytes / 16; i += kThreads) {
    smem16[i] = __ldg(reinterpret_cast<const uint4*>(tables) + i);
  }
  const __nv_bfloat16* to_s = reinterpret_cast<const __nv_bfloat16*>(smem);
  const __nv_bfloat16* from_s = to_s + GP * TS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  char* xs = smem + tbytes + warp * (KS * 16 * 64);
  __syncthreads();

  // per-lane ldmatrix row offsets (bytes) within a chunk's tables: to^T rows
  // (grid points, 2 n tiles x 2 k halves per x4), from^T rows (coefficients)
  const uint32_t to_base = mma::smem_addr(to_s + (8 * (lane / 16) + lane % 8) * TS + 8 * ((lane / 8) % 2));
  const uint32_t from_base = mma::smem_addr(from_s + (8 * (lane / 16) + lane % 8) * FS + 8 * ((lane / 8) % 2));
  const uint32_t from_base2 = mma::smem_addr(from_s + (lane % 8) * FS + 8 * ((lane / 8) % 2));  // x2: one n tile

  const long long ncols = M * (long long)C;
  const long long ntiles = (ncols + kWarpCols - 1) / kWarpCols;
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < ntiles; tile += (long long)gridDim.x * kWarps) {
    const long long col0 = tile * kWarpCols;
    load_x(xs, h, KS * 16, NC, C, col0, ncols, vec != 0, lane);
    __syncwarp();
    uint32_t xa[2][KS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma::ldsm_x4_trans(xa[mt][ks], mma::smem_addr(xs + mma::swz64(16 * ks + 8 * (lane / 16) + lane % 8,
                                                                       2 * mt + (lane / 8) % 2)));
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll 1
    for (int q = 0; q < GP / 16; ++q) {
      uint32_t tb[KS][4];  // to^T: {n tile 0 k lo, n tile 0 k hi, n tile 1 k lo, n tile 1 k hi} per k step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) mma::ldsm_x4(tb[ks], to_base + 2 * (16 * q * TS + 16 * ks));
      uint32_t fb[NT][2];
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t r4[4];
        mma::ldsm_x4(r4, from_base + 2 * (8 * nt * FS + 16 * q));
        fb[nt][0] = r4[0], fb[nt][1] = r4[1], fb[nt + 1][0] = r4[2], fb[nt + 1][1] = r4[3];
      }
      if constexpr (NT % 2 == 1) mma::ldsm_x2(fb[NT - 1], from_base2 + 2 * (8 * (NT - 1) * FS + 16 * q));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma::mma_bf16(g[0], xa[mt][ks], tb[ks][0], tb[ks][1]);
          mma::mma_bf16(g[1], xa[mt][ks], tb[ks][2], tb[ks][3]);
        }
        const uint32_t a[4] = {mma::pack_bf16x2(silu(g[0][0]), silu(g[0][1])),
                               mma::pack_bf16x2(silu(g[0][2]), silu(g[0][3])),
                               mma::pack_bf16x2(silu(g[1][0]), silu(g[1][1])),
                               mma::pack_bf16x2(silu(g[1][2]), silu(g[1][3]))};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma::mma_bf16(acc[mt][nt], a, fb[nt][0], fb[nt][1]);
      }
    }

    __syncwarp();
    stage_out<NT>(xs, acc, lane);
    __syncwarp();
    store_out(xs, out, NC, C, col0, ncols, vec != 0, lane);
    __syncwarp();
  }
}

template <int KS, int NT>
__global__ void __launch_bounds__(kThreads, 2) s2_grid_silu_bf16_bwd_kernel(
    const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ dy,
    const __nv_bfloat16* __restrict__ tables, __nv_bfloat16* __restrict__ dh, long long M, int NC, int C, int GP,
    int vec) {
  constexpr int TS = to_stride(KS);
  const int FS = from_stride(GP);
  extern __shared__ uint4 smem16[];
  char* smem = reinterpret_cast<char*>(smem16);
  const int tbytes = (int)table_bytes(KS, NT, GP);
  for (int i = threadIdx.x; i < tbytes / 16; i += kThreads) {
    smem16[i] = __ldg(reinterpret_cast<const uint4*>(tables) + i);
  }
  const __nv_bfloat16* to_s = reinterpret_cast<const __nv_bfloat16*>(smem);
  const __nv_bfloat16* from_s = to_s + GP * TS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  char* xs = smem + tbytes + warp * (2 * KS * 16 * 64);  // X^T, then dX^T
  char* ds = xs + KS * 16 * 64;                          // dY^T
  __syncthreads();

  // per-lane ldmatrix row offsets within a chunk's tables: to^T as the first
  // product's B (by grid point, k = coefficient), from as the second's
  // (.trans, by coefficient; x2: its first 8 rows only), to as the third's
  // (.trans, by grid point, n = coefficient; x2: one n tile)
  const uint32_t to_base = mma::smem_addr(to_s + (8 * (lane / 16) + lane % 8) * TS + 8 * ((lane / 8) % 2));
  const uint32_t from_base = mma::smem_addr(from_s + (lane % 16) * FS + 8 * (lane / 16));
  const uint32_t from_base2 = mma::smem_addr(from_s + (lane % 8) * FS + 8 * ((lane / 8) % 2));
  const uint32_t tot_base = mma::smem_addr(to_s + (lane % 16) * TS + 8 * (lane / 16));
  const uint32_t tot_base2 = mma::smem_addr(to_s + (lane % 16) * TS);

  const long long ncols = M * (long long)C;
  const long long ntiles = (ncols + kWarpCols - 1) / kWarpCols;
  for (long long tile = (long long)blockIdx.x * kWarps + warp; tile < ntiles; tile += (long long)gridDim.x * kWarps) {
    const long long col0 = tile * kWarpCols;
    load_x(xs, h, KS * 16, NC, C, col0, ncols, vec != 0, lane);
    load_x(ds, dy, KS * 16, NC, C, col0, ncols, vec != 0, lane);
    __syncwarp();
    uint32_t xa[2][KS][4], da[2][KS][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int off = mma::swz64(16 * ks + 8 * (lane / 16) + lane % 8, 2 * mt + (lane / 8) % 2);
        mma::ldsm_x4_trans(xa[mt][ks], mma::smem_addr(xs + off));
        mma::ldsm_x4_trans(da[mt][ks], mma::smem_addr(ds + off));
      }
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll 1
    for (int q = 0; q < GP / 16; ++q) {
      uint32_t tb[KS][4], fb[KS][4];  // {n tile 0 k lo, n tile 0 k hi, n tile 1 k lo, n tile 1 k hi} per k step
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma::ldsm_x4(tb[ks], to_base + 2 * (16 * q * TS + 16 * ks));
        if (16 * (ks + 1) <= 8 * NT) {
          mma::ldsm_x4_trans(fb[ks], from_base + 2 * (16 * ks * FS + 16 * q));
        } else {  // rows past from's NT 8: zero (their dY^T columns are zero too)
          uint32_t r2[2];
          mma::ldsm_x2_trans(r2, from_base2 + 2 * (16 * ks * FS + 16 * q));
          fb[ks][0] = r2[0], fb[ks][1] = 0u, fb[ks][2] = r2[1], fb[ks][3] = 0u;
        }
      }
      uint32_t wb[NT][2];
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t r4[4];
        mma::ldsm_x4_trans(r4, tot_base + 2 * (16 * q * TS + 8 * nt));
        wb[nt][0] = r4[0], wb[nt][1] = r4[1], wb[nt + 1][0] = r4[2], wb[nt + 1][1] = r4[3];
      }
      if constexpr (NT % 2 == 1) mma::ldsm_x2_trans(wb[NT - 1], tot_base2 + 2 * (16 * q * TS + 8 * (NT - 1)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float g[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma::mma_bf16(g[0], xa[mt][ks], tb[ks][0], tb[ks][1]);
          mma::mma_bf16(g[1], xa[mt][ks], tb[ks][2], tb[ks][3]);
          mma::mma_bf16(dg[0], da[mt][ks], fb[ks][0], fb[ks][1]);
          mma::mma_bf16(dg[1], da[mt][ks], fb[ks][2], fb[ks][3]);
        }
        const uint32_t w[4] = {mma::pack_bf16x2(dsilu_times(g[0][0], dg[0][0]), dsilu_times(g[0][1], dg[0][1])),
                               mma::pack_bf16x2(dsilu_times(g[0][2], dg[0][2]), dsilu_times(g[0][3], dg[0][3])),
                               mma::pack_bf16x2(dsilu_times(g[1][0], dg[1][0]), dsilu_times(g[1][1], dg[1][1])),
                               mma::pack_bf16x2(dsilu_times(g[1][2], dg[1][2]), dsilu_times(g[1][3], dg[1][3]))};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma::mma_bf16(acc[mt][nt], w, wb[nt][0], wb[nt][1]);
      }
    }

    __syncwarp();
    stage_out<NT>(xs, acc, lane);
    __syncwarp();
    store_out(xs, dh, NC, C, col0, ncols, vec != 0, lane);
    __syncwarp();
  }
}

template <int KS, int NT>
int launch(const void* h, const void* tables, void* out, long long M, int NC, int C, int GP, long long blocks,
           int smem, cudaStream_t stream) {
  const long long need = table_bytes(KS, NT, GP) + (long long)kWarps * KS * 16 * 64;
  if (smem != need || blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(s2_grid_silu_bf16_kernel<KS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec =
      C % 8 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  s2_grid_silu_bf16_kernel<KS, NT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(tables),
      static_cast<__nv_bfloat16*>(out), M, NC, C, GP, vec);
  return (int)cudaGetLastError();
}

template <int KS, int NT>
int launch_bwd(const void* h, const void* dy, const void* tables, void* dh, long long M, int NC, int C, int GP,
               long long blocks, int smem, cudaStream_t stream) {
  const long long need = table_bytes(KS, NT, GP) + (long long)kWarps * 2 * KS * 16 * 64;
  if (smem != need || blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(s2_grid_silu_bf16_bwd_kernel<KS, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(dy) & 15) == 0 && (reinterpret_cast<uintptr_t>(dh) & 15) == 0;
  s2_grid_silu_bf16_bwd_kernel<KS, NT><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(tables), static_cast<__nv_bfloat16*>(dh), M, NC, C, GP, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors: h [M, NC, C] bf16; tables, the bf16 layout of ops/kernels.py::
// s2_bf16_tables (to_eff [G, NC] and from_eff [NC, G] rounded to bf16, G
// padded to GP, a multiple of 16); out [M, NC, C] bf16 is written. 1 <= NC
// <= 32. `blocks` and `smem` come from the wrapper's plan (ops/kernels.py::
// s2_grid_silu_bf16_plan: 256 threads a block, the tables and 2 KB a warp in
// shared memory); a plan this kernel does not match is refused with
// cudaErrorInvalidValue. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int s2_grid_silu_bf16_mma(const void* h, const void* tables, void* out, long long M, int NC, int C,
                                      int GP, long long blocks, int smem, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  if (GP <= 0 || GP % 16 != 0 || NC < 1 || NC > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NC <= 8) return launch<1, 1>(h, tables, out, M, NC, C, GP, blocks, smem, s);
  if (NC <= 16) return launch<1, 2>(h, tables, out, M, NC, C, GP, blocks, smem, s);
  if (NC <= 24) return launch<2, 3>(h, tables, out, M, NC, C, GP, blocks, smem, s);
  return launch<2, 4>(h, tables, out, M, NC, C, GP, blocks, smem, s);
}

// The backward, same layout and rules: h and dy [M, NC, C] bf16, tables as
// the forward's, dh [M, NC, C] bf16 written. `blocks` and `smem` from
// ops/kernels.py::s2_grid_silu_bf16_bwd_plan (the tables and 2 KB a k16
// step a warp: X^T and dY^T tiles); a plan this kernel does not match is
// refused with cudaErrorInvalidValue.
extern "C" int s2_grid_silu_bf16_bwd_mma(const void* h, const void* dy, const void* tables, void* dh, long long M,
                                         int NC, int C, int GP, long long blocks, int smem, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  if (GP <= 0 || GP % 16 != 0 || NC < 1 || NC > 32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NC <= 8) return launch_bwd<1, 1>(h, dy, tables, dh, M, NC, C, GP, blocks, smem, s);
  if (NC <= 16) return launch_bwd<1, 2>(h, dy, tables, dh, M, NC, C, GP, blocks, smem, s);
  if (NC <= 24) return launch_bwd<2, 3>(h, dy, tables, dh, M, NC, C, GP, blocks, smem, s);
  return launch_bwd<2, 4>(h, dy, tables, dh, M, NC, C, GP, blocks, smem, s);
}

extern "C" const char* s2_grid_silu_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
