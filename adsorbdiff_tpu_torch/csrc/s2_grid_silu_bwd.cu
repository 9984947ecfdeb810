// Backward of EquiformerV2's S^2 grid activation, fused, for Hopper (sm_90a),
// f32 (the bf16 form is s2_grid_silu_bf16_bwd_mma in csrc/s2_grid_silu_bf16.cu).
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _s2_act_bwd_kernel (called from _s2_act_bwd, the custom VJP of
// s2_grid_silu). For every (edge, channel) column x of h [M, NC, C] and its
// output cotangent dy, with the forward's tables to_eff [G, NC] and
// from_eff [NC, G]:
//
//   g  = to_eff @ x                         (recomputed, [G])
//   dg = from_eff^T @ dy                    ([G])
//   dx = to_eff^T @ (silu'(g) * dg)         silu'(g) = s (1 + g (1 - s)), s = sigmoid(g)
//
// The [M, G, C] grid tensors (g and dg) never exist: each grid point's g and
// dg are made in registers and consumed at once.
//
// What bounds it on the H100: at the training shape (M = 19,200 edges,
// NC = 19, C = 64) a launch does 3 x 2 x 324 x 19 FLOP per column plus the
// sigmoid and silu' (~10 per grid point) x 1.23 M columns = 49.4 GFLOP of f32
// (0.74 ms at 67 TFLOP/s) and moves h, dy and dx once (0.28 GB, 0.08 ms at
// 3.35 TB/s). So operations set the bound: the kernel is as fast as its FP32
// pipe is kept busy, and every instruction that is not an FFMA on a
// coefficient costs issue slots.
//
// The design (the forward's, csrc/s2_grid_silu.cu, with three arrays a column
// in place of two; it replaced a 256-thread kernel that looped over NC
// rounded up to 4, took an IEEE division in its sigmoid and ran at 8 warps an
// SM): one thread owns two columns (c and c + 128 of a 256-column group of
// the flattened (edge, channel) index, so every load and store is coalesced
// across a warp's channels) and holds their NC coefficients of h and of dy
// and their NC accumulators of dx in registers, 6 NC values. It loops over
// the G grid points; per point the to-row and the from-row of the tables come
// from shared memory as float4 broadcasts (each feeds 8 FMAs, 4 rows x 2
// columns), and the to-row stays in registers from the g dot to the dx
// update. The dots run as two independent chains each (even and odd rows):
// a column's g and dg are four chains of about NC / 2 FMAs. The FMA loops
// cover exactly NC rows (NC is a template parameter; only the tables' rows
// are padded to a multiple of 4 in shared memory, and the padding is never
// read into an FMA). scripts/variants_s2_grid_silu_bwd.py prints the
// grid-point loop's instructions and times each of this file's design
// choices undone (PERF.md section 6, row 7).
//
// The sigmoid is 1 / (1 + 2^(-g log2(e))) from the SFU's approximate exp2 and
// reciprocal in their flush-to-zero forms: a few ulp, far inside the 1e-4
// gate. For g < -88.7, 2^(-g log2(e)) is infinite and s = 0, so silu'(g) = 0,
// as the plain version's is to within 1e-37; for g > 87.3 it flushes to 0 and
// s = 1, silu'(g) = 1 (checked at max |g| = 100 by the card tests and
// chip_smoke.py phase 13b).
//
// Occupancy is set on purpose: 128 threads a block, and the launch bound asks
// for 3 blocks (12 warps) an SM up to NC = 19, where ptxas keeps the 6 NC
// array values, the to-row and ~20 others in 168 registers without spilling
// (its counts are printed by chip_smoke.py phase 13b; 2 blocks an SM were
// slower); wider NC takes 2 blocks. Both tables take 2 x G x NCP floats of
// shared memory (51,840 B at NC = 19), so three blocks fit an SM. The grid is
// persistent: one block per SM slot, each staging the tables once and taking
// every gridDim.x-th column group (a block per group, staging the tables each
// time, was a little slower). The launch comes from the wrapper's plan
// (ops/kernels.py::s2_grid_silu_bwd_plan); the C entry point refuses a plan
// that disagrees with this layout. Every column is written by its own
// thread: no atomics, so the result repeats bit for bit from run to run.
//
// Measured (chip_smoke.py phase 13b, NVIDIA H100 80GB HBM3, 700 W): see
// PERF.md section 6, row 7, for this design's time and share of the bound
// beside the 1.919 ms (38.4%) of the kernel it replaced. What is left:
// tensor cores (the three products are [G, NC] x [NC, cols] GEMMs, a fit for
// wgmma with a split-f32 product, once the bound is restated at that rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 2;  // columns per thread

// dg * silu'(g), with s = sigmoid(g) = 1 / (1 + 2^(-g log2(e))) from the SFU's
// approximate exp2 and reciprocal. The flush-to-zero forms are the two SFU
// instructions alone; __expf and __fdividef wrap the same two in range
// fix-ups for subnormal values (6 more instructions a grid point).
__device__ __forceinline__ float dsilu_times(float g, float dg) {
  float e, s;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(g * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(s) : "f"(1.f + e));
  return dg * s * fmaf(g, 1.f - s, 1.f);
}

// Persistent: block b stages both tables once, then takes the column groups
// b, b + gridDim.x, ...; a group is the kCols columns c = group * kThreads *
// kCols + j * kThreads + threadIdx.x of each thread. In this form ptxas keeps
// the grid-point index and the table addresses in uniform registers, so every
// LDS.128 takes one warp-wide address (LDS.128 R, [UR]); with the group's body
// moved into a device function, as in the kernel this one replaced, it
// computed them per thread (LDS.128 R, [R]) with one instruction fewer, and
// the kernel ran slower. Blocks per SM from ptxas's register counts
// at 128 threads: 3 (at most 168 registers a thread) hold the 6 NC array
// values and the to-row without spilling up to NC = 19; wider NC takes 2.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 19 ? 3 : 2) s2_grid_silu_bwd_kernel(
    const float* __restrict__ h, const float* __restrict__ dy, const float* __restrict__ to_eff,
    const float* __restrict__ from_eff, float* __restrict__ dh, long long M, int C, int G) {
  constexpr int NCP = (NC + 3) & ~3;
  constexpr int NQ = NCP / 4;
  extern __shared__ float4 smem4[];
  float* to_s = reinterpret_cast<float*>(smem4);  // [G][NCP]
  float* from_s = to_s + (size_t)G * NCP;         // [G][NCP] = from_eff^T
  for (int i = threadIdx.x; i < G * NCP; i += kThreads) {
    const int p = i / NCP, r = i - p * NCP;
    to_s[i] = r < NC ? to_eff[(size_t)p * NC + r] : 0.f;
    from_s[i] = r < NC ? from_eff[(size_t)r * G + p] : 0.f;
  }
  __syncthreads();

  const long long ncols = M * (long long)C;
  for (long long group = blockIdx.x; group * (kThreads * kCols) < ncols; group += gridDim.x) {
    long long col[kCols];
    bool valid[kCols];
    float x[kCols][NC], d[kCols][NC], acc[kCols][NC];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col[j] = group * (kThreads * kCols) + j * kThreads + threadIdx.x;
      valid[j] = col[j] < ncols;
      const long long m = valid[j] ? col[j] / C : 0;
      const int c = valid[j] ? (int)(col[j] - m * C) : 0;
      const long long base = m * (long long)NC * C + c;
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        x[j][r] = valid[j] ? __ldg(h + base + (size_t)r * C) : 0.f;
        d[j][r] = valid[j] ? __ldg(dy + base + (size_t)r * C) : 0.f;
        acc[j][r] = 0.f;
      }
    }

#pragma unroll 1
    for (int p = 0; p < G; ++p) {
      const float4* t4 = reinterpret_cast<const float4*>(to_s + (size_t)p * NCP);
      const float4* f4 = reinterpret_cast<const float4*>(from_s + (size_t)p * NCP);
      float4 t[NQ];  // to_eff row p: the g dot's, then the dx update's
      float ge[kCols], go[kCols], de[kCols], dd[kCols];  // even and odd chains of g and dg
#pragma unroll
      for (int j = 0; j < kCols; ++j) ge[j] = go[j] = de[j] = dd[j] = 0.f;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        t[q] = t4[q];
        const float4 f = f4[q];
        const float tv[4] = {t[q].x, t[q].y, t[q].z, t[q].w};
        const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * q + i;
          if (r < NC) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              if (r % 2 == 0) {
                ge[j] = fmaf(tv[i], x[j][r], ge[j]);
                de[j] = fmaf(fv[i], d[j][r], de[j]);
              } else {
                go[j] = fmaf(tv[i], x[j][r], go[j]);
                dd[j] = fmaf(fv[i], d[j][r], dd[j]);
              }
            }
          }
        }
      }
      float w[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = dsilu_times(ge[j] + go[j], de[j] + dd[j]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float tv[4] = {t[q].x, t[q].y, t[q].z, t[q].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 4 * q + i;
          if (r < NC) {
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[j][r] = fmaf(tv[i], w[j], acc[j][r]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (!valid[j]) continue;
      const long long m = col[j] / C;
      const int c = (int)(col[j] - m * C);
      float* dst = dh + m * (long long)NC * C + c;
#pragma unroll
      for (int r = 0; r < NC; ++r) dst[(size_t)r * C] = acc[j][r];
    }
  }
}

template <int NC>
int launch(const float* h, const float* dy, const float* to_eff, const float* from_eff, float* dh, long long M, int C,
           int G, long long blocks, int smem, cudaStream_t stream) {
  constexpr int NCP = (NC + 3) & ~3;
  const long long ncols = M * (long long)C;
  const long long groups = (ncols + kThreads * kCols - 1) / (kThreads * kCols);
  if (smem != 2 * G * NCP * (int)sizeof(float) || blocks < 1 || blocks > groups || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees with this kernel
  }
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(s2_grid_silu_bwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  s2_grid_silu_bwd_kernel<NC><<<(unsigned)blocks, kThreads, smem, stream>>>(h, dy, to_eff, from_eff, dh, M, C, G);
  return (int)cudaGetLastError();
}

int dispatch(const void* h, const void* dy, const void* to_eff, const void* from_eff, void* dh, long long M, int NC,
             int C, int G, long long blocks, int smem, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const float* hp = static_cast<const float*>(h);
  const float* dp = static_cast<const float*>(dy);
  const float* tp = static_cast<const float*>(to_eff);
  const float* fp = static_cast<const float*>(from_eff);
  float* op = static_cast<float*>(dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NC) {
#define S2B_CASE(n) \
  case n:           \
    return launch<n>(hp, dp, tp, fp, op, M, C, G, blocks, smem, s);
    S2B_CASE(1) S2B_CASE(2) S2B_CASE(3) S2B_CASE(4) S2B_CASE(5) S2B_CASE(6) S2B_CASE(7) S2B_CASE(8)
    S2B_CASE(9) S2B_CASE(10) S2B_CASE(11) S2B_CASE(12) S2B_CASE(13) S2B_CASE(14) S2B_CASE(15) S2B_CASE(16)
    S2B_CASE(17) S2B_CASE(18) S2B_CASE(19) S2B_CASE(20) S2B_CASE(21) S2B_CASE(22) S2B_CASE(23) S2B_CASE(24)
    S2B_CASE(25) S2B_CASE(26) S2B_CASE(27) S2B_CASE(28) S2B_CASE(29) S2B_CASE(30) S2B_CASE(31) S2B_CASE(32)
#undef S2B_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors: h and dy [M, NC, C], to_eff [G, NC] and from_eff [NC, G], f32;
// dh [M, NC, C] f32 is written.
// 1 <= NC <= 32. `blocks` and `smem` come from the wrapper's plan
// (ops/kernels.py::s2_grid_silu_bwd_plan: persistent blocks of 128 threads x
// 2 columns over the 256-column groups, both tables in shared memory as f32);
// a plan this kernel does not match (shared bytes other than its layout's,
// blocks outside 1 .. the groups) is refused with cudaErrorInvalidValue.
// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int s2_grid_silu_bwd_f32(const void* h, const void* dy, const void* to_eff, const void* from_eff,
                                    void* dh, long long M, int NC, int C, int G, long long blocks, int smem,
                                    void* stream) {
  return dispatch(h, dy, to_eff, from_eff, dh, M, NC, C, G, blocks, smem, stream);
}

extern "C" const char* s2_grid_silu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
