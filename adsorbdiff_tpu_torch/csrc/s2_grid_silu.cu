// EquiformerV2 S^2 grid activation, fused, for Hopper (sm_90a), f32 (bf16 h
// takes s2_grid_silu_bf16.cu, on the tensor cores).
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _s2_act_fwd_kernel (called from _s2_act_call; public s2_grid_silu). For
// every (edge, channel) column x of h [M, NC, C] (NC truncated m-primary
// coefficients) it computes
//
//   out[:, c] = from_eff @ silu(to_eff @ x)        to_eff [G, NC], from_eff [NC, G]
//
// with G = 18 x 18 = 324 grid points; the m-truncation rescale is folded into
// both matrices by the caller. The [M, G, C] grid tensor never exists.
//
// What bounds it on the H100: at the sampling shape (M = 25,600 edges, NC =
// 19, C = 64) a launch does (4 NC + ~6) FLOP per grid point per column x 324
// points x 1.64 M columns = 43.5 GFLOP of f32 (0.65 ms at 67 TFLOP/s) and
// moves h in and out once (0.25 GB, 0.074 ms at 3.35 TB/s). So operations set
// the bound: the kernel is as fast as its FP32 pipe is kept busy.
//
// The design: one thread owns four columns (c, c + 128, c + 256, c + 384 of
// the flattened (edge, channel) index, so every load and store is coalesced
// across a warp's channels), holds their NC coefficients and NC accumulators
// in registers, and loops over the G grid points: per point the to-row and
// the from-row of the tables come from shared memory as float4 broadcasts
// (each feeds 16 FMAs, 4 rows x 4 columns), the dot to_eff[p] . x runs as two
// independent chains per column, and the FMA loops cover exactly NC rows (NC
// is a template parameter; only the tables' rows are padded to a multiple of
// 4, and the padding is never read into an FMA). The SiLU is g * (1 / (1 +
// e^-g)) with the fast exponential and reciprocal (__expf, __fdividef: a few
// ulp, relative error below 1e-6 for the values a layer gives, far inside the
// 1e-4 gate; an IEEE division there took a multi-instruction sequence with a
// slow-path check per point and column). 128 threads a block; the wrapper's
// plan (ops/kernels.py::s2_grid_silu_plan) sets the grid to one column group
// per thread. The launch bound asks for 3 blocks (12 warps) per SM up to NC =
// 19: ptxas then keeps the 8 NC + ~20 live values in at most 170 registers
// without spilling (its counts are printed by chip_smoke.py), and the extra
// warps hide the shared-memory and SiLU latencies better than 2 blocks did.
// Wider NC spills at 3 blocks and takes 2.
//
// Measured (chip_smoke.py phase 10, NVIDIA H100 80GB HBM3, 700 W): see
// PERF.md section 6, row 6, for this design's time and share of the bound
// beside the two-column design it replaced (1.693 ms, 38%). What is left:
// tensor cores (the two products are [G, NC] x [NC, cols] GEMMs, a fit for
// wgmma with a split-f32 product, once the bound is restated at that rate).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;  // columns per thread

__device__ __forceinline__ float silu_fast(float g) { return __fdividef(g, 1.f + __expf(-g)); }

// Blocks per SM from ptxas's register counts at 128 threads: 3 (at most 170
// registers a thread) hold the 8 NC + ~20 live values without spilling up to
// NC = 19; wider NC takes 2.
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 19 ? 3 : 2) s2_grid_silu_kernel(
    const float* __restrict__ h, const float* __restrict__ to_eff, const float* __restrict__ from_eff,
    float* __restrict__ out, long long M, int C, int G) {
  constexpr int NCP = (NC + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* to_s = reinterpret_cast<float*>(smem4);  // [G][NCP]
  float* from_s = to_s + (size_t)G * NCP;         // [G][NCP] = from_eff^T
  for (int i = threadIdx.x; i < G * NCP; i += kThreads) {
    const int p = i / NCP, r = i - p * NCP;
    to_s[i] = r < NC ? to_eff[(size_t)p * NC + r] : 0.f;
    from_s[i] = r < NC ? from_eff[(size_t)r * G + p] : 0.f;
  }

  const long long ncols = M * (long long)C;
  long long col[kCols];
  bool valid[kCols];
  float x[kCols][NC], acc[kCols][NC];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    col[j] = (long long)blockIdx.x * (kThreads * kCols) + j * kThreads + threadIdx.x;
    valid[j] = col[j] < ncols;
    const long long m = valid[j] ? col[j] / C : 0;
    const int c = valid[j] ? (int)(col[j] - m * C) : 0;
    const float* src = h + m * (long long)NC * C + c;
#pragma unroll
    for (int r = 0; r < NC; ++r) {
      x[j][r] = valid[j] ? __ldg(src + (size_t)r * C) : 0.f;
      acc[j][r] = 0.f;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int p = 0; p < G; ++p) {
    const float4* t4 = reinterpret_cast<const float4*>(to_s + (size_t)p * NCP);
    const float4* f4 = reinterpret_cast<const float4*>(from_s + (size_t)p * NCP);
    float ge[kCols], go[kCols];  // two independent chains per column: even and odd rows
#pragma unroll
    for (int j = 0; j < kCols; ++j) ge[j] = go[j] = 0.f;
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 t = t4[q];
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * q + i;
        if (r < NC) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            if (r % 2 == 0) {
              ge[j] = fmaf(tv[i], x[j][r], ge[j]);
            } else {
              go[j] = fmaf(tv[i], x[j][r], go[j]);
            }
          }
        }
      }
    }
    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = silu_fast(ge[j] + go[j]);
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 f = f4[q];
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * q + i;
        if (r < NC) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j][r] = fmaf(fv[i], s[j], acc[j][r]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (!valid[j]) continue;
    const long long m = col[j] / C;
    const int c = (int)(col[j] - m * C);
    float* dst = out + m * (long long)NC * C + c;
#pragma unroll
    for (int r = 0; r < NC; ++r) dst[(size_t)r * C] = acc[j][r];
  }
}

template <int NC>
int launch(const float* h, const float* to_eff, const float* from_eff, float* out, long long M, int C, int G,
           long long blocks, int smem, cudaStream_t stream) {
  constexpr int NCP = (NC + 3) & ~3;
  const long long ncols = M * (long long)C;
  if (smem != 2 * G * NCP * (int)sizeof(float) || blocks * kThreads * kCols < ncols || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees with this kernel
  }
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(s2_grid_silu_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  s2_grid_silu_kernel<NC><<<(unsigned)blocks, kThreads, smem, stream>>>(h, to_eff, from_eff, out, M, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous f32
// tensors: h [M, NC, C]; to_eff [G, NC] and from_eff [NC, G]; out [M, NC, C]
// is written. 1 <= NC <= 32. `blocks` and `smem` come from the wrapper's plan
// (ops/kernels.py::s2_grid_silu_plan: 128 threads x 4 columns a block, both
// tables in shared memory); a plan this kernel does not match is refused
// with cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int s2_grid_silu_f32(const void* h, const void* to_eff, const void* from_eff, void* out,
                                long long M, int NC, int C, int G, long long blocks, int smem, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const float* hp = static_cast<const float*>(h);
  const float* tp = static_cast<const float*>(to_eff);
  const float* fp = static_cast<const float*>(from_eff);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (NC) {
#define S2_CASE(n) \
  case n:          \
    return launch<n>(hp, tp, fp, op, M, C, G, blocks, smem, s);
    S2_CASE(1) S2_CASE(2) S2_CASE(3) S2_CASE(4) S2_CASE(5) S2_CASE(6) S2_CASE(7) S2_CASE(8)
    S2_CASE(9) S2_CASE(10) S2_CASE(11) S2_CASE(12) S2_CASE(13) S2_CASE(14) S2_CASE(15) S2_CASE(16)
    S2_CASE(17) S2_CASE(18) S2_CASE(19) S2_CASE(20) S2_CASE(21) S2_CASE(22) S2_CASE(23) S2_CASE(24)
    S2_CASE(25) S2_CASE(26) S2_CASE(27) S2_CASE(28) S2_CASE(29) S2_CASE(30) S2_CASE(31) S2_CASE(32)
#undef S2_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s2_grid_silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
