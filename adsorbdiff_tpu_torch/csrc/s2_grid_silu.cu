// EquiformerV2 S^2 grid activation, fused, for Hopper (sm_90a), f32.
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
// 19, C = 64) a launch does 2 x 2 x 324 x 19 FLOP per column x 1.64 M columns
// = 40.3 GFLOP of f32 FMAs (0.60 ms at 67 TFLOP/s) and moves h in and out
// once (0.25 GB, 0.075 ms at 3.35 TB/s). So operations set the bound.
//
// The design: one thread owns two columns (c and c + 256 of the flattened
// (edge, channel) index), reads their NC coefficients straight from h's
// [M, NC, C] layout (coalesced across channels) into registers, and loops over
// the G grid points: NC FMAs per column for g, one SiLU, NC FMAs into an
// NC-register accumulator. to_eff and from_eff^T sit in shared memory (2 x G x
// NCP floats, NCP = NC rounded up to 4 and zero padded, 52 KB at NC = 19) and
// are read as float4 broadcasts, so a grid point costs 2 x NCP / 4 shared
// loads for 4 x NC FMAs. The TPU wrapper's moveaxis to [NC, M] and its
// padding to 32 rows and to the M tile were Mosaic layout rules and have no
// counterpart here. Not yet used: tensor cores (the two products are
// [G, NCP] x [NCP, cols] GEMMs, a fit for wgmma with a split-f32 product).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 2;  // columns per thread

__device__ __forceinline__ float silu(float g) { return g / (1.f + __expf(-g)); }

// NCP: coefficient rows rounded up to a multiple of 4 (the zero-padded rows
// of the shared tables make the padding FMAs add exact zeros).
template <int NCP>
__global__ void __launch_bounds__(kThreads) s2_grid_silu_kernel(
    const float* __restrict__ h, const float* __restrict__ to_eff, const float* __restrict__ from_eff,
    float* __restrict__ out, long long M, int NC, int C, int G) {
  extern __shared__ float4 smem4[];
  float* to_s = reinterpret_cast<float*>(smem4);  // [G][NCP]
  float* from_s = to_s + (size_t)G * NCP;         // [G][NCP] = from_eff^T, zero padded
  for (int i = threadIdx.x; i < G * NCP; i += kThreads) {
    const int p = i / NCP, r = i - p * NCP;
    to_s[i] = r < NC ? to_eff[(size_t)p * NC + r] : 0.f;
    from_s[i] = r < NC ? from_eff[(size_t)r * G + p] : 0.f;
  }
  __syncthreads();

  const long long ncols = M * (long long)C;
  long long col[kCols];
  bool valid[kCols];
  float x[kCols][NCP], acc[kCols][NCP];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    col[j] = (long long)blockIdx.x * (kThreads * kCols) + j * kThreads + threadIdx.x;
    valid[j] = col[j] < ncols;
    const long long m = valid[j] ? col[j] / C : 0;
    const int c = valid[j] ? (int)(col[j] - m * C) : 0;
    const float* src = h + m * (long long)NC * C + c;
#pragma unroll
    for (int r = 0; r < NCP; ++r) {
      x[j][r] = (valid[j] && r < NC) ? src[(size_t)r * C] : 0.f;
      acc[j][r] = 0.f;
    }
  }

  for (int p = 0; p < G; ++p) {
    const float4* t4 = reinterpret_cast<const float4*>(to_s + (size_t)p * NCP);
    const float4* f4 = reinterpret_cast<const float4*>(from_s + (size_t)p * NCP);
    float g[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) g[j] = 0.f;
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 t = t4[q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        g[j] = fmaf(t.x, x[j][4 * q], g[j]);
        g[j] = fmaf(t.y, x[j][4 * q + 1], g[j]);
        g[j] = fmaf(t.z, x[j][4 * q + 2], g[j]);
        g[j] = fmaf(t.w, x[j][4 * q + 3], g[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) g[j] = silu(g[j]);
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 f = f4[q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j][4 * q] = fmaf(f.x, g[j], acc[j][4 * q]);
        acc[j][4 * q + 1] = fmaf(f.y, g[j], acc[j][4 * q + 1]);
        acc[j][4 * q + 2] = fmaf(f.z, g[j], acc[j][4 * q + 2]);
        acc[j][4 * q + 3] = fmaf(f.w, g[j], acc[j][4 * q + 3]);
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
    for (int r = 0; r < NCP; ++r) {
      if (r < NC) dst[(size_t)r * C] = acc[j][r];
    }
  }
}

template <int NCP>
int launch(const float* h, const float* to_eff, const float* from_eff, float* out, long long M, int NC, int C,
           int G, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)G * NCP * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(s2_grid_silu_kernel<NCP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long ncols = M * (long long)C;
  const long long blocks = (ncols + kThreads * kCols - 1) / (kThreads * kCols);
  s2_grid_silu_kernel<NCP><<<(unsigned)blocks, kThreads, smem, stream>>>(h, to_eff, from_eff, out, M, NC, C, G);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous f32
// tensors: h [M, NC, C]; to_eff [G, NC]; from_eff [NC, G]; out [M, NC, C] is
// written. NC <= 32. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success; cudaErrorInvalidValue for NC > 32).
extern "C" int s2_grid_silu_f32(const void* h, const void* to_eff, const void* from_eff, void* out,
                                long long M, int NC, int C, int G, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const float* hp = static_cast<const float*>(h);
  const float* tp = static_cast<const float*>(to_eff);
  const float* fp = static_cast<const float*>(from_eff);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((NC + 3) / 4) {
    case 1: return launch<4>(hp, tp, fp, op, M, NC, C, G, s);
    case 2: return launch<8>(hp, tp, fp, op, M, NC, C, G, s);
    case 3: return launch<12>(hp, tp, fp, op, M, NC, C, G, s);
    case 4: return launch<16>(hp, tp, fp, op, M, NC, C, G, s);
    case 5: return launch<20>(hp, tp, fp, op, M, NC, C, G, s);
    case 6: return launch<24>(hp, tp, fp, op, M, NC, C, G, s);
    case 7: return launch<28>(hp, tp, fp, op, M, NC, C, G, s);
    case 8: return launch<32>(hp, tp, fp, op, M, NC, C, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s2_grid_silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
