// Backward of EquiformerV2's S^2 grid activation, fused, for Hopper (sm_90a), f32.
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
// sigmoid and silu' (~8 per grid point) x 1.23 M columns = 48.6 GFLOP of f32
// (0.73 ms at 67 TFLOP/s) and moves h, dy and dx once (0.28 GB, 0.08 ms at
// 3.35 TB/s). So operations set the bound.
//
// The design follows csrc/s2_grid_silu.cu: one thread owns two columns (c and
// c + 256 of the flattened (edge, channel) index), reads their NC coefficients
// of h and of dy straight from the [M, NC, C] layout (coalesced across
// channels) into registers and loops over the G grid points: NC FMAs each for
// g and dg, one sigmoid, NC FMAs into the NC-register accumulator dx. to_eff
// and from_eff^T sit in shared memory (2 x G x NCP floats, NCP = NC rounded up
// to 4 and zero padded, 52 KB at NC = 19) and are read as float4 broadcasts.
// Every column is written by its own thread: no atomics, so the result
// repeats bit for bit from run to run. Not yet used: tensor cores (the three
// products are [G, NCP] x [NCP, cols] GEMMs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 2;  // columns per thread

template <int NCP>
__global__ void __launch_bounds__(kThreads) s2_grid_silu_bwd_kernel(
    const float* __restrict__ h, const float* __restrict__ dy, const float* __restrict__ to_eff,
    const float* __restrict__ from_eff, float* __restrict__ dh, long long M, int NC, int C, int G) {
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
  float x[kCols][NCP], d[kCols][NCP], acc[kCols][NCP];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    col[j] = (long long)blockIdx.x * (kThreads * kCols) + j * kThreads + threadIdx.x;
    valid[j] = col[j] < ncols;
    const long long m = valid[j] ? col[j] / C : 0;
    const int c = valid[j] ? (int)(col[j] - m * C) : 0;
    const long long base = m * (long long)NC * C + c;
#pragma unroll
    for (int r = 0; r < NCP; ++r) {
      const bool in = valid[j] && r < NC;
      x[j][r] = in ? h[base + (size_t)r * C] : 0.f;
      d[j][r] = in ? dy[base + (size_t)r * C] : 0.f;
      acc[j][r] = 0.f;
    }
  }

  for (int p = 0; p < G; ++p) {
    const float4* t4 = reinterpret_cast<const float4*>(to_s + (size_t)p * NCP);
    const float4* f4 = reinterpret_cast<const float4*>(from_s + (size_t)p * NCP);
    float g[kCols], dg[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) g[j] = dg[j] = 0.f;
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 t = t4[q];
      const float4 f = f4[q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        g[j] = fmaf(t.x, x[j][4 * q], g[j]);
        g[j] = fmaf(t.y, x[j][4 * q + 1], g[j]);
        g[j] = fmaf(t.z, x[j][4 * q + 2], g[j]);
        g[j] = fmaf(t.w, x[j][4 * q + 3], g[j]);
        dg[j] = fmaf(f.x, d[j][4 * q], dg[j]);
        dg[j] = fmaf(f.y, d[j][4 * q + 1], dg[j]);
        dg[j] = fmaf(f.z, d[j][4 * q + 2], dg[j]);
        dg[j] = fmaf(f.w, d[j][4 * q + 3], dg[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float s = 1.f / (1.f + __expf(-g[j]));
      dg[j] *= s * (1.f + g[j] * (1.f - s));
    }
#pragma unroll
    for (int q = 0; q < NCP / 4; ++q) {
      const float4 t = t4[q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[j][4 * q] = fmaf(t.x, dg[j], acc[j][4 * q]);
        acc[j][4 * q + 1] = fmaf(t.y, dg[j], acc[j][4 * q + 1]);
        acc[j][4 * q + 2] = fmaf(t.z, dg[j], acc[j][4 * q + 2]);
        acc[j][4 * q + 3] = fmaf(t.w, dg[j], acc[j][4 * q + 3]);
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
    for (int r = 0; r < NCP; ++r) {
      if (r < NC) dst[(size_t)r * C] = acc[j][r];
    }
  }
}

template <int NCP>
int launch(const float* h, const float* dy, const float* to_eff, const float* from_eff, float* dh, long long M,
           int NC, int C, int G, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)G * NCP * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(s2_grid_silu_bwd_kernel<NCP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long ncols = M * (long long)C;
  const long long blocks = (ncols + kThreads * kCols - 1) / (kThreads * kCols);
  s2_grid_silu_bwd_kernel<NCP><<<(unsigned)blocks, kThreads, smem, stream>>>(h, dy, to_eff, from_eff, dh, M, NC, C,
                                                                               G);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous f32
// tensors: h and dy [M, NC, C]; to_eff [G, NC]; from_eff [NC, G]; dh
// [M, NC, C] is written. NC <= 32. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success; cudaErrorInvalidValue for
// NC > 32).
extern "C" int s2_grid_silu_bwd_f32(const void* h, const void* dy, const void* to_eff, const void* from_eff,
                                    void* dh, long long M, int NC, int C, int G, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const float* hp = static_cast<const float*>(h);
  const float* dp = static_cast<const float*>(dy);
  const float* tp = static_cast<const float*>(to_eff);
  const float* fp = static_cast<const float*>(from_eff);
  float* op = static_cast<float*>(dh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((NC + 3) / 4) {
    case 1: return launch<4>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 2: return launch<8>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 3: return launch<12>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 4: return launch<16>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 5: return launch<20>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 6: return launch<24>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 7: return launch<28>(hp, dp, tp, fp, op, M, NC, C, G, s);
    case 8: return launch<32>(hp, dp, tp, fp, op, M, NC, C, G, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* s2_grid_silu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
