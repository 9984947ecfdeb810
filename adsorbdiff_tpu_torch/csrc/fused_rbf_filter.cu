// Masked radial edge filters, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _fused_rbf_filter_kernel (wrapper fused_rbf_filter). For every edge e of
// the flattened lead dims and output column f:
//
//   basis[e, r] = exp(-(R-1)^2/2 * (d_e - r/(R-1))^2) * env(d_e),  d_e = dist/cutoff
//   out[e, f]   = mask_e * (bias[f] + sum_r basis[e, r] * W[r, f])
//
// (a masked edge is 0, bias included; an unmasked edge beyond the cutoff,
// whose basis is all zero, gives the bias).
//
// It is a GEMM [E, R] x [R, F] whose A operand is computed in the kernel from
// dist and never stored. A tiled SIMT product: a block of 256 threads owns a
// 64-edge x 128-column tile of the output; for each 32-row slice of R it
// computes the basis slice [32][64] into shared memory and stages the W slice
// [32][128] there, and each thread accumulates a 4-edge x 8-column micro-tile
// in registers. Only the slices of R that some edge of the tile reaches are
// visited (a unit-width gaussian in r underflows to exactly 0 in f32 beyond
// ~14.4 rows of d (R-1), and is 0 for d >= 1); the rows skipped are exact
// zeros of the dense sum. The epilogue adds the bias, applies the mask and
// writes the tile. No padding: edges and columns past the ends are guarded.
//
// What bounds it on the H100: it must write the [E, F] output once (393 MB
// at E=64,000, F=1536: ~0.12 ms at 3.35 TB/s), above the ~5.7 GFLOP that the
// product needs on the non-zero rows (~0.09 ms). Not yet used: tensor cores
// (the f32 path rules out TF32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileE = 64;   // edges per block
constexpr int kTileF = 128;  // output columns per block
constexpr int kSliceR = 32;  // basis rows per shared-memory slice
constexpr int kMicroE = 4;   // edges per thread
constexpr int kMicroF = 8;   // columns per thread, strided by 16
constexpr int kReach = 14;   // basis rows with |r - c| > kReach + 1 underflow to 0

__global__ void __launch_bounds__(kThreads) fused_rbf_filter_kernel(
    const float* __restrict__ dist, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, long long E, int R, int F, float inv_cutoff, int p) {
  __shared__ __align__(16) float basis_s[kSliceR][kTileE];
  __shared__ float w_s[kSliceR][kTileF];
  __shared__ float dsc_s[kTileE];
  __shared__ float env_s[kTileE];
  __shared__ int lo_s, hi_s;

  const long long e0 = (long long)blockIdx.x * kTileE;
  const int f0 = blockIdx.y * kTileF;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns f0 + tx + 16 j
  const int ty = tid / 16;  // edges e0 + 4 ty + i

  if (tid == 0) {
    lo_s = R;
    hi_s = -1;
  }
  __syncthreads();
  if (tid < kTileE) {
    const long long e = e0 + tid;
    float d = 1.f, env = 0.f;
    if (e < E) {
      d = dist[e] * inv_cutoff;
      const float pf = (float)p;
      float dp = 1.f;
      for (int j = 0; j < p; ++j) dp *= d;
      env = 1.f + (-(pf + 1.f) * (pf + 2.f) * 0.5f) * dp + pf * (pf + 2.f) * dp * d +
            (-pf * (pf + 1.f) * 0.5f) * dp * d * d;
      if (mask[e] && d < 1.f) {  // else the edge's product is 0 (masked) or its basis is
        const int bin = min((int)(d * (float)(R - 1)), R - 1);
        atomicMin(&lo_s, max(0, bin - kReach));
        atomicMax(&hi_s, min(R - 1, bin + kReach + 1));
      }
    }
    dsc_s[tid] = d;
    env_s[tid] = d < 1.f ? env : 0.f;
  }
  __syncthreads();

  float acc[kMicroE][kMicroF];
#pragma unroll
  for (int i = 0; i < kMicroE; ++i)
#pragma unroll
    for (int j = 0; j < kMicroF; ++j) acc[i][j] = 0.f;

  const int lo = lo_s, hi = hi_s;
  const float coeff = -0.5f * (float)((R - 1) * (R - 1));
  for (int r0 = lo; r0 <= hi; r0 += kSliceR) {
    for (int idx = tid; idx < kSliceR * kTileE; idx += kThreads) {
      const int rr = idx / kTileE;
      const int k = idx - rr * kTileE;
      const int r = r0 + rr;
      float v = 0.f;
      if (r <= hi) {
        const float diff = dsc_s[k] - (float)r / (float)(R - 1);
        v = expf(coeff * diff * diff) * env_s[k];
      }
      basis_s[rr][k] = v;
    }
    for (int idx = tid; idx < kSliceR * kTileF; idx += kThreads) {
      const int rr = idx / kTileF;
      const int c = idx - rr * kTileF;
      const int r = r0 + rr;
      const int col = f0 + c;
      w_s[rr][c] = (r <= hi && col < F) ? __ldg(w + (size_t)r * F + col) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kSliceR; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&basis_s[rr][kMicroE * ty]);
      float b[kMicroF];
#pragma unroll
      for (int j = 0; j < kMicroF; ++j) b[j] = w_s[rr][tx + 16 * j];
#pragma unroll
      for (int j = 0; j < kMicroF; ++j) {
        acc[0][j] = fmaf(a.x, b[j], acc[0][j]);
        acc[1][j] = fmaf(a.y, b[j], acc[1][j]);
        acc[2][j] = fmaf(a.z, b[j], acc[2][j]);
        acc[3][j] = fmaf(a.w, b[j], acc[3][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMicroE; ++i) {
    const long long e = e0 + kMicroE * ty + i;
    if (e >= E) break;
    const bool keep = mask[e] != 0;
    float* row = out + (size_t)e * F;
#pragma unroll
    for (int j = 0; j < kMicroF; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < F) row[col] = keep ? acc[i][j] + __ldg(bias + col) : 0.f;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: dist [E] f32 and mask [E] bool (1 byte), the flattened
// lead dims; w [R,F] f32; bias [F] f32; out [E,F] f32 is written. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 = success).
extern "C" int fused_rbf_filter_f32(
    const void* dist, const void* mask, const void* w, const void* bias, void* out,
    long long E, int R, int F, float inv_cutoff, int envelope_exponent, void* stream) {
  if (E <= 0 || F <= 0) return 0;
  const long long blocks = (E + kTileE - 1) / kTileE;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)((F + kTileF - 1) / kTileF));
  fused_rbf_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), E, R, F, inv_cutoff, envelope_exponent);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_rbf_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
