// PaiNN message block, fused, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _painn_message_fused_kernel (wrapper painn_message_fused). For every target
// atom (b, i) and feature column h it computes, over the K neighbour slots:
//
//   basis[k, r] = exp(-(R-1)^2/2 * (d_k - r/(R-1))^2) * env(d_k),  d_k = dist/cutoff
//   f[k, c]     = mask_k * (bias[c] + sum_r basis[k, r] * W[r, c])      c < 3H
//   g = xh[b, src_k, c] * f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] * g3 + vec[b, src_k, d*H + h] * g2
//
// (before PaiNN's 1/sqrt(H) scale, which the caller applies).
//
// What bounds it on the H100: at the sampling shape (B=16, N=80, K=50,
// H=512, R=128) the filter product alone is 2*E*R*3H = 25.2 GFLOP per layer
// (E = 64,000 edge slots) in f32 on the CUDA cores (67 TFLOP/s, >= 0.38 ms),
// while the bytes it must move from device memory are ~27 MB (8 us at
// 3.35 TB/s). So the least time is set by f32 operations. The design:
//   * one block per target atom and 128 feature columns; thread h owns the
//     three filter columns h, H+h, 2H+h that its outputs need;
//   * the block stages its K edges' basis [R][K] (computed in the block, never
//     in device memory), unit vectors and sources in shared memory;
//   * a thread keeps a 16-edge x 3-column tile of the filter in registers: each
//     W element it loads feeds 16 FMAs, each basis value (a shared-memory
//     broadcast) feeds 3;
//   * the source rows of xh/vec are read straight from device memory by index
//     (coalesced across h), replacing the TPU's one-hot gather matmul, and the
//     K-reduction is a register sum, replacing its selection-matrix matmuls.
// W is not kept on chip: every block reloads its 128 x 384 slice of W
// (196 KB) for each 16-edge pass, 4 passes at K=50, so a launch at the
// sampling shape loads ~4 GB of W through L1/L2 (W itself, 0.79 MB, stays in
// L2). That traffic may limit the kernel as much as the FMAs do; which one
// does is not measured. Making each W load serve more edges (several targets
// per block, W tiles staged in shared memory) is the next step.
// Not yet used: tensor cores (wgmma) and TMA; the f32 path rules out TF32.
//
// Masked slots and sources outside [0, N) contribute nothing, which is what
// the TPU kernel's masked filter and one-hot gather give.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // feature columns per block, one per thread
constexpr int kChunk = 16;     // edges per register tile

template <int KC>
__device__ __forceinline__ void edge_chunk(
    int k0, int K, int k_pad, int R, int H, int h,
    const float* __restrict__ basis_s, const float* __restrict__ unit_s,
    const int* __restrict__ src_s, const float* __restrict__ w,
    float b0, float b1, float b2,
    const float* __restrict__ xh_sys, const float* __restrict__ vec_sys,
    float& dx, float& dv0, float& dv1, float& dv2) {
  const size_t F = 3 * (size_t)H;
  float acc[KC][3];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    acc[kk][0] = 0.f;
    acc[kk][1] = 0.f;
    acc[kk][2] = 0.f;
  }
  const float* wcol = w + h;
  for (int r = 0; r < R; ++r) {
    const float* wr = wcol + (size_t)r * F;
    const float w0 = __ldg(wr);
    const float w1 = __ldg(wr + H);
    const float w2 = __ldg(wr + 2 * H);
    const float* brow = basis_s + (size_t)r * k_pad + k0;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const float bv = brow[kk];
      acc[kk][0] = fmaf(bv, w0, acc[kk][0]);
      acc[kk][1] = fmaf(bv, w1, acc[kk][1]);
      acc[kk][2] = fmaf(bv, w2, acc[kk][2]);
    }
  }
  const float inv_sqrt3 = 0.57735026918962576f;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const int k = k0 + kk;
    if (k < K) {
      const int s = src_s[k];
      if (s >= 0) {
        const float* xr = xh_sys + (size_t)s * F;
        const float* vr = vec_sys + (size_t)s * F;
        const float g1 = __ldg(xr + h) * (acc[kk][0] + b0);
        const float g2 = __ldg(xr + H + h) * (acc[kk][1] + b1) * inv_sqrt3;
        const float g3 = __ldg(xr + 2 * H + h) * (acc[kk][2] + b2);
        dx += g1;
        dv0 += unit_s[3 * k + 0] * g3 + __ldg(vr + h) * g2;
        dv1 += unit_s[3 * k + 1] * g3 + __ldg(vr + H + h) * g2;
        dv2 += unit_s[3 * k + 2] * g3 + __ldg(vr + 2 * H + h) * g2;
      }
    }
  }
}

// Rows of the basis tile: whole 16-edge chunks, then the tail rounded up to 4.
__host__ __device__ inline int padded_edges(int K) {
  return K / kChunk * kChunk + (K % kChunk + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads) painn_message_fused_kernel(
    const float* __restrict__ xh, const float* __restrict__ vec,
    const int32_t* __restrict__ src, const float* __restrict__ dist,
    const uint8_t* __restrict__ mask, const float* __restrict__ unit,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ dx_out, float* __restrict__ dvec_out,
    int N, int K, int R, int H, float inv_cutoff, int p) {
  extern __shared__ float smem[];
  const int k_pad = padded_edges(K);
  float* basis_s = smem;                                  // [R][k_pad]
  float* unit_s = basis_s + (size_t)R * k_pad;            // [K][3]
  int* src_s = reinterpret_cast<int*>(unit_s + 3 * K);    // [K], -1 = no edge

  const int target = blockIdx.x;  // b * N + i
  const int b = target / N;
  const size_t e0 = (size_t)target * K;

  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int s = src[e0 + k];
    src_s[k] = (mask[e0 + k] && s >= 0 && s < N) ? s : -1;
    unit_s[3 * k + 0] = unit[(e0 + k) * 3 + 0];
    unit_s[3 * k + 1] = unit[(e0 + k) * 3 + 1];
    unit_s[3 * k + 2] = unit[(e0 + k) * 3 + 2];
  }
  // gaussian basis x polynomial envelope (as _painn_message_fused_kernel)
  const float pf = (float)p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  const float coeff = -0.5f * (float)((R - 1) * (R - 1));
  for (int idx = threadIdx.x; idx < R * k_pad; idx += blockDim.x) {
    const int r = idx / k_pad;
    const int k = idx - r * k_pad;
    float v = 0.f;
    if (k < K) {
      const float d = dist[e0 + k] * inv_cutoff;
      float dp = 1.f;
      for (int j = 0; j < p; ++j) dp *= d;
      float env = 1.f + ca * dp + cb * dp * d + cc * dp * d * d;
      env = d < 1.f ? env : 0.f;
      const float diff = d - (float)r / (float)(R - 1);
      v = expf(coeff * diff * diff) * env;
    }
    basis_s[idx] = v;
  }
  __syncthreads();

  const int h = blockIdx.y * kThreads + threadIdx.x;
  if (h >= H) return;  // no barrier below this point
  const size_t F = 3 * (size_t)H;
  const float* xh_sys = xh + (size_t)b * N * F;
  const float* vec_sys = vec + (size_t)b * N * F;
  const float b0 = bias[h], b1 = bias[H + h], b2 = bias[2 * H + h];
  float dx = 0.f, dv0 = 0.f, dv1 = 0.f, dv2 = 0.f;
  int k0 = 0;
  for (; k0 + kChunk <= K; k0 += kChunk) {
    edge_chunk<kChunk>(k0, K, k_pad, R, H, h, basis_s, unit_s, src_s, w, b0, b1, b2,
                       xh_sys, vec_sys, dx, dv0, dv1, dv2);
  }
  const int tail = K - k0;
  if (tail > 12) {
    edge_chunk<16>(k0, K, k_pad, R, H, h, basis_s, unit_s, src_s, w, b0, b1, b2,
                   xh_sys, vec_sys, dx, dv0, dv1, dv2);
  } else if (tail > 8) {
    edge_chunk<12>(k0, K, k_pad, R, H, h, basis_s, unit_s, src_s, w, b0, b1, b2,
                   xh_sys, vec_sys, dx, dv0, dv1, dv2);
  } else if (tail > 4) {
    edge_chunk<8>(k0, K, k_pad, R, H, h, basis_s, unit_s, src_s, w, b0, b1, b2,
                  xh_sys, vec_sys, dx, dv0, dv1, dv2);
  } else if (tail > 0) {
    edge_chunk<4>(k0, K, k_pad, R, H, h, basis_s, unit_s, src_s, w, b0, b1, b2,
                  xh_sys, vec_sys, dx, dv0, dv1, dv2);
  }
  dx_out[(size_t)target * H + h] = dx;
  float* dv = dvec_out + (size_t)target * F;
  dv[h] = dv0;
  dv[H + h] = dv1;
  dv[2 * H + h] = dv2;
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: xh, vec [B,N,3H] f32; src [B,N,K] i32; dist [B,N,K] f32;
// mask [B,N,K] bool (1 byte); unit [B,N,K,3] f32; w [R,3H] f32; bias [3H] f32;
// dx [B,N,H] f32 and dvec [B,N,3,H] f32 are written. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int painn_message_fused_f32(
    const void* xh, const void* vec, const void* src, const void* dist,
    const void* mask, const void* unit, const void* w, const void* bias,
    void* dx, void* dvec, int B, int N, int K, int R, int H,
    float inv_cutoff, int envelope_exponent, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  const int k_pad = padded_edges(K);
  const size_t smem = ((size_t)R * k_pad + 3 * (size_t)K) * sizeof(float) + (size_t)K * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        painn_message_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(B * N), (unsigned)((H + kThreads - 1) / kThreads));
  painn_message_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(vec),
      static_cast<const int32_t*>(src), static_cast<const float*>(dist),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(unit),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(dx), static_cast<float*>(dvec),
      N, K, R, H, inv_cutoff, envelope_exponent);
  return (int)cudaGetLastError();
}

extern "C" const char* painn_message_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
