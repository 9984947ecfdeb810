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
// The body is painn_message.cuh's, shared with painn_message_consumer.cu
// (the basis staged in shared memory on the rows each 16-edge pass can
// reach, a 16-edge x 3-column register tile of the filter, the K-reduction in
// registers). Here the source rows of xh/vec are read straight from device
// memory by index (coalesced across h), replacing the TPU's one-hot gather
// matmul, and the K-reduction replaces its selection-matrix matmuls.
//
// What bounds it on the H100: at the sampling shape (B=16, N=80, K=50,
// H=512, R=128; 64,000 valid edges with ~28.8 non-zero rows each) the filter
// product the data needs is 6H flops per non-zero row, ~6.3 GFLOP per launch
// with the rest (~0.094 ms at 67 TFLOP/s f32 on the CUDA cores), while the
// bytes it must move are ~28 MB (8.5 us at 3.35 TB/s). So f32 operations set
// the least time. Making each W load serve more edges (several targets per
// block, W tiles staged in shared memory) is the next step. Not yet used:
// tensor cores (wgmma) and TMA; the f32 path rules out TF32.
//
// Masked slots and sources outside [0, N) contribute nothing, which is what
// the TPU kernel's masked filter and one-hot gather give.

#include "painn_message.cuh"

namespace {

using namespace painn_message;

__global__ void __launch_bounds__(kThreads) painn_message_fused_kernel(
    const float* __restrict__ xh, const float* __restrict__ vec,
    const int32_t* __restrict__ src, const float* __restrict__ dist,
    const uint8_t* __restrict__ mask, const float* __restrict__ unit,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ dx_out, float* __restrict__ dvec_out,
    int N, int K, int R, int H, float inv_cutoff, int p) {
  extern __shared__ float smem[];
  const Tile t = carve(smem, K, R);
  const int target = blockIdx.x;  // b * N + i
  const int b = target / N;
  const size_t e0 = (size_t)target * K;
  stage_target(t, dist, unit, e0, K, R, inv_cutoff, p, [&](int k) {
    const int s = src[e0 + k];
    return mask[e0 + k] && s >= 0 && s < N ? s : -1;
  });
  const int h = blockIdx.y * kThreads + threadIdx.x;
  if (h >= H) return;  // no barrier below this point
  const size_t F = 3 * (size_t)H;
  message_columns(t, K, H, h, w, bias, xh + (size_t)b * N * F, vec + (size_t)b * N * F,
                  dx_out + (size_t)target * H, dvec_out + (size_t)target * F);
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
  const size_t smem = smem_bytes(K, R);
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
