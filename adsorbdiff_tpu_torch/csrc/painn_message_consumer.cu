// PaiNN message on features gathered beforehand, for Hopper (sm_90a), f32.
//
// Replaces two TPU kernels of adsorbdiff_tpu/ops/pallas_kernels.py:
// _painn_message_kernel (wrapper painn_message_consumer, one target per
// program) and _painn_message_tiled_kernel (wrapper
// painn_message_consumer_tiled, TI targets per program). For every target m
// and feature column h it computes, over the K neighbour slots of m:
//
//   basis[k, r] = exp(-(R-1)^2/2 * (d_k - r/(R-1))^2) * env(d_k),  d_k = dist/cutoff
//   f[k, c]     = mask_k * (bias[c] + sum_r basis[k, r] * W[r, c])      c < 3H
//   g = xh[m, k, c] * f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] * g3 + vec[m, k, d*H + h] * g2
//
// which is csrc/painn_message_fused.cu's function with the gather done by
// the caller: slot k's features are row k of the gathered tensors. The body
// is painn_message.cuh's (the basis staged in shared
// memory on the rows each 16-edge pass can reach, a 16-edge x 3-column
// register tile of the filter, the K-reduction in registers where the TPU's
// tiled kernel multiplies by selection matrices). A block takes TI
// consecutive targets one after another, reusing its shared memory; the last
// block stops at M, so M need not be a multiple of TI.
//
// What bounds it on the H100: it must read the two gathered [M, K, 3H]
// tensors once (786 MB at M=1280, K=50, H=512: ~0.24 ms at 3.35 TB/s), above
// the ~6.3 GFLOP the filter needs on the non-zero rows (~0.09 ms).
//
// Masked slots contribute nothing; an unmasked slot beyond the cutoff
// contributes xh * bias (its basis is all zero), as in the TPU kernel.

#include "painn_message.cuh"

namespace {

using namespace painn_message;

__global__ void __launch_bounds__(kThreads) painn_message_consumer_kernel(
    const float* __restrict__ dist, const uint8_t* __restrict__ mask,
    const float* __restrict__ unit, const float* __restrict__ xh,
    const float* __restrict__ vec, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ dx_out,
    float* __restrict__ dvec_out, int M, int K, int R, int H, int ti,
    float inv_cutoff, int p) {
  extern __shared__ float smem[];
  const Tile t = carve(smem, K, R);
  const int h = blockIdx.y * kThreads + threadIdx.x;
  const size_t F = 3 * (size_t)H;
  for (int j = 0; j < ti; ++j) {
    const int m = blockIdx.x * ti + j;  // the same for every thread of the block
    if (m >= M) break;
    const size_t e0 = (size_t)m * K;
    __syncthreads();  // the previous target's reads of the tile are done
    stage_target(t, dist, unit, e0, K, R, inv_cutoff, p, [&](int k) { return mask[e0 + k] ? k : -1; });
    if (h < H) {
      message_columns(t, K, H, h, w, bias, xh + e0 * F, vec + e0 * F, dx_out + (size_t)m * H,
                      dvec_out + (size_t)m * F);
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: dist [M,K] f32; mask [M,K] bool (1 byte); unit [M,K,3]
// f32; xh, vec [M,K,3H] f32 (vec's 3H is (3, H) flattened); w [R,3H] f32;
// bias [3H] f32; dx [M,H] f32 and dvec [M,3,H] f32 are written. `ti`
// targets per block (>= 1). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int painn_message_consumer_f32(
    const void* dist, const void* mask, const void* unit, const void* xh,
    const void* vec, const void* w, const void* bias, void* dx, void* dvec,
    int M, int K, int R, int H, int ti, float inv_cutoff, int envelope_exponent,
    void* stream) {
  if (M <= 0 || H <= 0) return 0;
  if (ti < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        painn_message_consumer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((M + ti - 1) / ti), (unsigned)((H + kThreads - 1) / kThreads));
  painn_message_consumer_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dist), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(unit), static_cast<const float*>(xh),
      static_cast<const float*>(vec), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(dx),
      static_cast<float*>(dvec), M, K, R, H, ti, inv_cutoff, envelope_exponent);
  return (int)cudaGetLastError();
}

extern "C" const char* painn_message_consumer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
