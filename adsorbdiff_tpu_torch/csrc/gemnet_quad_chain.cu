// GemNet-OC quadruplet chain, fused, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _quad_chain_kernel (wrapper gemnet_quad_chain, plain math _quad_chain_ref).
// For every cell (b, n) -- the qint target atom a -- it computes
//
//   n1h = n1 / max(|n1|, 1e-9),  n2h likewise               (dihedral normals)
//   cos[u,q,k]  = clip(<n1h[u,q], n2h[q,k]>, -1, 1)
//   keep[u,q,k] = key1[u] != key2[q,k] && key1[u] >= 0       (c == d exclusion)
//   y[u,q,k,s]  = sqrt((2s+1)/4pi) P_s(cos) keep             (Legendre recurrence)
//   d2[u,q,s,e] = sum_k y[u,q,k,s] xm[q,k,e]
//   out[u,f,e]  = sum_{s,q} qp[u,s,q,f] d2[u,q,s,e]
//
// with u the main out-edge (c -> a), q the qint edge (b -> a) and k the main
// in-edge of b (d -> b).
//
// What bounds it on the H100: at the relaxation shape (B=8, N=80, U=K2=30,
// Q=8, S=7, E=F=32) a launch does ~4.3 GFLOP of f32 FMAs (0.064 ms at
// 67 TFLOP/s) and must read qp once (137.6 MB) and write out (78.6 MB):
// ~240 MB in all, 0.072 ms at 3.35 TB/s. So bytes set the bound, with the
// operations close behind; reading qp is most of it.
//
// The design, one block of 256 threads per cell:
//   * the cell's xm [Q,K2,E], the normalised n2 [Q,K2,3] and n1 [U,Q,3] and
//     both key tables are staged in shared memory once;
//   * for each u in turn: the basis y[q,k,s] is built in shared memory
//     (one thread per (q,k)), d2[q,s,e] is formed with one thread per (q,e)
//     holding up to 8 levels s in registers and summing over k, and out[f,e]
//     with one thread per (4 f, e) summing over (s,q); out is written
//     coalesced along E;
//   * qp[u] ([S,Q,F], contiguous in device memory) is copied into shared
//     memory with cp.async at the top of each u step, so the copy overlaps
//     the basis and d2 work of the same step.
// Nothing between the inputs and out goes to device memory; the TPU kernel's
// block-diagonal packing, u/k padding to 32 and level-major scratch were
// Mosaic layout workarounds and have no counterpart here. Not yet used:
// tensor cores (wgmma), TMA, and fusing the qp einsum into the kernel (which
// would remove the largest input).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSTile = 8;  // spherical levels held in registers in the d2 loop
constexpr int kFTile = 4;  // output columns f per thread in the outer loop

__host__ __device__ inline size_t smem_floats(int U, int Q, int K2, int S, int E, int F) {
  const size_t qk = (size_t)Q * K2;
  return qk * E          // xm_s
         + qk * 3        // n2h_s
         + (size_t)U * Q * 3  // n1h_s
         + qk * S        // y_s
         + (size_t)Q * S * E  // d2_s
         + (size_t)S * Q * F  // qp_s
         + qk + U;       // key2_s, key1_s (ints, same size)
}

__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float x = v[0], y = v[1], z = v[2];
  const float den = fmaxf(sqrtf(x * x + y * y + z * z), 1e-9f);
  out[0] = x / den;
  out[1] = y / den;
  out[2] = z / den;
}

__global__ void __launch_bounds__(kThreads) gemnet_quad_chain_kernel(
    const float* __restrict__ n1, const float* __restrict__ n2,
    const int32_t* __restrict__ key1, const int32_t* __restrict__ key2,
    const float* __restrict__ xm, const float* __restrict__ qp,
    float* __restrict__ out, int U, int Q, int K2, int S, int E, int F) {
  extern __shared__ float smem[];
  const int QK = Q * K2;
  float* xm_s = smem;                                   // [Q*K2][E]
  float* n2h_s = xm_s + (size_t)QK * E;                 // [Q*K2][3]
  float* n1h_s = n2h_s + (size_t)QK * 3;                // [U*Q][3]
  float* y_s = n1h_s + (size_t)U * Q * 3;               // [Q*K2][S]
  float* d2_s = y_s + (size_t)QK * S;                   // [Q][S][E]
  float* qp_s = d2_s + (size_t)Q * S * E;               // [S][Q][F]
  int* key2_s = reinterpret_cast<int*>(qp_s + (size_t)S * Q * F);  // [Q*K2]
  int* key1_s = key2_s + QK;                            // [U]

  const size_t cell = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xm_c = xm + cell * QK * E;
  const float* n1_c = n1 + cell * U * Q * 3;
  const float* n2_c = n2 + cell * QK * 3;
  const size_t sqf = (size_t)S * Q * F;
  const float* qp_c = qp + cell * U * sqf;
  float* out_c = out + cell * U * F * E;

  for (int i = tid; i < QK * E; i += kThreads) xm_s[i] = xm_c[i];
  for (int i = tid; i < QK; i += kThreads) {
    normalize3(n2_c + 3 * i, n2h_s + 3 * i);
    key2_s[i] = key2[cell * QK + i];
  }
  for (int i = tid; i < U * Q; i += kThreads) normalize3(n1_c + 3 * i, n1h_s + 3 * i);
  for (int i = tid; i < U; i += kThreads) key1_s[i] = key1[cell * U + i];
  __syncthreads();

  const float kPi = 3.14159265358979323846f;
  for (int u = 0; u < U; ++u) {
    // qp[u] -> shared memory, asynchronously; qp_s is free (barrier below)
    const float* qp_u = qp_c + u * sqf;
    for (size_t i = tid; i < sqf; i += kThreads) __pipeline_memcpy_async(qp_s + i, qp_u + i, sizeof(float));
    __pipeline_commit();

    // 1. basis y[q,k,s] for this u
    const int k1 = key1_s[u];
    for (int i = tid; i < QK; i += kThreads) {
      const int q = i / K2;
      const float* a = n1h_s + 3 * (u * Q + q);
      const float* b = n2h_s + 3 * i;
      float c = a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
      c = fminf(fmaxf(c, -1.f), 1.f);
      const bool keep = (k1 != key2_s[i]) && (k1 >= 0);
      float* yrow = y_s + (size_t)i * S;
      float pm1 = 1.f, p = c;
      for (int l = 0; l < S; ++l) {
        float pl;
        if (l == 0) {
          pl = 1.f;
        } else if (l == 1) {
          pl = c;
        } else {
          pl = ((2 * l - 1) * c * p - (l - 1) * pm1) / (float)l;
          pm1 = p;
          p = pl;
        }
        yrow[l] = keep ? sqrtf((2 * l + 1) / (4.f * kPi)) * pl : 0.f;
      }
    }
    __syncthreads();

    // 2. d2[q,s,e] = sum_k y[q,k,s] xm[q,k,e]
    for (int item = tid; item < Q * E; item += kThreads) {
      const int q = item / E;
      const int e = item - q * E;
      for (int s0 = 0; s0 < S; s0 += kSTile) {
        float acc[kSTile];
#pragma unroll
        for (int j = 0; j < kSTile; ++j) acc[j] = 0.f;
        for (int k = 0; k < K2; ++k) {
          const int qk = q * K2 + k;
          const float x = xm_s[(size_t)qk * E + e];
          const float* yrow = y_s + (size_t)qk * S + s0;
#pragma unroll
          for (int j = 0; j < kSTile; ++j) {
            if (s0 + j < S) acc[j] = fmaf(yrow[j], x, acc[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kSTile; ++j) {
          if (s0 + j < S) d2_s[((size_t)q * S + s0 + j) * E + e] = acc[j];
        }
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // 3. out[f,e] = sum_{s,q} qp[s,q,f] d2[q,s,e]
    const int f_tiles = (F + kFTile - 1) / kFTile;
    for (int item = tid; item < f_tiles * E; item += kThreads) {
      const int fb = item / E;
      const int e = item - fb * E;
      const int f0 = fb * kFTile;
      float acc[kFTile];
#pragma unroll
      for (int j = 0; j < kFTile; ++j) acc[j] = 0.f;
      for (int s = 0; s < S; ++s) {
        for (int q = 0; q < Q; ++q) {
          const float d = d2_s[((size_t)q * S + s) * E + e];
          const float* qrow = qp_s + ((size_t)s * Q + q) * F + f0;
#pragma unroll
          for (int j = 0; j < kFTile; ++j) {
            if (f0 + j < F) acc[j] = fmaf(qrow[j], d, acc[j]);
          }
        }
      }
      float* orow = out_c + (size_t)u * F * E;
#pragma unroll
      for (int j = 0; j < kFTile; ++j) {
        if (f0 + j < F) orow[(size_t)(f0 + j) * E + e] = acc[j];
      }
    }
    __syncthreads();  // y_s, d2_s and qp_s are rewritten by the next u
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: n1 [cells,U,Q,3] f32; n2 [cells,Q,K2,3] f32; key1
// [cells,U] i32; key2 [cells,Q,K2] i32; xm [cells,Q,K2,E] f32; qp
// [cells,U,S,Q,F] f32; out [cells,U,F,E] f32 is written. Launches on `stream`
// and returns cudaGetLastError() after the launch (0 = success).
extern "C" int gemnet_quad_chain_f32(
    const void* n1, const void* n2, const void* key1, const void* key2,
    const void* xm, const void* qp, void* out,
    int cells, int U, int Q, int K2, int S, int E, int F, void* stream) {
  if (cells <= 0 || U <= 0 || F <= 0 || E <= 0) return 0;
  const size_t smem = smem_floats(U, Q, K2, S, E, F) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gemnet_quad_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gemnet_quad_chain_kernel<<<(unsigned)cells, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(n1), static_cast<const float*>(n2),
      static_cast<const int32_t*>(key1), static_cast<const int32_t*>(key2),
      static_cast<const float*>(xm), static_cast<const float*>(qp),
      static_cast<float*>(out), U, Q, K2, S, E, F);
  return (int)cudaGetLastError();
}

extern "C" const char* gemnet_quad_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
