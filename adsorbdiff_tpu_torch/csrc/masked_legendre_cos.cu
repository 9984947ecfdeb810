// GemNet-OC masked Legendre bases over pairwise cosines, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _legendre_cos_kernel (wrapper masked_legendre_cos, used through
// gemnet_cbf_basis and gemnet_quad_basis). For every cell and every (m, k)
// pair of it, it computes
//
//   c          = clip(<a[m], b[k]>, -1, 1)           (3-vectors; for the dihedral
//                                                    basis each normalised first,
//                                                    v / max(|v|, 1e-9))
//   y[l, m, k] = coef[l] * P_l(c) * keep[m, k],  l = 0..S-1
//
// with P_l from the Legendre recurrence and coef[l] = sqrt((2l+1)/4pi),
// computed in double on the host and passed in as f32.
//
// What bounds it on the H100: bytes. At the relaxation shape (B=8, N=80,
// K1=30, S=7) the e2e triplet basis writes 640 x 7 x 30 x 30 x 4 B = 16.1 MB
// and reads 0.6 MB of vectors and masks: ~5 us at 3.35 TB/s, against ~45
// FLOP per (m, k) column (a few us at the f32 peak would need 1e11 columns).
//
// The design: one block per cell -- a (b, n) target row for the triplet
// bases, a (b, n, q) row for the dihedral basis, the quad's q axis being part
// of the cell index. The cell's a and b rows are staged in shared memory
// (normalised there when asked); each thread takes (m, k) columns with k
// fastest, keeps the dot, the clip and the recurrence in registers and writes
// its S values, so every store of a warp covers consecutive floats along k and
// every keep read consecutive bytes (keep is read as bool). Every operand is
// addressed through strides from the wrapper, so the dihedral basis writes its
// [B, N, S, Kq, K1, K2] layout directly and no transposed copy of any operand
// exists. The TPU kernel's block-diagonal packing over C = 3 Kq (one MXU dot
// per cell) and its multi-cell batching were Mosaic workarounds and have no
// counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 16;
constexpr int kMaxThreads = 256;

struct Coef {
  float c[kMaxS];
};

// element offsets: a (o, q, m, c) = o*a_so + q*a_sq + m*a_sm + c;
// b (o, q, k, c) = o*b_so + q*b_sq + k*b_sk + c*b_sc;
// keep (o, q, m, k) = o*kp_so + q*kp_sq + m*kp_sm + k;
// y (o, q, l, m, k) = o*y_so + q*y_sq + l*y_sl + m*y_sm + k
struct Layout {
  long long a_so, a_sq, a_sm;
  long long b_so, b_sq, b_sk, b_sc;
  long long kp_so, kp_sq, kp_sm;
  long long y_so, y_sq, y_sl, y_sm;
};

__device__ __forceinline__ void load3(const float* src, long long stride, bool normalize, float* dst) {
  float x = src[0], y = src[stride], z = src[2 * stride];
  if (normalize) {
    const float den = fmaxf(sqrtf(x * x + y * y + z * z), 1e-9f);
    x = x / den;
    y = y / den;
    z = z / den;
  }
  dst[0] = x;
  dst[1] = y;
  dst[2] = z;
}

__global__ void __launch_bounds__(kMaxThreads) masked_legendre_cos_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const bool* __restrict__ keep,
    float* __restrict__ y, int Q, int M, int K, int S, int normalize, Layout L, Coef coef) {
  extern __shared__ float smem[];
  float* a_s = smem;          // [M][3]
  float* b_s = smem + 3 * M;  // [K][3]
  const long long cell = blockIdx.x;
  const long long o = cell / Q;
  const long long q = cell - o * Q;
  const int tid = threadIdx.x;

  const float* a_c = a + o * L.a_so + q * L.a_sq;
  const float* b_c = b + o * L.b_so + q * L.b_sq;
  for (int i = tid; i < M; i += blockDim.x) load3(a_c + i * L.a_sm, 1, normalize, a_s + 3 * i);
  for (int i = tid; i < K; i += blockDim.x) load3(b_c + i * L.b_sk, L.b_sc, normalize, b_s + 3 * i);
  __syncthreads();

  const bool* keep_c = keep + o * L.kp_so + q * L.kp_sq;
  float* y_c = y + o * L.y_so + q * L.y_sq;
  for (int i = tid; i < M * K; i += blockDim.x) {
    const int m = i / K;
    const int k = i - m * K;
    const float* av = a_s + 3 * m;
    const float* bv = b_s + 3 * k;
    float c = av[0] * bv[0] + av[1] * bv[1] + av[2] * bv[2];
    c = fminf(fmaxf(c, -1.f), 1.f);
    const bool kp = keep_c[m * L.kp_sm + k];
    float* out = y_c + m * L.y_sm + k;
    float p_prev = 1.f, p = c;  // P_{l-2}, P_{l-1} once l >= 2
    for (int l = 0; l < S; ++l) {
      float pl;
      if (l == 0) {
        pl = 1.f;
      } else if (l == 1) {
        pl = c;
      } else {
        pl = ((float)(2 * l - 1) * c * p - (float)(l - 1) * p_prev) / (float)l;
        p_prev = p;
        p = pl;
      }
      out[l * L.y_sl] = kp ? coef.c[l] * pl : 0.f;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). a, b, keep and y are device
// pointers (f32, f32, bool, f32) addressed through `strides`, a host array of
// 14 element strides in Layout's order; coef is a host array of S floats.
// The grid has cells_outer x Q blocks, a cell holding M x K columns. Launches
// on `stream` and returns cudaGetLastError() after the launch (0 = success).
extern "C" int masked_legendre_cos_f32(
    const void* a, const void* b, const void* keep, void* y, long long cells_outer, int Q, int M, int K,
    int S, int normalize, const long long* strides, const float* coef, void* stream) {
  if (S < 1 || S > kMaxS || Q < 1) return (int)cudaErrorInvalidValue;
  if (cells_outer <= 0 || M <= 0 || K <= 0) return 0;
  Layout L;
  L.a_so = strides[0];  L.a_sq = strides[1];  L.a_sm = strides[2];
  L.b_so = strides[3];  L.b_sq = strides[4];  L.b_sk = strides[5];  L.b_sc = strides[6];
  L.kp_so = strides[7]; L.kp_sq = strides[8]; L.kp_sm = strides[9];
  L.y_so = strides[10]; L.y_sq = strides[11]; L.y_sl = strides[12]; L.y_sm = strides[13];
  Coef cf;
  for (int l = 0; l < kMaxS; ++l) cf.c[l] = l < S ? coef[l] : 0.f;
  const size_t smem = (size_t)3 * (M + K) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        masked_legendre_cos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long columns = (long long)M * K;
  const int threads = columns >= kMaxThreads ? kMaxThreads : (int)((columns + 31) / 32 * 32);
  masked_legendre_cos_kernel<<<(unsigned)(cells_outer * Q), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const bool*>(keep),
      static_cast<float*>(y), Q, M, K, S, normalize, L, cf);
  return (int)cudaGetLastError();
}

extern "C" const char* masked_legendre_cos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
