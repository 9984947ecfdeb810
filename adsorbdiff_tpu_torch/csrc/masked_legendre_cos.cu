// GemNet-OC masked Legendre bases over pairwise cosines, for Hopper (sm_90a), f32 and bf16 outputs.
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
// with P_l from the Legendre recurrence P_l = ((2l-1) c P_{l-1} - (l-1)
// P_{l-2}) / l (the division taken as a product with 1/l, rounded to f32 on
// the host) and coef[l] = sqrt((2l+1)/4pi), computed in double on the host
// and passed in as f32.
//
// What bounds it on the H100: bytes, and before them the host. At the
// relaxation shape (B=8, N=80, K1=30, Kae=20, S=7) one GemNet-OC forward's
// three triplet bases (e2e, a2e, e2a) write 37.6 MB and read 1.3 MB of masks
// and vectors: ~12 us at 3.35 TB/s, against ~50 FLOP per (m, k) column. Three
// launches from Python cost more host time than that, so one launch takes a
// group of up to three problems.
//
// The design: one grid over all problems of the group. The problem table
// (pointers, strides, sizes, each problem's first block and cells a block)
// and the coefficients are passed by value as a __grid_constant__ parameter.
// A block finds its problem from its index and takes `cpb` consecutive cells
// of it (a cell is a (b, n) target row of a triplet basis, a (b, n, q) row of
// the dihedral basis): as many whole cells as hold at most 1024 columns, one
// where a cell has more (one at the relaxation shape: 2048 columns a block ran
// slower). It stages its cells' a and b rows in shared
// memory (normalised there when asked) behind its only barrier. Where M x K %
// 4 == 0 and y's (m, k) plane is contiguous and 16-byte aligned (the plan
// asks, and this file checks), a thread takes four consecutive (m, k) columns
// of a plane: one division for the unit's cell and row, then increments; the
// dots, clips and recurrences stay in registers, and each level is one float4
// store (keep read as one 32-bit word where its plane is contiguous too).
// Elsewhere a thread takes single columns. Every operand is addressed
// through strides, so the dihedral basis writes its [B, N, S, Kq, K1, K2]
// layout directly. The TPU kernel's block-diagonal packing over C = 3 Kq (one
// MXU dot per cell) was a Mosaic workaround and has no counterpart here.
//
// The bf16 variant (GemNet-OC with compute_dtype: bfloat16, the TPU kernel's
// out_dtype): inputs and arithmetic as above in f32, each output rounded once
// to bf16; a four-column unit is one 8-byte store. It writes half the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxS = 16;
constexpr int kMaxProblems = 3;
constexpr int kThreads = 256;
constexpr int kTableWidth = 22;  // long longs a problem in the host table

// element offsets: a (o, q, m, c) = o*a_so + q*a_sq + m*a_sm + c;
// b (o, q, k, c) = o*b_so + q*b_sq + k*b_sk + c*b_sc;
// keep (o, q, m, k) = o*kp_so + q*kp_sq + m*kp_sm + k;
// y (o, q, l, m, k) = o*y_so + q*y_sq + l*y_sl + m*y_sm + k; cell = o*Q + q
struct Problem {
  const float* a;
  const float* b;
  const uint8_t* keep;
  void* y;  // float, or __nv_bfloat16 in the bf16 variant
  long long a_so, a_sq, a_sm;
  long long b_so, b_sq, b_sk, b_sc;
  long long kp_so, kp_sq, kp_sm;
  long long y_so, y_sq, y_sl, y_sm;
  long long cells;
  int Q, M, K, normalize, first_block, cpb, vec4, keep4;
};

struct Group {
  Problem p[kMaxProblems];
  float coef[kMaxS];
  float inv_l[kMaxS];  // 1/l, l >= 2
  int n, S;
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

__device__ __forceinline__ float clipped_dot(const float* av, const float* bv) {
  const float c = fmaf(av[2], bv[2], fmaf(av[1], bv[1], av[0] * bv[0]));
  return fminf(fmaxf(c, -1.f), 1.f);
}

// P_l from P_{l-1} = p and P_{l-2} = p_prev, l >= 2
__device__ __forceinline__ float legendre_next(float c, float p, float p_prev, int l, float inv_l) {
  return ((float)(2 * l - 1) * c * p - (float)(l - 1) * p_prev) * inv_l;
}

// Four outputs at out (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ void store4(float* out, const float (&v)[4]) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, const float (&v)[4]) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out);
  o[0] = __floats2bfloat162_rn(v[0], v[1]);
  o[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads) masked_legendre_cos_kernel(const __grid_constant__ Group G) {
  extern __shared__ float smem[];
  int pi = 0;
  while (pi + 1 < G.n && (int)blockIdx.x >= G.p[pi + 1].first_block) ++pi;
  const Problem& P = G.p[pi];
  const int M = P.M, K = P.K, Q = P.Q, MK = M * K, S = G.S;
  const long long cell0 = (long long)((int)blockIdx.x - P.first_block) * P.cpb;
  const int ncell = (int)min((long long)P.cpb, P.cells - cell0);
  const bool normalize = P.normalize != 0;
  float* a_s = smem;                    // [cpb * M][3]
  float* b_s = smem + 3 * P.cpb * M;    // [cpb * K][3]
  const int tid = threadIdx.x;

  for (int i = tid; i < ncell * M; i += blockDim.x) {
    const int c = i / M, m = i - c * M;
    const long long cell = cell0 + c, o = cell / Q, q = cell - o * Q;
    load3(P.a + o * P.a_so + q * P.a_sq + m * P.a_sm, 1, normalize, a_s + 3 * i);
  }
  for (int i = tid; i < ncell * K; i += blockDim.x) {
    const int c = i / K, k = i - c * K;
    const long long cell = cell0 + c, o = cell / Q, q = cell - o * Q;
    load3(P.b + o * P.b_so + q * P.b_sq + k * P.b_sk, P.b_sc, normalize, b_s + 3 * i);
  }
  __syncthreads();

  if (P.vec4) {
    const int units = ncell * MK / 4;
    for (int u = tid; u < units; u += blockDim.x) {
      const int col = 4 * u, c = col / MK, r = col - c * MK;
      int m = r / K, k = r - m * K;
      const long long cell = cell0 + c, o = cell / Q, q = cell - o * Q;
      const uint8_t* kp_c = P.keep + o * P.kp_so + q * P.kp_sq;
      uint32_t word = 0;
      if (P.keep4) word = *reinterpret_cast<const uint32_t*>(kp_c + r);
      float cs[4];
      bool kp[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        cs[j] = clipped_dot(a_s + 3 * (c * M + m), b_s + 3 * (c * K + k));
        kp[j] = P.keep4 ? ((word >> (8 * j)) & 0xffu) != 0 : kp_c[m * P.kp_sm + k] != 0;
        if (++k == K) {
          k = 0;
          ++m;
        }
      }
      TO* out = static_cast<TO*>(P.y) + o * P.y_so + q * P.y_sq + r;  // y_sm == K: the plane is contiguous
      float p_prev[4], p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p_prev[j] = 1.f;
        p[j] = cs[j];
      }
      for (int l = 0; l < S; ++l) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float pl;
          if (l == 0) {
            pl = 1.f;
          } else if (l == 1) {
            pl = cs[j];
          } else {
            pl = legendre_next(cs[j], p[j], p_prev[j], l, G.inv_l[l]);
            p_prev[j] = p[j];
            p[j] = pl;
          }
          v[j] = kp[j] ? G.coef[l] * pl : 0.f;
        }
        store4(out + l * P.y_sl, v);
      }
    }
  } else {
    const int columns = ncell * MK;
    for (int i = tid; i < columns; i += blockDim.x) {
      const int c = i / MK, r = i - c * MK, m = r / K, k = r - m * K;
      const long long cell = cell0 + c, o = cell / Q, q = cell - o * Q;
      const float cs = clipped_dot(a_s + 3 * (c * M + m), b_s + 3 * (c * K + k));
      const bool kp = P.keep[o * P.kp_so + q * P.kp_sq + m * P.kp_sm + k] != 0;
      TO* out = static_cast<TO*>(P.y) + o * P.y_so + q * P.y_sq + m * P.y_sm + k;
      float p_prev = 1.f, p = cs;
      for (int l = 0; l < S; ++l) {
        float pl;
        if (l == 0) {
          pl = 1.f;
        } else if (l == 1) {
          pl = cs;
        } else {
          pl = legendre_next(cs, p, p_prev, l, G.inv_l[l]);
          p_prev = p;
          p = pl;
        }
        out[l * P.y_sl] = dtype::narrow<TO>(kp ? G.coef[l] * pl : 0.f);
      }
    }
  }
}

// Plain C interface (loaded with ctypes). One launch for a group of `n`
// problems (1..3), laid out as ops/kernels.py::legendre_group_plan gives it:
//   table: n x 22 long longs a problem: the 14 element strides in Layout's
//     order above (a: so, sq, sm; b: so, sq, sk, sc; keep: so, sq, sm; y: so,
//     sq, sl, sm), cells (= outer x Q), Q, M, K, normalize, first block,
//     cells a block, and 1 where the plan takes four columns a thread;
//   ptrs: n x 4 device pointers (a, b, keep, y: f32, f32, bool, and f32 for
//     masked_legendre_cos_f32, bf16 for masked_legendre_cos_bf16);
//   coef: S floats.
// The plan must agree with this file's layout: problem p's blocks are
// [first, first + ceil(cells / cpb)) with the first problem's first at 0,
// `blocks` their total, `threads` 256, `smem_bytes` the largest 12 cpb (M +
// K) of a problem with blocks, and a four-column problem must have M K % 4 ==
// 0 and a contiguous y plane aligned to four elements; else cudaErrorInvalidValue,
// with nothing launched. A group with no block launches nothing. Launches on
// `stream` and returns cudaGetLastError() after the launch (0 = success).
template <typename TO>
int run(int n, const long long* table, void* const* ptrs, int S, const float* coef, int blocks, int threads,
        int smem_bytes, void* stream) {
  if (n < 1 || n > kMaxProblems || S < 1 || S > kMaxS || threads != kThreads) return (int)cudaErrorInvalidValue;
  Group G;
  G.n = n;
  G.S = S;
  for (int l = 0; l < kMaxS; ++l) {
    G.coef[l] = l < S ? coef[l] : 0.f;
    G.inv_l[l] = l >= 2 ? (float)(1.0 / l) : 0.f;
  }
  long long first = 0;
  long long smem = 0;
  for (int i = 0; i < n; ++i) {
    const long long* t = table + (long long)kTableWidth * i;
    Problem& P = G.p[i];
    P.a = static_cast<const float*>(ptrs[4 * i]);
    P.b = static_cast<const float*>(ptrs[4 * i + 1]);
    P.keep = static_cast<const uint8_t*>(ptrs[4 * i + 2]);
    P.y = ptrs[4 * i + 3];
    P.a_so = t[0]; P.a_sq = t[1]; P.a_sm = t[2];
    P.b_so = t[3]; P.b_sq = t[4]; P.b_sk = t[5]; P.b_sc = t[6];
    P.kp_so = t[7]; P.kp_sq = t[8]; P.kp_sm = t[9];
    P.y_so = t[10]; P.y_sq = t[11]; P.y_sl = t[12]; P.y_sm = t[13];
    P.cells = t[14];
    P.Q = (int)t[15]; P.M = (int)t[16]; P.K = (int)t[17]; P.normalize = (int)t[18];
    P.first_block = (int)t[19]; P.cpb = (int)t[20]; P.vec4 = (int)t[21];
    if (P.Q < 1 || P.M < 0 || P.K < 0 || P.cells < 0 || P.cpb < 1 || P.first_block != first)
      return (int)cudaErrorInvalidValue;
    const long long mk = (long long)P.M * P.K;
    const long long nb = mk == 0 ? 0 : (P.cells + P.cpb - 1) / P.cpb;
    if (nb > 0) {
      if (mk * P.cpb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
      smem = smem > 12LL * P.cpb * (P.M + P.K) ? smem : 12LL * P.cpb * (P.M + P.K);
    }
    if (P.vec4) {
      const bool aligned = reinterpret_cast<uintptr_t>(P.y) % (4 * sizeof(TO)) == 0 && P.y_so % 4 == 0 &&
                           P.y_sq % 4 == 0 && P.y_sl % 4 == 0;
      if (mk % 4 != 0 || P.y_sm != P.K || !aligned) return (int)cudaErrorInvalidValue;
      P.keep4 = P.kp_sm == P.K && P.kp_so % 4 == 0 && P.kp_sq % 4 == 0 &&
                reinterpret_cast<uintptr_t>(P.keep) % 4 == 0;
    } else {
      P.keep4 = 0;
    }
    first += nb;
  }
  if (first != blocks || smem != smem_bytes || first > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(masked_legendre_cos_kernel<TO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  masked_legendre_cos_kernel<TO><<<(unsigned)blocks, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int masked_legendre_cos_f32(int n, const long long* table, void* const* ptrs, int S,
                                       const float* coef, int blocks, int threads, int smem_bytes, void* stream) {
  return run<float>(n, table, ptrs, S, coef, blocks, threads, smem_bytes, stream);
}

extern "C" int masked_legendre_cos_bf16(int n, const long long* table, void* const* ptrs, int S,
                                        const float* coef, int blocks, int threads, int smem_bytes, void* stream) {
  return run<__nv_bfloat16>(n, table, ptrs, S, coef, blocks, threads, smem_bytes, stream);
}

extern "C" const char* masked_legendre_cos_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
