// GemNet-OC quadruplet chain, fused, for Hopper (sm_90a), f32 in, f32 or bf16 out.
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
// Q=8, S=7, E=F=32) a launch does ~4.4 GFLOP of f32 FMAs (0.066 ms at
// 67 TFLOP/s) and must read qp once (137.6 MB) and write out (78.6 MB):
// ~240 MB in all, 0.072 ms at 3.35 TB/s. So bytes set the bound, with the
// operations close behind; reading qp is most of it.
//
// The design: a block stages one cell's xm [Q*K2, E], the normalised n2 and
// n1 rows and the key2 table in shared memory, behind its only barrier. Then
// each warp owns main edges u (u = its index in the cell's warps, then every
// warps-of-the-cell-th one) and runs them with no block barrier:
//   * qp[u] ([S,Q,F], contiguous in device memory) goes into the warp's own
//     shared buffer by cp.async (16-byte copies where F % 4 == 0 and the base
//     is aligned, else 4-byte ones into rows padded to a multiple of 4); the
//     copy for the warp's next u is issued once the current one is computed.
//     Where even one warp's buffer does not fit, qp is read from device
//     memory in the product (the plan's qp_buffers = 0);
//   * for each q and each tile of 32 in-edges k, every lane builds one basis
//     row y[q,k,0:8] into the warp's [32][8] buffer (levels past S zero,
//     rows 16-byte aligned);
//   * a lane owns two columns e (e0 + 2 (lane % 16) and the next). The two
//     half-warps split the K2 product by rows k: d2[s] += y[k,s] xm[q,k,e]
//     with the row read as float4 broadcasts and xm as one 8-byte load, 8
//     FMAs a load pair; one shuffle a level sums the halves. d2 (8 levels x
//     2 columns) never leaves registers;
//   * then the halves split the 32 columns f, 16 each: acc[f][e] +=
//     qp[s,q,f] d2[s,e], 8 FMAs a float4 broadcast of qp. acc stays in
//     registers, and out[u,f,e] is written once, 8 bytes a lane (128 B a
//     half-warp and column f at E = 32);
//   * a warp whose key1[u] < 0 writes zeros (every keep is false).
// Shared-memory loads, not FMAs or bytes, limited the one-column-a-lane form
// of this kernel (0.2867 ms at the relaxation shape on an H100 against
// 0.2030 with two columns, chip_smoke.py phase 3); the two-column blocking
// halves the loads an FMA.
// The widths every GemNet-OC config of the repo runs (S = 7, E = 32, the 32
// columns f all below F, qp staged) take a pass with no guard in its
// unrolled loops. Every other shape takes one generic pass: levels in passes
// of 8 (later passes add into out), columns e and f in passes of 32 (d2 made
// again for each), with runtime guards and qp read by scalar loads from the
// buffer or from device memory. The launch (warps a block, blocks a cell,
// qp buffering, copy width) comes from the plain-Python plan
// adsorbdiff_tpu_torch/ops/kernels.py::quad_chain_plan; the C entry refuses
// a plan whose shared-memory size disagrees with its own layout. Nothing
// between the inputs and out goes to device memory. Not yet used: tensor
// cores (wgmma), TMA, and fusing the qp einsum into the kernel (which would
// remove the largest input).
//
// The bf16 variant (the TPU kernel's out_dtype): out is bf16, rounded once
// from the f32 sums. GemNet-OC with compute_dtype: bfloat16 passes f32 xm and
// qp, as the JAX model does (its f32 scale factors widen xm), so the inputs,
// the plan and the layout are the f32 ones. A bf16 out takes one pass of
// levels (S <= 8): a later pass would add to a rounded partial sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxWarps = 16;
constexpr int kLevels = 8;                    // levels s a pass holds in registers (d2)
constexpr int kCols = 32;                     // columns e (two a lane) and f (16 a lane) a pass
constexpr int kTileK = 32;                    // in-edges k a basis tile (one a lane)
constexpr int kYFloats = kTileK * kLevels;    // a warp's basis buffer
constexpr int kPathLevels = 7;                // num_spherical of every GemNet-OC config (the guard-free pass)

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Floats of a block's dynamic shared memory: per warp the basis buffer and
// `bufs` (0 or 1) qp[u] buffer (rows padded to a multiple of 4), then the
// cell's xm, n2h, n1h and key2 (int) tables.
__host__ __device__ inline size_t smem_floats(int warps, int bufs, int U, int Q, int K2, int S, int E, int F) {
  const size_t qk = (size_t)Q * K2;
  const size_t sqf = (size_t)S * Q * round4(F);
  return (size_t)warps * (kYFloats + bufs * sqf) + qk * E + qk * 3 + (size_t)U * Q * 3 + qk;
}

// TO: out (float or bf16)
template <typename TO>
struct ChainArgs {
  const float* n1;
  const float* n2;
  const int32_t* key1;
  const int32_t* key2;
  const float* xm;
  const float* qp;
  TO* out;
  int U, Q, K2, S, E, F;
  int warps, parts, bufs, copy16, xm16;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// qp[u] ([S*Q rows][F], n = S*Q*F floats) into a buffer of rows padded to fp.
__device__ __forceinline__ void copy_qp(float* dst, const float* src, int n, int F, int fp, bool copy16, int lane) {
  if (copy16) {  // F % 4 == 0, so fp == F and the rows are contiguous
    for (int i = 4 * lane; i < n; i += 4 * 32) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < n; i += 32) {
      const int r = i / F;
      cp_async4(dst + (size_t)r * fp + (i - r * F), src + i);
    }
  }
}

__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float x = v[0], y = v[1], z = v[2];
  const float den = fmaxf(sqrtf(x * x + y * y + z * z), 1e-9f);
  out[0] = x / den;
  out[1] = y / den;
  out[2] = z / den;
}

// y[j] = sqrt((2l+1)/4pi) P_l(c) for l = s0 + j, j < nl; 0 past nl and where
// !keep. P_{l+1} = ((2l+1) c P_l - l P_{l-1}) / (l+1). kFirst: s0 == 0, so
// every level's constants are known at compile time.
template <bool kFirst>
__device__ __forceinline__ void basis_row(float c, bool keep, int s0, int nl, float (&y)[kLevels]) {
  const float inv4pi = 0.25f / 3.14159265358979323846f;
  float pm1 = 0.f, p = 1.f;  // P_{l-1}, P_l at l = 0
  int l0 = 0;
  if (!kFirst) {
    for (; l0 < s0; ++l0) {
      const float next = ((2 * l0 + 1) * c * p - l0 * pm1) / (float)(l0 + 1);
      pm1 = p;
      p = next;
    }
  }
#pragma unroll
  for (int j = 0; j < kLevels; ++j) {
    const int l = kFirst ? j : l0 + j;
    y[j] = (keep && j < nl) ? sqrtf((2 * l + 1) * inv4pi) * p : 0.f;
    const float next = ((2 * l + 1) * c * p - l * pm1) * (1.f / (float)(l + 1));
    pm1 = p;
    p = next;
  }
}

// This lane's half of the K2 product over a basis tile of nk rows: d2a[s]
// and d2b[s] += y[k,s] xm[q,k,e] for its columns e = ec0 and ec1 and its
// rows k = half, half + 2, ... over kNL levels (the generic pass takes all
// 8: the basis rows are zero past its level count). kE32: E == 32 and the
// two columns adjacent, one 8-byte load. xrow: xm[q,k0,:].
template <int kNL, bool kE32>
__device__ __forceinline__ void k_product(const float* y_w, const float* xrow, int E, int nk, int half, int ec0,
                                          int ec1, float (&d2a)[kLevels], float (&d2b)[kLevels]) {
  const float4* y4 = reinterpret_cast<const float4*>(y_w);
#pragma unroll 4
  for (int kk = half; kk < nk; kk += 2) {
    float x0, x1;
    if (kE32) {
      const float2 x = *reinterpret_cast<const float2*>(xrow + kk * 32 + ec0);
      x0 = x.x;
      x1 = x.y;
    } else {
      x0 = xrow[kk * E + ec0];
      x1 = xrow[kk * E + ec1];
    }
    float y[kLevels];
    const float4 ya = y4[2 * kk], yb = y4[2 * kk + 1];
    y[0] = ya.x, y[1] = ya.y, y[2] = ya.z, y[3] = ya.w;
    y[4] = yb.x, y[5] = yb.y, y[6] = yb.z, y[7] = yb.w;
#pragma unroll
    for (int j = 0; j < kNL; ++j) {
      d2a[j] = fmaf(y[j], x0, d2a[j]);
      d2b[j] = fmaf(y[j], x1, d2b[j]);
    }
  }
}

// acca[f] and accb[f] += qp[s,q,f] d2[s] for this lane's 16 columns f and
// two columns e; qrow: qp[u,s0,q,f], rows of level_stride floats apart.
// kFast: kPathLevels levels and all 16 columns below F, qp read as float4
// broadcasts from the warp's buffer; else nl levels and the fleft columns
// below F, read one float at a time from the buffer or device memory.
template <bool kFast>
__device__ __forceinline__ void acc_update(const float* qrow, size_t level_stride, int nl, int fleft,
                                           const float (&d2a)[kLevels], const float (&d2b)[kLevels],
                                           float (&acca)[kCols / 2], float (&accb)[kCols / 2]) {
#pragma unroll
  for (int j = 0; j < (kFast ? kPathLevels : kLevels); ++j) {
    if (!kFast && j >= nl) break;
    const float* row = qrow + j * level_stride;
    if (kFast) {
#pragma unroll
      for (int c = 0; c < kCols / 8; ++c) {
        const float4 w = *reinterpret_cast<const float4*>(row + 4 * c);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acca[4 * c + t] = fmaf(wv[t], d2a[j], acca[4 * c + t]);
          accb[4 * c + t] = fmaf(wv[t], d2b[j], accb[4 * c + t]);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < kCols / 2; ++t) {
        if (t < fleft) {
          const float w = row[t];
          acca[t] = fmaf(w, d2a[j], acca[t]);
          accb[t] = fmaf(w, d2b[j], accb[t]);
        }
      }
    }
  }
}

// One pass (levels s0 .. s0 + nl - 1, columns e0 .. e0 + 31, columns f0 ..
// f0 + 31) of one main edge u: out[u,f,e] = sum_{q, s} qp[u,s,q,f] d2[u,q,s,e]
// (a later level pass adds into the warp's own rows). A lane owns columns e
// = e0 + 2 (lane % 16) and the next; the two half-warps split the K2 product
// by rows k (their partial d2 summed with one shuffle a level) and then the
// 32 columns f, 16 each: per k, 8 FMAs a lane for two broadcast loads of y and
// one 8-byte load of xm; per level, 32 FMAs for four float4 loads of qp.
// kFast: the paths' widths (s0 == 0, nl == kPathLevels, E == 32, f0 + 32 <=
// F, qpb the warp's buffer), so strides are immediates and no guard splits
// the unrolled loops.
template <bool kFast, typename TO>
__device__ __forceinline__ void chain_pass(const ChainArgs<TO>& a, int k1, const float* n1u, const float* qpb,
                                           int stride, const float* xm_s, const float* n2h_s, const int* key2_s,
                                           float* y_w, TO* out_u, int s0, int nl, int e0, int f0, int lane) {
  constexpr int kNL = kFast ? kPathLevels : kLevels;
  const int Q = a.Q, K2 = a.K2, E = kFast ? 32 : a.E, F = a.F;
  const int half = lane >> 4;
  const int e = e0 + 2 * (lane & 15);
  const bool ev0 = e < E, ev1 = e + 1 < E;
  const int ec0 = ev0 ? e : E - 1, ec1 = ev1 ? e + 1 : E - 1;
  const int fh = f0 + (kCols / 2) * half;  // this lane's first column f
  const size_t level_stride = (size_t)Q * stride;
  float acca[kCols / 2], accb[kCols / 2];
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) acca[j] = accb[j] = 0.f;
  for (int q = 0; q < Q; ++q) {
    float d2a[kLevels], d2b[kLevels];
#pragma unroll
    for (int j = 0; j < kLevels; ++j) d2a[j] = d2b[j] = 0.f;
    const float ax = n1u[3 * q], ay = n1u[3 * q + 1], az = n1u[3 * q + 2];
    for (int k0 = 0; k0 < K2; k0 += kTileK) {
      const int nk = min(kTileK, K2 - k0);
      __syncwarp();  // the last tile's readers are done with y_w
      if (lane < nk) {
        const int r = q * K2 + k0 + lane;
        const float* b = n2h_s + 3 * r;
        const float c = fminf(fmaxf(ax * b[0] + ay * b[1] + az * b[2], -1.f), 1.f);
        const bool keep = k1 != key2_s[r];
        float y[kLevels];
        if (kFast || s0 == 0) {
          basis_row<true>(c, keep, 0, kFast ? kPathLevels : nl, y);
        } else {
          basis_row<false>(c, keep, s0, nl, y);
        }
        float4* row = reinterpret_cast<float4*>(y_w + lane * kLevels);
        row[0] = make_float4(y[0], y[1], y[2], y[3]);
        row[1] = make_float4(y[4], y[5], y[6], y[7]);
      }
      __syncwarp();
      k_product<kNL, kFast>(y_w, xm_s + (size_t)(q * K2 + k0) * E, E, nk, half, ec0, ec1, d2a, d2b);
    }
#pragma unroll
    for (int j = 0; j < kNL; ++j) {  // both halves' rows k
      d2a[j] += __shfl_xor_sync(0xffffffffu, d2a[j], 16);
      d2b[j] += __shfl_xor_sync(0xffffffffu, d2b[j], 16);
    }
    acc_update<kFast>(qpb + ((size_t)s0 * Q + q) * stride + fh, level_stride, nl, F - fh, d2a, d2b, acca, accb);
  }
  TO* o = out_u + (size_t)fh * E + e;
#pragma unroll
  for (int j = 0; j < kCols / 2; ++j) {
    TO* oj = o + j * E;
    if (kFast) {  // both columns exist, the pair is aligned to two elements, and this is the only level pass
      if constexpr (dtype::kF32<TO>) {
        *reinterpret_cast<float2*>(oj) = make_float2(acca[j], accb[j]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(oj) = __floats2bfloat162_rn(acca[j], accb[j]);
      }
    } else if (fh + j < F) {  // a bf16 out has one level pass (s0 == 0)
      if (ev0) oj[0] = dtype::narrow<TO>(s0 == 0 ? acca[j] : dtype::f32(oj[0]) + acca[j]);
      if (ev1) oj[1] = dtype::narrow<TO>(s0 == 0 ? accb[j] : dtype::f32(oj[1]) + accb[j]);
    }
  }
}

// One main edge u of the cell, by one warp, in passes. qp_w: the warp's qp
// buffer (rows of fp floats; used only where a.bufs == 1, by the guard-free
// pass); qpb: qp[u] with rows of `stride` floats, that buffer or device
// memory (the generic pass).
template <typename TO>
__device__ __forceinline__ void chain_step(const ChainArgs<TO>& a, int u, int k1, const float* qp_w, int fp,
                                           const float* qpb, int stride, const float* xm_s, const float* n2h_s,
                                           const float* n1h_s, const int* key2_s, float* y_w, TO* out_u,
                                           int lane) {
  const int Q = a.Q, S = a.S, E = a.E, F = a.F;
  if (k1 < 0 || S == 0) {  // every keep is false, or no levels: the plain version's exact zeros
    for (int i = lane; i < F * E; i += 32) out_u[i] = dtype::narrow<TO>(0.f);
    return;
  }
  const float* n1u = n1h_s + (size_t)u * Q * 3;
  const bool path_widths = a.bufs == 1 && S == kPathLevels && E == kCols;
  for (int s0 = 0; s0 < S; s0 += kLevels) {
    const int nl = min(kLevels, S - s0);
    for (int e0 = 0; e0 < E; e0 += kCols) {
      for (int f0 = 0; f0 < F; f0 += kCols) {
        if (path_widths && f0 + kCols <= F) {
          chain_pass<true>(a, k1, n1u, qp_w, fp, xm_s, n2h_s, key2_s, y_w, out_u, 0, kPathLevels, 0, f0, lane);
        } else {
          chain_pass<false>(a, k1, n1u, qpb, stride, xm_s, n2h_s, key2_s, y_w, out_u, s0, nl, e0, f0, lane);
        }
      }
    }
  }
}

template <typename TO>
__global__ void __launch_bounds__(kMaxWarps * 32) gemnet_quad_chain_kernel(const ChainArgs<TO> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int U = a.U, Q = a.Q, K2 = a.K2, S = a.S, E = a.E, F = a.F;
  const int QK = Q * K2, fp = round4(F);
  const int bufs = a.bufs;
  const size_t sqf = (size_t)S * Q * fp;  // floats of a staged qp[u]
  const int sqf_g = S * Q * F;            // floats of qp[u] in device memory
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qp_w = smem + (size_t)warp * bufs * sqf;
  float* y_w = smem + (size_t)a.warps * bufs * sqf + warp * kYFloats;
  float* xm_s = smem + (size_t)a.warps * (bufs * sqf + kYFloats);
  float* n2h_s = xm_s + (size_t)QK * E;
  float* n1h_s = n2h_s + (size_t)QK * 3;
  int* key2_s = reinterpret_cast<int*>(n1h_s + (size_t)U * Q * 3);

  const size_t cell = blockIdx.x / a.parts;
  const int part = blockIdx.x - (int)cell * a.parts;
  const int G = a.parts * a.warps;  // the cell's warps
  const int g = part * a.warps + warp;
  const float* qp_c = a.qp + cell * U * (size_t)sqf_g;
  const bool copy16 = a.copy16 != 0;

  // the cell's xm, then each warp's first qp[u], asynchronously; the rest by hand
  const float* xm_c = a.xm + cell * QK * (size_t)E;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (a.xm16) {
    for (int i = 4 * tid; i < QK * E; i += 4 * nt) cp_async16(xm_s + i, xm_c + i);
  } else {
    for (int i = tid; i < QK * E; i += nt) cp_async4(xm_s + i, xm_c + i);
  }
  cp_async_commit();
  if (bufs && g < U) copy_qp(qp_w, qp_c + (size_t)g * sqf_g, sqf_g, F, fp, copy16, lane);
  cp_async_commit();
  const float* n2_c = a.n2 + cell * QK * 3;
  const float* n1_c = a.n1 + cell * U * Q * 3;
  for (int i = tid; i < QK; i += nt) {
    normalize3(n2_c + 3 * i, n2h_s + 3 * i);
    key2_s[i] = a.key2[cell * QK + i];
  }
  for (int i = tid; i < U * Q; i += nt) normalize3(n1_c + 3 * i, n1h_s + 3 * i);
  cp_async_wait<1>();  // the xm group (a warp's qp group may still be in flight)
  __syncthreads();     // the block's only barrier
  if (g >= U) return;

  for (int u = g; u < U; u += G) {
    if (bufs) {
      cp_async_wait<0>();  // this u's copy
      __syncwarp();        // every lane's copies are visible to the warp
    }
    const int k1 = a.key1[cell * U + u];
    TO* out_u = a.out + (cell * U + u) * (size_t)F * E;
    chain_step(a, u, k1, qp_w, fp, bufs ? qp_w : qp_c + (size_t)u * sqf_g, bufs ? fp : F, xm_s, n2h_s, n1h_s,
               key2_s, y_w, out_u, lane);
    __syncwarp();  // every lane is done with the qp buffer
    if (bufs && u + G < U) {
      copy_qp(qp_w, qp_c + (size_t)(u + G) * sqf_g, sqf_g, F, fp, copy16, lane);
      cp_async_commit();
    }
  }
}

template <typename TO>
int run(const void* n1, const void* n2, const void* key1, const void* key2, const void* xm, const void* qp, void* out,
        int cells, int U, int Q, int K2, int S, int E, int F, int warps, int parts, int qp_buffers, int copy16,
        long long smem_bytes, void* stream) {
  if (cells <= 0 || U <= 0 || F <= 0 || E <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps || parts < 1 || qp_buffers < 0 || qp_buffers > 1 ||
      (copy16 && (F % 4 != 0 || qp_buffers == 0 || reinterpret_cast<uintptr_t>(qp) % 16 != 0)) ||
      (!dtype::kF32<TO> && S > kLevels))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(warps, qp_buffers, U, Q, K2, S, E, F) * sizeof(float);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;
  ChainArgs<TO> a{static_cast<const float*>(n1), static_cast<const float*>(n2),
                  static_cast<const int32_t*>(key1), static_cast<const int32_t*>(key2),
                  static_cast<const float*>(xm), static_cast<const float*>(qp), static_cast<TO*>(out),
                  U, Q, K2, S, E, F, warps, parts, qp_buffers, copy16 ? 1 : 0,
                  (reinterpret_cast<uintptr_t>(xm) % 16 == 0 && ((size_t)Q * K2 * E) % 4 == 0) ? 1 : 0};
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(gemnet_quad_chain_kernel<TO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gemnet_quad_chain_kernel<TO><<<(unsigned)((size_t)cells * parts), warps * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: n1 [cells,U,Q,3] f32; n2 [cells,Q,K2,3] f32; key1
// [cells,U] i32; key2 [cells,Q,K2] i32; xm [cells,Q,K2,E] f32; qp
// [cells,U,S,Q,F] f32; out [cells,U,F,E] is written, f32 by
// gemnet_quad_chain_f32 and bf16 by gemnet_quad_chain_f32_bf16. The launch is
// quad_chain_plan's: `warps` a block (1..16), `parts` blocks a cell,
// `qp_buffers` (0: qp read from device memory, 1: a staged buffer a warp),
// `copy16` (16-byte qp copies; needs F % 4 == 0 and an aligned qp), and
// `smem_bytes`, which must equal this file's layout; a bf16 out needs S <= 8.
// Launches on `stream` and returns cudaGetLastError() after the launch (0 =
// success), or cudaErrorInvalidValue for a plan that disagrees.
#define QUAD_CHAIN_ENTRY(NAME, TO)                                                                               \
  extern "C" int NAME(const void* n1, const void* n2, const void* key1, const void* key2, const void* xm,        \
                      const void* qp, void* out, int cells, int U, int Q, int K2, int S, int E, int F, int warps, \
                      int parts, int qp_buffers, int copy16, long long smem_bytes, void* stream) {                \
    return run<TO>(n1, n2, key1, key2, xm, qp, out, cells, U, Q, K2, S, E, F, warps, parts, qp_buffers, copy16,  \
                   smem_bytes, stream);                                                                          \
  }
QUAD_CHAIN_ENTRY(gemnet_quad_chain_f32, float)
QUAD_CHAIN_ENTRY(gemnet_quad_chain_f32_bf16, __nv_bfloat16)

extern "C" const char* gemnet_quad_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
