// The PaiNN message of one target atom, the body of painn_message_consumer.cu
// (rows gathered by the caller), for Hopper (sm_90a), f32. For target t and
// feature column h, over its K neighbour slots k:
//
//   basis[k, r] = exp(-(R-1)^2/2 * (d_k - r/(R-1))^2) * env(d_k),  d_k = dist/cutoff
//   f[k, c]     = (bias[c] + sum_r basis[k, r] * W[r, c])   for a valid slot, c < 3H
//   g = xrow_k[c] * f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] * g3 + vrow_k[d*H + h] * g2
//
// (before PaiNN's 1/sqrt(H) scale, which the caller applies). xrow_k and
// vrow_k are rows of the features; an invalid slot contributes nothing.
// painn_message_fused.cu computes the same function with the rows gathered by
// index, in a body of its own.
//
// The basis is sparse: basis[k, r] = exp(-(r - c_k)^2 / 2) env(d_k) with
// c_k = d_k (R-1), a unit-width gaussian in r that underflows to exactly 0 in
// f32 once |r - c_k| > 14.4, and is 0 for d_k >= 1: at most 29 of the R rows
// per edge are not zero.
//
// The design: one block of kThreads threads per target and 128 feature
// columns; thread h owns the three filter columns h, H+h, 2H+h that its
// outputs need. stage_target puts the target's K edges' basis [R][K]
// (computed in the block, never in device memory), unit vectors and rows in
// shared memory; message_columns keeps a 16-edge x 3-column tile of the
// filter in registers (each W element it loads feeds 16 FMAs, each basis
// value, a shared-memory broadcast, feeds 3), loops each 16-edge pass only
// over the rows its valid edges can reach (the union of their windows; the
// skipped terms are exact zeros of the dense sum; slots sorted by distance
// keep the union narrow, any order stays correct), and reduces over K in
// registers. W is not kept on chip: every pass reloads the W rows it
// reaches through L1/L2 (W itself, 0.79 MB at R=128, H=512, stays in L2).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace painn_message {

constexpr int kThreads = 128;  // feature columns per block, one per thread
constexpr int kChunk = 16;     // edges per register tile
constexpr int kReach = 14;     // basis rows with |r - c| > kReach + 1 underflow to 0

// Rows of the basis tile: whole 16-edge chunks, then the tail rounded up to 4.
__host__ __device__ inline int padded_edges(int K) {
  return K / kChunk * kChunk + (K % kChunk + 3) / 4 * 4;
}

__host__ __device__ inline int num_chunks(int K) { return (K + kChunk - 1) / kChunk; }

__host__ __device__ inline size_t smem_bytes(int K, int R) {
  return ((size_t)R * padded_edges(K) + 5 * (size_t)K) * sizeof(float) +
         ((size_t)K + 2 * (size_t)num_chunks(K)) * sizeof(int);
}

// One target's edges in shared memory (smem_bytes(K, R) of dynamic shared memory).
struct Tile {
  float* basis;  // [R][padded_edges(K)]
  float* unit;   // [K][3]
  float* dsc;    // [K] distance / cutoff
  float* env;    // [K]
  int* row;      // [K] feature row of each slot, -1 = adds nothing
  int* lo;       // [num_chunks] first reachable basis row of a 16-edge chunk
  int* hi;       // [num_chunks] last reachable basis row
};

__device__ inline Tile carve(float* smem, int K, int R) {
  Tile t;
  t.basis = smem;
  t.unit = t.basis + (size_t)R * padded_edges(K);
  t.dsc = t.unit + 3 * K;
  t.env = t.dsc + K;
  t.row = reinterpret_cast<int*>(t.env + K);
  t.lo = t.row + K;
  t.hi = t.lo + num_chunks(K);
  return t;
}

// Stage the target's K slots starting at flat slot e0: row_of(k) gives slot
// k's feature row, or -1 for a slot that adds nothing. Every thread of the
// block calls it; it ends with a barrier. A caller that reuses the tile for
// another target puts a barrier before it.
template <class RowOf>
__device__ __forceinline__ void stage_target(const Tile& t, const float* __restrict__ dist,
                                             const float* __restrict__ unit, size_t e0, int K, int R,
                                             float inv_cutoff, int p, RowOf row_of) {
  const int k_pad = padded_edges(K);
  for (int c = threadIdx.x; c < num_chunks(K); c += blockDim.x) {
    t.lo[c] = R;
    t.hi[c] = -1;
  }
  __syncthreads();
  // per slot: row, unit vector, distance, polynomial envelope, and the rows
  // its basis can reach
  const float pf = (float)p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int row = row_of(k);
    t.row[k] = row;
    t.unit[3 * k + 0] = unit[(e0 + k) * 3 + 0];
    t.unit[3 * k + 1] = unit[(e0 + k) * 3 + 1];
    t.unit[3 * k + 2] = unit[(e0 + k) * 3 + 2];
    const float d = dist[e0 + k] * inv_cutoff;
    float dp = 1.f;
    for (int j = 0; j < p; ++j) dp *= d;
    const float env = 1.f + ca * dp + cb * dp * d + cc * dp * d * d;
    t.dsc[k] = d;
    t.env[k] = d < 1.f ? env : 0.f;
    if (row >= 0 && d < 1.f) {  // else the slot adds nothing or has an all-zero basis
      const int bin = min((int)(d * (float)(R - 1)), R - 1);
      atomicMin(t.lo + k / kChunk, max(0, bin - kReach));
      atomicMax(t.hi + k / kChunk, min(R - 1, bin + kReach + 1));
    }
  }
  __syncthreads();
  // gaussian basis x envelope, on each chunk's reachable rows only
  const float coeff = -0.5f * (float)((R - 1) * (R - 1));
  for (int idx = threadIdx.x; idx < R * k_pad; idx += blockDim.x) {
    const int r = idx / k_pad;
    const int k = idx - r * k_pad;
    if (k < K && r >= t.lo[k / kChunk] && r <= t.hi[k / kChunk]) {
      const float diff = t.dsc[k] - (float)r / (float)(R - 1);
      t.basis[idx] = expf(coeff * diff * diff) * t.env[k];
    }
  }
  __syncthreads();
}

template <int KC>
__device__ __forceinline__ void edge_chunk(
    int k0, int K, int k_pad, int r_lo, int r_hi, int H, int h,
    const float* __restrict__ basis_s, const float* __restrict__ unit_s,
    const int* __restrict__ row_s, const float* __restrict__ w,
    float b0, float b1, float b2,
    const float* __restrict__ xh_rows, const float* __restrict__ vec_rows,
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
  for (int r = r_lo; r <= r_hi; ++r) {
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
      const int s = row_s[k];
      if (s >= 0) {
        const float* xr = xh_rows + (size_t)s * F;
        const float* vr = vec_rows + (size_t)s * F;
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

// Column h (< H) of the staged target's outputs: dx_t [H] and dvec_t [3][H];
// slot k's features are row t.row[k] of xh_rows and vec_rows ([rows][3H]).
__device__ __forceinline__ void message_columns(
    const Tile& t, int K, int H, int h, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ xh_rows, const float* __restrict__ vec_rows, float* __restrict__ dx_t,
    float* __restrict__ dvec_t) {
  const int k_pad = padded_edges(K);
  const float b0 = bias[h], b1 = bias[H + h], b2 = bias[2 * H + h];
  float dx = 0.f, dv0 = 0.f, dv1 = 0.f, dv2 = 0.f;
  int k0 = 0;
  for (; k0 + kChunk <= K; k0 += kChunk) {
    const int c = k0 / kChunk;
    edge_chunk<kChunk>(k0, K, k_pad, t.lo[c], t.hi[c], H, h, t.basis, t.unit, t.row, w, b0, b1, b2, xh_rows,
                       vec_rows, dx, dv0, dv1, dv2);
  }
  const int tail = K - k0;
  const int c = k0 / kChunk;
  if (tail > 12) {
    edge_chunk<16>(k0, K, k_pad, t.lo[c], t.hi[c], H, h, t.basis, t.unit, t.row, w, b0, b1, b2, xh_rows, vec_rows,
                   dx, dv0, dv1, dv2);
  } else if (tail > 8) {
    edge_chunk<12>(k0, K, k_pad, t.lo[c], t.hi[c], H, h, t.basis, t.unit, t.row, w, b0, b1, b2, xh_rows, vec_rows,
                   dx, dv0, dv1, dv2);
  } else if (tail > 4) {
    edge_chunk<8>(k0, K, k_pad, t.lo[c], t.hi[c], H, h, t.basis, t.unit, t.row, w, b0, b1, b2, xh_rows, vec_rows,
                  dx, dv0, dv1, dv2);
  } else if (tail > 0) {
    edge_chunk<4>(k0, K, k_pad, t.lo[c], t.hi[c], H, h, t.basis, t.unit, t.row, w, b0, b1, b2, xh_rows, vec_rows,
                  dx, dv0, dv1, dv2);
  }
  dx_t[h] = dx;
  dvec_t[h] = dv0;
  dvec_t[H + h] = dv1;
  dvec_t[2 * H + h] = dv2;
}

}  // namespace painn_message
