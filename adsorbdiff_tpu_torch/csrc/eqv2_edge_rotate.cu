// EquiformerV2's truncated edge-frame Wigner rotation, fused, for Hopper
// (sm_90a), f32 (the bf16 form is csrc/eqv2_edge_rotate_bf16.cu).
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _edge_rot_kernel (called from _edge_rot_call; public eqv2_edge_rotate and
// eqv2_gather_rotate_to; constants _edge_rot_consts). With the alpha = 0
// gauge the rotation of one (edge, channel) column is a chain of constant
// block-diagonal products and per-edge z-rotations Dz:
//
//   to   (x [D] l-primary -> y [n_sel] truncated m-primary):
//        y = P_sel J Dz(beta) J^T Dz(gamma) x
//   from (v [n_sel] -> y [D]), the transpose, since Dz(t)^T = Dz(-t):
//        y = Dz(-gamma) J Dz(-beta) J^T P_sel^T v
//
// with D = (lmax + 1)^2, J = D(R_x(-pi/2)) block diagonal over l, P_sel the
// first n_sel rows of the m-primary order, and Dz(t) mixing each (l, +m) row
// with its (l, -m) partner: y[i] = cos(m t) x[i] + s_i sin(m t) x[partner].
// Each direction's VJP is the other direction at the same angles.
//
// What bounds it on the H100: at the training shape (E = 19,200 edges,
// C = 128, lmax 4, n_sel 19) a column needs the two block products (2 x 165
// FMAs, or fewer rows where P_sel drops them) and the two Dz stages (2 x 20
// partner pairs); ~0.8 kFLOP against 176 bytes read and written: ~4.6 FLOP
// per byte, below the card's ~20 f32 FLOP per byte. So bytes set the bound.
//
// The design: one thread per (edge, channel) column, channels fastest, so a
// warp's loads and stores of one coefficient row are coalesced. A thread
// holds its column's D coefficients in registers through the whole chain (the
// [E, 2D, C] intermediates of the plain chain never exist). J's diagonal
// blocks (165 floats at lmax 4), the Dz signs and the row map of P_sel sit in
// the kernel's parameter block, so every product reads its constant as a
// broadcast operand. cos/sin(m t) for m <= lmax are made per thread from the
// edge's two angles, read once per edge (not expanded over channels). The
// input row is addressed by index: the edge's own row, a node row shared by
// the K edges of a target (the target half: no K-broadcast copy exists), or a
// source node row x[b, src[b, n, k]] (the gather variant: no gathered copy
// exists). The TPU's [2D, D] stacking, (8, 128) padding and one-hot cos/sin
// expanders were Mosaic layout rules and have no counterpart. Not yet used:
// keeping a node row in shared memory for its K edges (the reads go through
// L2 instead).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 6;

__host__ __device__ constexpr int dim_of(int lmax) { return (lmax + 1) * (lmax + 1); }
// offset of block l in the packed diagonal blocks: sum_{q < l} (2q + 1)^2
__host__ __device__ constexpr int block_off(int l) { return l * (2 * l - 1) * (2 * l + 1) / 3; }

template <int LMAX>
struct RotConsts {
  float j[block_off(LMAX + 1)];  // J's diagonal blocks, each (2l+1) x (2l+1) row-major
  float sign[dim_of(LMAX)];      // Dz sign of row i (0 for m = 0)
  int row[dim_of(LMAX)];         // truncated row r < n_sel of l-primary row i, or -1
};

// v <- Dz(t) v on every (l, +-m) pair; cs[m], sn[m] = cos(m t), sin(m t)
template <int LMAX>
__device__ __forceinline__ void dz(float* v, const float* cs, const float* sn, const RotConsts<LMAX>& k) {
#pragma unroll
  for (int l = 1; l <= LMAX; ++l) {
#pragma unroll
    for (int m = 1; m <= l; ++m) {
      const int ip = l * l + l + m, in = l * l + l - m;
      const float a = v[ip], b = v[in];
      v[ip] = fmaf(cs[m], a, k.sign[ip] * sn[m] * b);
      v[in] = fmaf(cs[m], b, k.sign[in] * sn[m] * a);
    }
  }
}

// v <- J v (TRANSPOSE false) or J^T v (true), block by block
template <int LMAX, bool TRANSPOSE>
__device__ __forceinline__ void jmul(float* v, const RotConsts<LMAX>& k) {
#pragma unroll
  for (int l = 0; l <= LMAX; ++l) {
    constexpr int kMaxN = 2 * LMAX + 1;
    const int n = 2 * l + 1, base = l * l, off = block_off(l);
    float t[kMaxN];
#pragma unroll
    for (int a = 0; a < n; ++a) {
      float s = 0.f;
#pragma unroll
      for (int b = 0; b < n; ++b) s = fmaf(TRANSPOSE ? k.j[off + b * n + a] : k.j[off + a * n + b], v[base + b], s);
      t[a] = s;
    }
#pragma unroll
    for (int a = 0; a < n; ++a) v[base + a] = t[a];
  }
}

// cs[m], sn[m] = cos(m t), sign sin(m t)
template <int LMAX>
__device__ __forceinline__ void angle_table(float t, float sign, float* cs, float* sn) {
  cs[0] = 1.f;
  sn[0] = 0.f;
#pragma unroll
  for (int m = 1; m <= LMAX; ++m) {
    float s, c;
    sincosf((float)m * t, &s, &c);
    cs[m] = c;
    sn[m] = sign * s;
  }
}

// x: rows of n_in coefficients x C channels; the input row of edge e is
// (e / nk) * n_nodes + src[e] with src, else e / kdiv. out [E, n_out, C].
template <int LMAX, bool TO>
__global__ void __launch_bounds__(kThreads) eqv2_edge_rotate_kernel(
    const float* __restrict__ x, const int* __restrict__ src, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ out, long long E, int C, int n_in, int n_out,
    long long kdiv, long long nk, int n_nodes, const RotConsts<LMAX> k) {
  constexpr int D = dim_of(LMAX);
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= E * C) return;
  const long long e = col / C;
  const int c = (int)(col - e * C);
  const long long in_row = src != nullptr ? (e / nk) * n_nodes + src[e] : e / kdiv;
  const float* xin = x + in_row * n_in * (long long)C + c;

  float v[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (TO) {
      v[i] = xin[(long long)i * C];
    } else {
      const int r = k.row[i];
      v[i] = r >= 0 ? xin[(long long)r * C] : 0.f;
    }
  }

  float cs[LMAX + 1], sn[LMAX + 1];
  const float g = gamma[e], bt = beta[e];
  if (TO) {
    angle_table<LMAX>(g, 1.f, cs, sn);
    dz<LMAX>(v, cs, sn, k);
  }
  jmul<LMAX, true>(v, k);
  angle_table<LMAX>(bt, TO ? 1.f : -1.f, cs, sn);
  dz<LMAX>(v, cs, sn, k);
  jmul<LMAX, false>(v, k);
  if (!TO) {
    angle_table<LMAX>(g, -1.f, cs, sn);
    dz<LMAX>(v, cs, sn, k);
  }

  float* dst = out + e * n_out * (long long)C + c;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (TO) {
      const int r = k.row[i];
      if (r >= 0) dst[(long long)r * C] = v[i];
    } else {
      dst[(long long)i * C] = v[i];
    }
  }
}

template <int LMAX>
int launch(const float* x, const int* src, const float* gamma, const float* beta, float* out, long long E, int C,
           int n_in, int n_out, long long kdiv, long long nk, int n_nodes, bool to, const float* j_host,
           const float* sign_host, const int* row_host, cudaStream_t stream) {
  RotConsts<LMAX> k;
  for (int i = 0; i < block_off(LMAX + 1); ++i) k.j[i] = j_host[i];
  for (int i = 0; i < dim_of(LMAX); ++i) {
    k.sign[i] = sign_host[i];
    k.row[i] = row_host[i];
  }
  const long long blocks = (E * C + kThreads - 1) / kThreads;
  if (to) {
    eqv2_edge_rotate_kernel<LMAX, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, src, gamma, beta, out, E, C, n_in, n_out, kdiv, nk, n_nodes, k);
  } else {
    eqv2_edge_rotate_kernel<LMAX, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        x, src, gamma, beta, out, E, C, n_in, n_out, kdiv, nk, n_nodes, k);
  }
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* src, const void* gamma, const void* beta, void* out, long long E, int C,
             int n_in, int n_out, long long kdiv, long long nk, int n_nodes, int lmax, int direction_to,
             const void* j_blocks, const void* sign, const void* row, void* stream) {
  if (E <= 0 || C <= 0) return 0;
  const float* xp = static_cast<const float*>(x);
  const int* sp = static_cast<const int*>(src);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  float* op = static_cast<float*>(out);
  const float* jh = static_cast<const float*>(j_blocks);
  const float* sh = static_cast<const float*>(sign);
  const int* rh = static_cast<const int*>(row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool to = direction_to != 0;
  switch (lmax) {
    case 1: return launch<1>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    case 2: return launch<2>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    case 3: return launch<3>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    case 4: return launch<4>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    case 5: return launch<5>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    case kMaxL: return launch<kMaxL>(xp, sp, gp, bp, op, E, C, n_in, n_out, kdiv, nk, n_nodes, to, jh, sh, rh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors: x f32 (rows of n_in x C), src int32 [E] or null, gamma and beta
// f32 [E], out f32 [E, n_out, C] (written). Host pointers: j_blocks f32 (J's
// diagonal blocks, sum_l (2l+1)^2 floats), sign f32 [D], row int32 [D] (the
// truncated row of each l-primary row, -1 where P_sel drops it). direction_to
// is 1 for "to" (n_in = D, n_out = n_sel) and 0 for "from" (n_in = n_sel,
// n_out = D). lmax <= 6. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success; cudaErrorInvalidValue for lmax > 6).
extern "C" int eqv2_edge_rotate_f32(const void* x, const void* src, const void* gamma, const void* beta, void* out,
                                    long long E, int C, int n_in, int n_out, long long kdiv, long long nk,
                                    int n_nodes, int lmax, int direction_to, const void* j_blocks,
                                    const void* sign, const void* row, void* stream) {
  return dispatch(x, src, gamma, beta, out, E, C, n_in, n_out, kdiv, nk, n_nodes, lmax, direction_to, j_blocks, sign,
                  row, stream);
}

extern "C" const char* eqv2_edge_rotate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
