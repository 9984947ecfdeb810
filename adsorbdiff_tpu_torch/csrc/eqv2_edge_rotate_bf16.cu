// EquiformerV2's truncated edge-frame Wigner rotation in bf16, for Hopper
// (sm_90a), on the bf16 tensor cores.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _edge_rot_kernel (called from _edge_rot_call; public eqv2_edge_rotate and
// eqv2_gather_rotate_to) for bf16 x, with the TPU kernel's rounding. Per
// (edge, channel) column, with the alpha = 0 gauge:
//
//   to   (x [D] l-primary -> y [n_sel] truncated m-primary):
//        y = P_sel J Dz(beta) J^T Dz(gamma) x
//   from (v [n_sel] -> y [D]), the transpose: y = Dz(-gamma) J Dz(-beta) J^T P_sel^T v
//
// D = (lmax + 1)^2, J = D(R_x(-pi/2)) block diagonal over l, P_sel the first
// n_sel rows of the m-primary order, Dz(t) mixing each (l, +m) row with its
// (l, -m) partner: y[+] = c x[+] + s_+ x[-], y[-] = c x[-] + s_- x[+] with
// c = cos(m t), s_+- = +-sign sin(m t). The roundings are those of
// ops/kernels.py::_edge_rotate_bf16_reference: J's entries and the cos/sin
// tables are bf16 values; each product with J sums in f32 and is rounded
// once; each Dz stage rounds both of its products and their sum.
//
// What bounds it on the H100: bytes. At the sampling shape (E = 25,600
// edges, C = 128, lmax 4, n_sel 19) a column moves 88 bytes ("to": 25 rows
// in, 19 out; "from": 19 in, 25 out) against ~0.8 kFLOP of bf16 products;
// the products of one launch (6.7 GFLOP on the padded 16 x 16 blocks) take
// ~7 us at the bf16 tensor rate.
//
// The design: the flattened (edge, channel) columns are the M dimension of
// two mma.sync.m16n8k16 products, the coefficients their K and N.
// - The coefficients are permuted (ops/kernels.py::rotate_bf16_layout) so
//   that each (l, +m) row and its (l, -m) partner sit at slots (2j, 2j+1);
//   the m = 0 rows are paired with each other (cos 1, sin 0: the identity),
//   and the slots are padded to P, a multiple of 16. In an A fragment and in
//   a C fragment of m16n8k16 a lane holds slots (2t, 2t+1) of each k8/n8
//   half, so every Dz stage runs inside a lane on packed bf16x2 registers:
//   mul(v, (c, c)) + mul(swap(v), (s_+, s_-)), each product and the sum
//   rounded once (mul.rn / add.rn.bf16x2), as the plain version rounds.
// - The slots come in groups of 16 that hold whole l blocks of J, so
//   J[pi, pi] is block diagonal over the groups and each product is one
//   m16n8k16 pair a group (J's 165 non-zeros at lmax 4 need 2 groups, not
//   the 4 x 2 blocks of a dense 32 x 32 product).
// - J comes from the wrapper as one bf16 matrix J[pi, pi] (zero-padded,
//   rows of an odd number of 16-byte chunks), copied once a block into
//   shared memory: read with ldmatrix.trans it is the first product's B
//   (J^T v), read without it the second's (J v).
// - A warp takes a run of consecutive 32-column tiles (two m16 tiles each).
//   A tile's input rows are copied in slot order into a tile buffer of the
//   warp (64-byte rows, swizzled: mma::swz64) and loaded as A fragments with
//   ldmatrix.trans. When C % 32 == 0 and the rows are 16-byte aligned (the
//   model's widths) a tile is 32 channels of one edge: the copies are
//   16-byte cp.async along the channels into a ring of 3 buffers, two tiles
//   ahead of the one being multiplied (with their edges' angles; the source
//   index of the next edge is loaded one edge ahead), so the loads' latency
//   hides behind the products; otherwise one tile at a time with 2-byte
//   loads. The three input forms differ only in the row address: the
//   edge's own row, a node row shared by the K edges of a target (e / kdiv),
//   or the source node row (e / nk) n_nodes + src[e].
// - The two C fragments of neighbouring n8 tiles, rounded and packed, are
//   the next product's A fragment (k16), so the chain stays in registers.
// - cos/sin(m t) are made once an edge (once a tile when tiles span edges;
//   not once a channel) into a per-warp table of packed (c, c), (s_+, s_-)
//   per edge and slot pair, the direction's sign folded in.
// - The result, packed, goes back into the tile with stmatrix.trans and
//   leaves as 16-byte stores along the channels (2-byte stores when the
//   tiles are not aligned); only the rows the direction writes are stored
//   (P_sel's for "to").
// - Persistent blocks of 8 warps, 2 an SM (ops/kernels.py::rotate_bf16_plan);
//   warp w of block b takes the (8 b + w)-th run of consecutive tiles.
// Any E and C, lmax 1-6 (P = 16, 16, 16, 32, 48, 64); a group with no input
// rows (no output rows) skips the first (second) product.
//
// Measured (chip_smoke.py phase 25, scripts/variants_eqv2_bf16_mma.py;
// NVIDIA H100 80GB HBM3): PERF.md section 6, row 8 bf16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 32;  // columns a warp takes at a time: two m16 tiles
constexpr int kBlocksPerSM = 2;  // ops/kernels.py::_ROT_PER_SM
constexpr int kStages = 3;       // a warp's tile buffers: the tile it multiplies and the ones in flight

// J's row stride (bf16 elements): an odd number of 16-byte chunks
__host__ __device__ constexpr int j_stride(int p) { return ((p / 8) | 1) * 8; }
// the constants' bytes: J [P][j_stride], then int16 in_row [P], out_row [P], pair_m [P / 2], pair_sign [P / 2]
__host__ __device__ constexpr int consts_bytes(int p) { return (2 * (p * j_stride(p) + 3 * p) + 15) / 16 * 16; }
// most edges 32 consecutive columns can touch
__host__ __device__ inline int tile_edges(int C) { return (C + 30) / C + 1 < 32 ? (C + 30) / C + 1 : 32; }
// a warp's shared bytes: its tiles [P][32 columns] (kStages when aligned, else 1) with an angle pair (16 bytes)
// each, and its table [2 angles][tile_edges][P / 2] of uint2
__host__ __device__ inline int warp_bytes(int p, int C, bool aligned) {
  return (aligned ? kStages : 1) * (64 * p + 16) + 8 * p * tile_edges(C);
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, int src_bytes) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v <- Dz on the packed pair v = (x[+], x[-]): k.x = (c, c), k.y = (s_+, s_-)
__device__ __forceinline__ uint32_t dz(uint32_t v, uint2 k) {
  return mma::add_bf16x2(mma::mul_bf16x2(v, k.x), mma::mul_bf16x2(__byte_perm(v, 0, 0x1032), k.y));
}

template <int P, bool TO, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) eqv2_edge_rotate_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const int* __restrict__ src, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, const int16_t* __restrict__ consts,
    long long E, int C, int n_in, int n_out, long long kdiv, long long nk, int n_nodes, int in_groups,
    int out_groups) {
  constexpr int JS = j_stride(P), KS = P / 16, NT = P / 8, NP = P / 2, NR = P / 8;
  constexpr int MT = P <= 32 ? 2 : 1;  // m16 tiles that share one pass over J
  constexpr int CB = consts_bytes(P);
  extern __shared__ uint4 smem16[];
  char* smem = reinterpret_cast<char*>(smem16);
  for (int i = threadIdx.x; i < CB / 16; i += kThreads) smem16[i] = __ldg(reinterpret_cast<const uint4*>(consts) + i);
  const __nv_bfloat16* j_s = reinterpret_cast<const __nv_bfloat16*>(smem);
  const int16_t* maps = reinterpret_cast<const int16_t*>(smem) + P * JS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ne = tile_edges(C);
  constexpr int NB = ALIGNED ? kStages : 1;
  char* xbuf = smem + CB + warp * warp_bytes(P, C, ALIGNED);  // NB tiles
  float* angs = reinterpret_cast<float*>(xbuf + NB * 64 * P);  // NB (gamma, beta) pairs
  uint2* tab = reinterpret_cast<uint2*>(xbuf + NB * (64 * P + 16));
  __syncthreads();

  // lane (g, t) copies slots g + 8 i, columns 8 t .. 8 t + 7 of a tile
  // and their rows' element offsets within an edge's input and output rows (-1: none)
  int in_r[NR], out_r[NR], in_off[NR], out_off[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    in_r[i] = maps[g + 8 * i], out_r[i] = maps[P + g + 8 * i];
    in_off[i] = in_r[i] >= 0 ? in_r[i] * C : -1, out_off[i] = out_r[i] >= 0 ? out_r[i] * C : -1;
  }
  // ldmatrix row addresses: J as [k][n] (.trans: the first product's B) and as [n][k] (the second's)
  const uint32_t jt_base = mma::smem_addr(j_s + (lane % 16) * JS + 8 * (lane / 16));
  const uint32_t jn_base = mma::smem_addr(j_s + (8 * (lane / 16) + lane % 8) * JS + 8 * ((lane / 8) % 2));

  // warp w takes the tiles [w per, (w + 1) per) of the flattened columns, in order
  const long long ncols = E * (long long)C;
  const long long ntiles = (ncols + kWarpCols - 1) / kWarpCols;
  const long long nwarps = (long long)gridDim.x * kWarps;
  const long long per = (ntiles + nwarps - 1) / nwarps;
  const long long t_first = ((long long)blockIdx.x * kWarps + warp) * per;
  const long long t_end = min(ntiles, t_first + per);
  if (t_first >= t_end) return;

  // ALIGNED (C % 32 == 0, 16-byte rows): a tile is 32 channels of one edge, the warp's tiles walk the edges in
  // order, and the rows of the next kStages - 1 tiles (with their edges' angles) are in flight by cp.async while
  // one is multiplied; an edge's tables are made once for its C / 32 tiles
  long long e0 = t_first * kWarpCols / C;
  int ch0 = (int)(t_first * kWarpCols - e0 * C);
  long long tab_e = -1;
  auto row_of = [&](long long e) { return src != nullptr ? (e / nk) * n_nodes + src[e] : e / kdiv; };
  long long fx_e = e0, row_e = -1, pf_e = -1;  // the next tile to fetch: edge, channel; its row's edge
  int fx_ch = ch0, pf_src = 0;
  const __nv_bfloat16* row_base = x;
  auto fetch_tile = [&](int buf) {
    if (fx_e != row_e) {
      long long row;
      if (src != nullptr) {  // the source index of the next edge is loaded one edge ahead
        const int sv = pf_e == fx_e ? pf_src : __ldg(src + fx_e);
        row = (fx_e / nk) * n_nodes + sv;
        if (fx_e + 1 < E) pf_src = __ldg(src + fx_e + 1), pf_e = fx_e + 1;
      } else {
        row = fx_e / kdiv;
      }
      row_base = x + row * n_in * (long long)C + 8 * t;
      row_e = fx_e;
    }
    char* dst = xbuf + buf * 64 * P;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      cp_async(mma::smem_addr(dst + mma::swz64(g + 8 * i, t)), row_base + fx_ch + max(in_off[i], 0), 16,
               in_off[i] >= 0 ? 16 : 0);
    }
    if (lane < 2) cp_async(mma::smem_addr(angs + 4 * buf + lane), (lane == 0 ? gamma : beta) + fx_e, 4, 4);
    fx_ch += kWarpCols;
    if (fx_ch == C) fx_ch = 0, ++fx_e;
  };
  if (ALIGNED) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (t_first + s < t_end) fetch_tile(s);
      cp_async_commit();
    }
  }

  int buf = 0;
  for (long long tile = t_first; tile < t_end; ++tile) {
    const long long col0 = tile * kWarpCols;
    if (!ALIGNED) e0 = col0 / C, ch0 = (int)(col0 - e0 * C);
    const int ncol = ALIGNED ? kWarpCols : (int)min((long long)kWarpCols, ncols - col0);
    const int nedge = ALIGNED ? 1 : (ch0 + ncol - 1) / C + 1;
    char* xs = xbuf + buf * 64 * P;
    if (ALIGNED) {
      if (tile + kStages - 1 < t_end) fetch_tile((buf + kStages - 1) % kStages);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
    }

    // cos/sin(m t) of the tile's edges, per slot pair: (c, c), (s_+, s_-) with the pair's sign and the direction's
    if (!ALIGNED || e0 != tab_e) {
      for (int i = lane; i < 2 * nedge * NP; i += 32) {
        const int a = i / (nedge * NP), el = (i / NP) % nedge, j = i % NP;
        float s, c;
        const float ang = ALIGNED ? angs[4 * buf + a] : __ldg((a == 0 ? gamma : beta) + e0 + el);
        sincosf((float)maps[2 * P + j] * ang, &s, &c);
        const float sr = __bfloat162float(__float2bfloat16_rn(s)) * (TO ? 1.f : -1.f) * (float)maps[2 * P + NP + j];
        const float cr = __bfloat162float(__float2bfloat16_rn(c));
        tab[(a * ne + el) * NP + j] = make_uint2(mma::pack_bf16x2(cr, cr), mma::pack_bf16x2(sr, -sr));
      }
      tab_e = e0;
    }

    // the tile's input rows in slot order (ALIGNED: fetched ahead)
    const int c8 = ch0 + 8 * t;  // this lane's first column, counted from e0's first channel
    if constexpr (!ALIGNED) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        uint16_t w[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          w[u] = 0;
          if (8 * t + u < ncol && in_r[i] >= 0) {
            const long long e = e0 + (c8 + u) / C;
            w[u] = __ldg(reinterpret_cast<const unsigned short*>(x) + (row_of(e) * n_in + in_r[i]) * (long long)C +
                         (c8 + u) % C);
          }
        }
        *reinterpret_cast<uint4*>(xs + mma::swz64(g + 8 * i, t)) =
            make_uint4(w[0] | (uint32_t)w[1] << 16, w[2] | (uint32_t)w[3] << 16, w[4] | (uint32_t)w[5] << 16,
                       w[6] | (uint32_t)w[7] << 16);
      }
    }
    __syncwarp();

    // table offsets of this lane's fragment rows (columns 16 mt + g and + 8); past the last column, the last edge
    int erow[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) erow[mt][h] = ALIGNED ? t : min((ch0 + 16 * mt + g + 8 * h) / C, nedge - 1) * NP + t;
    const uint2* tab_g = tab;            // gamma
    const uint2* tab_b = tab + ne * NP;  // beta

#pragma unroll
    for (int mb = 0; mb < 2; mb += MT) {
      uint32_t a[MT][KS][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          mma::ldsm_x4_trans(a[m][ks], mma::smem_addr(xs + mma::swz64(16 * ks + 8 * (lane / 16) + lane % 8,
                                                                       2 * (mb + m) + (lane / 8) % 2)));
          if (TO) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[m][ks][i] = dz(a[m][ks][i], tab_g[erow[mb + m][i & 1] + 8 * ks + 4 * (i >> 1)]);
            }
          }
        }
      // J^T v, rounded, packed: the second product's A; then Dz(beta)
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;
#pragma unroll
      for (int gi = 0; gi < KS; ++gi) {  // J[pi, pi] is block diagonal over the 16-slot groups
        if (!(in_groups >> gi & 1)) continue;
        uint32_t b[4];
        mma::ldsm_x4_trans(b, jt_base + 2 * 16 * gi * (JS + 1));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma::mma_bf16(acc[m][2 * gi], a[m][gi], b[0], b[1]);
          mma::mma_bf16(acc[m][2 * gi + 1], a[m][gi], b[2], b[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          a[m][ks][0] = mma::pack_bf16x2(acc[m][2 * ks][0], acc[m][2 * ks][1]);
          a[m][ks][1] = mma::pack_bf16x2(acc[m][2 * ks][2], acc[m][2 * ks][3]);
          a[m][ks][2] = mma::pack_bf16x2(acc[m][2 * ks + 1][0], acc[m][2 * ks + 1][1]);
          a[m][ks][3] = mma::pack_bf16x2(acc[m][2 * ks + 1][2], acc[m][2 * ks + 1][3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) a[m][ks][i] = dz(a[m][ks][i], tab_b[erow[mb + m][i & 1] + 8 * ks + 4 * (i >> 1)]);
        }
      // J v, rounded (then Dz(-gamma) for "from"), back into the tile by slot
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;
#pragma unroll
      for (int gi = 0; gi < KS; ++gi) {
        if (!(out_groups >> gi & 1)) continue;
        uint32_t b[4];
        mma::ldsm_x4(b, jn_base + 2 * 16 * gi * (JS + 1));
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma::mma_bf16(acc[m][2 * gi], a[m][gi], b[0], b[1]);
          mma::mma_bf16(acc[m][2 * gi + 1], a[m][gi], b[2], b[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          if (!(out_groups >> ks & 1)) continue;
          uint32_t o[4] = {mma::pack_bf16x2(acc[m][2 * ks][0], acc[m][2 * ks][1]),
                           mma::pack_bf16x2(acc[m][2 * ks][2], acc[m][2 * ks][3]),
                           mma::pack_bf16x2(acc[m][2 * ks + 1][0], acc[m][2 * ks + 1][1]),
                           mma::pack_bf16x2(acc[m][2 * ks + 1][2], acc[m][2 * ks + 1][3])};
          if (!TO) {
#pragma unroll
            for (int i = 0; i < 4; ++i) o[i] = dz(o[i], tab_g[erow[mb + m][i & 1] + 8 * ks + 4 * (i >> 1)]);
          }
          mma::stsm_x4_trans(mma::smem_addr(xs + mma::swz64(16 * ks + 8 * (lane / 16) + lane % 8,
                                                            2 * (mb + m) + (lane / 8) % 2)),
                             o);
        }
    }
    __syncwarp();

    // the rows this direction writes, out [E, n_out, C]
    if (ALIGNED) {
      __nv_bfloat16* base = out + e0 * n_out * (long long)C + c8;
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (out_off[i] >= 0) {
          *reinterpret_cast<uint4*>(base + out_off[i]) = *reinterpret_cast<const uint4*>(xs + mma::swz64(g + 8 * i, t));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (out_r[i] < 0) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(xs + mma::swz64(g + 8 * i, t));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (8 * t + u < ncol) {
            const long long e = e0 + (c8 + u) / C;
            reinterpret_cast<unsigned short*>(out)[(e * n_out + out_r[i]) * (long long)C + (c8 + u) % C] =
                (unsigned short)(w[u / 2] >> (16 * (u % 2)));
          }
        }
      }
    }
    __syncwarp();
    if (ALIGNED) {
      buf = buf + 1 == kStages ? 0 : buf + 1;
      ch0 += kWarpCols;
      if (ch0 == C) ch0 = 0, ++e0;
    }
  }
}

template <int P>
int launch(const void* x, const void* src, const void* gamma, const void* beta, void* out, const void* consts,
           long long E, int C, int n_in, int n_out, long long kdiv, long long nk, int n_nodes, bool to, int in_groups,
           int out_groups, long long blocks, int smem, cudaStream_t stream) {
  const bool aligned =
      C % kWarpCols == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long need = consts_bytes(P) + (long long)kWarps * warp_bytes(P, C, aligned);
  if (smem != need || blocks < 1 || blocks > 0x7fffffffLL || in_groups < 1 || in_groups >= 1 << P / 16 ||
      out_groups < 1 || out_groups >= 1 << P / 16) {
    return (int)cudaErrorInvalidValue;  // the wrapper's plan or layout disagrees with this kernel
  }
  auto kernel = to ? (aligned ? eqv2_edge_rotate_bf16_kernel<P, true, true>
                              : eqv2_edge_rotate_bf16_kernel<P, true, false>)
                   : (aligned ? eqv2_edge_rotate_bf16_kernel<P, false, true>
                              : eqv2_edge_rotate_bf16_kernel<P, false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(src), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), static_cast<const int16_t*>(consts), E, C,
      n_in, n_out, kdiv, nk, n_nodes, in_groups, out_groups);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors: x bf16 (rows of n_in x C), src int32 [E] or null, gamma and beta
// f32 [E], out bf16 [E, n_out, C] (written), consts: the int16 blob of
// ops/kernels.py::rotate_bf16_consts for P slots (J[pi, pi] as bf16, the
// slot maps, the pairs' |m| and signs). The input row of edge e is
// (e / nk) n_nodes + src[e] with src, else e / kdiv. direction_to is 1 for
// "to" (n_in = D, n_out = n_sel) and 0 for "from" (n_in = n_sel, n_out = D).
// in_groups and out_groups, from the layout: bit g set where the 16-slot
// group g holds input rows (the first product's blocks) and output rows (the
// second's). `blocks` and `smem` come from the wrapper's plan
// (ops/kernels.py::rotate_bf16_plan: 256 threads a block, the constants and,
// per warp, its tiles and its angle table); a plan this kernel
// does not match, or P other than 16, 32, 48 or 64, is refused with
// cudaErrorInvalidValue. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int eqv2_edge_rotate_bf16_mma(const void* x, const void* src, const void* gamma, const void* beta,
                                         void* out, const void* consts, long long E, int C, int n_in, int n_out,
                                         long long kdiv, long long nk, int n_nodes, int P, int direction_to,
                                         int in_groups, int out_groups, long long blocks, int smem, void* stream) {
  if (E <= 0 || C <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool to = direction_to != 0;
  switch (P) {
    case 16: return launch<16>(x, src, gamma, beta, out, consts, E, C, n_in, n_out, kdiv, nk, n_nodes, to, in_groups,
                               out_groups, blocks, smem, s);
    case 32: return launch<32>(x, src, gamma, beta, out, consts, E, C, n_in, n_out, kdiv, nk, n_nodes, to, in_groups,
                               out_groups, blocks, smem, s);
    case 48: return launch<48>(x, src, gamma, beta, out, consts, E, C, n_in, n_out, kdiv, nk, n_nodes, to, in_groups,
                               out_groups, blocks, smem, s);
    case 64: return launch<64>(x, src, gamma, beta, out, consts, E, C, n_in, n_out, kdiv, nk, n_nodes, to, in_groups,
                               out_groups, blocks, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* eqv2_edge_rotate_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
