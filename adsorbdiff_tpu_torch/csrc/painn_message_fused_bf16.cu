// PaiNN message block, fused, in bf16, for Hopper (sm_90a), on the bf16
// tensor cores.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _painn_message_fused_kernel (wrapper painn_message_fused) for bf16 xh
// (PaiNN with compute_dtype: bfloat16), with the TPU kernel's rounding. For
// every target atom t = (b, i) and feature column h, over the K neighbour
// slots:
//
//   basis[k, r] = bf16(exp(-(R-1)^2/2 (d_k - r/(R-1))^2) env(d_k)),  d_k = dist/cutoff
//   f[k, c]     = bias[c] + sum_r basis[k, r] bf16(W[r, c])   (summed in f32)   c < 3H
//   g = xh[b, src_k, c] f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] g3 + vec[b, src_k, d H + h] g2
//
// in f32, before PaiNN's 1/sqrt(H): ops/kernels.py::
// painn_message_fused_reference for bf16 xh, the TPU kernel's
// jnp.dot(basis.astype(cdt), w.astype(cdt), preferred_element_type=f32). xh
// and W are bf16, vec bf16 (PaiNN's layers 1-2) or f32 (layers 3-6, where the
// f32 scale factor widens it), everything else f32. A masked slot, or a
// source outside [0, N), adds nothing; an unmasked slot at or past the
// cutoff adds xh x bias (its basis is all zero, its bias is not).
//
// Each basis value is made by the plain version's f32 steps (the offset
// r/(R-1) an IEEE division, then a subtraction, two products, expf and the
// product with the envelope of powf terms, each rounded to nearest and
// unfused) and rounded once to bf16, so it is the plain version's bit for
// bit: a value one f32 ulp off can round to the neighbouring bf16 number.
// In r it is a unit-width gaussian around c_k = d_k (R-1), exactly 0 in f32
// once |r - c_k| > 14.4 and for d_k >= 1: a slot of bin floor(c_k) reaches
// rows [bin - 14, bin + 15] only.
//
// What bounds it on the H100: at the sampling shape (B=16, N=80, K=50,
// H=512, R=128; 64,000 valid edges with ~28.8 non-zero basis rows each) the
// filter product the data needs is ~5.7 GFLOP of bf16 products (5.7 us at
// the dense bf16 tensor rate), the f32 gather-multiply and sums ~0.7 GFLOP
// (9.8 us at the f32 rate), the bytes ~20 MB (6 us at 3.35 TB/s): 0.0158 ms.
// In practice the instructions around the products set the time: the
// gather-multiply (~18 operations a slot and column, from 8-byte loads of
// the source rows), the shared-memory reads of W^T, and the basis values
// (~12 f32 operations each), which are therefore made once, not once for
// each of the 16 column slices.
//
// The design (ops/kernels.py::painn_bf16_plan sets the launch, the
// shared-memory layout and the scratch layout; the entries refuse a plan
// whose layouts do not hold what the kernels read and write):
//   * a pre-pass (basis_kernel), one warp 4 tiles of 8 consecutive slots of
//     a target (a lane a slot), writes each tile's slot records (source row or -1, unit
//     vector), its chunk range (the 16-row chunks its valid slots' windows
//     reach; the rows outside are exactly 0, so skipping them is exact) and,
//     for each chunk in it, the B fragment of the filter product, four bf16
//     basis values a lane, 256 bytes a chunk, into the wrapper's scratch;
//   * the main kernel: block (x, y) takes targets [x tpb, (x + 1) tpb) of the
//     B N (any systems) and the 32 columns h0 = 32 y .. of each H-block; its
//     8 warps take targets warp, warp + 8, ...;
//   * the filter product is mma.sync.m16n8k16 bf16 with f32 accumulators
//     (csrc/mma_bf16.cuh). Its M is the block's 96 columns jH + h, six m16
//     tiles: A = W^T, the wrapper's pack (ops/kernels.py::
//     pack_painn_message_bf16: W rounded to bf16, a slice's rows ordered so
//     that lane 4g + t of a C fragment holds columns h0 + 4g .. 4g + 3 of
//     each H-block, rows zero past R and H, an odd number of 16-byte chunks
//     long, so ldmatrix reads eight rows on eight bank groups) copied once a
//     block with cp.async and read with ldmatrix. Its N is the slots, 8 a
//     tile, two tiles a pass; its K the basis rows, 16 a chunk: a pass loads
//     its tiles' fragments of 2 chunks at once, then multiplies each
//     W^T fragment, loaded once, by the tiles whose range holds the chunk;
//   * the C fragment starts from the bias and holds, in lane 4g + t, the
//     filter of slots 2t and 2t + 1 at columns h0 + 4g .. 4g + 3 of every
//     H-block, so the gather-multiply reads each source row's four columns
//     with one 8-byte load (16 for f32 vec) through L1, and the K-sum runs in
//     registers; at the target's end a transposing sum over the lanes of a
//     quad (12 shuffles) leaves lane 4g + t with one of dx, dvec[0..2] at
//     its four columns, written with one 16-byte store: no atomics and no
//     barrier after the staging.
// Any B, N, K >= 1, 2 <= R <= 1200 (W^T in one block's shared memory) and H
// a multiple of 4 (16-byte output rows).
//
// Measured (chip_smoke.py phase 25, scripts/variants_painn_bf16_mma.py;
// NVIDIA H100 80GB HBM3): PERF.md section 6, row 3 bf16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;                      // columns h a block, in each H-block
constexpr int kMTiles = 6;                     // m16 tiles of W^T: (H-block j, half q) = 2 j + q
constexpr int kWRows = 16 * kMTiles;           // W^T rows a block
constexpr int kBatch = 2;                      // chunks whose fragments a pass loads at once
constexpr int kItems = 4;                      // (target, tile) items a warp of the pre-pass takes
constexpr int kReachLo = 14, kReachHi = 15;    // a slot of bin b reaches rows [b - 14, b + 15]
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInvSqrt3 = 0.57735026918962576f;

// the pre-pass's outputs in the scratch: per (target, tile) item, its chunk range, its 8 slot records and, per
// chunk c of the R rounded up to 16 over 16, a B fragment of 32 lanes
struct Scratch {
  uint2* frags;     // [T][G][C16][32]
  int2* ranges;     // [T][G]: first, last chunk (last < first: none)
  float4* records;  // [T][G][8]: unit vector, source row (-1: adds nothing) as int bits
};

struct BasisArgs {
  const int32_t* src;
  const float* dist;
  const uint8_t* mask;
  const float* unit;
  Scratch out;
  int N, K, R, G, items;
  float inv_cutoff;
  int p;
};

template <typename TV>
struct Args {
  const __nv_bfloat16* xh;
  const TV* vec;
  const __nv_bfloat16* wt;  // [slices][96][w_stride]
  const float* bias;
  Scratch in;
  float *dx, *dvec;
  int R, H, G, T, tpb, w_stride;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

// four consecutive columns of a source row, widened to f32
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = mma::unpack_bf16x2(w.x), hi = mma::unpack_bf16x2(w.y);
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
}

// basis value of a slot at d = dist/cutoff with envelope env, at row r: the plain version's f32 steps
// (c0 = -(R-1)^2/2); rows past R, where W^T is zero, take offset 0
__device__ __forceinline__ float basis(float d, float env, int r, int R, float rm1, float c0) {
  const float df = __fsub_rn(d, r < R ? __fdiv_rn((float)r, rm1) : 0.f);
  return __fmul_rn(expf(__fmul_rn(c0, __fmul_rn(df, df))), env);
}

// ---- the pre-pass: one warp 4 (target, tile of 8 slots) items, lanes 8i .. 8i + 7 the slots of item i ----
__global__ void __launch_bounds__(kThreads) basis_kernel(const BasisArgs a) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int item0 = (blockIdx.x * kWarps + threadIdx.x / 32) * kItems;
  if (item0 >= a.items) return;
  const int N = a.N, K = a.K, R = a.R;
  const int item = item0 + lane / 8;  // this lane's item and slot k
  const int tt = item / a.G, k = item % a.G * 8 + lane % 8;
  const bool mine = item < a.items;
  const float rm1 = (float)(R - 1);

  // slot k: its source row (-1: adds nothing), unit vector, d and envelope
  int row = -1;
  float d = 2.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
  if (mine && k < K) {
    const size_t ek = (size_t)tt * K + k;
    const bool m = a.mask[ek];
    const int s = __ldg(a.src + ek);
    const float dk = __ldg(a.dist + ek);
    const float x0 = __ldg(a.unit + 3 * ek), x1 = __ldg(a.unit + 3 * ek + 1), x2 = __ldg(a.unit + 3 * ek + 2);
    if (m && s >= 0 && s < N) {
      row = tt / N * N + s;
      d = dk * a.inv_cutoff;
      u0 = x0, u1 = x1, u2 = x2;
    }
  }
  if (mine) a.out.records[(size_t)item0 * 8 + lane] = make_float4(u0, u1, u2, __int_as_float(row));
  const bool reach = d < 1.f;  // a valid slot with a non-zero basis
  float env = 0.f;
  int lo = R, hi = -1;
  if (reach) {  // the plain version's f32 steps
    const float pf = (float)a.p;
    const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f, cb = pf * (pf + 2.f), cc = -pf * (pf + 1.f) * 0.5f;
    env = __fadd_rn(__fadd_rn(__fadd_rn(1.f, __fmul_rn(ca, powf(d, pf))), __fmul_rn(cb, powf(d, pf + 1.f))),
                    __fmul_rn(cc, powf(d, pf + 2.f)));
    const int bin = min((int)(d * rm1), R - 1);
    lo = max(0, bin - kReachLo);
    hi = min(R - 1, bin + kReachHi);
  }
  // each item's chunks: those its slots' windows reach (the union over its 8 lanes)
#pragma unroll
  for (int o = 1; o < 8; o *= 2) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  const int cl = lo / 16;
  const int ch = hi >> 4;
  if (mine && lane % 8 == 0) a.out.ranges[item] = make_int2(cl, ch);
  // item i's fragments: lane 4g + t makes slot g at rows 16c + 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1)
  const float c0 = -0.5f * rm1 * rm1;
  const int c16 = (R + 15) / 16;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int from = 8 * i + g;
    const float dg = __shfl_sync(kFull, d, from), eg = __shfl_sync(kFull, env, from);
    const int first = __shfl_sync(kFull, cl, 8 * i), last = __shfl_sync(kFull, ch, 8 * i);
    if (item0 + i >= a.items) break;
    uint2* frag = a.out.frags + (size_t)(item0 + i) * c16 * 32 + lane;
    for (int c = first; c <= last; ++c) {
      const int r = 16 * c + 2 * t;
      frag[32 * c] = make_uint2(mma::pack_bf16x2(basis(dg, eg, r, R, rm1, c0), basis(dg, eg, r + 1, R, rm1, c0)),
                                mma::pack_bf16x2(basis(dg, eg, r + 8, R, rm1, c0), basis(dg, eg, r + 9, R, rm1, c0)));
    }
  }
}

// ---- the main kernel ----
template <typename TV>
__global__ void __launch_bounds__(kThreads, 2) painn_fwd_bf16_kernel(const Args<TV> a) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int H = a.H, G = a.G;
  const int c16 = (a.R + 15) / 16;
  const size_t F = 3 * (size_t)H;

  // ---- the block's W^T slice (cp.async); the only barrier ----
  {
    const unsigned char* w = reinterpret_cast<const unsigned char*>(a.wt + (size_t)blockIdx.y * kWRows * a.w_stride);
    const uint32_t dst = mma::smem_addr(smem4);
    for (int i = tid; i < kWRows * a.w_stride / 8; i += kThreads) cp_async16(dst + 16 * i, w + 16 * i);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  const int h0 = blockIdx.y * kCols, hc = h0 + 4 * g;
  const bool cols = hc < H;  // H % 4 == 0: a lane's four columns are all in or all out
  // lane l reads row l % 16 of an m16 tile, k columns 8 (l / 16) ..: byte address of W^T at m tile 0, chunk 0
  const uint32_t wbase = mma::smem_addr(smem4) + 2 * ((lane % 16) * a.w_stride + 8 * (lane / 16));

  const int t0 = blockIdx.x * a.tpb, t1 = min(a.T, t0 + a.tpb);
  for (int tt = t0 + warp; tt < t1; tt += kWarps) {
    float acc[4][4];  // [dx, dvec 0, 1, 2][column hc + e], summed over this lane's slots
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;

    for (int q0 = 0; q0 < G; q0 += 2) {  // a pass: tiles q0 and q0 + 1 (slots 8 q0 .. 8 q0 + 15)
      const size_t item = (size_t)tt * G + q0;
      const bool two = q0 + 1 < G;
      // lanes 0-15 read the records of slots 8 q0 + lane; every lane the tiles' chunk ranges
      const float4 rec = lane < (two ? 16 : 8) ? __ldg(a.in.records + item * 8 + lane)
                                               : make_float4(0.f, 0.f, 0.f, __int_as_float(-1));
      const int2 rg0 = __ldg(a.in.ranges + item), rg1 = two ? __ldg(a.in.ranges + item + 1) : make_int2(c16, -1);
      float4 bias[3];  // columns hc .. hc + 3 of each H-block
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        bias[j] = cols ? __ldg(reinterpret_cast<const float4*>(a.bias + j * H + hc)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }

      float c[2][kMTiles][4];  // [tile][m tile (j, q)]: rows g, g + 8 = columns hc + 2q, + 1; slots 2t, 2t + 1
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          c[n][2 * j][0] = c[n][2 * j][1] = bias[j].x;
          c[n][2 * j][2] = c[n][2 * j][3] = bias[j].y;
          c[n][2 * j + 1][0] = c[n][2 * j + 1][1] = bias[j].z;
          c[n][2 * j + 1][2] = c[n][2 * j + 1][3] = bias[j].w;
        }
      }
      const uint2* frag0 = a.in.frags + item * c16 * 32 + lane;
      const uint2* frag1 = frag0 + c16 * 32;
      const int ch = max(rg0.y, rg1.y);
      for (int base = min(rg0.x, rg1.x); base <= ch; base += kBatch) {
        uint2 f0[kBatch], f1[kBatch];  // the B fragments of chunks base .. base + kBatch - 1, loaded together
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int ci = base + i;
          f0[i] = rg0.x <= ci && ci <= rg0.y ? __ldg(frag0 + 32 * ci) : make_uint2(0u, 0u);
          f1[i] = rg1.x <= ci && ci <= rg1.y ? __ldg(frag1 + 32 * ci) : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          const int ci = base + i;
          if (ci > ch) break;
          const bool in0 = rg0.x <= ci && ci <= rg0.y, in1 = rg1.x <= ci && ci <= rg1.y;
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            uint32_t w[4];
            mma::ldsm_x4(w, wbase + 2 * (16 * m * a.w_stride + 16 * ci));
            if (in0) mma::mma_bf16(c[0][m], w, f0[i].x, f0[i].y);
            if (in1) mma::mma_bf16(c[1][m], w, f1[i].x, f1[i].y);
          }
        }
      }

      // ---- the gather-multiply: slots 8 (q0 + n) + 2t + s of this lane, columns hc .. hc + 3 ----
      const int row = __float_as_int(rec.w);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int from = 8 * n + 2 * t + s;
          const int srow = __shfl_sync(kFull, row, from);
          const float su0 = __shfl_sync(kFull, rec.x, from), su1 = __shfl_sync(kFull, rec.y, from),
                      su2 = __shfl_sync(kFull, rec.z, from);
          if (srow >= 0 && cols) {
            const size_t base = (size_t)srow * F + hc;
            float x[3][4], v[3][4];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              load4(a.xh + base + j * H, x[j]);
              load4(a.vec + base + j * H, v[j]);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = e / 2, r = 2 * (e % 2) + s;
              const float g1 = x[0][e] * c[n][q][r];
              const float g2 = x[1][e] * c[n][2 + q][r] * kInvSqrt3;
              const float g3 = x[2][e] * c[n][4 + q][r];
              acc[0][e] += g1;
              acc[1][e] = fmaf(su0, g3, fmaf(v[0][e], g2, acc[1][e]));
              acc[2][e] = fmaf(su1, g3, fmaf(v[1][e], g2, acc[2][e]));
              acc[3][e] = fmaf(su2, g3, fmaf(v[2][e], g2, acc[3][e]));
            }
          }
        }
      }
    }

    // ---- the K-sum across the quad, transposed: lane 4g + t keeps output t (dx, dvec 0, 1, 2) ----
    float half[2][4];
    const bool up2 = t & 2, up1 = t & 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float keep = up2 ? acc[2 + i][e] : acc[i][e], give = up2 ? acc[i][e] : acc[2 + i][e];
        half[i][e] = keep + __shfl_xor_sync(kFull, give, 2);
      }
    }
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float keep = up1 ? half[1][e] : half[0][e], give = up1 ? half[0][e] : half[1][e];
      out[e] = keep + __shfl_xor_sync(kFull, give, 1);
    }
    if (cols) {
      float* dst = t == 0 ? a.dx + (size_t)tt * H + hc : a.dvec + (size_t)tt * F + (size_t)(t - 1) * H + hc;
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <typename TV>
int run(const void* xh, const void* vec, const void* src, const void* dist, const void* mask, const void* unit,
        const void* wt, const void* bias, void* dx, void* dvec, void* scratch, int B, int N, int K, int R, int H,
        float inv_cutoff, int envelope_exponent, int tpb, int w_stride, int smem, long long range_off,
        long long record_off, long long scratch_bytes, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  const int r16 = (R + 15) / 16 * 16;
  const auto aligned = [](const void* ptr, size_t n) { return reinterpret_cast<uintptr_t>(ptr) % n == 0; };
  if (K < 1 || R < 2 || H % 4 != 0 || tpb < 1 || (H + kCols - 1) / kCols > 65535 || (long long)B * N > 0x7fffffff ||
      !aligned(xh, 8) || !aligned(vec, 4 * sizeof(TV)) || !aligned(wt, 16) || !aligned(bias, 16) ||
      !aligned(dx, 16) || !aligned(dvec, 16) || !aligned(scratch, 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long T = (long long)B * N, G = (K + 7) / 8, items = T * G;
  // the plan's layouts must hold what the kernels read and write: in shared memory W^T's 96 rows of w_stride bf16
  // (an odd number of 16-byte chunks, at least R rounded up to 16) and nothing else; in the scratch the fragments
  // from byte 0, the chunk ranges from range_off, the slot records from record_off
  if (w_stride < r16 || w_stride % 16 != 8 || smem != 2 * kWRows * w_stride || items > 0x7fffffffLL ||
      range_off < items * (r16 / 16) * 256 || record_off < range_off + 8 * items || record_off % 16 != 0 ||
      scratch_bytes < record_off + 128 * items) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  const Scratch sc{reinterpret_cast<uint2*>(sp), reinterpret_cast<int2*>(sp + range_off),
                   reinterpret_cast<float4*>(sp + record_off)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BasisArgs p;
  p.src = static_cast<const int32_t*>(src);
  p.dist = static_cast<const float*>(dist);
  p.mask = static_cast<const uint8_t*>(mask);
  p.unit = static_cast<const float*>(unit);
  p.out = sc;
  p.N = N;
  p.K = K;
  p.R = R;
  p.G = (int)G;
  p.items = (int)items;
  p.inv_cutoff = inv_cutoff;
  p.p = envelope_exponent;
  basis_kernel<<<(unsigned)((items + kWarps * kItems - 1) / (kWarps * kItems)), kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  Args<TV> a;
  a.xh = static_cast<const __nv_bfloat16*>(xh);
  a.vec = static_cast<const TV*>(vec);
  a.wt = static_cast<const __nv_bfloat16*>(wt);
  a.bias = static_cast<const float*>(bias);
  a.in = sc;
  a.dx = static_cast<float*>(dx);
  a.dvec = static_cast<float*>(dvec);
  a.R = R;
  a.H = H;
  a.G = (int)G;
  a.T = (int)T;
  a.tpb = tpb;
  a.w_stride = w_stride;
  err = cudaFuncSetAttribute(painn_fwd_bf16_kernel<TV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T + tpb - 1) / tpb), (unsigned)((H + kCols - 1) / kCols));
  painn_fwd_bf16_kernel<TV><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: xh bf16 [B,N,3H]; vec [B,N,3H], bf16 (entry
// painn_message_fused_bf16_mma) or f32 (painn_message_fused_bf16_mma_vf32);
// src [B,N,K] i32; dist [B,N,K] f32; mask [B,N,K] bool (1 byte); unit
// [B,N,K,3] f32; wt: ops/kernels.py::pack_painn_message_bf16's W^T slices,
// bf16 [ceil(H/32)][96][w_stride]; bias [3H] f32; dx [B,N,H] f32 and dvec
// [B,N,3,H] f32 are written whole; scratch: scratch_bytes the pre-pass
// writes and the main kernel reads. The plan (ops/kernels.py::
// painn_bf16_plan): tpb targets a block, w_stride and smem (the shared-memory
// layout), range_off, record_off and scratch_bytes (the scratch's), 256
// threads a block. A plan whose layouts do not hold what the kernels read and
// write, K < 1, R < 2, H not a multiple of 4, or a pointer not aligned to its
// loads (8 bytes for xh and bf16 vec, 16 for the others) is refused with
// cudaErrorInvalidValue. Launches the pre-pass and the main kernel on
// `stream` and returns cudaGetLastError() after them (0 = success).
#define PAINN_BF16_ENTRY(NAME, TV)                                                                                 \
  extern "C" int NAME(const void* xh, const void* vec, const void* src, const void* dist, const void* mask,        \
                      const void* unit, const void* wt, const void* bias, void* dx, void* dvec, void* scratch,      \
                      int B, int N, int K, int R, int H, float inv_cutoff, int envelope_exponent, int tpb,          \
                      int w_stride, int smem, long long range_off, long long record_off, long long scratch_bytes,   \
                      void* stream) {                                                                              \
    return run<TV>(xh, vec, src, dist, mask, unit, wt, bias, dx, dvec, scratch, B, N, K, R, H, inv_cutoff,         \
                   envelope_exponent, tpb, w_stride, smem, range_off, record_off, scratch_bytes, stream);          \
  }
PAINN_BF16_ENTRY(painn_message_fused_bf16_mma, __nv_bfloat16)
PAINN_BF16_ENTRY(painn_message_fused_bf16_mma_vf32, float)

extern "C" const char* painn_message_fused_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
