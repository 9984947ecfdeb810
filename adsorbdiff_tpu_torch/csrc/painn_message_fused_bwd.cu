// Backward of the fused PaiNN message block, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _painn_message_fused_bwd_kernel (VJP _painn_fused_bwd). The forward
// (painn_message_fused.cu) computes, per edge e = (target t, slot k) with
// source s = src[e]:
//
//   f[e, c]  = mask_e * (bias[c] + sum_r basis[e, r] * W[r, c])        c < 3H
//   g = xh[s] * f;  dx[t, h] += g[h];
//   dvec[t, d, h] += unit[e, d] * g[2H+h] + vec[s, dH+h] * g[H+h] / sqrt(3)
//
// Given the cotangents gdx [B,N,H] and gdv [B,N,3,H], per valid edge and h:
//
//   ghat0 = gdx[t, h]
//   ghat1 = sum_d vec[s, dH+h] * gdv[t, d, h] / sqrt(3)
//   ghat2 = sum_d unit[e, d] * gdv[t, d, h]
//   dxh[s, jH+h]  += ghat_j * f[e, jH+h]                      (j = 0, 1, 2)
//   dvec[s, dH+h] += xh[s, H+h] * f[e, H+h] / sqrt(3) * gdv[t, d, h]
//   dfil[e, jH+h]  = ghat_j * xh[s, jH+h]
//   dW[r, c] = sum_e basis[e, r] * dfil[e, c];   db[c] = sum_e dfil[e, c]
//
// Masked slots and sources outside [0, N) contribute nothing (their filter,
// gathered row and scatter are all zero in the TPU kernel's one-hot form).
// There are no cotangents for dist and unit: the JAX contract.
//
// The basis is sparse. basis[e, r] = exp(-(R-1)^2/2 (d - r/(R-1))^2) env(d)
// = exp(-(r - c)^2 / 2) env(d) with c = d (R-1): a unit-width gaussian in r,
// which underflows to exactly 0 in f32 once |r - c| > 14.4, and is 0
// everywhere once d >= 1 (env = 0). An edge of bin b = floor(c) reaches rows
// [b - 14, b + 15] only; every product below runs only over the rows a group
// of edges can reach, and the terms it skips are exact zeros of the dense sum.
//
// What bounds it on the H100: at the training shape (B=48, N=80, K=50, R=128,
// H=512, <= 192,000 valid edges) the work the data needs is the two R x 3H
// products over each edge's non-zero rows, 2 x 6 x 29 x H flops, ~30H
// elementwise and ~10 R for the basis: ~37 GFLOP of f32 on the CUDA cores
// (~0.55 ms at 67 TFLOP/s), against ~150 MB to move (~0.05 ms). Operations
// set the bound; the dense count (the TPU kernel's) is 154 GFLOP.
//
// Design (ops/kernels.py::painn_bwd_plan sets the launch; the C function
// refuses a plan whose shared-memory size disagrees with its own layout):
//   * every source row a system's edges scatter to lies in that system, so a
//     block takes one system and a slice of HC columns h (HC = 32, 16 or 8,
//     each with its H + h and 2H + h), one block of 16 warps an SM, and keeps
//     the system's dxh/dvec on chip;
//   * a first small kernel, one block per system, gives each of the 16 warps
//     its own sources (ranked by in-degree and dealt in a snake, so the
//     warps' edge counts agree within a few per cent) and counting-sorts the
//     system's valid slots (mask set, source in [0, N)) by (owner warp, bin)
//     into a scratch buffer: warp w's stream holds the edges whose sources it
//     owns, by distance. Every column slice of the system reuses it;
//   * the main kernel: each warp walks its own stream in tiles of up to 16
//     edges whose bins span at most 10 beyond the first (at most 40 basis
//     rows; edges past the cutoff, bin R, in tiles of their own), with no
//     block barrier between the prologue and the epilogue:
//       0. the tile's basis over the rows its edges reach, into the warp's
//          buffer: lane e + 16k walks edge e up (k = 0) or down (k = 1) from
//          the row nearest its centre with two multiplies a row (the
//          gaussian's ratio of neighbouring rows is exp(+-(c - r) - 1/2));
//       1. filter: a 16-edge x 3-column register tile (lane = column h, or
//          lane groups of HC columns over 32/HC edge groups), W from shared
//          memory, the basis as broadcast float4s;
//       2. elementwise in registers (the target's cotangents loaded 4 edges
//          ahead): dxh and dvec (before dvec's xh[s, H+h] / sqrt(3) factor)
//          added to the warp's own source rows in shared memory with plain
//          loads and stores (no other warp writes them; lanes that share a
//          column take turns); the tile becomes dfil in place; db sums per
//          thread;
//       3. dW: for each row the tile reaches, the sum over its edges of
//          basis x dfil, one fire-and-forget reduction (RED) a row and
//          column into the zeroed dW;
//   * at the end: dxh and dvec are written once with plain stores (the
//     wrapper allocates them with torch.empty), db added once a block.
//   Shared memory at the training shape (N = 80, R = 128, HC = 32), 228,352 B:
//       the warps' basis buffers [16][40][20]       51,200 B
//       W columns h, H+h, 2H+h [R][3][HC] (cp.async)  49,152 B
//       dxh, dvec accumulators [N][3][HC] x 2       61,440 B
//       staged xh, vec rows [N][3][HC] x 2 (cp.async) 61,440 B
//       the tiles' edges (static) [16][16] x 5        5,120 B
//     The plan narrows HC as N grows, until the accumulators fit, stages the
//     xh/vec rows where they also fit (else reads them through L1/L2), and
//     past HC = 8 takes the GLOBAL branch, which adds dxh and dvec with
//     global REDs into zeroed outputs.
// Measured alternatives (chip_smoke.py's shape): float atomicAdd on shared
// memory compiles to a compare-and-swap loop (ATOMS.CAST.SPIN) on sm_90, and
// a scatter and a dW tile kept in shared memory through it were slower than
// global REDs; one block-wide pass of 128-256 edges at a time, with two or
// three barriers a pass, was as fast as these per-warp streams only once the
// scatter went to global REDs. Atomics make the order of the f32 sums into
// dxh/dvec (with GLOBAL), dW and db differ from run to run. Not yet used:
// tensor cores, TMA.
//
// The bf16 variants (PaiNN training with compute_dtype: bfloat16): xh in
// bf16, vec in bf16 or f32, widened where they are loaded (into the same f32
// shared memory when staged: the plan and layout are the f32 ones); W, the
// cotangents and every sum stay f32, and the recomputed basis is NOT rounded
// to bf16 (the TPU backward's jnp.dot(basis, w) in f32, unlike its forward).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

constexpr int kWarps = 16;                                // warps a block; warp w owns the sources s with s % 16 == w
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                                 // edges a warp takes at a time
constexpr int kWin = 40;                                  // basis rows a tile holds
constexpr int kReachLo = 14, kReachHi = 15;               // an edge of bin b reaches rows [b - 14, b + 15]
constexpr int kSpan = kWin - kReachLo - kReachHi - 1;     // bins a tile spans beyond its first
constexpr int kBW = kTile + 4;                            // basis row stride (16-byte rows)
constexpr int kWarpBuf = kWin * kBW;                      // floats of a warp's basis buffer
constexpr int kMaxR = 128;
constexpr int kMaxRank = 1024;                            // systems up to this N get balanced streams
constexpr int kAhead = 4;                                 // edges ahead that the target cotangents are loaded

// Dynamic shared floats of a block: the warps' basis buffers, the block's W columns
// [R][3][HC], the dxh/dvec accumulators [N][3][HC] x 2 (none with global
// atomics), the staged xh/vec rows [N][3][HC] x 2 (stage).
__host__ __device__ inline size_t smem_bytes(int N, int R, int hc, bool stage, bool global) {
  return sizeof(float) * ((size_t)kWarps * kWarpBuf + 3 * (size_t)R * hc + (global ? 0 : 6 * (size_t)N * hc) +
                          (stage ? 6 * (size_t)N * hc : 0));
}

// Sort bin of an edge: floor(c) for c = d (R-1) when d < 1, else R (no
// non-zero basis row).  NaN distances land in bin R too.
__device__ __forceinline__ int edge_bin(float d, int R) {
  return d < 1.f ? min((int)(d * (float)(R - 1)), R - 1) : R;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

// One element into the f32 shared memory (zero where !ok): by cp.async for
// float, by a widening load and a store for bf16.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, bool ok) {
  if constexpr (dtype::kF32<T>) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? dtype::ldg(src) : 0.f;
  }
}

// One block (of kWarps warps) per system: its valid slots (mask set, source
// in [0, N)) counting-sorted by (owner warp of the source, bin) into
// order[b]; warp w's stream is order[b][starts[b][w] .. starts[b][w + 1]).
// Owners balance the streams: the sources ranked by in-degree are dealt to
// the warps in a snake (0..15, 15..0, ..); past kMaxRank sources, source %
// kWarps.
__global__ void __launch_bounds__(kThreads) painn_bwd_sort_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ dist, const uint8_t* __restrict__ mask, int N,
    int K, int R, float inv_cutoff, int32_t* __restrict__ order, int32_t* __restrict__ starts) {
  __shared__ int cursor[kWarps * (kMaxR + 1)];  // per (warp, bin): count, then next free position
  __shared__ int base[kWarps + 1];
  __shared__ int deg[kMaxRank];
  __shared__ unsigned char owner[kMaxRank];
  const int nb = R + 1;
  const int b = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = N * K;
  const size_t g0 = (size_t)b * nk;
  const bool ranked = N <= kMaxRank;
  for (int i = threadIdx.x; i < kWarps * nb; i += kThreads) cursor[i] = 0;
  if (ranked) {
    for (int i = threadIdx.x; i < N; i += kThreads) deg[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < nk; i += kThreads) {
      const int s = src[g0 + i];
      if (mask[g0 + i] && s >= 0 && s < N) atomicAdd(deg + s, 1);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < N; s += kThreads) {
      int rank = 0;
      for (int o = 0; o < N; ++o) rank += deg[o] > deg[s] || (deg[o] == deg[s] && o < s);
      const int q = rank / kWarps, m = rank % kWarps;
      owner[s] = (unsigned char)(q & 1 ? kWarps - 1 - m : m);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nk; i += kThreads) {
    const int s = src[g0 + i];
    if (mask[g0 + i] && s >= 0 && s < N) {
      atomicAdd(cursor + (ranked ? owner[s] : s % kWarps) * nb + edge_bin(dist[g0 + i] * inv_cutoff, R), 1);
    }
  }
  __syncthreads();
  if (lane == 0) {  // warp w: exclusive scan of its stream's bins
    int run = 0;
    for (int i = warp * nb; i < (warp + 1) * nb; ++i) {
      const int c = cursor[i];
      cursor[i] = run;
      run += c;
    }
    base[warp + 1] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    base[0] = 0;
    for (int w = 0; w < kWarps; ++w) base[w + 1] += base[w];
  }
  __syncthreads();
  if (threadIdx.x <= kWarps) starts[(size_t)b * (kWarps + 1) + threadIdx.x] = base[threadIdx.x];
  for (int i = threadIdx.x; i < kWarps * nb; i += kThreads) cursor[i] += base[i / nb];
  __syncthreads();
  for (int i = threadIdx.x; i < nk; i += kThreads) {
    const int s = src[g0 + i];
    if (mask[g0 + i] && s >= 0 && s < N) {
      const int w = ranked ? owner[s] : s % kWarps;
      order[g0 + atomicAdd(cursor + w * nb + edge_bin(dist[g0 + i] * inv_cutoff, R), 1)] = i;
    }
  }
}

// TX: xh (float or bf16); TV: vec
template <typename TX, typename TV>
struct Args {
  const TX* xh;
  const TV* vec;
  const float *dist, *unit, *w, *bias, *gdx, *gdv;
  const int32_t* src;
  const int32_t* order;
  const int32_t* starts;
  float *dxh, *dvec, *dw, *db;
  int N, K, R, H;
  float inv_cutoff;
  int p;
};

template <typename TX, typename TV, int HC, bool STAGE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, 1) painn_bwd_kernel(const Args<TX, TV> a) {
  constexpr int EL = 32 / HC;    // lanes that share a column: edge groups in a warp
  constexpr int TE = kTile / EL;  // edges a thread holds
  constexpr int C3 = 3 * HC;
  extern __shared__ float4 smem4[];
  // the tiles' edges, apart from the dynamic arrays (the accumulators' stores do not order their loads)
  __shared__ int e_src_s[kWarps][kTile], e_tgt_s[kWarps][kTile];
  __shared__ float e_unit_s[kWarps][kTile][3];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hh = lane % HC, eh = lane / HC;
  const int b = blockIdx.y;
  const int H = a.H, N = a.N, R = a.R;
  float* bw = reinterpret_cast<float*>(smem4) + warp * kWarpBuf;  // this warp's basis [kWin][kBW]
  float* e_unit = e_unit_s[warp][0];
  int* e_src = e_src_s[warp];
  int* e_tgt = e_tgt_s[warp];
  float* w_s = reinterpret_cast<float*>(smem4) + kWarps * kWarpBuf;  // [R][3][HC]
  float* acc_x = w_s + R * C3;                                   // [N][3][HC]
  float* acc_v = acc_x + (GLOBAL ? 0 : N * C3);                  // [N][3][HC], before the xh[s, H+h] / sqrt(3)
  float* x_s = acc_v + (GLOBAL ? 0 : N * C3);                    // [N][3][HC] staged xh rows
  float* v_s = x_s + (STAGE ? N * C3 : 0);                       // [N][3][HC] staged vec rows

  const int h0 = blockIdx.x * HC;
  const int h = h0 + hh;
  const bool h_ok = h < H;
  const int hc = h_ok ? h : 0;  // clamped column for loads on idle lanes
  const int F = 3 * H;
  const size_t sys = (size_t)b * N;  // the system's first row
  const TX* xh_b = a.xh + sys * F;
  const TV* vec_b = a.vec + sys * F;
  const float* gdx_b = a.gdx + sys * H;
  const float* gdv_b = a.gdv + sys * F;
  float* dxh_b = a.dxh + sys * F;
  float* dvec_b = a.dvec + sys * F;
  const float inv_sqrt3 = 0.57735026918962576f;

  // ---- the block's W columns and the system's xh/vec rows (cp.async, zero past H), zeroed accumulators ----
  for (int i = tid; i < R * C3; i += kThreads) {
    const int r = i / C3, j = (i - r * C3) / HC, c = i % HC;
    const bool ok = h0 + c < H;
    cp_async4(w_s + i, a.w + r * F + j * H + (ok ? h0 + c : 0), ok);
  }
  if (STAGE) {
    for (int i = tid; i < N * C3; i += kThreads) {
      const int s = i / C3, j = (i - s * C3) / HC, c = i % HC;
      const bool ok = h0 + c < H;
      const size_t g = (size_t)s * F + j * H + (ok ? h0 + c : 0);
      stage(x_s + i, xh_b + g, ok);
      stage(v_s + i, vec_b + g, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if (!GLOBAL) {
    for (int i = tid; i < 2 * N * C3; i += kThreads) acc_x[i] = 0.f;  // acc_v follows acc_x
  }

  const float pf = (float)a.p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  const float rm1 = (float)(R - 1);
  const float einv = 0.36787944117144233f;  // e^-1
  const float b0 = __ldg(a.bias + hc), b1 = __ldg(a.bias + H + hc), b2 = __ldg(a.bias + 2 * H + hc);
  float db0 = 0.f, db1 = 0.f, db2 = 0.f;
  const int32_t* order = a.order + (size_t)b * N * a.K;
  int ptr = a.starts[(size_t)b * (kWarps + 1) + warp];
  const int end = a.starts[(size_t)b * (kWarps + 1) + warp + 1];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- this warp's stream, a tile of up to 16 edges at a time; no block barrier ----
  while (ptr < end) {
    // lanes 0..15 read edges ptr..ptr+15 of the stream (sorted by bin)
    const bool have = lane < kTile && ptr + lane < end;
    int s = 0, t = 0, bin = R + 1;
    float u0 = 0.f, u1 = 0.f, u2 = 0.f, d = 2.f, env = 0.f;
    if (have) {
      const int slot = order[ptr + lane];
      const size_t g = (size_t)b * N * a.K + slot;
      s = a.src[g];
      t = slot / a.K;
      u0 = __ldg(a.unit + 3 * g + 0);
      u1 = __ldg(a.unit + 3 * g + 1);
      u2 = __ldg(a.unit + 3 * g + 2);
      d = __ldg(a.dist + g) * a.inv_cutoff;
      float dp = 1.f;
      for (int j = 0; j < a.p; ++j) dp *= d;
      env = d < 1.f ? 1.f + ca * dp + cb * dp * d + cc * dp * d * d : 0.f;
      bin = edge_bin(d, R);
    }
    // the tile: the leading edges within kSpan bins of the first (past the cutoff: all of bin R)
    const int bfirst = __shfl_sync(0xffffffffu, bin, 0);
    const int limit = bfirst >= R ? R : min(bfirst + kSpan, R - 1);
    const int L = __popc(__ballot_sync(0xffffffffu, have && bin <= limit));
    const int blast = __shfl_sync(0xffffffffu, bin, L - 1);
    const int lo = bfirst >= R ? 0 : max(0, bfirst - kReachLo);
    const int hi = bfirst >= R ? -1 : min(R - 1, blast + kReachHi);
    if (lane < kTile) {
      const bool in = lane < L;
      e_src[lane] = in ? s : 0;
      e_tgt[lane] = in ? t : 0;
      e_unit[3 * lane + 0] = in ? u0 : 0.f;
      e_unit[3 * lane + 1] = in ? u1 : 0.f;
      e_unit[3 * lane + 2] = in ? u2 : 0.f;
    }
    // the basis of rows [lo, hi]: lane e + 16 k walks edge e's column up (k = 0) or down (k = 1) from the row
    // nearest its centre c = d (R-1), by basis[r +- 1] = basis[r] * exp(+-(c - r) - 1/2), two multiplies a row
    {
      const int e = lane % kTile;
      const float de = __shfl_sync(0xffffffffu, d, e), enve = __shfl_sync(0xffffffffu, env, e);
      if (hi >= lo) {
        const float c = de * rm1;
        const bool real = e < L;
        const int r0 = real ? max(lo, min(hi, __float2int_rn(c))) : lo;
        const float x = real ? (float)r0 - c : 0.f;
        const float g0 = real ? expf(-0.5f * x * x) * enve : 0.f;
        if (lane < kTile) {
          float g = g0, q = real ? expf(-x - 0.5f) : 0.f;
          for (int r = r0; r <= hi; ++r) {
            bw[(r - lo) * kBW + e] = g;
            g *= q;
            q *= einv;
          }
        } else {
          float g = g0, q = real ? expf(x - 0.5f) : 0.f;
          for (int r = r0 - 1; r >= lo; --r) {
            g *= q;
            q *= einv;
            bw[(r - lo) * kBW + e] = g;
          }
        }
      }
    }
    __syncwarp();

    const int et = eh * TE;  // this thread's first edge of the tile
    // ---- 1. filter recompute: TE edges x columns h, H+h, 2H+h ----
    float acc[TE][3];
#pragma unroll
    for (int i = 0; i < TE; ++i) acc[i][0] = acc[i][1] = acc[i][2] = 0.f;
    for (int r = lo; r <= hi; ++r) {
      const float* wr = w_s + r * C3 + hh;
      const float w0 = wr[0], w1 = wr[HC], w2 = wr[2 * HC];
      const float* br = bw + (r - lo) * kBW + et;
#pragma unroll
      for (int q = 0; q < TE / 4; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(br + 4 * q);
        const float v[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[4 * q + u][0] = fmaf(v[u], w0, acc[4 * q + u][0]);
          acc[4 * q + u][1] = fmaf(v[u], w1, acc[4 * q + u][1]);
          acc[4 * q + u][2] = fmaf(v[u], w2, acc[4 * q + u][2]);
        }
      }
    }

    // ---- 2. elementwise: dxh / dvec into this warp's own source rows, the tile becomes dfil ----
    // (loads need no guard: a padded edge reads rows 0, an idle lane column 0; the target's cotangents are
    // loaded kAhead edges ahead)
    float qgx[kAhead], qgv[kAhead][3];
#pragma unroll
    for (int i = 0; i < kAhead && i < TE; ++i) {
      const int tr = e_tgt[et + i];
      qgx[i] = __ldg(gdx_b + (size_t)tr * H + hc);
      qgv[i][0] = __ldg(gdv_b + (size_t)tr * F + hc);
      qgv[i][1] = __ldg(gdv_b + (size_t)tr * F + H + hc);
      qgv[i][2] = __ldg(gdv_b + (size_t)tr * F + 2 * H + hc);
    }
#pragma unroll
    for (int i = 0; i < TE; ++i) {
      const int e = et + i;
      const int se = e_src[e];
      const float gx = qgx[i % kAhead], gv0 = qgv[i % kAhead][0], gv1 = qgv[i % kAhead][1];
      const float gv2 = qgv[i % kAhead][2];
      if (i + kAhead < TE) {
        const int tr = e_tgt[e + kAhead];
        qgx[i % kAhead] = __ldg(gdx_b + (size_t)tr * H + hc);
        qgv[i % kAhead][0] = __ldg(gdv_b + (size_t)tr * F + hc);
        qgv[i % kAhead][1] = __ldg(gdv_b + (size_t)tr * F + H + hc);
        qgv[i % kAhead][2] = __ldg(gdv_b + (size_t)tr * F + 2 * H + hc);
      }
      const size_t row = (size_t)se * F;
      float xg0, xg1, xg2, vg0, vg1, vg2;
      if (STAGE) {
        const float* xr = x_s + se * C3 + hh;
        const float* vr = v_s + se * C3 + hh;
        xg0 = xr[0], xg1 = xr[HC], xg2 = xr[2 * HC];
        vg0 = vr[0], vg1 = vr[HC], vg2 = vr[2 * HC];
      } else {
        xg0 = dtype::ldg(xh_b + row + hc), xg1 = dtype::ldg(xh_b + row + H + hc);
        xg2 = dtype::ldg(xh_b + row + 2 * H + hc);
        vg0 = dtype::ldg(vec_b + row + hc), vg1 = dtype::ldg(vec_b + row + H + hc);
        vg2 = dtype::ldg(vec_b + row + 2 * H + hc);
      }
      const float f0 = acc[i][0] + b0, f1 = acc[i][1] + b1, f2 = acc[i][2] + b2;
      const float ghat1 = (vg0 * gv0 + vg1 * gv1 + vg2 * gv2) * inv_sqrt3;
      const float ghat2 = e_unit[3 * e] * gv0 + e_unit[3 * e + 1] * gv1 + e_unit[3 * e + 2] * gv2;
      const bool live = e < L && h_ok;
      if (GLOBAL) {  // fire-and-forget reductions into zeroed outputs
        if (live) {
          atomicAdd(dxh_b + row + h, gx * f0);
          atomicAdd(dxh_b + row + H + h, ghat1 * f1);
          atomicAdd(dxh_b + row + 2 * H + h, ghat2 * f2);
          const float g2 = xg1 * f1 * inv_sqrt3;
          atomicAdd(dvec_b + row + h, g2 * gv0);
          atomicAdd(dvec_b + row + H + h, g2 * gv1);
          atomicAdd(dvec_b + row + 2 * H + h, g2 * gv2);
        }
      } else {
        // the source is this warp's alone; lanes that share a column (EL > 1) take turns
#pragma unroll
        for (int k = 0; k < EL; ++k) {
          if (live && eh == k) {
            float* ax = acc_x + se * C3 + hh;
            float* av = acc_v + se * C3 + hh;
            ax[0] += gx * f0;
            ax[HC] += ghat1 * f1;
            ax[2 * HC] += ghat2 * f2;
            av[0] += f1 * gv0;
            av[HC] += f1 * gv1;
            av[2 * HC] += f1 * gv2;
          }
          if (EL > 1) __syncwarp();
        }
      }
      acc[i][0] = live ? gx * xg0 : 0.f;
      acc[i][1] = live ? ghat1 * xg1 : 0.f;
      acc[i][2] = live ? ghat2 * xg2 : 0.f;
      db0 += acc[i][0];
      db1 += acc[i][1];
      db2 += acc[i][2];
    }

    // ---- 3. dW rows [lo, hi] += basis^T dfil over the tile, one reduction a row into L2 ----
    for (int r = lo; r <= hi; ++r) {
      const float* br = bw + (r - lo) * kBW + et;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < TE / 4; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(br + 4 * q);
        const float v[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s0 = fmaf(v[u], acc[4 * q + u][0], s0);
          s1 = fmaf(v[u], acc[4 * q + u][1], s1);
          s2 = fmaf(v[u], acc[4 * q + u][2], s2);
        }
      }
#pragma unroll
      for (int o = HC; o < 32; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (eh == 0 && h_ok) {
        float* dr = a.dw + r * F + h;
        atomicAdd(dr, s0);
        atomicAdd(dr + H, s1);
        atomicAdd(dr + 2 * H, s2);
      }
    }
    __syncwarp();  // the next tile overwrites this warp's buffer
    ptr += L;
  }
  __syncthreads();

  // ---- db: over the lanes of a column, then the block, then one atomic a column ----
#pragma unroll
  for (int o = HC; o < 32; o <<= 1) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, o);
    db1 += __shfl_xor_sync(0xffffffffu, db1, o);
    db2 += __shfl_xor_sync(0xffffffffu, db2, o);
  }
  float* db_s = reinterpret_cast<float*>(smem4);  // [3][HC], free after the streams
  if (tid < C3) db_s[tid] = 0.f;
  __syncthreads();
  if (eh == 0 && h_ok) {
    atomicAdd(db_s + hh, db0);
    atomicAdd(db_s + HC + hh, db1);
    atomicAdd(db_s + 2 * HC + hh, db2);
  }
  __syncthreads();
  if (tid < C3) {
    const int j = tid / HC, c = tid % HC;
    if (h0 + c < H) atomicAdd(a.db + j * H + h0 + c, db_s[tid]);
  }
  // ---- dxh, dvec: every row of the system, written once ----
  if (!GLOBAL) {
    for (int i = tid; i < N * C3; i += kThreads) {
      const int s = i / C3, j = (i - s * C3) / HC, c = i % HC;
      if (h0 + c < H) {
        const size_t row = (size_t)s * F;
        const float x1 = STAGE ? x_s[s * C3 + HC + c] : dtype::ldg(xh_b + row + H + h0 + c);
        dxh_b[row + j * H + h0 + c] = acc_x[i];
        dvec_b[row + j * H + h0 + c] = acc_v[i] * x1 * inv_sqrt3;
      }
    }
  }
}

template <typename TX, typename TV, int HC, bool STAGE, bool GLOBAL>
cudaError_t launch(const Args<TX, TV>& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(painn_bwd_kernel<TX, TV, HC, STAGE, GLOBAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((a.H + HC - 1) / HC), (unsigned)B);
  painn_bwd_kernel<TX, TV, HC, STAGE, GLOBAL><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TV, bool STAGE, bool GLOBAL>
cudaError_t launch_cols(int cols, const Args<TX, TV>& a, int B, size_t smem, cudaStream_t stream) {
  switch (cols) {
    case 32: return launch<TX, TV, 32, STAGE, GLOBAL>(a, B, smem, stream);
    case 16: return launch<TX, TV, 16, STAGE, GLOBAL>(a, B, smem, stream);
    default: return launch<TX, TV, 8, STAGE, GLOBAL>(a, B, smem, stream);
  }
}

template <typename TX, typename TV>
int run(const void* xh, const void* vec, const void* src, const void* dist, const void* mask, const void* unit,
        const void* w, const void* bias, const void* gdx, const void* gdv, void* dxh, void* dvec, void* dw, void* db,
        void* scratch, int B, int N, int K, int R, int H, float inv_cutoff, int envelope_exponent, int cols,
        int stage, int global_scatter, int smem, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || H <= 0) return 0;
  if (R < 2 || R > kMaxR) return (int)cudaErrorInvalidValue;
  if ((cols != 8 && cols != 16 && cols != 32) || (stage && global_scatter) ||
      (size_t)smem != smem_bytes(N, R, cols, stage != 0, global_scatter != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* order = static_cast<int32_t*>(scratch);
  int32_t* starts = order + (size_t)B * N * K;
  painn_bwd_sort_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const int32_t*>(src), static_cast<const float*>(dist), static_cast<const uint8_t*>(mask), N, K,
      R, inv_cutoff, order, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args<TX, TV> a;
  a.xh = static_cast<const TX*>(xh);
  a.vec = static_cast<const TV*>(vec);
  a.dist = static_cast<const float*>(dist);
  a.unit = static_cast<const float*>(unit);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.gdx = static_cast<const float*>(gdx);
  a.gdv = static_cast<const float*>(gdv);
  a.src = static_cast<const int32_t*>(src);
  a.order = order;
  a.starts = starts;
  a.dxh = static_cast<float*>(dxh);
  a.dvec = static_cast<float*>(dvec);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.N = N;
  a.K = K;
  a.R = R;
  a.H = H;
  a.inv_cutoff = inv_cutoff;
  a.p = envelope_exponent;
  const size_t bytes = (size_t)smem;
  if (global_scatter) return (int)launch_cols<TX, TV, false, true>(cols, a, B, bytes, s);
  return (int)(stage ? launch_cols<TX, TV, true, false>(cols, a, B, bytes, s)
                     : launch_cols<TX, TV, false, false>(cols, a, B, bytes, s));
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: xh, vec [B,N,3H]; src [B,N,K] i32; dist [B,N,K] f32;
// mask [B,N,K] bool (1 byte); unit [B,N,K,3] f32; w [R,3H] f32; bias [3H] f32;
// gdx [B,N,H] f32; gdv [B,N,3,H] f32. The entries: painn_message_fused_bwd_f32
// (xh, vec f32), _bf16 (xh, vec bf16) and _bf16_vf32 (xh bf16, vec f32). dw
// [R,3H] and db [3H] f32 must be
// zeroed by the caller: the kernel adds into them. dxh, dvec [B,N,3H] are
// written whole, except with global_scatter, where they must be zeroed too.
// scratch: int32, B N K + 17 B entries. The plan (ops/kernels.py::
// painn_bwd_plan): cols (8, 16 or 32 columns h a block), stage,
// global_scatter and smem_bytes must equal this file's layout, else
// cudaErrorInvalidValue. Needs 2 <= R <= 128. Launches the sort and the main
// kernel on `stream` and returns cudaGetLastError() after them (0 = success).
#define PAINN_BWD_ENTRY(NAME, TX, TV)                                                                              \
  extern "C" int NAME(const void* xh, const void* vec, const void* src, const void* dist, const void* mask,        \
                      const void* unit, const void* w, const void* bias, const void* gdx, const void* gdv,          \
                      void* dxh, void* dvec, void* dw, void* db, void* scratch, int B, int N, int K, int R, int H,  \
                      float inv_cutoff, int envelope_exponent, int cols, int stage, int global_scatter, int smem,   \
                      void* stream) {                                                                              \
    return run<TX, TV>(xh, vec, src, dist, mask, unit, w, bias, gdx, gdv, dxh, dvec, dw, db, scratch, B, N, K, R,  \
                       H, inv_cutoff, envelope_exponent, cols, stage, global_scatter, smem, stream);               \
  }
PAINN_BWD_ENTRY(painn_message_fused_bwd_f32, float, float)
PAINN_BWD_ENTRY(painn_message_fused_bwd_bf16, __nv_bfloat16, __nv_bfloat16)
PAINN_BWD_ENTRY(painn_message_fused_bwd_bf16_vf32, __nv_bfloat16, float)

extern "C" const char* painn_message_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
