// PaiNN message block, fused, for Hopper (sm_90a), in f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _painn_message_fused_kernel (wrapper painn_message_fused). For every target
// atom t = (b, i) and feature column h it computes, over the K neighbour slots:
//
//   basis[k, r] = exp(-(R-1)^2/2 * (d_k - r/(R-1))^2) * env(d_k),  d_k = dist/cutoff
//   f[k, c]     = bias[c] + sum_r basis[k, r] * W[r, c]                  c < 3H
//   g = xh[b, src_k, c] * f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] * g3 + vec[b, src_k, d*H + h] * g2
//
// (before PaiNN's 1/sqrt(H) scale, which the caller applies). A masked slot
// and a source outside [0, N) add nothing, which is what the TPU kernel's
// masked filter and one-hot gather give; an unmasked slot at or past the
// cutoff adds xh * bias (its basis is all zero, its bias is not).
//
// The basis is sparse: basis[k, r] = exp(-(r - c_k)^2 / 2) env(d_k) with
// c_k = d_k (R-1), a unit-width gaussian in r that underflows to exactly 0 in
// f32 once |r - c_k| > 14.4, and is 0 for d_k >= 1. A slot of bin
// b = floor(c_k) reaches rows [b - 14, b + 15] only.
//
// Design (ops/kernels.py::painn_fwd_plan sets the launch; the C function
// refuses a plan whose shared-memory size disagrees with this file's layout):
//   * a block of 16 warps takes `tpb` consecutive targets (of any systems) and
//     32 columns h (each with its H + h and 2H + h). Before its only barrier
//     it copies (cp.async) the W columns [R][3][32] and, where the plan stages
//     them, the xh and vec rows [rows][3][32] of every system its targets lie
//     in, into shared memory; W is then read from shared memory by every
//     target of the block, and the sources' rows are never gathered from L2;
//   * each half-warp ("owner") takes targets owner, owner + 32, ... of the
//     block and walks their slots in groups of 8 consecutive slots; lane l
//     holds the columns h0 + 2l and h0 + 2l + 1;
//   * per group: lanes 0-7 read the slots; the rows the group can reach are
//     the union of its valid slots' windows; the basis of those rows is
//     built in the owner's buffer in passes of up to 48 rows, lane e + 8k
//     walking slot e's column up (k = 0) or down (k = 1) from the row nearest
//     its centre with two multiplies a row (neighbouring rows differ by
//     exp(+-(c - r) - 1/2));
//   * the filter: an 8-slot x 6-column register tile; per row one float2 of
//     W for each H-block and two broadcast float4s of the basis feed 48 FMAs
//     (the last group of K, 4 or 2 slots, runs a 4- or 2-slot tile);
//   * the gather-multiply, the K-reduction and the directional term stay in
//     registers; each output is written once, with a plain store, when the
//     owner's target is done: no atomics and no barrier after the staging.
//   Shared memory at the sampling shape (tpb = 160 targets = 2 systems of
//   N = 80, R = 128), 227,200 B:
//       the owners' basis buffers [32][48 x 8 + 8]       50,176 B
//       the owners' slot records [32][9] float4           4,608 B
//       W columns [R][3][32]                             49,152 B
//       xh and vec rows [rows][3][32] x 2               122,880 B
//       bias columns [3][32]                                384 B
//   Where W does not fit (R > 461) it is read through L1/L2, and where the
//   rows do not fit (at R = 128, more than 166 rows a block) they are too.
//
// What bounds it on the H100: at the sampling shape (B=16, N=80, K=50,
// H=512, R=128; 64,000 valid edges with ~28.8 non-zero rows each) the filter
// product the data needs is 6H flops per non-zero row, ~6.3 GFLOP per launch
// with the rest (~0.094 ms at 67 TFLOP/s f32 on the CUDA cores), while the
// bytes it must move are ~28 MB (8.5 us at 3.35 TB/s). So f32 operations set
// the least time. The filter runs at about the issue rate of its FFMAs,
// over 1.33x the needed products: windows of 8 slots reach that many rows of
// the valid slots on the bench graph (4 slots would reach 1.17x, but then a
// W load feeds half the FMAs, and splitting a group's rows by half-group
// timed slower); the basis walk, the slot reads and the gather-multiply take
// the rest. chip_smoke.py phase 3 prints the time against the bound. Not yet
// used: tensor cores (wgmma) and TMA; the f32 path rules out TF32. With bf16
// xh the wrapper launches csrc/painn_message_fused_bf16.cu instead.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kOwners = 2 * kWarps;                     // half-warps a block, each owning targets
constexpr int kCols = 32;                               // columns h a block; a lane holds two neighbours
constexpr int kGroup = 8;                               // slots a register tile
constexpr int kWin = 48;                                // basis rows a pass
constexpr int kBufStride = kWin * kGroup + 8;           // floats of an owner's buffer (== 8 mod 32: the two
                                                        // owners of a warp read other banks)
constexpr int kMetaStride = 4 * (kGroup + 1);           // floats of an owner's slot records
constexpr int kReachLo = 14, kReachHi = 15;             // a slot of bin b reaches rows [b - 14, b + 15]

// Dynamic shared bytes of a block: the owners' basis buffers and slot records,
// the W columns (stage_w), the xh and vec rows of up to `rows` rows
// (stage_rows), the bias columns.
__host__ __device__ inline size_t smem_bytes(int R, int rows, bool stage_w, bool stage_rows) {
  return sizeof(float) * ((size_t)kOwners * (kBufStride + kMetaStride) + (stage_w ? 3 * (size_t)R * kCols : 0) +
                          (stage_rows ? 6 * (size_t)rows * kCols : 0) + 3 * kCols);
}

// The most rows a block's systems hold: block x takes targets [x tpb, min(T, (x + 1) tpb)), whose systems' rows
// are staged whole. The first N blocks show every offset of a block in its system.
inline int staged_rows(int T, int N, int tpb) {
  const int blocks = (T + tpb - 1) / tpb;
  int most = 0;
  for (int x = 0; x < blocks && x < N; ++x) {
    const int t0 = x * tpb, t1 = t0 + tpb < T ? t0 + tpb : T;
    const int rows = ((t1 - 1) / N + 1) * N - t0 / N * N;
    most = rows > most ? rows : most;
  }
  return most;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

struct Args {
  const float *xh, *w;
  const float* vec;
  const float *dist, *unit, *bias;
  const int32_t* src;
  const uint8_t* mask;
  float *dx, *dvec;
  int B, N, K, R, H, tpb, rows;
  float inv_cutoff;
  int p;
};

// The filter over the basis rows [plo, phi] of the owner's buffer: acc[i][j] += basis[r][i] * W[r][jH + (hA, hB)]
// for the group's first TE slots (TE = 8, 4 or 2); W from shared memory (SW) or through L1/L2.
template <int TE, bool SW>
__device__ __forceinline__ void filter_rows(float2 (&acc)[kGroup][3], const float4* __restrict__ b4,
                                            const float2* __restrict__ w2, const float* __restrict__ w, size_t F,
                                            int H, int cA, int cB, int plo, int phi) {
  constexpr int kUnroll = SW ? 4 : 2;  // deeper unrolling spills where W is read through L1/L2
#pragma unroll kUnroll
  for (int r = plo; r <= phi; ++r) {
    float bv[kGroup];
    const float4 ba = b4[2 * (r - plo)];
    bv[0] = ba.x, bv[1] = ba.y, bv[2] = ba.z, bv[3] = ba.w;
    if (TE > 4) {
      const float4 bb = b4[2 * (r - plo) + 1];
      bv[4] = bb.x, bv[5] = bb.y, bv[6] = bb.z, bv[7] = bb.w;
    }
    float2 w0, w1, w2v;
    if (SW) {
      const float2* wr = w2 + r * (3 * kCols / 2);
      w0 = wr[0];
      w1 = wr[kCols / 2];
      w2v = wr[kCols];
    } else {
      const float* wr = w + (size_t)r * F;
      w0 = make_float2(__ldg(wr + cA), __ldg(wr + cB));
      w1 = make_float2(__ldg(wr + H + cA), __ldg(wr + H + cB));
      w2v = make_float2(__ldg(wr + 2 * H + cA), __ldg(wr + 2 * H + cB));
    }
#pragma unroll
    for (int i = 0; i < TE; ++i) {
      acc[i][0].x = fmaf(bv[i], w0.x, acc[i][0].x);
      acc[i][0].y = fmaf(bv[i], w0.y, acc[i][0].y);
      acc[i][1].x = fmaf(bv[i], w1.x, acc[i][1].x);
      acc[i][1].y = fmaf(bv[i], w1.y, acc[i][1].y);
      acc[i][2].x = fmaf(bv[i], w2v.x, acc[i][2].x);
      acc[i][2].y = fmaf(bv[i], w2v.y, acc[i][2].y);
    }
  }
}

template <bool SW, bool SR>
__global__ void __launch_bounds__(kThreads, 1) painn_fwd_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int half = lane / 16, l = lane % 16;
  const int owner = half * kWarps + warp;  // consecutive targets go to warps on other schedulers first
  const unsigned omask = 0xffffu << (16 * half);
  const int obase = 16 * half;  // the owner's first lane
  float* buf = smem + owner * kBufStride;
  float4* meta = reinterpret_cast<float4*>(smem + kOwners * kBufStride + owner * kMetaStride);
  float* w_s = smem + kOwners * (kBufStride + kMetaStride);  // [R][3][32]
  float* x_s = w_s + (SW ? 3 * a.R * kCols : 0);              // [rows][3][32]
  float* v_s = x_s + (SR ? 3 * a.rows * kCols : 0);           // [rows][3][32]
  float* bias_s = v_s + (SR ? 3 * a.rows * kCols : 0);        // [3][32]

  const int H = a.H, N = a.N, K = a.K, R = a.R;
  const size_t F = 3 * (size_t)H;
  const int T = a.B * N;
  const int t0 = blockIdx.x * a.tpb;
  const int t1 = min(T, t0 + a.tpb);
  const int h0 = blockIdx.y * kCols;
  const int row0 = t0 / N * N;  // the first staged row: the block's first system
  const int nrows = ((t1 - 1) / N + 1) * N - row0;

  // ---- the block's W and bias columns and its systems' xh/vec rows (zero past H); the only barrier ----
  for (int i = tid; i < 3 * kCols; i += kThreads) {
    const int c = h0 + i % kCols;
    bias_s[i] = c < H ? __ldg(a.bias + (i / kCols) * H + c) : 0.f;
  }
  if (SW) {
    for (int i = tid; i < 3 * R * kCols; i += kThreads) {
      const int r = i / (3 * kCols), j = i / kCols % 3, c = h0 + i % kCols;
      cp_async4(w_s + i, a.w + (size_t)r * F + j * H + (c < H ? c : 0), c < H);
    }
  }
  if (SR) {
    for (int i = tid; i < 3 * nrows * kCols; i += kThreads) {
      const int s = i / (3 * kCols), j = i / kCols % 3, c = h0 + i % kCols;
      const size_t g = (size_t)(row0 + s) * F + j * H + (c < H ? c : 0);
      cp_async4(x_s + i, a.xh + g, c < H);
      cp_async4(v_s + i, a.vec + g, c < H);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // ---- this owner's targets, a group of 8 slots at a time ----
  const int hA = h0 + 2 * l, hB = hA + 1;
  const int cA = min(hA, H - 1), cB = min(hB, H - 1);  // clamped columns for loads of idle lanes
  const int ngroups = (K + kGroup - 1) / kGroup;
  const int mine = owner < t1 - t0 ? (t1 - t0 - owner + kOwners - 1) / kOwners : 0;
  const int nwork = mine * ngroups;
  const float pf = (float)a.p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  const float rm1 = (float)(R - 1);
  const float einv = 0.36787944117144233f;  // e^-1
  const float inv_sqrt3 = 0.57735026918962576f;
  const float2* w2 = reinterpret_cast<const float2*>(w_s) + l;
  const float4* b4 = reinterpret_cast<const float4*>(buf);

  float2 ox = make_float2(0.f, 0.f), ov0 = ox, ov1 = ox, ov2 = ox;  // the target's outputs at hA, hB
  for (int wi = 0; wi < nwork; ++wi) {
    const int tt = wi / ngroups, grp = wi - tt * ngroups;
    const int t = t0 + owner + tt * kOwners;
    const int b = t / N;
    // lanes 0-7 read slot grp * 8 + l of target t
    const int k = grp * kGroup + l;
    const size_t ek = (size_t)t * K + k;
    int s = -1;
    float d = 2.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
    if (l < kGroup && k < K && a.mask[ek]) {
      s = a.src[ek];
      d = __ldg(a.dist + ek) * a.inv_cutoff;
      u0 = __ldg(a.unit + 3 * ek);
      u1 = __ldg(a.unit + 3 * ek + 1);
      u2 = __ldg(a.unit + 3 * ek + 2);
    }
    const bool valid = s >= 0 && s < N;
    if (!valid) d = 2.f;

    // slot records: unit vector and row (-1: adds nothing); envelope and reach
    const bool reach = d < 1.f;  // a valid slot with a non-zero basis
    float env = 0.f;
    if (reach) {
      float dp = 1.f;
      for (int j = 0; j < a.p; ++j) dp *= d;
      env = 1.f + ca * dp + cb * dp * d + cc * dp * d * d;
    }
    const int bin = reach ? min((int)(d * rm1), R - 1) : 0;
    if (l < kGroup) {
      const int row = valid ? b * N + s - (SR ? row0 : 0) : -1;
      meta[l] = make_float4(u0, u1, u2, __int_as_float(row));
    }
    const int lo = __reduce_min_sync(omask, reach ? max(0, bin - kReachLo) : R);
    const int hi = __reduce_max_sync(omask, reach ? min(R - 1, bin + kReachHi) : -1);
    const int e = l % kGroup;
    const bool up = l < kGroup;
    const float de = __shfl_sync(omask, d, obase + e);
    const float enve = __shfl_sync(omask, env, obase + e);

    const int nslots = min(kGroup, K - grp * kGroup);  // both owners of a warp at one group: no divergence
    float2 acc[kGroup][3];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) acc[i][0] = acc[i][1] = acc[i][2] = make_float2(0.f, 0.f);
    for (int plo = lo; plo <= hi; plo += kWin) {
      const int phi = min(hi, plo + kWin - 1);
      // basis rows [plo, phi] of slot e: from r0, the row nearest the centre within the pass, up or down
      const bool real = enve != 0.f;
      const float c = de * rm1;
      const int r0 = real ? max(plo, min(phi, __float2int_rn(c))) : plo;
      const float x = real ? (float)r0 - c : 0.f;
      float g = real ? expf(-0.5f * x * x) * enve : 0.f;
      float q = real ? expf((up ? -x : x) - 0.5f) : 0.f;
      int r = r0;
      int n = phi - r0 + 1;
      if (!up) {
        g *= q;
        q *= einv;
        r = r0 - 1;
        n = r0 - plo;
      }
      const int step = up ? kGroup : -kGroup;
      float* dst = buf + (r - plo) * kGroup + e;
      for (int i = 0; i < n; ++i) {
        *dst = g;
        g *= q;
        q *= einv;
        dst += step;
      }
      __syncwarp(omask);
      // ---- the filter; a group of 4 or fewer slots (the tail of K) runs a narrower tile ----
      if (nslots > 4) {
        filter_rows<8, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
      } else if (nslots > 2) {
        filter_rows<4, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
      } else {
        filter_rows<2, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
      }
      __syncwarp(omask);  // the next pass overwrites the buffer
    }
    __syncwarp(omask);  // the slot records are written

    // ---- gather-multiply, K-reduction and directional term, in registers ----
    const float2* bias2 = reinterpret_cast<const float2*>(bias_s) + l;
    const float2 b0 = bias2[0], b1 = bias2[kCols / 2], b2 = bias2[kCols];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const float4 m = meta[i];
      const int row = __float_as_int(m.w);
      if (row >= 0) {
        float2 x0, x1, x2, v0, v1, v2;
        if (SR) {
          const float2* xr = reinterpret_cast<const float2*>(x_s + row * 3 * kCols) + l;
          const float2* vr = reinterpret_cast<const float2*>(v_s + row * 3 * kCols) + l;
          x0 = xr[0], x1 = xr[kCols / 2], x2 = xr[kCols];
          v0 = vr[0], v1 = vr[kCols / 2], v2 = vr[kCols];
        } else {
          const float* xr = a.xh + (size_t)row * F;
          const float* vr = a.vec + (size_t)row * F;
          x0 = make_float2(__ldg(xr + cA), __ldg(xr + cB));
          x1 = make_float2(__ldg(xr + H + cA), __ldg(xr + H + cB));
          x2 = make_float2(__ldg(xr + 2 * H + cA), __ldg(xr + 2 * H + cB));
          v0 = make_float2(__ldg(vr + cA), __ldg(vr + cB));
          v1 = make_float2(__ldg(vr + H + cA), __ldg(vr + H + cB));
          v2 = make_float2(__ldg(vr + 2 * H + cA), __ldg(vr + 2 * H + cB));
        }
        const float g1x = x0.x * (acc[i][0].x + b0.x), g1y = x0.y * (acc[i][0].y + b0.y);
        const float g2x = x1.x * (acc[i][1].x + b1.x) * inv_sqrt3, g2y = x1.y * (acc[i][1].y + b1.y) * inv_sqrt3;
        const float g3x = x2.x * (acc[i][2].x + b2.x), g3y = x2.y * (acc[i][2].y + b2.y);
        ox.x += g1x;
        ox.y += g1y;
        ov0.x += m.x * g3x + v0.x * g2x;
        ov0.y += m.x * g3y + v0.y * g2y;
        ov1.x += m.y * g3x + v1.x * g2x;
        ov1.y += m.y * g3y + v1.y * g2y;
        ov2.x += m.z * g3x + v2.x * g2x;
        ov2.y += m.z * g3y + v2.y * g2y;
      }
    }
    if (grp == ngroups - 1) {  // the target is done: its outputs, once
      float* dxr = a.dx + (size_t)t * H;
      float* dvr = a.dvec + (size_t)t * F;
      if (hA < H) {
        dxr[hA] = ox.x;
        dvr[hA] = ov0.x;
        dvr[H + hA] = ov1.x;
        dvr[2 * H + hA] = ov2.x;
      }
      if (hB < H) {
        dxr[hB] = ox.y;
        dvr[hB] = ov0.y;
        dvr[H + hB] = ov1.y;
        dvr[2 * H + hB] = ov2.y;
      }
      ox = ov0 = ov1 = ov2 = make_float2(0.f, 0.f);
    }
    __syncwarp(omask);  // the next group overwrites the slot records
  }
}

template <bool SW, bool SR>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(painn_fwd_kernel<SW, SR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int T = a.B * a.N;
  const dim3 grid((unsigned)((T + a.tpb - 1) / a.tpb), (unsigned)((a.H + kCols - 1) / kCols));
  painn_fwd_kernel<SW, SR><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(const void* xh, const void* vec, const void* src, const void* dist, const void* mask, const void* unit,
        const void* w, const void* bias, void* dx, void* dvec, int B, int N, int K, int R, int H, float inv_cutoff,
        int envelope_exponent, int tpb, int stage_w, int stage_rows, int rows, int smem, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0) return 0;
  if (K < 1 || R < 2 || tpb < 1 || rows < 0 || (H + kCols - 1) / kCols > 65535) return (int)cudaErrorInvalidValue;
  if ((size_t)smem != smem_bytes(R, rows, stage_w != 0, stage_rows != 0) ||
      (stage_rows && rows < staged_rows(B * N, N, tpb))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.xh = static_cast<const float*>(xh);
  a.vec = static_cast<const float*>(vec);
  a.dist = static_cast<const float*>(dist);
  a.unit = static_cast<const float*>(unit);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.src = static_cast<const int32_t*>(src);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dx = static_cast<float*>(dx);
  a.dvec = static_cast<float*>(dvec);
  a.B = B;
  a.N = N;
  a.K = K;
  a.R = R;
  a.H = H;
  a.tpb = tpb;
  a.rows = rows;
  a.inv_cutoff = inv_cutoff;
  a.p = envelope_exponent;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem;
  if (stage_w) {
    return (int)(stage_rows ? launch<true, true>(a, bytes, s) : launch<true, false>(a, bytes, s));
  }
  return (int)(stage_rows ? launch<false, true>(a, bytes, s) : launch<false, false>(a, bytes, s));
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: xh, vec [B,N,3H] f32; src [B,N,K] i32; dist [B,N,K] f32;
// mask [B,N,K] bool (1 byte); unit [B,N,K,3] f32; w [R,3H] f32; bias [3H] f32;
// dx [B,N,H] f32 and dvec [B,N,3,H] f32 are written whole. The plan
// (ops/kernels.py::painn_fwd_plan): tpb targets a block, stage_w, stage_rows,
// rows (the most staged rows a block holds, at least what its systems need)
// and smem_bytes must agree with this file's layout, else
// cudaErrorInvalidValue. Needs K >= 1 and R >= 2. Launches on `stream` and
// returns cudaGetLastError() after the launch (0 = success).
extern "C" int painn_message_fused_f32(const void* xh, const void* vec, const void* src, const void* dist,
                                       const void* mask, const void* unit, const void* w, const void* bias, void* dx,
                                       void* dvec, int B, int N, int K, int R, int H, float inv_cutoff,
                                       int envelope_exponent, int tpb, int stage_w, int stage_rows, int rows, int smem,
                                       void* stream) {
  return run(xh, vec, src, dist, mask, unit, w, bias, dx, dvec, B, N, K, R, H, inv_cutoff, envelope_exponent, tpb,
             stage_w, stage_rows, rows, smem, stream);
}

extern "C" const char* painn_message_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
