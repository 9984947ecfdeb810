// PaiNN message on features gathered beforehand, for Hopper (sm_90a), f32.
//
// Replaces two TPU kernels of adsorbdiff_tpu/ops/pallas_kernels.py:
// _painn_message_kernel (wrapper painn_message_consumer, one target per
// program) and _painn_message_tiled_kernel (wrapper
// painn_message_consumer_tiled, TI targets per program). One kernel serves
// both: their function is the same, and the launch comes from the plan, not
// from TI. For every target m and feature column h it computes, over the K
// neighbour slots of m:
//
//   basis[k, r] = exp(-(R-1)^2/2 * (d_k - r/(R-1))^2) * env(d_k),  d_k = dist/cutoff
//   f[k, c]     = mask_k * (bias[c] + sum_r basis[k, r] * W[r, c])      c < 3H
//   g = xh[m, k, c] * f[k, c];  g1 | g2/sqrt(3) | g3 = g split in three H-blocks
//   dx[h]      = sum_k g1
//   dvec[d][h] = sum_k unit[k, d] * g3 + vec[m, k, d*H + h] * g2
//
// which is csrc/painn_message_fused.cu's function with the gather done by
// the caller: slot k's features are row m K + k of the gathered tensors. A
// masked slot adds nothing (its rows are not read); an unmasked slot at or
// past the cutoff adds xh * bias (its basis is all zero, its bias is not); a
// target whose slots are all masked gives 0.
//
// The basis is sparse: basis[k, r] = exp(-(r - c_k)^2 / 2) env(d_k) with
// c_k = d_k (R-1), a unit-width gaussian in r that underflows to 0 in f32
// once |r - c_k| > 14.4, and is 0 for d_k >= 1. A slot of bin b = floor(c_k)
// reaches rows [b - 14, b + 15] only.
//
// What bounds it on the H100: it must read the two gathered [M, K, 3H]
// tensors once (786 MB of the 798.8 MB it moves at M=1280, K=50, H=512:
// 0.2384 ms at 3.35 TB/s), above the 6.33 GFLOP the filter needs on the
// non-zero rows (0.0945 ms). So device memory has to stream without a pause
// while the filter's FMAs run underneath, and the FMAs, with the
// shared-memory loads that feed them, must issue fast enough to stay under
// the bytes.
//
// Design (ops/kernels.py::consumer_plan sets the launch; the C function
// refuses a plan whose shared-memory size disagrees with this file's layout):
//   * one block of 8 warps an SM. Block b owns the 64 columns h0 = 64 (b % S)
//     .. h0 + 63 (with H + h and 2H + h) of the S = ceil(H / 64) slices and
//     the targets of chunk b / S of the plan's C equal chunks. The S blocks
//     of a chunk run side by side and walk the same targets in the same
//     order, so dist, mask and unit come from device memory about once and
//     from L2 for the other slices. Before its only barrier a block copies
//     (cp.async) W's columns [R][3][64] and the bias into shared memory
//     (W's slice is read through L1/L2 where it does not fit, R > 215);
//   * each warp ("owner") takes the targets o, o + 8, .. of its chunk, in
//     batches of at most 4 targets and 256 slots (one target split in runs
//     of 256 slots where K > 256). It sorts a batch's unmasked slots by
//     basis bin in shared memory (a stable counting sort: int shared atomics
//     for the counts, one scan, __match_any_sync ranks), keeping each slot's
//     distance there, and walks them in groups of 8 sorted slots of any of
//     its targets: 1.14x the needed products on the bench graph, where 8
//     consecutive slots of one target run 1.33x (10 targets a batch run
//     1.08x, but their sums leave too little of the SM's memory to L1, and
//     time slower). Lane l holds the columns h0 + 2l and h0 + 2l + 1;
//   * a group first issues the loads of its slots' rows (8 slots x 2 tensors
//     x 3 H-blocks, a float2 a lane: 256-byte segments, 12 KB a group,
//     streaming loads into registers), then builds its basis and runs its
//     filter, and reads the rows only when the filter is done: every owner
//     keeps its 12 KB in flight while its FMAs run (96 KB an SM, where
//     ~20 KB cover the latency at full rate);
//   * the rows the group can reach are the union of its slots' windows. Lane
//     l computes basis[r][l % 8] for rows plo + l / 8, + 4, .. directly (one
//     ex2 each) into the owner's buffer, in passes of up to 48 rows; the
//     filter is an 8-slot x 6-column register tile, per row two broadcast
//     float4s of the basis (one address for the whole warp) and one float2 of
//     W for each H-block feeding 48 FMAs (the last group of a batch, 4 or 2
//     slots, runs a 4- or 2-slot tile);
//   * the gather-multiply and the directional term stay in registers; each
//     slot's terms go to its target's sums in shared memory, which only the
//     lane that owns the columns touches (no atomics, no barrier), in sorted
//     order, so the sums are the same bits on every run. A batch's outputs
//     are written once, with plain stores, when its last group is done.
//   Shared memory at M=1280, K=50, R=128, H=512 (8 slices x 16 chunks = 128
//   blocks of 256 threads, 80 targets a block, batches of 4, 4 and 2 a
//   warp), 165,248 B (the 164 KB carveout, 92 KB of L1 beside it):
//       the owners' basis buffers [8][48 x 8 + 16]       12,800 B
//       the owners' sums [8][4][4][64]                   32,768 B
//       W columns [R][3][64]                             98,304 B
//       bias columns [3][64]                                768 B
//       the owners' sort counts [8][132] int              4,224 B
//       the owners' slot distances [8][256] f32           8,192 B
//       the owners' sorted slots and keys [8][2][256] u16  8,192 B
//   The rows of a group live in registers (96 floats a lane), not in shared
//   memory: one block of 8 warps an SM is what the 65,536 registers allow.
//
// scripts/variants_painn_message_consumer.py undoes these design choices one
// at a time, each by a text substitution in this file.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                       // warps a block, each an owner of targets
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 64;                       // columns h a block; a lane holds two neighbours
constexpr int kGroup = 8;                       // slots a register tile
constexpr int kWin = 48;                        // basis rows a pass
constexpr int kBufStride = kWin * kGroup + 16;  // floats of an owner's basis buffer
constexpr int kBatch = 4;                       // targets an owner sums at a time
constexpr int kSlotCap = 256;                   // slots an owner sorts at a time
constexpr int kKeys = 128;                      // sort keys: bin * 128 / R with a basis, 128 without
constexpr int kCountStride = kKeys + 4;         // ints of an owner's counts
constexpr int kReachLo = 14, kReachHi = 15;     // a slot of bin b reaches rows [b - 14, b + 15]
constexpr int kUnrollSW = 4;                    // filter row loop unrolling with W staged

// Dynamic shared bytes of a block: the owners' basis buffers and sums, the W columns (stage_w), the bias columns, the
// owners' sort counts, slot distances, sorted slots and keys.
__host__ __device__ inline size_t smem_bytes(int R, bool stage_w) {
  return sizeof(float) * ((size_t)kWarps * (kBufStride + kBatch * 4 * kCols) +
                          (stage_w ? 3 * (size_t)R * kCols : 0) + 3 * kCols) +
         sizeof(int) * kWarps * kCountStride + sizeof(float) * kWarps * kSlotCap +
         sizeof(uint16_t) * kWarps * 2 * kSlotCap;
}

// The gathered rows are read once: streaming loads (evict first) keep W, dist and unit in L2.
__device__ __forceinline__ float2 ld_rows(const float* p) { return __ldcs(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float ld_row(const float* p) { return __ldcs(p); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

struct Args {
  const float *dist, *unit, *xh, *vec, *w, *bias;
  const uint8_t* mask;
  float *dx, *dvec;
  int M, K, R, H, chunks, slices;
  float inv_cutoff;
  int p;
};

// The filter over the basis rows [plo, phi] of the owner's buffer: acc[i][j] += basis[r][i] * W[r][jH + (hA, hB)]
// for the group's first TE slots (TE = 8, 4 or 2); W from shared memory (SW) or through L1/L2.
template <int TE, bool SW>
__device__ __forceinline__ void filter_rows(float2 (&acc)[kGroup][3], const float4* __restrict__ b4,
                                            const float2* __restrict__ w2, const float* __restrict__ w, size_t F,
                                            int H, int cA, int cB, int plo, int phi) {
  constexpr int kUnroll = SW ? kUnrollSW : 2;
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

// The rows of the group's slots (slot i: row shfl(row, i), present where bit i of vm is set) at the lane's columns:
// x[i][j] = xh[row][jH + (hA, hB)], v likewise; zero for an absent slot or a column past H. V2: H even, float2 loads.
template <bool V2>
__device__ __forceinline__ void load_rows(float2 (&x)[kGroup][3], float2 (&v)[kGroup][3], const Args& a, int row,
                                          unsigned vm, int hA, size_t F) {
  const int H = a.H;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    const size_t ri = (size_t)__shfl_sync(0xffffffffu, row, i);
    const bool okA = (vm >> i & 1u) && hA < H;
    const bool okB = (vm >> i & 1u) && hA + 1 < H;
    const float* xp = a.xh + ri * F + hA;
    const float* vp = a.vec + ri * F + hA;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (V2) {
        x[i][j] = okA ? ld_rows(xp + j * H) : make_float2(0.f, 0.f);
        v[i][j] = okA ? ld_rows(vp + j * H) : make_float2(0.f, 0.f);
      } else {
        x[i][j] = make_float2(okA ? ld_row(xp + j * H) : 0.f, okB ? ld_row(xp + j * H + 1) : 0.f);
        v[i][j] = make_float2(okA ? ld_row(vp + j * H) : 0.f, okB ? ld_row(vp + j * H + 1) : 0.f);
      }
    }
  }
}

template <bool SW, bool V2>
__global__ void __launch_bounds__(kThreads, 1) consumer_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, l = tid % 32, owner = tid / 32;
  float* buf = smem + owner * kBufStride;
  float* sums = smem + kWarps * kBufStride + owner * kBatch * 4 * kCols + 2 * l;  // [target][4][kCols], the lane's
  float* w_s = smem + kWarps * (kBufStride + kBatch * 4 * kCols);                 // [R][3][kCols]
  float* bias_s = w_s + (SW ? 3 * a.R * kCols : 0);                               // [3][kCols]
  int* counts_all = reinterpret_cast<int*>(bias_s + 3 * kCols);                         // [owner][kCountStride]
  float* dsc_all = reinterpret_cast<float*>(counts_all + kWarps * kCountStride);         // [owner][kSlotCap]
  uint16_t* slots_all = reinterpret_cast<uint16_t*>(dsc_all + kWarps * kSlotCap);        // [owner][2][kSlotCap]
  int* counts = counts_all + owner * kCountStride;  // the sort's counts, then its next places
  float* dsc = dsc_all + owner * kSlotCap;          // slot i's distance / cutoff
  uint16_t* order = slots_all + owner * 2 * kSlotCap;  // the run's slots in sorted order
  uint16_t* keys = order + kSlotCap;                   // slot i's key + 1 (0: masked) | its target in the batch << 8

  const int H = a.H, K = a.K, R = a.R;
  const size_t F = 3 * (size_t)H;
  const int slice = blockIdx.x % a.slices, chunk = blockIdx.x / a.slices;
  const int h0 = slice * kCols;
  const int t0 = (int)((long long)chunk * a.M / a.chunks);
  const int t1 = (int)((long long)(chunk + 1) * a.M / a.chunks);

  // ---- the block's W and bias columns (zero past H); the only barrier ----
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
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int hA = h0 + 2 * l, hB = hA + 1;
  const int cA = min(hA, H - 1), cB = min(hB, H - 1);  // clamped columns for W loads of idle lanes
  const float pf = (float)a.p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  const float rm1 = (float)(R - 1);
  const float inv_sqrt3 = 0.57735026918962576f;
  const float2* w2 = reinterpret_cast<const float2*>(w_s) + l;
  const float4* b4 = reinterpret_cast<const float4*>(buf);
  const float2* bias2 = reinterpret_cast<const float2*>(bias_s) + l;
  const float2 b0 = bias2[0], b1 = bias2[kCols / 2], b2 = bias2[kCols];
  const int e = l % kGroup;  // the basis column (slot) a lane builds

  // ---- this owner's targets t0 + owner + 8 i, i < mine, in batches of bsize ----
  const int mine = owner < t1 - t0 ? (t1 - t0 - owner + kWarps - 1) / kWarps : 0;
  const int per_batch = max(1, min(kBatch, kSlotCap / K));
  const int nbatches = (mine + per_batch - 1) / per_batch;
  const int bsize = nbatches > 0 ? (mine + nbatches - 1) / nbatches : 1;
  for (int i0 = 0; i0 < mine; i0 += bsize) {
    const int nt = min(bsize, mine - i0);  // the batch's targets: tb + 8 j, j < nt
    const int tb = t0 + owner + kWarps * i0;
    for (int j = 0; j < nt; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) *reinterpret_cast<float2*>(sums + (j * 4 + q) * kCols) = make_float2(0.f, 0.f);
    }
    for (int s0 = 0; s0 < nt * K; s0 += kSlotCap) {
      const int n = min(kSlotCap, nt * K - s0);
      // -- stable counting sort of the run's unmasked slots by key; slot s0 + i of the batch is slot (s0 + i) % K
      // of target tb + 8 j, j = (s0 + i) / K --
      for (int i = l; i < kKeys + 1; i += 32) counts[i] = 0;
      __syncwarp();
      for (int i = l; i < n; i += 32) {
        const int j = (s0 + i) / K;
        const int row = (tb + kWarps * j) * K + (s0 + i - j * K);
        const float d = __ldg(a.dist + row) * a.inv_cutoff;
        const int key = __ldg(a.mask + row) == 0 ? -1 : d < 1.f ? min((int)(d * rm1), R - 1) * kKeys / R : kKeys;
        keys[i] = (uint16_t)((key + 1) | j << 8);
        dsc[i] = d;
        if (key >= 0) atomicAdd(counts + key, 1);
      }
      __syncwarp();
      int total = 0;
      for (int base = 0; base < kKeys + 1; base += 32) {  // exclusive scan of the counts
        const int i = base + l;
        const int c = i < kKeys + 1 ? counts[i] : 0;
        int x = c;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (l >= off) x += y;
        }
        if (i < kKeys + 1) counts[i] = total + x - c;
        total += __shfl_sync(0xffffffffu, x, 31);
      }
      __syncwarp();
      for (int base = 0; base < n; base += 32) {  // in slot order: lanes of one key take consecutive places
        const int i = base + l;
        const int key = i < n ? (keys[i] & 0xff) - 1 : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key >= 0) order[counts[key] + __popc(peers & ((1u << l) - 1))] = (uint16_t)i;
        __syncwarp();
        if (key >= 0 && l == __ffs(peers) - 1) counts[key] += __popc(peers);
        __syncwarp();
      }

      // -- groups of 8 sorted slots --
      for (int g0 = 0; g0 < total; g0 += kGroup) {
        // lanes 0-7 read slot g0 + l of the sorted run: its row, target in the batch, distance and unit vector
        int row = 0, tl = 0;
        float d = 2.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
        const bool present = l < kGroup && g0 + l < total;
        if (present) {
          const int i = order[g0 + l];
          tl = keys[i] >> 8;
          row = (tb + kWarps * tl) * K + (s0 + i - tl * K);
          d = dsc[i];
          u0 = __ldg(a.unit + 3 * (size_t)row);
          u1 = __ldg(a.unit + 3 * (size_t)row + 1);
          u2 = __ldg(a.unit + 3 * (size_t)row + 2);
        }
        const unsigned vm = __ballot_sync(0xffffffffu, present) & 0xffu;
        float2 xr[kGroup][3], vr[kGroup][3];
        load_rows<V2>(xr, vr, a, row, vm, hA, F);  // in flight while the basis and the filter run

        // envelope, bin and reach of the lane's slot; the group's window [lo, hi]
        const bool reach = d < 1.f;  // a present slot with a non-zero basis
        float env = 0.f;
        if (reach) {
          float dp = 1.f;
          for (int j = 0; j < a.p; ++j) dp *= d;
          env = 1.f + ca * dp + cb * dp * d + cc * dp * d * d;
        }
        const int bin = reach ? min((int)(d * rm1), R - 1) : 0;
        const int lo = __reduce_min_sync(0xffffffffu, reach ? max(0, bin - kReachLo) : R);
        const int hi = __reduce_max_sync(0xffffffffu, reach ? min(R - 1, bin + kReachHi) : -1);
        const float ce = __shfl_sync(0xffffffffu, d, e) * rm1;  // slot e's centre row
        const float enve = __shfl_sync(0xffffffffu, env, e);

        const int nslots = min(kGroup, total - g0);
        float2 acc[kGroup][3];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) acc[i][0] = acc[i][1] = acc[i][2] = make_float2(0.f, 0.f);
        for (int plo = lo; plo <= hi; plo += kWin) {
          const int phi = min(hi, plo + kWin - 1);
          // basis rows [plo, phi]: lane l builds slot e's rows plo + l / 8, + 4, ..
          for (int r = plo + l / kGroup; r <= phi; r += 32 / kGroup) {
            const float x = (float)r - ce;
            buf[(r - plo) * kGroup + e] = enve != 0.f ? __expf(-0.5f * x * x) * enve : 0.f;
          }
          __syncwarp();
          // ---- the filter; the last group of a run, 4 or fewer slots, runs a narrower tile ----
          if (nslots > 4) {
            filter_rows<8, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
          } else if (nslots > 2) {
            filter_rows<4, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
          } else {
            filter_rows<2, SW>(acc, b4, w2, a.w, F, H, cA, cB, plo, phi);
          }
          __syncwarp();  // the next pass overwrites the buffer
        }

        // ---- gather-multiply and directional term in registers, into the slot's target's sums ----
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float ui0 = __shfl_sync(0xffffffffu, u0, i);
          const float ui1 = __shfl_sync(0xffffffffu, u1, i);
          const float ui2 = __shfl_sync(0xffffffffu, u2, i);
          const int ti = __shfl_sync(0xffffffffu, tl, i);
          if (vm >> i & 1u) {
            const float g1x = xr[i][0].x * (acc[i][0].x + b0.x), g1y = xr[i][0].y * (acc[i][0].y + b0.y);
            const float g2x = xr[i][1].x * (acc[i][1].x + b1.x) * inv_sqrt3;
            const float g2y = xr[i][1].y * (acc[i][1].y + b1.y) * inv_sqrt3;
            const float g3x = xr[i][2].x * (acc[i][2].x + b2.x), g3y = xr[i][2].y * (acc[i][2].y + b2.y);
            float2* o = reinterpret_cast<float2*>(sums + ti * 4 * kCols);
            float2 ox = o[0], ov0 = o[kCols / 2], ov1 = o[kCols], ov2 = o[3 * kCols / 2];
            ox.x += g1x;
            ox.y += g1y;
            ov0.x += ui0 * g3x + vr[i][0].x * g2x;
            ov0.y += ui0 * g3y + vr[i][0].y * g2y;
            ov1.x += ui1 * g3x + vr[i][1].x * g2x;
            ov1.y += ui1 * g3y + vr[i][1].y * g2y;
            ov2.x += ui2 * g3x + vr[i][2].x * g2x;
            ov2.y += ui2 * g3y + vr[i][2].y * g2y;
            o[0] = ox, o[kCols / 2] = ov0, o[kCols] = ov1, o[3 * kCols / 2] = ov2;
          }
        }
      }
      __syncwarp();  // the next run rewrites the counts and the order
    }

    // ---- the batch's outputs, once ----
    for (int j = 0; j < nt; ++j) {
      const int t = tb + kWarps * j;
      const float2* o = reinterpret_cast<const float2*>(sums + j * 4 * kCols);
      const float2 ox = o[0], ov0 = o[kCols / 2], ov1 = o[kCols], ov2 = o[3 * kCols / 2];
      float* dxr = a.dx + (size_t)t * H;
      float* dvr = a.dvec + (size_t)t * F;
      if (V2) {
        if (hA < H) {
          *reinterpret_cast<float2*>(dxr + hA) = ox;
          *reinterpret_cast<float2*>(dvr + hA) = ov0;
          *reinterpret_cast<float2*>(dvr + H + hA) = ov1;
          *reinterpret_cast<float2*>(dvr + 2 * H + hA) = ov2;
        }
      } else {
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
      }
    }
  }
}

template <bool SW, bool V2>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(consumer_kernel<SW, V2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  consumer_kernel<SW, V2><<<(unsigned)(a.chunks * a.slices), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: dist [M,K] f32; mask [M,K] bool (1 byte); unit [M,K,3]
// f32; xh, vec [M,K,3H] f32 (vec's 3H is (3, H) flattened); w [R,3H] f32;
// bias [3H] f32; dx [M,H] f32 and dvec [M,3,H] f32 are written whole. The
// plan (ops/kernels.py::consumer_plan): `chunks` target chunks (1 <= chunks
// <= M) x ceil(H / 64) slices = the blocks; stage_w and smem_bytes must agree
// with this file's layout; vec2 (float2 loads and stores) needs H even and
// xh, vec, dx, dvec 8-byte aligned; else cudaErrorInvalidValue. Needs K >= 1,
// R >= 2 and M K < 2^31. Launches on `stream` and returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int painn_message_consumer_f32(
    const void* dist, const void* mask, const void* unit, const void* xh,
    const void* vec, const void* w, const void* bias, void* dx, void* dvec,
    int M, int K, int R, int H, float inv_cutoff, int envelope_exponent,
    int chunks, int stage_w, int vec2, int smem, void* stream) {
  if (M <= 0 || H <= 0) return 0;
  const long long slices = (H + kCols - 1) / kCols;
  if (K < 1 || R < 2 || (long long)M * K > INT_MAX || chunks < 1 || chunks > M || chunks * slices > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if ((size_t)smem != smem_bytes(R, stage_w != 0)) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)xh | (uintptr_t)vec | (uintptr_t)dx | (uintptr_t)dvec;
  if (vec2 && (H % 2 != 0 || align % 8 != 0)) return (int)cudaErrorInvalidValue;
  Args a;
  a.dist = static_cast<const float*>(dist);
  a.unit = static_cast<const float*>(unit);
  a.xh = static_cast<const float*>(xh);
  a.vec = static_cast<const float*>(vec);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const uint8_t*>(mask);
  a.dx = static_cast<float*>(dx);
  a.dvec = static_cast<float*>(dvec);
  a.M = M;
  a.K = K;
  a.R = R;
  a.H = H;
  a.chunks = chunks;
  a.slices = (int)slices;
  a.inv_cutoff = inv_cutoff;
  a.p = envelope_exponent;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem;
  if (stage_w) return (int)(vec2 ? launch<true, true>(a, bytes, s) : launch<true, false>(a, bytes, s));
  return (int)(vec2 ? launch<false, true>(a, bytes, s) : launch<false, false>(a, bytes, s));
}

// This file's layout, for tools that launch other versions of the kernel side by side: the dynamic shared bytes a
// block takes with W staged or not, and the columns a block owns (*cols).
extern "C" int painn_message_consumer_layout(int R, int stage_w, int* cols) {
  *cols = kCols;
  return (int)smem_bytes(R, stage_w != 0);
}

extern "C" const char* painn_message_consumer_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
