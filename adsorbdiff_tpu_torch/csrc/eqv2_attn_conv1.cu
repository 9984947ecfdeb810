// EquiformerV2 attention front half, fused, for Hopper (sm_90a), f32:
// gaussian distance basis -> radial trunk -> per-m gates -> gated first SO(2)
// convolution over the separate source and target message halves. (bf16
// message halves take eqv2_attn_conv1_bf16.cu, on the tensor cores.)
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _attn_conv1_kernel (called from _attn_conv1_call; public eqv2_attn_conv1,
// plain math _attn_conv1_ref). Per edge e, with the packed weights of
// ops/kernels.py::pack_attn_conv1:
//
//   gauss[r] = exp(coeff (d - r delta)^2) mask                    [R]
//   y0 = silu(LN(gauss @ wg + emb_s @ ws + emb_t @ wt + b0))       [H]   LN eps 1e-6
//   y1 = silu(LN(y0 @ w1 + b1))                                    [H]
//   gates = y1 @ w2 + b2          [2 x sum(nb) x C], columns [s-half | t-half], n-major
//   m0:   [extra | h_m0] = (msg_s[m0] g_s[m0]) @ km0_s + (msg_t[m0] g_t[m0]) @ km0_t + bm0
//   |m|>0, per half:  yp += xp @ kr - xn @ ki,  yn += xp @ ki + xn @ kr
//                     (xp, xn the +m and -m message rows times the block's gates)
//
// What bounds it on the H100: at the sampling shape (E = 25,600 edges, R = 600,
// H = 128, C = 128, c_out = 64, extra = 576, blocks (5, 4, 3)) an edge needs
// 6.47 MFLOP on the non-zero gaussian rows (trunk 0.90, m0 2.29, m+-1 2.10,
// m+-2 1.18): 165.7 GFLOP, 2.47 ms of f32 FMAs at 67 TFLOP/s. It moves ~0.7 GB
// (the two message halves 0.50 GB, the outputs 0.18 GB, embeddings and 9.94 MB
// of packed weights), 0.21 ms at 3.35 TB/s. So operations set the bound, and
// the kernel is as fast as its FMA pipes are kept busy.
//
// The design (each point answers what held the 16-edge design at 27% of the
// bound):
// - Tiles of 64 edges (kTE), one block of 256 threads per SM (about 212 KB of
//   shared memory): every weight value fetched from L2 feeds 64 edges (128 in
//   a |m| > 0 pair), 4x the 16 of the old design.
// - The weights stream through a ring of 3 slots in shared memory (32 KB
//   each), copied with cp.async: a slot holds one slice of a weight matrix,
//   as many rows as fill it up to 64 ([16, 448] of an m0 pass, [64, 128] of a
//   trunk pass or a gate chunk; for a pair kr's slice then ki's). A tile's
//   weights are one fixed sequence of slices (the segment table that
//   for_each_segment builds once per block), so slice q + 2 is copied while
//   slice q is multiplied, across GEMMs, m-blocks and tiles, one barrier a
//   slice. The cursor over the table lives in shared memory (Sched): thread
//   0 advances it, so the threads' registers hold none of it.
// - Register micro-tiles, both operands from shared memory: thread (ty, tx)
//   owns 4 edges x 4 columns per 64-column group, so one float4 of A and one
//   of W feed 16 FMAs; an m0 pass holds 4 x 28 accumulators (448 columns), a
//   pair pass 2 x 4 x 16 (yp, yn over 256 columns). The gates use 8 x 4
//   tiles (warp = 8 edges, lane = 4 of 128 columns). k loops are unrolled to
//   a few hundred FMAs of straight code: fully unrolled 16-step bodies
//   outgrew the SM's instruction cache.
// - Nothing but the outputs reaches device memory: the gaussian basis (64
//   rows at a time), both trunk activations (LayerNorm in shared memory) and
//   the gates stay on chip. Gates are made 128 columns at a time (y1 @ w2
//   chunk + b2) and stored to shared memory, where a sweep with lanes along
//   the edges multiplies in the chunk's message rows (prefetched to L2 while
//   the gates were made; xp in place, and xn for |m| > 0), swizzled so the
//   stores spread over the banks; the chunk's conv slices then consume it
//   into the register accumulators, over both halves, so yp, yn and the m0
//   outputs are summed in registers and written once. An m0 output of 896
//   columns needs two passes of 448, and each pass makes its gates again:
//   2 x 2 x H x nb0 C = 0.33 MFLOP per edge more, 5.1% of the bound's count
//   (at most 10% is allowed).
// - A 64-row gaussian slice that is zero for the whole tile (all its edges'
//   distances far from those centres, masked slots, distances past the
//   cutoff) skips its FMAs, as the bound counts only non-zero rows.
// - The grid is sized against the SMs (ops/kernels.py::attn_conv1_plan, the
//   Sched struct): one persistent block per SM takes whole tiles; the tiles
//   left over are cut into units, one m-block column pass of one 32-edge half
//   tile each (with the trunk, made again per unit: 0.15% more FLOP at the
//   sampling shape), spread over the blocks. At 25,600 edges = 400 tiles that
//   is 3 tiles a block and 32 units, where an even split of the edges left
//   every block a 2-edge fourth tile that cost most of a full one (it still
//   streams every weight and passes every barrier).
// - Ragged input is handled in the kernel: any E, masked slots (they get
//   outputs like any other slot: their gaussian rows are 0 and the attention
//   zeroes them later), any widths (a region whose rows or columns are not
//   16-byte aligned is copied 4 bytes at a time). Widths whose plan does not
//   fit in 227 KB (trunk and embedding widths over 160 at C = 128) are
//   refused by the plan.
//
// Measured (chip_smoke.py phase 10, NVIDIA H100 80GB HBM3, 700 W): PERF.md
// section 6, row 9, beside the 16-edge design it replaced (9.145 ms, 27% of
// the bound). What holds it: 8 warps an SM at 255 registers a thread (the
// 112-128 accumulators leave no room for more warps or for prefetched
// fragments), so shared-memory latency is only partly hidden; every thread
// issues its share of the weight copies; the m+-1 units set the tail. Tried
// and slower on this card: the weights as TMA bulk copies (one a row, or
// 16 x 64 boxes of 2-D tensor maps issued by one thread). Left: tensor cores
// with a split-f32 product (every product here is a [64, K] x [K, N] GEMM
// tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTE = 64;            // edges per tile; the A operands' row stride in shared memory
constexpr int kKS = 16;            // weight rows a slice holds at least
constexpr int kMaxSliceRows = 64;  // ... and at most
constexpr int kStages = 3;         // ring slots
constexpr int kSlot = 8192;        // floats per ring slot (32 KB)
constexpr int kKC = 128;           // gate columns per chunk
constexpr int kTrunkN = 128;       // trunk columns per pass (NJ = 2)
constexpr int kM0NJ = 7;           // m0 column groups per pass: 448 columns
constexpr int kPairNJ = 4;         // |m| > 0 column groups per pass at most: 256 columns
constexpr int kMaxGroups = 8;      // m-blocks (mmax + 1)
constexpr int kMaxParts = 32;      // m-block column passes (a work item's part mask is 32 bits)

// k steps unrolled per loop trip for NJ 64-column groups (16 NJ FMAs a step):
// 100 to 256 FMAs of straight code
template <int NJ>
__host__ __device__ constexpr int kUnroll() { return NJ >= 8 ? 1 : NJ >= 4 ? 4 : 8 / NJ; }

struct Seg {  // one weight matrix region, streamed in slices of sr rows
  const float* src0;
  const float* src1;  // a pair's ki, laid after kr's slice in the slot; or null
  int ld, rows, cols, sld, sr, vec;
  int part;  // the m-block column pass it feeds (-1: the trunk, every work item's)
};

struct Args {
  const float* dist;
  const uint8_t* mask;
  const float *emb_s, *emb_t, *msg_s, *msg_t;
  const float *wg, *ws, *wt, *b0, *ln0s, *ln0b, *w1, *b1, *ln1s, *ln1b, *w2, *b2, *bm0, *wconv;
  float *extra_out, *h_out;
  long long E;
  int R, Ed, H, C, CO, X, n_groups;
  int NG;  // gate columns, 2 sum(nb) C: the row stride of w2
  int nb[kMaxGroups];
  float delta, coeff;
  long long msg_ld;  // message row length, NA * C
  int msg_vec;       // both message halves' chunks are 16-byte aligned (float4 loads)
  int Hp, Edp;       // H, Ed rounded up to 4
  int x_floats;      // the X region: es/et, y1 before its LayerNorm, the gated message chunk
  int n_seg;         // segments per tile
  int n_parts;       // m-block column passes per tile
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Rows per ring slice of a segment of `cols` columns (two matrices side by
// side for a pair): as many 16-row steps as fill a slot, 16 to 64.
__host__ __device__ inline int slice_rows(int cols, bool pair) {
  const int r = kSlot / (round4(cols) * (pair ? 2 : 1)) / kKS * kKS;
  return r < kKS ? kKS : (r > kMaxSliceRows ? kMaxSliceRows : r);
}

// Column pass width: the fewest passes of at most nj_max x 64 columns, each
// rounded up to whole 64-column groups.
__host__ __device__ inline int pass_width(int n, int nj_max) {
  const int passes = cdiv(n, nj_max * 64);
  return cdiv(cdiv(n, passes), 64) * 64;
}

// m-block g's output columns
__host__ __device__ inline int group_cols(const Args& a, int g) {
  return g == 0 ? a.X + a.nb[0] * a.CO : a.nb[g] * a.CO;
}
__host__ __device__ inline int group_pass(const Args& a, int g) {
  return pass_width(group_cols(a, g), g == 0 ? kM0NJ : kPairNJ);
}

// The tile's weight stream, in the order the kernel body consumes it; f(src0,
// src1, ld, rows, cols, part) per segment.
template <class F>
__host__ __device__ void for_each_segment(const Args& a, F& f) {
  for (int hc = 0; hc < a.H; hc += kTrunkN) {
    const int hw = imin(kTrunkN, a.H - hc);
    f(a.wg + hc, (const float*)nullptr, a.H, a.R, hw, -1);
    f(a.ws + hc, (const float*)nullptr, a.H, a.Ed, hw, -1);
    f(a.wt + hc, (const float*)nullptr, a.H, a.Ed, hw, -1);
  }
  for (int hc = 0; hc < a.H; hc += kTrunkN) {
    f(a.w1 + hc, (const float*)nullptr, a.H, a.H, imin(kTrunkN, a.H - hc), -1);
  }
  const int half_gates = a.NG / 2;
  const float* wc = a.wconv;
  int goff = 0, part = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    const int K = a.nb[g] * a.C, N = group_cols(a, g), tn = group_pass(a, g);
    const size_t kn = (size_t)K * N;
    for (int c0 = 0; c0 < N; c0 += tn, ++part) {
      const int w = imin(tn, N - c0);
      for (int half = 0; half < 2; ++half) {
        for (int kc = 0; kc < K; kc += kKC) {
          const int kw = imin(kKC, K - kc);
          f(a.w2 + half * half_gates + goff + kc, (const float*)nullptr, a.NG, a.H, kw, part);
          if (g == 0) {
            f(wc + half * kn + (size_t)kc * N + c0, (const float*)nullptr, N, kw, w, part);
          } else {
            const float* kr = wc + 2 * half * kn + (size_t)kc * N + c0;
            f(kr, kr + kn, N, kw, w, part);
          }
        }
      }
    }
    wc += (g == 0 ? 2 : 4) * kn;
    goff += K;
  }
}

struct SegCounter {
  int n = 0, parts = 0;
  __host__ __device__ void operator()(const float*, const float*, int, int, int, int part) {
    ++n;
    if (part + 1 > parts) parts = part + 1;
  }
};

struct SegWriter {
  Seg* segs;
  int n = 0;
  __device__ void operator()(const float* s0, const float* s1, int ld, int rows, int cols, int part) {
    const bool aligned = (ld % 4 == 0) && (cols % 4 == 0) && ((reinterpret_cast<uintptr_t>(s0) & 15) == 0) &&
                         (s1 == nullptr || (reinterpret_cast<uintptr_t>(s1) & 15) == 0);
    segs[n++] = Seg{s0, s1, ld, rows, cols, round4(cols), slice_rows(cols, s1 != nullptr), aligned ? 1 : 0, part};
  }
};

// A block's work: `whole` tiles (every part), then units of the tiles left
// over, each unit one column pass of one half (32 edges) of a tile, with the
// trunk, which every unit makes again. So 25,600 edges = 400 tiles on 132
// SMs are 3 tiles a block and 32 units, not 3 tiles and a 2-edge fourth.
// Lives in shared memory with the ring's cursor: thread 0 advances the
// cursor, double buffered by slice parity, so the threads' registers hold
// none of it.
constexpr int kUnitEdges = kTE / 2;

struct Sched {
  int whole, first_left, units, blocks, parts, b, n_items;
  int seg[2], piece[2], item[2];  // the next slice to issue: segment, row piece, work item
  unsigned mask[2];               // ... and that item's parts

  __host__ __device__ void init(long long E, int blocks_, int parts_, int b_) {
    const int tiles = (int)((E + kTE - 1) / kTE);
    blocks = blocks_, parts = parts_, b = b_;
    whole = tiles / blocks;
    first_left = whole * blocks;
    units = (int)((E - (long long)first_left * kTE + kUnitEdges - 1) / kUnitEdges) * parts;  // non-empty halves
    n_items = whole + (units > b ? (units - b + blocks - 1) / blocks : 0);
  }
  // item i's first edge and edge count (at most)
  __host__ __device__ int first_edge(int i) const {
    return i < whole ? (b * whole + i) * kTE : first_left * kTE + (b + (i - whole) * blocks) / parts * kUnitEdges;
  }
  __host__ __device__ int max_edges(int i) const { return i < whole ? kTE : kUnitEdges; }
  __host__ __device__ unsigned parts_of(int i) const {
    return i < whole ? ~0u : 1u << ((b + (i - whole) * blocks) % parts);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// rows x cols floats from src (row stride ld) to dst (row stride sld); thread
// t copies elements t, t + 256, ... of the row-major slice (16 bytes each when
// vec, else 4), walking (row, column) without a division per element.
__device__ __forceinline__ void copy_slice(float* dst, int sld, const float* src, int ld, int rows, int cols,
                                           bool vec) {
  const int w = vec ? cols / 4 : cols;  // elements a row
  const int dr = kThreads / w, dc = kThreads - dr * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  for (; r < rows; r += dr) {
    if (vec) {
      cp_async16(dst + r * sld + 4 * c, src + (size_t)r * ld + 4 * c);
    } else {
      cp_async4(dst + r * sld + c, src + (size_t)r * ld + c);
    }
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// The ring: slice q lives in slot q % kStages. Every thread issues its share
// of each copy at the cursor in the schedule (the copy of parity i % 2 for
// issue i); thread 0 then writes the next slice's cursor into the other copy,
// skipping the segments of parts the work item does not take. The barrier of
// each acquire orders that write before the next issue reads it.
struct Ring {
  float* slots;
  const Seg* segs;
  int n_seg;
  Sched* sc;
  int q = 0;  // next slice to consume

  // (seg, piece, item, mask) moved to the next selected slice
  __device__ void advance(int& seg, int& piece, int& item, unsigned& mask, bool step) const {
    if (step && ++piece * segs[seg].sr < segs[seg].rows) return;
    if (step) {
      piece = 0;
      ++seg;
    }
    for (;;) {
      if (seg == n_seg) {  // the next item streams the same weights
        seg = 0;
        if (++item < sc->n_items) mask = sc->parts_of(item);
      }
      if (item >= sc->n_items || segs[seg].part < 0 || ((mask >> segs[seg].part) & 1u)) return;
      ++seg;
    }
  }
  __device__ void issue(int slot, int cur) {
    const int item = sc->item[cur];
    if (item < sc->n_items) {
      const Seg& s = segs[sc->seg[cur]];
      const int r0 = sc->piece[cur] * s.sr, rows = imin(s.sr, s.rows - r0);
      float* dst = slots + slot * kSlot;
      copy_slice(dst, s.sld, s.src0 + (size_t)r0 * s.ld, s.ld, rows, s.cols, s.vec);
      if (s.src1 != nullptr) {
        copy_slice(dst + s.sr * s.sld, s.sld, s.src1 + (size_t)r0 * s.ld, s.ld, rows, s.cols, s.vec);
      }
      if (threadIdx.x == 0) {
        int seg = sc->seg[cur], piece = sc->piece[cur], it = item;
        unsigned mask = sc->mask[cur];
        advance(seg, piece, it, mask, true);
        sc->seg[cur ^ 1] = seg, sc->piece[cur ^ 1] = piece, sc->item[cur ^ 1] = it, sc->mask[cur ^ 1] = mask;
      }
    } else if (threadIdx.x == 0) {
      sc->item[cur ^ 1] = item;
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  }
  __device__ void prologue() {
    if (threadIdx.x == 0) {
      int seg = 0, piece = 0, item = 0;
      unsigned mask = sc->n_items > 0 ? sc->parts_of(0) : 0u;
      if (sc->n_items > 0) advance(seg, piece, item, mask, false);
      sc->seg[0] = seg, sc->piece[0] = piece, sc->item[0] = item, sc->mask[0] = mask;
    }
    for (int s = 0; s < kStages - 1; ++s) {
      __syncthreads();
      issue(s, s & 1);
    }
  }
  // Slice q's slot, once every thread's copy of it has landed and every
  // thread is done with slice q - 1 (whose slot then takes slice q + 2).
  __device__ const float* acquire() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue((q + kStages - 1) % kStages, q & 1);  // issue number q + 2
    return slots + (q++ % kStages) * kSlot;
  }
};

// Float offset of row k, edges 4 ty .. 4 ty + 3, in a [k][64 edges] operand.
// The gated message chunk is stored swizzled (SWZ): the float4 of edge group
// ty sits in slot ty ^ ((k / 4) % 16), so stores where the lanes of a
// half-warp write rows 4 apart spread over the banks instead of falling 16 to
// one bank group; a mma step reads one row, two slots.
template <bool SWZ>
__device__ __forceinline__ int a_offset(int k, int ty) {
  return k * kTE + 4 * (SWZ ? ty ^ ((k >> 2) & 15) : ty);
}

// acc[i][4j + c] += sum_{k < kr} A[arow0 + k][4 ty + i] W[k][(tx + 16 j) 4 + c]
// (ty = tid / 16, tx = tid % 16). The k loop is unrolled KU steps at a time:
// a fully unrolled 16-step body outgrew the SM's instruction cache.
template <int NJ, bool SWZ = false>
__device__ __forceinline__ void mma(float (&acc)[4][4 * NJ], const float* A, int arow0, const float* W, int sld,
                                    int kr) {
  constexpr int KU = kUnroll<NJ>();
  const int ty = threadIdx.x / 16;
  const float* w = W + 4 * (threadIdx.x % 16);
  auto step = [&](int k) {
    const float4 av = *reinterpret_cast<const float4*>(A + a_offset<SWZ>(arow0 + k, ty));
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * sld + 64 * j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][4 * j + 0] = fmaf(ar[i], wv.x, acc[i][4 * j + 0]);
        acc[i][4 * j + 1] = fmaf(ar[i], wv.y, acc[i][4 * j + 1]);
        acc[i][4 * j + 2] = fmaf(ar[i], wv.z, acc[i][4 * j + 2]);
        acc[i][4 * j + 3] = fmaf(ar[i], wv.w, acc[i][4 * j + 3]);
      }
    }
  };
  int k0 = 0;
#pragma unroll 1
  for (; k0 + KU <= kr; k0 += KU) {
#pragma unroll
    for (int k = 0; k < KU; ++k) step(k0 + k);
  }
#pragma unroll 1
  for (; k0 < kr; ++k0) step(k0);
}

// The gate tile: g[i][c] += sum_{k < kr} y[k][i] w[k][c], y at the warp's 8
// edges of a [k][64] operand, w at the lane's 4 columns of a slice row.
__device__ __forceinline__ void gate_mma(float (&g)[8][4], const float* y, const float* w, int sld, int kr) {
  auto step = [&](int k) {
    const float4 y0 = *reinterpret_cast<const float4*>(y + k * kTE);
    const float4 y1 = *reinterpret_cast<const float4*>(y + k * kTE + 4);
    const float4 wv = *reinterpret_cast<const float4*>(w + k * sld);
    const float yr[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      g[i][0] = fmaf(yr[i], wv.x, g[i][0]);
      g[i][1] = fmaf(yr[i], wv.y, g[i][1]);
      g[i][2] = fmaf(yr[i], wv.z, g[i][2]);
      g[i][3] = fmaf(yr[i], wv.w, g[i][3]);
    }
  };
  int k0 = 0;
#pragma unroll 1
  for (; k0 + 8 <= kr; k0 += 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) step(k0 + k);
  }
#pragma unroll 1
  for (; k0 < kr; ++k0) step(k0);
}

// The |m| > 0 pair: yp += XP KR - XN KI, yn += XP KI + XN KR; XP and XN the
// swizzled xp^T and xn^T regions, rows arow0 .. arow0 + kr.
template <int NJ>
__device__ __forceinline__ void pair_mma(float (&yp)[4][4 * NJ], float (&yn)[4][4 * NJ], const float* XP,
                                         const float* XN, int arow0, const float* KR, const float* KI, int sld,
                                         int kr) {
  constexpr int KU = kUnroll<4 * NJ>();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  KR += 4 * tx;
  KI += 4 * tx;
  auto step = [&](int k) {
    const int off = a_offset<true>(arow0 + k, ty);
    const float4 pv = *reinterpret_cast<const float4*>(XP + off);
    const float4 nv = *reinterpret_cast<const float4*>(XN + off);
    const float p[4] = {pv.x, pv.y, pv.z, pv.w};
    const float n[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 r4 = *reinterpret_cast<const float4*>(KR + k * sld + 64 * j);
      const float4 i4 = *reinterpret_cast<const float4*>(KI + k * sld + 64 * j);
      const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
      const float iv[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          yp[i][4 * j + c] = fmaf(p[i], rv[c], yp[i][4 * j + c]);
          yp[i][4 * j + c] = fmaf(-n[i], iv[c], yp[i][4 * j + c]);
          yn[i][4 * j + c] = fmaf(p[i], iv[c], yn[i][4 * j + c]);
          yn[i][4 * j + c] = fmaf(n[i], rv[c], yn[i][4 * j + c]);
        }
      }
    }
  };
  int k0 = 0;
#pragma unroll 1
  for (; k0 + KU <= kr; k0 += KU) {
#pragma unroll
    for (int k = 0; k < KU; ++k) step(k0 + k);
  }
#pragma unroll 1
  for (; k0 < kr; ++k0) step(k0);
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// dst[h][e] = silu(LN(src[., e])[h] * scale[h] + bias[h]) over h < H, for the
// tile's 64 edges (layout [h][64]); four threads per edge. src may be dst.
__device__ __forceinline__ void ln_silu(const float* src, float* dst, int H, const float* __restrict__ scale,
                                        const float* __restrict__ bias) {
  const int e = threadIdx.x / 4, part = threadIdx.x % 4;
  float s = 0.f;
  for (int h = part; h < H; h += 4) s += src[h * kTE + e];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mu = s / H;
  float v = 0.f;
  for (int h = part; h < H; h += 4) {
    const float t = src[h * kTE + e] - mu;
    v += t * t;
  }
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  const float inv = rsqrtf(v / H + 1e-6f);
  for (int h = part; h < H; h += 4) {
    dst[h * kTE + e] = silu((src[h * kTE + e] - mu) * inv * __ldg(scale + h) + __ldg(bias + h));
  }
}

// acc (4 edges x 4 NJ columns of a pass starting at c0, n valid) -> dst[col][e]
template <int NJ>
__device__ __forceinline__ void store_t(float* dst, const float (&acc)[4][4 * NJ], int c0, int n) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = (tx + 16 * j) * 4 + c;
      if (col < n) {
        *reinterpret_cast<float4*>(dst + (c0 + col) * kTE + 4 * ty) =
            make_float4(acc[0][4 * j + c], acc[1][4 * j + c], acc[2][4 * j + c], acc[3][4 * j + c]);
      }
    }
}

template <int NJ>
__device__ __forceinline__ void init_bias(float (&acc)[4][4 * NJ], const float* __restrict__ b, int n) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = (tx + 16 * j) * 4 + c;
      const float v = (b != nullptr && col < n) ? __ldg(b + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][4 * j + c] = v;
    }
}

struct Tile {
  const Args* a;
  Ring* ring;
  float *Y, *X;
  int e0;       // the tile's first edge
  int ne;       // edges in this tile
  bool active;  // this warp has an edge below ne (warp w owns edges 8w .. 8w + 7)
};

// One chunk of gates (columns kc .. kc + kw of the half's m-block gates, which
// start at gate column gcol0), then the gated message rows into X: xp^T
// [kw][64] at X from the +m rows at message column msg_col + kc, and for a
// pair (neg_off > 0: the -m rows' offset in the message row) xn^T at X + kKC
// * kTE with the same gates, both swizzled.
__device__ __forceinline__ void gated_chunk(Tile& t, int gcol0, const float* msg_half, int kc, int kw, int msg_col,
                                            int neg_off) {
  const Args& a = *t.a;
  const float* msg = msg_half + msg_col + kc;
  // bring the chunk's message rows toward L2 while the gates are made: 64 edges x 2 halves x 4 lines of 128 B
  for (int i = threadIdx.x; i < kTE * 8; i += kThreads) {
    const int e = i / 8, line = i % 8, off = (line & 4 ? neg_off : 0) + (line & 3) * 32;
    if (e < t.ne && (line < 4 || neg_off > 0) && (line & 3) * 32 < kw) {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(msg + (size_t)(t.e0 + e) * a.msg_ld + off));
    }
  }
  // the gates: warp w makes edges 8w .. 8w + 7, lane l columns 4l .. 4l + 3
  // (an 8 x 4 register tile: two broadcast float4s of y1 and one of w2 feed
  // 32 FMAs)
  const int w8 = threadIdx.x / 32, lane = threadIdx.x % 32;
  float g[8][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float b = 4 * lane + c < kw ? __ldg(a.b2 + gcol0 + kc + 4 * lane + c) : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i][c] = b;
  }
  const int sld = round4(kw), sr = slice_rows(kw, false);
  for (int s = 0; s * sr < a.H; ++s) {
    const float* W = t.ring->acquire();
    if (t.active) gate_mma(g, t.Y + s * sr * kTE + 8 * w8, W + 4 * lane, sld, imin(sr, a.H - s * sr));
  }
  // the gates to X (swizzled [k][64 edges]); X is free: every thread passed
  // this chunk's acquire barriers after it last read X
  if (t.active) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * lane + c;
      if (k < kw) {
        *reinterpret_cast<float4*>(t.X + a_offset<true>(k, 2 * w8)) = make_float4(g[0][c], g[1][c], g[2][c], g[3][c]);
        *reinterpret_cast<float4*>(t.X + a_offset<true>(k, 2 * w8 + 1)) =
            make_float4(g[4][c], g[5][c], g[6][c], g[7][c]);
      }
    }
  }
  __syncthreads();
  // times the message rows, in place (xp), and into the xn region for a
  // pair: lanes along the edges, each a float4 of four columns; four items a
  // thread load their message values before any is used, so their latencies
  // overlap
  const int k4s = cdiv(kw, 4), items = kTE * k4s;
  for (int i0 = threadIdx.x; i0 < items; i0 += 4 * kThreads) {
    float m[4][4], mn[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, e = i % kTE, k0 = 4 * (i / kTE);
#pragma unroll
      for (int c = 0; c < 4; ++c) m[u][c] = mn[u][c] = 0.f;
      if (i < items && e < t.ne) {
        const float* row = msg + (size_t)(t.e0 + e) * a.msg_ld + k0;
        if (a.msg_vec) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row));
          m[u][0] = v.x, m[u][1] = v.y, m[u][2] = v.z, m[u][3] = v.w;
          if (neg_off > 0) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(row + neg_off));
            mn[u][0] = w.x, mn[u][1] = w.y, mn[u][2] = w.z, mn[u][3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (k0 + c < kw) {
              m[u][c] = __ldg(row + c);
              if (neg_off > 0) mn[u][c] = __ldg(row + neg_off + c);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kThreads, e = i % kTE, k0 = 4 * (i / kTE);
      if (i >= items) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (k0 + c >= kw) continue;
        const int off = a_offset<true>(k0 + c, e / 4) + e % 4;
        const float gv = t.X[off];
        t.X[off] = gv * m[u][c];
        if (neg_off > 0) t.X[kKC * kTE + off] = gv * mn[u][c];
      }
    }
  }
}

// One m0 column pass (columns c0 .. c0 + w of [extra | h_m0]) over both halves.
template <int NJ>
__device__ __forceinline__ void m0_pass(Tile& t, int K, int c0, int w) {
  const Args& a = *t.a;
  float acc[4][4 * NJ];
  init_bias<NJ>(acc, a.bm0 + c0, w);
  const int sld = round4(w), sr = slice_rows(w, false);
  for (int half = 0; half < 2; ++half) {
    for (int kc = 0; kc < K; kc += kKC) {
      const int kw = imin(kKC, K - kc);
      gated_chunk(t, half * (a.NG / 2), half ? a.msg_t : a.msg_s, kc, kw, 0, 0);
      for (int s = 0; s * sr < kw; ++s) {
        const float* W = t.ring->acquire();
        if (t.active) mma<NJ, true>(acc, t.X, s * sr, W, sld, imin(sr, kw - s * sr));
      }
    }
  }
  if (!t.active) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t hrow = (size_t)(a.msg_ld / a.C) * a.CO;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 4 * ty + i;
    if (e >= t.ne) continue;
    float* xrow = a.extra_out + (size_t)(t.e0 + e) * a.X;
    float* hrow_p = a.h_out + (size_t)(t.e0 + e) * hrow - a.X;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (tx + 16 * j) * 4 + c;
        if (col >= w) continue;
        const int oc = c0 + col;
        if (oc < a.X) {
          xrow[oc] = acc[i][4 * j + c];
        } else {
          hrow_p[oc] = acc[i][4 * j + c];
        }
      }
  }
}

// One |m| > 0 column pass (columns c0 .. c0 + w of the block's yp and yn)
// over both halves; the block's +m rows start at message row row0.
template <int NJ>
__device__ __forceinline__ void pair_pass(Tile& t, int K, int row0, int nb, int goff, int c0, int w) {
  const Args& a = *t.a;
  float yp[4][4 * NJ], yn[4][4 * NJ];
  init_bias<NJ>(yp, nullptr, 0);
  init_bias<NJ>(yn, nullptr, 0);
  const int sld = round4(w), sr = slice_rows(w, true);
  for (int half = 0; half < 2; ++half) {
    for (int kc = 0; kc < K; kc += kKC) {
      const int kw = imin(kKC, K - kc);
      gated_chunk(t, half * (a.NG / 2) + goff, half ? a.msg_t : a.msg_s, kc, kw, row0 * a.C, nb * a.C);
      for (int s = 0; s * sr < kw; ++s) {
        const float* W = t.ring->acquire();
        if (t.active) pair_mma<NJ>(yp, yn, t.X, t.X + kKC * kTE, s * sr, W, W + sr * sld, sld, imin(sr, kw - s * sr));
      }
    }
  }
  if (!t.active) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t hrow = (size_t)(a.msg_ld / a.C) * a.CO;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 4 * ty + i;
    if (e >= t.ne) continue;
    float* out = a.h_out + (size_t)(t.e0 + e) * hrow + c0;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = (tx + 16 * j) * 4 + c;
        if (col >= w) continue;
        out[(size_t)row0 * a.CO + col] = yp[i][4 * j + c];
        out[(size_t)(row0 + nb) * a.CO + col] = yn[i][4 * j + c];
      }
  }
}

__global__ void __launch_bounds__(kThreads, 1) eqv2_attn_conv1_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* slots = reinterpret_cast<float*>(smem4);  // [kStages][kSlot] weight ring
  float* Y = slots + kStages * kSlot;             // [Hp][64] trunk layer 0, then y1
  float* X = Y + a.Hp * kTE;                      // es^T, et^T; y1 before its LN; the gated message chunk
  float* G = X + a.x_floats;                      // [64][64] gaussian slice
  float* d_s = G + kMaxSliceRows * kTE;           // [64] distances
  float* m_s = d_s + kTE;                         // [64] mask as 0/1
  Seg* segs = reinterpret_cast<Seg*>(m_s + kTE);  // [n_seg] the tile's weight stream
  __shared__ Args a_s;  // the arguments the device functions read through a pointer (not to parameter space)
  __shared__ Sched sc;
  const int tid = threadIdx.x;
  if (tid == 0) {
    a_s = a;
    SegWriter w{segs};
    for_each_segment(a, w);
    sc.init(a.E, gridDim.x, a.n_parts, blockIdx.x);
  }
  __syncthreads();

  Ring ring;
  ring.slots = slots;
  ring.segs = segs;
  ring.n_seg = a.n_seg;
  ring.sc = &sc;
  ring.prologue();

  Tile t;
  t.a = &a_s;
  t.ring = &ring;
  t.Y = Y;
  t.X = X;
  for (int item = 0; item < sc.n_items; ++item) {
    const unsigned parts = sc.parts_of(item);
    t.e0 = sc.first_edge(item);
    t.ne = (int)(a.E - t.e0 < sc.max_edges(item) ? a.E - t.e0 : sc.max_edges(item));
    t.active = 8 * (tid / 32) < t.ne;

    // 1. stage the tile's distances, mask and embeddings (transposed)
    __syncthreads();  // the previous item is done with X, d_s and m_s
    if (tid < kTE) {
      d_s[tid] = tid < t.ne ? a.dist[t.e0 + tid] : 0.f;
      m_s[tid] = (tid < t.ne && a.mask[t.e0 + tid]) ? 1.f : 0.f;
    }
    for (int i = tid; i < kTE * a.Ed; i += kThreads) {
      const int j = i / kTE, e = i - j * kTE;
      const bool ok = e < t.ne;
      X[j * kTE + e] = ok ? __ldg(a.emb_s + (size_t)(t.e0 + e) * a.Ed + j) : 0.f;
      X[(a.Edp + j) * kTE + e] = ok ? __ldg(a.emb_t + (size_t)(t.e0 + e) * a.Ed + j) : 0.f;
    }
    __syncthreads();

    // 2. trunk layer 0: gauss @ wg + emb_s @ ws + emb_t @ wt + b0 -> Y, then LN + SiLU
    for (int hc = 0; hc < a.H; hc += kTrunkN) {
      const int hw = imin(kTrunkN, a.H - hc), sld = round4(hw), sr = slice_rows(hw, false);
      float acc[4][8];
      init_bias<2>(acc, a.b0 + hc, hw);
      for (int s = 0; s * sr < a.R; ++s) {
        const float* W = ring.acquire();  // also: every thread is done with the last slice's G
        const int r0 = s * sr, rows = imin(sr, a.R - r0);
        int nz = 0;
        for (int i = tid; i < sr * kTE; i += kThreads) {
          const int rr = i / kTE, e = i - rr * kTE;
          float v = 0.f;
          if (rr < rows && e < t.ne) {
            const float d = d_s[e] - (float)(r0 + rr) * a.delta;
            v = expf(a.coeff * (d * d)) * m_s[e];
          }
          G[i] = v;
          nz |= v != 0.f;
        }
        if (__syncthreads_or(nz) && t.active) mma<2>(acc, G, 0, W, sld, rows);
      }
      for (int s = 0; s * sr < a.Ed; ++s) {
        const float* W = ring.acquire();
        if (t.active) mma<2>(acc, X, s * sr, W, sld, imin(sr, a.Ed - s * sr));
      }
      for (int s = 0; s * sr < a.Ed; ++s) {
        const float* W = ring.acquire();
        if (t.active) mma<2>(acc, X, a.Edp + s * sr, W, sld, imin(sr, a.Ed - s * sr));
      }
      if (t.active) store_t<2>(Y, acc, hc, hw);
    }
    __syncthreads();
    ln_silu(Y, Y, a.H, a.ln0s, a.ln0b);

    // 3. trunk layer 1: y0 @ w1 + b1 -> X, then LN + SiLU -> Y (y1)
    for (int hc = 0; hc < a.H; hc += kTrunkN) {
      const int hw = imin(kTrunkN, a.H - hc), sld = round4(hw), sr = slice_rows(hw, false);
      float acc[4][8];
      init_bias<2>(acc, a.b1 + hc, hw);
      for (int s = 0; s * sr < a.H; ++s) {
        const float* W = ring.acquire();  // the first one also orders layer 0's LN before these reads
        if (t.active) mma<2>(acc, Y, s * sr, W, sld, imin(sr, a.H - s * sr));
      }
      if (t.active) store_t<2>(X, acc, hc, hw);
    }
    __syncthreads();
    ln_silu(X, Y, a.H, a.ln1s, a.ln1b);  // (the next acquire barrier orders this before Y is read)

    // 4. the item's m-block column passes: gates, gated messages, conv products
    int row0 = 0, goff = 0, part = 0;
    for (int g = 0; g < a.n_groups; ++g) {
      const int nb = a.nb[g], K = nb * a.C, N = group_cols(a, g), tn = group_pass(a, g);
      for (int c0 = 0; c0 < N; c0 += tn, ++part) {
        if (!((parts >> part) & 1u)) continue;
        const int w = imin(tn, N - c0);
        if (g == 0) {
          m0_pass<kM0NJ>(t, K, c0, w);
        } else {
          switch (tn / 64) {
            case 1: pair_pass<1>(t, K, row0, nb, goff, c0, w); break;
            case 2: pair_pass<2>(t, K, row0, nb, goff, c0, w); break;
            case 3: pair_pass<3>(t, K, row0, nb, goff, c0, w); break;
            default: pair_pass<4>(t, K, row0, nb, goff, c0, w); break;
          }
        }
      }
      row0 += g == 0 ? nb : 2 * nb;
      goff += K;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors, f32 unless named: dist [E]; mask [E] bool (uint8); emb_s, emb_t
// [E, Ed]; msg_s, msg_t [E, NA * C] (truncated m-primary rows, n-major,
// channel inner); the packed trunk wg [R, H], ws, wt [Ed, H], b0, ln0s, ln0b
// [H], w1 [H, H], b1, ln1s, ln1b [H], w2 [H, 2 sum(nb) C], b2 [2 sum(nb) C],
// bm0 [extra + nb0 c_out]; wconv, the conv kernels flattened one after another
// (km0_s, km0_t [nb0 C, extra + nb0 c_out], then per |m| block kr_s, ki_s,
// kr_t, ki_t [nb C, nb c_out]); extra_out [E, extra] and h_out [E, NA c_out]
// are written. n_blocks: host array of the rows per m-block (n_groups <= 8).
// `blocks` and `smem_bytes` come from the wrapper's plan
// (ops/kernels.py::attn_conv1_plan); a shared-memory size that disagrees with
// this kernel's layout is refused with cudaErrorInvalidValue. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int eqv2_attn_conv1_f32(
    const void* dist, const void* mask, const void* emb_s, const void* emb_t, const void* msg_s,
    const void* msg_t, const void* wg, const void* ws, const void* wt, const void* b0, const void* ln0s,
    const void* ln0b, const void* w1, const void* b1, const void* ln1s, const void* ln1b, const void* w2,
    const void* b2, const void* bm0, const void* wconv, void* extra_out, void* h_out, long long E,
    int num_gauss, int emb_dim, int hidden, int c_in, int c_out, int extra, const int* n_blocks, int n_groups,
    float cutoff, float width_scalar, int blocks, int smem_bytes, void* stream) {
  if (E <= 0) return 0;
  if (E > 0x7fffffffLL - kTE) return (int)cudaErrorInvalidValue;  // edge indices are 32-bit in the kernel
  if (n_groups < 1 || n_groups > kMaxGroups || num_gauss < 2 || blocks < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.dist = static_cast<const float*>(dist);
  a.mask = static_cast<const uint8_t*>(mask);
  a.emb_s = static_cast<const float*>(emb_s);
  a.emb_t = static_cast<const float*>(emb_t);
  a.msg_s = static_cast<const float*>(msg_s);
  a.msg_t = static_cast<const float*>(msg_t);
  a.wg = static_cast<const float*>(wg);
  a.ws = static_cast<const float*>(ws);
  a.wt = static_cast<const float*>(wt);
  a.b0 = static_cast<const float*>(b0);
  a.ln0s = static_cast<const float*>(ln0s);
  a.ln0b = static_cast<const float*>(ln0b);
  a.w1 = static_cast<const float*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.ln1s = static_cast<const float*>(ln1s);
  a.ln1b = static_cast<const float*>(ln1b);
  a.w2 = static_cast<const float*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.bm0 = static_cast<const float*>(bm0);
  a.wconv = static_cast<const float*>(wconv);
  a.extra_out = static_cast<float*>(extra_out);
  a.h_out = static_cast<float*>(h_out);
  a.E = E;
  a.R = num_gauss;
  a.Ed = emb_dim;
  a.H = hidden;
  a.C = c_in;
  a.CO = c_out;
  a.X = extra;
  a.n_groups = n_groups;
  int rows = 0, na = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    a.nb[g] = g < n_groups ? n_blocks[g] : 0;
    rows += a.nb[g];
    na += g == 0 ? a.nb[g] : 2 * a.nb[g];
  }
  a.NG = 2 * rows * c_in;
  a.msg_ld = (long long)na * c_in;
  a.msg_vec = c_in % 4 == 0 && (reinterpret_cast<uintptr_t>(msg_s) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(msg_t) & 15) == 0;
  // as the plain version: both constants in double, then rounded to f32
  const double delta = (double)cutoff / (num_gauss - 1);
  a.delta = (float)delta;
  a.coeff = (float)(-0.5 / ((width_scalar * delta) * (width_scalar * delta)));
  a.Hp = round4(hidden);
  a.Edp = round4(emb_dim);
  int xr = 2 * a.Edp > a.Hp ? 2 * a.Edp : a.Hp;
  if (2 * kKC > xr) xr = 2 * kKC;
  a.x_floats = xr * kTE;
  SegCounter count;
  for_each_segment(a, count);
  a.n_seg = count.n;
  a.n_parts = count.parts;
  if (a.n_parts > kMaxParts) return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)kStages * kSlot + a.Hp * kTE + a.x_floats + kMaxSliceRows * kTE + 2 * kTE;
  const size_t smem = floats * sizeof(float) + (size_t)a.n_seg * sizeof(Seg);
  if (smem != (size_t)smem_bytes) return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees
  cudaError_t err = cudaFuncSetAttribute(eqv2_attn_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err != cudaSuccess) return (int)err;
  eqv2_attn_conv1_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* eqv2_attn_conv1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
