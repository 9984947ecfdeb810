// EquiformerV2 attention front half in bf16, fused, for Hopper (sm_90a), on
// the bf16 tensor cores: gaussian distance basis -> radial trunk -> per-m
// gates -> gated first SO(2) convolution over the separate source and target
// message halves, for bf16 message halves.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _attn_conv1_kernel (called from _attn_conv1_call; public eqv2_attn_conv1)
// in its bf16 form (dt = msgs_ref.dtype = bf16; _attn_conv1_call casts the
// embeddings and every weight to bf16). Per edge e, with the weights of
// ops/kernels.py::pack_attn_conv1_mma (pack_attn_conv1's bf16 values, padded):
//
//   gauss[r] = bf16(exp(coeff (d - r delta)^2) mask)                   [R]
//   y0 = bf16(silu(LN(gauss @ wg + es @ ws + et @ wt + b0)))            [H]  es, et = bf16(emb)
//   y1 = bf16(silu(LN(y0 @ w1 + b1)))                                   [H]
//   gates = bf16(y1 @ w2 + b2)    [2 x sum(nb) x C], columns [s-half | t-half], n-major
//   xp = bf16(msg[+m] gates), xn = bf16(msg[-m] gates)
//   m0:   [extra | h_m0] = bf16(xp_s @ km0_s + xp_t @ km0_t + bm0)
//   |m|>0, per half:  yp += xp @ kr - xn @ ki,  yn += xp @ ki + xn @ kr, each rounded once
//
// Every product is of two bf16 values summed in f32 (jnp.dot with
// preferred_element_type f32): mma.sync m16n8k16 bf16 with f32 accumulators.
// The roundings sit where the TPU kernel and the plain version put them; only
// the order of the f32 sums inside each dot differs. The elementwise work
// (gaussians, LayerNorm, SiLU, biases, gates times messages) is f32 on the
// CUDA cores, with the f32 kernel's expressions.
//
// What bounds it on the H100: at the sampling shape (E = 25,600 edges, R =
// 600, H = 128, C = 128, c_out = 64, extra = 576, blocks (5, 4, 3)) an edge
// needs 6.47 MFLOP of products on the non-zero gaussian rows: 165.7 GFLOP,
// 0.168 ms at the dense bf16 tensor rate; it moves ~0.38 GB (the bf16 message
// halves 0.33 GB, the bf16 outputs, f32 embeddings and 5.0 MB of packed bf16
// weights), 0.11 ms. So operations set the bound.
//
// The design keeps the f32 kernel's (eqv2_attn_conv1.cu) structure and
// replaces the operand precision and the inner product:
// - Tiles of 64 edges, one persistent block of 256 threads (8 warps) per SM
//   (~207 KB of shared memory at the sampling widths), whole tiles first,
//   then units (one m-block column pass of one 32-edge half tile) of the
//   tiles left over: ops/kernels.py::attn_conv1_bf16_plan, attn_conv1_work.
// - The weights stream through the same ring of 3 slots of 32 KB, copied
//   with cp.async in one fixed sequence of slices (the segment table), one
//   barrier a slice; a slot holds up to 64 bf16 rows, padded to an odd
//   number of 16-byte chunks (mma::odd_stride) for ldmatrix.trans (40 KB
//   slots of 128 rows, 30% fewer slices, measured no faster). The packer pads every matrix with zeros to k16 rows and
//   n8 columns (and each m-block's gate columns to k16), so every copy is 16
//   bytes and no product needs a guard.
// - Every A operand lives in shared memory as bf16 [edge][k], rows of an odd
//   number of 16-byte chunks (the padding does what an XOR swizzle does, for
//   every width, the ragged ones too): the gaussian slice, both embeddings,
//   y0/y1, and the gated message chunk (xp, and xn for a pair). A fragments
//   are ldmatrix (non-trans) loads; B fragments ldmatrix.trans of the slice.
// - Warps split the columns, each warp all 64 edges (4 m16 tiles; 2 for a
//   32-edge unit): warp w takes n8 tiles w, w + 8, ... (NJ of them). The f32
//   accumulators stay in registers across both message halves: 4 x 7 x 4 =
//   112 for an m0 pass of 448 columns, at most 2 x 4 x 3 x 4 = 96 for a pair
//   pass (yp, yn over 192 columns; passes of 256 spilled); -xn is xn's A
//   fragment with its sign bits flipped (exact). yp, yn and the m0 outputs
//   are written once. The passes are functions of their own (noinline):
//   ptxas allocates them apart from the trunk, with fewer spills.
// - The trunk's f32 sums go to shared memory for LayerNorm (four threads an
//   edge, the f32 kernel's code), which writes y0 and y1 as bf16 A operands.
// - Gates are made 128 columns at a time in registers while the chunk's
//   message rows are copied into the X region (cp.async of whole rows,
//   issued before the gate slice's weights); each thread then rounds its own
//   gate fragments and
//   multiplies them into its positions of X in place, rounding each product.
//   The gates never reach shared memory.
// - A 16-row gaussian step that is zero for the whole tile is skipped (flags
//   from warp votes): the bound counts only the non-zero rows.
// Any E, masked slots, C not a multiple of 8 (messages then load 2 bytes at
// a time). Widths whose plan does not fit in 227 KB are refused by the plan.
//
// What holds it (ablations on the card, PERF.md row 9 bf16): every thread at
// 255 registers with spills in the m0 pass; a fixed cost a slice (barrier,
// cursor, copy issue: ~1 ms of the launch with no copies and no products,
// ~250 slices a tile); the gates, whose 128-column products load A for all 64
// edges per warp and are made again for the second m0 pass. The products run
// at ~130 TFLOP/s. A wgmma form was built and measured beside this one
// (PERF.md, row 9 bf16: K-major interleaved operands in shared memory, one
// m64nNk16 a k step and warpgroup, the pair's minus as the instruction's A
// scale, a 4-slot ring with one slice of products in flight): no spills and
// correct, but no faster (2.57-2.65 against 2.53-2.55 ms for the kernels
// alone), since the per-slice cost, not the products, then sets the time.
// The next step is the ring itself: a producer warp and mbarriers in place
// of a block barrier a slice, and fewer, larger slices.
//
// Measured (chip_smoke.py phase 25, scripts/variants_eqv2_bf16_mma.py;
// NVIDIA H100 80GB HBM3): PERF.md section 6, row 9 bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTE = 64;            // edges per tile
constexpr int kKS = 16;            // a slice holds a multiple of 16 weight rows
constexpr int kMaxSliceRows = 64;  // ... and at most 64
constexpr int kStages = 3;         // ring slots
constexpr int kSlot = 16384;       // bf16 per ring slot (32 KB)
constexpr int kKC = 128;           // gate columns per chunk
constexpr int kTrunkN = 128;       // trunk columns per pass (2 n8 tiles a warp)
constexpr int kM0NJ = 7;           // m0 n8 tiles a warp: 448 columns a pass
constexpr int kPairNJ = 3;         // |m| > 0 n8 tiles a warp at most: 192 columns a pass
constexpr int kMaxGroups = 8;      // m-blocks (mmax + 1)
constexpr int kMaxParts = 32;      // m-block column passes (a work item's part mask is 32 bits)
static_assert(kThreads / kTE * 16 == kMaxSliceRows, "a thread makes one 16-row step of a gaussian slice");

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int x, int m) { return cdiv(x, m) * m; }

// Rows per ring slice of a segment `cols` wide (two matrices side by side for
// a pair): as many 16-row steps as fill a slot, 16 to 64.
__host__ __device__ inline int slice_rows(int cols, bool pair) {
  const int r = kSlot / (mma::odd_stride(cols) * (pair ? 2 : 1)) / kKS * kKS;
  return r < kKS ? kKS : (r > kMaxSliceRows ? kMaxSliceRows : r);
}

// Column pass width: the fewest passes of at most nj_max x 64 columns, each
// rounded up to whole 64-column groups.
__host__ __device__ inline int pass_width(int n, int nj_max) {
  const int passes = cdiv(n, nj_max * 64);
  return cdiv(cdiv(n, passes), 64) * 64;
}

struct Seg {  // one weight matrix region, streamed in slices of sr rows
  const bf16* src0;
  const bf16* src1;  // a pair's ki, laid after kr's slice in the slot; or null
  int ld, rows, cols, sld, sr;
  int part;  // the m-block column pass it feeds (-1: the trunk, every work item's)
};

struct Args {
  const float* dist;
  const uint8_t* mask;
  const float *emb_s, *emb_t;
  const bf16 *msg_s, *msg_t;
  const bf16 *wg, *ws, *wt, *w1, *w2, *wconv;  // packed, padded bf16
  const float *b0, *ln0s, *ln0b, *b1, *ln1s, *ln1b, *b2, *bm0;  // bf16 values as f32
  bf16 *extra_out, *h_out;
  long long E;
  int R, Ed, H, C, CO, X, n_groups;
  int nb[kMaxGroups];
  int kp[kMaxGroups];  // nb C rounded up to 16: an m-block's gate columns and conv rows
  int Rp, Edp, Hp, H8;  // R, Ed, H rounded up to 16; H to 8 (the trunk matrices' row length)
  int NGp;              // the packed w2's row length, 2 sum(kp)
  float delta, coeff;
  long long msg_ld;  // message row length, NA * C
  long long h_ld;    // h_out row length, NA * CO
  int msg_vec;       // message chunks load 16 bytes at a time
  int out_vec;       // output pairs store 4 bytes at a time
  int ys, es, xs, gs, fs;  // shared row strides: Y, Es and Et, X and XN, G (bf16), F (f32)
  int n_seg, n_parts;
  // byte offsets in the dynamic shared memory (set_layout)
  int off_y, off_es, off_et, off_u, off_xn, off_g, off_d, off_m, off_nz, off_segs, smem_bytes;
};

// m-block g's output columns, real and padded to 8 (the packed row length)
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
  for (int hc = 0; hc < a.H8; hc += kTrunkN) {
    const int hw = imin(kTrunkN, a.H8 - hc);
    f(a.wg + hc, (const bf16*)nullptr, a.H8, a.Rp, hw, -1);
    f(a.ws + hc, (const bf16*)nullptr, a.H8, a.Edp, hw, -1);
    f(a.wt + hc, (const bf16*)nullptr, a.H8, a.Edp, hw, -1);
  }
  for (int hc = 0; hc < a.H8; hc += kTrunkN) {
    f(a.w1 + hc, (const bf16*)nullptr, a.H8, a.Hp, imin(kTrunkN, a.H8 - hc), -1);
  }
  const int half_gates = a.NGp / 2;
  const bf16* wc = a.wconv;
  int goff = 0, part = 0;
  for (int g = 0; g < a.n_groups; ++g) {
    const int K = a.kp[g], N = group_cols(a, g), N8 = round_up(N, 8), tn = group_pass(a, g);
    const size_t kn = (size_t)K * N8;
    for (int c0 = 0; c0 < N; c0 += tn, ++part) {
      const int w = imin(tn, N8 - c0);
      for (int half = 0; half < 2; ++half) {
        for (int kc = 0; kc < K; kc += kKC) {
          const int kw = imin(kKC, K - kc);
          f(a.w2 + half * half_gates + goff + kc, (const bf16*)nullptr, a.NGp, a.Hp, kw, part);
          if (g == 0) {
            f(wc + half * kn + (size_t)kc * N8 + c0, (const bf16*)nullptr, N8, kw, w, part);
          } else {
            const bf16* kr = wc + 2 * half * kn + (size_t)kc * N8 + c0;
            f(kr, kr + kn, N8, kw, w, part);
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
  __host__ __device__ void operator()(const bf16*, const bf16*, int, int, int, int part) {
    ++n;
    if (part + 1 > parts) parts = part + 1;
  }
};

struct SegWriter {
  Seg* segs;
  int n = 0;
  __device__ void operator()(const bf16* s0, const bf16* s1, int ld, int rows, int cols, int part) {
    segs[n++] = Seg{s0, s1, ld, rows, cols, mma::odd_stride(cols), slice_rows(cols, s1 != nullptr), part};
  }
};

// A block's work: `whole` tiles (every part), then units of the tiles left
// over, each unit one column pass of one half (32 edges) of a tile, with the
// trunk, which every unit makes again (the f32 kernel's schedule). Lives in
// shared memory with the ring's cursor: thread 0 advances the cursor, double
// buffered by slice parity.
constexpr int kUnitEdges = kTE / 2;

struct Sched {
  int whole, first_left, units, blocks, parts, b, n_items;
  int seg[2], piece[2], item[2];  // the next slice to issue: segment, row piece, work item
  unsigned mask[2];               // ... and that item's parts

  __device__ void init(long long E, int blocks_, int parts_, int b_) {
    const int tiles = (int)((E + kTE - 1) / kTE);
    blocks = blocks_, parts = parts_, b = b_;
    whole = tiles / blocks;
    first_left = whole * blocks;
    units = (int)((E - (long long)first_left * kTE + kUnitEdges - 1) / kUnitEdges) * parts;  // non-empty halves
    n_items = whole + (units > b ? (units - b + blocks - 1) / blocks : 0);
  }
  __device__ int first_edge(int i) const {
    return i < whole ? (b * whole + i) * kTE : first_left * kTE + (b + (i - whole) * blocks) / parts * kUnitEdges;
  }
  __device__ int max_edges(int i) const { return i < whole ? kTE : kUnitEdges; }
  __device__ unsigned parts_of(int i) const { return i < whole ? ~0u : 1u << ((b + (i - whole) * blocks) % parts); }
};

// The dynamic shared memory (laid out by set_layout), and the launch's
// arguments and schedule, which every device function reads from shared
// memory rather than holding pointers to them in registers.
extern __shared__ uint4 smem16[];
__shared__ Args a_s;
__shared__ Sched sc_s;

template <typename T = bf16>
__device__ __forceinline__ T* sm(int off) {
  return reinterpret_cast<T*>(reinterpret_cast<char*>(smem16) + off);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(mma::smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x cols bf16 (cols a multiple of 8) from src (row stride ld) to dst
// (row stride sld), 16 bytes a copy; thread t copies chunks t, t + 256, ...
// of the row-major slice.
__device__ __forceinline__ void copy_slice(bf16* dst, int sld, const bf16* src, int ld, int rows, int cols) {
  const int w = cols / 8;
  const int dr = kThreads / w, dc = kThreads - dr * w;
  int r = threadIdx.x / w, c = threadIdx.x - r * w;
  for (; r < rows; r += dr) {
    cp_async16(dst + r * sld + 8 * c, src + (size_t)r * ld + 8 * c);
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// The ring (the f32 kernel's): slice q lives in slot q % kStages; thread 0
// moves the cursor, skipping the segments of parts the work item does not
// take; the barrier of each acquire orders that write before the next issue.
struct Ring {
  int q = 0;  // next slice to consume

  // (seg, piece, item, mask) moved to the next selected slice
  __device__ void advance(int& seg, int& piece, int& item, unsigned& mask, bool step) const {
    const Seg* segs = sm<Seg>(a_s.off_segs);
    if (step && ++piece * segs[seg].sr < segs[seg].rows) return;
    if (step) {
      piece = 0;
      ++seg;
    }
    for (;;) {
      if (seg == a_s.n_seg) {  // the next item streams the same weights
        seg = 0;
        if (++item < sc_s.n_items) mask = sc_s.parts_of(item);
      }
      if (item >= sc_s.n_items || segs[seg].part < 0 || ((mask >> segs[seg].part) & 1u)) return;
      ++seg;
    }
  }
  __device__ void issue(int slot, int cur) {
    const int item = sc_s.item[cur];
    if (item < sc_s.n_items) {
      const Seg& s = sm<Seg>(a_s.off_segs)[sc_s.seg[cur]];
      const int r0 = sc_s.piece[cur] * s.sr, rows = imin(s.sr, s.rows - r0);
      bf16* dst = sm(slot * kSlot * 2);
      copy_slice(dst, s.sld, s.src0 + (size_t)r0 * s.ld, s.ld, rows, s.cols);
      if (s.src1 != nullptr) copy_slice(dst + s.sr * s.sld, s.sld, s.src1 + (size_t)r0 * s.ld, s.ld, rows, s.cols);
      if (threadIdx.x == 0) {
        int seg = sc_s.seg[cur], piece = sc_s.piece[cur], it = item;
        unsigned mask = sc_s.mask[cur];
        advance(seg, piece, it, mask, true);
        sc_s.seg[cur ^ 1] = seg, sc_s.piece[cur ^ 1] = piece, sc_s.item[cur ^ 1] = it, sc_s.mask[cur ^ 1] = mask;
      }
    } else if (threadIdx.x == 0) {
      sc_s.item[cur ^ 1] = item;
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  }
  __device__ void prologue() {
    if (threadIdx.x == 0) {
      int seg = 0, piece = 0, item = 0;
      unsigned mask = sc_s.n_items > 0 ? sc_s.parts_of(0) : 0u;
      if (sc_s.n_items > 0) advance(seg, piece, item, mask, false);
      sc_s.seg[0] = seg, sc_s.piece[0] = piece, sc_s.item[0] = item, sc_s.mask[0] = mask;
    }
    for (int s = 0; s < kStages - 1; ++s) {
      __syncthreads();
      issue(s, s & 1);
    }
  }
  // Slice q's slot, once every thread's copy of it has landed and every
  // thread is done with slice q - 1 (whose slot then takes slice q + 2);
  // before that issue, first() issues the copies that are needed sooner
  // (as their own commit group).
  template <class F>
  __device__ const bf16* acquire(F&& first) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    first();
    issue((q + kStages - 1) % kStages, q & 1);
    return sm((q++ % kStages) * kSlot * 2);
  }
  __device__ const bf16* acquire() {
    return acquire([] {});
  }
};

// acc[mt][j] += A[16 mt .., acol0 + 16 ks ..] W[16 ks .., 8 (warp + 8 j) ..]
// over the k steps ks < nks whose bit is set in kmask, for the m16 tiles mt <
// mts and this warp's n8 tiles below ncols. A: bf16 [64][as]; W: the slice,
// bf16 [rows][sld].
template <int NJ>
__device__ __forceinline__ void mma_slice(float (&acc)[4][NJ][4], const bf16* A, int as, int acol0, const bf16* W,
                                          int sld, int nks, int ncols, int mts, unsigned kmask = ~0u) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t a_base = mma::smem_addr(A + (lane % 16) * as + acol0 + 8 * (lane / 16));
  const uint32_t w_base = mma::smem_addr(W + (lane % 16) * sld);
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    if (!((kmask >> ks) & 1u)) continue;
    uint32_t b[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int n_lo = 8 * (warp + 8 * j);
      if (n_lo >= ncols) continue;
      if (j + 1 < NJ) {
        const int n_hi = 8 * (warp + 8 * (j + 1));
        const int n = lane < 16 || n_hi >= ncols ? n_lo : n_hi;
        uint32_t r4[4];
        mma::ldsm_x4_trans(r4, w_base + 2 * (16 * ks * sld + n));
        b[j][0] = r4[0], b[j][1] = r4[1], b[j + 1][0] = r4[2], b[j + 1][1] = r4[3];
      } else {
        mma::ldsm_x2_trans(b[j], w_base + 2 * (16 * ks * sld + n_lo));
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mts) break;
      uint32_t a[4];
      mma::ldsm_x4(a, a_base + 2 * (16 * mt * as + 16 * ks));
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (8 * (warp + 8 * j) < ncols) mma::mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
      }
    }
  }
}

// The |m| > 0 pair over one slice: yp += XP KR - XN KI, yn += XP KI + XN KR.
template <int NJ>
__device__ __forceinline__ void pair_slice(float (&yp)[4][NJ][4], float (&yn)[4][NJ][4], const bf16* XP,
                                           const bf16* XN, int as, int acol0, const bf16* KR, const bf16* KI, int sld,
                                           int nks, int ncols, int mts) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a_off = (lane % 16) * as + acol0 + 8 * (lane / 16);
  const uint32_t p_base = mma::smem_addr(XP + a_off), n_base = mma::smem_addr(XN + a_off);
  const uint32_t r_base = mma::smem_addr(KR + (lane % 16) * sld), i_base = mma::smem_addr(KI + (lane % 16) * sld);
#pragma unroll 1
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t br[NJ][2], bi[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int n_lo = 8 * (warp + 8 * j);
      if (n_lo >= ncols) continue;
      if (j + 1 < NJ) {
        const int n_hi = 8 * (warp + 8 * (j + 1));
        const int n = lane < 16 || n_hi >= ncols ? n_lo : n_hi;
        uint32_t r4[4];
        mma::ldsm_x4_trans(r4, r_base + 2 * (16 * ks * sld + n));
        br[j][0] = r4[0], br[j][1] = r4[1], br[j + 1][0] = r4[2], br[j + 1][1] = r4[3];
        mma::ldsm_x4_trans(r4, i_base + 2 * (16 * ks * sld + n));
        bi[j][0] = r4[0], bi[j][1] = r4[1], bi[j + 1][0] = r4[2], bi[j + 1][1] = r4[3];
      } else {
        mma::ldsm_x2_trans(br[j], r_base + 2 * (16 * ks * sld + n_lo));
        mma::ldsm_x2_trans(bi[j], i_base + 2 * (16 * ks * sld + n_lo));
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      if (mt >= mts) break;
      uint32_t p[4], n[4], nn[4];
      mma::ldsm_x4(p, p_base + 2 * (16 * mt * as + 16 * ks));
      mma::ldsm_x4(n, n_base + 2 * (16 * mt * as + 16 * ks));
#pragma unroll
      for (int i = 0; i < 4; ++i) nn[i] = mma::neg_bf16x2(n[i]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (8 * (warp + 8 * j) >= ncols) continue;
        mma::mma_bf16(yp[mt][j], p, br[j][0], br[j][1]);
        mma::mma_bf16(yp[mt][j], nn, bi[j][0], bi[j][1]);
        mma::mma_bf16(yn[mt][j], p, bi[j][0], bi[j][1]);
        mma::mma_bf16(yn[mt][j], n, br[j][0], br[j][1]);
      }
    }
  }
}

// acc = bias[col] (0 past n or for a null bias) at this warp's C fragment columns
template <int NJ>
__device__ __forceinline__ void init_acc(float (&acc)[4][NJ][4], const float* __restrict__ bias, int n) {
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = 8 * (warp + 8 * j) + 2 * t;
    const float v0 = bias != nullptr && col < n ? __ldg(bias + col) : 0.f;
    const float v1 = bias != nullptr && col + 1 < n ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) acc[mt][j][0] = acc[mt][j][2] = v0, acc[mt][j][1] = acc[mt][j][3] = v1;
  }
}

// Calls f(edge, col, v0, v1) for each pair of this warp's C fragment values
// (columns col, col + 1) at edges < ne and columns < n.
template <int NJ, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[4][NJ][4], int ne, int n, F&& f) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = 8 * (warp + 8 * j) + 2 * t;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 16 * mt + g + 8 * h;
        if (e < ne) f(e, col, acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
      }
    }
}

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// Y[e][h] = bf16(silu(LN(F[e][.])[h] * scale[h] + bias[h])) over h < H for
// the tile's 64 edges; four threads an edge (the f32 kernel's arithmetic).
__device__ __forceinline__ void ln_silu(const float* F, int fs, bf16* Y, int ys, int H, const float* __restrict__ scale,
                                        const float* __restrict__ bias) {
  const int e = threadIdx.x / 4, part = threadIdx.x % 4;
  const float* src = F + e * fs;
  float s = 0.f;
  for (int h = part; h < H; h += 4) s += src[h];
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mu = s / H;
  float v = 0.f;
  for (int h = part; h < H; h += 4) {
    const float t = src[h] - mu;
    v += t * t;
  }
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  const float inv = rsqrtf(v / H + 1e-6f);
  for (int h = part; h < H; h += 4) {
    Y[e * ys + h] = __float2bfloat16_rn(silu((src[h] - mu) * inv * __ldg(scale + h) + __ldg(bias + h)));
  }
}

struct Tile {
  Ring* ring;
  int e0;   // the item's first edge
  int ne;   // edges in this item
  int mts;  // m16 tiles holding them
};

// The chunk's message rows into X (xp: columns kc .. kc + kw of the +m
// rows) and, for a pair (neg_off > 0, the -m rows' offset), XN: 16-byte
// cp.async copies of whole rows, one commit group; columns past kv (the
// m-block's padding) are zeros, and messages whose rows or columns are not
// 16-byte aligned (C % 8 != 0) are copied 2 bytes at a time.
__device__ __forceinline__ void load_messages(const Tile& t, const bf16* msg, int kw, int kv, int neg_off) {
  const Args& a = a_s;
  const int c8s = kw / 8, items = t.ne * c8s;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int e = i / c8s, k0 = 8 * (i - e * c8s);
    bf16* xp = sm(a.off_u) + e * a.xs + k0;
    bf16* xn = sm(a.off_xn) + e * a.xs + k0;
    const bf16* row = msg + (size_t)(t.e0 + e) * a.msg_ld + k0;
    if (a.msg_vec && k0 + 8 <= kv) {
      cp_async16(xp, row);
      if (neg_off > 0) cp_async16(xn, row + neg_off);
    } else {
      uint32_t w[4] = {0, 0, 0, 0}, wn[4] = {0, 0, 0, 0};
      for (int c = 0; c < 8 && k0 + c < kv; ++c) {
        const unsigned short* p = reinterpret_cast<const unsigned short*>(row + c);
        w[c / 2] |= (uint32_t)__ldg(p) << (16 * (c % 2));
        if (neg_off > 0) wn[c / 2] |= (uint32_t)__ldg(p + neg_off) << (16 * (c % 2));
      }
      *reinterpret_cast<uint4*>(xp) = make_uint4(w[0], w[1], w[2], w[3]);
      if (neg_off > 0) *reinterpret_cast<uint4*>(xn) = make_uint4(wn[0], wn[1], wn[2], wn[3]);
    }
  }
  cp_async_commit();
}

// One chunk of gates (columns kc .. kc + kw of the half's m-block gates,
// which start at gate column gcol0) times the chunk's message rows, into X
// (xp) and, for a pair, XN (xn); kreal: the m-block's message columns. The
// messages are copied in while the gates are made; each thread then rounds
// its own gate fragments and multiplies them into X and XN in place, so the
// gates never reach shared memory.
__device__ __forceinline__ void gated_chunk(Tile& t, int gcol0, const bf16* msg_half, int kc, int kw, int msg_col,
                                            int neg_off, int kreal) {
  const Args& a = a_s;
  float g[4][2][4];
  init_acc<2>(g, a.b2 + gcol0 + kc, kw);
  const int sld = mma::odd_stride(kw), sr = slice_rows(kw, false), slices = cdiv(a.Hp, sr);
  for (int s = 0; s < slices; ++s) {
    // X is free after the first barrier (every thread passed it after its
    // last read of X): the messages are copied before that slice's weights
    const bf16* W = s > 0 ? t.ring->acquire() : t.ring->acquire([&] {
      load_messages(t, msg_half + msg_col + kc, kw, imin(kw, kreal - kc), neg_off);
    });
    mma_slice<2>(g, sm(a.off_y), a.ys, s * sr, W, sld, imin(sr, a.Hp - s * sr) / 16, kw, t.mts);
  }
  cp_async_wait<1>();  // the message group: a ring slice was committed after it
  __syncthreads();
  for_each_pair<2>(g, t.ne, kw, [&](int e, int col, float v0, float v1) {
    const float2 gv = mma::unpack_bf16x2(mma::pack_bf16x2(v0, v1));  // the gates, rounded
    uint32_t* xp = reinterpret_cast<uint32_t*>(sm(a.off_u) + e * a.xs + col);
    const float2 mp = mma::unpack_bf16x2(*xp);
    *xp = mma::pack_bf16x2(gv.x * mp.x, gv.y * mp.y);
    if (neg_off > 0) {
      uint32_t* xn = reinterpret_cast<uint32_t*>(sm(a.off_xn) + e * a.xs + col);
      const float2 mn = mma::unpack_bf16x2(*xn);
      *xn = mma::pack_bf16x2(gv.x * mn.x, gv.y * mn.y);
    }
  });
}

// bf16 pair (v0, v1) to dst[0], dst[1]: one 4-byte store where aligned
__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1, bool two, bool vec) {
  if (two && vec) {
    *reinterpret_cast<uint32_t*>(dst) = mma::pack_bf16x2(v0, v1);
  } else {
    dst[0] = __float2bfloat16_rn(v0);
    if (two) dst[1] = __float2bfloat16_rn(v1);
  }
}

// One m0 column pass (columns c0 .. c0 + w of [extra | h_m0], w padded to 8)
// over both halves.
template <int NJ>
__device__ __noinline__ void m0_pass(Tile& t, int c0, int w) {
  const Args& a = a_s;
  const int N = group_cols(a, 0), K = a.kp[0], wreal = imin(w, N - c0);
  float acc[4][NJ][4];
  init_acc<NJ>(acc, a.bm0 + c0, wreal);
  const int sld = mma::odd_stride(w), sr = slice_rows(w, false);
  for (int half = 0; half < 2; ++half) {
    for (int kc = 0; kc < K; kc += kKC) {
      const int kw = imin(kKC, K - kc);
      gated_chunk(t, half * (a.NGp / 2), half ? a.msg_t : a.msg_s, kc, kw, 0, 0, a.nb[0] * a.C);
      for (int s = 0; s * sr < kw; ++s) {
        const bf16* W = t.ring->acquire();
        mma_slice<NJ>(acc, sm(a.off_u), a.xs, s * sr, W, sld, imin(sr, kw - s * sr) / 16, w, t.mts);
      }
    }
  }
  for_each_pair<NJ>(acc, t.ne, wreal, [&](int e, int col, float v0, float v1) {
    const int oc = c0 + col;
    const bool two = col + 1 < wreal;
    if (oc + 1 < a.X || (!two && oc < a.X)) {
      store_pair(a.extra_out + (size_t)(t.e0 + e) * a.X + oc, v0, v1, two, a.out_vec);
    } else if (oc >= a.X) {
      store_pair(a.h_out + (size_t)(t.e0 + e) * a.h_ld + (oc - a.X), v0, v1, two, a.out_vec);
    } else {  // the pair straddles extra | h
      a.extra_out[(size_t)(t.e0 + e) * a.X + oc] = __float2bfloat16_rn(v0);
      a.h_out[(size_t)(t.e0 + e) * a.h_ld] = __float2bfloat16_rn(v1);
    }
  });
}

// One |m| > 0 column pass (columns c0 .. c0 + w of the block's yp and yn, w
// padded to 8) over both halves; the block's +m rows start at message row row0.
template <int NJ>
__device__ __noinline__ void pair_pass(Tile& t, int g, int row0, int goff, int c0, int w) {
  const Args& a = a_s;
  const int nb = a.nb[g], K = a.kp[g], wreal = imin(w, group_cols(a, g) - c0);
  float yp[4][NJ][4], yn[4][NJ][4];
  init_acc<NJ>(yp, nullptr, 0);
  init_acc<NJ>(yn, nullptr, 0);
  const int sld = mma::odd_stride(w), sr = slice_rows(w, true);
  for (int half = 0; half < 2; ++half) {
    for (int kc = 0; kc < K; kc += kKC) {
      const int kw = imin(kKC, K - kc);
      gated_chunk(t, half * (a.NGp / 2) + goff, half ? a.msg_t : a.msg_s, kc, kw, row0 * a.C, nb * a.C,
                  nb * a.C);
      for (int s = 0; s * sr < kw; ++s) {
        const bf16* W = t.ring->acquire();
        pair_slice<NJ>(yp, yn, sm(a.off_u), sm(a.off_xn), a.xs, s * sr, W, W + sr * sld, sld,
                       imin(sr, kw - s * sr) / 16, w, t.mts);
      }
    }
  }
  bf16* out = a.h_out + (size_t)t.e0 * a.h_ld + c0;
  for_each_pair<NJ>(yp, t.ne, wreal, [&](int e, int col, float v0, float v1) {
    store_pair(out + (size_t)e * a.h_ld + (size_t)row0 * a.CO + col, v0, v1, col + 1 < wreal, a.out_vec);
  });
  for_each_pair<NJ>(yn, t.ne, wreal, [&](int e, int col, float v0, float v1) {
    store_pair(out + (size_t)e * a.h_ld + (size_t)(row0 + nb) * a.CO + col, v0, v1, col + 1 < wreal, a.out_vec);
  });
}

// The dynamic shared memory (byte offsets), the same in the kernel and ops/
// kernels.py::attn_conv1_bf16_plan: the ring, Y [64][ys], Es and Et
// [64][es], the region U (F f32 [64][fs] during the trunk, X and XN [64][xs]
// during the passes), G [64][gs], the distances and mask [64] f32 each, the
// warps' zero-step votes [8] int, the segment table.
void set_layout(Args& a) {
  const int x_bytes = 2 * kTE * a.xs * 2, f_bytes = kTE * a.fs * 4;
  a.off_y = kStages * kSlot * 2;
  a.off_es = a.off_y + kTE * a.ys * 2;
  a.off_et = a.off_es + kTE * a.es * 2;
  a.off_u = a.off_et + kTE * a.es * 2;
  a.off_xn = a.off_u + kTE * a.xs * 2;
  a.off_g = a.off_u + round_up(x_bytes > f_bytes ? x_bytes : f_bytes, 16);
  a.off_d = a.off_g + kTE * a.gs * 2;
  a.off_m = a.off_d + kTE * 4;
  a.off_nz = a.off_m + kTE * 4;
  a.off_segs = a.off_nz + 8 * 4;
  a.smem_bytes = a.off_segs + a.n_seg * (int)sizeof(Seg);
}

__global__ void __launch_bounds__(kThreads, 1) eqv2_attn_conv1_bf16_kernel(const Args args) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    a_s = args;
    SegWriter w{sm<Seg>(args.off_segs)};
    for_each_segment(args, w);
    sc_s.init(args.E, gridDim.x, args.n_parts, blockIdx.x);
  }
  // Y, Es and Et are contiguous: zero them once, so the columns past H and Ed
  // (k padding the products read) stay 0
  for (int i = tid; i < (args.off_u - args.off_y) / 16; i += kThreads) {
    sm<uint4>(args.off_y)[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  const Args& a = a_s;

  Ring ring;
  ring.prologue();

  Tile t;
  t.ring = &ring;
  for (int item = 0; item < sc_s.n_items; ++item) {
    const unsigned parts = sc_s.parts_of(item);
    t.e0 = sc_s.first_edge(item);
    t.ne = (int)(a.E - t.e0 < sc_s.max_edges(item) ? a.E - t.e0 : sc_s.max_edges(item));
    t.mts = cdiv(t.ne, 16);
    bf16 *Y = sm(a.off_y), *Es = sm(a.off_es), *Et = sm(a.off_et), *G = sm(a.off_g);
    float *F = sm<float>(a.off_u), *d_s = sm<float>(a.off_d), *m_s = sm<float>(a.off_m);
    int* nzw = sm<int>(a.off_nz);

    // 1. stage the tile's distances, mask and embeddings (bf16, [edge][j])
    __syncthreads();  // the previous item is done with Es, Et, X, d_s and m_s
    if (tid < kTE) {
      d_s[tid] = tid < t.ne ? a.dist[t.e0 + tid] : 0.f;
      m_s[tid] = (tid < t.ne && a.mask[t.e0 + tid]) ? 1.f : 0.f;
    }
    for (int i = tid; i < kTE * a.Ed; i += kThreads) {
      const int e = i / a.Ed, j = i - e * a.Ed;
      const bool ok = e < t.ne;
      Es[e * a.es + j] = __float2bfloat16_rn(ok ? __ldg(a.emb_s + (size_t)(t.e0 + e) * a.Ed + j) : 0.f);
      Et[e * a.es + j] = __float2bfloat16_rn(ok ? __ldg(a.emb_t + (size_t)(t.e0 + e) * a.Ed + j) : 0.f);
    }
    __syncthreads();

    // 2. trunk layer 0: gauss @ wg + es @ ws + et @ wt + b0 -> F, then LN + SiLU -> Y
    for (int hc = 0; hc < a.H8; hc += kTrunkN) {
      const int hw = imin(kTrunkN, a.H8 - hc), sld = mma::odd_stride(hw), sr = slice_rows(hw, false);
      float acc[4][2][4];
      init_acc<2>(acc, a.b0 + hc, a.H - hc);
      for (int s = 0; s * sr < a.Rp; ++s) {
        const bf16* W = ring.acquire();  // also: every thread is done with the last slice's G and votes
        const int r0 = s * sr, rows = imin(sr, a.Rp - r0);
        // thread (edge tid % 64, 16-row step tid / 64) makes 16 values: 32 bytes of G's row
        const int e = tid % kTE, st = tid / kTE;
        bool nz = false;
        if (16 * st < rows) {
          uint32_t w[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            float v[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 16 * st + 2 * u + h;
              v[h] = 0.f;
              if (r < a.R && e < t.ne) {
                const float d = d_s[e] - (float)r * a.delta;
                v[h] = expf(a.coeff * (d * d)) * m_s[e];
              }
            }
            w[u] = mma::pack_bf16x2(v[0], v[1]);
            nz |= (w[u] & 0x7fff7fffu) != 0;
          }
          uint4* dst = reinterpret_cast<uint4*>(G + e * a.gs + 16 * st);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
        const bool any = __any_sync(0xffffffffu, nz);
        if (lane == 0) nzw[warp] = any;
        __syncthreads();
        unsigned kmask = 0;  // step k: warps 2 k and 2 k + 1
#pragma unroll
        for (int k = 0; k < kMaxSliceRows / 16; ++k) kmask |= (nzw[2 * k] | nzw[2 * k + 1]) ? 1u << k : 0u;
        mma_slice<2>(acc, G, a.gs, 0, W, sld, rows / 16, hw, t.mts, kmask);
      }
      for (int s = 0; s * sr < a.Edp; ++s) {
        const bf16* W = ring.acquire();
        mma_slice<2>(acc, Es, a.es, s * sr, W, sld, imin(sr, a.Edp - s * sr) / 16, hw, t.mts);
      }
      for (int s = 0; s * sr < a.Edp; ++s) {
        const bf16* W = ring.acquire();
        mma_slice<2>(acc, Et, a.es, s * sr, W, sld, imin(sr, a.Edp - s * sr) / 16, hw, t.mts);
      }
      for_each_pair<2>(acc, kTE, imin(hw, a.H - hc), [&](int e, int col, float v0, float v1) {
        F[e * a.fs + hc + col] = v0;
        if (hc + col + 1 < a.H) F[e * a.fs + hc + col + 1] = v1;
      });
    }
    __syncthreads();
    ln_silu(F, a.fs, Y, a.ys, a.H, a.ln0s, a.ln0b);

    // 3. trunk layer 1: y0 @ w1 + b1 -> F, then LN + SiLU -> Y (y1)
    for (int hc = 0; hc < a.H8; hc += kTrunkN) {
      const int hw = imin(kTrunkN, a.H8 - hc), sld = mma::odd_stride(hw), sr = slice_rows(hw, false);
      float acc[4][2][4];
      init_acc<2>(acc, a.b1 + hc, a.H - hc);
      for (int s = 0; s * sr < a.Hp; ++s) {
        const bf16* W = ring.acquire();  // the first one also orders layer 0's LN before these reads
        mma_slice<2>(acc, Y, a.ys, s * sr, W, sld, imin(sr, a.Hp - s * sr) / 16, hw, t.mts);
      }
      for_each_pair<2>(acc, kTE, imin(hw, a.H - hc), [&](int e, int col, float v0, float v1) {
        F[e * a.fs + hc + col] = v0;
        if (hc + col + 1 < a.H) F[e * a.fs + hc + col + 1] = v1;
      });
    }
    __syncthreads();
    ln_silu(F, a.fs, Y, a.ys, a.H, a.ln1s, a.ln1b);  // (the next acquire barrier orders this before Y is read)

    // 4. the item's m-block column passes: gates, gated messages, conv products
    int row0 = 0, goff = 0, part = 0;
    for (int g = 0; g < a.n_groups; ++g) {
      const int N = group_cols(a, g), N8 = round_up(N, 8), tn = group_pass(a, g);
      for (int c0 = 0; c0 < N; c0 += tn, ++part) {
        if (!((parts >> part) & 1u)) continue;
        const int w = imin(tn, N8 - c0);
        if (g == 0) {
          m0_pass<kM0NJ>(t, c0, w);
        } else {
          switch (tn / 64) {
            case 1: pair_pass<1>(t, g, row0, goff, c0, w); break;
            case 2: pair_pass<2>(t, g, row0, goff, c0, w); break;
            default: pair_pass<3>(t, g, row0, goff, c0, w); break;
          }
        }
      }
      row0 += g == 0 ? a.nb[g] : 2 * a.nb[g];
      goff += a.kp[g];
    }
  }
  cp_async_wait<0>();
}

int launch(const void* dist, const void* mask, const void* emb_s, const void* emb_t, const void* msg_s,
           const void* msg_t, const void* wg, const void* ws, const void* wt, const void* w1, const void* w2,
           const void* wconv, const void* b0, const void* ln0s, const void* ln0b, const void* b1, const void* ln1s,
           const void* ln1b, const void* b2, const void* bm0, void* extra_out, void* h_out, long long E,
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
  a.msg_s = static_cast<const bf16*>(msg_s);
  a.msg_t = static_cast<const bf16*>(msg_t);
  a.wg = static_cast<const bf16*>(wg);
  a.ws = static_cast<const bf16*>(ws);
  a.wt = static_cast<const bf16*>(wt);
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.wconv = static_cast<const bf16*>(wconv);
  a.b0 = static_cast<const float*>(b0);
  a.ln0s = static_cast<const float*>(ln0s);
  a.ln0b = static_cast<const float*>(ln0b);
  a.b1 = static_cast<const float*>(b1);
  a.ln1s = static_cast<const float*>(ln1s);
  a.ln1b = static_cast<const float*>(ln1b);
  a.b2 = static_cast<const float*>(b2);
  a.bm0 = static_cast<const float*>(bm0);
  a.extra_out = static_cast<bf16*>(extra_out);
  a.h_out = static_cast<bf16*>(h_out);
  a.E = E;
  a.R = num_gauss;
  a.Ed = emb_dim;
  a.H = hidden;
  a.C = c_in;
  a.CO = c_out;
  a.X = extra;
  a.n_groups = n_groups;
  int na = 0, ngp = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    a.nb[g] = g < n_groups ? n_blocks[g] : 0;
    a.kp[g] = round_up(a.nb[g] * c_in, 16);
    na += g == 0 ? a.nb[g] : 2 * a.nb[g];
    ngp += 2 * a.kp[g];
  }
  a.NGp = ngp;
  a.Rp = round_up(num_gauss, 16);
  a.Edp = round_up(emb_dim, 16);
  a.Hp = round_up(hidden, 16);
  a.H8 = round_up(hidden, 8);
  a.msg_ld = (long long)na * c_in;
  a.h_ld = (long long)na * c_out;
  a.msg_vec = c_in % 8 == 0 && (reinterpret_cast<uintptr_t>(msg_s) & 15) == 0 &&
              (reinterpret_cast<uintptr_t>(msg_t) & 15) == 0;
  a.out_vec = extra % 2 == 0 && c_out % 2 == 0 && (reinterpret_cast<uintptr_t>(extra_out) & 3) == 0 &&
              (reinterpret_cast<uintptr_t>(h_out) & 3) == 0;
  // as the plain version: both constants in double, then rounded to f32
  const double delta = (double)cutoff / (num_gauss - 1);
  a.delta = (float)delta;
  a.coeff = (float)(-0.5 / ((width_scalar * delta) * (width_scalar * delta)));
  a.ys = mma::odd_stride(a.Hp);
  a.es = mma::odd_stride(a.Edp);
  a.xs = mma::odd_stride(kKC);
  a.gs = mma::odd_stride(kMaxSliceRows);
  a.fs = round_up(hidden, 32) + 4;  // four threads an edge read rows 4 banks apart
  SegCounter count;
  for_each_segment(a, count);
  a.n_seg = count.n;
  a.n_parts = count.parts;
  if (a.n_parts > kMaxParts) return (int)cudaErrorInvalidValue;
  set_layout(a);
  if (a.smem_bytes != smem_bytes) return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees
  cudaError_t err =
      cudaFuncSetAttribute(eqv2_attn_conv1_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  eqv2_attn_conv1_bf16_kernel<<<(unsigned)blocks, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Device pointers of contiguous
// tensors: dist [E] f32; mask [E] bool (uint8); emb_s, emb_t [E, Ed] f32;
// msg_s, msg_t [E, NA * C] bf16 (truncated m-primary rows, n-major, channel
// inner); the bf16 matrices of ops/kernels.py::pack_attn_conv1_mma, zero
// padded (Rp, Edp, Hp: R, Ed, H rounded up to 16; kp_g = nb_g C rounded up to
// 16; widths rounded up to 8): wg [Rp, H8], ws, wt [Edp, H8], w1 [Hp, H8], w2
// [Hp, 2 sum kp] (gate columns [s-half | t-half], each half per m-block
// kp_g columns), wconv (km0_s, km0_t [kp_0, extra + nb0 c_out rounded to 8],
// then per |m| block kr_s, ki_s, kr_t, ki_t [kp_g, nb_g c_out rounded to 8]);
// the f32 vectors (bf16 values) b0, ln0s, ln0b, b1, ln1s, ln1b [H], b2 [2 sum
// kp], bm0 [extra + nb0 c_out]; extra_out [E, extra] and h_out [E, NA c_out]
// bf16 are written. n_blocks: host array of the rows per m-block (n_groups <=
// 8). `blocks` and `smem_bytes` come from the wrapper's plan (ops/
// kernels.py::attn_conv1_bf16_plan); a shared-memory size that disagrees
// with this kernel's layout is refused with cudaErrorInvalidValue. Launches
// on `stream` and returns cudaGetLastError() after the launch.
extern "C" int eqv2_attn_conv1_bf16_mma(const void* dist, const void* mask, const void* emb_s, const void* emb_t,
                                        const void* msg_s, const void* msg_t, const void* wg, const void* ws,
                                        const void* wt, const void* w1, const void* w2, const void* wconv,
                                        const void* b0, const void* ln0s, const void* ln0b, const void* b1,
                                        const void* ln1s, const void* ln1b, const void* b2, const void* bm0,
                                        void* extra_out, void* h_out, long long E, int num_gauss, int emb_dim,
                                        int hidden, int c_in, int c_out, int extra, const int* n_blocks,
                                        int n_groups, float cutoff, float width_scalar, int blocks, int smem_bytes,
                                        void* stream) {
  return launch(dist, mask, emb_s, emb_t, msg_s, msg_t, wg, ws, wt, w1, w2, wconv, b0, ln0s, ln0b, b1, ln1s, ln1b, b2,
                bm0, extra_out, h_out, E, num_gauss, emb_dim, hidden, c_in, c_out, extra, n_blocks, n_groups, cutoff,
                width_scalar, blocks, smem_bytes, stream);
}

extern "C" const char* eqv2_attn_conv1_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
