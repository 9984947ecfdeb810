// EquiformerV2 attention front half, fused, for Hopper (sm_90a), f32:
// gaussian distance basis -> radial trunk -> per-m gates -> gated first SO(2)
// convolution over the separate source and target message halves.
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
// 6.61 MFLOP (trunk 1.04, m0 2.29, m+-1 2.10, m+-2 1.18): 169 GFLOP, 2.5 ms of
// f32 FMAs at 67 TFLOP/s. It moves ~0.72 GB (the two message halves, 0.50 GB;
// the outputs, 0.18 GB; the embeddings and the weights), 0.21 ms at 3.35
// TB/s. So operations set the bound.
//
// The design: one block of 256 threads per tile of 16 edges, two blocks per SM
// (at most 128 registers a thread; with one block of 255-register threads per
// SM the weight loads' latency went unhidden and the kernel took 1.5x as
// long). The gaussian basis (in 32-row chunks, a chunk skipped when it is zero
// for the whole tile), both trunk activations and the gates stay in shared
// memory; none of them reaches device memory. The gates ([E, 3072] f32, 12 KB
// per edge) are made one (m-block, half) slice at a time: y1 @ w2[:, slice] +
// b2, with 1 to 3 gate columns per thread so that one pass covers the slice,
// multiplies the slice's message rows (read straight from the flattened
// n-major [E, NA * C] layout) into shared memory, and that block's conv product
// consumes them into register accumulators (16 edges x 2 columns per thread
// for the m0 output of 896 columns, both halves' gated rows held at once; 16
// edges x (yp, yn) for |m| > 0). Weights are read from device memory through
// L2 (each tile reads all of them once), coalesced across a warp's columns;
// the activations are read from shared memory as float4 broadcasts. Padded
// edges (mask 0) get outputs like any other: their gaussian rows are 0 and the
// attention zeroes them later. Not yet used: tensor cores (every product here
// is a [16, K] x [K, N] GEMM tile), cp.async or TMA staging of the weights
// (their L2 latency is what the second block per SM hides), larger edge
// tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTE = 16;        // edges per block
constexpr int kRC = 32;        // gaussian rows per chunk
constexpr int kMaxGroups = 8;  // m-blocks (mmax + 1)
constexpr int kTrunkCols = kThreads / 2;  // trunk: two groups of 8 edges x 128 columns

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
  int Hp, Edp, Kp;  // padded row strides in shared memory (multiples of 4)
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// acc[e][c] += sum_k A[e][k] W[k][col0 + c * kThreads] for the columns below
// ncol. A: NE rows of shared memory with stride lda (a multiple of 4); W:
// device memory, row stride ldw.
template <int NE, int NC>
__device__ __forceinline__ void gemm_acc(float (&acc)[NE][NC], const float* A, int lda, int K,
                                         const float* __restrict__ W, int ldw, int col0, int ncol) {
  bool ok[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ok[c] = col0 + c * kThreads < ncol;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float w[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) w[i][c] = ok[c] ? __ldg(W + (size_t)(k + i) * ldw + col0 + c * kThreads) : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(A + e * lda + k);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[e][c] = fmaf(a.x, w[0][c], acc[e][c]);
        acc[e][c] = fmaf(a.y, w[1][c], acc[e][c]);
        acc[e][c] = fmaf(a.z, w[2][c], acc[e][c]);
        acc[e][c] = fmaf(a.w, w[3][c], acc[e][c]);
      }
    }
  }
  for (; k < K; ++k) {
    float w[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) w[c] = ok[c] ? __ldg(W + (size_t)k * ldw + col0 + c * kThreads) : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const float a = A[e * lda + k];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[e][c] = fmaf(a, w[c], acc[e][c]);
    }
  }
}

// The |m| > 0 pair: yp[e] += sum_k XP[e][k] KR[k][col] - XN[e][k] KI[k][col],
//                   yn[e] += sum_k XP[e][k] KI[k][col] + XN[e][k] KR[k][col].
__device__ __forceinline__ void pair_acc(float (&yp)[kTE], float (&yn)[kTE], const float* XP, const float* XN,
                                         int lda, int K, const float* __restrict__ KR,
                                         const float* __restrict__ KI, int ldw, int col, bool ok) {
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float wr[4], wi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wr[i] = ok ? __ldg(KR + (size_t)(k + i) * ldw + col) : 0.f;
      wi[i] = ok ? __ldg(KI + (size_t)(k + i) * ldw + col) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kTE; ++e) {
      const float4 p = *reinterpret_cast<const float4*>(XP + e * lda + k);
      const float4 n = *reinterpret_cast<const float4*>(XN + e * lda + k);
      const float pv[4] = {p.x, p.y, p.z, p.w};
      const float nv[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yp[e] = fmaf(pv[i], wr[i], yp[e]);
        yp[e] = fmaf(-nv[i], wi[i], yp[e]);
        yn[e] = fmaf(pv[i], wi[i], yn[e]);
        yn[e] = fmaf(nv[i], wr[i], yn[e]);
      }
    }
  }
  for (; k < K; ++k) {
    const float wr = ok ? __ldg(KR + (size_t)k * ldw + col) : 0.f;
    const float wi = ok ? __ldg(KI + (size_t)k * ldw + col) : 0.f;
#pragma unroll
    for (int e = 0; e < kTE; ++e) {
      const float p = XP[e * lda + k], n = XN[e * lda + k];
      yp[e] = fmaf(p, wr, yp[e]);
      yp[e] = fmaf(-n, wi, yp[e]);
      yn[e] = fmaf(p, wi, yn[e]);
      yn[e] = fmaf(n, wr, yn[e]);
    }
  }
}

// In place over rows [kTE][H] of x (stride ld): silu(LN(x) * scale + bias),
// one warp per edge.
__device__ __forceinline__ void ln_silu_rows(float* x, int ld, int H, const float* __restrict__ scale,
                                             const float* __restrict__ bias) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = warp; e < kTE; e += kThreads / 32) {
    float* row = x + e * ld;
    float s = 0.f;
    for (int j = lane; j < H; j += 32) s += row[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / H;
    float v = 0.f;
    for (int j = lane; j < H; j += 32) {
      const float t = row[j] - mu;
      v += t * t;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / H + 1e-6f);
    for (int j = lane; j < H; j += 32) row[j] = silu((row[j] - mu) * inv * __ldg(scale + j) + __ldg(bias + j));
  }
}

// One (m-block, half) slice of gated messages into shared memory, NC gate
// columns per thread per pass (see gated_slice below):
// p0[e][j] = msg[e][row0 * C + j] * gate[e][gcol0 + j] (and, for |m| > 0,
// p1 from the -m rows at (row0 + nb) * C with the same gates), j < K = nb * C.
// y1: [kTE][H] in shared memory (stride Hp); w2 [H, NG] and b2 [NG] already
// offset to the slice's first gate column; msg already offset to the tile's
// first edge and the slice's first row (row stride msg_ld = NA * C).
template <int NC>
__device__ __forceinline__ void gated_slice_nc(const float* y1, int Hp, int H, const float* __restrict__ w2, int NG,
                                               const float* __restrict__ b2, const float* __restrict__ msg,
                                               size_t msg_ld, int ne, int K, int neg_off, float* p0, float* p1,
                                               int Kp) {
  for (int jb = 0; jb < K; jb += kThreads * NC) {
    float acc[kTE][NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = jb + threadIdx.x + c * kThreads;
      const float b = j < K ? __ldg(b2 + j) : 0.f;
#pragma unroll
      for (int e = 0; e < kTE; ++e) acc[e][c] = b;
    }
    gemm_acc<kTE, NC>(acc, y1, Hp, H, w2 + jb, NG, threadIdx.x, K - jb);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = jb + threadIdx.x + c * kThreads;
      if (j >= K) continue;
#pragma unroll
      for (int e = 0; e < kTE; ++e) {
        float v0 = 0.f, v1 = 0.f;
        if (e < ne) {
          const float* row = msg + e * msg_ld;
          v0 = __ldg(row + j) * acc[e][c];
          if (p1 != nullptr) v1 = __ldg(row + neg_off + j) * acc[e][c];
        }
        p0[e * Kp + j] = v0;
        if (p1 != nullptr) p1[e * Kp + j] = v1;
      }
    }
  }
}

// The slice with the fewest idle gate columns: one pass of NC x kThreads
// columns for K up to 3 x kThreads (the m0 slice at C = 128 has K = 640),
// more passes beyond.
__device__ __forceinline__ void gated_slice(const float* y1, int Hp, int H, const float* __restrict__ w2, int NG,
                                            const float* __restrict__ b2, const float* __restrict__ msg,
                                            size_t msg_ld, int ne, int K, int neg_off, float* p0, float* p1,
                                            int Kp) {
  if (K <= kThreads) {
    gated_slice_nc<1>(y1, Hp, H, w2, NG, b2, msg, msg_ld, ne, K, neg_off, p0, p1, Kp);
  } else if (K <= 2 * kThreads) {
    gated_slice_nc<2>(y1, Hp, H, w2, NG, b2, msg, msg_ld, ne, K, neg_off, p0, p1, Kp);
  } else {
    gated_slice_nc<3>(y1, Hp, H, w2, NG, b2, msg, msg_ld, ne, K, neg_off, p0, p1, Kp);
  }
}

__global__ void __launch_bounds__(kThreads, 2) eqv2_attn_conv1_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  __shared__ int nb_s[kMaxGroups];  // rows per m-block, indexed by a runtime group
  float* d_s = reinterpret_cast<float*>(smem4);  // [kTE] distances
  float* m_s = d_s + kTE;                         // [kTE] mask as 0/1
  float* g_s = m_s + kTE;                         // [kTE][kRC] gaussian chunk
  float* a_s = g_s + kTE * kRC;                   // [kTE][Hp] trunk layer 0
  float* b_s = a_s + kTE * a.Hp;                  // [kTE][Hp] trunk layer 1 (y1)
  float* u_s = b_s + kTE * a.Hp;                  // embeddings, then gated message slices
  float* es_s = u_s;
  float* et_s = u_s + kTE * a.Edp;
  float* p0_s = u_s;
  float* p1_s = u_s + kTE * a.Kp;

  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * kTE;
  const int ne = (int)((a.E - e0) < kTE ? (a.E - e0) : kTE);
  int NA = 0, half_rows = 0;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (tid == g) nb_s[g] = a.nb[g];
    NA += g == 0 ? a.nb[g] : 2 * a.nb[g];
    half_rows += a.nb[g];
  }
  const int half_gates = half_rows * a.C;
  const size_t msg_ld = (size_t)NA * a.C;

  // 1. stage the tile's distances, mask and embeddings
  if (tid < kTE) {
    d_s[tid] = tid < ne ? a.dist[e0 + tid] : 0.f;
    m_s[tid] = (tid < ne && a.mask[e0 + tid]) ? 1.f : 0.f;
  }
  for (int i = tid; i < kTE * a.Ed; i += kThreads) {
    const int e = i / a.Ed, j = i - e * a.Ed;
    es_s[e * a.Edp + j] = e < ne ? a.emb_s[(size_t)(e0 + e) * a.Ed + j] : 0.f;
    et_s[e * a.Edp + j] = e < ne ? a.emb_t[(size_t)(e0 + e) * a.Ed + j] : 0.f;
  }
  __syncthreads();

  // 2. trunk layer 0: gauss @ wg + emb_s @ ws + emb_t @ wt + b0 -> a_s
  const int tcol = tid % kTrunkCols, teg = tid / kTrunkCols;
  constexpr int kHalfTE = kTE / 2;
  for (int cb = 0; cb < a.H; cb += kTrunkCols) {
    float acc[kHalfTE][1];
    const bool ok = cb + tcol < a.H;
#pragma unroll
    for (int e = 0; e < kHalfTE; ++e) acc[e][0] = ok ? __ldg(a.b0 + cb + tcol) : 0.f;
    for (int r0 = 0; r0 < a.R; r0 += kRC) {
      __syncthreads();  // g_s is free
      int nz = 0;
      for (int i = tid; i < kTE * kRC; i += kThreads) {
        const int e = i / kRC, rr = i - e * kRC, r = r0 + rr;
        float v = 0.f;
        if (r < a.R && e < ne) {
          const float t = d_s[e] - (float)r * a.delta;
          v = expf(a.coeff * (t * t)) * m_s[e];
        }
        g_s[i] = v;
        nz |= v != 0.f;
      }
      if (__syncthreads_or(nz)) {
        const int K = a.R - r0 < kRC ? a.R - r0 : kRC;
        gemm_acc<kHalfTE, 1>(acc, g_s + teg * kHalfTE * kRC, kRC, K, a.wg + (size_t)r0 * a.H + cb, a.H, tcol,
                              a.H - cb);
      }
    }
    gemm_acc<kHalfTE, 1>(acc, es_s + teg * kHalfTE * a.Edp, a.Edp, a.Ed, a.ws + cb, a.H, tcol, a.H - cb);
    gemm_acc<kHalfTE, 1>(acc, et_s + teg * kHalfTE * a.Edp, a.Edp, a.Ed, a.wt + cb, a.H, tcol, a.H - cb);
    if (ok) {
#pragma unroll
      for (int e = 0; e < kHalfTE; ++e) a_s[(teg * kHalfTE + e) * a.Hp + cb + tcol] = acc[e][0];
    }
  }
  __syncthreads();
  ln_silu_rows(a_s, a.Hp, a.H, a.ln0s, a.ln0b);
  __syncthreads();

  // 3. trunk layer 1: y0 @ w1 + b1 -> b_s
  for (int cb = 0; cb < a.H; cb += kTrunkCols) {
    float acc[kHalfTE][1];
    const bool ok = cb + tcol < a.H;
#pragma unroll
    for (int e = 0; e < kHalfTE; ++e) acc[e][0] = ok ? __ldg(a.b1 + cb + tcol) : 0.f;
    gemm_acc<kHalfTE, 1>(acc, a_s + teg * kHalfTE * a.Hp, a.Hp, a.H, a.w1 + cb, a.H, tcol, a.H - cb);
    if (ok) {
#pragma unroll
      for (int e = 0; e < kHalfTE; ++e) b_s[(teg * kHalfTE + e) * a.Hp + cb + tcol] = acc[e][0];
    }
  }
  __syncthreads();
  ln_silu_rows(b_s, a.Hp, a.H, a.ln1s, a.ln1b);
  // (the barrier at the top of the first gated slice orders this before use)

  // 4. per m-block: gates, gated message slices, conv product
  const float* wc = a.wconv;
  int row0 = 0, goff = 0;
  const size_t hrow = (size_t)NA * a.CO;  // h_out row stride
  for (int g = 0; g < a.n_groups; ++g) {
    const int nb = nb_s[g];
    const int K = nb * a.C;
    if (g == 0) {
      // both halves' gated m0 rows at once (p0_s: source, p1_s: target), so
      // the column passes below reuse them
      constexpr int NC = 2;
      const int N = a.X + nb * a.CO;
      __syncthreads();  // p0_s, p1_s are free
      for (int half = 0; half < 2; ++half) {
        const int gcol = half * half_gates + goff;
        gated_slice(b_s, a.Hp, a.H, a.w2 + gcol, a.NG, a.b2 + gcol,
                    (half ? a.msg_t : a.msg_s) + (size_t)e0 * msg_ld + (size_t)row0 * a.C, msg_ld, ne, K, 0,
                    half ? p1_s : p0_s, nullptr, a.Kp);
      }
      __syncthreads();
      for (int cp = 0; cp < N; cp += kThreads * NC) {
        float acc[kTE][NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cp + tid + c * kThreads;
          const float b = col < N ? __ldg(a.bm0 + col) : 0.f;
#pragma unroll
          for (int e = 0; e < kTE; ++e) acc[e][c] = b;
        }
        gemm_acc<kTE, NC>(acc, p0_s, a.Kp, K, wc + cp, N, tid, N - cp);
        gemm_acc<kTE, NC>(acc, p1_s, a.Kp, K, wc + (size_t)K * N + cp, N, tid, N - cp);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = cp + tid + c * kThreads;
          if (col >= N) continue;
#pragma unroll
          for (int e = 0; e < kTE; ++e) {
            if (e >= ne) continue;
            if (col < a.X) {
              a.extra_out[(size_t)(e0 + e) * a.X + col] = acc[e][c];
            } else {
              a.h_out[(size_t)(e0 + e) * hrow + (col - a.X)] = acc[e][c];
            }
          }
        }
      }
      wc += 2 * (size_t)K * N;
      row0 += nb;
    } else {
      const int N = nb * a.CO;
      const size_t kn = (size_t)K * N;
      // per half: (kr, ki); layout kr_s, ki_s, kr_t, ki_t
      for (int cp = 0; cp < N; cp += kThreads) {
        const int col = cp + tid;
        const bool ok = col < N;
        float yp[kTE], yn[kTE];
#pragma unroll
        for (int e = 0; e < kTE; ++e) yp[e] = yn[e] = 0.f;
        for (int half = 0; half < 2; ++half) {
          __syncthreads();  // p0_s, p1_s are free
          const int gcol = half * half_gates + goff;
          gated_slice(b_s, a.Hp, a.H, a.w2 + gcol, a.NG, a.b2 + gcol,
                      (half ? a.msg_t : a.msg_s) + (size_t)e0 * msg_ld + (size_t)row0 * a.C, msg_ld, ne, K,
                      nb * a.C, p0_s, p1_s, a.Kp);
          __syncthreads();
          const float* kr = wc + (2 * half) * kn;
          pair_acc(yp, yn, p0_s, p1_s, a.Kp, K, kr, kr + kn, N, col, ok);
        }
        if (ok) {
#pragma unroll
          for (int e = 0; e < kTE; ++e) {
            if (e >= ne) continue;
            float* row = a.h_out + (size_t)(e0 + e) * hrow;
            row[(size_t)row0 * a.CO + col] = yp[e];
            row[(size_t)(row0 + nb) * a.CO + col] = yn[e];
          }
        }
      }
      wc += 4 * kn;
      row0 += 2 * nb;
    }
    goff += K;
  }
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
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int eqv2_attn_conv1_f32(
    const void* dist, const void* mask, const void* emb_s, const void* emb_t, const void* msg_s,
    const void* msg_t, const void* wg, const void* ws, const void* wt, const void* b0, const void* ln0s,
    const void* ln0b, const void* w1, const void* b1, const void* ln1s, const void* ln1b, const void* w2,
    const void* b2, const void* bm0, const void* wconv, void* extra_out, void* h_out, long long E,
    int num_gauss, int emb_dim, int hidden, int c_in, int c_out, int extra, const int* n_blocks, int n_groups,
    float cutoff, float width_scalar, void* stream) {
  if (E <= 0) return 0;
  if (n_groups < 1 || n_groups > kMaxGroups || num_gauss < 2) return (int)cudaErrorInvalidValue;
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
  int kmax = 0, rows = 0;
  for (int g = 0; g < kMaxGroups; ++g) {
    a.nb[g] = g < n_groups ? n_blocks[g] : 0;
    rows += a.nb[g];
    if (a.nb[g] * c_in > kmax) kmax = a.nb[g] * c_in;
  }
  a.NG = 2 * rows * c_in;
  // as the plain version: both constants in double, then rounded to f32
  const double delta = (double)cutoff / (num_gauss - 1);
  a.delta = (float)delta;
  a.coeff = (float)(-0.5 / ((width_scalar * delta) * (width_scalar * delta)));
  a.Hp = round4(hidden);
  a.Edp = round4(emb_dim);
  a.Kp = round4(kmax);
  const size_t union_floats = 2 * (size_t)kTE * (a.Edp > a.Kp ? a.Edp : a.Kp);
  const size_t smem = (2 * kTE + kTE * kRC + 2 * (size_t)kTE * a.Hp + union_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(eqv2_attn_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (E + kTE - 1) / kTE;
  eqv2_attn_conv1_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* eqv2_attn_conv1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
