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
// which underflows to exactly 0 in f32 once |r - c| > 14.4 (e^-104 is below
// the smallest denormal), and is 0 everywhere once d >= 1 (env = 0). So an
// edge has at most 29 non-zero basis values of the R; every product below
// runs only over the rows a chunk of edges can reach, and the terms it skips
// are exact zeros of the dense sum.
//
// What bounds it on the H100: at the training shape (B=48, N=80, K=50, R=128,
// H=512, <= 192,000 valid edges) the work the data needs is the two R x 3H
// products over each edge's non-zero rows, 2 x 6 x 29 x H flops, ~30H
// elementwise and ~10 R for the basis: ~35 GFLOP of f32 on the CUDA cores
// (~0.5 ms at 67 TFLOP/s), against ~150 MB to move (~0.05 ms). Operations
// set the bound; the dense count (the TPU kernel's) is 154 GFLOP.
//
// Design:
//   * one block of 256 threads per (32 consecutive target rows, 32 feature
//     columns h); lane l owns h = h0 + l and with it the three columns h,
//     H+h, 2H+h that couple through ghat1 and the dvec scatter;
//   * warp 0 compacts the block's valid edge slots (mask, source in range)
//     with a ballot; a counting sort in shared memory then orders them by
//     floor(c), so that each 64-edge chunk of the sorted list spans a narrow
//     band of distances and a narrow window of basis rows;
//   * per chunk: the basis is built in shared memory for the chunk's rows
//     only (in 16-row blocks), once per (edge, row), in two layouts ([r][e]
//     and [e][r], so both products read it with broadcast float4 loads), then
//       1. filter recompute: warp w holds an 8-edge x 3-column register tile
//          for edges 8w..8w+7 and loops over those 8 edges' rows only;
//       2. elementwise: source rows are read by index (coalesced across h),
//          dxh and dvec are scattered with atomicAdd into zeroed outputs,
//          dfil [64][96] goes to shared memory and db is summed per thread;
//       3. dW: warp w holds rows 16w..16w+15 of the block's dW tile for its
//          lane's 3 columns (48 registers) and adds basis^T @ dfil when its
//          rows meet the chunk's window;
//   * the dW / db tile stays in registers over all of the block's edges and
//     is added to the output with one atomicAdd per element (per warp for db)
//     at the end, so dW sees B*N/32 atomics per element, not one per edge.
// The TPU kernel's one-hot gather/scatter matmuls, its selection matrix and
// its host-side transposed copies of src and dist are gone: row loads, a
// register loop and two shared-memory layouts replace them. Atomics make the
// order of the f32 sums into dxh, dvec, dW and db differ from run to run.
// Not yet used: tensor cores (wgmma), TMA, and shared-memory staging of the
// scatter targets.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;                         // h values per block (one per lane)
constexpr int kEdgesPerWarp = 8;                  // filter register tile
constexpr int kChunk = kWarps * kEdgesPerWarp;    // edges per pass
constexpr int kMaxR = 128;                        // radial basis size the dW tile holds
constexpr int kRowsPerWarp = kMaxR / kWarps;      // dW rows per thread
constexpr int kTargets = 32;                      // target rows per block
constexpr int kBT = kChunk + 4;                   // basis_t row stride (16-byte rows, 4-way write conflicts)
constexpr float kReach = 14.5f;                   // basis rows beyond |r - c| > kReach underflow to 0

struct Smem {
  float* basis_t;  // [kMaxR][kBT]
  float* basis;    // [kChunk][kMaxR]
  float* dfil;     // [kChunk][3 * kCols]
  float* unit;     // [kChunk][3]
  float* dsc;      // [kChunk] distance / cutoff
  float* env;      // [kChunk]
  float* off;      // [kMaxR] r / (R - 1)
  int* src;        // [kChunk]
  int* tgt;        // [kChunk] global target row b * N + i
  int* hist;       // [kMaxR + 1] counting-sort bins, then their next free slot
  int* list;       // [kTargets * K] valid slots, relative to the block's first edge
  int* sorted;     // [kTargets * K] the same slots, ordered by bin
  int* count;      // [1]
};

__host__ __device__ inline size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)kMaxR * kBT + (size_t)kChunk * kMaxR + (size_t)kChunk * 3 * kCols + 5 * kChunk +
                          kMaxR) +
         sizeof(int) * (2 * kChunk + kMaxR + 1 + 2 * (size_t)kTargets * K + 1);
}

__device__ inline Smem carve(float* base, int K) {
  Smem s;
  s.basis_t = base;
  s.basis = s.basis_t + kMaxR * kBT;
  s.dfil = s.basis + kChunk * kMaxR;
  s.unit = s.dfil + kChunk * 3 * kCols;
  s.dsc = s.unit + 3 * kChunk;
  s.env = s.dsc + kChunk;
  s.off = s.env + kChunk;
  s.src = reinterpret_cast<int*>(s.off + kMaxR);
  s.tgt = s.src + kChunk;
  s.hist = s.tgt + kChunk;
  s.list = s.hist + kMaxR + 1;
  s.sorted = s.list + kTargets * K;
  s.count = s.sorted + kTargets * K;
  return s;
}

// Sort bin of an edge: floor(c) for c = d (R-1) when d < 1, else R (no
// non-zero basis row).  NaN distances land in bin R too.
__device__ __forceinline__ int edge_bin(float d, int R) {
  return d < 1.f ? min((int)(d * (float)(R - 1)), R - 1) : R;
}

// Rows [lo, hi] that edges with bins bin_lo <= bin_hi can reach.
__device__ __forceinline__ void reach(int bin_lo, int bin_hi, int R, int& lo, int& hi) {
  if (bin_lo >= R) {  // every edge has an all-zero basis
    lo = R;
    hi = -1;
    return;
  }
  lo = max(0, bin_lo - (int)kReach);
  hi = bin_hi >= R ? R - 1 : min(R - 1, bin_hi + (int)kReach + 1);
}

__global__ void __launch_bounds__(kThreads, 2) painn_message_fused_bwd_kernel(
    const float* __restrict__ xh, const float* __restrict__ vec,
    const int32_t* __restrict__ src, const float* __restrict__ dist,
    const uint8_t* __restrict__ mask, const float* __restrict__ unit,
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ gdx, const float* __restrict__ gdv,
    float* __restrict__ dxh, float* __restrict__ dvec,
    float* __restrict__ dw, float* __restrict__ db,
    int rows, int N, int K, int R, int H, float inv_cutoff, int p) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, K);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t0 = blockIdx.x * kTargets;
  const int nt = min(kTargets, rows - t0);
  const int h = blockIdx.y * kCols + lane;
  const bool h_ok = h < H;
  const int hc = h_ok ? h : 0;  // clamped column for loads on idle lanes
  const size_t F = 3 * (size_t)H;
  const size_t e0 = (size_t)t0 * K;
  const float inv_sqrt3 = 0.57735026918962576f;

  for (int r = threadIdx.x; r < kMaxR; r += kThreads) sm.off[r] = (float)r / (float)(R - 1);
  for (int b = threadIdx.x; b <= kMaxR; b += kThreads) sm.hist[b] = 0;
  // ---- compact the valid slots of this block's targets (warp 0) ----
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < nt * K; base += 32) {
      const int slot = base + lane;
      bool valid = false;
      if (slot < nt * K) {
        const int s = src[e0 + slot];
        valid = mask[e0 + slot] && s >= 0 && s < N;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (valid) sm.list[count + __popc(ballot & ((1u << lane) - 1u))] = slot;
      count += __popc(ballot);
    }
    if (lane == 0) *sm.count = count;
  }
  __syncthreads();
  const int n_valid = *sm.count;
  // ---- counting sort of the valid slots by bin ----
  for (int i = threadIdx.x; i < n_valid; i += kThreads) {
    atomicAdd(sm.hist + edge_bin(dist[e0 + sm.list[i]] * inv_cutoff, R), 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int b = 0; b <= R; ++b) {
      const int c = sm.hist[b];
      sm.hist[b] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_valid; i += kThreads) {
    const int slot = sm.list[i];
    sm.sorted[atomicAdd(sm.hist + edge_bin(dist[e0 + slot] * inv_cutoff, R), 1)] = slot;
  }
  __syncthreads();

  const float pf = (float)p;
  const float ca = -(pf + 1.f) * (pf + 2.f) * 0.5f;
  const float cb = pf * (pf + 2.f);
  const float cc = -pf * (pf + 1.f) * 0.5f;
  const float coeff = -0.5f * (float)((R - 1) * (R - 1));

  const float b0 = bias[hc], b1 = bias[H + hc], b2 = bias[2 * H + hc];
  float dwacc[kRowsPerWarp][3];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) dwacc[i][0] = dwacc[i][1] = dwacc[i][2] = 0.f;
  float db0 = 0.f, db1 = 0.f, db2 = 0.f;

  for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
    const int nchunk = min(kChunk, n_valid - c0);
    // ---- stage the chunk's edges ----
    for (int e = threadIdx.x; e < kChunk; e += kThreads) {
      if (e < nchunk) {
        const int slot = sm.sorted[c0 + e];
        const size_t g = e0 + slot;
        sm.src[e] = src[g];
        sm.tgt[e] = t0 + slot / K;
        sm.unit[3 * e + 0] = unit[3 * g + 0];
        sm.unit[3 * e + 1] = unit[3 * g + 1];
        sm.unit[3 * e + 2] = unit[3 * g + 2];
        const float d = dist[g] * inv_cutoff;
        float dp = 1.f;
        for (int j = 0; j < p; ++j) dp *= d;
        const float env = 1.f + ca * dp + cb * dp * d + cc * dp * d * d;
        sm.dsc[e] = d;
        sm.env[e] = d < 1.f ? env : 0.f;
      } else {
        sm.dsc[e] = 2.f;  // padded edges: bin R, zero basis
        sm.env[e] = 0.f;
      }
    }
    __syncthreads();
    // the chunk's reachable rows (bins are sorted: first and last edge bound them)
    int lo, hi;
    reach(edge_bin(sm.dsc[0], R), edge_bin(sm.dsc[nchunk - 1], R), R, lo, hi);
    const int lo16 = lo / 16 * 16;
    const int hi16 = hi < lo ? lo16 : min(kMaxR, (hi / 16 + 1) * 16);
    for (int e = warp; e < kChunk; e += kWarps) {
      const float d = sm.dsc[e], env = sm.env[e];
      for (int r = lo16 + lane; r < hi16; r += 32) {
        const float diff = d - sm.off[r];
        const float v = r < R ? expf(coeff * diff * diff) * env : 0.f;
        sm.basis[e * kMaxR + r] = v;
        sm.basis_t[r * kBT + e] = v;
      }
    }
    __syncthreads();

    // ---- 1. filter recompute: edges 8w..8w+7, columns h, H+h, 2H+h ----
    const int e_lo = warp * kEdgesPerWarp;
    float acc[kEdgesPerWarp][3];
#pragma unroll
    for (int kk = 0; kk < kEdgesPerWarp; ++kk) acc[kk][0] = acc[kk][1] = acc[kk][2] = 0.f;
    if (e_lo < nchunk) {  // warp-uniform
      int wlo, whi;
      reach(edge_bin(sm.dsc[e_lo], R), edge_bin(sm.dsc[min(e_lo + kEdgesPerWarp, nchunk) - 1], R), R, wlo, whi);
      const float* wcol = w + hc;
      for (int r = wlo; r <= whi; ++r) {
        const float* wr = wcol + (size_t)r * F;
        const float w0 = __ldg(wr), w1 = __ldg(wr + H), w2 = __ldg(wr + 2 * H);
        const float4 bl = *reinterpret_cast<const float4*>(sm.basis_t + r * kBT + e_lo);
        const float4 bh = *reinterpret_cast<const float4*>(sm.basis_t + r * kBT + e_lo + 4);
        const float bv[kEdgesPerWarp] = {bl.x, bl.y, bl.z, bl.w, bh.x, bh.y, bh.z, bh.w};
#pragma unroll
        for (int kk = 0; kk < kEdgesPerWarp; ++kk) {
          acc[kk][0] = fmaf(bv[kk], w0, acc[kk][0]);
          acc[kk][1] = fmaf(bv[kk], w1, acc[kk][1]);
          acc[kk][2] = fmaf(bv[kk], w2, acc[kk][2]);
        }
      }
    }

    // ---- 2. elementwise: scatter dxh / dvec, dfil to shared memory ----
#pragma unroll
    for (int kk = 0; kk < kEdgesPerWarp; ++kk) {
      const int e = e_lo + kk;
      float* drow = sm.dfil + e * 3 * kCols;
      if (e < nchunk && h_ok) {
        const int t = sm.tgt[e];
        const size_t row = ((size_t)(t / N) * N + sm.src[e]) * F;  // source row in its system
        const float xg0 = __ldg(xh + row + h), xg1 = __ldg(xh + row + H + h), xg2 = __ldg(xh + row + 2 * H + h);
        const float vg0 = __ldg(vec + row + h), vg1 = __ldg(vec + row + H + h), vg2 = __ldg(vec + row + 2 * H + h);
        const float gx = __ldg(gdx + (size_t)t * H + h);
        const float* gvt = gdv + (size_t)t * F;
        const float gv0 = __ldg(gvt + h), gv1 = __ldg(gvt + H + h), gv2 = __ldg(gvt + 2 * H + h);
        const float f0 = acc[kk][0] + b0, f1 = acc[kk][1] + b1, f2 = acc[kk][2] + b2;
        const float ghat0 = gx;
        const float ghat1 = (vg0 * gv0 + vg1 * gv1 + vg2 * gv2) * inv_sqrt3;
        const float ghat2 = sm.unit[3 * e] * gv0 + sm.unit[3 * e + 1] * gv1 + sm.unit[3 * e + 2] * gv2;
        atomicAdd(dxh + row + h, ghat0 * f0);
        atomicAdd(dxh + row + H + h, ghat1 * f1);
        atomicAdd(dxh + row + 2 * H + h, ghat2 * f2);
        const float g2 = xg1 * f1 * inv_sqrt3;
        atomicAdd(dvec + row + h, g2 * gv0);
        atomicAdd(dvec + row + H + h, g2 * gv1);
        atomicAdd(dvec + row + 2 * H + h, g2 * gv2);
        const float d0 = ghat0 * xg0, d1 = ghat1 * xg1, d2 = ghat2 * xg2;
        drow[lane] = d0;
        drow[kCols + lane] = d1;
        drow[2 * kCols + lane] = d2;
        db0 += d0;
        db1 += d1;
        db2 += d2;
      } else {
        drow[lane] = 0.f;
        drow[kCols + lane] = 0.f;
        drow[2 * kCols + lane] = 0.f;
      }
    }
    __syncthreads();

    // ---- 3. dW rows 16w..16w+15 += basis^T @ dfil, where they meet the window ----
    const int r_lo = warp * kRowsPerWarp;
    if (r_lo < R && r_lo <= hi && r_lo + kRowsPerWarp > lo) {  // warp-uniform; rows inside [lo16, hi16)
      for (int e = 0; e < nchunk; ++e) {
        const float* drow = sm.dfil + e * 3 * kCols;
        const float d0 = drow[lane], d1 = drow[kCols + lane], d2 = drow[2 * kCols + lane];
        const float4* brow = reinterpret_cast<const float4*>(sm.basis + e * kMaxR + r_lo);
#pragma unroll
        for (int q = 0; q < kRowsPerWarp / 4; ++q) {
          const float4 b4 = brow[q];
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dwacc[4 * q + j][0] = fmaf(bv[j], d0, dwacc[4 * q + j][0]);
            dwacc[4 * q + j][1] = fmaf(bv[j], d1, dwacc[4 * q + j][1]);
            dwacc[4 * q + j][2] = fmaf(bv[j], d2, dwacc[4 * q + j][2]);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the shared tiles
  }

  // ---- one atomicAdd per element of the block's dW tile, per warp for db ----
  if (h_ok && n_valid > 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      if (r < R) {
        float* dwr = dw + (size_t)r * F;
        atomicAdd(dwr + h, dwacc[i][0]);
        atomicAdd(dwr + H + h, dwacc[i][1]);
        atomicAdd(dwr + 2 * H + h, dwacc[i][2]);
      }
    }
    atomicAdd(db + h, db0);
    atomicAdd(db + H + h, db1);
    atomicAdd(db + 2 * H + h, db2);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: xh, vec [B,N,3H] f32; src [B,N,K] i32; dist [B,N,K] f32;
// mask [B,N,K] bool (1 byte); unit [B,N,K,3] f32; w [R,3H] f32; bias [3H] f32;
// gdx [B,N,H] f32; gdv [B,N,3,H] f32. dxh, dvec [B,N,3H], dw [R,3H] and db
// [3H] f32 must be zeroed by the caller: the kernel adds into them. Needs
// 2 <= R <= 128. Launches on `stream` and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int painn_message_fused_bwd_f32(
    const void* xh, const void* vec, const void* src, const void* dist,
    const void* mask, const void* unit, const void* w, const void* bias,
    const void* gdx, const void* gdv, void* dxh, void* dvec, void* dw, void* db,
    int B, int N, int K, int R, int H, float inv_cutoff, int envelope_exponent, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || H <= 0) return 0;
  if (R < 2 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(
      painn_message_fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * N;
  const dim3 grid((unsigned)((rows + kTargets - 1) / kTargets), (unsigned)((H + kCols - 1) / kCols));
  painn_message_fused_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xh), static_cast<const float*>(vec),
      static_cast<const int32_t*>(src), static_cast<const float*>(dist),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(unit),
      static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gdx), static_cast<const float*>(gdv),
      static_cast<float*>(dxh), static_cast<float*>(dvec),
      static_cast<float*>(dw), static_cast<float*>(db),
      rows, N, K, R, H, inv_cutoff, envelope_exponent);
  return (int)cudaGetLastError();
}

extern "C" const char* painn_message_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
