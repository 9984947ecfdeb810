// Masked radial edge filters, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel adsorbdiff_tpu/ops/pallas_kernels.py::
// _fused_rbf_filter_kernel (wrapper fused_rbf_filter). For every edge e of
// the flattened lead dims and output column f:
//
//   basis[e, r] = exp(-(R-1)^2/2 * (d_e - r/(R-1))^2) * env(d_e),  d_e = dist/cutoff
//   out[e, f]   = mask_e * (bias[f] + sum_r basis[e, r] * W[r, f])
//
// (a masked edge is 0, bias included; an unmasked edge beyond the cutoff,
// whose basis is all zero, gives the bias bit for bit).
//
// What bounds it on the H100: it must write the [E, F] output once (393 MB
// at E = 64,000, F = 1536: 0.118 ms at 3.35 TB/s), and the product needs
// ~2.9 G FMA on the non-zero basis values (0.088 ms at the f32 peak): a
// unit-width gaussian in r underflows to exactly 0 in f32 more than 14.4 rows
// from d (R-1), so an edge needs the rows [bin - 14, bin + 15] of its bin =
// floor(d (R-1)) only, and none at d >= 1.
//
// The design: a persistent grid from a plain-Python plan (ops/kernels.py::
// rbf_filter_plan). A block of 12 warps owns a slice of 128 output columns,
// lane l columns 4l..4l+3 of it; it stages W's slice ([R][128], 64 KB at R =
// 128) and the bias once, with cp.async, where W fits its shared memory (else
// W is read through L1/L2), and walks chunks of 384 consecutive edges. Each
// chunk is sorted by the edges' bins in shared memory (a counting sort: one
// edge a thread, shared int atomics, one warp's scan): groups of 8
// consecutive edges of a sorted graph span ~16 bins, so their windows run
// ~1.5x the needed products, where 8 edges of neighbouring bins from ~8
// targets run ~1.1x. Each warp then takes groups of 8 sorted edges: it builds
// the basis on the union of the group's windows into its own shared buffer
// ([48 rows][8], in passes) and, per row, two broadcast float4 loads of the 8
// basis values and one float4 load of the lane's 4 W columns feed 32 FMAs into
// an 8 x 4 register tile; the epilogue adds the bias, applies the mask and
// writes each edge's 4 columns with one streaming float4 store (a guarded
// scalar path where F % 4 != 0). An edge's sum runs over its own non-zero rows in
// ascending order from +0 whatever its group (rows outside its window add
// exact zeros), so the output does not depend on the order the atomics give
// within a bin.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;  // edges a chunk: one a thread in the sort
constexpr int kCols = 128;        // output columns a block
constexpr int kGroup = 8;         // edges a warp's tile
constexpr int kPass = 48;         // basis rows a pass of a warp's buffer
constexpr int kReach = 14;        // rows [bin - 14, bin + 15] hold an edge's non-zero basis values
constexpr int kSmemMax = 232448;  // the most shared memory a block may take on the H100

// floats of the dynamic shared memory: W's slice (staged instances), the bias,
// the warps' basis buffers, r / (R - 1), the counts [R + 1] and the chunk's
// sorted edge, keep, d and envelope
__host__ __device__ constexpr long long smem_floats(int R, bool stage_w) {
  return (stage_w ? (long long)kCols * R : 0) + kCols + kWarps * kPass * kGroup + R + (R + 1) + 4 * kChunk;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ float envelope(float d, int p) {
  const float pf = (float)p;
  float dp = 1.f;
  for (int j = 0; j < p; ++j) dp *= d;
  const float env = 1.f + (-(pf + 1.f) * (pf + 2.f) * 0.5f) * dp + pf * (pf + 2.f) * dp * d +
                    (-pf * (pf + 1.f) * 0.5f) * dp * d * d;
  return d < 1.f ? env : 0.f;
}

template <bool VEC, bool STAGE_W>
__global__ void __launch_bounds__(kThreads, 2) fused_rbf_filter_kernel(
    const float* __restrict__ dist, const uint8_t* __restrict__ mask, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, long long E, int R, int F, float inv_cutoff, int p,
    int slices) {
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                            // [R][kCols] (STAGE_W)
  float* bias_s = smem + (STAGE_W ? (long long)kCols * R : 0);  // [kCols]
  float* basis_s = bias_s + kCols;                              // [kWarps][kPass][kGroup]
  float* off_s = basis_s + kWarps * kPass * kGroup;             // [R]: r / (R - 1)
  int* cnt_s = reinterpret_cast<int*>(off_s + R);               // [R + 1]: per key, then first position
  int* edge_s = cnt_s + R + 1;                                  // [kChunk], sorted by key
  int* keep_s = edge_s + kChunk;
  float* d_s = reinterpret_cast<float*>(keep_s + kChunk);
  float* env_s = d_s + kChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = blockIdx.x % slices, bps = gridDim.x / slices;
  const int f0 = slice * kCols;
  const long long chunks = (E + kChunk - 1) / kChunk;

  if (STAGE_W) {
    if (VEC) {
      for (int idx = tid; idx < R * (kCols / 4); idx += kThreads) {
        const int r = idx / (kCols / 4), c = 4 * (idx % (kCols / 4)), col = f0 + c;
        cp_async(w_s + r * kCols + c, w + (col < F ? (size_t)r * F + col : 0), 16, col < F ? 16 : 0);
      }
    } else {
      for (int idx = tid; idx < R * kCols; idx += kThreads) {
        const int r = idx / kCols, c = idx % kCols, col = f0 + c;
        cp_async(w_s + idx, w + (col < F ? (size_t)r * F + col : 0), 4, col < F ? 4 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int c = tid; c < kCols; c += kThreads) bias_s[c] = f0 + c < F ? bias[f0 + c] : 0.f;
  for (int r = tid; r < R; r += kThreads) off_s[r] = (float)r / (float)(R - 1);
  for (int r = tid; r <= R; r += kThreads) cnt_s[r] = 0;
  if (STAGE_W) asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // rows a step of the row loop: 4 where W is staged (the unstaged instances spill at 4)
  constexpr int kUnroll = STAGE_W ? 4 : 2;
  const float coeff = -0.5f * (float)((R - 1) * (R - 1));
  float* buf = basis_s + warp * kPass * kGroup;
  const int col0 = f0 + 4 * lane;  // the lane's first column
  for (long long ch = blockIdx.x / slices; ch < chunks; ch += bps) {
    const long long e0 = ch * kChunk;
    const int n = (int)min((long long)kChunk, E - e0);

    // the sort: each thread's edge keyed by its bin (R: no non-zero basis value)
    int key = 0, rank = 0, keep = 0;
    float d = 1.f, env = 0.f;
    if (tid < n) {
      d = dist[e0 + tid] * inv_cutoff;
      keep = mask[e0 + tid] != 0;
      env = envelope(d, p);
      key = keep && d < 1.f ? min((int)(d * (float)(R - 1)), R - 1) : R;
      rank = atomicAdd(&cnt_s[key], 1);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the R + 1 counts, one contiguous run a lane
      const int per = (R + 1 + 31) / 32, r0 = lane * per, r1 = min(r0 + per, R + 1);
      int sum = 0;
      for (int r = r0; r < r1; ++r) sum += cnt_s[r];
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int run = incl - sum;
      for (int r = r0; r < r1; ++r) {
        const int c = cnt_s[r];
        cnt_s[r] = run;
        run += c;
      }
    }
    __syncthreads();
    if (tid < n) {
      const int pos = cnt_s[key] + rank;
      edge_s[pos] = tid;
      keep_s[pos] = keep;
      d_s[pos] = d;
      env_s[pos] = env;
    }
    __syncthreads();

    // groups of 8 sorted edges, one warp each; lane l builds the basis of edge l % 8
    for (int g = warp; g < (n + kGroup - 1) / kGroup; g += kWarps) {
      const int pos = kGroup * g + (lane & (kGroup - 1));
      const bool live = pos < n;
      const float d_l = live ? d_s[pos] : 1.f, env_l = live ? env_s[pos] : 0.f;
      const int keep_l = live ? keep_s[pos] : 0, edge_l = live ? edge_s[pos] : -1;
      const int bin = min((int)(d_l * (float)(R - 1)), R - 1);
      const bool reach = keep_l && d_l < 1.f;
      const int lo = __reduce_min_sync(0xffffffffu, reach ? max(0, bin - kReach) : R);
      const int hi = __reduce_max_sync(0xffffffffu, reach ? min(R - 1, bin + kReach + 1) : -1);

      float acc[kGroup][4];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int r0 = lo; r0 <= hi; r0 += kPass) {
        const int rows = min(kPass, hi - r0 + 1);
        for (int idx = lane; idx < rows * kGroup; idx += 32) {
          const float diff = d_l - off_s[r0 + idx / kGroup];
          buf[idx] = __expf(coeff * diff * diff) * env_l;  // within the gate, and faster than expf
        }
        __syncwarp();
#pragma unroll kUnroll
        for (int rr = 0; rr < rows; ++rr) {
          const float4 b0 = *reinterpret_cast<const float4*>(buf + rr * kGroup);
          const float4 b1 = *reinterpret_cast<const float4*>(buf + rr * kGroup + 4);
          float wv[4];
          if (STAGE_W) {
            const float4 t = *reinterpret_cast<const float4*>(w_s + (r0 + rr) * kCols + 4 * lane);
            wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
          } else if (VEC) {
            const float4 t = col0 < F ? __ldg(reinterpret_cast<const float4*>(w + (size_t)(r0 + rr) * F + col0))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
            wv[0] = t.x, wv[1] = t.y, wv[2] = t.z, wv[3] = t.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = col0 + j < F ? __ldg(w + (size_t)(r0 + rr) * F + col0 + j) : 0.f;
          }
          const float bv[kGroup] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kGroup; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], wv[j], acc[i][j]);
        }
        __syncwarp();
      }

      const float4 bias4 = *reinterpret_cast<const float4*>(bias_s + 4 * lane);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int edge = __shfl_sync(0xffffffffu, edge_l, i);
        const int kp = __shfl_sync(0xffffffffu, keep_l, i);
        if (edge < 0) continue;
        float* row = out + (size_t)(e0 + edge) * F;
        const float4 v = kp ? make_float4(acc[i][0] + bias4.x, acc[i][1] + bias4.y, acc[i][2] + bias4.z,
                                          acc[i][3] + bias4.w)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        if (VEC) {
          if (col0 < F) __stcs(reinterpret_cast<float4*>(row + col0), v);  // streaming: written once, not read
        } else {
          if (col0 < F) row[col0] = v.x;
          if (col0 + 1 < F) row[col0 + 1] = v.y;
          if (col0 + 2 < F) row[col0 + 2] = v.z;
          if (col0 + 3 < F) row[col0 + 3] = v.w;
        }
      }
    }
    for (int r = tid; r <= R; r += kThreads) cnt_s[r] = 0;
    __syncthreads();
  }
}

template <bool VEC, bool STAGE_W>
int launch(const void* dist, const void* mask, const void* w, const void* bias, void* out, long long E, int R, int F,
           float inv_cutoff, int p, int blocks, int slices, int smem_bytes, cudaStream_t stream) {
  auto kernel = fused_rbf_filter_kernel<VEC, STAGE_W>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, (size_t)smem_bytes, stream>>>(
      static_cast<const float*>(dist), static_cast<const uint8_t*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), E, R, F, inv_cutoff, p, slices);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). All pointers are device pointers of
// contiguous tensors: dist [E] f32 and mask [E] bool (1 byte), the flattened
// lead dims; w [R,F] f32; bias [F] f32; out [E,F] f32 is written. The launch
// is ops/kernels.py::rbf_filter_plan's: `blocks` persistent blocks of 384
// threads, a multiple of the ceil(F / 128) column slices and at most the
// slices x chunks of 384 edges; `stage_w` (W's slice in shared memory),
// `vec` (F % 4 == 0, float4 loads and stores: w and out 16-byte aligned) and
// `smem_bytes`, which must equal this file's layout for R and stage_w (within
// 227 KB). A plan that disagrees returns cudaErrorInvalidValue and launches
// nothing; E = 0 or F = 0 launches nothing. Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int fused_rbf_filter_f32(const void* dist, const void* mask, const void* w, const void* bias, void* out,
                                    long long E, int R, int F, float inv_cutoff, int envelope_exponent, int blocks,
                                    int stage_w, int vec, int smem_bytes, void* stream) {
  if (E <= 0 || F <= 0) return 0;
  const long long slices = (F + kCols - 1) / kCols, chunks = (E + kChunk - 1) / kChunk;
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (R < 2 || envelope_exponent < 0 || blocks < 1 || blocks % slices != 0 || blocks / slices > chunks ||
      smem_bytes != 4 * smem_floats(R, stage_w != 0) || smem_bytes > kSmemMax || (vec && (F % 4 != 0 || !aligned)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sl = (int)slices;
  if (vec) {
    return stage_w ? launch<true, true>(dist, mask, w, bias, out, E, R, F, inv_cutoff, envelope_exponent, blocks,
                                        sl, smem_bytes, s)
                   : launch<true, false>(dist, mask, w, bias, out, E, R, F, inv_cutoff, envelope_exponent, blocks,
                                         sl, smem_bytes, s);
  }
  return stage_w ? launch<false, true>(dist, mask, w, bias, out, E, R, F, inv_cutoff, envelope_exponent, blocks, sl,
                                       smem_bytes, s)
                 : launch<false, false>(dist, mask, w, bias, out, E, R, F, inv_cutoff, envelope_exponent, blocks, sl,
                                        smem_bytes, s);
}

extern "C" const char* fused_rbf_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
