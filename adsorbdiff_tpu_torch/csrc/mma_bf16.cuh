// bf16 tensor-core fragments for the kernels' bf16 forms on Hopper (sm_90a):
// ldmatrix loads from shared memory, the m16n8k16 bf16 mma with f32
// accumulators, bf16x2 packing, and the two shared-memory layouts that keep
// ldmatrix free of bank conflicts.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// lane l = 4 g + t (g = l / 4, t = l % 4):
//   A [16 x 16], 4 registers of two bf16: {A[g][2t..2t+1], A[g+8][2t..],
//     A[g][2t+8..], A[g+8][2t+8..]} (the second value in the high half);
//   B [16 x 8], 2 registers: {B[2t..2t+1][g], B[2t+8..2t+9][g]};
//   C, D [16 x 8], 4 f32: {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}.
// So two C fragments of neighbouring n8 tiles, rounded and packed, are
// register for register the A fragment of a product whose k runs over those
// 16 columns (s2_grid_silu_bf16.cu keeps its grid in registers that way).
//
// ldmatrix: lane l gives the shared address of row l % 8 of 8x8 matrix l / 8
// (16 bytes a row); register j receives matrix j. stmatrix, with the same
// addresses, stores the registers back where ldmatrix would read them. Without .trans lane l gets
// row g, elements 2t, 2t+1; with .trans, column g, rows 2t, 2t+1.
// - A from an [m][k] array (k contiguous): no .trans, lane l addresses row
//   m0 + l % 16, column k0 + 8 (l / 16).
// - A from a [k][m] array (m contiguous): .trans, lane l addresses row
//   k0 + 8 (l / 16) + l % 8, column m0 + 8 ((l / 8) % 2).
// - B from a [k][n] array (n contiguous, a weight matrix as stored): .trans,
//   lane l addresses row k0 + l % 16 of n tile l / 16 (x4: two n tiles).
// - B from an [n][k] array (k contiguous): no .trans, lane l addresses row
//   n0 + l % 8 (+ 8 for lanes 16-31 in x4: the second n tile), column k0 +
//   8 ((l / 8) % 2).
// Eight rows read together must lie on eight different 16-byte bank groups:
// either rows of 64 bytes with the XOR swizzle swz64, or any row length
// padded to an odd number of 16-byte chunks (odd_stride).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]),
               "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a b: one m16n8k16 product of bf16 values summed in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// the two bf16 of v widened to f32
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// a b and a + b on both bf16 halves, each result rounded to bf16 once
// (nearest even; subnormals kept)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// both bf16 of v negated (exact)
__device__ __forceinline__ uint32_t neg_bf16x2(uint32_t v) { return v ^ 0x80008000u; }

// Byte offset of 16-byte chunk c (0-3) of row r in an array of 64-byte rows:
// the chunk index XOR (r / 2) % 4, so the eight rows r0 .. r0 + 7 (r0 a
// multiple of 8) of one logical chunk fall on eight bank groups.
__host__ __device__ __forceinline__ int swz64(int r, int c) { return r * 64 + 16 * (c ^ ((r >> 1) & 3)); }

// Row stride in bf16 elements for rows of n elements (n a multiple of 8): an
// odd number of 16-byte chunks, so eight consecutive rows fall on eight bank
// groups whatever n is.
__host__ __device__ __forceinline__ int odd_stride(int n) { return ((n / 8) | 1) * 8; }

}  // namespace mma
