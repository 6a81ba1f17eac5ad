// The tensor-core tile loop for Hopper (sm_90a), for kernel sources that
// compute on bf16 tiles: warp-level mma.sync products with fp32
// accumulators, operands read from shared memory with ldmatrix, tiles
// (and the row statistics beside them) filled by a cp.async ring, and
// the SFU's exp2 for the probabilities between two products.
//
// Shared-memory layout. A tile is ROWS rows of COLS bf16 values, each row
// padded by 16 bytes: ld<COLS>() = COLS + 8 elements a row. For 128- and
// 256-wide rows (256 and 512 bytes, both multiples of the 128-byte bank
// line) the pad moves each row 4 banks on, so the eight 16-byte row reads
// of one ldmatrix 8 x 8 matrix fall in eight disjoint groups of 4 banks:
// no bank conflict. cp.async writes whole 16-byte chunks, so a row of
// device memory must start 16-byte aligned (COLS % 8 == 0).
//
// Fragments of mma.m16n8k16 with bf16 operands (PTX ISA): lane l holds,
// with g = l / 4 and t = l % 4,
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9) a3 (g+8, 2t+8..2t+9)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)        c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// with the lower index in the low half of each register. So the fp32
// accumulators of two neighbouring n8 tiles, rounded to bf16 and packed in
// pairs (acc_to_a), are the A fragment of one k16 step: FlashAttention-2's
// register reuse, which keeps a product's result (P, dS) out of shared
// memory when it is the left operand of the next product.
//
// The ring. STAGES slots, one cp.async commit group per tile:
//   for s < STAGES - 1: start tile s into slot s (if it exists); commit()
//   for each tile i:    ring_wait<STAGES>()   // tile i is in slot i % STAGES
//                                             // for every thread, and the
//                                             // slot of tile i - 1 is free
//                       start tile i + STAGES - 1 into slot
//                       (i + STAGES - 1) % STAGES (if it exists); commit()
//                       compute on slot i % STAGES
// One barrier a tile; the copies of the next STAGES - 1 tiles are in
// flight while a tile is computed on.

#pragma once

#include <cuda_bf16.h>
#include <cstddef>
#include <cstdint>

namespace {
namespace mma {

using bf16 = __nv_bfloat16;

// elements a padded shared-memory row of COLS bf16 values takes
template <int COLS> __host__ __device__ constexpr int ld() { return COLS + 8; }

template <int ROWS, int COLS>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(bf16) * (size_t)ROWS * ld<COLS>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- the cp.async ring --------------------------------------------------

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of every tile but the newest N have landed
template <int N> __device__ __forceinline__ void wait_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the oldest tile in flight has landed for every thread of the block, and
// every thread is done with the tile before it
template <int STAGES> __device__ __forceinline__ void ring_wait() {
  static_assert(STAGES >= 2, "a ring has at least two slots");
  wait_newest<STAGES - 2>();
  __syncthreads();
}

// Start (not wait for) the copy of ROWS rows of COLS bf16 values, device
// rows `stride` elements apart, into a padded tile; THREADS threads, 16
// bytes each a step.
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride) {
  static_assert(COLS % 8 == 0, "rows of whole 16-byte chunks");
  constexpr int CHUNKS = COLS / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    cp_async_16(dst + r * ld<COLS>() + c, src + (size_t)r * stride + c);
  }
}

// cp_async_16 that copies `bytes` (16 or 0) and zero-fills the rest of
// the 16: with 0 nothing is read from src, which must still be a valid
// address
__device__ __forceinline__ void cp_async_16_zfill(void* dst, const void* src,
                                                  int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// load_tile for a tile that may run past the end of the data: rows at or
// past `n_rows` are zero-filled and read nothing (n_rows <= 0: all zero).
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile_rows(bf16* dst, const bf16* src,
                                               size_t stride, int n_rows) {
  static_assert(COLS % 8 == 0, "rows of whole 16-byte chunks");
  constexpr int CHUNKS = COLS / 8;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool live = r < n_rows;
    cp_async_16_zfill(dst + r * ld<COLS>() + c,
                      src + (live ? (size_t)r * stride + c : 0),
                      live ? 16 : 0);
  }
}

// Start the copy of N contiguous fp32 values (N % 4 == 0, 16-byte aligned)
template <int N, int THREADS>
__device__ __forceinline__ void load_f32(float* dst, const float* src) {
  static_assert(N % 4 == 0, "whole 16-byte chunks");
  for (int i = threadIdx.x; i < N / 4; i += THREADS)
    cp_async_16(dst + 4 * i, src + 4 * i);
}

// Start the copy of N fp32 values, one cp.async of 4 bytes each, so src
// need only be 4-byte aligned (a row statistic at any offset): values at
// or past n are zero-filled and read nothing (n <= 0: all zero).
template <int N, int THREADS>
__device__ __forceinline__ void load_f32_rows(float* dst, const float* src,
                                              int n) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool live = i < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst + i)),
                 "l"(src + (live ? i : 0)), "r"(live ? 4 : 0)
                 : "memory");
  }
}

// ---- elementwise ----------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU, subnormal results flushed to 0: for a probability, where
// a term below 2^-126 adds nothing to an fp32 sum of order 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- fragments ------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The A fragment of the 16 x 16 block at (row, col) of a row-major tile
// with LD elements a row.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row, int col) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + (row + (l & 15)) * LD + col + (l >> 4) * 8);
}

// The B fragments of two n8 tiles (columns n..n+7, n+8..n+15) at depth
// k..k+15, from a tile stored n-major (rows n, columns k: B is the tile
// transposed), e.g. K in S = Q K^T.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2][2],
                                          const bf16* tile, int n, int k) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4(r, tile + (n + (l >> 4) * 8 + (l & 7)) * LD + k + ((l >> 3) & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The same from a tile stored k-major (rows k, columns n), read through
// ldmatrix.trans, e.g. K in dQ = dS K.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2][2],
                                          const bf16* tile, int k, int n) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm_x4_trans(r, tile + (k + ((l >> 3) & 1) * 8 + (l & 7)) * LD + n +
                       (l >> 4) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// c += a b on the tensor cores, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two fp32 values rounded to bf16 (to nearest even) in one register, lo in
// the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one k16 step from the fp32 accumulators of the two n8
// tiles that cover its columns (lo: k..k+7, hi: k+8..k+15), rounded to
// bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// acc_to_a with the rounding error kept: hi = bf16(x) and lo =
// bf16(x - hi), so hi + lo holds x to about 16 significant bits, and
// (hi + lo) b, as two products on the same B fragments, is x b to about
// 2^-17 of each term where hi b alone is to 2^-9.
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&a)[4],
                                               const float (&b)[4]) {
  const float x[8] = {a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - hf.x, x[2 * i + 1] - hf.y);
  }
}

// This lane's place in a C fragment: row g (and g + 8), column 2t (and
// 2t + 1) of each n8 tile.
__device__ __forceinline__ int frag_row() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int frag_col() { return (threadIdx.x & 3) * 2; }

// Write the fp32 accumulators of a 16 x (8 N8) strip as bf16 to device
// memory at dst (rows `stride` elements apart), a column pair a store.
template <int N8>
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride,
                                          const float (&acc)[N8][4]) {
  const int g = frag_row(), c = frag_col();
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)g * stride + 8 * j + c) =
        __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(g + 8) * stride +
                                       8 * j + c) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

// store_acc of the strip's first n_rows rows only (rows past the data)
template <int N8>
__device__ __forceinline__ void store_acc(bf16* dst, size_t stride,
                                          const float (&acc)[N8][4],
                                          int n_rows) {
  const int g = frag_row(), c = frag_col();
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    if (g < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)g * stride + 8 * j +
                                         c) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (g + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(g + 8) * stride +
                                         8 * j + c) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

}  // namespace mma
}  // namespace
