// The attention forward's tile body on Hopper's tensor cores (sm_90a),
// shared by the bf16 rungs of splash_fwd.cu (K6-fwd) and flash_fwd.cu
// (K1). Both compute softmax(q k^T masked) v a 16-row strip of queries
// at a time against streamed 64-key tiles, with an online softmax; they
// differ only in the walk over key tiles, the mask and the scale, which
// the callers own.
//
// One call is one warp's step over one key tile (mma_tile.cuh's layout
// and fragments):
//   S = Q K^T       mma.sync m16n8k16, Q as the A operand (registers or
//                   shared memory), K n-major through ldmatrix;
//   mask            only on tiles the caller flags (the strip's diagonal,
//                   the window's edge, the sequence end): a dropped score
//                   becomes -inf, so its probability is exactly 0;
//   m, l            row max over the quad's four lanes (shfl_xor 1, 2); l
//                   kept per lane and summed over the quad once, at the
//                   end; O's fragments rescaled by 2^((m_old - m) c);
//   P               2^(s c - m c), one FFMA and the hardware's exp2 an
//                   element, c = log2(e) x the softmax scale;
//   O += P V        P split into hi = bf16(p) and lo = bf16(p - hi), two
//                   mma.sync on the same V fragments (V k-major through
//                   ldmatrix.trans).
//
// Why two halves. The reference keeps P in fp32 for P V (jnp.exp, then
// an fp32 dot_general), and the checks hold each output element to 1e-2
// of max(|value|, 2^-8 x the largest |value|). P rounded once to bf16
// (FlashAttention-2's choice) errs by up to 2^-9 of each term; near the
// floor, where the terms of a sum cancel, that reaches 0.2 of the value.
// hi + lo keeps about 16 bits (2^-17), at 1.5x the tensor-core work of
// a bf16 P.
//
// The running max starts at the caller's mask value, which may be so
// large that m c overflows (splash: -0.7 x FLT_MAX x log2(e) < -FLT_MAX).
// So the scaled max is clamped to a finite value, and the correction is
// formed from the difference m_old - m, never from m_old c.

#pragma once

#include <cfloat>
#include <cmath>

#include "mma_tile.cuh"

namespace {
namespace fwd {

using mma::bf16;

using mma::ex2;
using mma::LOG2E;

constexpr int BN = 64;   // keys per tile

// The tiles of a forward kernel at head dim HD. A warp owns a 16-row
// strip; up to hd 128 it holds all of O's columns (64 fp32 registers at
// hd 128) and its Q fragments in registers. At hd 256 O alone would take
// 128 registers, so two warps share each strip, one per half of O's
// columns; both form the strip's scores, reading Q from shared memory.
// 64-row CTAs: at hd 128 a thread holds about 245 registers, so two
// 4-warp CTAs share an SM, each with its own barriers. The kernels state
// a minimum of one CTA an SM in __launch_bounds__: left to itself, ptxas
// caps them at 168 registers (three such CTAs), which spills at hd 96
// and schedules hd 128 about 15% slower. With Q in registers its tile is
// staged in the ring's last slot, which the ring first fills once every
// warp holds its fragments.
template <int HD>
struct Tiles {
  static constexpr int WC = HD > 128 ? HD / 128 : 1;   // warps across O
  static constexpr int BM = 64;                        // query rows a CTA
  static constexpr int WR = BM / 16;                   // warps down
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int STAGES = 2;                     // K/V ring slots
  static constexpr int LD = mma::ld<HD>();
  static constexpr int N8 = HD / WC / 8;               // n8 tiles of O a warp
  static constexpr bool Q_IN_REGISTERS = WC == 1;
  static constexpr size_t KV_BYTES = mma::tile_bytes<BN, HD>();
  static constexpr size_t Q_BYTES =
      Q_IN_REGISTERS ? 0 : mma::tile_bytes<BM, HD>();
  // Q (unless staged in the ring); STAGES slots of (K, V)
  static constexpr size_t SMEM = Q_BYTES + STAGES * 2 * KV_BYTES;
  static_assert(N8 % 2 == 0, "O's columns in whole n16 steps");
  static_assert(!Q_IN_REGISTERS || BM <= 2 * BN, "Q fits a ring slot");

  // where Q is staged: the ring's last slot, or ahead of the ring
  static __device__ bf16* q_tile(unsigned char* smem) {
    bf16* base = reinterpret_cast<bf16*>(smem);
    return Q_IN_REGISTERS ? base + (STAGES - 1) * 2 * BN * LD : base;
  }
  static __device__ bf16* ring(unsigned char* smem) {
    return reinterpret_cast<bf16*>(smem + Q_BYTES);
  }
};

// The A fragments of a warp's 16-row Q strip, for k16 step kk / 16:
// loaded once into registers, or read from shared memory at each use.
template <int HD, bool IN_REGISTERS>
struct QFrags;

template <int HD>
struct QFrags<HD, true> {
  uint32_t a[HD / 16][4];
  __device__ QFrags(const bf16* sq, int row) {
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16)
      mma::load_a<mma::ld<HD>()>(a[kk / 16], sq, row, kk);
  }
  __device__ void operator()(int kk, uint32_t (&x)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[kk / 16][i];
  }
};

template <int HD>
struct QFrags<HD, false> {
  const bf16* sq;
  int row;
  __device__ QFrags(const bf16* sq_, int row_) : sq(sq_), row(row_) {}
  __device__ void operator()(int kk, uint32_t (&x)[4]) const {
    mma::load_a<mma::ld<HD>()>(x, sq, row, kk);
  }
};

// A warp's running state over its strip: O's accumulators (N8 n8 tiles),
// and for this lane's rows g and g + 8 the running max (in score units,
// unscaled) and this lane's share of the running sum.
template <int N8>
struct Strip {
  float o[N8][4];
  float m[2], l[2];

  __device__ explicit Strip(float m0) {
#pragma unroll
    for (int j = 0; j < N8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = m0;
    l[0] = l[1] = 0.f;
  }

  // the row sums over the quad; then O / l in place
  __device__ void finish() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int j = 0; j < N8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[j][x] /= l[x >> 1];
  }
};

// One warp's step over one BN-key tile in shared memory (sk: K, sv: V,
// both padded rows of HD). c0: O's first column this warp owns. c: the
// exp2 scale, log2(e) x the softmax scale. row: this lane's first query
// row (strip row g), key: this lane's first key column (tile column 2t);
// with MASKED, keep(query, key) says which scores live.
template <bool MASKED, int HD, int N8, class Q, class Keep>
__device__ __forceinline__ void tile(Strip<N8>& st, const Q& qf,
                                     const bf16* sk, const bf16* sv, int c0,
                                     float c, int row, int key,
                                     const Keep& keep) {
  constexpr int LD = mma::ld<HD>();
  float s[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    qf(kk, a);
#pragma unroll
    for (int n = 0; n < BN; n += 16) {
      uint32_t b[2][2];
      mma::load_b_nk<LD>(b, sk, n, kk);
      mma::mma_16816(s[n / 8], a, b[0]);
      mma::mma_16816(s[n / 8 + 1], a, b[1]);
    }
  }

  // element x of n8 tile j: query row + 8 (x >> 1), key key + 8 j + (x & 1)
  if (MASKED) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (!keep(row + 8 * (x >> 1), key + 8 * j + (x & 1)))
          s[j][x] = -INFINITY;
  }

  float m[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
    m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
  }
  float mc[2], corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    corr[h] = exp2f((st.m[h] - m[h]) * c);
    mc[h] = fmaxf(m[h] * c, -FLT_MAX);
    st.m[h] = m[h];
  }

  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      s[j][x] = ex2(fmaf(s[j][x], c, -mc[x >> 1]));
      sum[x >> 1] += s[j][x];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * corr[h] + sum[h];
#pragma unroll
  for (int j = 0; j < N8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) st.o[j][x] *= corr[x >> 1];

  // O += (P_hi + P_lo) V, one k16 step of keys at a time
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    uint32_t hi[4], lo[4];
    mma::acc_to_a_split(hi, lo, s[2 * j], s[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < 8 * N8; n += 16) {
      uint32_t b[2][2];
      mma::load_b_kn<LD>(b, sv, 16 * j, c0 + n);
      mma::mma_16816(st.o[n / 8], hi, b[0]);
      mma::mma_16816(st.o[n / 8], lo, b[0]);
      mma::mma_16816(st.o[n / 8 + 1], hi, b[1]);
      mma::mma_16816(st.o[n / 8 + 1], lo, b[1]);
    }
  }
}

}  // namespace fwd
}  // namespace
