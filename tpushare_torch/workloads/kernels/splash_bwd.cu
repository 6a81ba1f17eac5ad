// Splash-attention backward for Hopper (sm_90a): the dQ and dK/dV kernels.
//
// Replaces the upstream splash backward kernels (jax's
// pallas/ops/tpu/splash_attention/splash_attention_kernel.py
// _flash_attention_dq_kernel under _splash_attention_bwd_dq, and
// _flash_attention_dkv_kernel under _splash_attention_bwd_dkv, non-fused
// as the reference's _build_prefill_splash configures them), which run
// when a gradient is taken through the splash forward (splash_fwd.cu).
//
// What they compute, from the forward's residuals — the pre-scaled q,
// k, v (B, S, H, hd), the row log-sum-exp lse (B, H, S) fp32 — the
// cotangent dO and di = rowsum(o * dO) (B, H, S) fp32 (computed outside,
// as upstream does), under the causal mask (dropped scores at
// -0.7 * FLT_MAX, so their probabilities are exactly 0):
//
//   P  = exp(q k^T - lse)            dP = dO v^T        dS = P o (dP - di)
//   dQ = round(dS) k                                     (dq kernel)
//   dV = round(P)^T dO,  dK = round(dS)^T q              (dkv kernel)
//
// ``round`` is to the input dtype (upstream's p.astype(do.dtype),
// ds.astype(do.dtype) and ds.astype(k.dtype)); products accumulate in
// fp32 and each gradient is written once in the input dtype. No scale:
// q was pre-scaled, and the scale's gradient flows outside.
//
// Schedules (ops/splash_mask.py), one block edge b: the dq kernel walks
// the forward schedule (per query block, its key blocks), the dkv kernel
// the dK/dV schedule (per key block, the query blocks that see it). The
// causal mask is applied only inside partial blocks; there, the tiles
// the mask leaves empty (keys past the query tile's last row, queries
// before the key tile's first row) are not read — their P and dS are 0.
//
// Blocks run in parallel and in no order, so upstream's sequential grid
// axis becomes a loop inside one CTA, and no sum crosses CTAs: one CTA
// owns a query tile (dq) or a key tile (dkv) and loops over the other
// axis. No atomics, so the gradients are deterministic: two launches on
// the same inputs give the same bits.
//
// Bound on this card: operations. Five S x S x hd products on the live
// pairs at the least (this two-kernel design recomputes q k^T and dO v^T
// in both, seven in all: three in dq, four in dkv) against reading each
// input once: at the long-context shape (S = 4096, hd 128) about 1,200
// operations a byte in dq and 1,400 in dkv, far above the 295 at which
// the bf16 tensor cores, and not device memory, set the pace.
//
// bf16: tensor cores (mma_tile.cuh). Warps own 16-row strips; every
// product is mma.sync m16n8k16 over bf16 tiles in shared memory with
// fp32 accumulators:
// - dq: one CTA per (64-row query tile, b*H + h). Q and dO are staged
//   once; 64-row K/V tiles stream through a two-slot cp.async ring.
//   S = Q K^T and dP = dO V^T read K and V as the n-major B operand;
//   dS is formed and rounded to bf16 in registers (the causal mask per
//   accumulator element, on tiles that cross the diagonal) and is the A
//   operand of dQ += dS K, K read k-major through ldmatrix.trans.
// - dkv: one CTA per (64-row key tile, b*H + h). K and V are staged
//   once; 32-row Q/dO tiles with their lse and di stream through a
//   three-slot ring. S^T = K Q^T and dP^T = V dO^T, P^T and dS^T rounded
//   in registers, then dV += P^T dO and dK += dS^T Q with dO and Q read
//   through ldmatrix.trans.
// P is 2^(s log2(e) - lse log2(e)): one FFMA and the hardware's exp2 an
// element, the mask's compare and select only on the tiles that cross
// the diagonal. The elementwise work is a large share of a warp's
// instructions: expf and a select on every element cost a quarter of
// the kernels' time.
// A warp's accumulators cover 128 head-dim columns: at hd 256 two warps
// share each 16-row strip, one per half of the columns, and both form
// the strip's scores (the score products run twice there; hd 256 is off
// the main paths). At hd 128 a dkv thread holds 2 x 64 accumulator
// registers and 2 x 16 for the scores, a dq thread 64 and 2 x 32; with
// the operand fragments that is close to 255, so a warp cannot take a
// taller strip, and every warp reads the whole streamed tile through
// ldmatrix: shared-memory reads now bound the kernels short of the
// tensor cores' rate. Shared memory at hd 128: dq 102 KiB, dkv 86 KiB
// (two CTAs an SM); at hd 256: 198 KiB and 166 KiB.
//
// fp32: CUDA cores. On tensor cores fp32 operands run as TF32, about 13
// bits fewer than fp32, which the fp32 backward's limit (1e-4 of each
// gradient's scale) would rightly refuse. So fp32 stays on plain FMAs:
// 256 threads as a 16 x 16 grid over fp32 tiles in shared memory (row
// stride hd + 1), each tile loaded between two barriers. BQ is 64 at hd
// 128 and 32 at hd 256, so the tiles fit the 227 KiB a block may use.

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int PARTIAL = 1;      // schedule kinds: 1 partial, 2 full

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using mma::bf16;

// The tiles of one CTA's walk along a row of a block schedule: for each
// live block in order, STEP-row tiles from the block's first row (raised
// to lo inside a partial block) to its end (lowered to hi inside a
// partial block).
template <int STEP>
struct Walk {
  const int* blocks;
  const int* kinds;
  int e, e_end, block, lo, hi;
  int pos, end;      // the current tile's first row; its block's end
  bool partial;

  __device__ Walk(const int* offsets, const int* blocks_, const int* kinds_,
                  int r, int block_, int lo_, int hi_)
      : blocks(blocks_), kinds(kinds_), e(offsets[r]), e_end(offsets[r + 1]),
        block(block_), lo(lo_), hi(hi_) {
    enter();
  }
  __device__ bool done() const { return e >= e_end; }
  __device__ void next() {
    pos += STEP;
    if (pos >= end) {
      ++e;
      enter();
    }
  }
  __device__ void enter() {
    for (; e < e_end; ++e) {
      partial = kinds[e] == PARTIAL;
      const int base = blocks[e] * block;
      pos = partial ? max(base, lo) : base;
      end = partial ? min(base + block, hi) : base + block;
      if (pos < end) return;
    }
  }
};

constexpr float LOG2E = 1.4426950408889634f;

// P = exp(s - lse) as 2^(s log2(e) - lse2), lse2 = lse log2(e) formed
// once a row: one FFMA and the hardware's exp2 an element
__device__ __forceinline__ float prob(float s, float lse2) {
  return exp2f(fmaf(s, LOG2E, -lse2));
}

// dq: dS = P o (dP - di) over a warp's C fragments, in place of s. Element
// x of n8 tile j is (query r + 8 (x >> 1), key kc + 8 j + (x & 1)); with
// MASKED, keys past their query get P = 0.
template <bool MASKED, int N8>
__device__ __forceinline__ void dq_ds(float (&s)[N8][4],
                                      const float (&dp)[N8][4], int r,
                                      int kc, const float (&lse2)[2],
                                      const float (&di)[2]) {
#pragma unroll
  for (int j = 0; j < N8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int hi = x >> 1;
      float p = prob(s[j][x], lse2[hi]);
      if (MASKED && kc + 8 * j + (x & 1) > r + 8 * hi) p = 0.f;
      s[j][x] = p * (dp[j][x] - di[hi]);
    }
}

// dkv: P^T in place of s, dS^T in place of dp. Element x of n8 tile j is
// (key kr + 8 (x >> 1), query q0 + 8 j + fc + (x & 1)); slse / sdi the
// query tile's lse and di; with MASKED, keys past their query get P = 0.
template <bool MASKED, int N8>
__device__ __forceinline__ void dkv_p_ds(float (&s)[N8][4],
                                         float (&dp)[N8][4], int kr, int q0,
                                         int fc, const float* slse,
                                         const float* sdi) {
#pragma unroll
  for (int j = 0; j < N8; ++j) {
    const int ql = 8 * j + fc;
    const float lse2[2] = {slse[ql] * LOG2E, slse[ql + 1] * LOG2E};
    const float di[2] = {sdi[ql], sdi[ql + 1]};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int c = x & 1;
      float p = prob(s[j][x], lse2[c]);
      if (MASKED && kr + 8 * (x >> 1) > q0 + ql + c) p = 0.f;
      s[j][x] = p;
      dp[j][x] = p * (dp[j][x] - di[c]);
    }
  }
}

template <int HD>
struct DqTiles {
  static constexpr int BQ = 64, BK = 64, STAGES = 2;
  static constexpr int WC = HD / 128;           // warps across head_dim
  static constexpr int WR = BQ / 16;            // warps down the tile
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int LD = mma::ld<HD>();
  static constexpr int ACC = HD / WC / 8;       // n8 tiles of dQ a warp
  static constexpr size_t Q_BYTES = mma::tile_bytes<BQ, HD>();
  static constexpr size_t KV_BYTES = mma::tile_bytes<BK, HD>();
  // Q, dO; STAGES slots of (K, V)
  static constexpr size_t SMEM = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int HD>
struct DkvTiles {
  static constexpr int BK = 64, BQ = 32, STAGES = 3;
  static constexpr int WC = HD / 128;
  static constexpr int WR = BK / 16;
  static constexpr int THREADS = 32 * WR * WC;
  static constexpr int LD = mma::ld<HD>();
  static constexpr int ACC = HD / WC / 8;       // n8 tiles of dK, dV a warp
  static constexpr size_t KV_BYTES = mma::tile_bytes<BK, HD>();
  static constexpr size_t Q_BYTES = mma::tile_bytes<BQ, HD>();
  // a slot: Q, dO, then lse and di of its BQ rows
  static constexpr size_t SLOT = 2 * Q_BYTES + 2 * sizeof(float) * BQ;
  // K, V; STAGES slots
  static constexpr size_t SMEM = 2 * KV_BYTES + STAGES * SLOT;
};

template <int HD>
__global__ void __launch_bounds__(DqTiles<HD>::THREADS)
    splash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, bf16* __restrict__ dq,
                      const int* __restrict__ offsets,
                      const int* __restrict__ blocks,
                      const int* __restrict__ kinds, int S, int H,
                      int block) {
  using C = DqTiles<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + C::BQ * LD;
  bf16* ring = sdo + C::BQ * LD;   // STAGES slots of (K, V)

  const int warp = threadIdx.x >> 5;
  const int wr = warp % C::WR;                  // 16-row strip
  const int c0 = (warp / C::WR) * (HD / C::WC); // first dQ column
  const int g = mma::frag_row(), fc = mma::frag_col();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;   // heaviest first
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const size_t step = (size_t)H * HD;
  const size_t off = (size_t)b * S * step + (size_t)h * HD;

  // this lane's query rows: r and r + 8
  const int r = q0 + wr * 16 + g;
  const float lse2[2] = {lse[(size_t)row * S + r] * LOG2E,
                         lse[(size_t)row * S + r + 8] * LOG2E};
  const float di_r[2] = {di[(size_t)row * S + r],
                         di[(size_t)row * S + r + 8]};

  auto slot_k = [&](int i) { return ring + (i % C::STAGES) * 2 * C::BK * LD; };
  auto fill = [&](int i, int k0) {
    bf16* sk = slot_k(i);
    mma::load_tile<C::BK, HD, C::THREADS>(sk, k + off + k0 * step, step);
    mma::load_tile<C::BK, HD, C::THREADS>(sk + C::BK * LD,
                                          v + off + k0 * step, step);
  };

  // Q and dO join the first tile's commit group
  mma::load_tile<C::BQ, HD, C::THREADS>(sq, q + off + q0 * step, step);
  mma::load_tile<C::BQ, HD, C::THREADS>(sdo, dout + off + q0 * step, step);
  const int qblk = q0 / block;
  // keys past the query tile's last row are masked out: not read
  Walk<C::BK> walk(offsets, blocks, kinds, qblk, block, 0, q0 + C::BQ);
  Walk<C::BK> ahead = walk;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (!ahead.done()) {
      fill(s, ahead.pos);
      ahead.next();
    }
    mma::commit();
  }

  float acc[C::ACC][4];
#pragma unroll
  for (int j = 0; j < C::ACC; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; !walk.done(); ++i, walk.next()) {
    mma::ring_wait<C::STAGES>();
    if (!ahead.done()) {
      fill(i + C::STAGES - 1, ahead.pos);
      ahead.next();
    }
    mma::commit();
    const bf16* sk = slot_k(i);
    const bf16* sv = sk + C::BK * LD;   // the slot's V tile
    const int k0 = walk.pos;

    // s = Q K^T, dp = dO V^T: this warp's 16 rows x BK keys
    float s[C::BK / 8][4], dp[C::BK / 8][4];
#pragma unroll
    for (int j = 0; j < C::BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t aq[4], ado[4];
      mma::load_a<LD>(aq, sq, wr * 16, kk);
      mma::load_a<LD>(ado, sdo, wr * 16, kk);
#pragma unroll
      for (int n = 0; n < C::BK; n += 16) {
        uint32_t bk[2][2], bv[2][2];
        mma::load_b_nk<LD>(bk, sk, n, kk);
        mma::load_b_nk<LD>(bv, sv, n, kk);
        mma::mma_16816(s[n / 8], aq, bk[0]);
        mma::mma_16816(s[n / 8 + 1], aq, bk[1]);
        mma::mma_16816(dp[n / 8], ado, bv[0]);
        mma::mma_16816(dp[n / 8 + 1], ado, bv[1]);
      }
    }

    // dS = P o (dP - di) into s; the mask only where this strip's rows
    // and the tile's keys cross the diagonal
    if (walk.partial && k0 + C::BK - 1 > q0 + wr * 16)
      dq_ds<true>(s, dp, r, k0 + fc, lse2, di_r);
    else
      dq_ds<false>(s, dp, r, k0 + fc, lse2, di_r);

    // dQ += round(dS) K: dS the register A operand, K read k-major
#pragma unroll
    for (int j = 0; j < C::BK / 16; ++j) {
      uint32_t ads[4];
      mma::acc_to_a(ads, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < HD / C::WC; n += 16) {
        uint32_t bk[2][2];
        mma::load_b_kn<LD>(bk, sk, 16 * j, c0 + n);
        mma::mma_16816(acc[n / 8], ads, bk[0]);
        mma::mma_16816(acc[n / 8 + 1], ads, bk[1]);
      }
    }
  }

  mma::store_acc<C::ACC>(dq + off + (size_t)(q0 + wr * 16) * step + c0, step,
                         acc);
}

template <int HD>
__global__ void __launch_bounds__(DkvTiles<HD>::THREADS)
    splash_bwd_dkv_mma(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, bf16* __restrict__ dk,
                       bf16* __restrict__ dv,
                       const int* __restrict__ offsets,
                       const int* __restrict__ blocks,
                       const int* __restrict__ kinds, int S, int H,
                       int block) {
  using C = DkvTiles<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + C::KV_BYTES);
  unsigned char* ring = smem + 2 * C::KV_BYTES;

  const int warp = threadIdx.x >> 5;
  const int wr = warp % C::WR;
  const int c0 = (warp / C::WR) * (HD / C::WC); // first dK/dV column
  const int g = mma::frag_row(), fc = mma::frag_col();
  // key tile 0 first: under causal masking it sees the most query tiles
  const int k0 = blockIdx.x * C::BK;
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const size_t step = (size_t)H * HD;
  const size_t off = (size_t)b * S * step + (size_t)h * HD;
  const float* lrow = lse + (size_t)row * S;
  const float* drow = di + (size_t)row * S;

  // this lane's key rows: kr and kr + 8
  const int kr = k0 + wr * 16 + g;

  auto slot = [&](int i) { return ring + (i % C::STAGES) * C::SLOT; };
  auto fill = [&](int i, int q0) {
    unsigned char* p = slot(i);
    mma::load_tile<C::BQ, HD, C::THREADS>(reinterpret_cast<bf16*>(p),
                                          q + off + q0 * step, step);
    mma::load_tile<C::BQ, HD, C::THREADS>(
        reinterpret_cast<bf16*>(p + C::Q_BYTES), dout + off + q0 * step,
        step);
    float* stats = reinterpret_cast<float*>(p + 2 * C::Q_BYTES);
    mma::load_f32<C::BQ, C::THREADS>(stats, lrow + q0);
    mma::load_f32<C::BQ, C::THREADS>(stats + C::BQ, drow + q0);
  };

  // K and V join the first tile's commit group
  mma::load_tile<C::BK, HD, C::THREADS>(sk, k + off + k0 * step, step);
  mma::load_tile<C::BK, HD, C::THREADS>(sv, v + off + k0 * step, step);
  const int kblk = k0 / block;
  // query rows before this key tile see none of it: not read
  Walk<C::BQ> walk(offsets, blocks, kinds, kblk, block, k0, S);
  Walk<C::BQ> ahead = walk;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (!ahead.done()) {
      fill(s, ahead.pos);
      ahead.next();
    }
    mma::commit();
  }

  float dk_acc[C::ACC][4], dv_acc[C::ACC][4];
#pragma unroll
  for (int j = 0; j < C::ACC; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[j][x] = dv_acc[j][x] = 0.f;

  for (int i = 0; !walk.done(); ++i, walk.next()) {
    mma::ring_wait<C::STAGES>();
    if (!ahead.done()) {
      fill(i + C::STAGES - 1, ahead.pos);
      ahead.next();
    }
    mma::commit();
    const unsigned char* p = slot(i);
    const bf16* sq = reinterpret_cast<const bf16*>(p);
    const bf16* sdo = reinterpret_cast<const bf16*>(p + C::Q_BYTES);
    const float* slse = reinterpret_cast<const float*>(p + 2 * C::Q_BYTES);
    const float* sdi = slse + C::BQ;
    const int q0 = walk.pos;

    // s^T = K Q^T, dp^T = V dO^T: this warp's 16 key rows x BQ queries
    float s[C::BQ / 8][4], dp[C::BQ / 8][4];
#pragma unroll
    for (int j = 0; j < C::BQ / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t ak[4], av[4];
      mma::load_a<LD>(ak, sk, wr * 16, kk);
      mma::load_a<LD>(av, sv, wr * 16, kk);
#pragma unroll
      for (int n = 0; n < C::BQ; n += 16) {
        uint32_t bq[2][2], bdo[2][2];
        mma::load_b_nk<LD>(bq, sq, n, kk);
        mma::load_b_nk<LD>(bdo, sdo, n, kk);
        mma::mma_16816(s[n / 8], ak, bq[0]);
        mma::mma_16816(s[n / 8 + 1], ak, bq[1]);
        mma::mma_16816(dp[n / 8], av, bdo[0]);
        mma::mma_16816(dp[n / 8 + 1], av, bdo[1]);
      }
    }

    // P^T into s, dS^T into dp; the mask only where the strip's keys and
    // the tile's queries cross the diagonal
    if (walk.partial && k0 + wr * 16 + 15 > q0)
      dkv_p_ds<true>(s, dp, kr, q0, fc, slse, sdi);
    else
      dkv_p_ds<false>(s, dp, kr, q0, fc, slse, sdi);

    // dV += round(P)^T dO, dK += round(dS)^T Q: register A operands, dO
    // and Q read k-major
#pragma unroll
    for (int j = 0; j < C::BQ / 16; ++j) {
      uint32_t ap[4], ads[4];
      mma::acc_to_a(ap, s[2 * j], s[2 * j + 1]);
      mma::acc_to_a(ads, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int n = 0; n < HD / C::WC; n += 16) {
        uint32_t bdo[2][2], bq[2][2];
        mma::load_b_kn<LD>(bdo, sdo, 16 * j, c0 + n);
        mma::load_b_kn<LD>(bq, sq, 16 * j, c0 + n);
        mma::mma_16816(dv_acc[n / 8], ap, bdo[0]);
        mma::mma_16816(dv_acc[n / 8 + 1], ap, bdo[1]);
        mma::mma_16816(dk_acc[n / 8], ads, bq[0]);
        mma::mma_16816(dk_acc[n / 8 + 1], ads, bq[1]);
      }
    }
  }

  const size_t at = off + (size_t)(k0 + wr * 16) * step + c0;
  mma::store_acc<C::ACC>(dk + at, step, dk_acc);
  mma::store_acc<C::ACC>(dv + at, step, dv_acc);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16

template <int HD>
__host__ __device__ constexpr int query_tile() { return HD > 128 ? 32 : 64; }

// Stage ROWS sequence rows of one head of a (B, S, H, HD) tensor,
// starting at position r0, into shared memory with row stride HD + 1.
template <int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      size_t step, int r0) {
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    dst[r * (HD + 1) + d] = src[(size_t)(r0 + r) * step + d];
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = query_tile<HD>();
  // Q, dO, K, V at HD + 1 floats a row; the dS tile at BK + 1
  return sizeof(float) *
         (size_t)(2 * BQ * (HD + 1) + 2 * BK * (HD + 1) + BQ * (BK + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  constexpr int BQ = query_tile<HD>();
  // K, V, Q, dO at HD + 1 floats a row; P^T and dS^T at BQ + 1; lse and
  // di of the query tile
  return sizeof(float) * (size_t)(2 * BK * (HD + 1) + 2 * BQ * (HD + 1) +
                                  2 * BK * (BQ + 1) + 2 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dq_fma(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ di, float* __restrict__ dq,
                      const int* __restrict__ offsets,
                      const int* __restrict__ blocks,
                      const int* __restrict__ kinds, int S, int H,
                      int block) {
  constexpr int BQ = query_tile<HD>();
  constexpr int RM = BQ / 16;   // query rows per thread
  constexpr int LD = HD + 1;
  constexpr int PS = BK + 1;
  constexpr int DJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float fsmem[];
  float* sq = fsmem;             // BQ x LD
  float* sdo = sq + BQ * LD;     // BQ x LD
  float* sk = sdo + BQ * LD;     // BK x LD
  float* sv = sk + BK * LD;      // BK x LD
  float* sds = sv + BK * LD;     // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int q_last = q0 + BQ - 1;
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;

  const size_t step = (size_t)H * HD;
  const size_t off = (size_t)b * S * step + (size_t)h * HD;

  stage<HD, BQ>(sq, q + off, step, q0);
  stage<HD, BQ>(sdo, dout + off, step, q0);
  float lse_r[RM], di_r[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    lse_r[i] = lse[(size_t)row * S + qi];
    di_r[i] = di[(size_t)row * S + qi];
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int qblk = q0 / block;
  for (int e = offsets[qblk]; e < offsets[qblk + 1]; ++e) {
    const bool partial = kinds[e] == PARTIAL;
    const int k_begin = blocks[e] * block;
    const int k_end = partial ? min(k_begin + block, q_last + 1)
                              : k_begin + block;
    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      __syncthreads();   // the previous tile's readers are done
      stage<HD, BK>(sk, k + off, step, k0);
      stage<HD, BK>(sv, v + off, step, k0);
      __syncthreads();

      // s = q k^T and dp = dO v^T: rows ty*RM + i, keys tx + 16*j
      float s[RM][4], dp[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[RM], dov[RM], kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          qv[i] = sq[(ty * RM + i) * LD + d];
          dov[i] = sdo[(ty * RM + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = sk[(tx + 16 * j) * LD + d];
          vv[j] = sv[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }

      // dS = P o (dP - di) into shared memory (fp32: no rounding)
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool dropped = partial && k0 + tx + 16 * j > qi;
          const float p = dropped ? 0.f : expf(s[i][j] - lse_r[i]);
          sds[(ty * RM + i) * PS + tx + 16 * j] = p * (dp[i][j] - di_r[i]);
        }
      }
      __syncthreads();

      // acc += dS k: rows ty*RM + i, head-dim columns tx + 16*j
#pragma unroll 4
      for (int c = 0; c < BK; ++c) {
        float dsv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) dsv[i] = sds[(ty * RM + i) * PS + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float kk = sk[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
        }
      }
    }
  }

  float* dqb = dq + off;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(size_t)qi * step + tx + 16 * j] = acc[i][j];
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dkv_fma(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ di, float* __restrict__ dk,
                       float* __restrict__ dv,
                       const int* __restrict__ offsets,
                       const int* __restrict__ blocks,
                       const int* __restrict__ kinds, int S, int H,
                       int block) {
  constexpr int BQ = query_tile<HD>();
  constexpr int CQ = BQ / 16;   // query columns per thread
  constexpr int LD = HD + 1;
  constexpr int PS = BQ + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float fsmem[];
  float* sk = fsmem;             // BK x LD
  float* sv = sk + BK * LD;      // BK x LD
  float* sq = sv + BK * LD;      // BQ x LD
  float* sdo = sq + BQ * LD;     // BQ x LD
  float* sp = sdo + BQ * LD;     // BK x PS: P^T
  float* sds = sp + BK * PS;     // BK x PS: dS^T
  float* slse = sds + BK * PS;   // BQ
  float* sdi = slse + BQ;        // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // key tile 0 first: under causal masking it sees the most query tiles
  const int k0 = blockIdx.x * BK;
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;

  const size_t step = (size_t)H * HD;
  const size_t off = (size_t)b * S * step + (size_t)h * HD;
  const float* lrow = lse + (size_t)row * S;
  const float* drow = di + (size_t)row * S;

  stage<HD, BK>(sk, k + off, step, k0);
  stage<HD, BK>(sv, v + off, step, k0);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int kblk = k0 / block;
  for (int e = offsets[kblk]; e < offsets[kblk + 1]; ++e) {
    const bool partial = kinds[e] == PARTIAL;
    const int q_end = (blocks[e] + 1) * block;
    // in a partial block, query rows before this key tile see none of it
    const int q_begin = partial ? max(blocks[e] * block, k0)
                                : blocks[e] * block;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous tile's readers are done
      stage<HD, BQ>(sq, q + off, step, q0);
      stage<HD, BQ>(sdo, dout + off, step, q0);
      for (int i = tid; i < BQ; i += THREADS) {
        slse[i] = lrow[q0 + i];
        sdi[i] = drow[q0 + i];
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T: key rows ty*4 + i, queries
      // tx + 16*j
      float s[4][CQ], dp[4][CQ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[CQ], dov[CQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sk[(ty * 4 + i) * LD + d];
          vv[i] = sv[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qv[j] = sq[(tx + 16 * j) * LD + d];
          dov[j] = sdo[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int ql = tx + 16 * j;
          const bool dropped = partial && kj > q0 + ql;
          const float p = dropped ? 0.f : expf(s[i][j] - slse[ql]);
          sp[(ty * 4 + i) * PS + ql] = p;
          sds[(ty * 4 + i) * PS + ql] = p * (dp[i][j] - sdi[ql]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T q: key rows ty*4 + i, head-dim columns
      // tx + 16*j
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sp[(ty * 4 + i) * PS + c];
          dsv[i] = sds[(ty * 4 + i) * PS + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float dd = sdo[c * LD + tx + 16 * j];
          const float qq = sq[c * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(pv[i], dd, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qq, dk_acc[i][j]);
          }
        }
      }
    }
  }

  float* dkb = dk + off;
  float* dvb = dv + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t at = (size_t)kj * step + tx + 16 * j;
      dkb[at] = dk_acc[i][j];
      dvb[at] = dv_acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Both kernels take the same arguments; Args carries them to a launch.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  const int *offsets, *blocks, *kinds;
  int B, S, H, block;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int HD>
cudaError_t launch_dq_mma(const Args& a) {
  using C = DqTiles<HD>;
  cudaError_t err = set_smem(splash_bwd_dq_mma<HD>, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / C::BQ, a.B * a.H);
  splash_bwd_dq_mma<HD><<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.di, static_cast<bf16*>(a.dq), a.offsets, a.blocks, a.kinds, a.S,
      a.H, a.block);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_mma(const Args& a) {
  using C = DkvTiles<HD>;
  cudaError_t err = set_smem(splash_bwd_dkv_mma<HD>, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / C::BK, a.B * a.H);
  splash_bwd_dkv_mma<HD><<<grid, C::THREADS, C::SMEM, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.di, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.offsets,
      a.blocks, a.kinds, a.S, a.H, a.block);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_fma(const Args& a) {
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = set_smem(splash_bwd_dq_fma<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / query_tile<HD>(), a.B * a.H);
  splash_bwd_dq_fma<HD><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dq), a.offsets, a.blocks, a.kinds,
      a.S, a.H, a.block);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_fma(const Args& a) {
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = set_smem(splash_bwd_dkv_fma<HD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.S / BK, a.B * a.H);
  splash_bwd_dkv_fma<HD><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.di, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.offsets, a.blocks, a.kinds, a.S, a.H, a.block);
  return cudaGetLastError();
}

bool bad_args(int B, int S, int H, int block) {
  return B < 1 || H < 1 || B * H > 65535 || block < BK || block % BK != 0 ||
         S < block || S % block != 0;
}

// cp.async copies 16-byte chunks: every bf16 row must start 16-byte
// aligned, as it does for a tensor from the caching allocator
bool misaligned(const Args& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.lse, a.di};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

}  // namespace

// q (pre-scaled) / k / v / dout / dq (B, S, H, hd), lse / di fp32
// (B, H, S); offsets / blocks / kinds: the forward block schedule
extern "C" int tpushare_splash_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* di,
                                      void* dq, const void* offsets,
                                      const void* blocks, const void* kinds,
                                      int B, int S, int H, int hd, int block,
                                      int is_bf16, void* stream) {
  if (bad_args(B, S, H, block)) return -1;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(di),
               dq, nullptr, nullptr,
               static_cast<const int*>(offsets),
               static_cast<const int*>(blocks), static_cast<const int*>(kinds),
               B, S, H, block, static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (misaligned(a)) return cudaErrorMisalignedAddress;
    switch (hd) {
      case 128: return launch_dq_mma<128>(a);
      case 256: return launch_dq_mma<256>(a);
    }
    return -1;
  }
  switch (hd) {
    case 128: return launch_dq_fma<128>(a);
    case 256: return launch_dq_fma<256>(a);
  }
  return -1;
}

// dk / dv (B, S, H, hd); offsets / blocks / kinds: the dK/dV schedule
extern "C" int tpushare_splash_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* di,
                                       void* dk, void* dv,
                                       const void* offsets,
                                       const void* blocks, const void* kinds,
                                       int B, int S, int H, int hd,
                                       int block, int is_bf16,
                                       void* stream) {
  if (bad_args(B, S, H, block)) return -1;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(di),
               nullptr, dk, dv,
               static_cast<const int*>(offsets),
               static_cast<const int*>(blocks), static_cast<const int*>(kinds),
               B, S, H, block, static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (misaligned(a)) return cudaErrorMisalignedAddress;
    switch (hd) {
      case 128: return launch_dkv_mma<128>(a);
      case 256: return launch_dkv_mma<256>(a);
    }
    return -1;
  }
  switch (hd) {
    case 128: return launch_dkv_fma<128>(a);
    case 256: return launch_dkv_fma<256>(a);
  }
  return -1;
}
