// Flash-attention backward for Hopper (sm_90a): the dQ and dK/dV kernels.
//
// Replaces tpushare/workloads/ops/attention.py::_dq_kernel (K2) and
// ::_dkv_kernel (K3), both reached through _flash_bwd_rows from the
// custom_vjp's backward (_flash_rows_bwd).
//
// What they compute, from the forward's residuals q (B, S, H, hd),
// k/v (B, S, Hkv, hd), the row log-sum-exp lse (B, H, S) fp32 and
// delta = rowsum(dO * O) (B, H, S) fp32 (computed outside, as the
// reference does), with scale = hd^-0.5 and the forward's mask
// (causal or full; ``window`` > 0 keeps i - window < j <= i):
//
//   P  = exp(q k^T * scale - lse)        (masked entries exactly 0)
//   dS = P o (dO v^T - delta)
//   dQ = scale * dS k                     (dq kernel, q's dtype)
//   dV = P^T dO,  dK = scale * dS^T q     (dkv kernel, k/v's dtype)
//
// dK/dV come back grouped, (B, S, Hkv, hd): the sum over the H/Hkv query
// heads that share each K/V head, as the reference returns them.
//
// Blocks run in parallel and in no order, so each sequential grid axis of
// the Pallas kernels becomes a loop inside one CTA, and no sum crosses
// CTAs: no atomics, each CTA writes its own rows once, and two launches
// on the same inputs give the same bits.
// - dq: one CTA per (64-row query tile, b*H + h), heaviest tiles first;
//   it walks the K tiles of its band, [max(q0 - window + 1, 0) / 64,
//   q_last / 64] under causal masking (every tile without), and sums
//   dS K.
// - dkv: one CTA per (64-row key tile, b*Hkv + hk), key tile 0 first;
//   it walks the group's query heads in order and, for each, the query
//   tiles that see its keys (from the diagonal to the band's end), and
//   sums P^T dO and dS^T q: the reference's group * n_q sweep, so the
//   GQA sum happens inside one CTA.
//
// Bound on this card: operations. Five S x S x hd products on the live
// pairs at the least (this two-kernel design recomputes q k^T and dO v^T
// in both, seven in all: three in dq, four in dkv) against reading each
// input once: at the training shape (S = 1024, hd 96) about 305
// operations a byte in dq and 340 in dkv, above the 295 at which the
// bf16 tensor cores, and not device memory, set the pace.
//
// bf16: tensor cores (mma_tile.cuh). Warps own 16-row strips; every
// product is mma.sync m16n8k16 over bf16 tiles in shared memory with
// fp32 accumulators, and P and dS never leave registers:
// - dq: Q and dO staged once; 64-row K/V tiles stream through a two-slot
//   cp.async ring. S = Q K^T and dP = dO V^T read K and V as the n-major
//   B operand; dS is formed in registers and is the A operand of
//   dQ += dS K, K read k-major through ldmatrix.trans.
// - dkv: K and V staged once; 32-row Q/dO tiles with their lse and delta
//   stream through a three-slot ring. S^T = K Q^T and dP^T = V dO^T;
//   P^T and dS^T formed in registers; then dV += P^T dO and dK += dS^T Q,
//   dO and Q read k-major. At hd 128 a thread holds 2 x 64 accumulator
//   registers for dK and dV and 2 x 16 for the score tiles, and ptxas
//   spills a few (44 bytes stored, 100 loaded): 16-row Q tiles, which
//   fit, ran 27% slower on an H100, so the tiles stay 32 rows.
// P and dS as two bf16 halves. The reference keeps P and dS in fp32 for
// all three gradient products, and a tensor-core product takes bf16
// operands. Rounded once, they keep 8 bits and use up to 57% of the
// backward's limit (1e-2 of each gradient's scale) on small shapes
// (tests/test_torch_bwd_split.py), more where more terms add up. So
// each is split, hi = bf16(x) and lo = bf16(x - hi) (about 16 bits), and
// both halves multiply the same B fragments: 4/3 the tensor work of a
// bf16 dS in dq and 1.5x in dkv, and no extra ldmatrix read.
// P = 2^(s c - lse log2 e), c = scale log2 e: one FFMA and the SFU's exp2
// an element. The mask's compare and select run only on the tiles that
// cross the diagonal, the window's edge or S; each warp skips the tiles
// its strip sees nothing of. Rows past S load as zeros (their P and dS
// meet a zero partner row, and are masked on the tail tile anyway) and
// are never stored, so any S works. __launch_bounds__(threads, 1) keeps
// ptxas from capping the registers (the forwards spilled under a cap).
// Head dims 16, 32, 64, 96, 128; the padded rows of mma_tile.cuh keep
// ldmatrix's eight row reads in disjoint groups of 4 banks at each.
//
// fp32: CUDA cores. On tensor cores fp32 operands run as TF32, about 13
// bits fewer than fp32, which the fp32 backward's limit (1e-4 of each
// gradient's scale) would rightly refuse. So fp32 stays on plain FMAs:
// 256 threads as a 16 x 16 grid over fp32 tiles in shared memory (row
// stride hd + 1, so column walks hit distinct banks), each thread a
// 4 x 4 block of the score tile and a 4 x (hd/16) block of each
// accumulator; the partial tile is masked and zero-filled.

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using mma::bf16;

// does query qi see key kj under the forward's mask?
__device__ __forceinline__ bool live(int qi, int kj, int S, int causal,
                                     int window) {
  return qi < S && kj < S &&
         (!causal || (kj <= qi && (window <= 0 || kj > qi - window)));
}

// the forward's mask, as the tensor-core tiles test it
struct Mask {
  int S, causal, window;
  __device__ bool operator()(int qi, int kj) const {
    return live(qi, kj, S, causal, window);
  }
};

// Both kernels of each rung take the same arguments; Args carries them to
// a launch.
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, S, H, Hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK = 64;          // key rows a dq tile / a dkv CTA

template <int HD>
struct DqTiles {
  static constexpr int BQ = 64, STAGES = 2;
  static constexpr int THREADS = 32 * (BQ / 16);
  static constexpr int LD = mma::ld<HD>();
  static constexpr int N8 = HD / 8;             // n8 tiles of dQ a warp
  static constexpr size_t Q_BYTES = mma::tile_bytes<BQ, HD>();
  static constexpr size_t KV_BYTES = mma::tile_bytes<BK, HD>();
  // Q, dO; STAGES slots of (K, V)
  static constexpr size_t SMEM = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
};

template <int HD>
struct DkvTiles {
  static constexpr int BQ = 32, STAGES = 3;
  static constexpr int THREADS = 32 * (BK / 16);
  static constexpr int LD = mma::ld<HD>();
  static constexpr int N8 = HD / 8;             // n8 tiles of dK, dV a warp
  static constexpr size_t KV_BYTES = mma::tile_bytes<BK, HD>();
  static constexpr size_t Q_BYTES = mma::tile_bytes<BQ, HD>();
  // a slot: Q, dO, then lse and delta of its BQ rows
  static constexpr size_t SLOT = 2 * Q_BYTES + 2 * sizeof(float) * BQ;
  // K, V; STAGES slots
  static constexpr size_t SMEM = 2 * KV_BYTES + STAGES * SLOT;
};

// One warp's step of dq over one BK-key tile: this warp's 16 query rows
// (strip) of Q and dO against the tile's K and V. Element x of n8 tile j
// of a score fragment is (query row + 8 (x >> 1), key key + 8 j + (x & 1));
// lse2 / dl: this lane's two rows' lse log2(e) and delta.
template <bool MASKED, int HD>
__device__ __forceinline__ void dq_tile(float (&acc)[HD / 8][4],
                                        const bf16* sq, const bf16* sdo,
                                        const bf16* sk, const bf16* sv,
                                        int strip, int row, int key, float c,
                                        const float (&lse2)[2],
                                        const float (&dl)[2],
                                        const Mask& keep) {
  constexpr int LD = mma::ld<HD>();
  // s = Q K^T, dp = dO V^T: 16 rows x BK keys
  float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t aq[4], ado[4];
    mma::load_a<LD>(aq, sq, strip * 16, kk);
    mma::load_a<LD>(ado, sdo, strip * 16, kk);
#pragma unroll
    for (int n = 0; n < BK; n += 16) {
      uint32_t bk[2][2], bv[2][2];
      mma::load_b_nk<LD>(bk, sk, n, kk);
      mma::load_b_nk<LD>(bv, sv, n, kk);
      mma::mma_16816(s[n / 8], aq, bk[0]);
      mma::mma_16816(s[n / 8 + 1], aq, bk[1]);
      mma::mma_16816(dp[n / 8], ado, bv[0]);
      mma::mma_16816(dp[n / 8 + 1], ado, bv[1]);
    }
  }

  // dS = P o (dP - delta), in place of s
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int hi = x >> 1;
      float p = mma::ex2(fmaf(s[j][x], c, -lse2[hi]));
      if (MASKED && !keep(row + 8 * hi, key + 8 * j + (x & 1))) p = 0.f;
      s[j][x] = p * (dp[j][x] - dl[hi]);
    }

  // dQ += (dS_hi + dS_lo) K: K read k-major
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t hi[4], lo[4];
    mma::acc_to_a_split(hi, lo, s[2 * j], s[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      uint32_t b[2][2];
      mma::load_b_kn<LD>(b, sk, 16 * j, n);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma::mma_16816(acc[n / 8 + e], hi, b[e]);
        mma::mma_16816(acc[n / 8 + e], lo, b[e]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(DqTiles<HD>::THREADS, 1)
    flash_bwd_dq_mma(const Args a) {
  using C = DqTiles<HD>;
  constexpr int LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + C::BQ * LD;
  bf16* ring = sdo + C::BQ * LD;   // STAGES slots of (K, V)

  const int S = a.S, causal = a.causal, window = a.window;
  const int strip = threadIdx.x >> 5;
  const int g = mma::frag_row(), fc = mma::frag_col();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;   // heaviest first
  const int r0 = q0 + strip * 16;               // the strip's first row
  const int r_last = r0 + 15;                   // and its last
  const int row = blockIdx.y;                   // b * H + h
  const int b = row / a.H;
  const int h = row - b * a.H;
  const int hk = h / (a.H / a.Hkv);
  const size_t q_step = (size_t)a.H * HD;       // between positions
  const size_t kv_step = (size_t)a.Hkv * HD;
  const size_t q_off = (size_t)b * S * q_step + (size_t)h * HD;
  const size_t kv_off = (size_t)b * S * kv_step + (size_t)hk * HD;
  const bf16* k = static_cast<const bf16*>(a.k) + kv_off;
  const bf16* v = static_cast<const bf16*>(a.v) + kv_off;
  const float scale = a.scale;
  const Mask keep{S, causal, window};

  // this lane's rows r0 + g and r0 + g + 8: lse log2(e) and delta (0
  // past S, where nothing is stored)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    lse2[i] = r < S ? a.lse[(size_t)row * S + r] * mma::LOG2E : 0.f;
    dl[i] = r < S ? a.delta[(size_t)row * S + r] : 0.f;
  }

  auto slot_k = [&](int i) { return ring + (i % C::STAGES) * 2 * BK * LD; };
  auto fill = [&](int i, int t) {
    bf16* sk = slot_k(i);
    const size_t at = (size_t)t * BK * kv_step;
    mma::load_tile_rows<BK, HD, C::THREADS>(sk, k + at, kv_step, S - t * BK);
    mma::load_tile_rows<BK, HD, C::THREADS>(sk + BK * LD, v + at, kv_step,
                                            S - t * BK);
  };

  const int q_last = min(q0 + C::BQ, S) - 1;
  const int t_first =
      causal && window > 0 ? max(q0 - window + 1, 0) / BK : 0;
  const int t_end = causal ? q_last / BK + 1 : (S + BK - 1) / BK;

  // Q and dO join the first tile's commit group
  const size_t at = q_off + (size_t)q0 * q_step;
  mma::load_tile_rows<C::BQ, HD, C::THREADS>(
      sq, static_cast<const bf16*>(a.q) + at, q_step, S - q0);
  mma::load_tile_rows<C::BQ, HD, C::THREADS>(
      sdo, static_cast<const bf16*>(a.dout) + at, q_step, S - q0);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (t_first + s < t_end) fill(s, t_first + s);
    mma::commit();
  }

  float acc[C::N8][4];
#pragma unroll
  for (int j = 0; j < C::N8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const float c = scale * mma::LOG2E;

  for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
    mma::ring_wait<C::STAGES>();
    if (t + C::STAGES - 1 < t_end) fill(i + C::STAGES - 1, t + C::STAGES - 1);
    mma::commit();
    const bf16* sk = slot_k(i);
    const int k0 = t * BK;
    // tiles this strip sees nothing of: rows all past S, keys all past
    // its diagonal or all before its window
    if (r0 >= S || (causal && (k0 > r_last ||
                               (window > 0 && k0 + BK - 1 <= r0 - window))))
      continue;
    const bool masked = k0 + BK > S || r_last >= S ||
                        (causal && (k0 + BK - 1 > r0 ||
                                    (window > 0 && k0 <= r_last - window)));
    if (masked)
      dq_tile<true, HD>(acc, sq, sdo, sk, sk + BK * LD, strip, r0 + g,
                        k0 + fc, c, lse2, dl, keep);
    else
      dq_tile<false, HD>(acc, sq, sdo, sk, sk + BK * LD, strip, r0 + g,
                         k0 + fc, c, lse2, dl, keep);
  }

#pragma unroll
  for (int j = 0; j < C::N8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[j][x] *= scale;
  mma::store_acc<C::N8>(static_cast<bf16*>(a.dq) + q_off + (size_t)r0 * q_step,
                        q_step, acc, S - r0);
}

// One warp's step of dkv over one BQ-query tile: this warp's 16 key rows
// (strip) of K and V against the tile's Q, dO, lse and delta (slse, sdl).
// Element x of n8 tile j of a score fragment is (key key + 8 (x >> 1),
// query query + 8 j + (x & 1)), query = the tile's first row + 2t.
template <bool MASKED, int HD>
__device__ __forceinline__ void dkv_tile(float (&dk)[HD / 8][4],
                                         float (&dv)[HD / 8][4],
                                         const bf16* sk, const bf16* sv,
                                         const bf16* sq, const bf16* sdo,
                                         const float* slse, const float* sdl,
                                         int strip, int key, int query,
                                         int fc, float c, const Mask& keep) {
  constexpr int LD = mma::ld<HD>();
  constexpr int BQ = DkvTiles<HD>::BQ;
  // s^T = K Q^T, dp^T = V dO^T: 16 key rows x BQ queries
  float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) s[j][x] = dp[j][x] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t ak[4], av[4];
    mma::load_a<LD>(ak, sk, strip * 16, kk);
    mma::load_a<LD>(av, sv, strip * 16, kk);
#pragma unroll
    for (int n = 0; n < BQ; n += 16) {
      uint32_t bq[2][2], bdo[2][2];
      mma::load_b_nk<LD>(bq, sq, n, kk);
      mma::load_b_nk<LD>(bdo, sdo, n, kk);
      mma::mma_16816(s[n / 8], ak, bq[0]);
      mma::mma_16816(s[n / 8 + 1], ak, bq[1]);
      mma::mma_16816(dp[n / 8], av, bdo[0]);
      mma::mma_16816(dp[n / 8 + 1], av, bdo[1]);
    }
  }

  // P^T in place of s, dS^T in place of dp
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int ql = 8 * j + fc;
    const float lse2[2] = {slse[ql] * mma::LOG2E, slse[ql + 1] * mma::LOG2E};
    const float dl[2] = {sdl[ql], sdl[ql + 1]};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int col = x & 1;
      float p = mma::ex2(fmaf(s[j][x], c, -lse2[col]));
      if (MASKED && !keep(query + 8 * j + col, key + 8 * (x >> 1))) p = 0.f;
      s[j][x] = p;
      dp[j][x] = p * (dp[j][x] - dl[col]);
    }
  }

  // dV += (P_hi + P_lo)^T dO, then dK += (dS_hi + dS_lo)^T Q, dO and Q
  // read k-major: one split A operand live at a time
#pragma unroll
  for (int j = 0; j < BQ / 16; ++j) {
    uint32_t hi[4], lo[4];
    mma::acc_to_a_split(hi, lo, s[2 * j], s[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      uint32_t b[2][2];
      mma::load_b_kn<LD>(b, sdo, 16 * j, n);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma::mma_16816(dv[n / 8 + e], hi, b[e]);
        mma::mma_16816(dv[n / 8 + e], lo, b[e]);
      }
    }
    mma::acc_to_a_split(hi, lo, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
    for (int n = 0; n < HD; n += 16) {
      uint32_t b[2][2];
      mma::load_b_kn<LD>(b, sq, 16 * j, n);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma::mma_16816(dk[n / 8 + e], hi, b[e]);
        mma::mma_16816(dk[n / 8 + e], lo, b[e]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(DkvTiles<HD>::THREADS, 1)
    flash_bwd_dkv_mma(const Args a) {
  using C = DkvTiles<HD>;
  constexpr int LD = C::LD;
  constexpr int BQ = C::BQ;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + C::KV_BYTES);
  unsigned char* ring = smem + 2 * C::KV_BYTES;

  const int S = a.S, H = a.H, causal = a.causal, window = a.window;
  const int strip = threadIdx.x >> 5;
  const int g = mma::frag_row(), fc = mma::frag_col();
  // key tile 0 first: under causal masking it sees the most query tiles
  const int k0 = blockIdx.x * BK;
  const int kr0 = k0 + strip * 16;              // the strip's first key
  const int row = blockIdx.y;                   // b * Hkv + hk
  const int b = row / a.Hkv;
  const int hk = row - b * a.Hkv;
  const int group = H / a.Hkv;
  const size_t q_step = (size_t)H * HD;
  const size_t kv_step = (size_t)a.Hkv * HD;
  const size_t kv_off = (size_t)b * S * kv_step + (size_t)hk * HD;
  const bf16* q = static_cast<const bf16*>(a.q) + (size_t)b * S * q_step;
  const bf16* dout = static_cast<const bf16*>(a.dout) + (size_t)b * S * q_step;
  const float* lse = a.lse + (size_t)b * H * S;
  const float* delta = a.delta + (size_t)b * H * S;
  const float scale = a.scale;
  const Mask keep{S, causal, window};

  // the query tiles that see this key tile: from the diagonal on under
  // causal masking, to the band's end with a window; the walk is
  // group x that many tiles, head by head
  const int n_q = (S + BQ - 1) / BQ;
  const int k_last = min(k0 + BK, S) - 1;
  const int t_first = causal ? k0 / BQ : 0;
  const int t_end = causal && window > 0
                        ? min((k_last + window - 1) / BQ + 1, n_q)
                        : n_q;
  const int n_t = t_end - t_first;
  const int n_tiles = group * n_t;

  auto slot = [&](int i) { return ring + (i % C::STAGES) * C::SLOT; };
  auto fill = [&](int i) {
    unsigned char* p = slot(i);
    const int h = hk * group + i / n_t;
    const int q0 = (t_first + i % n_t) * BQ;
    const size_t at = (size_t)q0 * q_step + (size_t)h * HD;
    mma::load_tile_rows<BQ, HD, C::THREADS>(reinterpret_cast<bf16*>(p),
                                            q + at, q_step, S - q0);
    mma::load_tile_rows<BQ, HD, C::THREADS>(
        reinterpret_cast<bf16*>(p + C::Q_BYTES), dout + at, q_step, S - q0);
    float* stats = reinterpret_cast<float*>(p + 2 * C::Q_BYTES);
    const size_t srow = (size_t)h * S + q0;
    mma::load_f32_rows<BQ, C::THREADS>(stats, lse + srow, S - q0);
    mma::load_f32_rows<BQ, C::THREADS>(stats + BQ, delta + srow, S - q0);
  };

  // K and V join the first tile's commit group
  const bf16* kb = static_cast<const bf16*>(a.k) + kv_off;
  const bf16* vb = static_cast<const bf16*>(a.v) + kv_off;
  mma::load_tile_rows<BK, HD, C::THREADS>(sk, kb + (size_t)k0 * kv_step,
                                          kv_step, S - k0);
  mma::load_tile_rows<BK, HD, C::THREADS>(sv, vb + (size_t)k0 * kv_step,
                                          kv_step, S - k0);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_tiles) fill(s);
    mma::commit();
  }

  float dk_acc[C::N8][4], dv_acc[C::N8][4];
#pragma unroll
  for (int j = 0; j < C::N8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[j][x] = dv_acc[j][x] = 0.f;
  const float c = scale * mma::LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    mma::ring_wait<C::STAGES>();
    if (i + C::STAGES - 1 < n_tiles) fill(i + C::STAGES - 1);
    mma::commit();
    const unsigned char* p = slot(i);
    const bf16* sq = reinterpret_cast<const bf16*>(p);
    const bf16* sdo = reinterpret_cast<const bf16*>(p + C::Q_BYTES);
    const float* slse = reinterpret_cast<const float*>(p + 2 * C::Q_BYTES);
    const int q0 = (t_first + i % n_t) * BQ;
    // tiles this strip sees nothing of: keys all past S, queries all
    // before its first key or all past its last key's band
    if (kr0 >= S || (causal && (q0 + BQ - 1 < kr0 ||
                                (window > 0 && q0 - (kr0 + 15) >= window))))
      continue;
    const bool masked =
        q0 + BQ > S || kr0 + 16 > S ||
        (causal && (kr0 + 15 > q0 ||
                    (window > 0 && q0 + BQ - 1 - kr0 >= window)));
    if (masked)
      dkv_tile<true, HD>(dk_acc, dv_acc, sk, sv, sq, sdo, slse, slse + BQ,
                         strip, kr0 + g, q0 + fc, fc, c, keep);
    else
      dkv_tile<false, HD>(dk_acc, dv_acc, sk, sv, sq, sdo, slse, slse + BQ,
                          strip, kr0 + g, q0 + fc, fc, c, keep);
  }

#pragma unroll
  for (int j = 0; j < C::N8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) dk_acc[j][x] *= scale;
  const size_t at = kv_off + (size_t)kr0 * kv_step;
  mma::store_acc<C::N8>(static_cast<bf16*>(a.dk) + at, kv_step, dk_acc,
                        S - kr0);
  mma::store_acc<C::N8>(static_cast<bf16*>(a.dv) + at, kv_step, dv_acc,
                        S - kr0);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int BM = 64;          // query rows per tile
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16

// Stage 64 sequence rows of one head of a (B, S, heads, HD) tensor,
// starting at position r0, into shared memory with row stride HD + 1;
// rows past S are zero.
template <int HD>
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      size_t step, int r0, int S) {
  for (int i = threadIdx.x; i < 64 * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int s = r0 + r;
    dst[r * (HD + 1) + d] = s < S ? src[(size_t)s * step + d] : 0.f;
  }
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V at HD + 1 floats a row; the dS tile at BN + 1
  return sizeof(float) *
         (size_t)(2 * BM * (HD + 1) + 2 * BN * (HD + 1) + BM * (BN + 1));
}

template <int HD>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO at HD + 1 floats a row; P^T and dS^T at BM + 1; lse and
  // delta of the query tile
  return sizeof(float) * (size_t)(2 * BN * (HD + 1) + 2 * BM * (HD + 1) +
                                  2 * BN * (BM + 1) + 2 * BM);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_fma(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int S, int H, int Hkv, int causal, int window,
                     float scale) {
  constexpr int LD = HD + 1;
  constexpr int PS = BN + 1;
  constexpr int DJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float fsmem[];
  float* sq = fsmem;             // BM x LD
  float* sdo = sq + BM * LD;     // BM x LD
  float* sk = sdo + BM * LD;     // BN x LD
  float* sv = sk + BN * LD;      // BN x LD
  float* sds = sv + BN * LD;     // BM x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // heaviest first
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int hk = h / (H / Hkv);

  const size_t q_step = (size_t)H * HD;
  const size_t kv_step = (size_t)Hkv * HD;
  const size_t q_off = (size_t)b * S * q_step + (size_t)h * HD;
  const size_t kv_off = (size_t)b * S * kv_step + (size_t)hk * HD;

  stage<HD>(sq, q + q_off, q_step, q0, S);
  stage<HD>(sdo, dout + q_off, q_step, q0, S);
  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    lse_r[i] = qi < S ? lse[(size_t)row * S + qi] : 0.f;
    delta_r[i] = qi < S ? delta[(size_t)row * S + qi] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BM, S) - 1;
  const int t_first =
      causal && window > 0 ? max(q0 - window + 1, 0) / BN : 0;
  const int t_end = causal ? q_last / BN + 1 : (S + BN - 1) / BN;
  for (int t = t_first; t < t_end; ++t) {
    const int k0 = t * BN;
    __syncthreads();   // the previous tile's readers are done
    stage<HD>(sk, k + kv_off, kv_step, k0, S);
    stage<HD>(sv, v + kv_off, kv_step, k0, S);
    __syncthreads();

    // s = q k^T and dp = dO v^T: rows ty*4 + i, keys tx + 16*j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sq[(ty * 4 + i) * LD + d];
        dov[i] = sdo[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sk[(tx + 16 * j) * LD + d];
        vv[j] = sv[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // dS = P o (dP - delta), into shared memory for the dS K product
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const float p = live(qi, kj, S, causal, window)
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.f;
        sds[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    // acc += dS k: rows ty*4 + i, head-dim columns tx + 16*j
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sds[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = sk[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

  float* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqb[(size_t)qi * q_step + tx + 16 * j] = acc[i][j] * scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_fma(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int S,
                      int H, int Hkv, int causal, int window, float scale) {
  constexpr int LD = HD + 1;
  constexpr int PS = BM + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float fsmem[];
  float* sk = fsmem;             // BN x LD
  float* sv = sk + BN * LD;      // BN x LD
  float* sq = sv + BN * LD;      // BM x LD
  float* sdo = sq + BM * LD;     // BM x LD
  float* sp = sdo + BM * LD;     // BN x PS: P^T
  float* sds = sp + BN * PS;     // BN x PS: dS^T
  float* slse = sds + BN * PS;   // BM
  float* sdelta = slse + BM;     // BM

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // key tile 0 first: under causal masking it sees the most query tiles
  const int k0 = blockIdx.x * BN;
  const int row = blockIdx.y;                          // b * Hkv + hk
  const int b = row / Hkv;
  const int hk = row - b * Hkv;
  const int group = H / Hkv;

  const size_t q_step = (size_t)H * HD;
  const size_t kv_step = (size_t)Hkv * HD;
  const size_t kv_off = (size_t)b * S * kv_step + (size_t)hk * HD;

  stage<HD>(sk, k + kv_off, kv_step, k0, S);
  stage<HD>(sv, v + kv_off, kv_step, k0, S);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // the query tiles that see this key tile: from the diagonal on under
  // causal masking, to the band's end with a window
  const int n_q = (S + BM - 1) / BM;
  const int k_last = min(k0 + BN, S) - 1;
  const int t_first = causal ? k0 / BM : 0;
  const int t_end = causal && window > 0
                        ? min((k_last + window - 1) / BM + 1, n_q)
                        : n_q;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const size_t q_off = (size_t)b * S * q_step + (size_t)h * HD;
    const float* lrow = lse + ((size_t)b * H + h) * S;
    const float* drow = delta + ((size_t)b * H + h) * S;
    for (int t = t_first; t < t_end; ++t) {
      const int q0 = t * BM;
      __syncthreads();   // the previous tile's readers are done
      stage<HD>(sq, q + q_off, q_step, q0, S);
      stage<HD>(sdo, dout + q_off, q_step, q0, S);
      for (int i = tid; i < BM; i += THREADS) {
        const int qi = q0 + i;
        slse[i] = qi < S ? lrow[qi] : 0.f;
        sdelta[i] = qi < S ? drow[qi] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T: key rows ty*4 + i, queries
      // tx + 16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = sk[(ty * 4 + i) * LD + d];
          vv[i] = sv[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = sq[(tx + 16 * j) * LD + d];
          dov[j] = sdo[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kj = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j;
          const float p = live(q0 + ql, kj, S, causal, window)
                              ? expf(s[i][j] * scale - slse[ql])
                              : 0.f;
          sp[(ty * 4 + i) * PS + ql] = p;
          sds[(ty * 4 + i) * PS + ql] = p * (dp[i][j] - sdelta[ql]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T q: key rows ty*4 + i, head-dim columns
      // tx + 16*j
#pragma unroll 4
      for (int c = 0; c < BM; ++c) {
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

  float* dkb = dk + kv_off;
  float* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t at = (size_t)kj * kv_step + tx + 16 * j;
        dkb[at] = dk_acc[i][j] * scale;
        dvb[at] = dv_acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct DqMma {
  template <int HD> static cudaError_t run(const Args& a) {
    using C = DqTiles<HD>;
    cudaError_t err = set_smem(flash_bwd_dq_mma<HD>, C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.B * a.H);
    flash_bwd_dq_mma<HD><<<grid, C::THREADS, C::SMEM, a.stream>>>(a);
    return cudaGetLastError();
  }
};

struct DkvMma {
  template <int HD> static cudaError_t run(const Args& a) {
    using C = DkvTiles<HD>;
    cudaError_t err = set_smem(flash_bwd_dkv_mma<HD>, C::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BK - 1) / BK, a.B * a.Hkv);
    flash_bwd_dkv_mma<HD><<<grid, C::THREADS, C::SMEM, a.stream>>>(a);
    return cudaGetLastError();
  }
};

struct DqFma {
  template <int HD> static cudaError_t run(const Args& a) {
    const size_t smem = dq_smem_bytes<HD>();
    cudaError_t err = set_smem(flash_bwd_dq_fma<HD>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BM - 1) / BM, a.B * a.H);
    flash_bwd_dq_fma<HD><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dq), a.S, a.H, a.Hkv, a.causal,
        a.window, a.scale);
    return cudaGetLastError();
  }
};

struct DkvFma {
  template <int HD> static cudaError_t run(const Args& a) {
    const size_t smem = dkv_smem_bytes<HD>();
    cudaError_t err = set_smem(flash_bwd_dkv_fma<HD>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BN - 1) / BN, a.B * a.Hkv);
    flash_bwd_dkv_fma<HD><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
        a.S, a.H, a.Hkv, a.causal, a.window, a.scale);
    return cudaGetLastError();
  }
};

// the launch of kernel family F at head dim hd
template <class F>
int by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 16: return F::template run<16>(a);
    case 32: return F::template run<32>(a);
    case 64: return F::template run<64>(a);
    case 96: return F::template run<96>(a);
    case 128: return F::template run<128>(a);
  }
  return -1;
}

bool bad_args(int B, int S, int H, int Hkv, int causal, int window) {
  return B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535 ||
         window < 0 || (window > 0 && !causal);
}

// cp.async copies 16-byte chunks of the bf16 tensors (every row starts
// 16-byte aligned when the tensor does: hd % 8 == 0) and 4-byte values of
// lse and delta; the gradients are stored a column pair at a time
bool misaligned(const Args& a) {
  const void* ptrs[] = {a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return reinterpret_cast<uintptr_t>(a.lse) % 4 ||
         reinterpret_cast<uintptr_t>(a.delta) % 4;
}

}  // namespace

// q/dout/dq (B, S, H, hd), k/v (B, S, Hkv, hd), lse/delta fp32 (B, H, S);
// window: 0 = none (causal only)
extern "C" int tpushare_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int B, int S, int H, int Hkv,
                                     int hd, int causal, int window,
                                     int is_bf16, float scale,
                                     void* stream) {
  if (bad_args(B, S, H, Hkv, causal, window)) return -1;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               dq, nullptr, nullptr, B, S, H, Hkv, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (misaligned(a)) return cudaErrorMisalignedAddress;
    return by_head_dim<DqMma>(hd, a);
  }
  return by_head_dim<DqFma>(hd, a);
}

// dk/dv (B, S, Hkv, hd): the per-group sums
extern "C" int tpushare_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int B, int S,
                                      int H, int Hkv, int hd, int causal,
                                      int window, int is_bf16, float scale,
                                      void* stream) {
  if (bad_args(B, S, H, Hkv, causal, window) || B * Hkv > 65535) return -1;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               nullptr, dk, dv, B, S, H, Hkv, causal, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) {
    if (misaligned(a)) return cudaErrorMisalignedAddress;
    return by_head_dim<DkvMma>(hd, a);
  }
  return by_head_dim<DkvFma>(hd, a);
}
