// Flash-attention forward for Hopper (sm_90a).
//
// Replaces tpushare/workloads/ops/attention.py::_fwd_kernel (reached
// through _flash_fwd_rows and the public flash_attention), with its
// optional LSE output and its sliding-window band.
//
// What it computes, per query head row (b, h) of q (B, S, H, hd) against
// k/v (B, S, Hkv, hd): softmax(q k^T * hd^-0.5 masked) v, causal or
// full, with the masked scores set to the finite -1e30 as the reference
// does, the running max / sum / accumulator in fp32, and the output in
// q's dtype. When ``lse`` is not null it also writes each row's
// log-sum-exp m + log(l) as fp32 into a (B, H, S) array: the residual
// the backward kernels (flash_bwd.cu) recompute probabilities from.
// ``window`` > 0 (causal only) keeps key j for query i when
// i - window < j <= i: the K loop then runs over the band's tiles only,
// [max(q0 - window + 1, 0) / BN, q_last / BN], which is what the
// reference's compact banded grid computes.
// GQA is native: head h reads K/V head h / (H / Hkv), nothing repeated.
// The tensors stay in the model's (B, S, heads, hd) layout; the kernel
// computes its own offsets, so the wrapper makes no transposed copies.
//
// Bound on this card: at the forward's shapes (S <= 2048, hd 96 / 128)
// the causal FLOPs over bf16 tensor-core peak exceed the bytes over HBM
// bandwidth, so the kernel is compute-bound in principle; at short S
// (the forward's S = 128) the bytes bound it.
//
// bf16: tensor cores, through attn_fwd_tile.cuh (the tile body K6-fwd's
// bf16 rung shares). One CTA per (64-row query tile, b*H + h), 4 warps
// with a 16-row strip each and its Q fragments in registers; 64-key K/V
// tiles stream through a two-slot cp.async ring over the band's tiles.
// Rows past S load as zeros and are never stored, keys past S are
// masked, so any S works. Each warp skips the tiles its strip cannot see
// (past its diagonal, before its window, or all of it past S) and masks
// only those that cross the diagonal, the window's edge or S. The
// scores are products of bf16 values, exact in fp32, so the softmax
// scale is folded into the exp2 (the reference scales q in fp32 first:
// equal up to rounding). P stays in registers, split into two bf16
// halves for P V (see the tile header). Head dims 16, 32, 64, 96 and
// 128; the padded rows of mma_tile.cuh (24, 40, 72, 104, 136 elements)
// put ldmatrix's eight row reads in disjoint groups of 4 banks at each.
//
// fp32: CUDA cores (TF32 would fail the fp32 check). 256 threads as a
// 16 x 16 grid; the Q tile and each 64-row K/V tile staged in shared
// memory as fp32, each thread owning a 4 x 4 block of the score tile and
// a 4 x (hd/16) block of the accumulator, rows reduced across the 16
// threads that share them with warp shuffles. The K/V loop stops at the
// causal diagonal (block-level skip, as the reference's _block_live)
// and, with a window, starts at the band's first tile; a partial last
// tile is masked.
//
// Both launch query tiles heaviest first.
//
// The cached chunk (tpushare_flash_fwd_chunk, bf16 only) replaces no TPU
// kernel: the reference attends a multi-token chunk against its KV cache
// with fp32 einsums over every cache row (decode.make_cached_attn_core),
// which the port keeps on the CPU. On the card a chunk of Q queries at
// absolute positions pos .. pos + Q - 1 runs K1's bf16 rung with a query
// offset: key j is kept for query i exactly when j <= pos + i, the K/V
// tiles come straight from one layer's view of the cache (its own row
// and batch strides, only the first pos + Q rows read), tiles wholly
// above the offset diagonal are skipped, and there is no fp32 copy of
// K or V, no score tensor and no mask tensor. Bound as K1: at a prefill
// chunk (Q 256-2048) the causal FLOPs over the tensor-core peak exceed
// the bytes over HBM bandwidth.

#include "attn_fwd_tile.cuh"
#include "common.cuh"

namespace {

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr float MASKED = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K padded to HD+1 floats a row (column walks hit distinct
  // banks), V unpadded, the probability tile padded to BN+1
  return sizeof(float) *
         (size_t)(BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * (BN + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int Hkv,
                     int causal, int window, float scale) {
  constexpr int QS = HD + 1;
  constexpr int PS = BN + 1;
  constexpr int DJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // BM x QS
  float* sk = sq + BM * QS;      // BN x QS
  float* sv = sk + BN * QS;      // BN x HD
  float* sp = sv + BN * HD;      // BM x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // heaviest first
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int hk = h / (H / Hkv);

  const size_t q_step = (size_t)H * HD;     // between sequence positions
  const size_t kv_step = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * q_step + (size_t)h * HD;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)hk * HD;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)hk * HD;
  T* ob = o + (size_t)b * S * q_step + (size_t)h * HD;

  for (int i = tid; i < BM * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int qi = q0 + r;
    sq[r * QS + d] = qi < S ? to_f32(qb[(size_t)qi * q_step + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
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
    for (int i = tid; i < BN * HD; i += THREADS) {
      const int r = i / HD, d = i - (i / HD) * HD;
      const int kj = k0 + r;
      const bool ok = kj < S;
      sk[r * QS + d] = ok ? to_f32(kb[(size_t)kj * kv_step + d]) : 0.f;
      sv[r * HD + d] = ok ? to_f32(vb[(size_t)kj * kv_step + d]) : 0.f;
    }
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sq[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax; a row's 64 scores live in the 16
    // threads of one half-warp, reduced with xor shuffles over tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool keep = kj < S && (!causal || (kj <= qi &&
                                   (window <= 0 || kj > qi - window)));
        s[i][j] = keep ? s[i][j] * scale : MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sp[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V: rows ty*4 + i, head-dim columns tx + 16*j
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sv[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        ob[(size_t)qi * q_step + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
      if (lse != nullptr && tx == 0)
        lse[(size_t)row * S + qi] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using mma::bf16;

// Where a forward's rows lie: Sq query rows at absolute positions pos ..
// pos + Sq - 1 against the first Skv key rows (K1: pos 0, Sq = Skv = S;
// a cached chunk: Skv = pos + Sq), and the element strides between batch
// rows of q / o, between batch rows of k / v, and between k / v
// positions (a cache layer's view keeps its own).
struct Rows {
  int Sq, Skv, pos;
  size_t q_batch, kv_batch, kv_row;
};

// which (query, key) scores live: keys before Skv, and with ``causal`` at
// or before the query's absolute position and, with a window, inside its
// band; q is the query's row, its position pos + q
struct Keep {
  int Skv, pos, window;
  bool causal;
  __device__ bool operator()(int q, int k) const {
    const int p = q + pos;
    return k < Skv && (!causal || (k <= p && (window <= 0 || k > p - window)));
  }
};

// One CTA's forward over its 64 query rows: the body of K1's bf16 rung
// and of the cached chunk's kernel, which differ only in their Rows.
template <int HD>
__device__ __forceinline__ void fwd_mma_rows(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    const Rows& R, int H, int Hkv, int causal, int window, float scale) {
  using C = fwd::Tiles<HD>;
  static_assert(C::WC == 1, "one warp holds a strip's O up to hd 128");
  constexpr int LD = C::LD;
  constexpr int BN = fwd::BN;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sq = C::q_tile(mma_smem);
  bf16* ring = C::ring(mma_smem);   // STAGES slots of (K, V)

  const int wr = threadIdx.x >> 5;              // row strip
  const int g = mma::frag_row(), fc = mma::frag_col();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BM;   // heaviest first
  const int r0 = q0 + wr * 16;                  // the strip's first row
  const int r_last = r0 + 15;                   // and its last
  const int p0 = R.pos + r0, p_last = R.pos + r_last;    // their positions
  const int row = blockIdx.y;                   // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const int hk = h / (H / Hkv);

  const size_t q_step = (size_t)H * HD;         // between positions
  const size_t q_off = (size_t)b * R.q_batch + (size_t)h * HD;
  const size_t kv_off = (size_t)b * R.kv_batch + (size_t)hk * HD;

  auto slot_k = [&](int i) { return ring + (i % C::STAGES) * 2 * BN * LD; };
  auto fill = [&](int i, int t) {
    bf16* sk = slot_k(i);
    const size_t at = kv_off + (size_t)t * BN * R.kv_row;
    mma::load_tile_rows<BN, HD, C::THREADS>(sk, k + at, R.kv_row,
                                            R.Skv - t * BN);
    mma::load_tile_rows<BN, HD, C::THREADS>(sk + BN * LD, v + at, R.kv_row,
                                            R.Skv - t * BN);
  };

  const int q_last = min(q0 + C::BM, R.Sq) - 1;
  const int t_first =
      causal && window > 0 ? max(R.pos + q0 - window + 1, 0) / BN : 0;
  const int t_end =
      causal ? (R.pos + q_last) / BN + 1 : (R.Skv + BN - 1) / BN;

  // Q is its own commit group, ahead of the ring's
  mma::load_tile_rows<C::BM, HD, C::THREADS>(sq, q + q_off + q0 * q_step,
                                             q_step, R.Sq - q0);
  mma::commit();
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (t_first + s < t_end) fill(s, t_first + s);
    mma::commit();
  }
  mma::wait_newest<C::STAGES - 1>();
  __syncthreads();
  const fwd::QFrags<HD, C::Q_IN_REGISTERS> qf(sq, wr * 16);
  fwd::Strip<C::N8> st(MASKED);
  const Keep keep{R.Skv, R.pos, window, causal != 0};
  const float c = fwd::LOG2E * scale;

  for (int t = t_first, i = 0; t < t_end; ++t, ++i) {
    mma::ring_wait<C::STAGES>();
    if (t + C::STAGES - 1 < t_end) fill(i + C::STAGES - 1, t + C::STAGES - 1);
    mma::commit();
    const bf16* sk = slot_k(i);
    const int k0 = t * BN;
    // tiles this strip sees nothing of: rows all past Sq, keys all past
    // its diagonal or all before its window
    if (r0 >= R.Sq || (causal && (k0 > p_last ||
                                  (window > 0 && k0 + BN - 1 <= p0 - window))))
      continue;
    const bool masked = k0 + BN > R.Skv ||
                        (causal && (k0 + BN - 1 > p0 ||
                                    (window > 0 && k0 <= p_last - window)));
    if (masked)
      fwd::tile<true, HD>(st, qf, sk, sk + BN * LD, 0, c, r0 + g, k0 + fc,
                          keep);
    else
      fwd::tile<false, HD>(st, qf, sk, sk + BN * LD, 0, c, r0 + g, k0 + fc,
                           keep);
  }

  st.finish();
  mma::store_acc<C::N8>(o + q_off + (size_t)r0 * q_step, q_step, st.o,
                        R.Sq - r0);
  if (lse != nullptr && fc == 0) {
    if (r0 + g < R.Sq)
      lse[(size_t)row * R.Sq + r0 + g] = st.m[0] * scale + logf(st.l[0]);
    if (r0 + g + 8 < R.Sq)
      lse[(size_t)row * R.Sq + r0 + g + 8] = st.m[1] * scale + logf(st.l[1]);
  }
}

// K1's bf16 rung: q, k, v of S rows each, contiguous
template <int HD>
__global__ void __launch_bounds__(fwd::Tiles<HD>::THREADS, 1)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int S, int H, int Hkv, int causal,
                  int window, float scale) {
  const Rows R{S, S, 0, (size_t)S * H * HD, (size_t)S * Hkv * HD,
               (size_t)Hkv * HD};
  fwd_mma_rows<HD>(q, k, v, o, lse, R, H, Hkv, causal, window, scale);
}

// A cached chunk: Q queries at positions pos .. pos + Q - 1, causal over
// the cache's first pos + Q rows, read in place
template <int HD>
__global__ void __launch_bounds__(fwd::Tiles<HD>::THREADS, 1)
    flash_fwd_chunk_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        Rows R, int H, int Hkv, float scale) {
  fwd_mma_rows<HD>(q, k, v, o, nullptr, R, H, Hkv, 1, 0, scale);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int S, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int H, int Hkv, int hd, int causal,
             int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                  window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                  window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                  window, scale, st);
    case 96: return launch<T, 96>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                  window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, Hkv, causal,
                                    window, scale, st);
  }
  return -1;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int S, int H, int Hkv, int causal,
               int window, float scale, cudaStream_t stream) {
  using C = fwd::Tiles<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + C::BM - 1) / C::BM, B * H);
  flash_fwd_mma<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, H, Hkv,
      causal, window, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_chunk(const void* q, const void* k, const void* v, void* o,
                 const Rows& R, int B, int H, int Hkv, float scale,
                 cudaStream_t stream) {
  using C = fwd::Tiles<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_chunk_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((R.Sq + C::BM - 1) / C::BM, B * H);
  flash_fwd_chunk_mma<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), R, H, Hkv, scale);
  return cudaGetLastError();
}

// cp.async copies 16-byte chunks: every bf16 tensor and row must start
// 16-byte aligned, as a tensor from the caching allocator does
bool misaligned(const void* q, const void* k, const void* v, const void* o,
                int H, int Hkv, int hd) {
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return (size_t)H * hd * sizeof(bf16) % 16 != 0 ||
         (size_t)Hkv * hd * sizeof(bf16) % 16 != 0;
}

}  // namespace

// lse: null, or fp32 (B, H, S); window: 0 = none (causal only)
extern "C" int tpushare_flash_fwd(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int B,
                                  int S, int H, int Hkv, int hd, int causal,
                                  int window, int is_bf16, float scale,
                                  void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535 ||
      window < 0 || (window > 0 && !causal))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    if (misaligned(q, k, v, o, H, Hkv, hd)) return cudaErrorMisalignedAddress;
    switch (hd) {
      case 16: return launch_mma<16>(q, k, v, o, l, B, S, H, Hkv, causal,
                                     window, scale, st);
      case 32: return launch_mma<32>(q, k, v, o, l, B, S, H, Hkv, causal,
                                     window, scale, st);
      case 64: return launch_mma<64>(q, k, v, o, l, B, S, H, Hkv, causal,
                                     window, scale, st);
      case 96: return launch_mma<96>(q, k, v, o, l, B, S, H, Hkv, causal,
                                     window, scale, st);
      case 128: return launch_mma<128>(q, k, v, o, l, B, S, H, Hkv, causal,
                                       window, scale, st);
    }
    return -1;
  }
  return dispatch<float>(q, k, v, o, l, B, S, H, Hkv, hd, causal, window,
                         scale, st);
}

// A cached chunk's attention (bf16): q, o (B, Q, H, hd) contiguous, the
// queries at absolute positions pos .. pos + Q - 1; k, v one layer's
// cache view (B, rows, Hkv, hd) with rows >= pos + Q, positions kv_row
// elements apart and batch rows kv_batch apart, of which the first
// pos + Q rows are read; causal by absolute position
extern "C" int tpushare_flash_fwd_chunk(const void* q, const void* k,
                                        const void* v, void* o, int B, int Q,
                                        int pos, int H, int Hkv, int hd,
                                        long long kv_batch, long long kv_row,
                                        float scale, void* stream) {
  if (B < 1 || Q < 1 || pos < 0 || Hkv < 1 || H % Hkv != 0 ||
      B * H > 65535 || kv_row < (long long)Hkv * hd || kv_batch < 0)
    return -1;
  if (misaligned(q, k, v, o, H, Hkv, hd) ||
      (size_t)kv_row * sizeof(bf16) % 16 != 0 ||
      (size_t)kv_batch * sizeof(bf16) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const Rows R{Q, pos + Q, pos, (size_t)Q * H * hd, (size_t)kv_batch,
               (size_t)kv_row};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_chunk<16>(q, k, v, o, R, B, H, Hkv, scale, st);
    case 32: return launch_chunk<32>(q, k, v, o, R, B, H, Hkv, scale, st);
    case 64: return launch_chunk<64>(q, k, v, o, R, B, H, Hkv, scale, st);
    case 96: return launch_chunk<96>(q, k, v, o, R, B, H, Hkv, scale, st);
    case 128: return launch_chunk<128>(q, k, v, o, R, B, H, Hkv, scale, st);
  }
  return -1;
}
