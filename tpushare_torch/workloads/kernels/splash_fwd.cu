// Splash-attention forward for Hopper (sm_90a).
//
// Replaces the upstream splash forward kernel (jax's
// pallas/ops/tpu/splash_attention/splash_attention_kernel.py
// flash_attention_kernel, under make_splash_mha) as the reference
// builds it in tpushare/workloads/ops/registry.py::_build_prefill_splash
// for long-context MHA prefill: MultiHeadMask of CausalMask((S, S)),
// one block edge b for every block size (512 where it tiles S, else the
// largest power of two >= 128 that does).
//
// What it computes, per (b, h) of the pre-scaled q (B, S, H, hd) against
// k/v (B, S, H, hd): softmax(q k^T masked) v with no further scale (the
// wrapper multiplied q by hd^-0.5, as the reference does), the causal
// mask's dropped scores at upstream's DEFAULT_MASK_VALUE
// (-0.7 * FLT_MAX), the running max starting at that value, running
// max / sum / accumulator in fp32, and the output in q's dtype. When
// ``lse`` is not null it also writes each row's m + log(l) as fp32 into
// a (B, H, S) array: the residual the backward (splash_bwd.cu) reads.
//
// The block schedule (ops/splash_mask.py) lists, per query block of b
// rows, the key blocks the mask touches in order, each flagged full or
// partial; skipped blocks are absent and never read. The causal mask is
// applied only inside partial blocks; there, key tiles past the query
// tile's last row hold masked scores only, which add exactly zero to the
// softmax (exp(MASK - m) underflows once a row has a live score, and the
// key tiles run in order, the first holding each row's key 0 or a live
// full block), so they are not read either.
//
// Bound on this card: operations. At the long-context shape (S = 4096,
// hd 128) the causal FLOPs over bf16 tensor-core peak exceed the bytes
// over HBM bandwidth about 3.5 times.
//
// bf16: tensor cores, through attn_fwd_tile.cuh (the tile body K1's bf16
// rung shares). One CTA per (64-row query tile, b*H + h): at hd 128 four
// warps, a 16-row strip each with its Q fragments in registers, two CTAs
// an SM; at hd 256 eight (two warps a strip, one per half of O's
// columns). 64-key K/V tiles stream through a two-slot cp.async ring
// along the schedule's walk; each warp skips the tiles wholly past its
// strip's last row, and masks only the tiles that cross its diagonal. P
// stays in registers, split into two bf16 halves for P V (so the output
// keeps the fp32-P reference's precision; see the tile header). Shared
// memory: 68 KiB at hd 128 (Q staged in a ring slot), 165 KiB at hd 256.
//
// fp32: CUDA cores. On tensor cores fp32 operands run as TF32, which the
// fp32 check would rightly refuse, so fp32 stays on plain FMAs: 256
// threads as a 16 x 16 grid, the Q tile and each 64-row K/V tile staged
// in shared memory as fp32, each thread owning a 4 x 4 block of the
// score tile and a 4 x (hd/16) block of the accumulator, rows reduced
// across the 16 threads that share them with warp shuffles. At hd 256
// those tiles take 209 KiB of shared memory.
//
// Both read the model's (B, S, H, hd) layout directly (the reference's
// transposes are its layout, not its function), and launch query tiles
// heaviest first.

#include "attn_fwd_tile.cuh"
#include "common.cuh"

namespace {

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PARTIAL = 1;      // schedule kinds: 1 partial, 2 full
// upstream DEFAULT_MASK_VALUE, rounded to fp32 as the reference rounds it
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K padded to HD+1 floats a row (column walks hit distinct
  // banks), V unpadded, the probability tile padded to BN+1
  return sizeof(float) *
         (size_t)(BM * (HD + 1) + BN * (HD + 1) + BN * HD + BM * (BN + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    splash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse,
                      const int* __restrict__ offsets,
                      const int* __restrict__ blocks,
                      const int* __restrict__ kinds, int S, int H,
                      int block) {
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
  const int q_last = q0 + BM - 1;
  const int row = blockIdx.y;                          // b * H + h
  const int b = row / H;
  const int h = row - b * H;

  const size_t step = (size_t)H * HD;      // between sequence positions
  const size_t off = (size_t)b * S * step + (size_t)h * HD;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;

  for (int i = tid; i < BM * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    sq[r * QS + d] = to_f32(qb[(size_t)(q0 + r) * step + d]);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASK_VALUE;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int qblk = q0 / block;
  for (int e = offsets[qblk]; e < offsets[qblk + 1]; ++e) {
    const bool partial = kinds[e] == PARTIAL;
    const int k_begin = blocks[e] * block;
    const int k_end = partial ? min(k_begin + block, q_last + 1)
                              : k_begin + block;
    for (int k0 = k_begin; k0 < k_end; k0 += BN) {
      __syncthreads();   // the previous tile's readers are done
      for (int i = tid; i < BN * HD; i += THREADS) {
        const int r = i / HD, d = i - (i / HD) * HD;
        const size_t at = (size_t)(k0 + r) * step + d;
        sk[r * QS + d] = to_f32(kb[at]);
        sv[r * HD + d] = to_f32(vb[at]);
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

      // mask (partial blocks only), online softmax; a row's 64 scores
      // live in the 16 threads of one half-warp, reduced with xor
      // shuffles over tx
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty * 4 + i;
        float mx = MASK_VALUE;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (partial && k0 + tx + 16 * j > qi) s[i][j] = MASK_VALUE;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int sh = 8; sh > 0; sh >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
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
        for (int sh = 8; sh > 0; sh >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
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
  }

  T* ob = o + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(size_t)qi * step + tx + 16 * j] = from_f32<T>(acc[i][j] / l[i]);
    if (lse != nullptr && tx == 0)
      lse[(size_t)row * S + qi] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using mma::bf16;

// The key tiles of a query tile's walk along its row of the schedule: for
// each live block in order, BN-key tiles from the block's first row to its
// end, lowered to hi (the query tile's end) inside a partial block.
struct Walk {
  const int* blocks;
  const int* kinds;
  int e, e_end, block, hi;
  int pos, end;      // the current tile's first key; its block's end
  bool partial;

  __device__ Walk(const int* offsets, const int* blocks_, const int* kinds_,
                  int r, int block_, int hi_)
      : blocks(blocks_), kinds(kinds_), e(offsets[r]), e_end(offsets[r + 1]),
        block(block_), hi(hi_) {
    enter();
  }
  __device__ bool done() const { return e >= e_end; }
  __device__ void next() {
    pos += fwd::BN;
    if (pos >= end) {
      ++e;
      enter();
    }
  }
  __device__ void enter() {
    for (; e < e_end; ++e) {
      partial = kinds[e] == PARTIAL;
      pos = blocks[e] * block;
      end = partial ? min(pos + block, hi) : pos + block;
      if (pos < end) return;
    }
  }
};

struct Causal {
  __device__ bool operator()(int q, int k) const { return k <= q; }
};

template <int HD>
__global__ void __launch_bounds__(fwd::Tiles<HD>::THREADS, 1)
    splash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, const int* __restrict__ offsets,
                   const int* __restrict__ blocks,
                   const int* __restrict__ kinds, int S, int H, int block) {
  using C = fwd::Tiles<HD>;
  constexpr int LD = C::LD;
  constexpr int BN = fwd::BN;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sq = C::q_tile(mma_smem);
  bf16* ring = C::ring(mma_smem);   // STAGES slots of (K, V)

  const int warp = threadIdx.x >> 5;
  const int wr = warp % C::WR;                  // row strip
  const int c0 = (warp / C::WR) * (HD / C::WC); // first O column
  const int g = mma::frag_row(), fc = mma::frag_col();
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BM;   // heaviest first
  const int r0 = q0 + wr * 16;                  // the strip's first row
  const int row = blockIdx.y;                   // b * H + h
  const int b = row / H;
  const int h = row - b * H;
  const size_t step = (size_t)H * HD;           // between positions
  const size_t off = (size_t)b * S * step + (size_t)h * HD;

  auto slot_k = [&](int i) { return ring + (i % C::STAGES) * 2 * BN * LD; };
  auto fill = [&](int i, int k0) {
    bf16* sk = slot_k(i);
    mma::load_tile<BN, HD, C::THREADS>(sk, k + off + k0 * step, step);
    mma::load_tile<BN, HD, C::THREADS>(sk + BN * LD, v + off + k0 * step,
                                       step);
  };

  // Q is its own commit group, ahead of the ring's
  mma::load_tile<C::BM, HD, C::THREADS>(sq, q + off + q0 * step, step);
  mma::commit();
  // keys past the query tile's last row are masked out: not read
  Walk walk(offsets, blocks, kinds, q0 / block, block, q0 + C::BM);
  Walk ahead = walk;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (!ahead.done()) {
      fill(s, ahead.pos);
      ahead.next();
    }
    mma::commit();
  }
  mma::wait_newest<C::STAGES - 1>();
  __syncthreads();
  const fwd::QFrags<HD, C::Q_IN_REGISTERS> qf(sq, wr * 16);
  fwd::Strip<C::N8> st(MASK_VALUE);

  for (int i = 0; !walk.done(); ++i, walk.next()) {
    mma::ring_wait<C::STAGES>();
    if (!ahead.done()) {
      fill(i + C::STAGES - 1, ahead.pos);
      ahead.next();
    }
    mma::commit();
    const bf16* sk = slot_k(i);
    const int k0 = walk.pos;
    if (walk.partial && k0 > r0 + 15) continue;   // past its rows
    if (walk.partial && k0 + BN - 1 > r0)         // its diagonal
      fwd::tile<true, HD>(st, qf, sk, sk + BN * LD, c0, fwd::LOG2E, r0 + g,
                          k0 + fc, Causal{});
    else
      fwd::tile<false, HD>(st, qf, sk, sk + BN * LD, c0, fwd::LOG2E, r0 + g,
                           k0 + fc, Causal{});
  }

  st.finish();
  mma::store_acc<C::N8>(o + off + (size_t)r0 * step + c0, step, st.o);
  if (lse != nullptr && c0 == 0 && fc == 0) {
    lse[(size_t)row * S + r0 + g] = st.m[0] + logf(st.l[0]);
    lse[(size_t)row * S + r0 + g + 8] = st.m[1] + logf(st.l[1]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* offsets, const int* blocks,
                   const int* kinds, int B, int S, int H, int block,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      splash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BM, B * H);
  splash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, offsets, blocks,
      kinds, S, H, block);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, const int* offsets, const int* blocks,
             const int* kinds, int B, int S, int H, int hd, int block,
             cudaStream_t st) {
  switch (hd) {
    case 128: return launch<T, 128>(q, k, v, o, lse, offsets, blocks, kinds,
                                    B, S, H, block, st);
    case 256: return launch<T, 256>(q, k, v, o, lse, offsets, blocks, kinds,
                                    B, S, H, block, st);
  }
  return -1;
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, const int* offsets, const int* blocks,
               const int* kinds, int B, int S, int H, int block,
               cudaStream_t stream) {
  using C = fwd::Tiles<HD>;
  if (block % C::BM) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      splash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / C::BM, B * H);
  splash_fwd_mma<HD><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, offsets,
      blocks, kinds, S, H, block);
  return cudaGetLastError();
}

// cp.async copies 16-byte chunks: every bf16 tensor and row must start
// 16-byte aligned, as a tensor from the caching allocator does
bool misaligned(const void* q, const void* k, const void* v, const void* o,
                int H, int hd) {
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return (size_t)H * hd * sizeof(bf16) % 16 != 0;
}

}  // namespace

// q (pre-scaled), k, v, o: (B, S, H, hd); lse: null, or fp32 (B, H, S);
// offsets / blocks / kinds: the forward block schedule of edge ``block``
extern "C" int tpushare_splash_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* offsets, const void* blocks,
                                   const void* kinds, int B, int S, int H,
                                   int hd, int block, int is_bf16,
                                   void* stream) {
  if (B < 1 || H < 1 || B * H > 65535 || block < BM || block % BM != 0 ||
      S < block || S % block != 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* off = static_cast<const int*>(offsets);
  const int* blk = static_cast<const int*>(blocks);
  const int* kd = static_cast<const int*>(kinds);
  if (is_bf16) {
    if (misaligned(q, k, v, o, H, hd)) return cudaErrorMisalignedAddress;
    switch (hd) {
      case 128: return launch_mma<128>(q, k, v, o, l, off, blk, kd, B, S, H,
                                       block, st);
      case 256: return launch_mma<256>(q, k, v, o, l, off, blk, kd, B, S, H,
                                       block, st);
    }
    return -1;
  }
  return dispatch<float>(q, k, v, o, l, off, blk, kd, B, S, H, hd, block,
                         st);
}
