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
// Design: one CTA per (64-row query tile, b*H + h); 256 threads as a
// 16 x 16 grid. The tiles divide every reference block (b >= 128). The
// Q tile and each 64-row K/V tile are staged in shared memory as fp32,
// each thread owns a 4 x 4 block of the score tile and a 4 x (hd/16)
// block of the accumulator, rows reduced across the 16 threads that
// share them with warp shuffles. It reads the model's (B, S, H, hd)
// layout directly (the reference's transposes are its layout, not its
// function). Query tiles launch heaviest first. Element type (bf16,
// fp32) and head dim (128, 256) are template arguments; at hd 256 the
// tiles take 209 KiB of shared memory.
//
// Bound on this card: at the long-context shape (S = 4096, hd 128) the
// causal FLOPs over bf16 tensor-core peak exceed the bytes over HBM
// bandwidth about 3.5 times, so the kernel is compute-bound in
// principle. This version does its products with plain fp32 FMAs from
// shared memory, not the tensor cores; mma/wgmma tiles and a K/V ring
// are the levers for a later version.

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
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, off, blk, kd, B, S, H, hd,
                                   block, st);
  return dispatch<float>(q, k, v, o, l, off, blk, kd, B, S, H, hd, block,
                         st);
}
