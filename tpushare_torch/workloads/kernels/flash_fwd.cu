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
// Design: one CTA per (64-row query tile, b*H + h); 256 threads as a
// 16 x 16 grid. The Q tile and each 64-row K/V tile are staged in shared
// memory as fp32 (bf16 and fp32 inputs both), each thread owns a 4 x 4
// block of the score tile and a 4 x (hd/16) block of the accumulator,
// rows reduced across the 16 threads that share them with warp
// shuffles. The K/V loop stops at the causal diagonal (block-level skip,
// as the reference's _block_live) and, with a window, starts at the
// band's first tile; a partial last tile is masked, so any S works.
// Query tiles launch heaviest first. Head dims 16, 32, 64, 96 and 128
// (every config of the repo) are instantiated.
//
// Bound on this card: at the forward's shapes (S <= 2048, hd 128) the
// causal FLOPs over bf16 tensor-core peak exceed the bytes over HBM
// bandwidth, so the kernel is compute-bound in principle. This version
// does its dot products with plain fp32 FMAs from shared memory, not the
// tensor cores (simple and exact for fp32 inputs); mma/wgmma tiles are
// the lever for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;          // query rows per CTA
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, B, S, H, Hkv, hd, causal,
                                   window, scale, st);
  return dispatch<float>(q, k, v, o, l, B, S, H, Hkv, hd, causal, window,
                         scale, st);
}

extern "C" const char* tpushare_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
