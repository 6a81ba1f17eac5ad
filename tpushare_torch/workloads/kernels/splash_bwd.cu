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
// Design. Blocks run in parallel and in no order, so upstream's
// sequential grid axis becomes a loop inside one CTA and no sum crosses
// CTAs (no atomics: the gradients are deterministic).
// - dq: one CTA per (BQ-row query tile, b*H + h); Q, dO, lse and di are
//   staged once, the CTA loops over the live 64-row key tiles and
//   accumulates round(dS) k in registers.
// - dkv: one CTA per (64-row key tile, b*H + h); K and V are staged
//   once, the CTA loops over the live BQ-row query tiles and accumulates
//   round(P)^T dO and round(dS)^T q in registers.
// Both use 256 threads as a 16 x 16 grid with fp32 shared-memory tiles
// (row stride hd + 1) and plain fp32 FMAs. BQ is 64 at hd 128 and 32 at
// hd 256, so the staged tiles fit the 227 KiB a block may use (hd 128:
// dq 145 KiB, dkv 162 KiB; hd 256: dq 201 KiB, dkv 210 KiB) and the dkv
// thread's two hd/16 x 4 accumulators fit its 255 registers.
//
// Bound on this card: five S x S x hd products on the live pairs at the
// least (this two-kernel design recomputes q k^T and dO v^T in both,
// seven in all) put the backward far above its bytes at S = 4096, so it
// is compute-bound in principle; without tensor cores it runs at the
// fp32 FMA rate (mma/wgmma tiles are the lever for a later version).

#include "common.cuh"

namespace {

constexpr int BK = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16
constexpr int PARTIAL = 1;      // schedule kinds: 1 partial, 2 full

template <int HD>
__host__ __device__ constexpr int query_tile() { return HD > 128 ? 32 : 64; }

// Stage ROWS sequence rows of one head of a (B, S, H, HD) tensor,
// starting at position r0, into shared memory with row stride HD + 1.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t step, int r0) {
  for (int i = threadIdx.x; i < ROWS * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    dst[r * (HD + 1) + d] = to_f32(src[(size_t)(r0 + r) * step + d]);
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dq,
                         const int* __restrict__ offsets,
                         const int* __restrict__ blocks,
                         const int* __restrict__ kinds, int S, int H,
                         int block) {
  constexpr int BQ = query_tile<HD>();
  constexpr int RM = BQ / 16;   // query rows per thread
  constexpr int LD = HD + 1;
  constexpr int PS = BK + 1;
  constexpr int DJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // BQ x LD
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

  stage<T, HD, BQ>(sq, q + off, step, q0);
  stage<T, HD, BQ>(sdo, dout + off, step, q0);
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
      stage<T, HD, BK>(sk, k + off, step, k0);
      stage<T, HD, BK>(sv, v + off, step, k0);
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

      // dS = P o (dP - di), rounded to T, into shared memory
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int qi = q0 + ty * RM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool dropped = partial && k0 + tx + 16 * j > qi;
          const float p = dropped ? 0.f : expf(s[i][j] - lse_r[i]);
          sds[(ty * RM + i) * PS + tx + 16 * j] =
              round_to<T>(p * (dp[i][j] - di_r[i]));
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

  T* dqb = dq + off;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(size_t)qi * step + tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    splash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ di,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const int* __restrict__ offsets,
                          const int* __restrict__ blocks,
                          const int* __restrict__ kinds, int S, int H,
                          int block) {
  constexpr int BQ = query_tile<HD>();
  constexpr int CQ = BQ / 16;   // query columns per thread
  constexpr int LD = HD + 1;
  constexpr int PS = BQ + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* sk = smem;              // BK x LD
  float* sv = sk + BK * LD;      // BK x LD
  float* sq = sv + BK * LD;      // BQ x LD
  float* sdo = sq + BQ * LD;     // BQ x LD
  float* sp = sdo + BQ * LD;     // BK x PS: round(P)^T
  float* sds = sp + BK * PS;     // BK x PS: round(dS)^T
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

  stage<T, HD, BK>(sk, k + off, step, k0);
  stage<T, HD, BK>(sv, v + off, step, k0);
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
      stage<T, HD, BQ>(sq, q + off, step, q0);
      stage<T, HD, BQ>(sdo, dout + off, step, q0);
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
          sp[(ty * 4 + i) * PS + ql] = round_to<T>(p);
          sds[(ty * 4 + i) * PS + ql] = round_to<T>(p * (dp[i][j] - sdi[ql]));
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

  T* dkb = dk + off;
  T* dvb = dv + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const size_t at = (size_t)kj * step + tx + 16 * j;
      dkb[at] = from_f32<T>(dk_acc[i][j]);
      dvb[at] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* di,
                      void* dq, const int* offsets, const int* blocks,
                      const int* kinds, int B, int S, int H, int block,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      splash_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / query_tile<HD>(), B * H);
  splash_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dq), offsets, blocks, kinds, S, H, block);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* di,
                       void* dk, void* dv, const int* offsets,
                       const int* blocks, const int* kinds, int B, int S,
                       int H, int block, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      splash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BK, B * H);
  splash_bwd_dkv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
      static_cast<T*>(dk), static_cast<T*>(dv), offsets, blocks, kinds, S,
      H, block);
  return cudaGetLastError();
}

bool bad_args(int B, int S, int H, int block) {
  return B < 1 || H < 1 || B * H > 65535 || block < BK || block % BK != 0 ||
         S < block || S % block != 0;
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* di,
                void* dq, const int* off, const int* blk, const int* kd,
                int B, int S, int H, int hd, int block, cudaStream_t st) {
  switch (hd) {
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, di, dq, off, blk,
                                       kd, B, S, H, block, st);
    case 256: return launch_dq<T, 256>(q, k, v, dout, lse, di, dq, off, blk,
                                       kd, B, S, H, block, st);
  }
  return -1;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* di,
                 void* dk, void* dv, const int* off, const int* blk,
                 const int* kd, int B, int S, int H, int hd, int block,
                 cudaStream_t st) {
  switch (hd) {
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, di, dk, dv, off,
                                        blk, kd, B, S, H, block, st);
    case 256: return launch_dkv<T, 256>(q, k, v, dout, lse, di, dk, dv, off,
                                        blk, kd, B, S, H, block, st);
  }
  return -1;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  const int* off = static_cast<const int*>(offsets);
  const int* blk = static_cast<const int*>(blocks);
  const int* kd = static_cast<const int*>(kinds);
  if (is_bf16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, off, blk, kd,
                                      B, S, H, hd, block, st);
  return dispatch_dq<float>(q, k, v, dout, l, d, dq, off, blk, kd, B, S, H,
                            hd, block, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  const int* off = static_cast<const int*>(offsets);
  const int* blk = static_cast<const int*>(blocks);
  const int* kd = static_cast<const int*>(kinds);
  if (is_bf16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, off, blk,
                                       kd, B, S, H, hd, block, st);
  return dispatch_dkv<float>(q, k, v, dout, l, d, dk, dv, off, blk, kd, B, S,
                             H, hd, block, st);
}
