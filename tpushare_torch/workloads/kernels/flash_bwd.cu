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
// Design. Blocks run in parallel and in no order, so each sequential
// grid axis of the Pallas kernels becomes a loop inside one CTA, and no
// sum crosses CTAs (no atomics: the gradients are deterministic).
// - dq: one CTA per (64-row query tile, b*H + h). Q, dO, lse and delta
//   are staged once; the CTA loops over the live K tiles (up to the
//   causal diagonal, from the window band's first tile) and accumulates
//   dS K in registers.
// - dkv: one CTA per (64-row key tile, b*Hkv + hk). K and V are staged
//   once; the CTA loops over the group's query heads and, for each, over
//   the query tiles from the diagonal to the band's end, accumulating
//   P^T dO and dS^T Q in registers. This is the reference's group * n_q
//   sweep: the GQA sum happens inside one CTA.
// Both use 256 threads as a 16 x 16 grid with fp32 shared-memory tiles
// (row stride hd + 1, so column walks hit distinct banks) and plain fp32
// FMAs, as the forward does. Each thread owns a 4 x 4 block of the score
// tile and a 4 x (hd/16) block of each accumulator: at hd 128 that is
// 64 fp32 accumulator registers a thread in dkv (dK and dV), which fits
// the 255-register budget of a 256-thread CTA without shrinking the
// tiles. Shared memory at hd 128: dq 145 KiB, dkv 162 KiB (one CTA per
// SM). Any S works (the partial tile is masked and zero-filled).
//
// Bound on this card: the backward's matrix products (five S x S x hd
// products on the live pairs at the least; this two-kernel design
// recomputes q k^T and dO v^T in both kernels, seven in all) put it far
// above the bytes it moves at the training shapes, so it is
// compute-bound in principle. Without tensor cores it runs at the fp32
// FMA rate; mma/wgmma tiles are the lever for a later version.

#include "common.cuh"

namespace {

constexpr int BM = 64;          // query rows per tile
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = 256;    // 16 x 16

// does query qi see key kj under the forward's mask?
__device__ __forceinline__ bool live(int qi, int kj, int S, int causal,
                                     int window) {
  return qi < S && kj < S &&
         (!causal || (kj <= qi && (window <= 0 || kj > qi - window)));
}

// Stage 64 sequence rows of one head of a (B, S, heads, HD) tensor,
// starting at position r0, into shared memory with row stride HD + 1;
// rows past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t step, int r0, int S) {
  for (int i = threadIdx.x; i < 64 * HD; i += THREADS) {
    const int r = i / HD, d = i - (i / HD) * HD;
    const int s = r0 + r;
    dst[r * (HD + 1) + d] = s < S ? to_f32(src[(size_t)s * step + d]) : 0.f;
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, int H, int Hkv, int causal, int window,
                        float scale) {
  constexpr int LD = HD + 1;
  constexpr int PS = BN + 1;
  constexpr int DJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* sq = smem;              // BM x LD
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

  stage<T, HD>(sq, q + q_off, q_step, q0, S);
  stage<T, HD>(sdo, dout + q_off, q_step, q0, S);
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
    stage<T, HD>(sk, k + kv_off, kv_step, k0, S);
    stage<T, HD>(sv, v + kv_off, kv_step, k0, S);
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

  T* dqb = dq + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqb[(size_t)qi * q_step + tx + 16 * j] =
            from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int S,
                         int H, int Hkv, int causal, int window,
                         float scale) {
  constexpr int LD = HD + 1;
  constexpr int PS = BM + 1;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* sk = smem;              // BN x LD
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

  stage<T, HD>(sk, k + kv_off, kv_step, k0, S);
  stage<T, HD>(sv, v + kv_off, kv_step, k0, S);
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
      stage<T, HD>(sq, q + q_off, q_step, q0, S);
      stage<T, HD>(sdo, dout + q_off, q_step, q0, S);
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

  T* dkb = dk + kv_off;
  T* dvb = dv + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj < S) {
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t at = (size_t)kj * kv_step + tx + 16 * j;
        dkb[at] = from_f32<T>(dk_acc[i][j] * scale);
        dvb[at] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int S, int H, int Hkv, int causal,
                      int window, float scale, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, H, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int S,
                       int H, int Hkv, int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BN - 1) / BN, B * Hkv);
  flash_bwd_dkv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, causal, window,
      scale);
  return cudaGetLastError();
}

bool bad_args(int B, int S, int H, int Hkv, int causal, int window) {
  return B < 1 || S < 1 || Hkv < 1 || H % Hkv != 0 || B * H > 65535 ||
         window < 0 || (window > 0 && !causal);
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                void* dq, int B, int S, int H, int Hkv, int hd, int causal,
                int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     Hkv, causal, window, scale, st);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     Hkv, causal, window, scale, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     Hkv, causal, window, scale, st);
    case 96: return launch_dq<T, 96>(q, k, v, dout, lse, delta, dq, B, S, H,
                                     Hkv, causal, window, scale, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, B, S,
                                       H, Hkv, causal, window, scale, st);
  }
  return -1;
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dk, void* dv, int B, int S, int H, int Hkv, int hd,
                 int causal, int window, float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, Hkv, causal, window, scale, st);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, Hkv, causal, window, scale, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, Hkv, causal, window, scale, st);
    case 96: return launch_dkv<T, 96>(q, k, v, dout, lse, delta, dk, dv, B,
                                      S, H, Hkv, causal, window, scale, st);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv,
                                        B, S, H, Hkv, causal, window, scale,
                                        st);
  }
  return -1;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, S, H, Hkv,
                                      hd, causal, window, scale, st);
  return dispatch_dq<float>(q, k, v, dout, l, dl, dq, B, S, H, Hkv, hd,
                            causal, window, scale, st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16)
    return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, B, S, H,
                                       Hkv, hd, causal, window, scale, st);
  return dispatch_dkv<float>(q, k, v, dout, l, dl, dk, dv, B, S, H, Hkv, hd,
                             causal, window, scale, st);
}
