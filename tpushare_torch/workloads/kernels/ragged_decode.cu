// Ragged decode attention for Hopper (sm_90a).
//
// Replaces tpushare/workloads/ops/ragged_decode.py::_kernel (front door
// ragged_decode_attention), bf16/fp32 slot caches; the int8 {q, s} codec
// rung is not ported in this version.
//
// What it computes: one query token per slot b, H query heads, over the
// slot's own contiguous cache rows k/v[b, 0..lengths[b]] INCLUSIVE (the
// current token's K/V is already written at row lengths[b]). The
// arithmetic is the reference's: q read as fp32, the dot product taken
// first and then scaled by hd^-0.5, an fp32 online softmax, the output
// rounded once to q's dtype. The caller passes one layer of the stacked
// (L, B, S, Hkv, hd) cache by its base pointer, so no slice is copied.
//
// Design: one CTA per (kv head, slot), serving that KV head's G query
// heads, so each live K/V row is read from HBM once for the whole group.
// Eight warps take the live rows round-robin, four rows per warp step for
// independent loads in flight; a warp reads one row as 32 lanes x 4
// contiguous elements (one 8- or 16-byte load per lane, coalesced),
// reduces the dot products with xor shuffles and keeps its own running
// max / sum / accumulator. The partial states merge through shared
// memory at the end. The Pallas kernel's single dot over the expanded
// (block_k x Hkv) column space rationed MXU op count; it is not carried
// over.
//
// Ragged: the row loop stops at lengths[b], so dead rows are never
// loaded and a slot's result does not depend on the allocated S — two
// caches of different capacity holding the same live rows give bitwise
// equal outputs (the loop, its order and its arithmetic are identical).
//
// Bound on this card: bytes. A decode read does ~4 FLOPs per K/V element
// it loads, far below Hopper's ~295 FLOP/byte balance point, so the floor
// is the live K/V bytes over HBM bandwidth. With B x Hkv CTAs the grid
// can be smaller than the 132 SMs at long caches; a split over the rows
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;        // the reference's head-dim gate
constexpr int PER = HD / 32;   // head-dim elements per lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 4;           // rows per warp step

__device__ __forceinline__ void load4(const float* p, float out[PER]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float out[PER]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
    ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths,
                         T* __restrict__ o, int S, int H, int Hkv,
                         float scale) {
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // rows [0, lengths[b]] inclusive, clipped to the cache
  const int len = min(max(lengths[b], -1) + 1, S);

  float qf[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load4(q + ((size_t)b * H + hk * G + g) * HD + lane * PER, qf[g]);

  float m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  }

  const size_t row_step = (size_t)Hkv * HD;
  const size_t base0 = (size_t)b * S * row_step + (size_t)hk * HD + lane * PER;

  for (int r0 = w * U; r0 < len; r0 += WARPS * U) {
    float s[U][G], vv[U][PER];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u;
      valid[u] = r < len;   // warp-uniform
      if (valid[u]) {
        const size_t off = base0 + (size_t)r * row_step;
        float kf[PER];
        load4(k + off, kf);
        load4(v + off, vv[u]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < PER; ++e) part = fmaf(qf[g][e], kf[e], part);
          s[u][g] = part;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) {
          s[u][g] *= scale;
          mx = fmaxf(mx, s[u][g]);
        }
      const float corr = expf(m[g] - mx);   // 0 on the first step
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) {
          const float p = expf(s[u][g] - mx);
          l[g] += p;
#pragma unroll
          for (int e = 0; e < PER; ++e)
            acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
        }
      m[g] = mx;
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) sm_acc[w][g][lane * PER + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - (i / HD) * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, sm_m[ww][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float mw = sm_m[ww][g];
      const float c = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum += sm_l[ww][g] * c;
      osum += sm_acc[ww][g][d] * c;
    }
    o[((size_t)b * H + hk * G + g) * HD + d] =
        from_f32<T>(lsum > 0.f ? osum / lsum : 0.f);
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int B, int S, int H,
                   int Hkv, float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  ragged_decode_kernel<T, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), S, H, Hkv, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_group(int G, const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int B, int S, int H,
                   int Hkv, float scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, 1>(q, k, v, lengths, o, B, S, H, Hkv, scale, st);
    case 2:
      return launch<T, 2>(q, k, v, lengths, o, B, S, H, Hkv, scale, st);
    case 4:
      return launch<T, 4>(q, k, v, lengths, o, B, S, H, Hkv, scale, st);
    case 8:
      return launch<T, 8>(q, k, v, lengths, o, B, S, H, Hkv, scale, st);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int tpushare_ragged_decode(const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* o, int B, int S, int H, int Hkv,
                                      int hd, int is_bf16, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hkv < 1 || H % Hkv != 0 || hd != HD)
    return -1;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_group<__nv_bfloat16>(G, q, k, v, lengths, o, B, S, H,
                                         Hkv, scale, st);
  return dispatch_group<float>(G, q, k, v, lengths, o, B, S, H, Hkv, scale,
                               st);
}

extern "C" const char* tpushare_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
