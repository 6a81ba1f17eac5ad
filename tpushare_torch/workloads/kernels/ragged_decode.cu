// Ragged decode attention for Hopper (sm_90a).
//
// Replaces tpushare/workloads/ops/ragged_decode.py::_kernel (front door
// ragged_decode_attention): bf16/fp32 slot caches, and the int8 {q, s}
// codec rung of the reference's quantized branch (cfg.kv_int8 caches:
// int8 values q, one fp32 scale s per (row, kv head), x ~= q * s).
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
// Eight warps take the live rows round-robin, four rows per warp step: a
// warp issues all four rows' loads before it uses any, so their round
// trips overlap (rows past the length re-read the last live row and are
// masked; with the loads behind a branch per row the compiler kept the
// int8 rung's four round trips in sequence). A warp reads one row as 32
// lanes x 4 contiguous elements (one 4-, 8- or 16-byte load per lane,
// coalesced), reduces the dot products with xor shuffles and keeps its
// own running max / sum / accumulator. The partial states merge through
// shared memory at the end. The Pallas kernel's single dot over the expanded
// (block_k x Hkv) column space rationed MXU op count; it is not carried
// over.
//
// int8 rung: the same kernel with int8 K/V (the KV template argument),
// in the reference's order: s = dot(q, k_q) * hd^-0.5 * k_s, an fp32
// online softmax whose running sum takes the unscaled probability p, and
// an accumulator that adds (p * v_s) * v_q. An int8 row of head_dim 128
// is 128 bytes, so each lane takes one aligned 4-byte load; the row's
// two scales are one fp32 load each (one address per warp).
//
// Ragged: the row loop stops at lengths[b], so dead rows are never
// loaded and a slot's result does not depend on the allocated S — two
// caches of different capacity holding the same live rows give bitwise
// equal outputs (the loop, its order and its arithmetic are identical).
//
// Bound on this card: bytes. A decode read does ~4 FLOPs per K/V element
// it loads, far below Hopper's ~295 FLOP/byte balance point, so the floor
// is the live K/V bytes over HBM bandwidth (int8: hd + 4 bytes per row
// and head, against 2 hd for bf16). With B x Hkv CTAs the grid
// can be smaller than the 132 SMs at long caches; a split over the rows
// is later work.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

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

__device__ __forceinline__ void load4(const int8_t* p, float out[PER]) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}

// the launch's arguments: k / v one layer's (B, S, Hkv, HD) base; ks / vs
// the int8 rung's (B, S, Hkv) scale planes, null for a bf16/fp32 cache
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* lengths;
  void* o;
  int B, S, H, Hkv;
  float scale;
};

template <typename T, typename KV, int G>
__global__ void __launch_bounds__(THREADS) ragged_decode_kernel(Args a) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KV* __restrict__ k = static_cast<const KV*>(a.k);
  const KV* __restrict__ v = static_cast<const KV*>(a.v);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int S = a.S, H = a.H, Hkv = a.Hkv;
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  // rows [0, lengths[b]] inclusive, clipped to the cache
  const int len = min(max(a.lengths[b], -1) + 1, S);

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

  for (int r0 = w * U; r0 < len; r0 += WARPS * U) {
    // every row's loads are issued before any is used, so each warp
    // keeps U rows in flight; a row past the length re-reads the last
    // live one (len >= 1 inside the loop) and is masked below
    float kf[U][PER], vv[U][PER], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // (slot, row, kv head): the scale's index; x HD the row's
      const size_t srow =
          ((size_t)b * S + min(r0 + u, len - 1)) * Hkv + hk;
      const size_t off = srow * HD + lane * PER;
      load4(k + off, kf[u]);
      load4(v + off, vv[u]);
      ksc[u] = vsc[u] = 1.f;
      if constexpr (INT8) {
        ksc[u] = a.ks[srow];
        vsc[u] = a.vs[srow];
      }
    }
    float s[U][G];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      valid[u] = r0 + u < len;   // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) part = fmaf(qf[g][e], kf[u][e], part);
        s[u][g] = part;
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
          s[u][g] *= a.scale;
          if constexpr (INT8) s[u][g] *= ksc[u];
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
          const float pv = INT8 ? p * vsc[u] : p;
#pragma unroll
          for (int e = 0; e < PER; ++e)
            acc[g][e] = fmaf(pv, vv[u][e], acc[g][e]);
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

template <typename T, typename KV, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.Hkv, a.B);
  ragged_decode_kernel<T, KV, G><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV>
int dispatch_group(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, KV, 1>(a, st);
    case 2:
      return launch<T, KV, 2>(a, st);
    case 4:
      return launch<T, KV, 4>(a, st);
    case 8:
      return launch<T, KV, 8>(a, st);
    default:
      return -1;
  }
}

template <typename T>
int dispatch_kv(int is_int8, int G, const Args& a, cudaStream_t st) {
  if (is_int8) return dispatch_group<T, int8_t>(G, a, st);
  return dispatch_group<T, T>(G, a, st);
}

}  // namespace

// ks / vs: the int8 rung's scale planes (B, S, Hkv) fp32 of the same
// layer, or null with is_int8 0 (then k / v hold q's dtype)
extern "C" int tpushare_ragged_decode(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* lengths,
                                      void* o, int B, int S, int H, int Hkv,
                                      int hd, int is_bf16, int is_int8,
                                      float scale, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hkv < 1 || H % Hkv != 0 || hd != HD ||
      (is_int8 && (ks == nullptr || vs == nullptr)))
    return -1;
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs),
               static_cast<const int*>(lengths), o, B, S, H, Hkv, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_kv<__nv_bfloat16>(is_int8, H / Hkv, a, st);
  return dispatch_kv<float>(is_int8, H / Hkv, a, st);
}
