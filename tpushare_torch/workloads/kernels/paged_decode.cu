// Paged-attention decode read for Hopper (sm_90a).
//
// Replaces the upstream Pallas paged_attention kernel that the reference
// reaches through tpushare/workloads/ops/registry.py::_build_paged_pallas
// (front door ops/paged_attention.py::paged_attention_read): bf16/fp32
// pools, and the int8 rung the reference serves from QuantizedTensor
// pages (registry.py:617-665), where a pool row holds int8 values q and
// one fp32 scale s per (row, kv head), x ~= q * s.
//
// What it computes: one query token per lane b attends over the lane's
// block-table pages. Row r of lane b lives at
// pool[tables[b, r / page_size], r % page_size, kv_head, :]; rows
// >= kv_lens[b] are masked. The arithmetic follows the reference's
// gather twin (xla_paged_read), not the upstream kernel: q is read as
// fp32, the dot product is taken first and then scaled by hd^-0.5, and
// the softmax runs online in fp32. Table entries may alias (shared
// prefix pages): every row is addressed through its own table slot.
// A lane with kv_lens 0 writes zeros (the serving engine never issues
// one: its read covers the just-written row, kv_lens >= 1).
//
// int8 rung: the same kernel with int8 K/V (the KV template argument).
// A lane reads its hd/32 int8 elements of a row as one 4-byte (hd 128)
// or 2-byte (hd 64) load, and the row's K and V scales as one fp32 each
// (one address for the warp, a broadcast). The K scale multiplies the
// score after hd^-0.5; the V scale multiplies the probability before it
// weights the row, while the running sum takes the unscaled probability.
// The twin dequantizes first (q * s) and then takes fp32 einsums, so the
// two differ in fp32 rounding only. The upstream kernel's /127.5 scale
// convention belongs to that kernel and is not carried over.
//
// Design: one CTA per (kv head, lane), serving that KV head's G query
// heads, so each K/V row is read from HBM once for the whole group. Eight
// warps split the rows round-robin, four rows per warp step: a warp
// issues all four rows' loads (table entry, K, V, scales) before it uses
// any, so their round trips overlap — rows past the length re-read the
// last live row and are masked. A warp reads one row as 32 lanes x hd/32
// contiguous elements in one vector load per lane (coalesced), reduces
// the dot products with xor shuffles and keeps its own running max /
// sum / accumulator. The eight partial states merge through shared
// memory at the end.
//
// Bound on this card: bytes. A decode read does ~4 FLOPs per K/V element
// it loads, far below Hopper's ~295 FLOP/byte balance point, so the
// floor is the live K/V bytes over HBM bandwidth (int8: hd + 4 bytes per
// row and head, against 2 hd for bf16); the kernel reads only live rows
// (no gather copy, no dead pages) to stay near it.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 4;   // rows per warp step

// one lane's PER contiguous elements of a row, as fp32, in one vector
// load (4 or 2 bytes int8, 8 or 4 bytes bf16, 16 or 8 bytes fp32)
template <int PER, typename KV>
__device__ __forceinline__ void load_row(const KV* p, float out[PER]) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    static_assert(PER == 2 || PER == 4, "int8 rows: head_dim 64 or 128");
    if constexpr (PER == 4) {
      const char4 x = *reinterpret_cast<const char4*>(p);
      out[0] = x.x;
      out[1] = x.y;
      out[2] = x.z;
      out[3] = x.w;
    } else {
      const char2 x = *reinterpret_cast<const char2*>(p);
      out[0] = x.x;
      out[1] = x.y;
    }
  } else if constexpr (std::is_same<KV, float>::value && PER == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (std::is_same<KV, float>::value) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else if constexpr (PER == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
    out[0] = lo.x;
    out[1] = lo.y;
    out[2] = hi.x;
    out[3] = hi.y;
  } else {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x;
    out[1] = x.y;
  }
}

// the launch's arguments; ks / vs are the int8 rung's scale planes
// (n_pages, ps, Hkv), null for a bf16/fp32 pool
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ks;
  const float* vs;
  const int* tables;
  int table_stride;
  int n_table;
  const int* kv_lens;
  void* o;
  int B, H, Hkv, ps;
  float scale;
};

template <typename T, typename KV, int HD, int G>
__global__ void __launch_bounds__(THREADS) paged_decode_kernel(Args a) {
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  constexpr int PER = HD / 32;   // head-dim elements per lane
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KV* __restrict__ kp = static_cast<const KV*>(a.kp);
  const KV* __restrict__ vp = static_cast<const KV*>(a.vp);
  T* __restrict__ o = static_cast<T*>(a.o);
  const int H = a.H, Hkv = a.Hkv, ps = a.ps;
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int len = max(0, min(a.kv_lens[b], a.n_table * ps));

  float qf[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < PER; ++e)
      qf[g][e] = to_f32(q[((size_t)b * H + hk * G + g) * HD + lane * PER + e]);

  float m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < PER; ++e) acc[g][e] = 0.f;
  }

  const int* trow = a.tables + (size_t)b * a.table_stride;

  for (int r0 = w * U; r0 < len; r0 += WARPS * U) {
    // every row's loads are issued before any is used, so each warp
    // keeps U rows in flight; a row past the length re-reads the last
    // live one (len >= 1 inside the loop) and is masked below
    float kf[U][PER], vv[U][PER], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = min(r0 + u, len - 1);
      // (page, row in page, kv head): the scale's index; x HD the row's
      const size_t srow =
          ((size_t)trow[r / ps] * ps + (size_t)(r % ps)) * Hkv + hk;
      const size_t base = srow * HD + lane * PER;
      load_row<PER>(kp + base, kf[u]);
      load_row<PER>(vp + base, vv[u]);
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

template <typename T, typename KV, int HD, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<T, KV, HD, G><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int HD>
int dispatch_group(int G, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, KV, HD, 1>(a, st);
    case 2:
      return launch<T, KV, HD, 2>(a, st);
    case 4:
      return launch<T, KV, HD, 4>(a, st);
    case 8:
      return launch<T, KV, HD, 8>(a, st);
    default:
      return -1;
  }
}

template <typename T, typename KV>
int dispatch_hd(int hd, int G, const Args& a, cudaStream_t st) {
  if (hd == 64) return dispatch_group<T, KV, 64>(G, a, st);
  if (hd == 128) return dispatch_group<T, KV, 128>(G, a, st);
  return -1;
}

template <typename T>
int dispatch_kv(int is_int8, int hd, int G, const Args& a, cudaStream_t st) {
  if (is_int8) return dispatch_hd<T, int8_t>(hd, G, a, st);
  return dispatch_hd<T, T>(hd, G, a, st);
}

}  // namespace

// ks / vs: the int8 rung's scale planes (n_pages, ps, Hkv) fp32, or null
// with is_int8 0 (then kp / vp hold q's dtype)
extern "C" int tpushare_paged_decode(const void* q, const void* kp,
                                     const void* vp, const void* ks,
                                     const void* vs, const void* tables,
                                     int table_stride, int n_table,
                                     const void* kv_lens, void* o, int B,
                                     int H, int Hkv, int hd, int ps,
                                     int is_bf16, int is_int8, float scale,
                                     void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || H % Hkv != 0 || ps < 1 ||
      n_table < 1 || (is_int8 && (ks == nullptr || vs == nullptr)))
    return -1;
  const Args a{q, kp, vp, static_cast<const float*>(ks),
               static_cast<const float*>(vs),
               static_cast<const int*>(tables), table_stride, n_table,
               static_cast<const int*>(kv_lens), o, B, H, Hkv, ps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_kv<__nv_bfloat16>(is_int8, hd, H / Hkv, a, st);
  return dispatch_kv<float>(is_int8, hd, H / Hkv, a, st);
}
