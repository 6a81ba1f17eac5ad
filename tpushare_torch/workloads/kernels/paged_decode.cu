// Paged-attention decode read for Hopper (sm_90a).
//
// Replaces the upstream Pallas paged_attention kernel that the reference
// reaches through tpushare/workloads/ops/registry.py::_build_paged_pallas
// (front door ops/paged_attention.py::paged_attention_read), bf16/fp32
// pools; the int8 QuantizedTensor rung is not ported in this version.
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
// Design: one CTA per (kv head, lane), serving that KV head's G query
// heads, so each K/V row is read from HBM once for the whole group. Eight
// warps split the rows round-robin, four rows per warp step for
// independent loads in flight; a warp reads one row as 32 lanes x hd/32
// contiguous elements (coalesced), reduces the dot products with xor
// shuffles and keeps its own running max / sum / accumulator. The eight
// partial states merge through shared memory at the end.
//
// Bound on this card: bytes. A decode read does ~4 FLOPs per K/V element
// it loads, far below Hopper's ~295 FLOP/byte balance point, so the
// floor is the live K/V bytes over HBM bandwidth; the kernel reads only
// live rows (no gather copy, no dead pages) to stay near it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 4;   // rows per warp step

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

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ tables, int table_stride,
                        int n_table, const int* __restrict__ kv_lens,
                        T* __restrict__ o, int H, int Hkv, int ps,
                        float scale) {
  constexpr int PER = HD / 32;   // head-dim elements per lane
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int len = max(0, min(kv_lens[b], n_table * ps));

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

  const int* trow = tables + (size_t)b * table_stride;
  const size_t row_step = (size_t)Hkv * HD;        // rows inside a page
  const size_t page_step = (size_t)ps * row_step;
  const size_t head_off = (size_t)hk * HD + lane * PER;

  for (int r0 = w * U; r0 < len; r0 += WARPS * U) {
    float s[U][G], vv[U][PER];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u;
      valid[u] = r < len;   // warp-uniform
      if (valid[u]) {
        const int page = trow[r / ps];
        const size_t base =
            (size_t)page * page_step + (size_t)(r % ps) * row_step + head_off;
        float kf[PER];
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          kf[e] = to_f32(kp[base + e]);
          vv[u][e] = to_f32(vp[base + e]);
        }
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

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, int table_stride, int n_table,
                   const void* kv_lens, void* o, int B, int H, int Hkv,
                   int ps, float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T, HD, G><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      table_stride, n_table, static_cast<const int*>(kv_lens),
      static_cast<T*>(o), H, Hkv, ps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
int dispatch_group(int G, const void* q, const void* kp, const void* vp,
                   const void* tables, int table_stride, int n_table,
                   const void* kv_lens, void* o, int B, int H, int Hkv,
                   int ps, float scale, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch<T, HD, 1>(q, kp, vp, tables, table_stride, n_table,
                              kv_lens, o, B, H, Hkv, ps, scale, st);
    case 2:
      return launch<T, HD, 2>(q, kp, vp, tables, table_stride, n_table,
                              kv_lens, o, B, H, Hkv, ps, scale, st);
    case 4:
      return launch<T, HD, 4>(q, kp, vp, tables, table_stride, n_table,
                              kv_lens, o, B, H, Hkv, ps, scale, st);
    case 8:
      return launch<T, HD, 8>(q, kp, vp, tables, table_stride, n_table,
                              kv_lens, o, B, H, Hkv, ps, scale, st);
    default:
      return -1;
  }
}

}  // namespace

extern "C" int tpushare_paged_decode(const void* q, const void* kp,
                                     const void* vp, const void* tables,
                                     int table_stride, int n_table,
                                     const void* kv_lens, void* o, int B,
                                     int H, int Hkv, int hd, int ps,
                                     int is_bf16, float scale, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || H % Hkv != 0 || ps < 1 ||
      n_table < 1)
    return -1;
  const int G = H / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (hd == 64)
      return dispatch_group<__nv_bfloat16, 64>(G, q, kp, vp, tables,
                                               table_stride, n_table, kv_lens,
                                               o, B, H, Hkv, ps, scale, st);
    if (hd == 128)
      return dispatch_group<__nv_bfloat16, 128>(G, q, kp, vp, tables,
                                                table_stride, n_table,
                                                kv_lens, o, B, H, Hkv, ps,
                                                scale, st);
  } else {
    if (hd == 64)
      return dispatch_group<float, 64>(G, q, kp, vp, tables, table_stride,
                                       n_table, kv_lens, o, B, H, Hkv, ps,
                                       scale, st);
    if (hd == 128)
      return dispatch_group<float, 128>(G, q, kp, vp, tables, table_stride,
                                        n_table, kv_lens, o, B, H, Hkv, ps,
                                        scale, st);
  }
  return -1;
}

extern "C" const char* tpushare_cuda_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
