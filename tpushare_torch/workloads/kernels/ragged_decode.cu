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
// (L, B, S, Hkv, hd) cache by its base pointer, so no slice is copied;
// a row of the cache may hold more KV heads than the launch reads
// (row_heads >= Hkv): a tp shard of a whole slot cache is read in place
// from its first head's pointer.
//
// Bound on this card: bytes. A decode read does ~4 FLOPs per K/V element
// it loads, far below Hopper's ~295 FLOP/byte balance point, so the floor
// is the live K/V bytes over HBM bandwidth (int8: hd + 4 bytes per row
// and head, against 2 hd for bf16). Reaching it takes many bytes in
// flight on every SM, whatever the slots' lengths.
//
// Design: a split-row read with a fixed-order combine (flash-decoding).
// The Pallas kernel walks a slot's rows as a sequential grid axis; here
// the rows are cut into chunks of CHUNK rows and every chunk is a CTA.
//
// - Pass 1, partials: grid (ceil(S / CHUNK), Hkv, B). CTA (c, hk, b)
//   reads rows [c CHUNK, min((c + 1) CHUNK, len)) of slot b for kv head
//   hk and its G query heads, so each live K/V row is read from HBM once
//   for the whole group, and writes the chunk's fp32 softmax state
//   (m, l, acc[G][128]) to a workspace. A CTA whose chunk starts at or
//   past the live length exits before any load; the grid is sized from S
//   on the host, so lengths never cross to the host.
//   Four warps; a lane reads 16 bytes of a row (8 bytes for the int8
//   rung at G >= 4, where 16 would take 64 accumulator registers and
//   218-242 a thread at G = 4), so a warp load covers 1 (fp32), 2 (bf16)
//   or 4 (int8, G < 4) rows. Each lane keeps two steps of U such loads
//   of K and of V in flight: the next step's are issued before this
//   step's are used, which took `long` 9% and `gqa` 16% below loads
//   issued and used in one step (PERF.md). Rows past the chunk's live
//   count re-read its last live row and are masked. Dots reduce
//   with xor shuffles inside a row's lanes; each row group keeps its own
//   running max / sum / accumulator; the groups of a warp merge through
//   xor shuffles, the warps through shared memory, each in a fixed
//   order.
// - Pass 2, combine: grid (H, B), one CTA per (query head, slot), a
//   thread per head-dim column. It reads chunks 0 .. ceil(len / CHUNK) - 1
//   IN INDEX ORDER, rescales each by exp(m_c - m) and writes o, rounded
//   once to q's dtype. When one chunk covers S, pass 1 writes o itself:
//   the combine of one chunk is acc / l bit for bit (its weight is
//   exp(0) = 1), so the two routes give the same bits.
//
// Chunk boundaries are multiples of CHUNK and depend on nothing else —
// not on S, not on any other slot's length — and no sum uses atomics.
// So two launches give the same bits, a slot's result does not depend on
// its neighbours, and two caches of different capacity holding the same
// live rows give bitwise-equal outputs.
//
// int8 rung: the same kernels with int8 K/V (the KV template argument),
// in the reference's order: s = dot(q, k_q) * hd^-0.5 * k_s, an fp32
// online softmax whose running sum takes the unscaled probability p, and
// an accumulator that adds (p * v_s) * v_q. A row's two scales are one
// fp32 load each (one address per row group).

#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int HD = 128;       // the reference's head-dim gate
constexpr int CHUNK = 512;    // rows a pass-1 CTA reads (PERF.md: the sweep)
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int U = 4;          // loads of K (and of V) a lane issues a step

// a row's layout over a warp: E elements a lane, LPR lanes a row, RPW
// rows a warp load; 16 bytes a lane unless the G accumulators would pass
// 32 registers on the int8 rung (64 on the others)
template <typename KV, int G>
struct Layout {
  static constexpr int E16 = 16 / static_cast<int>(sizeof(KV));
  static constexpr int E =
      G * E16 <= (sizeof(KV) == 1 ? 32 : 64) ? E16 : E16 / 2;
  static constexpr int LPR = HD / E;
  static constexpr int RPW = 32 / LPR;
  static constexpr int BYTES = E * static_cast<int>(sizeof(KV));
};

template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };

__device__ __forceinline__ void words(const uint4& r, uint32_t w[4]) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ void words(const uint2& r, uint32_t w[2]) {
  w[0] = r.x;
  w[1] = r.y;
}

// element i of a vector held as 32-bit words, as fp32 (exact)
template <typename X> __device__ __forceinline__ float elem(const uint32_t* w,
                                                            int i);
template <> __device__ __forceinline__ float elem<float>(const uint32_t* w,
                                                         int i) {
  return __uint_as_float(w[i]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint32_t* w, int i) {
  const uint32_t x = w[i >> 1];
  return __uint_as_float(i & 1 ? x & 0xffff0000u : x << 16);
}
template <> __device__ __forceinline__ float elem<int8_t>(const uint32_t* w,
                                                          int i) {
  return static_cast<float>(
      static_cast<int32_t>(w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
}

// E consecutive elements of T at p (16-byte aligned) as fp32
template <typename T, int E>
__device__ __forceinline__ void load_f32(const T* p, float out[E]) {
  constexpr int PER = 16 / static_cast<int>(sizeof(T));
  static_assert(E % PER == 0, "q slices are whole 16-byte vectors");
#pragma unroll
  for (int j = 0; j < E / PER; ++j) {
    uint32_t w[4];
    words(*reinterpret_cast<const uint4*>(p + j * PER), w);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[j * PER + i] = elem<T>(w, i);
  }
}

// the launch's arguments: k / v one layer's (B, S, Hkv, HD) base, rows
// row_heads heads apart; ks / vs the int8 rung's (B, S, Hkv) scale planes
// on the same row pitch, null for a bf16/fp32 cache;
// ws the partials, acc (B, Hkv, n_chunks, G, HD) then (m, l)
// (B, Hkv, n_chunks, G, 2), null when n_chunks is 1
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* lengths;
  void* o;
  float* ws;
  int B, S, H, Hkv, row_heads, n_chunks;
  float scale;
};

// rows [0, lengths[b]] inclusive, clipped to the cache
__device__ __forceinline__ int live_rows(const Args& a, int b) {
  return min(max(a.lengths[b], -1) + 1, a.S);
}

template <typename T, typename KV, int G>
__global__ void __launch_bounds__(THREADS) ragged_partial_kernel(Args a) {
  using L = Layout<KV, G>;
  constexpr int E = L::E, LPR = L::LPR, RPW = L::RPW;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  using Raw = typename RawOf<L::BYTES>::type;
  constexpr int NW = L::BYTES / 4;
  __shared__ float sm_m[WARPS][G];
  __shared__ float sm_l[WARPS][G];
  __shared__ float sm_acc[WARPS][G][HD];

  const int c = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int H = a.H, Hkv = a.Hkv;
  T* __restrict__ o = static_cast<T*>(a.o);
  const int len = live_rows(a, b);
  const int r0 = c * CHUNK;
  if (r0 >= len) {
    // a slot with no live row reads zeros; with one chunk no combine
    // runs, so this CTA writes them
    if (a.n_chunks == 1)
      for (int i = threadIdx.x; i < G * HD; i += THREADS)
        o[((size_t)b * H + hk * G) * HD + i] = from_f32<T>(0.f);
    return;
  }
  const int n = min(CHUNK, len - r0);   // the chunk's live rows
  const T* __restrict__ q = static_cast<const T*>(a.q);
  const KV* __restrict__ k = static_cast<const KV*>(a.k);
  const KV* __restrict__ v = static_cast<const KV*>(a.v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rg = lane / LPR, sl = lane % LPR;

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_f32<T, E>(q + ((size_t)b * H + hk * G + g) * HD + sl * E, qf[g]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // a CTA step covers WARPS x U x RPW rows; warp w takes U x RPW of them
  constexpr int STEP = WARPS * U * RPW;
  Raw kr[U], vr[U], kn[U], vn[U];
  float ksc[U], vsc[U], ksn[U], vsn[U];
  // the rows of the step at base (past the live count: its last row)
  auto fetch = [&](int base, Raw (&kx)[U], Raw (&vx)[U], float (&ksx)[U],
                   float (&vsx)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = min(base + u * RPW + rg, n - 1);
      // (slot, row, kv head): the scale's index; x HD the row's
      const size_t srow = ((size_t)b * a.S + r0 + i) * a.row_heads + hk;
      const size_t off = srow * HD + sl * E;
      kx[u] = *reinterpret_cast<const Raw*>(k + off);
      vx[u] = *reinterpret_cast<const Raw*>(v + off);
      ksx[u] = vsx[u] = 1.f;
      if constexpr (INT8) {
        ksx[u] = a.ks[srow];
        vsx[u] = a.vs[srow];
      }
    }
  };
  fetch(w * U * RPW, kr, vr, ksc, vsc);
  for (int base = w * U * RPW; base < n; base += STEP) {
    // the next step's loads are in flight while this step computes
    fetch(base + STEP, kn, vn, ksn, vsn);
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) valid[u] = base + u * RPW + rg < n;
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      uint32_t kw[NW];
      words(kr[u], kw);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e)
          part = fmaf(qf[g][e], elem<KV>(kw, e), part);
        s[u][g] = part;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
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
      // a row group with no live row yet keeps l = acc = 0
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) {
          uint32_t vw[NW];
          words(vr[u], vw);
          const float p = expf(s[u][g] - mx);
          l[g] += p;
          const float pv = INT8 ? p * vsc[u] : p;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = fmaf(pv, elem<KV>(vw, e), acc[g][e]);
        }
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
      ksc[u] = ksn[u];
      vsc[u] = vsn[u];
    }
  }

  // the warp's row groups merge pairwise, lane rg = 0 ending with
  // ((0, 1), (2, 3)): a fixed order
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = m[g] == -INFINITY ? 0.f : expf(m[g] - mx);
      const float cb = mo == -INFINITY ? 0.f : expf(mo - mx);
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mx;
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (sl == 0) {
        sm_m[w][g] = m[g];
        sm_l[w][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[w][g][sl * E + e] = acc[g][e];
    }
  }
  __syncthreads();

  const size_t first = ((size_t)(b * Hkv + hk) * a.n_chunks + c) * G;
  const size_t n_states = (size_t)a.B * H * a.n_chunks;
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) mx = fmaxf(mx, sm_m[ww][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int ww = 0; ww < WARPS; ++ww) {
      const float mw = sm_m[ww][g];
      const float cw = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum = fmaf(sm_l[ww][g], cw, lsum);
      osum = fmaf(sm_acc[ww][g][d], cw, osum);
    }
    if (a.n_chunks == 1) {
      o[((size_t)b * H + hk * G + g) * HD + d] =
          from_f32<T>(lsum > 0.f ? osum / lsum : 0.f);
    } else {
      a.ws[(first + g) * HD + d] = osum;
      if (d == 0) {
        a.ws[n_states * HD + (first + g) * 2] = mx;
        a.ws[n_states * HD + (first + g) * 2 + 1] = lsum;
      }
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(HD) ragged_combine_kernel(Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int hk = h / G, g = h - hk * G;
  const int nc = (live_rows(a, b) + CHUNK - 1) / CHUNK;
  const size_t first = ((size_t)(b * a.Hkv + hk) * a.n_chunks) * G + g;
  const float* __restrict__ acc = a.ws + first * HD + d;
  const float* __restrict__ ml =
      a.ws + (size_t)a.B * a.H * a.n_chunks * HD + first * 2;
  // chunk c's state sits G states after chunk c - 1's
  float mx = -INFINITY;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, ml[(size_t)c * G * 2]);
  float lsum = 0.f, osum = 0.f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const float wc = expf(ml[(size_t)c * G * 2] - mx);
    lsum = fmaf(ml[(size_t)c * G * 2 + 1], wc, lsum);
    osum = fmaf(acc[(size_t)c * G * HD], wc, osum);
  }
  static_cast<T*>(a.o)[((size_t)b * a.H + h) * HD + d] =
      from_f32<T>(lsum > 0.f ? osum / lsum : 0.f);
}

template <typename T, typename KV, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.n_chunks, a.Hkv, a.B);
  ragged_partial_kernel<T, KV, G><<<grid, THREADS, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return err;
  ragged_combine_kernel<T, G><<<dim3(a.H, a.B), HD, 0, stream>>>(a);
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
// layer, or null with is_int8 0 (then k / v hold q's dtype); row_heads:
// the KV heads a cache row holds (Hkv for a whole cache, more for a
// head shard read in place); ws: fp32
// partials of B * H * n_chunks * (hd + 2) floats, n_chunks = ceil(S /
// CHUNK), null when n_chunks is 1
extern "C" int tpushare_ragged_decode(const void* q, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, const void* lengths,
                                      void* o, void* ws, int n_chunks, int B,
                                      int S, int H, int Hkv,
                                      int row_heads, int hd,
                                      int is_bf16, int is_int8, float scale,
                                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || Hkv < 1 || Hkv > 65535 ||
      row_heads < Hkv ||
      H % Hkv != 0 || hd != HD || n_chunks != (S + CHUNK - 1) / CHUNK ||
      (n_chunks > 1 && ws == nullptr) ||
      (is_int8 && (ks == nullptr || vs == nullptr)))
    return -1;
  const Args a{q, k, v, static_cast<const float*>(ks),
               static_cast<const float*>(vs),
               static_cast<const int*>(lengths), o,
               static_cast<float*>(ws), B, S, H, Hkv, row_heads, n_chunks,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_kv<__nv_bfloat16>(is_int8, H / Hkv, a, st);
  return dispatch_kv<float>(is_int8, H / Hkv, a, st);
}
