// Multi-resolution hash-grid encode for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/hash_encode.py:94
// (hash_encode_call / _encode_kernel / encode_level).  Bound: bytes, of
// random gathers: eight F-float table rows per (point, level) from a
// table stack (16 x 2^19 x 2 fp32 = 64 MiB at the paper's config) larger
// than the 50 MB L2, while N * L * F floats of output stream through it.
// Each gather costs a 32-B sector from L2 and, per warp load, one L1
// wavefront for each 128-B line its lanes touch.
//
// The design walks the work level-group-major, as the TPU kernel's grid
// (n_levels, n_point_tiles) walks it level-major:
//  * A work item is one point at one level group: G = max(1, kGroupFloats
//    / F) consecutive levels (the last group ragged where G does not
//    divide L).  Item i is point i % n of group i / n, so the persistent
//    grid-stride loop sweeps every point of group 0, then of group 1, ...:
//    at most two groups' tables are live in L2 at once, not all L levels.
//  * Two lanes share a work item (kLanesPerPoint), one per x-neighbour of
//    the cell (encode_pair_level), so a warp is 16 consecutive points at
//    one level and each of its loads takes both x-corners of each point:
//    one 128-B line for both 15 times in 16.  Points come in ray order, so
//    at the coarse levels the lanes' corners share sectors too.
//  * A work item's G * F floats (32 B at F = 2: one sector) stay in
//    registers, half in each lane, and are stored whole, with an
//    evict-first hint, so the output streams past the tables.
// The arithmetic is asdr::encode_point_level's (the fused march's), op by
// op and in its order, so the values are the plain version's bit for bit.
//
// The design choices are constants, for kernels/tile_variants.py to vary:
// kGroupFloats and kLanesPerPoint (which the wrapper's GROUP_FLOATS and
// LANES_PER_POINT mirror), kStreamStores, kEvictLast (the table loads' L2
// policy) and kStagePoints (a warp's points staged through shared memory,
// or read directly).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroupFloats = 8;
constexpr int kLanesPerPoint = 2;
constexpr int kStreamStores = 1;
constexpr int kEvictLast = 0;
constexpr int kStagePoints = 0;

// G: the levels of one work item at feature width F.
__host__ __device__ constexpr int levels_per_group(int F) {
  return F >= kGroupFloats ? 1 : kGroupFloats / F;
}

__device__ __forceinline__ void store(float* p, float v) {
  if (kStreamStores) __stcs(p, v); else *p = v;
}

__device__ __forceinline__ void store(float4* p, float4 v) {
  if (kStreamStores) __stcs(p, v); else *p = v;
}

// out[A, B) = feat[A, B), cut at ``lim``: float4s where whole and aligned.
template <int A, int B, int W>
__device__ __forceinline__ void store_run(float* out, const float (&feat)[W],
                                          int lim) {
  if constexpr (B > A) {
    if ((B - A) % 4 == 0 && lim >= B && ((uintptr_t)(out + A) & 15) == 0) {
#pragma unroll
      for (int j = A; j < B; j += 4)
        store(reinterpret_cast<float4*>(out + j),
              make_float4(feat[j], feat[j + 1], feat[j + 2], feat[j + 3]));
    } else {
#pragma unroll
      for (int j = A; j < B; ++j)
        if (j < lim) store(out + j, feat[j]);
    }
  }
}

// An L2 cache policy that keeps the lines a load brings in past those of
// normal priority (the tables, while the output streams past).
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// A table row's floats through the read-only path (__ldg) or, where
// kEvictLast, with ``policy`` as its L2 cache hint.
template <bool kEvictLast>
__device__ __forceinline__ float load_row(const float* p, uint64_t policy) {
  if constexpr (kEvictLast) {
    float v;
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v) : "l"(p), "l"(policy));
    return v;
  } else {
    return __ldg(p);
  }
}

template <bool kEvictLast>
__device__ __forceinline__ float2 load_row(const float2* p, uint64_t policy) {
  if constexpr (kEvictLast) {
    float2 v;
    asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
        : "=f"(v.x), "=f"(v.y) : "l"(p), "l"(policy));
    return v;
  } else {
    return __ldg(p);
  }
}

// Point p's coordinates.  Staged: where the warp's lanes hold consecutive
// points (kLanesPerPoint lanes each), they copy them into ``buf`` as
// coalesced rows first.
__device__ __forceinline__ void load_point(const float* __restrict__ pts,
                                           long long n, long long p,
                                           float* buf, float& px, float& py,
                                           float& pz) {
  if (kStagePoints) {
    constexpr int P = 32 / kLanesPerPoint;
    const unsigned act = __activemask();
    const int q = (threadIdx.x % 32) / kLanesPerPoint;
    const long long p0 = __shfl_sync(act, p, __ffs(act) - 1);
    if (__all_sync(act, p == p0 + q)) {
      const long long end = 3 * min(n, p0 + P);
      for (int j = threadIdx.x % 32; j < 3 * P; j += 32)
        if (3 * p0 + j < end) buf[j] = __ldg(pts + 3 * p0 + j);
      __syncwarp(act);
      px = buf[3 * q];
      py = buf[3 * q + 1];
      pz = buf[3 * q + 2];
      __syncwarp(act);
      return;
    }
  }
  px = __ldg(pts + p * 3);
  py = __ldg(pts + p * 3 + 1);
  pz = __ldg(pts + p * 3 + 2);
}

// One level's encode of one point by a pair of lanes: the lane with
// ox = 0 gathers corners 0-3 (x = bx), the lane with ox = 1 corners 4-7
// (x = bx + 1), so one warp load takes both x-neighbours of 16 points,
// which lie in one 128-B line 15 times in 16.  The ox = 0 lane sums its
// four from 0 and hands the sums to the ox = 1 lane, which adds its four:
// encode_point_level's sums, c = 0 .. 7 in order, bit for bit.  Only the
// ox = 1 lane writes out[f], f < F.
template <int F>
__device__ __forceinline__ void encode_pair_level(
    float px, float py, float pz, int res, int dense, uint32_t rows,
    const float* __restrict__ table, int ox, unsigned pair,
    float* __restrict__ out) {
  const uint64_t policy = kEvictLast ? evict_last_policy() : 0;
  const asdr::Cell q = asdr::cell_of(px, py, pz, res);
  uint32_t idx[4];
  float w[4], v[4][F];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    idx[j] = asdr::corner_row(q, 4 * ox + j, res, dense, rows);
    w[j] = asdr::corner_weight(q, 4 * ox + j);
  }
  bool pairs = false;
  if constexpr (F == 2) {
    pairs = ((uintptr_t)table & 7) == 0;
    if (pairs)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 r = load_row<kEvictLast != 0>(
            reinterpret_cast<const float2*>(table) + idx[j], policy);
        v[j][0] = r.x;
        v[j][1] = r.y;
      }
  }
  if (!pairs)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int f = 0; f < F; ++f)
        v[j][f] = load_row<kEvictLast != 0>(
            table + (size_t)idx[j] * F + f, policy);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.f;
  if (ox == 0)
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f] = acc[f] + v[j][f] * w[j];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = __shfl_xor_sync(pair, acc[f], 1);
  if (ox == 1)
#pragma unroll
    for (int f = 0; f < F; ++f) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f] = acc[f] + v[j][f] * w[j];
      out[f] = acc[f];
    }
}

template <int F>
__global__ void __launch_bounds__(kThreads) hash_encode_kernel(
    const float* __restrict__ pts, long long n, const int* __restrict__ meta,
    const float* __restrict__ tables, int L, long long T,
    float* __restrict__ out) {
  constexpr int G = levels_per_group(F);
  constexpr int W = G * F;        // floats of one work item's output
  // with two lanes a point, lane 0 finishes (and stores) levels [0, H),
  // lane 1 levels [H, G) of the group
  constexpr int H = kLanesPerPoint == 2 ? (G + 1) / 2 : G;
  __shared__ float staged[kStagePoints ? kThreads * 3 : 1];
  float* buf = staged + (kStagePoints ? threadIdx.x / 32 * 96 : 0);
  const int lane = threadIdx.x % 32, h = lane % kLanesPerPoint;
  const unsigned pair = 3u << (lane & 30);
  const long long total = n * ((L + G - 1) / G);
  // work item i (point p of group g) runs on lanes kLanesPerPoint * i + h
  const long long step = (long long)gridDim.x * blockDim.x / kLanesPerPoint;
  const long long dg = step / n, dp = step - dg * n;
  long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kLanesPerPoint;
  long long g = i / n, p = i - g * n;
  for (; i < total; i += step) {
    const int l0 = (int)g * G, nl = min(G, L - l0);
    float px, py, pz;
    load_point(pts, n, p, buf, px, py, pz);
    float feat[W];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k < nl) {
        const int l = l0 + k, res = __ldg(meta + l * 3),
                  dense = __ldg(meta + l * 3 + 1);
        const uint32_t rows = (uint32_t)__ldg(meta + l * 3 + 2);
        const float* table = tables + (size_t)l * T * F;
        if (kLanesPerPoint == 1)
          asdr::encode_point_level(px, py, pz, res, dense, rows, table, F,
                                   feat + k * F);
        else
          encode_pair_level<F>(px, py, pz, res, dense, rows, table,
                               h == (k >= H ? 1 : 0), pair, feat + k * F);
      }
    }
    float* o = out + p * (long long)(L * F) + l0 * F;
    if (h == 0)
      store_run<0, H * F>(o, feat, nl * F);
    else
      store_run<H * F, W>(o, feat, nl * F);
    g += dg;
    p += dp;
    if (p >= n) {
      p -= n;
      ++g;
    }
  }
}

template <int F>
int launch(const float* pts, long long n, const int* meta,
           const float* tables, int L, long long T, float* out,
           cudaStream_t stream) {
  constexpr int G = levels_per_group(F);
  const long long lanes = n * ((L + G - 1) / G) * kLanesPerPoint;
  const int blocks = asdr::fill_grid(hash_encode_kernel<F>, kThreads, 0,
                                     lanes);
  hash_encode_kernel<F><<<blocks, kThreads, 0, stream>>>(pts, n, meta, tables,
                                                         L, T, out);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (n, 3), meta (L, 3) int32 [res, is_dense, rows], tables (L, T, F)
// -> out (n, L*F).  G is the wrapper's levels_per_group(F); the launch is
// refused (cudaErrorInvalidValue) unless it is this kernel's.  Returns
// cudaGetLastError() after the launch.
extern "C" int hash_encode_launch(const float* pts, long long n,
                                  const int* meta, const float* tables, int L,
                                  long long T, int F, int G, float* out,
                                  void* stream) {
  if (F < 1 || F > asdr::kMaxFeat || L < 1 || L > asdr::kMaxLevels ||
      G != levels_per_group(F))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch<1>(pts, n, meta, tables, L, T, out, s);
    case 2: return launch<2>(pts, n, meta, tables, L, T, out, s);
    case 3: return launch<3>(pts, n, meta, tables, L, T, out, s);
    case 4: return launch<4>(pts, n, meta, tables, L, T, out, s);
    case 5: return launch<5>(pts, n, meta, tables, L, T, out, s);
    case 6: return launch<6>(pts, n, meta, tables, L, T, out, s);
    case 7: return launch<7>(pts, n, meta, tables, L, T, out, s);
    default: return launch<8>(pts, n, meta, tables, L, T, out, s);
  }
}
