// Device functions shared by the hash-encode, MLP and fused-march kernels,
// so Phase I and Phase II run one implementation of the encode and of a
// dense layer and cannot drift apart.
//
// Numerics: every kernel is built with --fmad=false, so a*b+c rounds the
// product and the sum separately, exactly as the plain PyTorch versions
// (kernels/*.py) do op by op; sums run in the same order as theirs.  The
// tile chains below name their rounding explicitly (MulAdd or Fma), so it
// holds whatever --fmad says.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace asdr {

constexpr int kMaxFeat = 8;      // feature_dim F per level
constexpr int kMaxWidth = 128;   // widest MLP layer (input or output)
constexpr int kMaxLayers = 8;    // layers per MLP chain
constexpr int kMaxLevels = 32;   // hash-grid levels

// Widths of one MLP chain: d[0] inputs, d[i+1] outputs of layer i.
struct Dims {
  int n;                          // number of layers
  int d[kMaxLayers + 1];
};

// Weights of a chain as stored flat: layer i is a row-major
// (d[i], d[i+1]) matrix right after layer i-1.
__host__ __device__ inline int chain_floats(const Dims& D) {
  int s = 0;
  for (int i = 0; i < D.n; ++i) s += D.d[i] * D.d[i + 1];
  return s;
}

// One level's trilinear encode of one point: out[f], f < F.
// Dense levels address row-major with stride res+1; hashed levels use
// Instant-NGP's XOR-of-primes hash in wrapping uint32, mod ``rows``.
__device__ __forceinline__ void encode_point_level(
    float px, float py, float pz, int res, int dense, uint32_t rows,
    const float* __restrict__ table, int F, float* out) {
  const float fres = (float)res;
  const float sx = px * fres, sy = py * fres, sz = pz * fres;
  const int bx = min(max((int)floorf(sx), 0), res - 1);
  const int by = min(max((int)floorf(sy), 0), res - 1);
  const int bz = min(max((int)floorf(sz), 0), res - 1);
  const float fx = sx - (float)bx, fy = sy - (float)by, fz = sz - (float)bz;
  for (int f = 0; f < F; ++f) out[f] = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = (c >> 2) & 1, oy = (c >> 1) & 1, oz = c & 1;
    const uint32_t cx = (uint32_t)(bx + ox), cy = (uint32_t)(by + oy),
                   cz = (uint32_t)(bz + oz);
    uint32_t idx;
    if (dense) {
      const uint32_t s = (uint32_t)(res + 1);
      idx = cx + s * (cy + s * cz);
    } else {
      const uint32_t h = (cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u);
      idx = h % rows;
    }
    const float wx = ox ? fx : 1.f - fx;
    const float wy = oy ? fy : 1.f - fy;
    const float wz = oz ? fz : 1.f - fz;
    const float w = wx * wy * wz;
    const float* row = table + (size_t)idx * F;
    for (int f = 0; f < F; ++f) out[f] = out[f] + __ldg(row + f) * w;
  }
}

// y = x @ W for one sample, W a row-major (n_in, n_out) matrix (in shared
// memory); the sum over k runs in order from k = 0.
__device__ __forceinline__ void dense_layer(const float* __restrict__ W,
                                            int n_in, int n_out,
                                            const float* x, float* y,
                                            bool relu) {
  for (int j = 0; j < n_out; ++j) {
    float acc = 0.f;
    for (int k = 0; k < n_in; ++k) acc = acc + x[k] * W[k * n_out + j];
    y[j] = relu ? fmaxf(acc, 0.f) : acc;
  }
}

// The whole chain, ReLU between layers and none after the last.  Input in
// a; returns the buffer (a or b) that holds the output.
__device__ __forceinline__ float* mlp_chain(const float* __restrict__ W,
                                            const Dims& D, float* a,
                                            float* b) {
  float* x = a;
  float* y = b;
  for (int i = 0; i < D.n; ++i) {
    dense_layer(W, D.d[i], D.d[i + 1], x, y, i < D.n - 1);
    W += D.d[i] * D.d[i + 1];
    float* t = x; x = y; y = t;
  }
  return x;
}

__device__ __forceinline__ float trunc_exp(float x) {
  return expf(fminf(fmaxf(x, -15.f), 15.f));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- Register-tiled MLP chains over tiles of kTileRows samples ----------
//
// A CTA runs kTileGroups warp groups of kGroupThreads threads; each group
// carries its own tile of kTileRows samples through the chain and
// synchronises on its own named barrier, so one group's latency-bound
// steps (a chain's last layer, the input transposition) overlap the other
// group's multiply-adds.  A tile's activations sit in shared memory
// k-major, act[k * kTileRows + row], so a thread reads four rows of one k
// as a float4.  Thread t of a group owns a register tile of outputs: kTR
// rows from kTR*rg (rg = t % kRowGroups) by TC columns from TC*cg (cg = t /
// kRowGroups).  Per k it loads kTR/4 float4s of activations and TC weights
// (row-major W[k][TC*cg..], as float4s where TC is 4 or 8) and does
// kTR*TC multiply-adds from registers.  Every output's sum starts at 0 and
// runs k = 0, 1, ..., K-1 in order, as in the plain versions.

constexpr int kTileRows = 32;
constexpr int kGroupThreads = 128;
constexpr int kTileGroups = 2;
constexpr int kTR = 4;           // rows of a thread's register tile
constexpr int kTileThreads = kTileGroups * kGroupThreads;
constexpr int kRowGroups = kTileRows / kTR;
constexpr int kColGroups = kGroupThreads / kRowGroups;

// The calling thread's index in its warp group, and the group's barrier
// (named barriers 1, 2, ...; __syncthreads is barrier 0).
__device__ __forceinline__ int group_tid() {
  return threadIdx.x % kGroupThreads;
}
__device__ __forceinline__ void group_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + threadIdx.x / kGroupThreads),
               "n"(kGroupThreads)
               : "memory");
}

// acc + x*w with the product and the sum rounded on their own (the
// arithmetic of dense_layer under --fmad=false; nvcc never contracts it).
struct MulAdd {
  static __device__ __forceinline__ float step(float acc, float x, float w) {
    return __fadd_rn(acc, __fmul_rn(x, w));
  }
};

// fmaf(x, w, acc): one rounding per multiply-add.
struct Fma {
  static __device__ __forceinline__ float step(float acc, float x, float w) {
    return __fmaf_rn(x, w, acc);
  }
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// TC weights of one row from wk (16-B aligned where TC > 1).
template <int TC>
__device__ __forceinline__ void load_w(const float* wk, float (&w)[TC]) {
  if constexpr (TC == 1) {
    w[0] = wk[0];
  } else {
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(wk + 4 * q);
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
    }
  }
}

__device__ __forceinline__ void load_x(const float* xk, float (&a)[kTR]) {
#pragma unroll
  for (int q = 0; q < kTR / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(xk + 4 * q);
    a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
  }
}

// acc[i][j] = sum over k of x[k][r0 + i] * W[k][c0 + j], in k order.
template <class Mac, int TC>
__device__ __forceinline__ void tile_mac(const float* W, int K, int N,
                                         const float* x, int r0, int c0,
                                         float (&acc)[kTR][TC]) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float a[kTR], w[TC];
    load_x(x + k * kTileRows + r0, a);
    load_w<TC>(W + k * N + c0, w);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = Mac::step(acc[i][j], a[i], w[j]);
  }
}

template <class Mac, int TC>
__device__ __forceinline__ void tile_relu_tc(const float* W, int K, int N,
                                             const float* x, float* act) {
  const int t = group_tid();
  const int r0 = kTR * (t % kRowGroups), c0 = TC * (t / kRowGroups);
  float acc[kTR][TC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  if (c0 < N) tile_mac<Mac, TC>(W, K, N, x, r0, c0, acc);
  group_sync();
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    if (c0 + j < N) {
#pragma unroll
      for (int q = 0; q < kTR / 4; ++q)
        *reinterpret_cast<float4*>(act + (c0 + j) * kTileRows + r0 + 4 * q) =
            make_float4(fmaxf(acc[4 * q][j], 0.f), fmaxf(acc[4 * q + 1][j], 0.f),
                        fmaxf(acc[4 * q + 2][j], 0.f),
                        fmaxf(acc[4 * q + 3][j], 0.f));
    }
  }
  group_sync();
}

// act rows [0, N) = relu(x @ W) for the group's tile; x = K rows of
// k-major activations (it may be act itself), W row-major (K, N) in shared
// memory, 16-B aligned.  Layers of up to 4 * kColGroups columns take 4
// columns a thread (N % 4 == 0), so every warp works; wider ones 8 (N % 8
// == 0, N <= 8 * kColGroups).  Syncs the group before it overwrites act
// and after.
template <class Mac>
__device__ __forceinline__ void tile_dense_relu(const float* W, int K, int N,
                                                const float* x, float* act) {
  if (N <= 4 * kColGroups)
    tile_relu_tc<Mac, 4>(W, K, N, x, act);
  else
    tile_relu_tc<Mac, 8>(W, K, N, x, act);
}

// The chain's last layer, no ReLU, each result handed to epi(row, col, y).
// At least kColGroups columns: a column and kTR rows a thread.  Fewer (the
// color chain's 3): one thread per row and column.
template <class Mac, class Epi>
__device__ __forceinline__ void tile_dense_last(const float* W, int K, int N,
                                                const float* x, Epi epi) {
  const int t = group_tid();
  if (N >= kColGroups) {
    const int r0 = kTR * (t % kRowGroups);
    for (int c = t / kRowGroups; c < N; c += kColGroups) {
      float acc[kTR][1];
#pragma unroll
      for (int i = 0; i < kTR; ++i) acc[i][0] = 0.f;
      tile_mac<Mac, 1>(W, K, N, x, r0, c, acc);
#pragma unroll
      for (int i = 0; i < kTR; ++i) epi(r0 + i, c, acc[i][0]);
    }
    return;
  }
  for (int o = t; o < kTileRows * N; o += kGroupThreads) {
    const int r = o / N, c = o - r * N;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k)
      acc = Mac::step(acc, x[k * kTileRows + r], W[k * N + c]);
    epi(r, c, acc);
  }
}

// raw (nrows, din) row-major -> act[k * kTileRows + r], rows past nrows 0,
// by the calling group.  A thread keeps one row r and walks k along a
// diagonal, k = (kk + r) % din, so a warp's reads of raw spread over the
// banks even where din is a multiple of 32.
__device__ __forceinline__ void tile_to_k_major(const float* raw, int din,
                                                int nrows, float* act) {
  constexpr int step = kGroupThreads / kTileRows;
  const int t = group_tid(), r = t % kTileRows;
  int k = (t / kTileRows + r) % din;
  for (int kk = t / kTileRows; kk < din; kk += step) {
    act[k * kTileRows + r] = r < nrows ? raw[r * din + k] : 0.f;
    for (k += step; k >= din;) k -= din;
  }
}

// Asynchronous copies global -> shared (cp.async, sm_80+).
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The calling group starts copying rows [row0, row0 + nrows) of x (n,
// din) into s: 16-B copies, then 4-B ones for a tail that is not a
// multiple of 4 floats.  x must be 16-B aligned (row0 is a multiple of
// kTileRows, a multiple of 4, so the tile's start is too).
__device__ __forceinline__ void tile_load_async(float* s, const float* x,
                                                long long row0, int nrows,
                                                int din) {
  const float* g = x + row0 * din;
  const int nf = nrows * din, n16 = nf >> 2;
  for (int i = group_tid(); i < n16; i += kGroupThreads)
    cp_async16(s + 4 * i, g + 4 * i);
  for (int i = 4 * n16 + group_tid(); i < nf; i += kGroupThreads)
    cp_async4(s + i, g + i);
}

// Blocks of ``threads`` to fill the card once with a grid-stride loop.
template <typename K>
inline int fill_grid(K kernel, int threads, size_t smem, long long work) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long long want = (work + threads - 1) / threads;
  long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (want > cap) want = cap;
  return (int)(want > 0 ? want : 1);
}

}  // namespace asdr
