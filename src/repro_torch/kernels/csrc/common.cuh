// Device functions shared by the hash-encode, MLP and fused-march kernels,
// so Phase I and Phase II run one implementation of the encode and of the
// register-tiled MLP chain and cannot drift apart: the encode, the tile
// chain with its shared-memory plan (TileLayout), the persistent tile loop
// of the one-pass MLP kernels and the density chain's epilogue.
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
constexpr int kMaxLayers = 8;    // layers per MLP chain
constexpr int kMaxLevels = 32;   // hash-grid levels

// Widths of one MLP chain: d[0] inputs, d[i+1] outputs of layer i.
struct Dims {
  int n;                          // number of layers
  int d[kMaxLayers + 1];
};

// A chain's widths from a host array of n_layers + 1 of them.
inline Dims dims_of(const int* dims, int n_layers) {
  Dims D{};
  D.n = n_layers;
  for (int i = 0; i <= n_layers; ++i) D.d[i] = dims[i];
  return D;
}

// Weights of a chain as stored flat: layer i is a row-major
// (d[i], d[i+1]) matrix right after layer i-1.
__host__ __device__ inline int chain_floats(const Dims& D) {
  int s = 0;
  for (int i = 0; i < D.n; ++i) s += D.d[i] * D.d[i + 1];
  return s;
}

// A point's cell at one level of resolution ``res``: its base vertex,
// clamped to the grid, and its fractions within the cell.
struct Cell {
  int bx, by, bz;
  float fx, fy, fz;
};

__device__ __forceinline__ Cell cell_of(float px, float py, float pz,
                                        int res) {
  const float fres = (float)res;
  const float sx = px * fres, sy = py * fres, sz = pz * fres;
  Cell q;
  q.bx = min(max((int)floorf(sx), 0), res - 1);
  q.by = min(max((int)floorf(sy), 0), res - 1);
  q.bz = min(max((int)floorf(sz), 0), res - 1);
  q.fx = sx - (float)q.bx;
  q.fy = sy - (float)q.by;
  q.fz = sz - (float)q.bz;
  return q;
}

// Corner c = (c>>2, c>>1 & 1, c & 1) of cell q: its table row (dense
// levels row-major with stride res+1; hashed levels Instant-NGP's
// XOR-of-primes hash in wrapping uint32, mod ``rows``: a mask where rows
// is a power of two, the same index in fewer instructions) and its
// trilinear weight wx * wy * wz.
__device__ __forceinline__ uint32_t corner_row(const Cell& q, int c, int res,
                                               int dense, uint32_t rows) {
  const uint32_t cx = (uint32_t)(q.bx + ((c >> 2) & 1)),
                 cy = (uint32_t)(q.by + ((c >> 1) & 1)),
                 cz = (uint32_t)(q.bz + (c & 1));
  if (dense) {
    const uint32_t s = (uint32_t)(res + 1);
    return cx + s * (cy + s * cz);
  }
  const uint32_t h = (cx * 1u) ^ (cy * 2654435761u) ^ (cz * 805459861u);
  return (rows & (rows - 1)) == 0 ? (h & (rows - 1)) : h % rows;
}

__device__ __forceinline__ float corner_weight(const Cell& q, int c) {
  const float wx = (c >> 2) & 1 ? q.fx : 1.f - q.fx;
  const float wy = (c >> 1) & 1 ? q.fy : 1.f - q.fy;
  const float wz = c & 1 ? q.fz : 1.f - q.fz;
  return wx * wy * wz;
}

// One level's trilinear encode of one point: out[f * stride], f < F.
// The eight corners' rows are gathered together (F = 2 as one float2 per
// corner), then each feature sums its corners in order c = 0 .. 7 from 0.
// Where F is a constant at the call site, the feature loop unrolls, so an
// ``out`` in registers stays there.
__device__ __forceinline__ void encode_point_level(
    float px, float py, float pz, int res, int dense, uint32_t rows,
    const float* __restrict__ table, int F, float* __restrict__ out,
    int stride = 1) {
  const Cell q = cell_of(px, py, pz, res);
  uint32_t idx[8];
  float w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    idx[c] = corner_row(q, c, res, dense, rows);
    w[c] = corner_weight(q, c);
  }
  if (F == 2 && ((uintptr_t)table & 7) == 0) {
    float2 v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = __ldg(reinterpret_cast<const float2*>(table) + idx[c]);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      a0 = a0 + v[c].x * w[c];
      a1 = a1 + v[c].y * w[c];
    }
    out[0] = a0;
    out[stride] = a1;
    return;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc = acc + __ldg(table + (size_t)idx[c] * F + f) * w[c];
    out[f * stride] = acc;
  }
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

// acc + x*w with the product and the sum rounded on their own (what
// a*b+c means under --fmad=false; nvcc never contracts it).
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

// ---- Shared-memory plans and the chain over a tile ---------------------

// Where a tile kernel's pieces sit in dynamic shared memory, in floats,
// worked out on the host from the widths, so the kernels index no Dims at
// run time: chain 0's weights (the color chain, the density chain, or the
// two-chain kernels' density chain) at 0, chain 1's (their color chain) at
// w1, each of the CTA's ``groups`` warp groups' k-major activations at act
// + g * act_g, and from raw + g * raw_g the group's other buffers: two
// input tiles of ``tile`` floats each (one filling while the other
// computes), then ``extra`` floats of the kernel's own.
struct TileLayout {
  int nw0, nw1;        // weights of chain 0 and chain 1 (0 for one chain)
  int w1, act, raw;    // offsets (each a multiple of 4 floats)
  int groups;          // warp groups of a CTA
  int act_g;           // floats of one group's activations
  int tile;            // floats of one input tile
  int extra;           // floats of the kernel's own, after the two tiles
  int raw_g;           // floats of one group's buffers from raw
  int P;               // act row of the color input (two chains)
  size_t bytes;
};

// Rows of k-major activations a chain needs: its widest layer input.
inline int act_rows(const Dims& D) {
  int m = 0;
  for (int i = 0; i < D.n; ++i) m = D.d[i] > m ? D.d[i] : m;
  return m;
}

inline void finish_layout(TileLayout& L, int rows, int in_floats, int extra,
                          int groups) {
  L.groups = groups;
  L.act_g = rows * kTileRows;
  L.raw = L.act + groups * L.act_g;
  L.tile = kTileRows * in_floats;
  L.extra = pad4(extra);
  L.raw_g = 2 * L.tile + L.extra;
  L.bytes = sizeof(float) * ((size_t)L.raw + groups * (size_t)L.raw_g);
}

// One chain: weights, act rows of its widest input, tiles of d[0] floats.
inline TileLayout chain_layout(const Dims& D, int extra) {
  TileLayout L{};
  L.nw0 = chain_floats(D);
  L.act = pad4(L.nw0);
  finish_layout(L, act_rows(D), D.d[0], extra, kTileGroups);
  return L;
}

// color_mlp: the chain alone.
inline TileLayout color_layout(const Dims& D) { return chain_layout(D, 0); }

// density_mlp: the chain and a staging tile of kTileRows output rows of
// d[n] + 1 floats (one of padding, so a column's stores spread over the
// banks), written out as contiguous float4s.
inline TileLayout density_layout(const Dims& D) {
  return chain_layout(D, kTileRows * (D.d[D.n] + 1));
}

// Two chains (fused field, fused march): the color input [geo, sh] sits in
// act rows [P, P + G + S), P the density chain's widest input, clear of
// every density layer's rows; input tiles of in_floats floats a row.
inline TileLayout two_chain_layout(const Dims& Dd, const Dims& Dc,
                                   int in_floats, int extra,
                                   int groups = kTileGroups) {
  TileLayout L{};
  L.nw0 = chain_floats(Dd);
  L.nw1 = chain_floats(Dc);
  L.w1 = pad4(L.nw0);
  L.act = L.w1 + pad4(L.nw1);
  L.P = act_rows(Dd);
  const int rc = act_rows(Dc);
  finish_layout(L, L.P + Dc.d[0] > rc ? L.P + Dc.d[0] : rc, in_floats, extra,
                groups);
  return L;
}

// fused_field: input tiles of enc rows, then sh rows.
inline TileLayout fused_layout(const Dims& Dd, const Dims& Dc, int S) {
  return two_chain_layout(Dd, Dc, Dd.d[0] + S, 0);
}

// A chain's widths into shared memory (thread 0, compile-time indices).
__device__ __forceinline__ void dims_to_shared(const Dims& D, int* s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= kMaxLayers; ++i) s[i] = D.d[i];
  }
}

// The hidden layers of a chain on one tile, then its last layer into epi.
// dims: the chain's widths in shared memory; x: its k-major input.
template <class Mac, class Epi>
__device__ __forceinline__ void tile_chain(const float* W, const int* dims,
                                           int n_layers, const float* x,
                                           float* act, Epi epi) {
  for (int l = 0; l < n_layers - 1; ++l) {
    tile_dense_relu<Mac>(W, dims[l], dims[l + 1], x, act);
    W += dims[l] * dims[l + 1];
    x = act;
  }
  tile_dense_last<Mac>(W, dims[n_layers - 1], dims[n_layers], x, epi);
}

// The density chain's last layer: column 0 is the sigma logit, handed on
// as sigma(row, trunc_exp(logit)); columns 1.. are geo, geo(row, g, y).
template <class Sigma, class Geo>
__device__ __forceinline__ auto density_epi(Sigma sigma, Geo geo) {
  return [=](int r, int c, float y) {
    if (c == 0)
      sigma(r, trunc_exp(y));
    else
      geo(r, c - 1, y);
  };
}

__device__ __forceinline__ int tile_rows(long long n, long long tile) {
  return (int)min((long long)kTileRows, n - tile * kTileRows);
}

// The persistent loop of the one-pass tile kernels.  The calling group
// walks over tiles blockIdx.x * kTileGroups + g, then gridDim.x *
// kTileGroups further on, of kTileRows of the n rows.  load(buf, tile)
// starts the cp.async copies of a tile's inputs into buf; body(cur, row0,
// nrows) computes the tile whose inputs sit in cur (the group synced)
// while the next tile's copies fill the other buffer.  body must sync the
// group once it has read cur.
template <class Load, class Body>
__device__ __forceinline__ void tile_loop(long long n, float* raw0,
                                          float* raw1, Load load, Body body) {
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  const long long stride = (long long)gridDim.x * kTileGroups;
  long long tile = (long long)blockIdx.x * kTileGroups +
                   threadIdx.x / kGroupThreads;
  if (tile < ntiles) load(raw0, tile);
  cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += stride) {
    const long long next = tile + stride;
    if (next < ntiles) load((it & 1) ? raw0 : raw1, next);
    cp_async_commit();
    cp_async_wait<1>();
    group_sync();
    body((it & 1) ? raw1 : raw0, tile * kTileRows, tile_rows(n, tile));
  }
  cp_async_wait<0>();
}

// Rows [row0, row0 + nrows) of out (n, W) from stage (row r at r * (W + 1))
// by the calling group: the rows are contiguous in out, so they go as
// float4s (row0 * W floats in, a multiple of 4) and a scalar tail.
__device__ __forceinline__ void store_tile(const float* stage, int W,
                                           float* out, long long row0,
                                           int nrows) {
  float* g = out + row0 * W;
  const int nf = nrows * W, n4 = nf >> 2;
  auto at = [&](int e) {
    const int r = e / W;
    return stage[e + r];
  };
  for (int i = group_tid(); i < n4; i += kGroupThreads)
    *reinterpret_cast<float4*>(g + 4 * i) =
        make_float4(at(4 * i), at(4 * i + 1), at(4 * i + 2), at(4 * i + 3));
  for (int e = 4 * n4 + group_tid(); e < nf; e += kGroupThreads) g[e] = at(e);
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
