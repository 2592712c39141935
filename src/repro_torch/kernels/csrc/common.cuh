// Device functions shared by the hash-encode, MLP and fused-march kernels,
// so Phase I and Phase II run one implementation of the encode and of a
// dense layer and cannot drift apart.
//
// Numerics: every kernel is built with --fmad=false, so a*b+c rounds the
// product and the sum separately, exactly as the plain PyTorch versions
// (kernels/*.py) do op by op; sums run in the same order as theirs.
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
