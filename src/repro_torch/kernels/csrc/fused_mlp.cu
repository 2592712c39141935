// Density and color MLPs for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py density_call
// (_density_kernel), color_call (_color_kernel) and fused_field_call
// (_fused_kernel, both chains in one pass).  Weights keep their true
// widths (no 128-lane padding, no sigma-column permutation) and sit in
// shared memory, copied once per CTA.  Bound: operations (74,240 FLOP per
// color sample against 12 B of output).  No tensor cores.
//
// density_mlp_kernel carries one sample per thread through asdr::mlp_chain
// (the fused march's dense layer), product and sum rounded on their own.
//
// color_mlp_kernel and fused_field_kernel are register-tiled chains: one
// persistent CTA per SM holds the weights and runs two warp groups of 128
// threads, each walking over its own tiles of kTileRows = 32 samples (64
// in flight per CTA) on its own named barrier.  A tile's input rows arrive
// by cp.async into one of the group's two buffers while its previous tile
// computes, then go k-major into the group's activations; each hidden
// layer is asdr::tile_dense_relu (a 4-row x 8-column register tile per
// thread, 4 x 4 for layers of up to 64), the last one
// asdr::tile_dense_last (4 rows x 1 column a thread, or one thread per row
// and column for the color chain's 3).  The color chain rounds once per
// multiply-add (asdr::Fma); the fused field's density chain keeps the
// density kernel's rounding (asdr::MulAdd), so its sigma and geo stay
// bit-equal to density_mlp_kernel.
#include "common.cuh"

namespace {

using asdr::kTileGroups;
using asdr::kTileRows;
using asdr::kTileThreads;

// enc (n, d[0]) -> out (n, d[n_layers]) = [trunc_exp(sigma logit), geo...]
__global__ void __launch_bounds__(256) density_mlp_kernel(
    const float* __restrict__ enc, long long n, const float* __restrict__ w,
    asdr::Dims D, float* __restrict__ out) {
  extern __shared__ float sw[];
  const int nw = asdr::chain_floats(D);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  __syncthreads();
  const int din = D.d[0], dout = D.d[D.n];
  float a[asdr::kMaxWidth], b[asdr::kMaxWidth];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    for (int k = 0; k < din; ++k) a[k] = enc[r * din + k];
    const float* y = asdr::mlp_chain(sw, D, a, b);
    float* o = out + r * dout;
    o[0] = asdr::trunc_exp(y[0]);
    for (int j = 1; j < dout; ++j) o[j] = y[j];
  }
}

// Where a tile kernel's pieces sit in dynamic shared memory, in floats,
// worked out on the host from the widths, so the kernels index no Dims at
// run time: chain 0's weights (the color chain, or the fused field's
// density chain) at 0, chain 1's (the fused field's color chain) at w1,
// each warp group's k-major activations at act + g * act_g, and its two
// input tiles at raw + 2g * tile and raw + (2g + 1) * tile.
struct TileLayout {
  int nw0, nw1;        // weights of chain 0 and chain 1 (0 for color_mlp)
  int w1, act, raw;    // offsets (each a multiple of 4 floats)
  int act_g;           // floats of one group's activations
  int tile;            // floats of one input tile
  int P;               // act row of the color input (fused field)
  size_t bytes;
};

// Rows of k-major activations a chain needs: its widest layer input.
int act_rows(const asdr::Dims& D) {
  int m = 0;
  for (int i = 0; i < D.n; ++i) m = D.d[i] > m ? D.d[i] : m;
  return m;
}

void finish_layout(TileLayout& L, int rows, int in_floats) {
  L.act_g = rows * kTileRows;
  L.raw = L.act + kTileGroups * L.act_g;
  L.tile = kTileRows * in_floats;
  L.bytes = sizeof(float) * ((size_t)L.raw + 2 * kTileGroups * (size_t)L.tile);
}

// color_mlp: weights, act rows of the widest input, tiles of d[0] floats.
TileLayout color_layout(const asdr::Dims& D) {
  TileLayout L{};
  L.nw0 = asdr::chain_floats(D);
  L.act = asdr::pad4(L.nw0);
  finish_layout(L, act_rows(D), D.d[0]);
  return L;
}

// fused_field: the color input [geo, sh] sits in act rows [P, P + G + S),
// P the density chain's widest input, clear of every density layer's rows;
// an input tile holds enc rows, then sh rows.
TileLayout fused_layout(const asdr::Dims& Dd, const asdr::Dims& Dc, int S) {
  TileLayout L{};
  L.nw0 = asdr::chain_floats(Dd);
  L.nw1 = asdr::chain_floats(Dc);
  L.w1 = asdr::pad4(L.nw0);
  L.act = L.w1 + asdr::pad4(L.nw1);
  L.P = act_rows(Dd);
  const int rc = act_rows(Dc);
  finish_layout(L, L.P + Dc.d[0] > rc ? L.P + Dc.d[0] : rc, Dd.d[0] + S);
  return L;
}

// A chain's widths into shared memory (thread 0, compile-time indices).
__device__ __forceinline__ void dims_to_shared(const asdr::Dims& D, int* s) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i <= asdr::kMaxLayers; ++i) s[i] = D.d[i];
  }
}

// The hidden layers of a chain on one tile, then its last layer into epi.
// dims: the chain's widths in shared memory; x: its k-major input.
template <class Mac, class Epi>
__device__ __forceinline__ void tile_chain(const float* W, const int* dims,
                                           int n_layers, const float* x,
                                           float* act, Epi epi) {
  for (int l = 0; l < n_layers - 1; ++l) {
    asdr::tile_dense_relu<Mac>(W, dims[l], dims[l + 1], x, act);
    W += dims[l] * dims[l + 1];
    x = act;
  }
  asdr::tile_dense_last<Mac>(W, dims[n_layers - 1], dims[n_layers], x, epi);
}

__device__ __forceinline__ int tile_rows(long long n, long long tile) {
  return (int)min((long long)kTileRows, n - tile * kTileRows);
}

// cin (n, d[0]) = [geo, SH(dir)] -> out (n, d[n_layers]) = sigmoid(chain).
__global__ void __launch_bounds__(kTileThreads, 1) color_mlp_kernel(
    const float* __restrict__ cin, long long n, const float* __restrict__ w,
    asdr::Dims D, TileLayout L, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims[asdr::kMaxLayers + 1];
  const int g = threadIdx.x / asdr::kGroupThreads, din = D.d[0];
  float* act = smem + L.act + g * L.act_g;
  float* raw0 = smem + L.raw + 2 * g * L.tile;
  float* raw1 = raw0 + L.tile;
  dims_to_shared(D, dims);
  for (int i = threadIdx.x; i < L.nw0; i += blockDim.x) smem[i] = w[i];
  __syncthreads();

  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  const long long stride = (long long)gridDim.x * kTileGroups;
  long long tile = (long long)blockIdx.x * kTileGroups + g;
  const int dout = dims[D.n];
  if (tile < ntiles)
    asdr::tile_load_async(raw0, cin, tile * kTileRows, tile_rows(n, tile), din);
  asdr::cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += stride) {
    const long long next = tile + stride;
    if (next < ntiles)
      asdr::tile_load_async((it & 1) ? raw0 : raw1, cin, next * kTileRows,
                            tile_rows(n, next), din);
    asdr::cp_async_commit();
    asdr::cp_async_wait<1>();
    asdr::group_sync();
    const long long row0 = tile * kTileRows;
    const int nrows = tile_rows(n, tile);
    asdr::tile_to_k_major((it & 1) ? raw1 : raw0, din, nrows, act);
    asdr::group_sync();
    tile_chain<asdr::Fma>(smem, dims, D.n, act, act, [&](int r, int c, float y) {
      if (r < nrows) out[(row0 + r) * dout + c] = asdr::sigmoid(y);
    });
  }
  asdr::cp_async_wait<0>();
}

// enc (n, Dd.d[0]), sh (n, S) -> out (n, 4 + G) = [sigma, rgb, geo]: the
// density chain, then the color chain on [geo, sh].
__global__ void __launch_bounds__(kTileThreads, 1) fused_field_kernel(
    const float* __restrict__ enc, const float* __restrict__ sh, long long n,
    int S, int G, const float* __restrict__ wd, asdr::Dims Dd,
    const float* __restrict__ wc, asdr::Dims Dc, TileLayout L,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims_d[asdr::kMaxLayers + 1], dims_c[asdr::kMaxLayers + 1];
  const int g = threadIdx.x / asdr::kGroupThreads;
  float* act = smem + L.act + g * L.act_g;
  float* raw0 = smem + L.raw + 2 * g * L.tile;
  float* raw1 = raw0 + L.tile;
  const int din = Dd.d[0], W = 4 + G;
  dims_to_shared(Dd, dims_d);
  dims_to_shared(Dc, dims_c);
  for (int i = threadIdx.x; i < L.nw0; i += blockDim.x) smem[i] = wd[i];
  for (int i = threadIdx.x; i < L.nw1; i += blockDim.x) smem[L.w1 + i] = wc[i];
  __syncthreads();

  auto load = [&](float* buf, long long t) {
    asdr::tile_load_async(buf, enc, t * kTileRows, tile_rows(n, t), din);
    asdr::tile_load_async(buf + kTileRows * din, sh, t * kTileRows,
                          tile_rows(n, t), S);
  };
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  const long long stride = (long long)gridDim.x * kTileGroups;
  long long tile = (long long)blockIdx.x * kTileGroups + g;
  if (tile < ntiles) load(raw0, tile);
  asdr::cp_async_commit();
  for (int it = 0; tile < ntiles; ++it, tile += stride) {
    const long long next = tile + stride;
    if (next < ntiles) load((it & 1) ? raw0 : raw1, next);
    asdr::cp_async_commit();
    asdr::cp_async_wait<1>();
    asdr::group_sync();
    const long long row0 = tile * kTileRows;
    const int nrows = tile_rows(n, tile);
    const float* cur = (it & 1) ? raw1 : raw0;
    asdr::tile_to_k_major(cur, din, nrows, act);
    asdr::tile_to_k_major(cur + kTileRows * din, S, nrows,
                          act + (L.P + G) * kTileRows);
    asdr::group_sync();
    tile_chain<asdr::MulAdd>(smem, dims_d, Dd.n, act, act,
                             [&](int r, int c, float y) {
      if (c > 0) act[(L.P + c - 1) * kTileRows + r] = y;
      if (r < nrows)
        out[(row0 + r) * W + (c > 0 ? 3 + c : 0)] =
            c > 0 ? y : asdr::trunc_exp(y);
    });
    asdr::group_sync();
    tile_chain<asdr::Fma>(smem + L.w1, dims_c, Dc.n, act + L.P * kTileRows,
                          act, [&](int r, int c, float y) {
      if (r < nrows) out[(row0 + r) * W + 1 + c] = asdr::sigmoid(y);
    });
  }
  asdr::cp_async_wait<0>();
}

asdr::Dims dims_of(const int* dims, int n_layers) {
  asdr::Dims D{};
  D.n = n_layers;
  for (int i = 0; i <= n_layers; ++i) D.d[i] = dims[i];
  return D;
}

// Opt in to smem bytes of dynamic shared memory and size the grid:
// blocks of kTileThreads (or threads), at most what fills the card once.
template <typename K>
int prepare(K kernel, size_t smem, int threads, long long work, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = asdr::fill_grid(kernel, threads, smem, work);
  return 0;
}

}  // namespace

// dims: host array of n_layers + 1 widths; w: the chain's weights, flat.
extern "C" int density_mlp_launch(const float* enc, long long n,
                                  const float* w, const int* dims,
                                  int n_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims D = dims_of(dims, n_layers);
  const size_t smem = (size_t)asdr::chain_floats(D) * sizeof(float);
  int blocks = 0;
  if (int e = prepare(density_mlp_kernel, smem, 256, n, &blocks)) return e;
  density_mlp_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(enc, n, w,
                                                                   D, out);
  return (int)cudaGetLastError();
}

// Hidden widths must be multiples of 4 and at most 128; cin 16-B aligned.
extern "C" int color_mlp_launch(const float* cin, long long n, const float* w,
                                const int* dims, int n_layers, float* out,
                                void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims D = dims_of(dims, n_layers);
  const TileLayout L = color_layout(D);
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  int blocks = 0;
  if (int e = prepare(color_mlp_kernel, L.bytes, kTileThreads,
                      ntiles * asdr::kGroupThreads, &blocks))
    return e;
  color_mlp_kernel<<<blocks, kTileThreads, L.bytes, (cudaStream_t)stream>>>(
      cin, n, w, D, L, out);
  return (int)cudaGetLastError();
}

// sh: (n, S) SH features; dims_d / dims_c: host arrays of the two chains'
// widths (dims_c[0] = G + S).  enc and sh 16-B aligned.
extern "C" int fused_field_launch(const float* enc, const float* sh,
                                  long long n, int S, const float* wd,
                                  const int* dims_d, int nd_layers,
                                  const float* wc, const int* dims_c,
                                  int nc_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims Dd = dims_of(dims_d, nd_layers);
  const asdr::Dims Dc = dims_of(dims_c, nc_layers);
  const TileLayout L = fused_layout(Dd, Dc, S);
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  int blocks = 0;
  if (int e = prepare(fused_field_kernel, L.bytes, kTileThreads,
                      ntiles * asdr::kGroupThreads, &blocks))
    return e;
  fused_field_kernel<<<blocks, kTileThreads, L.bytes, (cudaStream_t)stream>>>(
      enc, sh, n, S, Dd.d[Dd.n] - 1, wd, Dd, wc, Dc, L, out);
  return (int)cudaGetLastError();
}
