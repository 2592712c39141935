// Density and color MLPs for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py density_call
// (_density_kernel), color_call (_color_kernel) and fused_field_call
// (_fused_kernel, both chains in one pass).  Weights keep their true
// widths (no 128-lane padding, no sigma-column permutation) and sit in
// shared memory, copied once per CTA.  Bound: operations (74,240 FLOP per
// color sample against 12 B of output; 6,144 per density sample against
// 192 B).  No tensor cores.
//
// All three are register-tiled chains (common.cuh): one persistent CTA
// per SM holds the weights and runs two warp groups of 128 threads, each
// walking over its own tiles of kTileRows = 32 samples (64 in flight per
// CTA) on its own named barrier (asdr::tile_loop).  A tile's input rows
// arrive by cp.async into one of the group's two buffers while its
// previous tile computes, then go k-major into the group's activations;
// each hidden layer is asdr::tile_dense_relu (a 4-row x 8-column register
// tile per thread, 4 x 4 for layers of up to 64), the last one
// asdr::tile_dense_last (4 rows x 1 column a thread, or one thread per row
// and column for the color chain's 3).  The color chain rounds once per
// multiply-add (asdr::Fma); the density chain rounds the product and the
// sum on their own (asdr::MulAdd), in density_mlp_kernel and in the fused
// field alike, so their sigma and geo are bit-equal.  density_mlp_kernel
// stages its 32 x 16 output tile in shared memory and writes it as
// contiguous float4 rows.
#include "common.cuh"

namespace {

using asdr::kTileRows;
using asdr::kTileThreads;

// cin (n, d[0]) = [geo, SH(dir)] -> out (n, d[n_layers]) = sigmoid(chain).
__global__ void __launch_bounds__(kTileThreads, 1) color_mlp_kernel(
    const float* __restrict__ cin, long long n, const float* __restrict__ w,
    asdr::Dims D, asdr::TileLayout L, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims[asdr::kMaxLayers + 1];
  const int g = threadIdx.x / asdr::kGroupThreads, din = D.d[0];
  float* act = smem + L.act + g * L.act_g;
  float* raw0 = smem + L.raw + g * L.raw_g;
  asdr::dims_to_shared(D, dims);
  for (int i = threadIdx.x; i < L.nw0; i += blockDim.x) smem[i] = w[i];
  __syncthreads();
  const int dout = dims[D.n];
  asdr::tile_loop(
      n, raw0, raw0 + L.tile,
      [&](float* buf, long long t) {
        asdr::tile_load_async(buf, cin, t * kTileRows, asdr::tile_rows(n, t),
                              din);
      },
      [&](const float* cur, long long row0, int nrows) {
        asdr::tile_to_k_major(cur, din, nrows, act);
        asdr::group_sync();
        asdr::tile_chain<asdr::Fma>(smem, dims, D.n, act, act,
                                    [&](int r, int c, float y) {
          if (r < nrows) out[(row0 + r) * dout + c] = asdr::sigmoid(y);
        });
      });
}

// enc (n, d[0]) -> out (n, d[n_layers]) = [trunc_exp(sigma logit), geo].
__global__ void __launch_bounds__(kTileThreads, 2) density_mlp_kernel(
    const float* __restrict__ enc, long long n, const float* __restrict__ w,
    asdr::Dims D, asdr::TileLayout L, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims[asdr::kMaxLayers + 1];
  const int g = threadIdx.x / asdr::kGroupThreads, din = D.d[0];
  float* act = smem + L.act + g * L.act_g;
  float* raw0 = smem + L.raw + g * L.raw_g;
  float* stage = raw0 + 2 * L.tile;
  asdr::dims_to_shared(D, dims);
  for (int i = threadIdx.x; i < L.nw0; i += blockDim.x) smem[i] = w[i];
  __syncthreads();
  const int dout = dims[D.n], sw = dout + 1;
  asdr::tile_loop(
      n, raw0, raw0 + L.tile,
      [&](float* buf, long long t) {
        asdr::tile_load_async(buf, enc, t * kTileRows, asdr::tile_rows(n, t),
                              din);
      },
      [&](const float* cur, long long row0, int nrows) {
        asdr::tile_to_k_major(cur, din, nrows, act);
        asdr::group_sync();
        asdr::tile_chain<asdr::MulAdd>(
            smem, dims, D.n, act, act,
            asdr::density_epi(
                [&](int r, float s) { stage[r * sw] = s; },
                [&](int r, int c, float y) { stage[r * sw + 1 + c] = y; }));
        asdr::group_sync();
        asdr::store_tile(stage, dout, out, row0, nrows);
      });
}

// enc (n, Dd.d[0]), sh (n, S) -> out (n, 4 + G) = [sigma, rgb, geo]: the
// density chain, then the color chain on [geo, sh].
__global__ void __launch_bounds__(kTileThreads, 1) fused_field_kernel(
    const float* __restrict__ enc, const float* __restrict__ sh, long long n,
    int S, int G, const float* __restrict__ wd, asdr::Dims Dd,
    const float* __restrict__ wc, asdr::Dims Dc, asdr::TileLayout L,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims_d[asdr::kMaxLayers + 1], dims_c[asdr::kMaxLayers + 1];
  const int g = threadIdx.x / asdr::kGroupThreads;
  float* act = smem + L.act + g * L.act_g;
  float* raw0 = smem + L.raw + g * L.raw_g;
  const int din = Dd.d[0], W = 4 + G;
  asdr::dims_to_shared(Dd, dims_d);
  asdr::dims_to_shared(Dc, dims_c);
  for (int i = threadIdx.x; i < L.nw0; i += blockDim.x) smem[i] = wd[i];
  for (int i = threadIdx.x; i < L.nw1; i += blockDim.x) smem[L.w1 + i] = wc[i];
  __syncthreads();
  asdr::tile_loop(
      n, raw0, raw0 + L.tile,
      [&](float* buf, long long t) {
        asdr::tile_load_async(buf, enc, t * kTileRows, asdr::tile_rows(n, t),
                              din);
        asdr::tile_load_async(buf + kTileRows * din, sh, t * kTileRows,
                              asdr::tile_rows(n, t), S);
      },
      [&](const float* cur, long long row0, int nrows) {
        asdr::tile_to_k_major(cur, din, nrows, act);
        asdr::tile_to_k_major(cur + kTileRows * din, S, nrows,
                              act + (L.P + G) * kTileRows);
        asdr::group_sync();
        asdr::tile_chain<asdr::MulAdd>(
            smem, dims_d, Dd.n, act, act,
            asdr::density_epi(
                [&](int r, float s) {
                  if (r < nrows) out[(row0 + r) * W] = s;
                },
                [&](int r, int c, float y) {
                  act[(L.P + c) * kTileRows + r] = y;
                  if (r < nrows) out[(row0 + r) * W + 4 + c] = y;
                }));
        asdr::group_sync();
        asdr::tile_chain<asdr::Fma>(smem + L.w1, dims_c, Dc.n,
                                    act + L.P * kTileRows, act,
                                    [&](int r, int c, float y) {
          if (r < nrows) out[(row0 + r) * W + 1 + c] = asdr::sigmoid(y);
        });
      });
}

// Opt in to L.bytes of dynamic shared memory and size the grid: blocks
// of kTileThreads, at most what fills the card once, at most one warp
// group per tile of the n rows.
template <typename K>
int prepare(K kernel, const asdr::TileLayout& L, long long n, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (e != cudaSuccess) return (int)e;
  const long long ntiles = (n + kTileRows - 1) / kTileRows;
  *blocks = asdr::fill_grid(kernel, kTileThreads, L.bytes,
                            ntiles * asdr::kGroupThreads);
  return 0;
}

}  // namespace

// Bytes of dynamic shared memory density_mlp_launch asks for.
extern "C" long long density_mlp_smem(const int* dims, int n_layers) {
  return (long long)asdr::density_layout(asdr::dims_of(dims, n_layers)).bytes;
}

// dims: host array of n_layers + 1 widths; w: the chain's weights, flat.
// Hidden widths must be multiples of 4 (of 8 above 64) and at most 128;
// enc 16-B aligned.
extern "C" int density_mlp_launch(const float* enc, long long n,
                                  const float* w, const int* dims,
                                  int n_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims D = asdr::dims_of(dims, n_layers);
  const asdr::TileLayout L = asdr::density_layout(D);
  int blocks = 0;
  if (int e = prepare(density_mlp_kernel, L, n, &blocks)) return e;
  density_mlp_kernel<<<blocks, kTileThreads, L.bytes, (cudaStream_t)stream>>>(
      enc, n, w, D, L, out);
  return (int)cudaGetLastError();
}

// Hidden widths must be multiples of 4 (of 8 above 64) and at most 128;
// cin 16-B aligned.
extern "C" int color_mlp_launch(const float* cin, long long n, const float* w,
                                const int* dims, int n_layers, float* out,
                                void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims D = asdr::dims_of(dims, n_layers);
  const asdr::TileLayout L = asdr::color_layout(D);
  int blocks = 0;
  if (int e = prepare(color_mlp_kernel, L, n, &blocks)) return e;
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
  const asdr::Dims Dd = asdr::dims_of(dims_d, nd_layers);
  const asdr::Dims Dc = asdr::dims_of(dims_c, nc_layers);
  const asdr::TileLayout L = asdr::fused_layout(Dd, Dc, S);
  int blocks = 0;
  if (int e = prepare(fused_field_kernel, L, n, &blocks)) return e;
  fused_field_kernel<<<blocks, kTileThreads, L.bytes, (cudaStream_t)stream>>>(
      enc, sh, n, S, Dd.d[Dd.n] - 1, wd, Dd, wc, Dc, L, out);
  return (int)cudaGetLastError();
}
