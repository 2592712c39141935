// Density and color MLPs for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py density_call
// (_density_kernel), color_call (_color_kernel) and fused_field_call
// (_fused_kernel, both chains in one pass).  Weights keep their true
// widths (no 128-lane padding, no sigma-column permutation): one CTA
// copies the chain's weights into shared memory once, then each thread
// carries one sample through the chain in per-thread arrays.  Bound:
// operations (74,240 FLOP per color sample against 12 B of output); the
// design keeps the weights on chip and reads them as shared-memory
// broadcasts.  No tensor cores in this version.
#include "common.cuh"

namespace {

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

// cin (n, d[0]) = [geo, SH(dir)] -> out (n, d[n_layers]) = sigmoid(chain)
__global__ void __launch_bounds__(256) color_mlp_kernel(
    const float* __restrict__ cin, long long n, const float* __restrict__ w,
    asdr::Dims D, float* __restrict__ out) {
  extern __shared__ float sw[];
  const int nw = asdr::chain_floats(D);
  for (int i = threadIdx.x; i < nw; i += blockDim.x) sw[i] = w[i];
  __syncthreads();
  const int din = D.d[0], dout = D.d[D.n];
  float a[asdr::kMaxWidth], b[asdr::kMaxWidth];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    for (int k = 0; k < din; ++k) a[k] = cin[r * din + k];
    const float* y = asdr::mlp_chain(sw, D, a, b);
    for (int j = 0; j < dout; ++j) out[r * dout + j] = asdr::sigmoid(y[j]);
  }
}

// enc (n, Dd.d[0]), sh (n, S) -> out (n, 4 + G) = [sigma, rgb, geo]: the
// density chain, then the color chain on [geo, sh], with the same device
// functions as the two kernels above, so the pair and this kernel agree
// to the bit.  Both chains sit in shared memory side by side.
__global__ void __launch_bounds__(256) fused_field_kernel(
    const float* __restrict__ enc, const float* __restrict__ sh, long long n,
    int S, const float* __restrict__ wd, asdr::Dims Dd,
    const float* __restrict__ wc, asdr::Dims Dc, float* __restrict__ out) {
  extern __shared__ float sw[];
  const int nd = asdr::chain_floats(Dd), nc = asdr::chain_floats(Dc);
  for (int i = threadIdx.x; i < nd; i += blockDim.x) sw[i] = wd[i];
  for (int i = threadIdx.x; i < nc; i += blockDim.x) sw[nd + i] = wc[i];
  __syncthreads();
  const int din = Dd.d[0], G = Dd.d[Dd.n] - 1, W = 4 + G;
  float a[asdr::kMaxWidth], b[asdr::kMaxWidth];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (long long)gridDim.x * blockDim.x) {
    for (int k = 0; k < din; ++k) a[k] = enc[r * din + k];
    float* y = asdr::mlp_chain(sw, Dd, a, b);
    float* x = y == a ? b : a;
    float* o = out + r * W;
    o[0] = asdr::trunc_exp(y[0]);
    for (int j = 0; j < G; ++j) {
      o[4 + j] = y[1 + j];
      x[j] = y[1 + j];
    }
    for (int k = 0; k < S; ++k) x[G + k] = sh[r * S + k];
    const float* c = asdr::mlp_chain(sw + nd, Dc, x, y);
    for (int j = 0; j < 3; ++j) o[1 + j] = asdr::sigmoid(c[j]);
  }
}

asdr::Dims dims_of(const int* dims, int n_layers) {
  asdr::Dims D;
  D.n = n_layers;
  for (int i = 0; i <= n_layers; ++i) D.d[i] = dims[i];
  return D;
}

template <typename K>
int launch(K kernel, const float* x, long long n, const float* w,
           const int* dims, int n_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims D = dims_of(dims, n_layers);
  const size_t smem = (size_t)asdr::chain_floats(D) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  const int blocks = asdr::fill_grid(kernel, threads, smem, n);
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(x, n, w, D, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: host array of n_layers + 1 widths; w: the chain's weights, flat.
extern "C" int density_mlp_launch(const float* enc, long long n,
                                  const float* w, const int* dims,
                                  int n_layers, float* out, void* stream) {
  return launch(density_mlp_kernel, enc, n, w, dims, n_layers, out, stream);
}

extern "C" int color_mlp_launch(const float* cin, long long n, const float* w,
                                const int* dims, int n_layers, float* out,
                                void* stream) {
  return launch(color_mlp_kernel, cin, n, w, dims, n_layers, out, stream);
}

// sh: (n, S) SH features; dims_d / dims_c: host arrays of the two chains'
// widths (dims_c[0] = G + S).
extern "C" int fused_field_launch(const float* enc, const float* sh,
                                  long long n, int S, const float* wd,
                                  const int* dims_d, int nd_layers,
                                  const float* wc, const int* dims_c,
                                  int nc_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  const asdr::Dims Dd = dims_of(dims_d, nd_layers);
  const asdr::Dims Dc = dims_of(dims_c, nc_layers);
  const size_t smem =
      (size_t)(asdr::chain_floats(Dd) + asdr::chain_floats(Dc)) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  const int blocks = asdr::fill_grid(fused_field_kernel, threads, smem, n);
  fused_field_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      enc, sh, n, S, wd, Dd, wc, Dc, out);
  return (int)cudaGetLastError();
}
