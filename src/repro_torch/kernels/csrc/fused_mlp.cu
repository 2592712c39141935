// Density and color MLPs for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernels src/repro/kernels/fused_mlp.py density_call
// (_density_kernel) and color_call (_color_kernel).  Weights keep their
// true widths (no 128-lane padding, no sigma-column permutation): one CTA
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

template <typename K>
int launch(K kernel, const float* x, long long n, const float* w,
           const int* dims, int n_layers, float* out, void* stream) {
  if (n <= 0) return 0;
  asdr::Dims D;
  D.n = n_layers;
  for (int i = 0; i <= n_layers; ++i) D.d[i] = dims[i];
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
