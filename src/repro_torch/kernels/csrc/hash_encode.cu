// Multi-resolution hash-grid encode for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/hash_encode.py
// (hash_encode_call / _encode_kernel / encode_level).  One thread per
// (point, level) writes its F features straight into the (N, L*F) layout
// that the reference builds by transposing (L, N, F).  Bound: bytes —
// eight random F-float gathers per (point, level) from a table stack that
// (64 MiB at the paper's config) exceeds the 50 MB L2; the design keeps
// the output writes coalesced (consecutive threads, consecutive levels of
// one point) and leaves the gathers to L2.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) hash_encode_kernel(
    const float* __restrict__ pts, long long n, const int* __restrict__ meta,
    const float* __restrict__ tables, int L, long long T, int F,
    float* __restrict__ out) {
  const long long total = n * L;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long p = t / L;
    const int l = (int)(t - p * L);
    const float px = pts[p * 3 + 0], py = pts[p * 3 + 1], pz = pts[p * 3 + 2];
    float feat[asdr::kMaxFeat];
    asdr::encode_point_level(px, py, pz, meta[l * 3 + 0], meta[l * 3 + 1],
                             (uint32_t)meta[l * 3 + 2],
                             tables + (size_t)l * T * F, F, feat);
    float* o = out + p * (long long)(L * F) + l * F;
    for (int f = 0; f < F; ++f) o[f] = feat[f];
  }
}

}  // namespace

// pts (n, 3), meta (L, 3) int32 [res, is_dense, rows], tables (L, T, F)
// -> out (n, L*F).  Returns cudaGetLastError() after the launch.
extern "C" int hash_encode_launch(const float* pts, long long n,
                                  const int* meta, const float* tables, int L,
                                  long long T, int F, float* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = asdr::fill_grid(hash_encode_kernel, threads, 0,
                                     n * (long long)L);
  hash_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, n, meta, tables, L, T, F, out);
  return (int)cudaGetLastError();
}
