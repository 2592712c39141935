// Decoupled volume rendering for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/volume_render.py
// volume_render_call (_vr_kernel): Eq. (1) compositing with the §4.3
// anchor colors expanded to every sample.  The TPU kernel puts that lerp
// on the MXU as a product with a constant expansion matrix; here each
// sample lerps its two enclosing anchors directly, by core/decouple.py's
// rule, reading the anchors in their (R, A, 3) layout, so no matrix is
// built.  One thread per ray walks its samples in order, carrying the
// exclusive sum of sigma * delta; transmittance is exp(-excl).  (The TPU
// kernel's cumsum(sd) - sd is the same sum, but loses the prefix to
// cancellation once one sample's sd dwarfs it; the running sum does not.)
//
// Bound: bytes (sigma and delta of each sample, each anchor read once; a
// few dozen operations per sample).  Neighbouring threads read rows S
// floats apart, so loads do not coalesce and L1 holds a warp's lines only
// while they fit: coalescing across rays is left for a later version.
#include <cuda_runtime.h>

namespace {

// sig / dlt (R, S), anch (R, A, 3) -> out (R, 4) = [acc, r, g, b]
__global__ void __launch_bounds__(256) volume_render_kernel(
    const float* __restrict__ sig, const float* __restrict__ dlt,
    const float* __restrict__ anch, long long R, int S, int A, int group,
    float* __restrict__ out) {
  const float fg = (float)group;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += (long long)gridDim.x * blockDim.x) {
    const float* sr = sig + r * S;
    const float* dr = dlt + r * S;
    const float* ar = anch + r * A * 3;
    float excl = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float sd = sr[j] * dr[j];
      const float w = expf(-excl) * (1.f - expf(-sd));
      excl = excl + sd;
      acc = acc + w;
      const int gi = j / group;
      const float t = (float)(j % group) / fg;
      const float* lo = ar + 3 * min(gi, A - 1);
      const float* hi = ar + 3 * min(gi + 1, A - 1);
      c0 = c0 + w * (lo[0] + (hi[0] - lo[0]) * t);
      c1 = c1 + w * (lo[1] + (hi[1] - lo[1]) * t);
      c2 = c2 + w * (lo[2] + (hi[2] - lo[2]) * t);
    }
    float* o = out + r * 4;
    o[0] = acc;
    o[1] = c0;
    o[2] = c1;
    o[3] = c2;
  }
}

}  // namespace

extern "C" int volume_render_launch(const float* sig, const float* dlt,
                                    const float* anch, long long R, int S,
                                    int A, int group, float* out,
                                    void* stream) {
  if (R <= 0) return 0;
  const int threads = 256;
  const long long blocks = (R + threads - 1) / threads;
  volume_render_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(sig, dlt, anch, R, S, A,
                                                 group, out);
  return (int)cudaGetLastError();
}
