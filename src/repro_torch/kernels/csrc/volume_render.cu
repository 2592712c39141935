// Decoupled volume rendering for Hopper (sm_90a), fp32, CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/volume_render.py
// volume_render_call (_vr_kernel): Eq. (1) compositing with the §4.3
// anchor colors expanded to every sample.  The TPU kernel puts that lerp
// on the MXU as a product with a constant expansion matrix; here each
// sample lerps its two enclosing anchors directly, by core/decouple.py's
// rule, reading the anchors in their (R, A, 3) layout, so no matrix is
// built.  Each ray's samples are walked in order, carrying the exclusive
// sum of sigma * delta; transmittance is exp(-excl).  (The TPU kernel's
// cumsum(sd) - sd is the same sum, but loses the prefix to cancellation
// once one sample's sd dwarfs it; the running sum does not.)
//
// Bound: bytes (sigma and delta of each sample, each anchor read once; a
// few dozen operations per sample).  So the loads are what the design is
// about: a warp takes 32 consecutive rays and stages chunks of kChunk
// samples of all 32 through shared memory by cp.async, double-buffered
// (chunk c + 1 loads while chunk c is walked); the warps of a CTA
// (kWarps: 2, five CTAs an SM) do not wait on each other.  A ray's
// kChunk sigmas (and deltas) are contiguous, so a warp's copies read whole
// 64-B runs, 16 B a lane where S is a multiple of 4 and the arrays 16-B
// aligned, else 4 B a lane.  The anchors a chunk's samples lerp between
// (a contiguous run of each ray's row) follow into the same buffer, 16 B
// a lane from the 16-B boundary at or below the run's start (so up to 3
// floats before and after it, never past the 16-B block that holds the
// run's last float, which lies in the allocation), else 4 B a lane.  Then
// each lane walks its own ray from shared memory: sigma and delta as
// float4s (rows padded so the 32 lanes' reads hit distinct banks), the
// sample's group and place in it counted up rather than divided, the
// group's two anchors read once per group, the lerp offset m / group from
// a per-warp table; and writes its [acc, r, g, b] as one float4.  Shared
// memory is bounded whatever S and A are: at most kChunk + 1 anchors a
// chunk.
//
// The arithmetic is the plain version's, op by op and in its order, and
// the build keeps --fmad=false, so the two agree to the bit.
#include "common.cuh"

namespace {

constexpr int kRays = 32;                // rays per warp
constexpr int kWarps = 2;                // warps per CTA (independent)
constexpr int kChunk = 16;               // samples per staged chunk
constexpr int kRowF = kChunk + 4;        // padded row of a chunk (floats)

// Most anchors one chunk's samples read (lo and hi of each), over the
// chunks of a ray of S samples with A anchors and `group` samples each.
__host__ inline int anchors_per_chunk(int S, int A, int group) {
  int most = 1;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int n = S - s0 < kChunk ? S - s0 : kChunk;
    const int lo = s0 / group < A - 1 ? s0 / group : A - 1;
    const int hi0 = (s0 + n - 1) / group + 1;
    const int hi = hi0 < A - 1 ? hi0 : A - 1;
    if (hi - lo + 1 > most) most = hi - lo + 1;
  }
  return most;
}

// Floats of one ray's staged anchors: the run of na anchors from the 16-B
// boundary at or below its start, in whole float4s, and an odd number of
// float4s, so the 32 lanes' rows start on 8 distinct bank groups.
__host__ inline int anchor_row(int na) {
  const int q = (3 * na + 3 + 3) / 4;
  return 4 * (q | 1);
}

// Floats of one buffer of one warp: sigma, delta, anchors of 32 rays.
__host__ __device__ inline int buffer_floats(int arow) {
  return kRays * (2 * kRowF + arow);
}

// Per warp: two buffers, then a table of the lerp offsets t = m / group
// for m < 32.
__host__ inline long long smem_bytes(int S, int A, int group) {
  return 4LL * kWarps *
         (2 * buffer_floats(anchor_row(anchors_per_chunk(S, A, group))) +
          kRays);
}

// Start copying chunk [s0, s0 + n) of the warp's rays [r0, r0 + nr) into
// one buffer: sigma and delta rows (kRowF floats a ray), then each ray's
// anchors [lo, hi] (arow floats a ray, from the 16-B boundary at or below
// the run's start: 16-B copies when the anchors are 16-B aligned, else
// 4-B ones from the run's start).
__device__ __forceinline__ void stage_chunk(
    float* sb, const float* __restrict__ sig, const float* __restrict__ dlt,
    const float* __restrict__ anch, long long r0, int nr, int S, int A,
    int group, int s0, int arow, bool vec, bool avec, int lane) {
  const int n = min(kChunk, S - s0);
  float* db = sb + kRays * kRowF;
  float* ab = db + kRays * kRowF;
  if (vec) {     // S % 4 == 0: a chunk's rows are whole float4s
    constexpr int kQ = kChunk / 4;
    for (int e = lane; e < kRays * kQ; e += 32) {
      const int r = e / kQ, qd = e % kQ;
      if (r < nr && 4 * qd < n) {
        const long long off = (r0 + r) * S + s0 + 4 * qd;
        asdr::cp_async16(sb + r * kRowF + 4 * qd, sig + off);
        asdr::cp_async16(db + r * kRowF + 4 * qd, dlt + off);
      }
    }
  } else {
    for (int e = lane; e < kRays * kChunk; e += 32) {
      const int r = e / kChunk, j = e % kChunk;
      if (r < nr && j < n) {
        const long long off = (r0 + r) * S + s0 + j;
        asdr::cp_async4(sb + r * kRowF + j, sig + off);
        asdr::cp_async4(db + r * kRowF + j, dlt + off);
      }
    }
  }
  const int lo = min(s0 / group, A - 1);
  const int hi = min((s0 + n - 1) / group + 1, A - 1);
  const int nf = 3 * (hi - lo + 1);
  if (avec) {    // 8 lanes a ray, 4 rays at a time
    for (int r = lane >> 3; r < nr; r += 4) {
      const long long f0 = ((r0 + r) * A + lo) * 3, a0 = f0 & ~3LL;
      const int n4 = (int)((f0 - a0 + nf + 3) >> 2);
      for (int qd = lane & 7; qd < n4; qd += 8)
        asdr::cp_async16(ab + r * arow + 4 * qd, anch + a0 + 4 * qd);
    }
  } else {
    for (int r = 0; r < nr; ++r) {
      const float* src = anch + ((r0 + r) * A + lo) * 3;
      for (int e = lane; e < nf; e += 32)
        asdr::cp_async4(ab + r * arow + e, src + e);
    }
  }
  asdr::cp_async_commit();
}

// sig / dlt (R, S), anch (R, A, 3) -> out (R, 4) = [acc, r, g, b]
__global__ void __launch_bounds__(kWarps * 32) volume_render_kernel(
    const float* __restrict__ sig, const float* __restrict__ dlt,
    const float* __restrict__ anch, long long R, int S, int A, int group,
    int arow, int vec, int avec, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRays;
  if (r0 >= R) return;
  const int nr = (int)min((long long)kRays, R - r0);
  const int bf = buffer_floats(arow);
  float* wb = smem + warp * (2 * bf + kRays);
  float* tt = wb + 2 * bf;           // t = m / group for m < 32
  const bool live = lane < nr;
  const float fg = (float)group;
  tt[lane] = (float)lane / fg;

  if (S > 0)
    stage_chunk(wb, sig, dlt, anch, r0, nr, S, A, group, 0, arow, vec, avec,
                lane);
  // the lane's ray: its running sums, the sample's group gi and place m
  // in it, and the group's lo anchor and hi - lo
  float excl = 0.f, acc = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  float l0 = 0.f, l1 = 0.f, l2 = 0.f, h0 = 0.f, h1 = 0.f, h2 = 0.f;
  float e0 = 0.f, e1 = 0.f, e2 = 0.f;
  int gi = 0, m = 0;
  int buf = 0;
  for (int s0 = 0; s0 < S; s0 += kChunk, buf ^= 1) {
    if (s0 + kChunk < S) {
      stage_chunk(wb + (buf ^ 1) * bf, sig, dlt, anch, r0, nr, S, A, group,
                  s0 + kChunk, arow, vec, avec, lane);
      asdr::cp_async_wait<1>();
    } else {
      asdr::cp_async_wait<0>();
    }
    __syncwarp();
    if (live) {
      const float* bb = wb + buf * bf;
      const float* sr = bb + lane * kRowF;
      const float* dr = bb + (kRays + lane) * kRowF;
      const int a_lo = min(s0 / group, A - 1);
      // where the lane's staged run of anchors starts (a_lo at ar[0])
      const float* ar = bb + 2 * kRays * kRowF + lane * arow +
                        (avec ? (int)(((r0 + lane) * A + a_lo) * 3 & 3) : 0);
      const int n = min(kChunk, S - s0);
#pragma unroll
      for (int qd = 0; qd < kChunk / 4; ++qd) {
        if (4 * qd < n) {
          const float4 s4 = *reinterpret_cast<const float4*>(sr + 4 * qd);
          const float4 d4 = *reinterpret_cast<const float4*>(dr + 4 * qd);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * qd + i < n) {
              if (m == 0) {    // a new group: lo is the last group's hi
                if (gi == 0) {
                  l0 = ar[0];
                  l1 = ar[1];
                  l2 = ar[2];
                } else {
                  l0 = h0;
                  l1 = h1;
                  l2 = h2;
                }
                const float* hp = ar + 3 * (min(gi + 1, A - 1) - a_lo);
                h0 = hp[0];
                h1 = hp[1];
                h2 = hp[2];
                e0 = h0 - l0;
                e1 = h1 - l1;
                e2 = h2 - l2;
              }
              const float sd = sv[i] * dv[i];
              const float w = expf(-excl) * (1.f - expf(-sd));
              excl = excl + sd;
              acc = acc + w;
              const float t = m < kRays ? tt[m] : (float)m / fg;
              c0 = c0 + w * (l0 + e0 * t);
              c1 = c1 + w * (l1 + e1 * t);
              c2 = c2 + w * (l2 + e2 * t);
              if (++m == group) {
                m = 0;
                ++gi;
              }
            }
          }
        }
      }
    }
    __syncwarp();   // the lanes are done with this buffer before it refills
  }
  if (live)
    *reinterpret_cast<float4*>(out + (r0 + lane) * 4) =
        make_float4(acc, c0, c1, c2);
}

}  // namespace

// Bytes of dynamic shared memory the launcher asks for at (S, A, group).
extern "C" long long volume_render_smem(int S, int A, int group) {
  return smem_bytes(S, A, group);
}

// S >= 1, A >= 1, group >= 1 (the wrapper checks).  Returns
// cudaGetLastError().
extern "C" int volume_render_launch(const float* sig, const float* dlt,
                                    const float* anch, long long R, int S,
                                    int A, int group, float* out,
                                    void* stream) {
  if (R <= 0) return 0;
  const int arow = anchor_row(anchors_per_chunk(S, A, group));
  const long long smem = smem_bytes(S, A, group);
  cudaError_t err = cudaFuncSetAttribute(
      volume_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = S % 4 == 0 && ((uintptr_t)sig | (uintptr_t)dlt) % 16 == 0;
  const int avec = (uintptr_t)anch % 16 == 0;
  const long long rays_per_cta = (long long)kWarps * kRays;
  const long long blocks = (R + rays_per_cta - 1) / rays_per_cta;
  volume_render_kernel<<<(unsigned)blocks, kWarps * 32, (size_t)smem,
                         (cudaStream_t)stream>>>(sig, dlt, anch, R, S, A,
                                                 group, arow, vec, avec,
                                                 out);
  return (int)cudaGetLastError();
}
