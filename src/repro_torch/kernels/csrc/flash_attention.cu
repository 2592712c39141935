// Causal GQA flash attention for Hopper (sm_90a), fp32 math on the CUDA
// cores, fp32 or bf16 in and out.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (_flash_kernel): scores q.k * Dh^-0.5, an optional tanh
// softcap, the causal mask and an optional sliding window, softmax, then
// the weighted sum of v.  The TPU kernel repeats K/V per GQA group and
// keeps one head's K/V resident while it sweeps 128 x 128 tiles.  Here one
// CTA takes (batch*head, 64 query rows): four threads share a query row,
// each holding a quarter of q and of the output in registers (float4
// slices interleaved, so shared-memory reads do not conflict); 32-key
// tiles of K and V pass through shared memory; the online softmax runs on
// the CUDA cores.  The KV head is h / (H / KV), read in place.  Key tiles
// that the causal or window mask empties for every row of the CTA are
// skipped; masked scores get a weight of exactly 0, so a row whose first
// tiles are all masked carries no state from them.
//
// Bound: operations (4 * Dh FLOP per unmasked (query, key) pair against
// 4 * Dh * (2 + 2 * KV / H) bytes per query row).  Built without
// --fmad=false: the kernel is held to its plain version by tolerance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 64;                      // query rows per CTA
constexpr int kKB = 32;                      // keys per shared-memory tile
constexpr int kTPR = 4;                      // threads per query row
constexpr int kThreads = kQB * kTPR;
constexpr int kMaxDh = 128;
constexpr int kMaxV = kMaxDh / (4 * kTPR);   // float4 slices per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// q/out (B, S, H, Dh), k/v (B, S, KV, Dh), contiguous.  Grid: (query
// tiles, B * H); the heaviest (last) query tiles start first.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int H, int KV, int Dh, int window,
    float softcap, float scale) {
  __shared__ float4 sk[kKB][kMaxDh / 4];
  __shared__ float4 sv[kKB][kMaxDh / 4];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int row = threadIdx.x / kTPR, part = threadIdx.x % kTPR;
  const int qi = q0 + row;
  const int nv = Dh / (4 * kTPR), d4 = Dh / 4;

  float4 qr[kMaxV], acc[kMaxV];
#pragma unroll
  for (int i = 0; i < kMaxV; ++i) {
    qr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = qr[i];
    if (i < nv && qi < S) {
      const float4 x = load4(q + ((long long)(b * S + qi) * H + h) * Dh +
                             4 * (i * kTPR + part));
      qr[i] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }
  float m = kNeg, l = 0.f;
  const int k_end = min(S, q0 + kQB);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kKB * kKB : 0;

  for (int kt = k_begin; kt < k_end; kt += kKB) {
    __syncthreads();
    for (int e = threadIdx.x; e < kKB * d4; e += kThreads) {
      const int r = e / d4, c = e % d4, kj = kt + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (kj < S) {
        const long long off = ((long long)(b * S + kj) * KV + kvh) * Dh + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      sk[r][c] = kk;
      sv[r][c] = vv;
    }
    __syncthreads();

    float s[kKB];
    float mt = kNeg;
    unsigned keep = 0u;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      float p = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxV; ++i) {
        if (i < nv) {
          const float4 kk = sk[j][i * kTPR + part];
          p += qr[i].x * kk.x + qr[i].y * kk.y + qr[i].z * kk.z +
               qr[i].w * kk.w;
        }
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);
      p += __shfl_xor_sync(0xffffffffu, p, 2);
      if (softcap > 0.f) p = softcap * tanhf(p / softcap);
      const int kj = kt + j;
      const bool ok = kj <= qi && kj < S && (window <= 0 || qi - kj < window);
      s[j] = ok ? p : kNeg;
      keep |= (unsigned)ok << j;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      s[j] = (keep >> j) & 1u ? expf(s[j] - m_new) : 0.f;
      sum += s[j];
    }
    l = l * alpha + sum;
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
#pragma unroll
      for (int i = 0; i < kMaxV; ++i) {
        if (i < nv) {
          const float4 vv = sv[j][i * kTPR + part];
          acc[i].x += s[j] * vv.x;
          acc[i].y += s[j] * vv.y;
          acc[i].z += s[j] * vv.z;
          acc[i].w += s[j] * vv.w;
        }
      }
    }
    m = m_new;
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      if (i < nv) {
        store4(out + ((long long)(b * S + qi) * H + h) * Dh +
                   4 * (i * kTPR + part),
               make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv,
                           acc[i].w * inv));
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, int Dh, int window, float softcap,
           float scale, void* stream) {
  const dim3 grid((S + kQB - 1) / kQB, B * H);
  flash_attention_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV, Dh, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Dh a multiple of 16 up to 128, H a multiple of KV, 16-byte aligned
// pointers (the wrapper checks).  bf16 != 0: all four tensors bf16, else
// fp32.  window 0 = global; softcap 0 = none.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int Dh, int window,
                                      float softcap, float scale, int bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, Dh, window,
                                      softcap, scale, stream)
              : launch<float>(q, k, v, out, B, S, H, KV, Dh, window, softcap,
                              scale, stream);
}
