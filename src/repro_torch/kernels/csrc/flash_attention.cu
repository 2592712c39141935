// Causal GQA flash attention for Hopper (sm_90a): bf16 on the tensor
// cores, fp32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// flash_attention (_flash_kernel): scores q.k * Dh^-0.5, an optional tanh
// softcap, the causal mask and an optional sliding window, an online
// softmax with fp32 statistics (m, l), then the weighted sum of v, out in
// q's dtype.  The TPU kernel repeats K/V per GQA group and keeps one
// head's K/V resident while it sweeps 128 x 128 tiles.  Here the KV head
// h / (H / KV) is read in place, key tiles that the causal or window mask
// empties for every row of a CTA are never loaded, and masked scores get
// a weight of exactly 0 (exp of -inf), so a row whose first tiles are all
// masked carries nothing from them.  One CTA takes (batch*head, a tile of
// query rows); K and V tiles pass through shared memory by cp.async,
// double-buffered, so tile k + 1 loads while tile k is computed (one
// barrier a tile: tile k has landed and the other buffer is free).
//
// Each kernel is a template on a compile-time bound of the head dim, kDh:
// 128 takes Dh up to 128, 256 takes Dh in (128, 256].  The two bounds
// have their own tiles (bf16_qb, bf16_kb, f32_min_ctas, ...); at 256 one warp's O
// accumulator alone is 128 fp32 registers of the 255 a thread can hold.
//
// bf16 (flash_attention_bf16_kernel), FA2-style: each warp owns 16 query
// rows.  At kDh 128 a CTA holds kBf16Warps of them (8: 128 rows, one CTA
// an SM at 235 registers; 4 warps at two CTAs an SM timed within noise of
// it, at three CTAs they spill) and Q's fragments stay in registers (Q's
// tile is staged in the second K/V buffer, which it leaves before that
// buffer first fills).  At kDh 256 a CTA holds kBf16WideWarps (4: 64
// rows) over tiles of kBf16WideKB keys (32), and Q stays in shared memory
// of its own, its fragments loaded by ldmatrix a 16-dim step at a time
// beside K's: 128 registers of O, 16 of S and two steps of Q and K
// fragments fit without spills, where Q's 64 fragment registers, S at 64
// keys and V's fragments would not; 101,376 B of shared memory, two CTAs
// an SM (64 keys double-buffered, 270 KB, would not fit one).
// Q.K^T is mma.sync m16n8k16 bf16 -> fp32; K tiles come in by ldmatrix, V
// by ldmatrix.trans, each step's fragments loading while the last one
// multiplies.  The online softmax runs on the fp32 accumulator fragments
// (a quad of lanes shares a row: two shuffles for its max, which is taken
// before the log2 scale, folded into the exponent's multiply-add; the
// row sum stays per lane until the end; O is rescaled only when a row's
// max moved).  P is rounded to bf16 in registers and used directly as
// the A operand of P.V, never through shared memory; the TPU kernel's MXU
// passes round bf16 operands the same way, and the plain version rounds
// P so too.  Rows of shared memory are padded by 16 B, so ldmatrix's
// eight rows fall on distinct banks.  Bound: the tensor cores (4 * Dh
// FLOP per unmasked pair at 989 TFLOP/s), then the exps (and the
// softcap's tanhf: an exp2 and a reciprocal) on the special-function
// units.
//
// fp32 (flash_attention_f32_kernel) stays in full fp32 on the CUDA cores
// (no TF32), as a register-tiled outer product: a CTA of 128 threads takes
// 64 query rows against kF32KB-key tiles (32: two CTAs an SM; 16 and 64
// measured slower); each thread holds a 4 x 4 tile of S = Q.K^T (rows
// ty + 16 r, keys tx + 8 c) and a 4 x kDh / 8 tile of O (rows ty + 16 r,
// float4 slices tx + 8 c of Dh), so each float4 read from shared memory
// feeds several multiply-adds.  At kDh 256 the tiles are the same, O is
// 128 registers, and the 209,920 B of shared memory hold one CTA an SM.
// P goes through a small shared tile read back by the warp that wrote it.  Bound: operations (4 * Dh FLOP per unmasked
// pair at 67 TFLOP/s).
//
// Built without --fmad=false: the kernel is held to its plain version by
// tolerance, not to the bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// head dims up to 128
constexpr int kBf16Warps = 8;                // warps (16 query rows each)
constexpr int kBf16MinCtas = 1;              // CTAs an SM it is built for
constexpr int kBf16KB = 64;                  // keys per tile

constexpr int kF32MinCtas = 2;               // CTAs an SM it is built for
constexpr int kF32KB = 32;                   // keys per tile

// head dims in (128, 256]
constexpr int kBf16WideWarps = 4;
constexpr int kBf16WideMinCtas = 2;
constexpr int kBf16WideKB = 32;

constexpr int kF32WideMinCtas = 1;          // fp32 keeps its tiles

constexpr int kF32Threads = 128;
constexpr int kF32QB = 64;                   // query rows per CTA

// The tiles of each head-dim bound (kDh 128 or 256).
__host__ __device__ constexpr int bf16_threads(int kDh) {
  return 32 * (kDh > 128 ? kBf16WideWarps : kBf16Warps);
}
__host__ __device__ constexpr int bf16_qb(int kDh) {
  return 16 * (kDh > 128 ? kBf16WideWarps : kBf16Warps);
}
__host__ __device__ constexpr int bf16_kb(int kDh) {
  return kDh > 128 ? kBf16WideKB : kBf16KB;
}
__host__ __device__ constexpr int bf16_min_ctas(int kDh) {
  return kDh > 128 ? kBf16WideMinCtas : kBf16MinCtas;
}
__host__ __device__ constexpr int f32_min_ctas(int kDh) {
  return kDh > 128 ? kF32WideMinCtas : kF32MinCtas;
}

// Rows of Q, K and V in shared memory are padded by 16 B: an odd number of
// 16-B units per row puts ldmatrix's eight rows (bf16) and eight lanes'
// float4 reads (fp32) on distinct banks.
__host__ __device__ inline int row_elems(int Dh, int elem_bytes) {
  return Dh + 16 / elem_bytes;
}

// Two buffers of a K tile and a V tile; at Dh <= 128 Q's tile is staged
// in the second (it is read into registers before that buffer first
// fills), past 128 it has its own.
__host__ inline long long bf16_smem(int Dh) {
  const int kb = bf16_kb(Dh);
  return 2LL * row_elems(Dh, 2) * (4 * kb + (Dh > 128 ? bf16_qb(Dh) : 0));
}

// Q's tile, two buffers of a K and a V tile, and the P tile.
__host__ inline long long f32_smem(int Dh) {
  return 4LL * (row_elems(Dh, 4) * (kF32QB + 4 * kF32KB) +
                kF32QB * (kF32KB + 8));
}

// The key tiles with an unmasked pair for query rows [q0, q0 + qb): their
// first keys run from begin (the tile holding key q0 - window + 1, 0
// without a window) by kb while below end (one past the rows' last key).
// The kernels and flash_attention_key_range share it.
struct KeyRange {
  int begin, end;
};
__host__ __device__ __forceinline__ KeyRange key_range(int q0, int S,
                                                       int window, int qb,
                                                       int kb) {
  const int first = q0 - window + 1;
  return {window > 0 && first > 0 ? first / kb * kb : 0,
          q0 + qb < S ? q0 + qb : S};
}

// ---- cp.async, ldmatrix, mma.sync ---------------------------------------
__device__ __forceinline__ void cp16(void* s, const void* g, bool full) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(g), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kRows rows from row0 of a (., Dh) matrix with row stride gstride into
// shared rows of ld elements; rows at or past S are zero-filled.
template <typename T, int kThreads, int kRows, int kDh>
__device__ __forceinline__ void load_rows(T* s, int ld, const T* g,
                                          long long gstride, int row0, int S,
                                          int Dh) {
  constexpr int kPer = 16 / sizeof(T);           // elements per 16 B
  constexpr int kSlots = kDh / kPer;             // 16 B slots of a row
  constexpr int kStep = kThreads / kSlots;       // rows a pass
  static_assert(kRows % kStep == 0, "whole passes");
  const int c = threadIdx.x % kSlots, r = threadIdx.x / kSlots;
  if (c * kPer >= Dh) return;
  const T* gp = g + (long long)(row0 + r) * gstride + c * kPer;
  T* sp = s + r * ld + c * kPer;
#pragma unroll
  for (int i = 0; i < kRows / kStep; ++i) {
    const bool ok = row0 + r + i * kStep < S;
    cp16(sp + i * kStep * ld, ok ? gp + i * kStep * gstride : g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// ---- bf16 on the tensor cores -------------------------------------------
// o += P . V for one warp's 16 rows and a tile of kKB keys, P the softmax
// numerators s (fp32, rounded to bf16 here).  Steps of 16 keys by kVP * 16
// dims, kHalves steps per 16 keys (Dh <= kHalves * kVP * 16); the next
// step's V fragments (ldmatrix.trans) load while this one multiplies.
// bv[0] holds the first step's, loaded by the caller.
template <int kHalves, int kDh, int kKB, int kVP>
__device__ __forceinline__ void pv_bf16(float (&o)[kDh / 8][4],
                                        const float (&s)[kKB / 8][4],
                                        uint32_t (&bv)[2][kVP][4],
                                        const bf16* va, int ld, int nk) {
  constexpr int kSteps = kKB / 16 * kHalves;
  uint32_t pa[4];
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int kk = st / kHalves, d0 = (st % kHalves) * kVP;
    const int nx = st + 1, nkk = nx / kHalves, nd0 = (nx % kHalves) * kVP;
    if (nx < kSteps) {
#pragma unroll
      for (int dp = 0; dp < kVP; ++dp)
        if (nd0 + dp < nk)
          ldsm_x4_t(bv[nx & 1][dp], va + nkk * 16 * ld + (nd0 + dp) * 16);
    }
    if (d0 == 0) {
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < kVP; ++dp) {
      if (d0 + dp < nk) {
        mma_bf16(o[2 * (d0 + dp)], pa, bv[st & 1][dp][0], bv[st & 1][dp][1]);
        mma_bf16(o[2 * (d0 + dp) + 1], pa, bv[st & 1][dp][2],
                 bv[st & 1][dp][3]);
      }
    }
  }
}

// q/out (B, S, H, Dh), k/v (B, S, KV, Dh), contiguous, Dh <= kDh.  Grid:
// (query tiles, B * H); the heaviest (last) query tiles start first.
template <int kDh>
__global__ void __launch_bounds__(bf16_threads(kDh), bf16_min_ctas(kDh))
flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int S, int H, int KV,
    int Dh, int window, float softcap, float scale) {
  constexpr int kThreads = bf16_threads(kDh), kQB = bf16_qb(kDh);
  constexpr int kKB = bf16_kb(kDh), kNT = kKB / 8;
  // Q's fragments held in registers for the whole CTA up to 128 dims (else
  // read from shared memory each step); 16-dim pairs of 8-dim output tiles
  // a P.V step
  constexpr bool kQInRegs = kDh <= 128;
  constexpr int kVP = kQInRegs ? 4 : 2;
  static_assert(!kQInRegs || kQB <= 2 * kKB, "Q's tile fits a K/V buffer");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_elems(Dh, 2);
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // buffer b: K at sk + b *
  bf16* sv = sk + kKB * ld;                      // 2 * kKB * ld, V after it
  // Q: in buffer 1 before its fill where it goes to registers, else after
  // both buffers
  bf16* sq = sk + (kQInRegs ? 2 : 4) * kKB * ld;

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;       // mma fragment row / pair
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix matrix / row
  const int nk = Dh / 16;
  const long long qs = (long long)H * Dh, ks = (long long)KV * Dh;
  const bf16* qb = q + ((long long)b * S * H + h) * Dh;
  const bf16* kb = k + ((long long)b * S * KV + kvh) * Dh;
  const bf16* vb = v + ((long long)b * S * KV + kvh) * Dh;

  const KeyRange keys = key_range(q0, S, window, kQB, kKB);
  const int k_begin = keys.begin, k_end = keys.end;
  load_rows<bf16, kThreads, kQB, kDh>(sq, ld, qb, qs, q0, S, Dh);
  load_rows<bf16, kThreads, kKB, kDh>(sk, ld, kb, ks, k_begin, S, Dh);
  load_rows<bf16, kThreads, kKB, kDh>(sv, ld, vb, ks, k_begin, S, Dh);
  cp_commit();

  const int wq0 = q0 + 16 * warp;                // the warp's first row
  const int row0 = wq0 + g, row1 = row0 + 8;
  const float sl = scale * kLog2e, sc = softcap > 0.f ? scale / softcap : 0.f;
  // Q's fragments: every 16-dim step's, or two steps' loaded in turn
  uint32_t qf[kQInRegs ? kDh / 16 : 2][4];
  float o[kDh / 8][4];
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int buf = 0;
  for (int kt = k_begin; kt < k_end; kt += kKB, buf ^= 1) {
    // tile kt has landed, and every warp is done with the other buffer
    cp_wait<0>();
    __syncthreads();
    if (kQInRegs && kt == k_begin) {      // Q into registers, then its
#pragma unroll                             // buffer is free
      for (int kk = 0; kk < kDh / 16; ++kk)
        if (kk < nk)
          ldsm_x4(qf[kk], sq + (16 * warp + mr + (mi & 1) * 8) * ld + kk * 16 +
                              (mi >> 1) * 8);
      __syncthreads();
    }
    if (kt + kKB < k_end) {
      load_rows<bf16, kThreads, kKB, kDh>(sk + (buf ^ 1) * 2 * kKB * ld, ld,
                                          kb, ks, kt + kKB, S, Dh);
      load_rows<bf16, kThreads, kKB, kDh>(sv + (buf ^ 1) * 2 * kKB * ld, ld,
                                          vb, ks, kt + kKB, S, Dh);
      cp_commit();
    }
    // a tile the masks empty for all of this warp's rows adds nothing
    const bool empty = kt > wq0 + 15 ||
                       (window > 0 && wq0 - (kt + kKB - 1) >= window);
    if (!empty) {
      const bf16* kt_s = sk + buf * 2 * kKB * ld;
      const bf16* vt_s = sv + buf * 2 * kKB * ld;
      float s[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      // Q.K^T; the K (and, from shared memory, Q) fragments of dim step
      // kk + 1 load while step kk multiplies
      const bf16* ka = kt_s + (mr + (mi >> 1) * 8) * ld + (mi & 1) * 8;
      const bf16* qa =
          sq + (16 * warp + mr + (mi & 1) * 8) * ld + (mi >> 1) * 8;
      uint32_t bk[2][kNT / 2][4];
      if (!kQInRegs) ldsm_x4(qf[0], qa);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np)
        ldsm_x4(bk[0][np], ka + np * 16 * ld);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        if (kk < nk) {
          if (kk + 1 < nk) {
            if (!kQInRegs) ldsm_x4(qf[(kk + 1) & 1], qa + (kk + 1) * 16);
#pragma unroll
            for (int np = 0; np < kNT / 2; ++np)
              ldsm_x4(bk[(kk + 1) & 1][np], ka + np * 16 * ld + (kk + 1) * 16);
          }
          const uint32_t(&af)[4] = qf[kQInRegs ? kk : kk & 1];
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            mma_bf16(s[2 * np], af, bk[kk & 1][np][0], bk[kk & 1][np][1]);
            mma_bf16(s[2 * np + 1], af, bk[kk & 1][np][2], bk[kk & 1][np][3]);
          }
        }
      }
      // the first V fragments load during the softmax
      const bf16* va = vt_s + (mr + (mi & 1) * 8) * ld + (mi >> 1) * 8;
      uint32_t bv[2][kVP][4];
#pragma unroll
      for (int dp = 0; dp < kVP; ++dp)
        if (dp < nk) ldsm_x4_t(bv[0][dp], va + dp * 16);
      // scores in log2 units, masked ones -inf
      const bool full = kt + kKB - 1 <= wq0 && kt + kKB <= S &&
                        (window <= 0 || wq0 + 15 - kt < window);
      // logits: the softcap's, in log2 units; without it s itself, scaled
      // by sl = scale * log2(e) in the exponent (max and scale commute)
      const float ls2 = softcap > 0.f ? 1.f : sl;
      if (softcap > 0.f) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] = softcap * tanhf(s[nt][e] * sc) * kLog2e;
      }
      if (!full) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kt + nt * 8 + 2 * tig + (e & 1);
            const int row = e < 2 ? row0 : row1;
            const bool ok =
                key <= row && key < S && (window <= 0 || row - key < window);
            s[nt][e] = ok ? s[nt][e] : -INFINITY;
          }
        }
      }
      // the rows' maxima, as a tree
      float mx[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        mx[nt][0] = fmaxf(s[nt][0], s[nt][1]);
        mx[nt][1] = fmaxf(s[nt][2], s[nt][3]);
      }
#pragma unroll
      for (int w = 1; w < kNT; w *= 2)
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2 * w) {
          mx[nt][0] = fmaxf(mx[nt][0], mx[nt + w][0]);
          mx[nt][1] = fmaxf(mx[nt][1], mx[nt + w][1]);
        }
      const float mn0 = fmaxf(m0, quad_max(mx[0][0]) * ls2);
      const float mn1 = fmaxf(m1, quad_max(mx[0][1]) * ls2);
      // a row with nothing unmasked yet keeps m = -inf; subtract 0 then
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      // rescale only where a row's maximum moved (else alpha is 1)
      if (__any_sync(0xffffffffu, mn0 != m0 || mn1 != m1)) {
        const float a0 = exp2f(m0 - mu0), a1 = exp2f(m1 - mu1);
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int i = 0; i < kDh / 8; ++i) {
          o[i][0] *= a0;
          o[i][1] *= a0;
          o[i][2] *= a1;
          o[i][3] *= a1;
        }
      }
      m0 = mn0;
      m1 = mn1;
      float ls[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        s[nt][0] = exp2f(s[nt][0] * ls2 - mu0);
        s[nt][1] = exp2f(s[nt][1] * ls2 - mu0);
        s[nt][2] = exp2f(s[nt][2] * ls2 - mu1);
        s[nt][3] = exp2f(s[nt][3] * ls2 - mu1);
        ls[nt][0] = s[nt][0] + s[nt][1];
        ls[nt][1] = s[nt][2] + s[nt][3];
      }
#pragma unroll
      for (int w = 1; w < kNT; w *= 2)
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2 * w) {
          ls[nt][0] += ls[nt + w][0];
          ls[nt][1] += ls[nt + w][1];
        }
      l0 += ls[0][0];
      l1 += ls[0][1];
      // P (bf16, in registers) . V; past 128 dims always the full steps
      if (kDh > 128 || nk > kVP)
        pv_bf16<kDh / 16 / kVP, kDh, kKB, kVP>(o, s, bv, va, ld, nk);
      else
        pv_bf16<1, kDh, kKB, kVP>(o, s, bv, va, ld, nk);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + ((long long)b * S * H + h) * Dh + 2 * tig;
#pragma unroll
  for (int i = 0; i < kDh / 8; ++i) {
    if (i < Dh / 8) {
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * qs + i * 8) =
            pack_bf16(o[i][0] * inv0, o[i][1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + row1 * qs + i * 8) =
            pack_bf16(o[i][2] * inv1, o[i][3] * inv1);
    }
  }
}

// ---- fp32 on the CUDA cores ---------------------------------------------
__device__ __forceinline__ void fma4(float& acc, float4 a, float4 b) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
}

__device__ __forceinline__ void axpy4(float4& acc, float p, float4 v) {
  acc.x += p * v.x;
  acc.y += p * v.y;
  acc.z += p * v.z;
  acc.w += p * v.w;
}

template <int kDh>
__global__ void __launch_bounds__(kF32Threads, f32_min_ctas(kDh))
flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S, int H,
    int KV, int Dh, int window, float softcap, float scale) {
  constexpr int kQB = kF32QB, kKB = kF32KB;
  constexpr int kKC = kKB / 8;                   // keys of a thread's S tile
  constexpr int kLdP = kKB + 8;                  // row of the P tile (floats)
  constexpr int kOC = kDh / 32;                  // float4 slices of O a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = row_elems(Dh, 4);
  float* sq = reinterpret_cast<float*>(smem_raw);
  float* sk = sq + kQB * ld;                     // [2][kKB][ld]
  float* sv = sk + 2 * kKB * ld;                 // [2][kKB][ld]
  float* sp = sv + 2 * kKB * ld;                 // [kQB][kLdP]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 7, ty = 4 * warp + (lane >> 3);
  const int d4 = Dh / 4;
  const long long qs = (long long)H * Dh, ks = (long long)KV * Dh;
  const float* qb = q + ((long long)b * S * H + h) * Dh;
  const float* kb = k + ((long long)b * S * KV + kvh) * Dh;
  const float* vb = v + ((long long)b * S * KV + kvh) * Dh;

  const KeyRange keys = key_range(q0, S, window, kQB, kKB);
  const int k_begin = keys.begin, k_end = keys.end;
  load_rows<float, kF32Threads, kQB, kDh>(sq, ld, qb, qs, q0, S, Dh);
  load_rows<float, kF32Threads, kKB, kDh>(sk, ld, kb, ks, k_begin, S, Dh);
  load_rows<float, kF32Threads, kKB, kDh>(sv, ld, vb, ks, k_begin, S, Dh);
  cp_commit();

  const float sc = softcap > 0.f ? scale / softcap : 0.f;
  float4 o[4][kOC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[r][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int buf = 0;
  for (int kt = k_begin; kt < k_end; kt += kKB, buf ^= 1) {
    // tile kt has landed, and every warp is done with the other buffer
    cp_wait<0>();
    __syncthreads();
    if (kt + kKB < k_end) {
      load_rows<float, kF32Threads, kKB, kDh>(sk + (buf ^ 1) * kKB * ld, ld,
                                              kb, ks, kt + kKB, S, Dh);
      load_rows<float, kF32Threads, kKB, kDh>(sv + (buf ^ 1) * kKB * ld, ld,
                                              vb, ks, kt + kKB, S, Dh);
      cp_commit();
    }
    const float* kt_s = sk + buf * kKB * ld;
    const float* vt_s = sv + buf * kKB * ld;

    float s[4][kKC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kKC; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; d += 4) {
      float4 qa[4], kk[kKC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(sq + (ty + 16 * r) * ld + d);
#pragma unroll
      for (int c = 0; c < kKC; ++c)
        kk[c] = *reinterpret_cast<const float4*>(kt_s + (tx + 8 * c) * ld + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kKC; ++c) fma4(s[r][c], qa[r], kk[c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        const int key = kt + tx + 8 * c;
        float x = softcap > 0.f ? softcap * tanhf(s[r][c] * sc)
                                : s[r][c] * scale;
        const bool ok =
            key <= row && key < S && (window <= 0 || row - key < window);
        s[r][c] = ok ? x : -INFINITY;
        mt = fmaxf(mt, s[r][c]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float mn = fmaxf(m[r], mt);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = expf(m[r] - mu);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        o[r][c].x *= alpha;
        o[r][c].y *= alpha;
        o[r][c].z *= alpha;
        o[r][c].w *= alpha;
      }
#pragma unroll
      for (int c = 0; c < kKC; ++c) {
        const float p = expf(s[r][c] - mu);
        l[r] += p;
        sp[(ty + 16 * r) * kLdP + tx + 8 * c] = p;
      }
    }
    __syncwarp();   // a row's P is written and read by the same warp

#pragma unroll 2
    for (int j = 0; j < kKB; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pr[r] = *reinterpret_cast<const float4*>(sp + (ty + 16 * r) * kLdP + j);
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        if (tx + 8 * c < d4) {
          const float* vr = vt_s + j * ld + 4 * (tx + 8 * c);
          const float4 v0 = *reinterpret_cast<const float4*>(vr);
          const float4 v1 = *reinterpret_cast<const float4*>(vr + ld);
          const float4 v2 = *reinterpret_cast<const float4*>(vr + 2 * ld);
          const float4 v3 = *reinterpret_cast<const float4*>(vr + 3 * ld);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            axpy4(o[r][c], pr[r].x, v0);
            axpy4(o[r][c], pr[r].y, v1);
            axpy4(o[r][c], pr[r].z, v2);
            axpy4(o[r][c], pr[r].w, v3);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int row = q0 + ty + 16 * r;
    if (row < S) {
      float* orow = out + ((long long)b * S * H + h) * Dh + row * qs;
#pragma unroll
      for (int c = 0; c < kOC; ++c)
        if (tx + 8 * c < d4)
          *reinterpret_cast<float4*>(orow + 4 * (tx + 8 * c)) =
              make_float4(o[r][c].x * inv, o[r][c].y * inv, o[r][c].z * inv,
                          o[r][c].w * inv);
    }
  }
}

}  // namespace

// The launch configuration the launcher uses for (is_bf16, Dh, B, S, H):
// out[0..4] = query rows per CTA, keys per tile, dynamic shared memory
// bytes, grid x, grid y.
extern "C" void flash_attention_config(int is_bf16, int Dh, int B, int S, int H,
                                       long long* out) {
  const int qb = is_bf16 ? bf16_qb(Dh) : kF32QB;
  out[0] = qb;
  out[1] = is_bf16 ? bf16_kb(Dh) : kF32KB;
  out[2] = is_bf16 ? bf16_smem(Dh) : f32_smem(Dh);
  out[3] = (S + qb - 1) / qb;
  out[4] = (long long)B * H;
}

// The key tiles the CTA of query rows [q0, q0 + query rows) loads at head
// dim Dh: out[0] = first key of the first tile, out[1] = one past the
// last key.
extern "C" void flash_attention_key_range(int is_bf16, int Dh, int q0, int S,
                                          int window, long long* out) {
  const KeyRange r =
      is_bf16 ? key_range(q0, S, window, bf16_qb(Dh), bf16_kb(Dh))
              : key_range(q0, S, window, kF32QB, kF32KB);
  out[0] = r.begin;
  out[1] = r.end;
}

namespace {
// Set the kernel's shared memory, launch it on E-typed tensors.
template <typename E>
int launch(void (*kernel)(const E*, const E*, const E*, E*, int, int, int,
                          int, int, float, float),
           dim3 grid, int threads, int smem, cudaStream_t stream,
           const void* q, const void* k, const void* v, void* out, int S,
           int H, int KV, int Dh, int window, float softcap, float scale) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(out), S, H, KV, Dh, window,
      softcap, scale);
  return (int)cudaGetLastError();
}
}  // namespace

// Dh a multiple of 16 up to 256 (the instantiation for 128 up to 128, the
// one for 256 past it), H a multiple of KV, 16-byte aligned pointers (the
// wrapper checks).  is_bf16 != 0: all four tensors bf16, else fp32.
// window 0 = global; softcap 0 = none.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KV, int Dh, int window,
                                      float softcap, float scale, int is_bf16,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  long long cfg[5];
  flash_attention_config(is_bf16, Dh, B, S, H, cfg);
  const dim3 grid((unsigned)cfg[3], (unsigned)cfg[4]);
  const int smem = (int)cfg[2];
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = Dh > 128;
  if (is_bf16)
    return wide ? launch(flash_attention_bf16_kernel<256>, grid,
                         bf16_threads(256), smem, st, q, k, v, out, S, H, KV,
                         Dh, window, softcap, scale)
                : launch(flash_attention_bf16_kernel<128>, grid,
                         bf16_threads(128), smem, st, q, k, v, out, S, H, KV,
                         Dh, window, softcap, scale);
  return wide ? launch(flash_attention_f32_kernel<256>, grid, kF32Threads,
                       smem, st, q, k, v, out, S, H, KV, Dh, window, softcap,
                       scale)
              : launch(flash_attention_f32_kernel<128>, grid, kF32Threads,
                       smem, st, q, k, v, out, S, H, KV, Dh, window, softcap,
                       scale);
}
