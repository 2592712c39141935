// Phase II of a TensoRF VM field in one launch, for Hopper (sm_90a), fp32.
//
// Replaces no TPU kernel (the JAX package has no VM field): it is
// fused_march.cu's counterpart for core/tensorf.py, with its contract and
// its schedule.  One persistent CTA per SM (a cooperative launch) walks the
// chunk steps of the longest budget; its warp groups of 128 threads take
// units (32 rays of one block) from a counter, skip blocks that are past
// their budget or whose rays all saturated, and a grid barrier ends a step.
// A unit that leaves a ray alive raises its block's flag to ci + 1.
//
// A unit walks its chunk as tiles of its 32 rays at one sample index.  In
// the gathers four threads share a ray (lanes 4r .. 4r + 3 of a warp):
// thread q reads float4 q, q + 4, ... of each tap's channels (planes
// (H, W, C) and lines (H, C), channels innermost), so a warp's four
// threads of one ray read 64 contiguous bytes of a texel.
//
// - Density, every valid sample inside the cube: the three plane / line
//   pairs at bilinear / linear taps (grid_sample's weights, align_corners,
//   zero padding), each thread summing plane x line over its components,
//   the four partials joined by two xor shuffles as (p0 + p1) + (p2 + p3);
//   sigma = sigma_scale * softplus(f + density_shift).
// - Appearance, on the anchor tiles some sample of the chunk needs (the
//   last valid sample's right anchor too, past the budget): the same
//   threads write the 3 ca plane x line products into the tile's k-major
//   activations; the group runs the bias-free basis (__fmaf_rn) and writes
//   its outputs and their PE (sinf, cosf), copies in the rays' view rows,
//   then the biased chain mlp_in -> hidden -> hidden -> 3 (__fmaf_rn, the
//   bias added after the sum), ReLU, and a sigmoid into the anchor's
//   colour slot.  An anchor no sample needs reads as colour 0.
// - The composite, one thread per ray (the group's first warp), steps its
//   serial sums in sample order once the group's right anchor is known,
//   as fused_march.cu does.
//
// Bound: the appearance chain's operations on the anchors (~82 kFLOP an
// anchor at VM-192) and the taps (1.15 KB a sample of density, 3.5 KB an
// anchor of appearance; the 17.3 MB density tensor stays in L2, the
// 51.8 MB appearance tensor does not).  The basis and chain weights sit in
// dynamic shared memory.  Per-ray state lives in the output rows across
// steps, read and written through L2.
//
// Output rows (N*B, 8): [acc, r, g, b, depth, block_chunks, ray_chunks, 0];
// anchors (N,): ray-anchors evaluated per block, also added to a 64-bit
// running total the caller keeps across launches.
//
// Two warp groups a CTA: at VM-192 the weights and two groups' buffers
// take ~213 KB of the 227 KB of shared memory, and a third does not fit.
#include "common.cuh"

namespace {

using asdr::kColGroups;
using asdr::kGroupThreads;
using asdr::kRowGroups;
using asdr::kTileRows;
using asdr::kTR;

constexpr int kMaxChunk = 64;
constexpr int kSyncWords = 4;
constexpr int kLanes = 4;
constexpr int kGroups = 2;

struct VMArgs {
  const float* o;        // (N*B, 3)
  const float* d;        // (N*B, 3)
  const float* view;     // (N*B, V) or null when !with_color
  const int* budgets;    // (N,)
  const float* dplane;   // three (H, W, cd) planes
  const float* dline;    // three (H, cd) lines
  const float* aplane;   // three (H, W, ca) planes
  const float* aline;    // three (H, ca) lines
  const float* w;        // basis (3 ca, app), w1, b1, w2, b2, w3, b3
  float* out;            // (N*B, 8), zeroed
  unsigned* sync;        // (kSyncWords + N,), zeroed
  int* anchors;          // (N,), zeroed
  unsigned long long* anchor_total;   // (1,), added to
  int N, B, chunk, group, cd, ca, app, hid, mlp_in, fea_pe, view_pe, V;
  int res[3];
  int early_term, white_background, with_color, per_ray_exit;
  int o_w1, o_b1, o_w2, o_b2, o_w3, o_b3, n_w, act_g, raw_g, smem;
  float near, span, far, log_eps_t, sigma_scale, density_shift;
};

// TensoRF's matMode [[0,1],[0,2],[1,2]] and vecMode [2,1,0].
__device__ __forceinline__ int mat0(int i) { return i == 2 ? 1 : 0; }
__device__ __forceinline__ int mat1(int i) { return i == 0 ? 1 : 2; }
__device__ __forceinline__ int vec(int i) { return 2 - i; }

// A normalized coordinate's texels along an axis of ``size`` texels, as
// grid_sample (align_corners) forms them: i0 = floor(u), weights
// (i0 + 1 - u) and (u - i0), each texel in or out of the tensor.
struct Lin {
  int i0;
  float w0, w1;
  bool ok0, ok1;
};

__device__ __forceinline__ Lin lin(float xn, int size) {
  const float u = ((xn + 1.f) / 2.f) * (float)(size - 1);
  const float fl = floorf(u);
  Lin L;
  L.i0 = (int)fl;
  L.w0 = (fl + 1.f) - u;
  L.w1 = u - fl;
  L.ok0 = L.i0 >= 0 && L.i0 < size;
  L.ok1 = L.i0 >= -1 && L.i0 + 1 < size;
  return L;
}

__device__ __forceinline__ float4 tap4(const float* tab, long long texel,
                                       int C, int c4, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(tab + texel * C) + c4);
}

// Float4 c4 of a plane (H, W, C) at texels X (along W) and Y (along H):
// 0 + nw + ne + sw + se, each corner times its weight, in that order.
__device__ __forceinline__ float4 plane4(const float* tab, const Lin& X,
                                         const Lin& Y, int W, int C, int c4) {
  const float wnw = X.w0 * Y.w0, wne = X.w1 * Y.w0;
  const float wsw = X.w0 * Y.w1, wse = X.w1 * Y.w1;
  const long long r0 = (long long)Y.i0 * W, r1 = r0 + W;
  const float4 a = tap4(tab, r0 + X.i0, C, c4, X.ok0 && Y.ok0);
  const float4 b = tap4(tab, r0 + X.i0 + 1, C, c4, X.ok1 && Y.ok0);
  const float4 c = tap4(tab, r1 + X.i0, C, c4, X.ok0 && Y.ok1);
  const float4 e = tap4(tab, r1 + X.i0 + 1, C, c4, X.ok1 && Y.ok1);
  float4 v;
  v.x = a.x * wnw; v.x = v.x + b.x * wne; v.x = v.x + c.x * wsw;
  v.x = v.x + e.x * wse;
  v.y = a.y * wnw; v.y = v.y + b.y * wne; v.y = v.y + c.y * wsw;
  v.y = v.y + e.y * wse;
  v.z = a.z * wnw; v.z = v.z + b.z * wne; v.z = v.z + c.z * wsw;
  v.z = v.z + e.z * wse;
  v.w = a.w * wnw; v.w = v.w + b.w * wne; v.w = v.w + c.w * wsw;
  v.w = v.w + e.w * wse;
  return v;
}

// Float4 c4 of a line (H, C) at texels Z.
__device__ __forceinline__ float4 line4(const float* tab, const Lin& Z,
                                        int C, int c4) {
  const float4 a = tap4(tab, Z.i0, C, c4, Z.ok0);
  const float4 b = tap4(tab, Z.i0 + 1, C, c4, Z.ok1);
  float4 v;
  v.x = a.x * Z.w0; v.x = v.x + b.x * Z.w1;
  v.y = a.y * Z.w0; v.y = v.y + b.y * Z.w1;
  v.z = a.z * Z.w0; v.z = v.z + b.z * Z.w1;
  v.w = a.w * Z.w0; v.w = v.w + b.w * Z.w1;
  return v;
}

// The act rows [0, N) = relu(x @ W + b) for the group's tile, in place
// (x = act's first K rows): asdr::tile_relu_tc with a bias added after
// each sum.
template <int TC>
__device__ __forceinline__ void bias_relu_tc(const float* W, const float* b,
                                             int K, int N, float* act) {
  const int t = asdr::group_tid();
  const int r0 = kTR * (t % kRowGroups), c0 = TC * (t / kRowGroups);
  float acc[kTR][TC];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  if (c0 < N) asdr::tile_mac<asdr::Fma, TC>(W, K, N, act, r0, c0, acc);
  asdr::group_sync();
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    if (c0 + j < N) {
      const float bj = b[c0 + j];
#pragma unroll
      for (int q = 0; q < kTR / 4; ++q)
        *reinterpret_cast<float4*>(act + (c0 + j) * kTileRows + r0 + 4 * q) =
            make_float4(fmaxf(acc[4 * q][j] + bj, 0.f),
                        fmaxf(acc[4 * q + 1][j] + bj, 0.f),
                        fmaxf(acc[4 * q + 2][j] + bj, 0.f),
                        fmaxf(acc[4 * q + 3][j] + bj, 0.f));
    }
  }
  asdr::group_sync();
}

__device__ __forceinline__ void bias_relu(const float* W, const float* b,
                                          int K, int N, float* act) {
  if (N <= 4 * kColGroups)
    bias_relu_tc<4>(W, b, K, N, act);
  else
    bias_relu_tc<8>(W, b, K, N, act);
}

// The basis on the group's tile of K products (act rows [0, K)), in place:
// feature c of row r to act row c, its PE at frequency 2^f to rows
// sin0 + c fea_pe + f and cos0 + c fea_pe + f.  At most 2 kColGroups
// features: columns c and c + kColGroups a thread, kTR rows.
__device__ __forceinline__ void basis_pe(const float* Wb, int K, int A,
                                         int fea_pe, float* act) {
  const int t = asdr::group_tid();
  const int r0 = kTR * (t % kRowGroups), cb = t / kRowGroups;
  float acc[2][kTR][1];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < kTR; ++i) acc[h][i][0] = 0.f;
    if (cb + h * kColGroups < A)
      asdr::tile_mac<asdr::Fma, 1>(Wb, K, A, act, r0, cb + h * kColGroups,
                                   acc[h]);
  }
  asdr::group_sync();
  const int sin0 = A + 3, cos0 = A + 3 + A * fea_pe;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = cb + h * kColGroups;
    if (c >= A) continue;
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = r0 + i;
      const float y = acc[h][i][0];
      act[c * kTileRows + r] = y;
      for (int f = 0; f < fea_pe; ++f) {
        const float x = y * (float)(1 << f);
        act[(sin0 + c * fea_pe + f) * kTileRows + r] = sinf(x);
        act[(cos0 + c * fea_pe + f) * kTileRows + r] = cosf(x);
      }
    }
  }
}

__device__ __forceinline__ int n_chunks(const VMArgs& a, int blk) {
  return (a.budgets[blk] + a.chunk - 1) / a.chunk;
}

__device__ __forceinline__ bool block_runs(const VMArgs& a, int blk, int ci) {
  return ci < n_chunks(a, blk) &&
         (!a.early_term || ci == 0 ||
          (int)__ldcg(a.sync + kSyncWords + blk) >= ci);
}

// All CTAs wait here until every one has arrived (fused_march.cu's).
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// A ray's composite sums over one chunk (threads q == 0 of a group).
struct Sums {
  float incl, acc, dep, r, g, b;
};

// Samples [j0, j1) of chunk ci into ray r's sums, in sample order, the
// colour lerped between anchor slots cl and cr (none where cl is null).
// A function and not a lambda over the caller's locals, so that nothing
// of the state takes the stack.
__device__ __forceinline__ void composite(const VMArgs& a, Sums& s,
                                          const float* sig, int r, int ci,
                                          float delta_t, float log_t, int j0,
                                          int j1, const float* cl,
                                          const float* cr) {
  const int C = a.chunk, grp = a.group;
  for (int j = j0; j < j1; ++j) {
    const int idx = ci * C + j;
    const float t = a.near + ((float)idx + 0.5f) * delta_t;
    const float alpha = 1.f - expf(-sig[j * kTileRows + r] * delta_t);
    const float ls = logf(fminf(fmaxf(1.f - alpha, 1e-10f), 1.f));
    s.incl = s.incl + ls;
    const float intra = s.incl - ls;
    const float w = expf(log_t + intra) * alpha;
    s.acc = s.acc + w;
    s.dep = s.dep + w * t;
    if (cl != nullptr) {
      const float tt = (float)(j % grp) / (float)grp;
      const float l0 = cl[r], l1 = cl[kTileRows + r];
      const float l2 = cl[2 * kTileRows + r];
      s.r = s.r + w * (l0 + (cr[r] - l0) * tt);
      s.g = s.g + w * (l1 + (cr[kTileRows + r] - l1) * tt);
      s.b = s.b + w * (l2 + (cr[2 * kTileRows + r] - l2) * tt);
    }
  }
}

// Chunk ci of rays [blk * B + 32 * slab, + nr) by the calling group.
__device__ __forceinline__ void march_unit(const VMArgs& a, const float* sw,
                                           float* act, float* scr, int blk,
                                           int slab, int ci) {
  const int gt = asdr::group_tid();
  const int r = gt % kTileRows, q = gt / kTileRows;   // composite mapping
  const int gr = gt / kLanes, ql = gt % kLanes;       // gather mapping
  const int C = a.chunk, grp = a.group, A = (C + grp - 1) / grp;
  const int budget = a.budgets[blk];
  const float delta_t = a.span / (float)budget;
  const int nr = min(kTileRows, a.B - kTileRows * slab);
  const long long ray0 = (long long)blk * a.B + kTileRows * slab;
  // the chunk's valid samples and the anchors they need
  const int v = min(C, budget - ci * C);
  const int last = (v - 1) / grp;
  const bool extra = (v - 1) % grp != 0 && last + 1 < A;
  float* sig = scr;                        // [j][row]
  float* col = sig + C * kTileRows;        // [anchor & 1][channel][row]
  float* vk = col + 6 * kTileRows;         // [s][row], the view rows
  int* alive = (int*)(vk + a.V * kTileRows);

  // the ray of gather row gr
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (gr < nr) {
    const float* po = a.o + (ray0 + gr) * 3;
    const float* pd = a.d + (ray0 + gr) * 3;
    ox = po[0]; oy = po[1]; oz = po[2];
    dx = pd[0]; dy = pd[1]; dz = pd[2];
  }
  float* st = a.out + (ray0 + r) * 8;
  float log_t = 0.f;
  if (q == 0) {
    if (r < nr) log_t = __ldcg(st + 7);
    alive[r] = r < nr && log_t > a.log_eps_t;
  }
  if (a.with_color)
    for (int i = gt; i < a.V * kTileRows; i += kGroupThreads) {
      const int s = i / kTileRows, rr = i - s * kTileRows;
      vk[i] = rr < nr ? a.view[(ray0 + rr) * a.V + s] : 0.f;
    }
  asdr::group_sync();
  if (a.per_ray_exit) {
    int any = 0;
    for (int i = 0; i < kTileRows; ++i) any |= alive[i];
    if (!any) return;
  }

  // composite sums of ray r (threads q == 0)
  Sums sums = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  const int K = 3 * a.ca;
  for (int j = 0; j < C; ++j) {
    const bool valid = j < v, anchor = (j % grp) == 0;
    const int m = j / grp;
    const float t = a.near + ((float)(ci * C + j) + 0.5f) * delta_t;
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    const float xn[3] = {px * 2.f - 1.f, py * 2.f - 1.f, pz * 2.f - 1.f};
    if (valid) {
      const bool keep = gr < nr && px >= 0.f && px <= 1.f && py >= 0.f &&
                        py <= 1.f && pz >= 0.f && pz <= 1.f &&
                        (!a.per_ray_exit || alive[gr]);
      float part = 0.f;
      if (keep) {
        long long poff = 0, loff = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int W = a.res[mat0(i)], H = a.res[mat1(i)];
          const int Lr = a.res[vec(i)];
          const Lin X = lin(xn[mat0(i)], W), Y = lin(xn[mat1(i)], H);
          const Lin Z = lin(xn[vec(i)], Lr);
          for (int c4 = ql; c4 < a.cd / 4; c4 += kLanes) {
            const float4 pv = plane4(a.dplane + poff, X, Y, W, a.cd, c4);
            const float4 lv = line4(a.dline + loff, Z, a.cd, c4);
            part = part + pv.x * lv.x;
            part = part + pv.y * lv.y;
            part = part + pv.z * lv.z;
            part = part + pv.w * lv.w;
          }
          poff += (long long)W * H * a.cd;
          loff += (long long)Lr * a.cd;
        }
      }
      part = part + __shfl_xor_sync(0xffffffffu, part, 1);
      part = part + __shfl_xor_sync(0xffffffffu, part, 2);
      if (ql == 0) {
        const float x = part + a.density_shift;
        const float sp = x > 20.f ? x : log1pf(expf(x));
        sig[j * kTileRows + gr] = keep ? a.sigma_scale * sp : 0.f;
      }
    } else if (ql == 0) {
      sig[j * kTileRows + gr] = 0.f;
    }
    if (!(a.with_color && anchor)) continue;
    float* cm = col + (m & 1) * 3 * kTileRows;
    if (m <= last || (extra && m == last + 1)) {
      // the appearance products, k-major: row i ca + c
      long long poff = 0, loff = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int W = a.res[mat0(i)], H = a.res[mat1(i)];
        const int Lr = a.res[vec(i)];
        const Lin X = lin(xn[mat0(i)], W), Y = lin(xn[mat1(i)], H);
        const Lin Z = lin(xn[vec(i)], Lr);
        for (int c4 = ql; c4 < a.ca / 4; c4 += kLanes) {
          const float4 pv = plane4(a.aplane + poff, X, Y, W, a.ca, c4);
          const float4 lv = line4(a.aline + loff, Z, a.ca, c4);
          float* dst = act + (i * a.ca + 4 * c4) * kTileRows + gr;
          dst[0] = pv.x * lv.x;
          dst[kTileRows] = pv.y * lv.y;
          dst[2 * kTileRows] = pv.z * lv.z;
          dst[3 * kTileRows] = pv.w * lv.w;
        }
        poff += (long long)W * H * a.ca;
        loff += (long long)Lr * a.ca;
      }
      asdr::group_sync();
      basis_pe(sw, K, a.app, a.fea_pe, act);
      // the view rows: [d] after the features, [sin, cos PE(d)] last
      const int pe_end = a.app + 3 + 2 * a.app * a.fea_pe;
      for (int i = gt; i < a.V * kTileRows; i += kGroupThreads) {
        const int s = i / kTileRows, rr = i - s * kTileRows;
        act[(s < 3 ? a.app + s : pe_end + s - 3) * kTileRows + rr] = vk[i];
      }
      asdr::group_sync();
      bias_relu(sw + a.o_w1, sw + a.o_b1, a.mlp_in, a.hid, act);
      bias_relu(sw + a.o_w2, sw + a.o_b2, a.hid, a.hid, act);
      const float* w3 = sw + a.o_w3;
      const float* b3 = sw + a.o_b3;
      for (int o = gt; o < kTileRows * 3; o += kGroupThreads) {
        const int rr = o / 3, c = o - rr * 3;
        float s = 0.f;
#pragma unroll 8
        for (int k = 0; k < a.hid; ++k)
          s = __fmaf_rn(act[k * kTileRows + rr], w3[k * 3 + c], s);
        cm[c * kTileRows + rr] = asdr::sigmoid(s + b3[c]);
      }
    } else {
      // no sample lerps towards it; wait for the composite that may still
      // read this slot as its left anchor
      asdr::group_sync();
      for (int i = gt; i < 3 * kTileRows; i += kGroupThreads) cm[i] = 0.f;
    }
    asdr::group_sync();
    if (m > 0 && q == 0)
      composite(a, sums, sig, r, ci, delta_t, log_t, (m - 1) * grp, m * grp,
                col + ((m - 1) & 1) * 3 * kTileRows, cm);
  }
  // the last samples' sigmas were written by the gather threads
  asdr::group_sync();
  if (a.with_color && gt == 0) {
    const int n = (last + 1 + (extra ? 1 : 0)) * nr;
    atomicAdd(a.anchors + blk, n);
    atomicAdd(a.anchor_total, (unsigned long long)n);
  }
  if (q != 0) return;
  if (a.with_color) {
    const float* cl = col + ((A - 1) & 1) * 3 * kTileRows;
    composite(a, sums, sig, r, ci, delta_t, log_t, (A - 1) * grp, C, cl, cl);
  } else {
    composite(a, sums, sig, r, ci, delta_t, log_t, 0, C, nullptr, nullptr);
  }
  const float lt = log_t + sums.incl;
  if (r < nr) {
    __stcg(st + 0, __ldcg(st + 0) + sums.acc);
    if (a.with_color) {
      __stcg(st + 1, __ldcg(st + 1) + sums.r);
      __stcg(st + 2, __ldcg(st + 2) + sums.g);
      __stcg(st + 3, __ldcg(st + 3) + sums.b);
    }
    __stcg(st + 4, __ldcg(st + 4) + sums.dep);
    __stcg(st + 6, __ldcg(st + 6) + (alive[r] ? 1.f : 0.f));
    __stcg(st + 7, lt);
  }
  const unsigned left = __ballot_sync(0xffffffffu, r < nr && lt > a.log_eps_t);
  if (a.early_term && left != 0u && r == 0)
    atomicMax(a.sync + kSyncWords + blk, (unsigned)(ci + 1));
}

__global__ void __launch_bounds__(kGroupThreads * kGroups, 1)
    vm_march_kernel(const __grid_constant__ VMArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int unit[kGroups];
  __shared__ int steps;
  const int g = threadIdx.x / kGroupThreads, gt = asdr::group_tid();
  float* act = smem + a.n_w + g * a.act_g;
  float* scr = smem + a.n_w + kGroups * a.act_g + g * a.raw_g;
  if (threadIdx.x == 0) steps = 0;
  if (a.with_color)
    for (int i = threadIdx.x; i < a.n_w; i += blockDim.x) smem[i] = a.w[i];
  __syncthreads();
  for (int b = threadIdx.x; b < a.N; b += blockDim.x)
    atomicMax(&steps, n_chunks(a, b));
  __syncthreads();

  const int slabs = (a.B + kTileRows - 1) / kTileRows;
  const int units = a.N * slabs;
  for (int ci = 0; ci < steps; ++ci) {
    if (blockIdx.x == 0 && threadIdx.x == 0)
      atomicExch(a.sync + 2 + ((ci + 1) & 1), 0u);
    for (;;) {
      if (gt == 0) unit[g] = (int)atomicAdd(a.sync + 2 + (ci & 1), 1u);
      asdr::group_sync();
      const int u = unit[g];
      asdr::group_sync();
      if (u >= units) break;
      const int blk = u / slabs;
      if (block_runs(a, blk, ci))
        march_unit(a, smem, act, scr, blk, u - blk * slabs, ci);
    }
    grid_sync(a.sync);
  }

  const long long rays = (long long)a.N * a.B;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < rays; i += (long long)gridDim.x * blockDim.x) {
    const int blk = (int)(i / a.B);
    float* st = a.out + i * 8;
    const float acc = __ldcg(st + 0);
    st[4] = __ldcg(st + 4) + (1.f - acc) * a.far;
    if (a.with_color && a.white_background)
      for (int c = 1; c < 4; ++c) st[c] = __ldcg(st + c) + (1.f - acc);
    int chunks = n_chunks(a, blk);
    if (a.early_term)
      chunks = min(chunks, (int)__ldcg(a.sync + kSyncWords + blk) + 1);
    st[5] = (float)chunks;
    st[7] = 0.f;
  }
}

int launch(VMArgs a, cudaStream_t stream) {
  const auto kernel = vm_march_kernel;
  const int threads = kGroupThreads * kGroups;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    a.smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(sms), dim3(threads),
                                  args, a.smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ints: [N, B, chunk, group, cd, ca, app, hid, mlp_in, fea_pe, view_pe, V,
//        res x3, early_term, white_background, with_color, per_ray_exit,
//        o_w1, o_b1, o_w2, o_b2, o_w3, o_b3, n_w, act_g, raw_g, smem] (the
//        wrapper's plan: kernels/vm_march.py plan());
// floats: [near, span, far, log_eps_t, sigma_scale, density_shift];
// out (N*B, 8), sync (4 + N) and anchors (N) zeroed by the caller;
// anchor_total (1) is added to.  One CTA
// per SM, all resident; returns the launch's error, else
// cudaGetLastError().
extern "C" int vm_march_launch(const float* o, const float* d,
                               const float* view, const int* budgets,
                               const float* dplane, const float* dline,
                               const float* aplane, const float* aline,
                               const float* w, float* out, unsigned* sync,
                               int* anchors,
                               unsigned long long* anchor_total,
                               const int* ints,
                               const float* floats, void* stream) {
  VMArgs a{};
  a.o = o; a.d = d; a.view = view; a.budgets = budgets;
  a.dplane = dplane; a.dline = dline; a.aplane = aplane; a.aline = aline;
  a.w = w; a.out = out; a.sync = sync; a.anchors = anchors;
  a.anchor_total = anchor_total;
  a.N = ints[0]; a.B = ints[1]; a.chunk = ints[2]; a.group = ints[3];
  a.cd = ints[4]; a.ca = ints[5]; a.app = ints[6]; a.hid = ints[7];
  a.mlp_in = ints[8]; a.fea_pe = ints[9]; a.view_pe = ints[10];
  a.V = ints[11];
  a.res[0] = ints[12]; a.res[1] = ints[13]; a.res[2] = ints[14];
  a.early_term = ints[15]; a.white_background = ints[16];
  a.with_color = ints[17]; a.per_ray_exit = ints[18];
  a.o_w1 = ints[19]; a.o_b1 = ints[20]; a.o_w2 = ints[21];
  a.o_b2 = ints[22]; a.o_w3 = ints[23]; a.o_b3 = ints[24];
  a.n_w = ints[25]; a.act_g = ints[26]; a.raw_g = ints[27];
  a.smem = ints[28];
  a.near = floats[0]; a.span = floats[1]; a.far = floats[2];
  a.log_eps_t = floats[3]; a.sigma_scale = floats[4];
  a.density_shift = floats[5];
  if (a.N <= 0) return 0;
  if (a.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  return launch(a, (cudaStream_t)stream);
}
