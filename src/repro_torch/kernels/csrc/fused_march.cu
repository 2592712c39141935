// All of ASDR's Phase II in one launch, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/fused_march.py
// (fused_march_call / _march_impl with its resident and streamed table
// supplies).  Bound: operations (6,144 FLOP per sample on the density
// chain plus the encode, 74,240 per anchor on the color chain); the table
// gathers of the encode come next (a 64 MiB stack at the paper's config,
// larger than the 50 MB L2).
//
// Work spread over the whole card, chunk step by chunk step.  The only
// coupling between rays is the block-level exit test (any(log_t >
// log_eps_t) over the block's rays before each chunk), so the kernel is
// one persistent CTA per SM (a cooperative launch: all CTAs co-resident)
// that walks the chunk steps ci = 0, 1, ... of the longest budget.  A CTA
// runs three warp groups of 128 threads where their shared memory fits
// (two at the largest chunks or widths).  In a step the warp groups take
// units (32 rays of one block) from a counter until every unit of the
// step is taken; a unit of a block that is past its budget's chunks, or
// whose rays had all saturated after the last step (under early_term), is
// skipped.  A grid-wide barrier ends the step.  A unit that leaves any ray
// alive raises its block's flag to ci + 1 (atomicMax), read only after the
// barrier, so no result depends on which CTA took which unit.
//
// A unit's tiles are its 32 rays at one sample index j, walked j = 0 ..
// chunk - 1 in order.  Per tile (asdr:: pieces shared with the MLP
// kernels): the 32 x L (point, level) encodes spread over the group's 128
// threads (encode_point_level, written k-major into the activations), the
// density chain (tile_chain with MulAdd, the rounding of density_mlp: the
// chunk counters hinge on it), and on anchor tiles the color chain on
// [geo, SH] (tile_chain with Fma, one rounding per multiply-add, as
// color_mlp).  A non-anchor tile past the budget is skipped; an anchor
// past it runs with sigma masked, since the lerp needs its color.  The
// tile's sigmas and the last two anchor colors stay in shared memory; one
// thread per ray (the group's first warp) composites group m of samples
// once anchor m + 1 is known, stepping its own serial sums in j order, as
// the plain version does sample by sample.
//
// Tables stay in device memory and gathers go through L2: the TPU's VMEM
// residency / DMA ping-pong has no counterpart.  Both weight chains sit in
// dynamic shared memory (the shared-memory plan is the fused field's,
// asdr::two_chain_layout, with the march's own buffers in place of the
// input tiles).  Per-ray state lives in the output rows across steps
// (read and written through L2), lane 7 holding log-transmittance until
// the end.
//
// Output rows (N*B, 8): [acc, r, g, b, depth, block_chunks, ray_chunks, 0].
#include "common.cuh"

namespace {

using asdr::kGroupThreads;
using asdr::kTileGroups;
using asdr::kTileRows;

constexpr int kMaxChunk = 64;

// sync words: [barrier arrivals, barrier generation, unit counters of the
// even and odd steps, then one flag per block]
constexpr int kSyncWords = 4;

struct MarchArgs {
  const float* o;        // (N*B, 3)
  const float* d;        // (N*B, 3)
  const float* sh;       // (N*B, S) or null when !with_color
  const int* budgets;    // (N,)
  const int* meta;       // (L, 3) [res, is_dense, rows]
  const float* tables;   // (L, T, F)
  const float* wd;       // density chain, flat
  const float* wc;       // color chain, flat
  float* out;            // (N*B, 8), zeroed
  unsigned* sync;        // (kSyncWords + N,), zeroed
  asdr::Dims dd, dc;
  asdr::TileLayout lay;
  long long T;
  int N, L, F, S, B, chunk, group;
  float near, span, far, log_eps_t;
  int early_term, white_background, with_color, per_ray_exit;
};

// A group's buffers past its activations, in floats: the tile sigmas
// (chunk rows of kTileRows), two anchor colors (3 rows each), the unit's
// SH (S rows, k-major) and two int rows: inside-the-cube per tile, alive
// per unit.
int march_extra(int chunk, int S) { return kTileRows * (chunk + 6 + S + 2); }

// Bytes of dynamic shared memory: the plan, then the (L, 3) meta ints.
size_t march_smem(const asdr::TileLayout& lay, int L) {
  return lay.bytes + sizeof(int) * 3 * (size_t)L;
}

// Warp groups of a CTA: three where their shared memory fits ``limit``
// (more warps to hide the gathers' and the last layers' latency; three
// groups at about 154 registers fill an SM's register file), else two.
constexpr int kMaxGroups = 3;

asdr::TileLayout march_plan(const MarchArgs& a, size_t limit) {
  asdr::TileLayout lay{};
  for (int g = kMaxGroups; g >= kTileGroups; --g) {
    lay = asdr::two_chain_layout(a.dd, a.dc, 0, march_extra(a.chunk, a.S),
                                 g);
    if (march_smem(lay, a.L) <= limit) break;
  }
  return lay;
}

__device__ __forceinline__ int n_chunks(const MarchArgs& a, int blk) {
  return (a.budgets[blk] + a.chunk - 1) / a.chunk;
}

__device__ __forceinline__ bool block_runs(const MarchArgs& a, int blk,
                                           int ci) {
  return ci < n_chunks(a, blk) &&
         (!a.early_term || ci == 0 ||
          (int)__ldcg(a.sync + kSyncWords + blk) >= ci);
}

// All CTAs wait here until every one has arrived (the launch is
// cooperative, so they are all resident); memory written before it is
// visible after it.
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

// Chunk ci of rays [blk * B + 32 * slab, + nr) by the calling group.
__device__ __forceinline__ void march_unit(
    const MarchArgs& a, const float* smem, const int* dims_d,
    const int* dims_c, const int* smeta, float* act, float* scr, int blk,
    int slab, int ci) {
  const asdr::TileLayout& lay = a.lay;
  const int gt = asdr::group_tid(), r = gt % kTileRows, q = gt / kTileRows;
  const int C = a.chunk, grp = a.group, A = (C + grp - 1) / grp;
  const int S = a.S, P = lay.P, G = dims_d[a.dd.n] - 1;
  const int budget = a.budgets[blk];
  const float delta_t = a.span / (float)budget;
  const int nr = min(kTileRows, a.B - kTileRows * slab);
  const long long ray0 = (long long)blk * a.B + kTileRows * slab;
  float* sig = scr;                        // [j][row]
  float* col = sig + C * kTileRows;        // [anchor & 1][channel][row]
  float* shk = col + 6 * kTileRows;        // [s][row]
  int* inside = (int*)(shk + S * kTileRows);
  int* alive = inside + kTileRows;

  // the ray of row r, held by the four threads that encode its row
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (r < nr) {
    const float* po = a.o + (ray0 + r) * 3;
    const float* pd = a.d + (ray0 + r) * 3;
    ox = po[0]; oy = po[1]; oz = po[2];
    dx = pd[0]; dy = pd[1]; dz = pd[2];
  }
  float* st = a.out + (ray0 + r) * 8;
  float log_t = 0.f;
  if (q == 0) {
    if (r < nr) log_t = __ldcg(st + 7);
    alive[r] = r < nr && log_t > a.log_eps_t;
  }
  for (int i = gt; i < S * kTileRows; i += kGroupThreads) {
    const int s = i / kTileRows, rr = i - s * kTileRows;
    shk[i] = rr < nr ? a.sh[(ray0 + rr) * S + s] : 0.f;
  }
  asdr::group_sync();
  if (a.per_ray_exit) {
    // a dead ray has all sigma masked, so its state does not change; a
    // unit of dead rays changes nothing
    int any = 0;
    for (int i = 0; i < kTileRows; ++i) any |= alive[i];
    if (!any) return;
  }

  // composite state of ray r (threads q == 0)
  float incl = 0.f, acc_c = 0.f, dep_c = 0.f;
  float rc0 = 0.f, rc1 = 0.f, rc2 = 0.f;
  auto composite = [&](int j0, int j1, const float* cl, const float* cr) {
    for (int j = j0; j < j1; ++j) {
      const int idx = ci * C + j;
      const float t = a.near + ((float)idx + 0.5f) * delta_t;
      const float alpha = 1.f - expf(-sig[j * kTileRows + r] * delta_t);
      const float ls = logf(fminf(fmaxf(1.f - alpha, 1e-10f), 1.f));
      incl = incl + ls;
      const float intra = incl - ls;
      const float w = expf(log_t + intra) * alpha;
      acc_c = acc_c + w;
      dep_c = dep_c + w * t;
      if (cl != nullptr) {
        const float tt = (float)(j % grp) / (float)grp;
        const float l0 = cl[r], l1 = cl[kTileRows + r];
        const float l2 = cl[2 * kTileRows + r];
        rc0 = rc0 + w * (l0 + (cr[r] - l0) * tt);
        rc1 = rc1 + w * (l1 + (cr[kTileRows + r] - l1) * tt);
        rc2 = rc2 + w * (l2 + (cr[2 * kTileRows + r] - l2) * tt);
      }
    }
  };

  for (int j = 0; j < C; ++j) {
    const int idx = ci * C + j;
    const bool valid = idx < budget, anchor = (j % grp) == 0;
    // a non-anchor past the budget has sigma 0 and feeds no color
    if (!valid && !anchor) {
      if (q == 0) sig[j * kTileRows + r] = 0.f;
      continue;
    }
    const bool color = a.with_color && anchor;
    const float t = a.near + ((float)idx + 0.5f) * delta_t;
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    for (int l = q; l < a.L; l += kGroupThreads / kTileRows)
      asdr::encode_point_level(px, py, pz, smeta[l * 3 + 0], smeta[l * 3 + 1],
                               (uint32_t)smeta[l * 3 + 2],
                               a.tables + (size_t)l * a.T * a.F, a.F,
                               act + l * a.F * kTileRows + r, kTileRows);
    if (q == 0)
      inside[r] = px >= 0.f && px <= 1.f && py >= 0.f && py <= 1.f &&
                  pz >= 0.f && pz <= 1.f;
    if (color)
      for (int i = gt; i < S * kTileRows; i += kGroupThreads)
        act[(P + G) * kTileRows + i] = shk[i];
    asdr::group_sync();
    asdr::tile_chain<asdr::MulAdd>(
        smem, dims_d, a.dd.n, act, act,
        asdr::density_epi(
            [&](int rr, float s) {
              const bool keep = inside[rr] && valid &&
                                (!a.per_ray_exit || alive[rr]);
              sig[j * kTileRows + rr] = keep ? s : 0.f;
            },
            [&](int rr, int c, float y) {
              if (color) act[(P + c) * kTileRows + rr] = y;
            }));
    asdr::group_sync();
    if (color) {
      const int m = j / grp;
      float* cm = col + (m & 1) * 3 * kTileRows;
      asdr::tile_chain<asdr::Fma>(smem + lay.w1, dims_c, a.dc.n,
                                  act + P * kTileRows, act,
                                  [&](int rr, int c, float y) {
        cm[c * kTileRows + rr] = asdr::sigmoid(y);
      });
      asdr::group_sync();
      if (m > 0 && q == 0)
        composite((m - 1) * grp, m * grp, col + ((m - 1) & 1) * 3 * kTileRows,
                  cm);
    }
  }
  if (q != 0) return;
  if (a.with_color) {
    const float* cl = col + ((A - 1) & 1) * 3 * kTileRows;
    composite((A - 1) * grp, C, cl, cl);
  } else {
    composite(0, C, nullptr, nullptr);
  }
  const float lt = log_t + incl;
  if (r < nr) {
    __stcg(st + 0, __ldcg(st + 0) + acc_c);
    if (a.with_color) {
      __stcg(st + 1, __ldcg(st + 1) + rc0);
      __stcg(st + 2, __ldcg(st + 2) + rc1);
      __stcg(st + 3, __ldcg(st + 3) + rc2);
    }
    __stcg(st + 4, __ldcg(st + 4) + dep_c);
    __stcg(st + 6, __ldcg(st + 6) + (alive[r] ? 1.f : 0.f));
    __stcg(st + 7, lt);
  }
  const unsigned left = __ballot_sync(0xffffffffu, r < nr && lt > a.log_eps_t);
  if (a.early_term && left != 0u && r == 0)
    atomicMax(a.sync + kSyncWords + blk, (unsigned)(ci + 1));
}

// a is read in place (__grid_constant__: no per-thread copy of it).
template <int Groups>
__global__ void __launch_bounds__(kGroupThreads * Groups, 1)
    fused_march_kernel(const __grid_constant__ MarchArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int dims_d[asdr::kMaxLayers + 1], dims_c[asdr::kMaxLayers + 1];
  __shared__ int unit[Groups];
  __shared__ int steps;
  const asdr::TileLayout& lay = a.lay;
  const int g = threadIdx.x / kGroupThreads, gt = asdr::group_tid();
  float* act = smem + lay.act + g * lay.act_g;
  float* scr = smem + lay.raw + g * lay.raw_g;
  int* smeta = (int*)(smem + lay.raw + Groups * lay.raw_g);
  asdr::dims_to_shared(a.dd, dims_d);
  asdr::dims_to_shared(a.dc, dims_c);
  if (threadIdx.x == 0) steps = 0;
  for (int i = threadIdx.x; i < lay.nw0; i += blockDim.x) smem[i] = a.wd[i];
  if (a.with_color)
    for (int i = threadIdx.x; i < lay.nw1; i += blockDim.x)
      smem[lay.w1 + i] = a.wc[i];
  for (int i = threadIdx.x; i < a.L * 3; i += blockDim.x) smeta[i] = a.meta[i];
  __syncthreads();
  for (int b = threadIdx.x; b < a.N; b += blockDim.x)
    atomicMax(&steps, n_chunks(a, b));
  __syncthreads();

  const int slabs = (a.B + kTileRows - 1) / kTileRows;
  const int units = a.N * slabs;
  for (int ci = 0; ci < steps; ++ci) {
    // the other parity's counter was spent in the last step; ready it for
    // the next one
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
        march_unit(a, smem, dims_d, dims_c, smeta, act, scr, blk,
                   u - blk * slabs, ci);
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
    // the chunks a block ran: all of its budget's, or up to the first
    // step after which none of its rays was alive
    int chunks = n_chunks(a, blk);
    if (a.early_term)
      chunks = min(chunks, (int)__ldcg(a.sync + kSyncWords + blk) + 1);
    st[5] = (float)chunks;
    st[7] = 0.f;
  }
}

void fill_args(MarchArgs& a, const int* ints, const int* dims_d,
               const int* dims_c) {
  a.N = ints[0]; a.B = ints[1]; a.chunk = ints[2]; a.group = ints[3];
  a.L = ints[4]; a.F = ints[5]; a.S = ints[6]; a.early_term = ints[7];
  a.white_background = ints[8]; a.with_color = ints[9];
  a.per_ray_exit = ints[10];
  a.dd = asdr::dims_of(dims_d, ints[11]);
  a.dc = asdr::dims_of(dims_c, ints[12]);
}

// Shared memory one CTA of the current device may opt in to.
size_t smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)limit;
}

// One CTA of Groups warp groups on each SM, all resident.
template <int Groups>
int launch(MarchArgs a, size_t smem, cudaStream_t stream) {
  const auto kernel = fused_march_kernel<Groups>;
  const int threads = kGroupThreads * Groups;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)kernel, dim3(sms), dim3(threads),
                                  args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ints: [N, B, chunk, group, L, F, S, early_term, white_background,
//        with_color, per_ray_exit, n_density_layers, n_color_layers]
// dims_d / dims_c: host arrays of layer widths.  Bytes of dynamic shared
// memory fused_march_launch asks for on the current device.
extern "C" long long fused_march_smem(const int* ints, const int* dims_d,
                                      const int* dims_c) {
  MarchArgs a{};
  fill_args(a, ints, dims_d, dims_c);
  return (long long)march_smem(march_plan(a, smem_limit()), a.L);
}

// ints, dims_d, dims_c as above; floats: [near, span, far, log_eps_t];
// T: rows per table; out (N*B, 8) and sync (4 + N) zeroed by the caller.
// One CTA per SM, all resident (cudaLaunchCooperativeKernel); returns the
// launch's error (cudaErrorCooperativeLaunchTooLarge where not one CTA
// fits an SM), else cudaGetLastError().
extern "C" int fused_march_launch(const float* o, const float* d,
                                  const float* sh, const int* budgets,
                                  const int* meta, const float* tables,
                                  long long T, const float* wd,
                                  const float* wc, const int* ints,
                                  const int* dims_d, const int* dims_c,
                                  const float* floats, float* out,
                                  unsigned* sync, void* stream) {
  MarchArgs a{};
  fill_args(a, ints, dims_d, dims_c);
  a.o = o; a.d = d; a.sh = sh; a.budgets = budgets; a.meta = meta;
  a.tables = tables; a.wd = wd; a.wc = wc; a.out = out; a.sync = sync;
  a.T = T;
  a.near = floats[0]; a.span = floats[1]; a.far = floats[2];
  a.log_eps_t = floats[3];
  if (a.N <= 0) return 0;
  if (a.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  a.lay = march_plan(a, smem_limit());
  const size_t smem = march_smem(a.lay, a.L);
  return a.lay.groups == kMaxGroups
             ? launch<kMaxGroups>(a, smem, (cudaStream_t)stream)
             : launch<kTileGroups>(a, smem, (cudaStream_t)stream);
}
