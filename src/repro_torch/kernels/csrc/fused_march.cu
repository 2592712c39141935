// All of ASDR's Phase II in one launch, for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/fused_march.py
// (fused_march_call / _march_impl with its resident and streamed table
// supplies).  One CTA marches one ASDR block: the block-level exit test
// any(log_t > log_eps_t) spans all B rays of the block (4,096 at the
// paper's config, more than a CTA's threads), so each thread strides over
// several rays and every chunk starts with __syncthreads_or(alive).  For
// each chunk a ray's samples are generated, hash-encoded (the shared
// encode_point_level), pushed through the density chain, and every
// group-th anchor through the color chain; anchor selection and the lerp
// are index arithmetic.  Compositing carries log-transmittance across
// chunks.  Per-sample features never leave the thread.
//
// Tables stay in device memory and gathers go through L2: the TPU's VMEM
// residency / DMA ping-pong has no counterpart.  Both weight chains sit in
// dynamic shared memory (160,768 B at the paper's widths, hence the
// cudaFuncAttributeMaxDynamicSharedMemorySize opt-in).  Bound: operations
// (6,144 FLOP per sample on the density chain, 74,240 per anchor on the
// color chain); per-ray state lives in the output rows, lane 7 holding
// log-transmittance until the block ends.
//
// Output rows (N*B, 8): [acc, r, g, b, depth, block_chunks, ray_chunks, 0].
#include "common.cuh"

namespace {

constexpr int kMaxChunk = 64;
constexpr int kThreads = 512;

struct MarchArgs {
  const float* o;        // (N*B, 3)
  const float* d;        // (N*B, 3)
  const float* sh;       // (N*B, S) or null when !with_color
  const int* budgets;    // (N,)
  const int* meta;       // (L, 3) [res, is_dense, rows]
  const float* tables;   // (L, T, F)
  const float* wd;       // density chain, flat
  const float* wc;       // color chain, flat
  float* out;            // (N*B, 8)
  asdr::Dims dd, dc;
  long long T;
  int L, F, S, B, chunk, group;
  float near, span, far, log_eps_t;
  int early_term, white_background, with_color, per_ray_exit;
};

// One chunk of one ray; reads and writes the ray's state in its out row.
__device__ void march_chunk(const MarchArgs& a, const float* swd,
                            const float* swc, const int* smeta, long long ray,
                            int ci, int budget, float delta_t) {
  float* st = a.out + ray * 8;
  const float log_t = st[7];
  const bool alive = log_t > a.log_eps_t;
  // a dead ray under per-ray exit has all sigma masked: its alpha, weight
  // and log step are exactly 0, so its state does not change
  if (a.per_ray_exit && !alive) return;

  const int C = a.chunk, G = a.dd.d[a.dd.n] - 1;
  const int A = (C + a.group - 1) / a.group;
  const float ox = a.o[ray * 3 + 0], oy = a.o[ray * 3 + 1], oz = a.o[ray * 3 + 2];
  const float dx = a.d[ray * 3 + 0], dy = a.d[ray * 3 + 1], dz = a.d[ray * 3 + 2];
  float sig[kMaxChunk];
  float col[kMaxChunk][3];
  float x[asdr::kMaxWidth], y[asdr::kMaxWidth];

  for (int j = 0; j < C; ++j) {
    const int idx = ci * C + j;
    const bool valid = idx < budget;
    const bool anchor = (j % a.group) == 0;
    sig[j] = 0.f;
    // a non-anchor past the budget has sigma 0 and feeds no color
    if (!valid && !anchor) continue;
    const float t = a.near + ((float)idx + 0.5f) * delta_t;
    const float px = ox + t * dx, py = oy + t * dy, pz = oz + t * dz;
    for (int l = 0; l < a.L; ++l)
      asdr::encode_point_level(px, py, pz, smeta[l * 3 + 0],
                               smeta[l * 3 + 1], (uint32_t)smeta[l * 3 + 2],
                               a.tables + (size_t)l * a.T * a.F, a.F,
                               x + l * a.F);
    const float* h = asdr::mlp_chain(swd, a.dd, x, y);
    const bool inside = px >= 0.f && px <= 1.f && py >= 0.f && py <= 1.f &&
                        pz >= 0.f && pz <= 1.f;
    sig[j] = (inside && valid) ? asdr::trunc_exp(h[0]) : 0.f;
    if (a.with_color && anchor) {
      // color input [geo, SH(dir)]; h is x or y, write into the other one
      float* cin = (h == x) ? y : x;
      for (int g = 0; g < G; ++g) cin[g] = h[1 + g];
      for (int s = 0; s < a.S; ++s) cin[G + s] = a.sh[ray * a.S + s];
      float* other = (cin == x) ? y : x;
      const float* rgb = asdr::mlp_chain(swc, a.dc, cin, other);
      for (int c = 0; c < 3; ++c) col[j / a.group][c] = asdr::sigmoid(rgb[c]);
    }
  }

  float incl = 0.f, acc_c = 0.f, dep_c = 0.f;
  float rc[3] = {0.f, 0.f, 0.f};
  for (int j = 0; j < C; ++j) {
    const int idx = ci * C + j;
    const float t = a.near + ((float)idx + 0.5f) * delta_t;
    const float alpha = 1.f - expf(-sig[j] * delta_t);
    const float ls = logf(fminf(fmaxf(1.f - alpha, 1e-10f), 1.f));
    incl = incl + ls;
    const float intra = incl - ls;
    const float w = expf(log_t + intra) * alpha;
    acc_c = acc_c + w;
    dep_c = dep_c + w * t;
    if (a.with_color) {
      const int gi = j / a.group;
      const int l0 = min(gi, A - 1), r0 = min(gi + 1, A - 1);
      const float tt = (float)(j % a.group) / (float)a.group;
      for (int c = 0; c < 3; ++c) {
        const float cj = col[l0][c] + (col[r0][c] - col[l0][c]) * tt;
        rc[c] = rc[c] + w * cj;
      }
    }
  }
  st[0] = st[0] + acc_c;
  if (a.with_color)
    for (int c = 0; c < 3; ++c) st[1 + c] = st[1 + c] + rc[c];
  st[4] = st[4] + dep_c;
  st[6] = st[6] + (alive ? 1.f : 0.f);
  st[7] = log_t + incl;
}

__global__ void __launch_bounds__(kThreads, 1) fused_march_kernel(MarchArgs a) {
  extern __shared__ float smem[];
  const int nwd = asdr::chain_floats(a.dd), nwc = asdr::chain_floats(a.dc);
  float* swd = smem;
  float* swc = smem + nwd;
  int* smeta = (int*)(swc + nwc);
  for (int i = threadIdx.x; i < nwd; i += blockDim.x) swd[i] = a.wd[i];
  if (a.with_color)
    for (int i = threadIdx.x; i < nwc; i += blockDim.x) swc[i] = a.wc[i];
  for (int i = threadIdx.x; i < a.L * 3; i += blockDim.x) smeta[i] = a.meta[i];

  const int blk = blockIdx.x;
  const long long first = (long long)blk * a.B;
  const int budget = a.budgets[blk];
  const float delta_t = a.span / (float)budget;
  const int n_chunks = (budget + a.chunk - 1) / a.chunk;
  for (int r = threadIdx.x; r < a.B; r += blockDim.x) {
    float* st = a.out + (first + r) * 8;
    for (int k = 0; k < 8; ++k) st[k] = 0.f;
  }
  __syncthreads();

  int ci = 0;
  while (ci < n_chunks) {
    if (a.early_term) {
      int live = 0;
      for (int r = threadIdx.x; r < a.B; r += blockDim.x)
        live |= a.out[(first + r) * 8 + 7] > a.log_eps_t;
      if (!__syncthreads_or(live)) break;
    }
    for (int r = threadIdx.x; r < a.B; r += blockDim.x)
      march_chunk(a, swd, swc, smeta, first + r, ci, budget, delta_t);
    ++ci;
  }

  for (int r = threadIdx.x; r < a.B; r += blockDim.x) {
    float* st = a.out + (first + r) * 8;
    const float acc = st[0];
    st[4] = st[4] + (1.f - acc) * a.far;
    if (a.with_color && a.white_background)
      for (int c = 0; c < 3; ++c) st[1 + c] = st[1 + c] + (1.f - acc);
    st[5] = (float)ci;
    st[7] = 0.f;
  }
}

}  // namespace

// ints: [N, B, chunk, group, L, F, S, early_term, white_background,
//        with_color, per_ray_exit, n_density_layers, n_color_layers]
// dims_d / dims_c: host arrays of layer widths; floats: [near, span, far,
// log_eps_t]; T: rows per table.  Returns cudaGetLastError().
extern "C" int fused_march_launch(const float* o, const float* d,
                                  const float* sh, const int* budgets,
                                  const int* meta, const float* tables,
                                  long long T, const float* wd,
                                  const float* wc, const int* ints,
                                  const int* dims_d, const int* dims_c,
                                  const float* floats, float* out,
                                  void* stream) {
  MarchArgs a;
  const int N = ints[0];
  a.o = o; a.d = d; a.sh = sh; a.budgets = budgets; a.meta = meta;
  a.tables = tables; a.wd = wd; a.wc = wc; a.out = out; a.T = T;
  a.B = ints[1]; a.chunk = ints[2]; a.group = ints[3]; a.L = ints[4];
  a.F = ints[5]; a.S = ints[6]; a.early_term = ints[7];
  a.white_background = ints[8]; a.with_color = ints[9];
  a.per_ray_exit = ints[10];
  a.dd.n = ints[11];
  for (int i = 0; i <= a.dd.n; ++i) a.dd.d[i] = dims_d[i];
  a.dc.n = ints[12];
  for (int i = 0; i <= a.dc.n; ++i) a.dc.d[i] = dims_c[i];
  a.near = floats[0]; a.span = floats[1]; a.far = floats[2];
  a.log_eps_t = floats[3];
  if (N <= 0) return 0;
  const size_t smem = (size_t)(asdr::chain_floats(a.dd) +
                               asdr::chain_floats(a.dc)) * sizeof(float) +
                      (size_t)a.L * 3 * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      fused_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_march_kernel<<<N, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
