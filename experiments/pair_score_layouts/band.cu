// An earlier layout of pair_score: one wave of row-band pairs, symmetric
// 4 x 4 tiles a thread, stacks loaded straight from global memory,
// 16-byte stores.  Kept to time the layouts against.
//
// All-pairs Eq. 4 pair cost (paper Step 2) and the matcher's cost
// preparation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/pair_score/kernel.py::_pair_score_kernel (launched by
// pair_score_pallas) and fuses into its epilogue the cost preparation of
// src/repro/core/synpa.py::make_fused_step (the BIG sentinels of inactive
// slots and the idle-context vertex's edges).  For every ordered pair
// (i, j) of the P output vertices it computes
//
//   s_ij = clip(sum_{c < C} relu(a_c + b_c x_ic + g_c x_jc + r_c x_ic x_jc),
//               0.25, 16)
//
// and s_ji in the same pass, and writes
//
//   IDLE_COST = 2      if i == idle_row and j is valid,
//                      or j == idle_row and i is valid;
//   BIG = DIAG = 1e9   else if i or j is not valid, or i == j;
//   s_ij + s_ji        else,
//
// where vertex v is valid when v < n_valid and valid[v] (a null `valid`
// means every v < n_valid).  Stack rows at or past n_valid are never read.
//
// What bounds it on an H100.  At P = fused_pad(1024) = 1032 the output is
// 4.26 MB: 1.28 us at the card's 3.35 TB/s if the writes reach HBM, but it
// fits in the 50 MB L2, so the kernel may end before they do.  An entry
// costs about 45 issued float32 instructions, a quarter of them on the
// half-rate min/max pipe; and in a launch this short the first loads'
// latency is a large share.  So each entry is computed once for both
// triangles: the matrix is symmetric bit for bit (the two directions swap
// places, and a float sum of two terms does not depend on their order),
// and a tile's costs are written at (i, j) and at (j, i).
//
// Design.  One wave of row bands.  The P rows are cut into NB bands of R
// rows (R a multiple of 4, NB <= 2 x the SM count), and block b owns bands
// b and NB - 1 - b: for each, the columns from the band's first row to P,
// in 4 x 4 tiles.  The two column ranges add up to about P + R whatever b
// is, so the blocks are balanced, and there are at most as many as SMs: no
// tail wave.  Each thread computes one tile at a time: it loads its 4 row
// and 4 column stacks and their validity straight from global memory (the
// loads of a warp's tiles are contiguous, and the row stacks are the same
// for the whole warp), keeps the 16 coefficients in registers, and writes
// the tile with 16-byte stores: 4 along its rows (a warp writes 512
// contiguous bytes of a row) and 4 along its columns; P % 4 != 0 takes the
// same code with scalar stores.  Loads go straight to registers: staging
// the column stacks in shared memory through a ring of bulk asynchronous
// copies (cp.async.bulk on an mbarrier) measured slower on the card, its
// copies' latency exposed in so short a launch (PERF.md).  The
// per-entry arithmetic is written out with explicit roundings, in the
// order of the first port of this kernel, so that the costs, and the
// matcher's choices on a last-ulp tie, do not move.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kBig = 1e9f;   // the kernel's DIAG and the matcher's BIG
constexpr float kIdleCost = 2.0f;

struct Args {
  const float4* st;              // (>= n_valid, 4) stacks
  const float4* coeffs;          // (4, 4): (alpha, beta, gamma, rho) rows
  const unsigned char* valid;    // (n_valid,) bool, or null: all valid
  float* out;                    // (p, p)
  int p, n_valid, idle_row;
  int band, n_bands;             // R and NB
};

// s_ij + s_ji for row stack xi and column stack xj over the first kCats
// categories.
template <int kCats>
__device__ __forceinline__ float pair_cost(const float4 xi4, const float4 xj4,
                                           const float4 (&cf)[4]) {
  const float xi[4] = {xi4.x, xi4.y, xi4.z, xi4.w};
  const float xj[4] = {xj4.x, xj4.y, xj4.z, xj4.w};
  float s_ij = 0.f;
  float s_ji = 0.f;
#pragma unroll
  for (int c = 0; c < kCats; ++c) {
    const float a = cf[c].x, b = cf[c].y, g = cf[c].z, r = cf[c].w;
    const float cross = __fmul_rn(xi[c], xj[c]);
    const float p_ij =
        __fmaf_rn(r, cross, __fmaf_rn(g, xj[c], __fmaf_rn(b, xi[c], a)));
    const float p_ji =
        __fmaf_rn(r, cross, __fmaf_rn(g, xi[c], __fmaf_rn(b, xj[c], a)));
    s_ij = __fadd_rn(s_ij, fmaxf(p_ij, 0.f));
    s_ji = __fadd_rn(s_ji, fmaxf(p_ji, 0.f));
  }
  s_ij = fminf(fmaxf(s_ij, kMinSlowdown), kMaxSlowdown);
  s_ji = fminf(fmaxf(s_ji, kMinSlowdown), kMaxSlowdown);
  return __fadd_rn(s_ij, s_ji);
}

// The 4 x 4 tile at rows i0.., columns j0..: costs, epilogue, stores at
// (i, j) and (j, i).  vr, vc: validity bits of its rows and columns.
template <int kCats, bool kVec>
__device__ __forceinline__ void tile(const Args& a, int i0, int j0,
                                     uint32_t vr, uint32_t vc,
                                     const float4 (&xr)[4],
                                     const float4 (&xj)[4],
                                     const float4 (&cf)[4]) {
  const int p = a.p;
  float t[4][4] = {};
  if (vr && vc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 xi = xr[r];
#pragma unroll
      for (int q = 0; q < 4; ++q) t[r][q] = pair_cost<kCats>(xi, xj[q], cf);
    }
  }
  // The epilogue, on the tiles that hold a sentinel or an idle edge.
  const bool idle_near = static_cast<unsigned>(a.idle_row - i0) < 4u ||
                         static_cast<unsigned>(a.idle_row - j0) < 4u;
  if (vr != 0xFu || vc != 0xFu || i0 == j0 || idle_near) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + r, j = j0 + q;
        const bool vi = (vr >> r) & 1u, vj = (vc >> q) & 1u;
        float v = vi && vj && i != j ? t[r][q] : kBig;
        if ((i == a.idle_row && vj) || (j == a.idle_row && vi)) {
          v = kIdleCost;
        }
        t[r][q] = v;
      }
    }
  }
  if (kVec) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      *reinterpret_cast<float4*>(a.out + static_cast<size_t>(i0 + r) * p +
                                 j0) =
          make_float4(t[r][0], t[r][1], t[r][2], t[r][3]);
    }
    if (i0 != j0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<float4*>(
            a.out + static_cast<size_t>(j0 + q) * p + i0) =
            make_float4(t[0][q], t[1][q], t[2][q], t[3][q]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + r, j = j0 + q;
        if (i < p && j < p) {
          a.out[static_cast<size_t>(i) * p + j] = t[r][q];
          a.out[static_cast<size_t>(j) * p + i] = t[r][q];
        }
      }
    }
  }
}

// Block b: bands b and NB - 1 - b (one band when they meet), each from
// its first row to column P, in 4 x 4 tiles.
template <int kCats, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
pair_score_kernel(const Args a) {
  const int p = a.p;
  float4 cf[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) cf[c] = __ldg(a.coeffs + c);
  const int band_a = blockIdx.x;
  const int band_b = a.n_bands - 1 - band_a;
  // Tiles of a band: row quads x column groups.
  const int ga = (p - band_a * a.band + 3) >> 2;
  const int gb = (p - band_b * a.band + 3) >> 2;
  const int na = ((min(a.band, p - band_a * a.band) + 3) >> 2) * ga;
  const int nb = band_b != band_a
                     ? ((min(a.band, p - band_b * a.band) + 3) >> 2) * gb
                     : 0;
  for (int u = threadIdx.x; u < na + nb; u += blockDim.x) {
    const bool in_a = u < na;
    const int band = in_a ? band_a : band_b;
    const int groups = in_a ? ga : gb;
    const int w = in_a ? u : u - na;
    const int rq = w / groups;
    const int g = w - rq * groups;
    const int i0 = band * a.band + 4 * rq;
    const int j0 = band * a.band + 4 * g;
    // Below the diagonal of the band's own columns: another tile's
    // transpose writes it.
    if (j0 < i0) continue;
    float4 xr[4], xj[4];
    uint32_t vr = 0, vc = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + q, j = j0 + q;
      const bool oki = i < a.n_valid, okj = j < a.n_valid;
      xr[q] = oki ? __ldg(a.st + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      xj[q] = okj ? __ldg(a.st + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      vr |= static_cast<uint32_t>(oki && (a.valid == nullptr || a.valid[i]))
            << q;
      vc |= static_cast<uint32_t>(okj && (a.valid == nullptr || a.valid[j]))
            << q;
    }
    tile<kCats, kVec>(a, i0, j0, vr, vc, xr, xj, cf);
  }
}

template <bool kVec>
int launch(const Args& a, int n_categories, int threads,
           cudaStream_t stream) {
  const int blocks = (a.n_bands + 1) / 2;
  switch (n_categories) {
    case 1: pair_score_kernel<1, kVec><<<blocks, threads, 0, stream>>>(a);
            break;
    case 2: pair_score_kernel<2, kVec><<<blocks, threads, 0, stream>>>(a);
            break;
    case 3: pair_score_kernel<3, kVec><<<blocks, threads, 0, stream>>>(a);
            break;
    case 4: pair_score_kernel<4, kVec><<<blocks, threads, 0, stream>>>(a);
            break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// st: (>= n_valid, 4) float32, 16-byte aligned; coeffs: (4, 4) float32
// rows (alpha, beta, gamma, rho), 16-byte aligned; valid: (n_valid,) bool
// or null; out: (p, p) float32; n_sm: the card's SM count.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int pair_score_launch(const void* st, const void* coeffs,
                                 const void* valid, void* out, int p,
                                 int n_valid, int n_categories, int idle_row,
                                 int n_sm, void* stream) {
  if (p <= 0) return 0;
  Args a;
  a.st = static_cast<const float4*>(st);
  a.coeffs = static_cast<const float4*>(coeffs);
  a.valid = static_cast<const unsigned char*>(valid);
  a.out = static_cast<float*>(out);
  a.p = p;
  a.n_valid = n_valid < p ? n_valid : p;
  a.idle_row = idle_row;
  a.band = 4 * ((p + 8 * n_sm - 1) / (8 * n_sm));
  a.n_bands = (p + a.band - 1) / a.band;
  // The block size: a block's tiles over as few rounds of at most
  // kMaxThreads threads as they need, evenly.
  const int tiles = (a.band / 4) * ((p + a.band + 3) / 4 + 2);
  const int rounds = (tiles + kMaxThreads - 1) / kMaxThreads;
  int threads = ((tiles + rounds - 1) / rounds + 31) / 32 * 32;
  threads = threads < 64 ? 64 : threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p % 4 == 0 ? launch<true>(a, n_categories, threads, s)
                    : launch<false>(a, n_categories, threads, s);
}
