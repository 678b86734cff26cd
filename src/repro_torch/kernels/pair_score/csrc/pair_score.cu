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
// With a non-null `idle_flag` (one bool in device memory), idle_row is the
// idle vertex only while *idle_flag is true, and -1 otherwise: the open
// system's flag is the parity of its active population, a device value,
// and the host never reads it.  One thread of each block reads the flag
// before the block's barrier, so every thread of a block, and every block,
// sees the same value.
//
// What bounds it on an H100.  At P = fused_pad(1024) = 1032 the output is
// 4.26 MB: 1.28 us at the card's 3.35 TB/s if the writes reach HBM, but it
// fits in the 50 MB L2, so the kernel may end before they do.  An entry
// costs about 45 issued float32 instructions, and the launch is a single
// wave of blocks, so each block's first loads are exposed.  The matrix is
// symmetric bit for bit (cost(j, i) runs the same float operations as
// cost(i, j), with the two terms of the final sum swapped), so each entry
// is computed once for both triangles.
//
// Lanes.  A scenario grid scores all its lanes in one launch: blockIdx.y is
// the lane, and each lane's stacks, validity, flag and (p, p) output sit at
// a fixed stride from the first lane's.  Nothing else depends on the lane,
// so a lane's output is bit for bit that of a one-lane launch on its
// inputs.  A one-lane launch runs the instantiation without the lane
// offsets: with them it took 6.092 us, without 5.531 us, and the kernel
// before the lane axis 5.530 us, in turns in one run on an H100 80GB HBM3
// at 700 W (experiments/pair_score_lanes/run.py).
//
// Design.  32 x 32 output tiles of the upper triangle, one block of 32 x 8
// threads each (P = 1032: 561 blocks).  The block stages its 32 row and 32
// column stacks, their validity and the 16 coefficients in shared memory;
// each thread then computes one column of 4 rows and writes them (a warp
// stores 32 consecutive floats of a row), and the block writes the tile's
// transpose through shared memory, coalesced the same way.  A tile with no
// sentinel and no idle edge (decided once for the block, by
// __syncthreads_and) takes the cost alone, without the epilogue's tests.
// One wave of row bands (its stacks loaded directly or through a ring of
// bulk asynchronous copies), 16-byte stores, and bulk stores from shared
// memory all measured slower on the card (PERF.md;
// experiments/pair_score_layouts/run.py times the layouts).  The per-entry
// arithmetic is written out with explicit roundings, in the order of the
// first port of this kernel, so that the costs, and the matcher's choices
// on a last-ulp tie, do not move.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kTile / kRowsPerThread;  // 8 -> 256 threads
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kBig = 1e9f;   // the kernel's DIAG and the matcher's BIG
constexpr float kIdleCost = 2.0f;

struct Args {
  const float4* st;              // (>= n_valid, 4) stacks
  const float* coeffs;           // (4, 4): (alpha, beta, gamma, rho) rows
  const unsigned char* valid;    // (n_valid,) bool, or null: all valid
  const unsigned char* idle_flag;  // one bool, or null: idle_row as given
  float* out;                    // (p, p)
  int p, n_valid, n_categories, idle_row;
  int tiles;                     // tiles along a side
  int st_rows;                   // stack rows a lane (the lane stride of st)
};

// s_ij + s_ji for row stack vi and column stack vj.
__device__ __forceinline__ float pair_cost(const float4 vi, const float4 vj,
                                           const float* cf, int n_categories) {
  const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
  const float xj[4] = {vj.x, vj.y, vj.z, vj.w};
  float s_ij = 0.f;
  float s_ji = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < n_categories) {
      const float a = cf[4 * c], b = cf[4 * c + 1], g = cf[4 * c + 2],
                  r = cf[4 * c + 3];
      const float cross = __fmul_rn(xi[c], xj[c]);
      const float p_ij =
          __fmaf_rn(r, cross, __fmaf_rn(g, xj[c], __fmaf_rn(b, xi[c], a)));
      const float p_ji =
          __fmaf_rn(r, cross, __fmaf_rn(g, xi[c], __fmaf_rn(b, xj[c], a)));
      s_ij = __fadd_rn(s_ij, fmaxf(p_ij, 0.f));
      s_ji = __fadd_rn(s_ji, fmaxf(p_ji, 0.f));
    }
  }
  s_ij = fminf(fmaxf(s_ij, kMinSlowdown), kMaxSlowdown);
  s_ji = fminf(fmaxf(s_ji, kMinSlowdown), kMaxSlowdown);
  return __fadd_rn(s_ij, s_ji);
}

// Block b -> tile (bi, bj), bi <= bj, the upper triangle row by row; row bi
// starts at block bi * T - bi * (bi - 1) / 2.
__device__ __forceinline__ void tile_of(int b, int t, int& bi, int& bj) {
  const float w = 2.f * t + 1.f;
  int r = static_cast<int>((w - sqrtf(w * w - 8.f * b)) * 0.5f);
  r = max(0, min(r, t - 1));
  while (r > 0 && r * t - r * (r - 1) / 2 > b) --r;
  while (r + 1 < t && (r + 1) * t - (r + 1) * r / 2 <= b) ++r;
  bi = r;
  bj = r + b - (r * t - r * (r - 1) / 2);
}

template <bool kLanes>
__global__ void __launch_bounds__(kTile * kBlockRows)
pair_score_kernel(const Args a) {
  __shared__ float4 st_i[kTile];
  __shared__ float4 st_j[kTile];
  __shared__ bool ok_i[kTile];
  __shared__ bool ok_j[kTile];
  __shared__ float cf[16];
  __shared__ float tile[kTile][kTile + 1];
  __shared__ bool idle_on;

  // This block's lane: every pointer moves by its lane's stride.
  const size_t lane = kLanes ? blockIdx.y : 0;
  const float4* st = a.st + lane * a.st_rows;
  const unsigned char* valid =
      a.valid == nullptr ? nullptr : a.valid + lane * a.n_valid;
  const unsigned char* idle_flag =
      a.idle_flag == nullptr ? nullptr : a.idle_flag + lane;
  float* out = a.out + lane * a.p * a.p;

  int bi, bj;
  tile_of(blockIdx.x, a.tiles, bi, bj);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = bi * kTile;
  const int j0 = bj * kTile;

  // Stage the stacks (none at or past n_valid) and their validity.
  bool ok = true;
  if (tid < 2 * kTile) {
    const int l = tid % kTile;
    const int v = (tid < kTile ? i0 : j0) + l;
    const bool in = v < a.n_valid;
    const float4 x = in ? st[v] : make_float4(0.f, 0.f, 0.f, 0.f);
    ok = in && (valid == nullptr || valid[v]);
    if (tid < kTile) {
      st_i[l] = x;
      ok_i[l] = ok;
    } else {
      st_j[l] = x;
      ok_j[l] = ok;
    }
  } else if (tid < 2 * kTile + 16) {
    cf[tid - 2 * kTile] = a.coeffs[tid - 2 * kTile];
  } else if (tid == 2 * kTile + 16) {
    idle_on = idle_flag == nullptr || *idle_flag != 0;
  }
  // The barrier publishes the flag with the staged stacks.  Costs only:
  // every vertex valid, off the diagonal, away from the idle vertex.
  const bool all_ok = __syncthreads_and(ok);
  const int idle_row = idle_on ? a.idle_row : -1;
  const bool clean = all_ok && bi != bj &&
                     static_cast<unsigned>(idle_row - i0) >= kTile &&
                     static_cast<unsigned>(idle_row - j0) >= kTile;

  const int j = j0 + tx;
  const float4 vj = st_j[tx];
  const bool okj = ok_j[tx];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int li = ty + k * kBlockRows;
    const int i = i0 + li;
    const bool oki = ok_i[li];
    float cost;
    if (clean) {
      cost = pair_cost(st_i[li], vj, cf, a.n_categories);
    } else if ((i == idle_row && okj) || (j == idle_row && oki)) {
      cost = kIdleCost;
    } else if (!oki || !okj || i == j) {
      cost = kBig;
    } else {
      cost = pair_cost(st_i[li], vj, cf, a.n_categories);
    }
    if (i < a.p && j < a.p) out[static_cast<size_t>(i) * a.p + j] = cost;
    tile[li][tx] = cost;
  }
  if (bi == bj) return;
  __syncthreads();
  // The transpose: rows j0 + r, columns i0 + tx.
  const int i = i0 + tx;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = ty + k * kBlockRows;
    if (j0 + r < a.p && i < a.p) {
      out[static_cast<size_t>(j0 + r) * a.p + i] = tile[tx][r];
    }
  }
}

}  // namespace

// For each of `lanes` lanes: st: (st_rows >= n_valid, 4) float32, 16-byte
// aligned; valid: (n_valid,) bool or null; idle_flag: one bool or null;
// out: (p, p) float32; the lanes follow one another in each array.
// coeffs: (4, 4) float32 rows (alpha, beta, gamma, rho), shared.  Launches
// on `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int pair_score_launch(const void* st, const void* coeffs,
                                 const void* valid, const void* idle_flag,
                                 void* out, int p, int n_valid,
                                 int n_categories, int idle_row, int lanes,
                                 int st_rows, void* stream) {
  if (p <= 0 || lanes <= 0) return 0;
  Args a;
  a.st = static_cast<const float4*>(st);
  a.coeffs = static_cast<const float*>(coeffs);
  a.valid = static_cast<const unsigned char*>(valid);
  a.idle_flag = static_cast<const unsigned char*>(idle_flag);
  a.out = static_cast<float*>(out);
  a.p = p;
  a.n_valid = n_valid < p ? n_valid : p;
  a.n_categories = n_categories;
  a.idle_row = idle_row;
  a.tiles = (p + kTile - 1) / kTile;
  a.st_rows = st_rows;
  const dim3 grid(a.tiles * (a.tiles + 1) / 2, lanes);
  const dim3 block(kTile, kBlockRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes == 1) {
    pair_score_kernel<false><<<grid, block, 0, s>>>(a);
  } else {
    pair_score_kernel<true><<<grid, block, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
