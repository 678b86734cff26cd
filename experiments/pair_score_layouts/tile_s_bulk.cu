// The kept pair_score kernel (src/repro_torch/kernels/pair_score/csrc/
// pair_score.cu) with the other store route: the tile and its transpose
// staged row-major in shared memory and written by one bulk asynchronous
// copy a row (cp.async.bulk.global.shared::cta).  Needs P % 4 == 0.

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
  float* out;                    // (p, p)
  int p, n_valid, n_categories, idle_row;
  int tiles;                     // tiles along a side
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

__global__ void __launch_bounds__(kTile * kBlockRows)
pair_score_kernel(const Args a) {
  __shared__ float4 st_i[kTile];
  __shared__ float4 st_j[kTile];
  __shared__ bool ok_i[kTile];
  __shared__ bool ok_j[kTile];
  __shared__ float cf[16];
  __shared__ float tile[kTile][kTile + 1];
  // Row-major staging of the tile (0) and its transpose (1).
  __shared__ __align__(128) float buf[2][kTile][kTile];

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
    const float4 x = in ? a.st[v] : make_float4(0.f, 0.f, 0.f, 0.f);
    ok = in && (a.valid == nullptr || a.valid[v]);
    if (tid < kTile) {
      st_i[l] = x;
      ok_i[l] = ok;
    } else {
      st_j[l] = x;
      ok_j[l] = ok;
    }
  } else if (tid < 2 * kTile + 16) {
    cf[tid - 2 * kTile] = a.coeffs[tid - 2 * kTile];
  }
  // Costs only: every vertex valid, off the diagonal, away from the idle
  // vertex.
  const bool clean = __syncthreads_and(ok) && bi != bj &&
                     static_cast<unsigned>(a.idle_row - i0) >= kTile &&
                     static_cast<unsigned>(a.idle_row - j0) >= kTile;

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
    } else if ((i == a.idle_row && okj) || (j == a.idle_row && oki)) {
      cost = kIdleCost;
    } else if (!oki || !okj || i == j) {
      cost = kBig;
    } else {
      cost = pair_cost(st_i[li], vj, cf, a.n_categories);
    }
    tile[li][tx] = cost;
    buf[0][li][tx] = cost;
  }
  __syncthreads();
  if (bi != bj) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int r = ty + k * kBlockRows;
      buf[1][r][tx] = tile[tx][r];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // One bulk store a row: threads 0-31 the tile's, 32-63 the transpose's.
  if (tid < 2 * kTile && (tid < kTile || bi != bj)) {
    const int h = tid / kTile, r = tid % kTile;
    const int row = (h ? j0 : i0) + r, col0 = h ? i0 : j0;
    if (row < a.p) {
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(a.out + static_cast<size_t>(row) * a.p + col0),
             "r"(static_cast<unsigned>(__cvta_generic_to_shared(&buf[h][r][0]))),
             "r"(static_cast<unsigned>(min(kTile, a.p - col0) * 4))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

}  // namespace

// st: (>= n_valid, 4) float32, 16-byte aligned; coeffs: (4, 4) float32
// rows (alpha, beta, gamma, rho); valid: (n_valid,) bool or null; out:
// (p, p) float32.  Launches on `stream` and returns the cudaError_t of the
// launch (0 on success).
extern "C" int launch_s_bulk(const void* st, const void* coeffs,
                                 const void* valid, void* out, int p,
                                 int n_valid, int n_categories, int idle_row,
                                 int n_sm, void* stream) {
  if (p <= 0 || p % 4) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.st = static_cast<const float4*>(st);
  a.coeffs = static_cast<const float*>(coeffs);
  a.valid = static_cast<const unsigned char*>(valid);
  a.out = static_cast<float*>(out);
  a.p = p;
  a.n_valid = n_valid < p ? n_valid : p;
  a.n_categories = n_categories;
  a.idle_row = idle_row;
  a.tiles = (p + kTile - 1) / kTile;
  const int blocks = a.tiles * (a.tiles + 1) / 2;
  pair_score_kernel<<<blocks, dim3(kTile, kBlockRows), 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
