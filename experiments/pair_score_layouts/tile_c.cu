// Variants C<kRpt>: old.cu's tiles (32 columns x 8*kRpt rows, 32 x 8 threads,
// each 1 column x kRpt rows) with the fused epilogue, and a block-uniform
// fast path for tiles with no sentinel and no idle edge.
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kTile = 32;
constexpr int kBlockRows = 8;
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kBig = 1e9f;
constexpr float kIdleCost = 2.0f;

struct Args {
  const float4* st; const float* coeffs; const unsigned char* valid; float* out;
  int p, n_valid, n_categories, idle_row, tiles;
};

__device__ __forceinline__ float pair_cost(const float4 vi, const float4 vj,
                                           const float* cf, int n_categories) {
  const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
  const float xj[4] = {vj.x, vj.y, vj.z, vj.w};
  float s_ij = 0.f, s_ji = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c < n_categories) {
      const float a = cf[4 * c], b = cf[4 * c + 1], g = cf[4 * c + 2],
                  r = cf[4 * c + 3];
      const float cross = __fmul_rn(xi[c], xj[c]);
      const float p_ij = __fmaf_rn(r, cross, __fmaf_rn(g, xj[c], __fmaf_rn(b, xi[c], a)));
      const float p_ji = __fmaf_rn(r, cross, __fmaf_rn(g, xi[c], __fmaf_rn(b, xj[c], a)));
      s_ij = __fadd_rn(s_ij, fmaxf(p_ij, 0.f));
      s_ji = __fadd_rn(s_ji, fmaxf(p_ji, 0.f));
    }
  }
  s_ij = fminf(fmaxf(s_ij, kMinSlowdown), kMaxSlowdown);
  s_ji = fminf(fmaxf(s_ji, kMinSlowdown), kMaxSlowdown);
  return __fadd_rn(s_ij, s_ji);
}

// Loads the tile's row and column stacks and validity into shared memory;
// returns, uniform over the block, whether the tile holds only costs.
template <int kRows>
__device__ __forceinline__ bool stage(const Args& a, int i0, int j0, int tid,
                                      float4* st_i, float4* st_j, bool* ok_i,
                                      bool* ok_j, float* cf) {
  bool ok = true;
  if (tid < kRows + kTile) {
    const bool row = tid < kRows;
    const int l = row ? tid : tid - kRows;
    const int v = (row ? i0 : j0) + l;
    const bool in = v < a.n_valid;
    const float4 x = in ? a.st[v] : make_float4(0.f, 0.f, 0.f, 0.f);
    ok = in && (a.valid == nullptr || a.valid[v]);
    if (row) { st_i[l] = x; ok_i[l] = ok; } else { st_j[l] = x; ok_j[l] = ok; }
  } else if (tid >= kTile * kBlockRows - 16) {
    cf[tid - (kTile * kBlockRows - 16)] = a.coeffs[tid - (kTile * kBlockRows - 16)];
  }
  const bool all_ok = __syncthreads_and(ok);
  const bool cross_diag = i0 < j0 + kTile && j0 < i0 + kRows;
  const bool idle_near = static_cast<unsigned>(a.idle_row - i0) < unsigned(kRows) ||
                         static_cast<unsigned>(a.idle_row - j0) < unsigned(kTile);
  return all_ok && !cross_diag && !idle_near;
}

__device__ __forceinline__ float entry(const Args& a, int i, int j, bool oki,
                                       bool okj, float4 vi, float4 vj,
                                       const float* cf) {
  if ((i == a.idle_row && okj) || (j == a.idle_row && oki)) return kIdleCost;
  if (!oki || !okj || i == j) return kBig;
  return pair_cost(vi, vj, cf, a.n_categories);
}

template <int kRpt>
__global__ void __launch_bounds__(kTile * kBlockRows) tiles_kernel(const Args a) {
  constexpr int kRows = kBlockRows * kRpt;
  __shared__ float4 st_i[kRows];
  __shared__ float4 st_j[kTile];
  __shared__ bool ok_i[kRows];
  __shared__ bool ok_j[kTile];
  __shared__ float cf[16];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kTile;
  const bool clean = stage<kRows>(a, i0, j0, tid, st_i, st_j, ok_i, ok_j, cf);
  const int j = j0 + tx;
  if (j >= a.p) return;
  const float4 vj = st_j[tx];
  const bool okj = ok_j[tx];
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int li = ty + k * kBlockRows, i = i0 + li;
    if (i >= a.p) break;
    const float cost = clean ? pair_cost(st_i[li], vj, cf, a.n_categories)
                             : entry(a, i, j, ok_i[li], okj, st_i[li], vj, cf);
    a.out[static_cast<size_t>(i) * a.p + j] = cost;
  }
}

Args make(const void* st, const void* coeffs, const void* valid, void* out,
          int p, int n_valid, int n_categories, int idle_row) {
  Args a{static_cast<const float4*>(st), static_cast<const float*>(coeffs),
         static_cast<const unsigned char*>(valid), static_cast<float*>(out), p,
         n_valid < p ? n_valid : p, n_categories, idle_row, (p + kTile - 1) / kTile};
  return a;
}

template <int kRpt>
int go(const Args& a, void* stream) {
  const dim3 grid(a.tiles, (a.p + kBlockRows * kRpt - 1) / (kBlockRows * kRpt));
  tiles_kernel<kRpt><<<grid, dim3(kTile, kBlockRows), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

#define ENTRY(name, ...)                                                      \
  extern "C" int name(const void* st, const void* coeffs, const void* valid,  \
                      void* out, int p, int n_valid, int n_categories,        \
                      int idle_row, int n_sm, void* stream) {                 \
    if (p <= 0) return 0;                                                      \
    const Args a = make(st, coeffs, valid, out, p, n_valid, n_categories,     \
                        idle_row);                                             \
    __VA_ARGS__                                                                \
  }
ENTRY(launch_c2, return go<2>(a, stream);)
ENTRY(launch_c4, return go<4>(a, stream);)
ENTRY(launch_c8, return go<8>(a, stream);)
