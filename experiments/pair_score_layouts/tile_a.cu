// Variant A: old.cu's 32 x 32 tiles (32 x 8 threads, each 1 column x 4 rows,
// scalar coalesced stores) with the fused epilogue and n_valid-bounded loads.
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kTile / kRowsPerThread;
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kBig = 1e9f;
constexpr float kIdleCost = 2.0f;

__global__ void __launch_bounds__(kTile * kBlockRows)
pair_score_kernel(const float4* __restrict__ st, const float* __restrict__ coeffs,
                  const unsigned char* __restrict__ valid, float* __restrict__ out,
                  int p, int n_valid, int n_categories, int idle_row) {
  __shared__ float4 st_i[kTile];
  __shared__ float4 st_j[kTile];
  __shared__ bool ok_i[kTile];
  __shared__ bool ok_j[kTile];
  __shared__ float cf[16];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 2 * kTile) {
    const int l = tid & (kTile - 1);
    const int v = (tid < kTile ? i0 : j0) + l;
    const bool in = v < n_valid;
    const float4 x = in ? st[v] : zero;
    const bool ok = in && (valid == nullptr || valid[v]);
    if (tid < kTile) { st_i[l] = x; ok_i[l] = ok; }
    else { st_j[l] = x; ok_j[l] = ok; }
  } else if (tid < 2 * kTile + 16) {
    cf[tid - 2 * kTile] = coeffs[tid - 2 * kTile];
  }
  __syncthreads();
  const int j = j0 + tx;
  if (j >= p) return;
  const float4 vj = st_j[tx];
  const bool okj = ok_j[tx];
  const float xj[4] = {vj.x, vj.y, vj.z, vj.w};
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int li = ty + k * kBlockRows;
    const int i = i0 + li;
    if (i >= p) break;
    const bool oki = ok_i[li];
    float cost;
    if ((i == idle_row && okj) || (j == idle_row && oki)) {
      cost = kIdleCost;
    } else if (!oki || !okj || i == j) {
      cost = kBig;
    } else {
      const float4 vi = st_i[li];
      const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
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
      cost = __fadd_rn(s_ij, s_ji);
    }
    out[static_cast<size_t>(i) * p + j] = cost;
  }
}
}  // namespace

extern "C" int launch_a(const void* st, const void* coeffs,
                                 const void* valid, void* out, int p,
                                 int n_valid, int n_categories, int idle_row,
                                 int n_sm, void* stream) {
  if (p <= 0) return 0;
  const int tiles = (p + kTile - 1) / kTile;
  pair_score_kernel<<<dim3(tiles, tiles), dim3(kTile, kBlockRows), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(st), static_cast<const float*>(coeffs),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), p,
      n_valid < p ? n_valid : p, n_categories, idle_row);
  return static_cast<int>(cudaGetLastError());
}
