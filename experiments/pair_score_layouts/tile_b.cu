// Variant B: tiles of kRows rows x 4*kQuads columns, 256 threads, each
// thread 4 consecutive columns of one row, one 16-byte store (scalar when
// P % 4 != 0); fused epilogue; n_valid-bounded loads.
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kBig = 1e9f;
constexpr float kIdleCost = 2.0f;

template <int kRows, int kQuads, bool kVec>
__global__ void __launch_bounds__(kRows * kQuads)
pair_score_kernel(const float4* __restrict__ st, const float* __restrict__ coeffs,
                  const unsigned char* __restrict__ valid, float* __restrict__ out,
                  int p, int n_valid, int n_categories, int idle_row) {
  constexpr int kCols = 4 * kQuads;
  __shared__ float4 st_i[kRows];
  __shared__ float4 st_j[kCols];
  __shared__ bool ok_i[kRows];
  __shared__ bool ok_j[kCols];
  __shared__ float cf[16];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kRows, j0 = blockIdx.x * kCols;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < kRows + kCols) {
    const bool row = tid < kRows;
    const int l = row ? tid : tid - kRows;
    const int v = (row ? i0 : j0) + l;
    const bool in = v < n_valid;
    const float4 x = in ? st[v] : zero;
    const bool ok = in && (valid == nullptr || valid[v]);
    if (row) { st_i[l] = x; ok_i[l] = ok; } else { st_j[l] = x; ok_j[l] = ok; }
  }
  if (tid >= kRows * kQuads - 16) cf[tid - (kRows * kQuads - 16)] = coeffs[tid - (kRows * kQuads - 16)];
  __syncthreads();
  const int q = tid % kQuads, li = tid / kQuads;
  const int i = i0 + li, jq = j0 + 4 * q;
  if (i >= p || jq >= p) return;
  const float4 vi = st_i[li];
  const bool oki = ok_i[li];
  const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
  float t[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = jq + u;
    const bool okj = ok_j[4 * q + u];
    float cost;
    if ((i == idle_row && okj) || (j == idle_row && oki)) {
      cost = kIdleCost;
    } else if (!oki || !okj || i == j) {
      cost = kBig;
    } else {
      const float4 vj = st_j[4 * q + u];
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
      cost = __fadd_rn(s_ij, s_ji);
    }
    t[u] = cost;
  }
  float* row = out + static_cast<size_t>(i) * p;
  if (kVec) {
    *reinterpret_cast<float4*>(row + jq) = make_float4(t[0], t[1], t[2], t[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) if (jq + u < p) row[jq + u] = t[u];
  }
}

template <int kRows, int kQuads>
int go(const void* st, const void* coeffs, const void* valid, void* out, int p,
       int n_valid, int n_categories, int idle_row, void* stream) {
  const dim3 grid((p + 4 * kQuads - 1) / (4 * kQuads), (p + kRows - 1) / kRows);
  auto* s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kern) {
    kern<<<grid, kRows * kQuads, 0, s>>>(
        static_cast<const float4*>(st), static_cast<const float*>(coeffs),
        static_cast<const unsigned char*>(valid), static_cast<float*>(out), p,
        n_valid < p ? n_valid : p, n_categories, idle_row);
  };
  if (p % 4 == 0) args(pair_score_kernel<kRows, kQuads, true>);
  else args(pair_score_kernel<kRows, kQuads, false>);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" int launch_b1(const void* st, const void* coeffs, const void* valid,
                         void* out, int p, int n_valid, int n_categories,
                         int idle_row, int n_sm, void* stream) {
  if (p <= 0) return 0;
  return go<32, 8>(st, coeffs, valid, out, p, n_valid, n_categories, idle_row, stream);
}
extern "C" int launch_b2(const void* st, const void* coeffs, const void* valid,
                         void* out, int p, int n_valid, int n_categories,
                         int idle_row, int n_sm, void* stream) {
  if (p <= 0) return 0;
  return go<16, 16>(st, coeffs, valid, out, p, n_valid, n_categories, idle_row, stream);
}
extern "C" int launch_b3(const void* st, const void* coeffs, const void* valid,
                         void* out, int p, int n_valid, int n_categories,
                         int idle_row, int n_sm, void* stream) {
  if (p <= 0) return 0;
  return go<8, 32>(st, coeffs, valid, out, p, n_valid, n_categories, idle_row, stream);
}
