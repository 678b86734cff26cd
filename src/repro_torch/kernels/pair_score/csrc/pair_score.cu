// All-pairs Eq. 4 pair cost (paper Step 2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/pair_score/kernel.py::_pair_score_kernel (launched by
// pair_score_pallas).  For every ordered pair (i, j) of the P padded
// vertices it computes
//
//   s_ij = clip(sum_{c < C} relu(a_c + b_c x_ic + g_c x_jc + r_c x_ic x_jc),
//               0.25, 16)
//
// and s_ji in the same pass, writes cost[i, j] = s_ij + s_ji, and writes the
// DIAG = 1e9 sentinel on the diagonal and on every row or column at or past
// n_valid.
//
// What bounds it on an H100: the P^2 float32 output writes.  At
// P = fused_pad(1024) = 1032 that is 4.26 MB, about 1.3 us at the card's
// 3.35 TB/s; the inputs are P x 16 bytes and the arithmetic (about 40
// float32 operations an entry) sits below the memory time.  At that size
// the kernel is shorter than a launch, so on the main path it is
// launch-bound.  No single PyTorch call computes this function, so there
// is no library yardstick beside it.
//
// Design: a 2-D grid of 32 x 32 output tiles, one 32 x 8 thread block per
// tile.  The block stages its 32 row stacks and 32 column stacks in shared
// memory as float4 and the 16 coefficients beside them (read from device
// memory, so the caller never copies them to the host); each thread then
// writes 4 rows of one column, so a warp stores 32 consecutive floats of a
// row and every store coalesces.  The category loop runs c < n_categories
// exactly as the TPU kernel does.  The TPU kernel's 128 x 128 VMEM blocks
// are not copied: here a small tile keeps enough blocks in flight to fill
// 132 SMs at P = 1032 (33 x 33 = 1089 blocks).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;
constexpr int kBlockRows = kTile / kRowsPerThread;  // 8 -> 256 threads
constexpr float kMinSlowdown = 0.25f;
constexpr float kMaxSlowdown = 16.0f;
constexpr float kDiag = 1e9f;

__global__ void __launch_bounds__(kTile * kBlockRows)
pair_score_kernel(const float4* __restrict__ st,
                  const float* __restrict__ coeffs,
                  float* __restrict__ out,
                  int p, int n_valid, int n_categories) {
  __shared__ float4 st_i[kTile];
  __shared__ float4 st_j[kTile];
  __shared__ float cf[16];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if (tid < kTile) {
    const int r = i0 + tid;
    st_i[tid] = r < p ? st[r] : zero;
  } else if (tid < 2 * kTile) {
    const int c = j0 + tid - kTile;
    st_j[tid - kTile] = c < p ? st[c] : zero;
  } else if (tid < 2 * kTile + 16) {
    cf[tid - 2 * kTile] = coeffs[tid - 2 * kTile];
  }
  __syncthreads();

  const int j = j0 + tx;
  if (j >= p) return;
  const float4 vj = st_j[tx];
  const float xj[4] = {vj.x, vj.y, vj.z, vj.w};

#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int li = ty + k * kBlockRows;
    const int i = i0 + li;
    if (i >= p) break;
    float cost;
    if (i == j || i >= n_valid || j >= n_valid) {
      cost = kDiag;
    } else {
      const float4 vi = st_i[li];
      const float xi[4] = {vi.x, vi.y, vi.z, vi.w};
      float s_ij = 0.f;
      float s_ji = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < n_categories) {
          const float a = cf[4 * c + 0];
          const float b = cf[4 * c + 1];
          const float g = cf[4 * c + 2];
          const float r = cf[4 * c + 3];
          const float cross = xi[c] * xj[c];
          s_ij += fmaxf(a + b * xi[c] + g * xj[c] + r * cross, 0.f);
          s_ji += fmaxf(a + b * xj[c] + g * xi[c] + r * cross, 0.f);
        }
      }
      s_ij = fminf(fmaxf(s_ij, kMinSlowdown), kMaxSlowdown);
      s_ji = fminf(fmaxf(s_ji, kMinSlowdown), kMaxSlowdown);
      cost = s_ij + s_ji;
    }
    out[static_cast<size_t>(i) * p + j] = cost;
  }
}

}  // namespace

// st: (p, 4) float32, 16-byte aligned; coeffs: (4, 4) float32 rows
// (alpha, beta, gamma, rho); out: (p, p) float32.  Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
extern "C" int pair_score_launch(const void* st, const void* coeffs,
                                 void* out, int p, int n_valid,
                                 int n_categories, void* stream) {
  if (p <= 0) return 0;
  const int tiles = (p + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles);
  const dim3 block(kTile, kBlockRows);
  pair_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(st), static_cast<const float*>(coeffs),
      static_cast<float*>(out), p, n_valid, n_categories);
  return static_cast<int>(cudaGetLastError());
}
