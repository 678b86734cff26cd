// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (launched by
// rms_norm_pallas through ops.rms_norm).  For every row x of a (T, D)
// input it computes
//
//   y = x * rsqrt(mean(x * x) + eps) * scale
//
// with float32 statistics and a float32 scale, and stores y in x's type
// (float32 or bfloat16).
//
// What bounds it on an H100: bytes.  Each value is read once and written
// once: at (8192, 1024) float32 that is 67 MB, 20 us at 3.35 TB/s, against
// 3 operations a value.
//
// Design: one warp per row, 8 rows to a block of 256 threads, and no
// shared memory or barrier.  Lanes read 4 contiguous values at a time
// (16-byte loads in float32, 8-byte in bfloat16), so each warp load covers
// 512 contiguous bytes of a float32 row.  The first 8 such vectors of each
// lane (D up to 1024) stay in registers between the sum of squares and the
// scaled store, so a row is read from memory once; a longer row reads its
// tail a second time.  The sum is reduced across the warp by shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kCached = 8;  // 4-value vectors a lane keeps in registers

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&a);
  raw.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__device__ __forceinline__ void scale_store(T* yr, const float* __restrict__ scale,
                                            int vi, const float* x, float inv) {
  float sc[4], y[4];
  load4(scale + 4 * vi, sc);
#pragma unroll
  for (int u = 0; u < 4; ++u) y[u] = x[u] * inv * sc[u];
  store4(yr + 4 * vi, y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int nvec = d / 4;
  const T* xr = x + (size_t)row * d;
  T* yr = out + (size_t)row * d;

  float cache[kCached][4];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kCached; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      load4(xr + 4 * vi, cache[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) ss = fmaf(cache[i][u], cache[i][u], ss);
    }
  }
  for (int vi = lane + 32 * kCached; vi < nvec; vi += 32) {
    float v[4];
    load4(xr + 4 * vi, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) ss = fmaf(v[u], v[u], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < kCached; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) scale_store(yr, scale, vi, cache[i], inv);
  }
  for (int vi = lane + 32 * kCached; vi < nvec; vi += 32) {
    float v[4];
    load4(xr + 4 * vi, v);
    scale_store(yr, scale, vi, v, inv);
  }
}

}  // namespace

// x, out: (rows, d), contiguous, 16-byte aligned, dtype 0 = float32,
// 1 = bfloat16; scale: (d,) float32; d a multiple of 4.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), sc, static_cast<float*>(out), rows, d,
        eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc,
        static_cast<__nv_bfloat16*>(out), rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
