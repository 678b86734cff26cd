// One-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::_decode_kernel (launched by
// decode_attention_pallas through ops.decode_attention).  For every batch
// row b and query head h = hk * G + g (G = Hq / Hkv) it computes
//
//   out[b, h] = sum_j softmax_j(q[b, h] . k[b, j, hk] / sqrt(D)) v[b, j, hk]
//
// over the cache positions j in [max(0, len_b - window + 1), len_b]
// (inclusive; the lower bound only when window > 0), clipped to the
// cache.  A row with no such position is written as 0.  Scores and
// accumulators are float32 for float32 and bfloat16 caches; the output is
// stored in the inputs' type.
//
// What bounds it on an H100: bytes.  Each valid K and V row is read once:
// at 8 slots x 4096 positions x 16 KV heads x D 64 in float32 that is
// 268 MB, 80 us at 3.35 TB/s, against under 0.2 GFLOP of work.
//
// Design: one block of 256 threads per (KV head, batch row), carrying all
// G query heads of that KV head, so each K/V row crosses the memory bus
// once whatever G is.  Only the valid span is read.  Each of the 8 warps
// walks its own positions, KPW at a time: lane l loads D / 32 contiguous
// values of each of the KPW K and V rows before any arithmetic, so every
// warp keeps 2 KB (KPW * D * 4 B * 2) of loads in flight.  Each warp keeps
// its own online softmax (running max, sum and the lane's slice of the
// float32 accumulator) for each of the G heads, with the dot products
// reduced across the warp by shuffles; at the end the 8 partial results
// are merged through shared memory.  At 128 blocks (8 x 16) this is under
// one wave of the 132 SMs: splitting the sequence across blocks
// (split-KV with a combine step) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* v) {
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = x.x; v[1] = x.y;
}
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

// E contiguous values (E = 2, 4 or 8) into float registers.
template <int E, typename T>
__device__ __forceinline__ void load_e(const T* p, float* v) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) load4(p + 4 * i, v + 4 * i);
  } else {
    load2(p, v);
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int s_len, int hkv, int g, int window, float scale) {
  constexpr int E = D / 32;     // values of a row per lane
  constexpr int KPW = 16 / E;   // positions a warp loads at once
  extern __shared__ float smem[];  // kWarps x g x (D + 2)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hq = hkv * g;

  const int length = lengths[b];
  const int hi = min(length, s_len - 1);
  const int lo = window > 0 ? max(0, length - window + 1) : 0;

  float qr[GMAX][E];
  float acc[GMAX][E];
  float m[GMAX], l[GMAX];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[gi][e] = 0.f;
      acc[gi][e] = 0.f;
    }
    if (gi < g)
      load_e<E>(q + ((size_t)b * hq + hk * g + gi) * D + lane * E, qr[gi]);
  }

  const size_t row_stride = (size_t)hkv * D;
  const T* k_base = kc + ((size_t)b * s_len * hkv + hk) * D + lane * E;
  const T* v_base = vc + ((size_t)b * s_len * hkv + hk) * D + lane * E;

  for (int base = lo + warp * KPW; base <= hi; base += kWarps * KPW) {
    float kr[KPW][E], vr[KPW][E];
#pragma unroll
    for (int u = 0; u < KPW; ++u) {
      if (base + u <= hi) {
        load_e<E>(k_base + (size_t)(base + u) * row_stride, kr[u]);
        load_e<E>(v_base + (size_t)(base + u) * row_stride, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi >= g) break;
      float s[KPW];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[gi][e], kr[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u] = base + u <= hi ? dot * scale : -INFINITY;
        mx = fmaxf(mx, s[u]);
      }
      // base <= hi, so mx is finite.
      const float m_new = fmaxf(m[gi], mx);
      const float alpha = expf(m[gi] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] *= alpha;
#pragma unroll
      for (int u = 0; u < KPW; ++u) {
        const float p = base + u <= hi ? expf(s[u] - m_new) : 0.f;
        sum += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(p, vr[u][e], acc[gi][e]);
      }
      l[gi] = l[gi] * alpha + sum;
      m[gi] = m_new;
    }
  }

  // Merge the warps' partial softmaxes.
  float* part = smem + (size_t)warp * g * (D + 2);
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi) {
    if (gi >= g) break;
    float* slot = part + gi * (D + 2);
#pragma unroll
    for (int e = 0; e < E; ++e) slot[2 + lane * E + e] = acc[gi][e];
    if (lane == 0) {
      slot[0] = m[gi];
      slot[1] = l[gi];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < g * D; idx += kThreads) {
    const int gi = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, smem[((size_t)w * g + gi) * (D + 2)]);
    float l_tot = 0.f;
    float o = 0.f;
    if (mx > -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float* slot = smem + ((size_t)w * g + gi) * (D + 2);
        if (slot[0] == -INFINITY) continue;
        const float wt = expf(slot[0] - mx);
        l_tot += slot[1] * wt;
        o += slot[2 + d] * wt;
      }
    }
    store1(out + ((size_t)b * hq + hk * g + gi) * D + d,
           l_tot > 0.f ? o / l_tot : 0.f);
  }
}

template <typename T, int D, int GMAX>
int launch(const void* q, const void* kc, const void* vc, const int* lengths,
           void* out, int b, int s_len, int hkv, int g, int window,
           float scale, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, D, GMAX>;
  const int smem = kWarps * g * (D + 2) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(hkv, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), lengths, static_cast<T*>(out), s_len, hkv,
      g, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const void* q, const void* kc, const void* vc,
             const int* lengths, void* out, int b, int s_len, int hkv, int g,
             int window, float scale, cudaStream_t stream) {
  if (g == 1)
    return launch<T, D, 1>(q, kc, vc, lengths, out, b, s_len, hkv, g, window,
                           scale, stream);
  if (g <= 8)
    return launch<T, D, 8>(q, kc, vc, lengths, out, b, s_len, hkv, g, window,
                           scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_dim(int d, const void* q, const void* kc, const void* vc,
           const int* lengths, void* out, int b, int s_len, int hkv, int g,
           int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return by_group<T, 64>(q, kc, vc, lengths, out, b, s_len, hkv, g,
                             window, scale, stream);
    case 128:
      return by_group<T, 128>(q, kc, vc, lengths, out, b, s_len, hkv, g,
                              window, scale, stream);
    case 256:
      return by_group<T, 256>(q, kc, vc, lengths, out, b, s_len, hkv, g,
                              window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, hkv * g, d); k_cache, v_cache: (b, s_len, hkv, d); lengths: (b,)
// int32; out: (b, hkv * g, d).  All contiguous and 16-byte aligned, q and
// the caches of one type: dtype 0 = float32, 1 = bfloat16.  d is 64, 128
// or 256, g at most 8.  Launches on `stream` and returns the cudaError_t of
// the launch (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* lengths, void* out, int b,
                                       int s_len, int hkv, int g, int d,
                                       int window, float scale, int dtype,
                                       void* stream) {
  if (b <= 0 || hkv <= 0 || g <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0)
    return by_dim<float>(d, q, k_cache, v_cache, len, out, b, s_len, hkv, g,
                         window, scale, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(d, q, k_cache, v_cache, len, out, b, s_len,
                                 hkv, g, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
