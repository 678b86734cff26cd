// Prefill flash attention (online softmax, GQA, causal / sliding window)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_fa_kernel (launched by
// flash_attention_pallas through ops.flash_attention).  For every batch b,
// query head h and query row i it computes
//
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) v[b, j, h / G]
//
// over the keys j with  j < Skv,  j <= i (causal),  j > i - window
// (window > 0); G = Hq / Hkv, so query head h reads KV head h / G.  A row
// with no such key is written as 0, as the TPU kernel's l == 0 guard does.
// Inputs and output keep the model's (B, S, H, D) layout: the kernel reads
// rows with their strides, so the wrapper neither transposes nor pads.
// Scores, running max, running sum and accumulator are float32 for float32
// and bfloat16 inputs; the output is stored in the inputs' type.
//
// What bounds it on an H100: operations.  At the serving prefill
// (B 4, S 2048, 16 heads, D 64, causal) the useful work is 34.4 GFLOP of
// float32 (4 D flops per unmasked (i, j) pair), 0.51 ms at the card's
// 67 TFLOP/s outside the tensor cores, against 33.5 MB of q, k, v and out
// (10 us at 3.35 TB/s).
//
// Design: one block of 256 threads per (query tile of BQ rows, query head,
// batch).  The block stages its Q tile once, then walks the KV tiles of BK
// keys that its rows can see, staging K and V in shared memory: the loop
// starts at the window's first tile and stops at the causal edge, so fully
// masked tiles are never loaded (the TPU kernel executes them).  Each tile
// is three phases separated by barriers: S = Q K^T as 16 x 16 threads with
// register micro-tiles (K and Q rows padded by one float so the column
// reads do not collide in a bank); the online-softmax update, one warp per
// row at a time; O += P V with the accumulator in registers, each thread
// owning BQ/16 rows x D/16 columns.  Tiles (BQ, BK) are (64, 64) at D 64,
// (64, 32) at D 128 and (32, 32) at D 256, so shared memory stays at 67,
// 75 and 103 KB: two to three blocks share an SM and the D 256 accumulator
// stays at 32 registers a thread.  Query tiles are issued last-first so
// the longest causal rows start first.  The products run on the float32
// pipes, not the tensor cores: wgmma tiles and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int D, int BQ, int BK>
struct Smem {
  static constexpr int kQ = 0;                              // BQ x (D + 1)
  static constexpr int kK = kQ + BQ * (D + 1);              // BK x (D + 1)
  static constexpr int kV = kK + BK * (D + 1);              // BK x D
  static constexpr int kS = kV + BK * D;                    // BQ x (BK + 1)
  static constexpr int kM = kS + BQ * (BK + 1);             // BQ
  static constexpr int kL = kM + BQ;                        // BQ
  static constexpr int kAlpha = kL + BQ;                    // BQ
  static constexpr int kFloats = kAlpha + BQ;
  static constexpr int kBytes = kFloats * 4;
};

// Stage `rows` rows of D values, starting at sequence position `pos0`, from
// a (B, S, H, D) tensor into shared memory with row stride `ld`; rows at or
// past `s_len` are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      int rows, int pos0, int s_len,
                                      size_t row_stride, int tid) {
  for (int e = tid; e < rows * D / 4; e += kThreads) {
    const int r = (4 * e) / D;
    const int c = (4 * e) % D;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (pos0 + r < s_len) load4(src + (size_t)(pos0 + r) * row_stride + c, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[r * ld + c + u] = v[u];
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int sq, int skv, int hq, int hkv, int causal,
                       int window, float scale) {
  static_assert(BQ % 16 == 0 && BK % 32 == 0 && D % 16 == 0, "tile shape");
  constexpr int TQ = BQ / 16;   // query rows per thread
  constexpr int TK = BK / 16;   // score columns per thread
  constexpr int TD = D / 16;    // output columns per thread
  using L = Smem<D, BQ, BK>;
  extern __shared__ float smem[];
  float* qs = smem + L::kQ;
  float* ks = smem + L::kK;
  float* vs = smem + L::kV;
  float* ss = smem + L::kS;
  float* m_s = smem + L::kM;
  float* l_s = smem + L::kL;
  float* alpha_s = smem + L::kAlpha;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);

  const size_t q_stride = (size_t)hq * D;
  const size_t kv_stride = (size_t)hkv * D;
  const T* q_base = q + ((size_t)b * sq * hq + h) * D;
  const T* k_base = k + ((size_t)b * skv * hkv + hk) * D;
  const T* v_base = v + ((size_t)b * skv * hkv + hk) * D;

  stage<T, D>(qs, D + 1, q_base, BQ, q0, sq, q_stride, tid);
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // The keys any row of this tile can see: [kv_lo, kv_hi).
  const int q_last = min(q0 + BQ, sq) - 1;
  int kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;

  float acc[TQ][TD];
#pragma unroll
  for (int r = 0; r < TQ; ++r)
#pragma unroll
    for (int c = 0; c < TD; ++c) acc[r][c] = 0.f;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage<T, D>(ks, D + 1, k_base, BK, k0, skv, kv_stride, tid);
    stage<T, D>(vs, D, v_base, BK, k0, skv, kv_stride, tid);
    __syncthreads();

    // S = Q K^T * scale, masked by global position.
    float s[TQ][TK];
#pragma unroll
    for (int r = 0; r < TQ; ++r)
#pragma unroll
      for (int c = 0; c < TK; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TQ], kv[TK];
#pragma unroll
      for (int r = 0; r < TQ; ++r) qv[r] = qs[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < TK; ++c) kv[c] = ks[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
#pragma unroll
        for (int c = 0; c < TK; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      const int qpos = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        const int kpos = k0 + tx + 16 * c;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        ss[(ty + 16 * r) * (BK + 1) + tx + 16 * c] =
            ok ? s[r][c] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one warp per row, BK / 32 scores a lane.
    for (int row = warp; row < BQ; row += kThreads / 32) {
      float sv[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < BK / 32; ++n) {
        sv[n] = ss[row * (BK + 1) + lane + 32 * n];
        mx = fmaxf(mx, sv[n]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      // A row with nothing seen yet keeps m = kNegInf; exp(0) must not
      // count its masked entries.
      const bool safe = m_new > kNegInf * 0.5f;
      const float alpha = safe ? expf(m_prev - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 32; ++n) {
        const float p = safe ? expf(sv[n] - m_new) : 0.f;
        ss[row * (BK + 1) + lane + 32 * n] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = alpha * l_s[row] + sum;
        alpha_s[row] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V.
#pragma unroll
    for (int r = 0; r < TQ; ++r) {
      const float a = alpha_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TD; ++c) acc[r][c] *= a;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TQ], vv[TD];
#pragma unroll
      for (int r = 0; r < TQ; ++r) pv[r] = ss[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < TD; ++c) vv[c] = vs[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
#pragma unroll
        for (int c = 0; c < TD; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }
  __syncthreads();

  T* o_base = out + ((size_t)b * sq * hq + h) * D;
#pragma unroll
  for (int r = 0; r < TQ; ++r) {
    const int row = ty + 16 * r;
    if (q0 + row >= sq) continue;
    const float l = l_s[row];
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll
    for (int c = 0; c < TD; ++c)
      store1(o_base + (size_t)(q0 + row) * q_stride + tx + 16 * c,
             acc[r][c] * inv);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  using L = Smem<D, BQ, BK>;
  auto kernel = flash_attention_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, skv, hq, hkv,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             int b, int sq, int skv, int hq, int hkv, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 64, 64>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                   window, scale, stream);
    case 128:
      return launch<T, 128, 64, 32>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                    window, scale, stream);
    case 256:
      return launch<T, 256, 32, 32>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                                    window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (b, sq, hq, d); k, v: (b, skv, hkv, d); out: (b, sq, hq, d); all
// contiguous, 16-byte aligned, of one type: dtype 0 = float32,
// 1 = bfloat16.  d is 64, 128 or 256 and hq a multiple of hkv.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, b, sq, skv, hq, hkv, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, b, sq, skv, hq, hkv,
                                   causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
