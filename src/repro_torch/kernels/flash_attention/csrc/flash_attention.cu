// Prefill flash attention (online softmax, GQA, causal / sliding window)
// for Hopper (sm_90a), with both products on the tensor cores (wgmma).
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
// What bounds it on an H100: tensor-core operations.  At the serving
// prefill (B 4, S 2048, 16 heads, D 64, causal) the useful work is 34.4
// GFLOP of float32 (4 D flops per unmasked (i, j) pair).  Each float32
// product is three TF32 products here (below), so the least time is
// 3 x 34.4 G / 495 TFLOP/s = 0.21 ms, against 33.5 MB of q, k, v and out
// (10 us at 3.35 TB/s).
//
// float32 accuracy (3xTF32): an operand x is split into hi = x rounded to
// TF32 (10 mantissa bits, round to nearest) and lo = x - hi rounded again;
// a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, three products into one float32
// accumulator, keeps float32's accuracy (a single TF32 product is off by
// ~1e-3 on a D 64 score).  bfloat16 inputs take one bf16 product each,
// P rounded to bfloat16.
//
// Route, float32: both products are warpgroup wgmma.mma_async m64nNk8
// TF32 instructions, A from registers and B from shared memory, float32
// accumulators in registers.  A TF32 B operand must be K-major in shared
// memory and its hi/lo split must exist there, so a pre-pass (prep_kernel,
// same launch sequence) writes, per KV head and tile of BK keys, the
// hi and lo planes of K (keys x D, D contiguous) and of V^T (D x keys,
// keys contiguous) in wgmma's no-swizzle layout of 8 x 16-byte core
// matrices, zero past Skv, into scratch the wrapper allocates.  The main
// loop then only copies contiguous tiles.
//
// Route, bfloat16: both products are wgmma m64n64k16 bf16 instructions,
// A from registers.  There is no pre-pass: the ring's copies put K and V
// rows straight from (B, S, H, D) into core matrices, K K-major for
// Q K^T and V N-major (wgmma's transpose bit, which 16-bit types have)
// for P V; Q's fragments are its bf16 pairs as they stand.
//
// Design: one block of W warpgroups per (query tile of 64 W rows, query
// head, batch); each warpgroup owns 64 rows.  Q is staged once as it is;
// the K/V tiles come into a two-stage ring in shared memory by cp.async
// (16-byte copies), the next tile loading while this tile's products and
// softmax run.  S = Q K^T: Q's A fragments are read from shared memory for
// every KV tile, a chunk at a time, and in float32 split in registers, 3
// wgmmas per 8 columns (held split in registers, Q would take 64 more
// registers a thread at D 64 and leave one block an SM, not two).  The
// scores stay in the accumulator fragments: scale, mask (only on tiles
// that cut the causal diagonal, the window's edge or Skv, by each
// element's (row, column)), row max by quad shuffles, exp2 and the
// rescale of O all run in registers, and P is the A operand of
// O += P V straight from the S fragments.  float32: P split
// hi/lo; the pre-pass stores each 8-key group of V^T in the order (0, 2,
// 4, 6, 1, 3, 5, 7), which is the order in which a thread's accumulator
// holds P's columns.  bfloat16: two 8-column groups of S are one k16 A
// fragment as they stand, packed into pairs.  The loop visits only the KV
// tiles a query tile can see (from the window's first tile to the causal
// edge) and query tiles are issued longest-first.  Tiles (W, BK), float32:
// D 64 (2, 32), 100 KB of shared memory and at most 128 registers, so two
// blocks share an SM; D 128 (2, 32), 199 KB; D 256 (1, 16), 198 KB.
// bfloat16: D 64 (2, 64), 50 KB, two blocks an SM; D 128 (2, 64), 98 KB;
// D 256 (1, 64), 161 KB.
//
// Not overlapped yet: a warpgroup waits for each batch of wgmmas before it
// touches their registers, so its tensor-core work and its softmax take
// turns; only the other warpgroups on the SM fill the gaps.  Tried on the
// card and not kept, all slower or no faster: the same arithmetic as
// mma.sync.m16n8k8 (with and without a pre-pass into (hi, lo) pairs), and
// Q in shared memory with the next tile's Q K^T issued before this tile's
// softmax (ptxas serialised those wgmmas).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ~ hi + lo, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// --- wgmma m64nNk8, TF32 in, float32 accumulators, A from registers -------
// d[N / 2] accumulates A (64 x 8: this thread's 4 fragment registers) times
// B (N x 8, K-major in shared memory, described by b); scale_d 0 clears d.
__device__ __forceinline__ void wgmma_n16(float* d, const uint32_t a[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t a[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t a[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t a[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float* d, const uint32_t a[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma(float* d, const uint32_t a[4],
                                      uint64_t b, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256, "N");
  if constexpr (N == 16) wgmma_n16(d, a, b, scale_d);
  if constexpr (N == 32) wgmma_n32(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_n64(d, a, b, scale_d);
  if constexpr (N == 128) wgmma_n128(d, a, b, scale_d);
  if constexpr (N == 256) wgmma_n256(d, a, b, scale_d);
}

// --- wgmma m64n64k16, bfloat16 in, float32 accumulators, A from registers
// d[32] accumulates A (64 x 16: 4 registers of bf16 pairs, the lower column
// in the low half) times B (64 x 16 in shared memory, described by b;
// kTransB 0: K-major, 1: N-major); scale_d 0 clears d.
template <int kTransB>
__device__ __forceinline__ void wgmma_bf16_n64(float* d, const uint32_t a[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kTransB));
}

// A B operand in shared memory without swizzle, in core matrices of 8
// rows x 16 contiguous bytes (128 bytes): core matrices adjacent in K are
// `k_bytes` apart (LBO), adjacent in M/N `mn_bytes` apart (SBO).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t k_bytes,
                                              uint32_t mn_bytes) {
  const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a >> 4) & 0x3FFF) | (uint64_t{(k_bytes >> 4) & 0x3FFF} << 16) |
         (uint64_t{(mn_bytes >> 4) & 0x3FFF} << 32);
}
// K-major, core matrices adjacent in K 128 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(const void* p,
                                              uint32_t group_bytes) {
  return smem_desc(p, 128, group_bytes);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
struct Config;
template <> struct Config<float, 64> {
  static constexpr int W = 2, BK = 32, kMinBlocks = 2;
};
template <> struct Config<float, 128> {
  static constexpr int W = 2, BK = 32, kMinBlocks = 1;
};
template <> struct Config<float, 256> {
  static constexpr int W = 1, BK = 16, kMinBlocks = 1;
};
template <> struct Config<__nv_bfloat16, 64> {
  static constexpr int W = 2, BK = 64, kMinBlocks = 2;
};
template <> struct Config<__nv_bfloat16, 128> {
  static constexpr int W = 2, BK = 64, kMinBlocks = 1;
};
template <> struct Config<__nv_bfloat16, 256> {
  static constexpr int W = 1, BK = 64, kMinBlocks = 1;
};

template <typename T, int D>
struct Tile {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int W = Config<T, D>::W;       // warpgroups per block
  static constexpr int BK = Config<T, D>::BK;     // keys per KV tile
  static constexpr int kThreads = 128 * W;
  static constexpr int BQ = 64 * W;               // query rows per block
  static constexpr int LDQ = D + 16 / sizeof(T);  // padded Q row
  // float32: TF32 hi and lo planes of K and V^T, from the pre-pass.
  static constexpr int kPlanes = 2;
  static constexpr int kPlane = BK * D;           // floats in one plane
  // One KV tile in a ring stage, in floats: float32, the K planes, then
  // the V^T planes (also one tile of the scratch); bfloat16, the K tile,
  // then the V tile, each BK x D bf16.
  static constexpr int kTile = kBf16 ? BK * D : 2 * kPlanes * kPlane;
  static constexpr int kBytes = BQ * LDQ * sizeof(T) + 2 * kTile * 4;
};

// The pre-pass, one block of kPrepThreads per (tile of BK keys, kv head,
// batch): k, v (B, Skv, Hkv, D) -> the tile's K planes (key n, column c at
// (n / 8) 8 D + (c / 4) 32 + (n % 8) 4 + c % 4) and V^T planes (column c,
// key slot s at (c / 8) 8 BK + (s / 4) 32 + (c % 8) 4 + s % 4, where slot s
// of an 8-key group holds key 2 s (s < 4) or 2 (s - 4) + 1), hi then lo.
// The tile is read row by row into shared memory and written out in
// output order, so both sides are coalesced.  float32 only: bfloat16
// reads K and V as they are.
constexpr int kPrepThreads = 256;

template <int D>
__global__ void __launch_bounds__(kPrepThreads)
prep_kernel(const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ kv, int skv, int hkv) {
  using L = Tile<float, D>;
  constexpr int BK = L::BK, LD = D + 4;  // padded: conflict-free reads
  __shared__ float ks[BK * LD], vs[BK * LD];
  const int n_tiles = (skv + BK - 1) / BK;
  const int tile = blockIdx.x, hk = blockIdx.y, bb = blockIdx.z;
  for (int e = threadIdx.x; e < BK * D; e += kPrepThreads) {
    const int n = e / D, c = e % D, key = tile * BK + n;
    float xk = 0.f, xv = 0.f;
    if (key < skv) {
      const size_t src = (((size_t)bb * skv + key) * hkv + hk) * D + c;
      xk = k[src];
      xv = v[src];
    }
    ks[n * LD + c] = xk;
    vs[n * LD + c] = xv;
  }
  __syncthreads();
  float* kt = kv + (((size_t)bb * hkv + hk) * n_tiles + tile) * L::kTile;
  float* vt = kt + L::kPlanes * L::kPlane;
  for (int o = threadIdx.x; o < L::kPlane; o += kPrepThreads) {
    uint32_t hi, lo;
    int rem = o % (8 * D);
    int n = (o / (8 * D)) * 8 + (rem % 32) / 4;
    int c = (rem / 32) * 4 + o % 4;
    split(ks[n * LD + c], hi, lo);
    kt[o] = __uint_as_float(hi);
    kt[L::kPlane + o] = __uint_as_float(lo);
    rem = o % (8 * BK);
    c = (o / (8 * BK)) * 8 + (rem % 32) / 4;
    const int s = (rem / 32) * 4 + o % 4, j = s % 8;
    n = (s / 8) * 8 + (j < 4 ? 2 * j : 2 * (j - 4) + 1);
    split(vs[n * LD + c], hi, lo);
    vt[o] = __uint_as_float(hi);
    vt[L::kPlane + o] = __uint_as_float(lo);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<T, D>::kThreads,
                                  Config<T, D>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ kv,
                       T* __restrict__ out, int sq, int skv, int hq, int hkv,
                       int causal, int window, float scale) {
  using L = Tile<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK, LDQ = L::LDQ, NTH = L::kThreads;
  constexpr int NS = BK / 2;   // S accumulators a thread holds
  constexpr int NO = D / 2;    // O accumulators a thread holds
  constexpr bool kBf16 = L::kBf16;
  // Q K^T steps of k (8 columns in TF32, 16 in bf16) per wgmma batch.
  constexpr int kStep = kBf16 ? 16 : 8, kChunk = 4;
  static_assert((D / kStep) % kChunk == 0, "Q chunks");
  static_assert(!kBf16 || BK == 64, "bf16 S tiles are one n64 wgmma wide");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);      // 2 x kTile floats
  T* qs = reinterpret_cast<T*>(ring + 2 * L::kTile);     // BQ x LDQ

  const int tid = threadIdx.x;
  const int wg = tid / 128;                 // this thread's warpgroup
  const int g = (tid % 32) / 4;             // fragment row group
  const int t = tid % 4;                    // thread in group
  const int row0 = wg * 64 + ((tid % 128) / 32) * 16 + g;  // row in tile
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int hk = h / (hq / hkv);
  const int n_tiles_all = (skv + BK - 1) / BK;

  const size_t q_stride = (size_t)hq * D;
  const T* q_base = q + ((size_t)b * sq * hq + h) * D;
  const float* kv_base = kv + ((size_t)b * hkv + hk) * n_tiles_all * L::kTile;
  const size_t kv_stride = (size_t)hkv * D;  // between keys, bfloat16
  const size_t kv_head = (size_t)b * skv * hkv * D + (size_t)hk * D;

  // The keys any row of this tile can see: [kv_lo, kv_hi).
  const int q_last = min(q0 + BQ, sq) - 1;
  int kv_hi = skv;
  if (causal) kv_hi = min(kv_hi, q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BK) * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  // Q rows as they are (zero past Sq), and the first KV tile.
  {
    constexpr int kVec = 16 / sizeof(T), kPerRow = D / kVec;
    for (int e = tid; e < BQ * kPerRow; e += NTH) {
      const int r = e / kPerRow, c = (e % kPerRow) * kVec;
      const bool ok = q0 + r < sq;
      cp_async16(qs + r * LDQ + c,
                 q_base + (size_t)(ok ? q0 + r : 0) * q_stride + c,
                 ok ? 16 : 0);
    }
  }
  auto load_tile = [&](int tile, int stage) {
    if constexpr (kBf16) {
      // K (key n, column c) at (n / 8) 8 D + (c / 8) 64 + (n % 8) 8 + c % 8:
      // K-major core matrices.  V at (c / 8) 8 BK + (n / 8) 64 + (n % 8) 8
      // + c % 8: N-major core matrices.  Keys past Skv are zero.  Eight
      // threads in a row copy one core matrix: 8 keys' 16 bytes of a
      // column group, 128 contiguous bytes in shared memory.
      T* kd = reinterpret_cast<T*>(ring + stage * L::kTile);
      T* vd = kd + BK * D;
      for (int e = tid; e < BK * D / 8; e += NTH) {
        const int n8 = e % 8, c8 = (e / 8) % (D / 8), ng = e / D;
        const int key = tile * BK + 8 * ng + n8;
        const bool ok = key < skv;
        const size_t src = kv_head + (size_t)(ok ? key : 0) * kv_stride + 8 * c8;
        cp_async16(kd + ng * 8 * D + c8 * 64 + n8 * 8, k + src, ok ? 16 : 0);
        cp_async16(vd + c8 * 8 * BK + ng * 64 + n8 * 8, v + src, ok ? 16 : 0);
      }
    } else {
      const float* src = kv_base + (size_t)tile * L::kTile;
      float* dst = ring + stage * L::kTile;
      for (int e = tid; e < L::kTile / 4; e += NTH)
        cp_async16(dst + 4 * e, src + 4 * e, 16);
    }
  };
  if (n_tiles > 0) load_tile(kv_lo / BK, 0);
  cp_async_commit();

  const float sl2 = scale * kLog2e;  // scores in log2 units
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kv_lo + it * BK;
    const int st = it & 1;
    if (it + 1 < n_tiles) load_tile(k0 / BK + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // all but the tile just requested have landed
    // wgmma reads shared memory through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const float* kt = ring + st * L::kTile;

    // S = Q K^T, a chunk of Q's columns at a time.  float32: Q split into
    // hi and lo, 3 wgmmas per 8 columns; bfloat16: Q's pairs as they are,
    // one wgmma per 16 columns.
    float s[NS];
#pragma unroll
    for (int c0 = 0; c0 < D / kStep; c0 += kChunk) {
      uint32_t ah[kChunk][4], al[kChunk][4];
#pragma unroll
      for (int kc = 0; kc < kChunk; ++kc) {
        if constexpr (kBf16) {
          const T* qr = qs + row0 * LDQ + (c0 + kc) * 16 + 2 * t;
          ah[kc][0] = *reinterpret_cast<const uint32_t*>(qr);
          ah[kc][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDQ);
          ah[kc][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
          ah[kc][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * LDQ + 8);
        } else {
          const T* qr = qs + row0 * LDQ + (c0 + kc) * 8 + t;
          split(qr[0], ah[kc][0], al[kc][0]);
          split(qr[8 * LDQ], ah[kc][1], al[kc][1]);
          split(qr[4], ah[kc][2], al[kc][2]);
          split(qr[8 * LDQ + 4], ah[kc][3], al[kc][3]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kChunk; ++kc) {
        if constexpr (kBf16) {
          // + 256 B per 16 columns; 8-key groups 16 D bytes apart.
          const T* kb = reinterpret_cast<const T*>(kt) + (c0 + kc) * 128;
          wgmma_bf16_n64<0>(s, ah[kc], smem_desc(kb, 16 * D), c0 + kc > 0);
        } else {
          const float* kb = kt + (c0 + kc) * 64;  // + 256 B per 8 columns
          const uint64_t bh = smem_desc(kb, 32 * D);
          const uint64_t bl = smem_desc(kb + L::kPlane, 32 * D);
          wgmma<BK>(s, ah[kc], bh, c0 + kc > 0);
          wgmma<BK>(s, ah[kc], bl, 1);
          wgmma<BK>(s, al[kc], bh, 1);
        }
      }
      wgmma_commit();
      wgmma_wait();
    }

    // Scale; mask by global (row, column) on tiles that need it.
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int row = q0 + row0 + ((i % 4) >= 2 ? 8 : 0);
        const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        bool ok = col < skv;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        if (!ok) x = -INFINITY;
      }
      s[i] = x;
    }

    // Online softmax on the fragments: a thread holds rows row0 and
    // row0 + 8; a row's four threads are one quad.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);
      // A row that has seen no key keeps m = -inf: exp2(-inf - 0) = 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[hr] - m_use);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 4; ++j)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = exp2f(s[4 * j + e] - m_use);
          s[4 * j + e] = p;
          sum += p;
        }
      l[hr] = l[hr] * alpha + sum;  // this thread's share
#pragma unroll
      for (int j = 0; j < NO / 4; ++j) {
        o[4 * j + 2 * hr] *= alpha;
        o[4 * j + 2 * hr + 1] *= alpha;
      }
    }

    if constexpr (kBf16) {
      // O += P V: P's A fragment for keys 16 kc.. is S's 8-column groups
      // 2 kc and 2 kc + 1 as they stand, packed into bf16 pairs; V is
      // N-major, one n64 wgmma per 64 columns of O.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
      const T* vb = reinterpret_cast<const T*>(kt) + BK * D;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
        for (int j = 0; j < D / 64; ++j)
          // 16 keys = two core matrices, 128 B apart; 8 columns 16 BK B.
          wgmma_bf16_n64<1>(o + 32 * j, pa[kc],
                            smem_desc(vb + j * 64 * BK + kc * 128, 128,
                                      16 * BK), 1);
    } else {
      // O += P V: P's A fragment for key slots (t, t + 4) of group kc is
      // the S accumulator pair (2t, 2t + 1) as it stands.
      const float* vt = kt + L::kPlanes * L::kPlane;
      uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        split(s[4 * kc + 0], ph[kc][0], pl[kc][0]);
        split(s[4 * kc + 2], ph[kc][1], pl[kc][1]);
        split(s[4 * kc + 1], ph[kc][2], pl[kc][2]);
        split(s[4 * kc + 3], ph[kc][3], pl[kc][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 8; ++kc) {
        const float* vb = vt + kc * 64;  // + 256 B per 8 key slots
        const uint64_t bh = smem_desc(vb, 32 * BK);
        const uint64_t bl = smem_desc(vb + L::kPlane, 32 * BK);
        wgmma<D>(o, ph[kc], bh, 1);
        wgmma<D>(o, ph[kc], bl, 1);
        wgmma<D>(o, pl[kc], bh, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    __syncthreads();  // this stage is free for the tile after next
  }
  cp_async_wait<0>();

  T* o_base = out + ((size_t)b * sq * hq + h) * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lsum = l[hr];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int row = q0 + row0 + 8 * hr;
    if (row >= sq) continue;
    const float inv = lsum == 0.f ? 0.f : 1.f / lsum;
    T* orow = o_base + (size_t)row * q_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j)
      store2(orow + 8 * j, o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* scratch, int b, int sq, int skv, int hq, int hkv,
           int causal, int window, float scale, cudaStream_t stream) {
  using L = Tile<T, D>;
  if (!L::kBf16 && skv > 0) {
    const dim3 prep_grid((skv + L::BK - 1) / L::BK, hkv, b);
    prep_kernel<D><<<prep_grid, kPrepThreads, 0, stream>>>(
        static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(scratch), skv, hkv);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hq, b, (sq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(scratch),
      static_cast<T*>(out), sq, skv, hq, hkv, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             void* scratch, int b, int sq, int skv, int hq, int hkv,
             int causal, int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, scratch, b, sq, skv, hq, hkv, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, scratch, b, sq, skv, hq, hkv,
                            causal, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, scratch, b, sq, skv, hq, hkv,
                            causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pre-pass's scratch for float32 inputs (bfloat16 needs none).
long long scratch_floats(int d, int b, int skv, int hkv) {
  auto n = [&](int bk, int planes) {
    return 2LL * planes * b * hkv * ((skv + bk - 1) / bk) * bk * d;
  };
  switch (d) {
    case 64: return n(Tile<float, 64>::BK, Tile<float, 64>::kPlanes);
    case 128: return n(Tile<float, 128>::BK, Tile<float, 128>::kPlanes);
    case 256: return n(Tile<float, 256>::BK, Tile<float, 256>::kPlanes);
    default: return -1;
  }
}

}  // namespace

// The float32 scratch `flash_attention_launch` needs for K and V's
// pre-split planes, in units of 16 floats (so that it fits an int);
// dtype 0 = float32, 1 = bfloat16 (0: it reads K and V as they are).
// -1 for an unsupported d or dtype.
extern "C" int flash_attention_scratch(int b, int skv, int hkv, int d,
                                       int dtype) {
  const long long n = scratch_floats(d, b, skv, hkv);
  if (dtype == 1) return n < 0 ? -1 : 0;
  if (dtype != 0) return -1;
  return n < 0 ? -1 : static_cast<int>(n / 16);
}

// q: (b, sq, hq, d); k, v: (b, skv, hkv, d); out: (b, sq, hq, d); all
// contiguous, 16-byte aligned, of one type: dtype 0 = float32,
// 1 = bfloat16.  scratch: 16 x flash_attention_scratch(...) floats,
// 16-byte aligned.  d is 64, 128 or 256 and hq a multiple of hkv.
// Launches the pre-pass (float32) and the attention kernel on `stream`
// and returns the cudaError_t of the first launch that failed (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* scratch,
                                      int b, int sq, int skv, int hq, int hkv,
                                      int d, int causal, int window,
                                      float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || hq <= 0) return 0;
  if (b > 65535 || hkv > 65535 || (sq + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, out, scratch, b, sq, skv, hq, hkv,
                           causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, scratch, b, sq, skv, hq,
                                   hkv, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
