// The "default" precision's products (core/precision.py): bf16 operands,
// fp32 accumulation, on the tensor cores through mma.sync.
//
// Replaces no TPU kernel by itself: it is what the bf16 instances of the
// layer kernel (stream_layer.cuh), the weight gradient (fused_step.cuh) and
// the DGM engine's gemm_kernel (dgm_train.cu) share, the counterpart of the
// TPU's MXU at lax.Precision.DEFAULT inside the JAX package's kernels.
//
// Global buffers and the kernels' cp.async rings stay fp32: each operand is
// rounded to bf16 (round to nearest even, __float2bfloat16_rn) where a warp
// builds its register fragment of a product from the fp32 tile in shared
// memory, so each value is rounded exactly once per product, as a TPU rounds
// each operand of a jnp.dot at DEFAULT. A product of two bf16 values is
// exact in fp32; the tensor core sums the products of one mma in its own
// order, and the chains of mma over k run in a fixed order, so a run is
// bit-reproducible. (Fragments are built by 32-bit shared-memory loads and a
// conversion, not by ldmatrix, which would need a bf16 copy of each tile in
// shared memory beside the fp32 ring the "highest" instances stage.)
//
// The tile is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: a warp
// multiplies a 16 × 16 A tile (row-major) by a 16 × 8 B tile (column-major)
// into a 16 × 8 fp32 accumulator. Lane l = 4·g + t (g = l / 4, t = l mod 4)
// holds
//   A: (g, 2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9)
//   B: (k = 2t..2t+1, n = g), (k = 2t+8..2t+9, n = g)
//   C: (g, 2t..2t+1), (g+8, 2t..2t+1)
// each pair in one 32-bit register, the lower index in the lower half.
#pragma once

#include <cuda_bf16.h>

namespace dednn {
namespace {

// x rounded to bf16 (nearest even) and back: the value a "default" product
// sees of an operand. Applied where the small products (D ≤ 4 inputs, one
// output column) load their operands; their fp32 FFMA chains then multiply
// exactly.
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x as a kBf16 product's operand: rounded when kBf16, else unchanged.
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBf16)
    return bf16r(x);
  else
    return x;
}

// Two floats rounded to bf16 in one register, lo in the lower half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// d += a·b on one warp's m16n8k16 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The lane's A fragment of the 16 × 16 tile whose element (r, k) is a(r, k)
// (fp32, rounded here).
template <class F>
__device__ __forceinline__ void frag_a(F a, unsigned (&f)[4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = 2 * (lane % 4);
  f[0] = pack_bf16(a(g, t), a(g, t + 1));
  f[1] = pack_bf16(a(g + 8, t), a(g + 8, t + 1));
  f[2] = pack_bf16(a(g, t + 8), a(g, t + 9));
  f[3] = pack_bf16(a(g + 8, t + 8), a(g + 8, t + 9));
}

// The lane's B fragment of the 16 × 8 tile whose element (k, n) is b(k, n).
template <class F>
__device__ __forceinline__ void frag_b(F b, unsigned (&f)[2]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = 2 * (lane % 4);
  f[0] = pack_bf16(b(t, g), b(t + 1, g));
  f[1] = pack_bf16(b(t + 8, g), b(t + 9, g));
}

// Hands the lane's four accumulator entries to store(r, n, value), at the
// tile's rows r < 16 and columns n < 8.
template <class F>
__device__ __forceinline__ void frag_c(const float (&d)[4], F store) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = 2 * (lane % 4);
  store(g, t, d[0]);
  store(g, t + 1, d[1]);
  store(g + 8, t, d[2]);
  store(g + 8, t + 1, d[3]);
}

// The output tiles of a kRows × kCols block product split over kWarps warps:
// kTiles m16n8 tiles, warp w taking tiles w, w + kWarps, ... (kPer at
// most), so every warp's share is fixed at compile time.
template <int kRows, int kCols, int kWarps>
struct MmaTiles {
  static_assert(kCols % 8 == 0, "whole n-tiles");
  static_assert(kWarps >= 1, "at least one whole warp");
  static constexpr int kMT = (kRows + 15) / 16, kNT = kCols / 8;
  static constexpr int kTiles = kMT * kNT;
  static constexpr int kPer = (kTiles + kWarps - 1) / kWarps;
};

}  // namespace
}  // namespace dednn
