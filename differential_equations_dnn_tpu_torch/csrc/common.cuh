// Shared helpers of the package's CUDA kernels.
//
// Every product here is a plain fp32 FFMA (no tensor cores, no TF32): the
// port's "highest" precision is exact IEEE fp32, as the JAX package's
// lax.Precision.HIGHEST is. The "default" precision's bf16 products (the
// kernels' kBf16 instances) are in mma_bf16.cuh. Built without --use_fast_math, so tanhf, expf,
// sinf, sqrtf and division are the accurate CUDA versions.
#pragma once

#include <cuda_runtime.h>

namespace dednn {

enum Activation : int { kTanh = 0, kRelu = 1, kSigmoid = 2 };

__device__ __forceinline__ float activate(int kind, float z) {
  switch (kind) {
    case kTanh:
      return tanhf(z);
    case kRelu:
      return fmaxf(z, 0.0f);
    default:
      return 1.0f / (1.0f + expf(-z));
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The largest grid y or z extent: the packed engines put the replica (or
// replica × stream) index there.
constexpr int kMaxGridYZ = 65535;

// p + off, or nullptr for an absent operand: the packed engines move each
// pointer to its replica's copy.
template <class T>
__device__ __forceinline__ T* shift(T* p, size_t off) {
  return p == nullptr ? p : p + off;
}

// dst[r * ld_dst + c] = src[r * ld_src + c] for r < rows, c < cols, by all
// threads of the block. Aligned sources go as float4 loads, unrolled so
// that many are in flight at once.
__device__ inline void stage(float* dst, int ld_dst,
                             const float* __restrict__ src, int ld_src,
                             int rows, int cols) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  if (cols % 4 == 0 && ld_src % 4 == 0 &&
      reinterpret_cast<size_t>(src) % 16 == 0) {
    const int q = cols / 4;
#pragma unroll 8
    for (int i = tid; i < rows * q; i += n_threads) {
      const int r = i / q, c = 4 * (i - r * q);
      const float4 v = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(r) * ld_src + c);
      float* d = dst + r * ld_dst + c;
      d[0] = v.x;
      d[1] = v.y;
      d[2] = v.z;
      d[3] = v.w;
    }
  } else {
    for (int i = tid; i < rows * cols; i += n_threads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld_dst + c] = src[static_cast<size_t>(r) * ld_src + c];
    }
  }
}

// Lets a kernel take more than the default 48 KB of dynamic shared memory
// (Hopper allows up to 227 KB per block).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace dednn

extern "C" const char* error_string(int code);
