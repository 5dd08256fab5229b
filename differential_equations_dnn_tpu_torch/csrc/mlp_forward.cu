// The plain MLP forward: y = act(...act(x W_in + b_in)...) W_out + b_out.
//
// Replaces: differential_equations_dnn_tpu/kernels/taylor_mlp.py::_mlp_kernel
// (reached through mlp_forward_pallas), the batch-tiled forward with the
// weights resident on the chip.
//
// What bounds it on the H100: at the grid-evaluation shape (1600 x 2 ->
// 128 x 3 -> 1) the work is about 0.16 GFLOP of fp32 and the weights are
// 200 KB, so neither the fp32 pipes nor HBM are the limit; the launch and
// each block's load of the weights from L2 are.
//
// What the design does about it: one launch for the whole grid, one block
// per tile of kRows rows. Each layer's weight matrix is copied once per
// block into dynamic shared memory (64 KB at H = 128) with unrolled float4
// loads; the tile's activations stay in shared memory between layers, so a
// row leaves the SM only as its output. Each thread keeps a register tile
// of kRowsPerWarp rows x kColsPerLane columns (16 FMA per 8 shared loads).
// The kernel masks the ragged last tile itself. Products are fp32 FFMA:
// exact fp32, no tensor cores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kColsPerLane = 4;
constexpr int kThreads = 256;
constexpr int kRows = kRowsPerWarp * kThreads / 32;

// out_s[r, :] = act(in_s[r, :] @ w + b) for the block's kRows rows. Warp w
// owns rows kRowsPerWarp * w.., lane l the columns l, l + 32, ... of each
// group of 32 * kColsPerLane (conflict-free reads of w_s; in_s reads are
// broadcasts).
__device__ void dense_layer(const float* in_s, int ld, int k_in,
                            const float* __restrict__ w,
                            const float* __restrict__ b, int k_out,
                            float* out_s, float* w_s, int act) {
  __syncthreads();  // the previous layer is done with w_s and in_s is written
  dednn::stage(w_s, k_out, w, k_out, k_in, k_out);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  for (int j0 = 0; j0 < k_out; j0 += 32 * kColsPerLane) {
    int col[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      col[c] = min(j0 + lane + 32 * c, k_out - 1);
    float acc[kRowsPerWarp][kColsPerLane] = {};
    for (int k = 0; k < k_in; ++k) {
      float wk[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) wk[c] = w_s[k * k_out + col[c]];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float x = in_s[(r0 + r) * ld + k];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[r][c] = fmaf(x, wk[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int j = j0 + lane + 32 * c;
      if (j >= k_out) continue;
      const float bj = b[j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float z = acc[r][c] + bj;
        out_s[(r0 + r) * ld + j] = act < 0 ? z : dednn::activate(act, z);
      }
    }
  }
}

__global__ void mlp_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ y, int n, int d,
    int h, int l, int o, int act) {
  extern __shared__ float smem[];
  const int ld = max(d, max(h, o)) + 1;
  float* w_s = smem;
  float* buf0 = w_s + max(d * h, max(h * h, h * o));
  float* buf1 = buf0 + kRows * ld;
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    buf0[r * ld + c] =
        row0 + r < n ? x[static_cast<size_t>(row0 + r) * d + c] : 0.0f;
  }
  dense_layer(buf0, ld, d, w_in, b_in, h, buf1, w_s, act);
  float* in = buf1;
  float* out = buf0;
  for (int layer = 0; layer < l; ++layer) {
    dense_layer(in, ld, h, w_hid + static_cast<size_t>(layer) * h * h,
                b_hid + static_cast<size_t>(layer) * h, h, out, w_s, act);
    float* tmp = in;
    in = out;
    out = tmp;
  }
  dense_layer(in, ld, h, w_out, b_out, o, out, w_s, -1);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * o; i += blockDim.x) {
    const int r = i / o, j = i - r * o;
    if (row0 + r < n) y[static_cast<size_t>(row0 + r) * o + j] = out[r * ld + j];
  }
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int mlp_forward(const float* x, const float* w_in,
                           const float* b_in, const float* w_hid,
                           const float* b_hid, const float* w_out,
                           const float* b_out, float* y, int n, int d, int h,
                           int l, int o, int act, void* stream) {
  if (n == 0) return cudaSuccess;
  const int ld = std::max({d, h, o}) + 1;
  const size_t smem =
      (static_cast<size_t>(std::max({d * h, h * h, h * o})) + 2 * kRows * ld) *
      sizeof(float);
  cudaError_t err = dednn::allow_smem(mlp_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  mlp_forward_kernel<<<dednn::ceil_div(n, kRows), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h, l, o, act);
  return cudaGetLastError();
}
