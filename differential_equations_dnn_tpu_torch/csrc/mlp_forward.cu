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
// per tile of rows. The tile's activations stay in shared memory between
// layers, so a row leaves the SM only as its output. Each layer's weight
// matrix passes through shared memory in k-tiles of kTileK rows by
// kColsChunk columns (32 KB, unrolled float4 loads), so the block's shared
// memory grows with H, not H²: 2 · rows · (max(D, H, O) + 1) floats of
// activations plus the tile. The rows per block (32, 16 or 8) are the most
// whose activations fit the 227 KB a block may take (32 up to H = 779, 16
// up to 1 559, 8 up to 3 119); mlp_forward_rows reports 0 past that. Each
// thread keeps a register tile of kRowsPerWarp rows x kColsPerLane columns
// across the k-tiles of its column chunk, so every output is one fmaf chain
// over k in ascending order. The kernel masks the ragged last tile itself.
// Products are fp32 FFMA: exact fp32, no tensor cores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kColsPerLane = 4;
constexpr int kColsChunk = 32 * kColsPerLane;  // columns of one w_s tile
constexpr int kTileK = 64;                      // rows of W per w_s tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may take

// out_s[r, :] = act(in_s[r, :] @ w + b) for the block's rows. Warp w owns
// rows kRowsPerWarp * w.., lane l the columns l, l + 32, ... of each chunk
// of kColsChunk (conflict-free reads of w_s; in_s reads are broadcasts).
// For each chunk the k range is staged kTileK rows at a time, in order.
template <int kRowsPerWarp>
__device__ void dense_layer(const float* in_s, int ld, int k_in,
                            const float* __restrict__ w,
                            const float* __restrict__ b, int k_out,
                            float* out_s, float* w_s, int act) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * kRowsPerWarp;
  for (int j0 = 0; j0 < k_out; j0 += kColsChunk) {
    const int cw = min(kColsChunk, k_out - j0);
    int col[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      col[c] = min(lane + 32 * c, cw - 1);
    float acc[kRowsPerWarp][kColsPerLane] = {};
    for (int k0 = 0; k0 < k_in; k0 += kTileK) {
      const int kk = min(kTileK, k_in - k0);
      __syncthreads();  // w_s is free, and in_s is written
      dednn::stage(w_s, kColsChunk, w + static_cast<size_t>(k0) * k_out + j0,
                   k_out, kk, cw);
      __syncthreads();
      for (int k = 0; k < kk; ++k) {
        float wk[kColsPerLane];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          wk[c] = w_s[k * kColsChunk + col[c]];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float x = in_s[(r0 + r) * ld + k0 + k];
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c)
            acc[r][c] = fmaf(x, wk[c], acc[r][c]);
        }
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

template <int kRowsPerWarp>
__global__ void mlp_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ w_in,
    const float* __restrict__ b_in, const float* __restrict__ w_hid,
    const float* __restrict__ b_hid, const float* __restrict__ w_out,
    const float* __restrict__ b_out, float* __restrict__ y, int n, int d,
    int h, int l, int o, int act) {
  constexpr int kRows = kRowsPerWarp * kWarps;
  extern __shared__ float smem[];
  const int ld = max(d, max(h, o)) + 1;
  float* w_s = smem;
  float* buf0 = w_s + kTileK * kColsChunk;
  float* buf1 = buf0 + kRows * ld;
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    buf0[r * ld + c] =
        row0 + r < n ? x[static_cast<size_t>(row0 + r) * d + c] : 0.0f;
  }
  dense_layer<kRowsPerWarp>(buf0, ld, d, w_in, b_in, h, buf1, w_s, act);
  float* in = buf1;
  float* out = buf0;
  for (int layer = 0; layer < l; ++layer) {
    dense_layer<kRowsPerWarp>(in, ld, h,
                              w_hid + static_cast<size_t>(layer) * h * h,
                              b_hid + static_cast<size_t>(layer) * h, h, out,
                              w_s, act);
    float* tmp = in;
    in = out;
    out = tmp;
  }
  dense_layer<kRowsPerWarp>(in, ld, h, w_out, b_out, o, out, w_s, -1);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * o; i += blockDim.x) {
    const int r = i / o, j = i - r * o;
    if (row0 + r < n) y[static_cast<size_t>(row0 + r) * o + j] = out[r * ld + j];
  }
}

size_t smem_bytes(int rows, int d, int h, int o) {
  const size_t ld = std::max({d, h, o}) + 1;
  return (static_cast<size_t>(kTileK) * kColsChunk + 2 * rows * ld) *
         sizeof(float);
}

// The most rows per block (32, 16 or 8) whose activations fit; 0 if none.
int plan_rows(int d, int h, int o) {
  for (int rows : {32, 16, 8})
    if (smem_bytes(rows, d, h, o) <= kSmemLimit) return rows;
  return 0;
}

template <int kRowsPerWarp>
cudaError_t launch(const float* x, const float* w_in, const float* b_in,
                   const float* w_hid, const float* b_hid, const float* w_out,
                   const float* b_out, float* y, int n, int d, int h, int l,
                   int o, int act, cudaStream_t stream) {
  constexpr int kRows = kRowsPerWarp * kWarps;
  const size_t smem = smem_bytes(kRows, d, h, o);
  cudaError_t err =
      dednn::allow_smem(mlp_forward_kernel<kRowsPerWarp>, smem);
  if (err != cudaSuccess) return err;
  mlp_forward_kernel<kRowsPerWarp>
      <<<dednn::ceil_div(n, kRows), kThreads, smem, stream>>>(
          x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h, l, o, act);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows per block of mlp_forward at these widths (0: no tile fits).
extern "C" int mlp_forward_rows(int d, int h, int o) {
  return plan_rows(d, h, o);
}

// Shared memory per block of mlp_forward at these widths.
extern "C" long long mlp_forward_smem_bytes(int d, int h, int o) {
  const int rows = plan_rows(d, h, o);
  return rows == 0 ? -1 : static_cast<long long>(smem_bytes(rows, d, h, o));
}

extern "C" int mlp_forward(const float* x, const float* w_in,
                           const float* b_in, const float* w_hid,
                           const float* b_hid, const float* w_out,
                           const float* b_out, float* y, int n, int d, int h,
                           int l, int o, int act, void* stream) {
  if (n == 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan_rows(d, h, o)) {
    case 32:
      return launch<4>(x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h,
                       l, o, act, st);
    case 16:
      return launch<2>(x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h,
                       l, o, act, st);
    case 8:
      return launch<1>(x, w_in, b_in, w_hid, b_hid, w_out, b_out, y, n, d, h,
                       l, o, act, st);
    default:
      return cudaErrorInvalidValue;
  }
}
