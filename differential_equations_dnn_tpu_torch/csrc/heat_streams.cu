// The heat step's 7 network evaluations through a plain MLP, in one launch:
// the interior value u, its x-, xx- and t-tangent streams (Taylor rules),
// and the IC and two boundary forwards.
//
// Replaces: differential_equations_dnn_tpu/kernels/taylor_mlp.py::_heat_kernel
// (reached through _heat_streams_fwd_impl and heat_fused_streams_pallas),
// the batch-tiled 7-stream forward behind Heat1D(taps="pallas").
//
// Streams, per point: 0 value at xt, 1 x-tangent (seed e_x = (1, 0)),
// 2 xx-tangent (seed 0), 3 t-tangent (seed e_t = (0, 1)), 4 IC at x0,
// 5 and 6 the boundaries at xb1, xb2. Each layer computes z = a W; the bias
// goes to the value streams {0, 4, 5, 6} only (a constant has no
// derivative). Streams 0-3 take the Taylor rules driven by stream 0's
// pre-activation, streams 4-6 the plain activation; the output layer has no
// activation.
//
// What bounds it on the H100: at heat's shape (B = 64, 2 -> 128x3 -> 1) the
// work is 44.4 MFLOP of fp32 (0.66 us at 67 TFLOP/s) against 204 KB of
// points and weights (0.06 us at 3.35 TB/s), so operations bound it on
// paper; at 8 blocks, each block's weight staging and its serial chain of
// layers do.
//
// What the design does about it: the TPU tile of 256 points x 7 streams x
// 128 wide is 917 KB per activation buffer, four times what an H100 block
// may take (227 KB). Here a block takes kPoints = 8 points, one per warp:
// its two activation buffers (7 kPoints x (H + 1) floats each) and one
// layer's W (64 KB at H = 128) stay in dynamic shared memory between
// layers, so a point leaves the SM only as its 7 outputs. A lane holds, for
// its warp's point and kColsPerLane columns, the accumulators of all 7
// streams, so each W value read from shared memory feeds 7 FFMAs and the
// Taylor rules of streams 1-3 read stream 0's pre-activation from
// registers. The kernel builds the 7 input rows itself and masks the ragged
// last tile. Products are fp32 FFMA: exact fp32, no tensor cores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kD = 2;  // the heat inputs are (x, t)
constexpr int kStreams = 7;
constexpr int kThreads = 256;
constexpr int kPoints = kThreads / 32;  // one point per warp
constexpr int kColsPerLane = 4;

int leading_dim(int h, int o) { return std::max({kD, h, o}) + 1; }

size_t smem_bytes(int h, int o) {
  return (static_cast<size_t>(std::max({kD * h, h * h, h * o})) +
          2 * static_cast<size_t>(kStreams) * kPoints * leading_dim(h, o)) *
         sizeof(float);
}

// The activation of streams 0-3 by the Taylor rules, driven by stream 0's
// pre-activation z[0] (ops/taylor.py; the TPU kernel's _act_streams), and of
// streams 4-6 by the plain activation.
__device__ __forceinline__ void act_streams(int act, float z[kStreams]) {
  const float z0 = z[0], z1 = z[1], z2 = z[2], z3 = z[3];
  float a0, d, dd;
  if (act == dednn::kTanh) {
    a0 = tanhf(z0);
    d = 1.0f - a0 * a0;
    dd = -2.0f * a0 * d;
  } else if (act == dednn::kSigmoid) {
    a0 = 1.0f / (1.0f + expf(-z0));
    d = a0 * (1.0f - a0);
    dd = d * (1.0f - 2.0f * a0);
  } else {  // relu: no second-order term
    a0 = fmaxf(z0, 0.0f);
    d = z0 > 0.0f ? 1.0f : 0.0f;
    dd = 0.0f;
  }
  z[0] = a0;
  z[1] = d * z1;
  z[2] = d * z2 + dd * (z1 * z1);
  z[3] = d * z3;
#pragma unroll
  for (int s = 4; s < kStreams; ++s) z[s] = dednn::activate(act, z[s]);
}

// out_s = act(in_s @ w (+ b on the value streams)) for the block's 7 kPoints
// rows, laid out [stream][point][ld]. Warp w owns point w; lane l the
// columns l, l + 32, ... of each group of 32 kColsPerLane (conflict-free
// reads of w_s; in_s reads are broadcasts). act < 0: no activation.
__device__ void stream_layer(const float* in_s, int ld, int k_in,
                             const float* __restrict__ w,
                             const float* __restrict__ b, int k_out,
                             float* out_s, float* w_s, int act) {
  __syncthreads();  // the previous layer is done with w_s and in_s is written
  dednn::stage(w_s, k_out, w, k_out, k_in, k_out);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / 32;
  for (int j0 = 0; j0 < k_out; j0 += 32 * kColsPerLane) {
    int col[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      col[c] = min(j0 + lane + 32 * c, k_out - 1);
    float acc[kStreams][kColsPerLane] = {};
    for (int k = 0; k < k_in; ++k) {
      float wk[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) wk[c] = w_s[k * k_out + col[c]];
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        const float x = in_s[(s * kPoints + r) * ld + k];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          acc[s][c] = fmaf(x, wk[c], acc[s][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      const int j = j0 + lane + 32 * c;
      if (j >= k_out) continue;
      const float bj = b[j];
      float z[kStreams];
#pragma unroll
      for (int s = 0; s < kStreams; ++s)
        z[s] = (s == 0 || s >= 4) ? acc[s][c] + bj : acc[s][c];
      if (act >= 0) act_streams(act, z);
#pragma unroll
      for (int s = 0; s < kStreams; ++s) out_s[(s * kPoints + r) * ld + j] = z[s];
    }
  }
}

__global__ void heat_streams_kernel(
    const float* __restrict__ xt, const float* __restrict__ x0,
    const float* __restrict__ xb1, const float* __restrict__ xb2,
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ w_hid, const float* __restrict__ b_hid,
    const float* __restrict__ w_out, const float* __restrict__ b_out,
    float* __restrict__ out, int n, int h, int l, int o, int act) {
  extern __shared__ float smem[];
  const int ld = max(kD, max(h, o)) + 1;
  float* w_s = smem;
  float* buf0 = w_s + max(kD * h, max(h * h, h * o));
  float* buf1 = buf0 + kStreams * kPoints * ld;
  const int row0 = blockIdx.x * kPoints;

  // The 7 input rows of each point; a point past n (the ragged last tile)
  // gets zeros and writes nothing.
  for (int i = threadIdx.x; i < kStreams * kPoints * kD; i += blockDim.x) {
    const int c = i % kD, r = (i / kD) % kPoints, s = i / (kD * kPoints);
    const int row = row0 + r;
    float v = 0.0f;
    if (row < n) {
      const size_t at = static_cast<size_t>(row) * kD + c;
      switch (s) {
        case 0: v = xt[at]; break;
        case 1: v = c == 0 ? 1.0f : 0.0f; break;  // e_x
        case 2: v = 0.0f; break;
        case 3: v = c == 1 ? 1.0f : 0.0f; break;  // e_t
        case 4: v = x0[at]; break;
        case 5: v = xb1[at]; break;
        default: v = xb2[at]; break;
      }
    }
    buf0[(s * kPoints + r) * ld + c] = v;
  }
  stream_layer(buf0, ld, kD, w_in, b_in, h, buf1, w_s, act);
  float* in = buf1;
  float* nxt = buf0;
  for (int layer = 0; layer < l; ++layer) {
    stream_layer(in, ld, h, w_hid + static_cast<size_t>(layer) * h * h,
                 b_hid + static_cast<size_t>(layer) * h, h, nxt, w_s, act);
    float* tmp = in;
    in = nxt;
    nxt = tmp;
  }
  stream_layer(in, ld, h, w_out, b_out, o, nxt, w_s, -1);
  __syncthreads();
  for (int i = threadIdx.x; i < kStreams * kPoints * o; i += blockDim.x) {
    const int j = i % o, r = (i / o) % kPoints, s = i / (o * kPoints);
    const int row = row0 + r;
    if (row < n)
      out[(static_cast<size_t>(s) * n + row) * o + j] =
          nxt[(s * kPoints + r) * ld + j];
  }
}

}  // namespace

// Bytes of dynamic shared memory one block takes at hidden width h and
// output width o; the wrapper holds it to the H100's 227 KB before
// launching.
extern "C" long long heat_streams_smem_bytes(int h, int o) {
  return static_cast<long long>(smem_bytes(h, o));
}

// out [7, n, o]: the streams (u, u_x, u_xx, u_t, u0, ub1, ub2) at the n
// points of xt, x0, xb1, xb2 (each [n, 2]), for the MLP 2 -> h x l -> o with
// activation act (dednn::Activation). w_hid and b_hid are unread at l = 0.
extern "C" int heat_streams(const float* xt, const float* x0,
                            const float* xb1, const float* xb2,
                            const float* w_in, const float* b_in,
                            const float* w_hid, const float* b_hid,
                            const float* w_out, const float* b_out,
                            float* out, int n, int h, int l, int o, int act,
                            void* stream) {
  if (n == 0) return cudaSuccess;
  const size_t smem = smem_bytes(h, o);
  cudaError_t err = dednn::allow_smem(heat_streams_kernel, smem);
  if (err != cudaSuccess) return err;
  heat_streams_kernel<<<dednn::ceil_div(n, kPoints), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      xt, x0, xb1, xb2, w_in, b_in, w_hid, b_hid, w_out, b_out, out, n, h, l,
      o, act);
  return cudaGetLastError();
}
