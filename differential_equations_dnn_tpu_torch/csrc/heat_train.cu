// K Adam steps of the heat-equation PINN (tanh MLP 2 -> H x L -> 1).
//
// Replaces: differential_equations_dnn_tpu/kernels/fused_train.py::
// _train_kernel (reached through heat_fused_train_chunk). That kernel keeps
// the parameters and both Adam moments resident in VMEM for all K steps.
// They do not fit a Hopper SM: at H = 128, L = 3 they are 3 x 50 049 fp32
// (about 600 KB) against 227 KB of shared memory per block. They do fit the
// 50 MB L2 many times over, with the step's activations (about 2.8 MB).
//
// What bounds it on the H100: one step at batch 64 is about 0.1 GFLOP of
// fp32 spread over a dozen dependent phases (forward layers, loss, backward
// layers, Adam), each with a few thousand outputs. The card is far from its
// fp32 or HBM limits; launch latency and the serial dependence between the
// phases are the limit.
//
// What the design does about it (the simple, right design of this slice):
// p, m and v are each ONE flat fp32 buffer, with the six tensors at fixed
// offsets. Each step is a fixed sequence of launches, enqueued by a host
// loop in C with no synchronisation and no copy back to the host:
//   fwd_layer  x (L+1)  7-stream stacked Taylor forward; z and act(z) saved
//   loss       x 1      output layer, residuals, loss[k], output gradient G
//   bwd_weight x (L+2)  dW = act(z)^T dz and db, block-tiled; one partial
//                       sum per stream (7x the blocks of one whole-batch
//                       reduction, 64 rows each at B = 64)
//   bwd_data   x (L+1)  g = dz W^T, then the Taylor VJP (act_bwd)
//   adam       x 1      sums the 7 partials, then Adam over the whole flat
//                       buffer, bias correction exp(t log b)
// Every reduction runs in a fixed order with no atomics, so every run is
// bit-identical to the last and a run cut into chunks (step0) equals the
// uncut run bit for bit. Every product is fp32 FFMA: exact fp32
// ("highest"), no tensor cores.
//
// At these sizes latency, not bandwidth or arithmetic, sets each kernel's
// time, so each one keeps the chain of loads per thread short: fwd_layer
// and bwd_data give every batch row a block of 8 warps that split the
// contraction (partial sums added in warp order), bwd_weight splits its
// reduction by stream, and weights are staged with unrolled float4 loads
// that are all in flight at once.
//
// Row layout of every [7B, width] activation: stream s, batch row b at row
// s*B + b, streams (value, x-tangent, xx-tangent, t-tangent, IC, BC x=0,
// BC x=x_max), as fused_train._stack_inputs orders them.
#include "common.cuh"

namespace {

constexpr int kStreams = 7;
constexpr int kTile = 32;          // bwd_weight: 32 x 32 outputs per block
// fwd_layer and bwd_data: one block per batch row; kSplitWarps warps split
// the contraction, and each lane keeps a register tile of kStreams x
// kColsPerLane outputs at columns lane, lane + 32, ... (coalesced global
// and conflict-free shared-memory reads).
constexpr int kSplitWarps = 8;
constexpr int kColsPerLane = 4;
constexpr int kColsPerWarp = 32 * kColsPerLane;
constexpr int kLossThreads = 1024;
constexpr int kAdamThreads = 256;

constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
// As the JAX package rounds them: 1 - b in double, then to fp32.
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835344);

__device__ __forceinline__ bool value_row(int row, int B) {
  return row < B || row >= 4 * B;  // value, IC and BC streams get the bias
}

// z = in @ w + mask * b for the 7 streams of batch row blockIdx.x, then the
// Taylor rules of tanh, for the kColsPerWarp columns j0.. of blockIdx.y.
// Block (32, kSplitWarps): warp y sums its own slice of the k range (a short
// chain of loads straight from L2) into a kStreams x kColsPerLane register
// tile; the slices' partial sums are then added in warp order through
// shared memory. For the first layer (u != nullptr) the 7 input rows are
// built from the row's uniforms and also written to x_out.
__global__ void fwd_layer_kernel(const float* __restrict__ in, int k_in,
                                 const float* __restrict__ u, float x_max,
                                 float t_max, float* __restrict__ x_out,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b, int k_out, int B,
                                 float* __restrict__ z_out,
                                 float* __restrict__ a_out) {
  extern __shared__ float smem[];
  float* in_s = smem;                          // [kStreams][k_in]
  float* part_s = smem + kStreams * k_in;      // [kSplitWarps][kStreams][kColsPerWarp]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * kColsPerWarp;
  if (u != nullptr) {  // k_in == 2
    if (tid == 0) {
      const float x = x_max * u[2 * row], t = t_max * u[2 * row + 1];
      const float rows[2 * kStreams] = {x,    t,    1.0f, 0.0f, 0.0f,
                                        0.0f, 0.0f, 1.0f, x,    0.0f,
                                        0.0f, t,    x_max, t};
      for (int i = 0; i < 2 * kStreams; ++i) in_s[i] = rows[i];
      if (blockIdx.y == 0) {
        for (int s = 0; s < kStreams; ++s) {
          x_out[2 * (s * B + row)] = rows[2 * s];
          x_out[2 * (s * B + row) + 1] = rows[2 * s + 1];
        }
      }
    }
  } else {
    for (int i = tid; i < kStreams * k_in; i += 32 * kSplitWarps) {
      const int s = i / k_in, k = i - s * k_in;
      in_s[i] = in[static_cast<size_t>(s * B + row) * k_in + k];
    }
  }
  __syncthreads();

  const int k_per_warp = (k_in + kSplitWarps - 1) / kSplitWarps;
  const int k_begin = warp * k_per_warp;
  const int k_end = min(k_in, k_begin + k_per_warp);
  int col[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c)
    col[c] = min(j0 + lane + 32 * c, k_out - 1);
  float z[kStreams][kColsPerLane] = {};
#pragma unroll 4
  for (int k = k_begin; k < k_end; ++k) {
    float wk[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      wk[c] = w[static_cast<size_t>(k) * k_out + col[c]];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const float x = in_s[s * k_in + k];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) z[s][c] = fmaf(x, wk[c], z[s][c]);
    }
  }
#pragma unroll
  for (int s = 0; s < kStreams; ++s)
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      part_s[(warp * kStreams + s) * kColsPerWarp + lane + 32 * c] = z[s][c];
  __syncthreads();

  for (int jj = tid; jj < kColsPerWarp; jj += 32 * kSplitWarps) {
    const int j = j0 + jj;
    if (j >= k_out) break;
    float zc[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      float sum = part_s[s * kColsPerWarp + jj];
      for (int p = 1; p < kSplitWarps; ++p)
        sum += part_s[(p * kStreams + s) * kColsPerWarp + jj];
      zc[s] = sum;
    }
    const float bj = b[j];
    zc[0] += bj;
    zc[4] += bj;
    zc[5] += bj;
    zc[6] += bj;
    const float a0 = tanhf(zc[0]);
    const float d = 1.0f - a0 * a0;
    float a[kStreams];
    a[0] = a0;
    a[1] = d * zc[1];
    a[2] = d * zc[2] - 2.0f * a0 * d * (zc[1] * zc[1]);
    a[3] = d * zc[3];
#pragma unroll
    for (int s = 4; s < kStreams; ++s) a[s] = tanhf(zc[s]);
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const size_t at = static_cast<size_t>(s * B + row) * k_out + j;
      z_out[at] = zc[s];
      a_out[at] = a[s];
    }
  }
}

// The output layer (O = 1), the residuals, loss = mean point loss, and the
// output gradient G [7B]. One block; warp w takes batch rows w, w + 32, ...
// and reduces each dot product with a butterfly shuffle (fixed order).
__global__ void loss_kernel(const float* __restrict__ a, int h,
                            const float* __restrict__ w_out,
                            const float* __restrict__ b_out,
                            const float* __restrict__ u, int B, float x_max,
                            float kappa, float* __restrict__ loss,
                            float* __restrict__ G) {
  __shared__ float partial[kLossThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const float s2 = 2.0f / B;
  const float bo = b_out[0];
  float sum = 0.0f;
  for (int row = warp; row < B; row += n_warps) {
    float out[kStreams];
#pragma unroll
    for (int s = 0; s < kStreams; ++s) {
      const float* ar = a + static_cast<size_t>(s * B + row) * h;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = lane; k < h; k += 32) acc = fmaf(ar[k], w_out[k], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      out[s] = acc;
    }
    out[0] += bo;
    out[4] += bo;
    out[5] += bo;
    out[6] += bo;
    const float r = out[3] - kappa * out[2];          // u_t - kappa u_xx
    const float r0 = out[4] - sinf(x_max * u[2 * row]);  // IC residual
    if (lane == 0) {
      sum += r * r + r0 * r0 + out[5] * out[5] + out[6] * out[6];
      G[row] = 0.0f;
      G[B + row] = 0.0f;
      G[2 * B + row] = (-kappa * s2) * r;
      G[3 * B + row] = s2 * r;
      G[4 * B + row] = s2 * r0;
      G[5 * B + row] = s2 * out[5];
      G[6 * B + row] = s2 * out[6];
    }
  }
  if (lane == 0) partial[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < n_warps; ++i) total += partial[i];
    *loss = total / B;
  }
}

// The partial sums of stream s = blockIdx.z, written at dw + s * n, db + s * n
// (n = one flat parameter buffer): dw[k, j] = sum of a[r, k] dz[r, j] and
// db[j] = sum of dz[r, j] over the stream's B rows in order (db is 0 for
// the tangent streams, which carry no bias). Block (32, 8) owns a 32 x 32
// tile of dw; blocks with blockIdx.y == 0 also produce db for their columns.
__global__ void bwd_weight_kernel(const float* __restrict__ a, int k_in,
                                  const float* __restrict__ dz, int k_out,
                                  int B, int n, float* __restrict__ dw,
                                  float* __restrict__ db) {
  __shared__ float a_s[kTile][kTile + 1];
  __shared__ float d_s[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kTile + tx;
  const int k0 = blockIdx.y * kTile;
  const int stream = blockIdx.z;
  const int R = (stream + 1) * B;
  const bool bias = blockIdx.y == 0 && ty == 0;
  const bool value = value_row(stream * B, B);
  dw += static_cast<size_t>(stream) * n;
  db += static_cast<size_t>(stream) * n;
  float acc[kTile / 8] = {};
  float bacc = 0.0f;
  for (int r0 = stream * B; r0 < R; r0 += kTile) {
    for (int rr = ty; rr < kTile; rr += 8) {
      const int r = r0 + rr;
      a_s[rr][tx] = (r < R && k0 + tx < k_in)
                        ? a[static_cast<size_t>(r) * k_in + k0 + tx]
                        : 0.0f;
      d_s[rr][tx] =
          (r < R && j < k_out) ? dz[static_cast<size_t>(r) * k_out + j] : 0.0f;
    }
    __syncthreads();
    const int rows = min(kTile, R - r0);
    for (int rr = 0; rr < rows; ++rr) {
      const float d = d_s[rr][tx];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        acc[i] = fmaf(a_s[rr][ty + 8 * i], d, acc[i]);
      if (bias) bacc += d;
    }
    __syncthreads();
  }
  if (j >= k_out) return;
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int k = k0 + ty + 8 * i;
    if (k < k_in) dw[static_cast<size_t>(k) * k_out + j] = acc[i];
  }
  if (bias) db[j] = value ? bacc : 0.0f;
}

// g = dz @ w^T for the 7 streams of batch row blockIdx.x, then the VJP of
// the tanh Taylor rules (fused_train._act_bwd) at the previous layer: with
// a0 = tanh(z0), d = 1 - a0^2, d' = -2 a0 d,
//   dz0 = d g0 + d'(z1 g1 + z2 g2 + z3 g3) - 2 z1^2 d (d - 2 a0^2) g2
//   dz1 = d g1 - 4 a0 d z1 g2,  dz2 = d g2,  dz3 = d g3
//   dzc = (1 - tanh^2 zc) gc for the three constraint streams.
// Block (32, kSplitWarps): w is staged in shared memory with rows padded by
// one float (lane l reading row k = l + 32 c hits bank (l + j) mod 32);
// warp y sums its own slice of the j range, and the slices' partial sums
// are added in warp order through shared memory.
__global__ void bwd_data_kernel(const float* __restrict__ dz, int k_out,
                                const float* __restrict__ w, int k_in,
                                const float* __restrict__ z_prev,
                                const float* __restrict__ a_prev, int B,
                                float* __restrict__ dz_prev) {
  extern __shared__ float smem[];
  const int ldw = k_out + 1;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row = blockIdx.x;
  float* w_s = smem;                        // [k_in][k_out + 1]
  float* d_s = w_s + k_in * ldw;            // [kStreams][k_out]
  float* part_s = d_s + kStreams * k_out;   // [kSplitWarps][kStreams][kColsPerWarp]
  dednn::stage(w_s, ldw, w, k_out, k_in, k_out);
  for (int i = tid; i < kStreams * k_out; i += 32 * kSplitWarps) {
    const int s = i / k_out, j = i - s * k_out;
    d_s[i] = dz[static_cast<size_t>(s * B + row) * k_out + j];
  }
  __syncthreads();

  const int j_per_warp = (k_out + kSplitWarps - 1) / kSplitWarps;
  const int j_begin = warp * j_per_warp;
  const int j_end = min(k_out, j_begin + j_per_warp);
  const size_t stride = static_cast<size_t>(B) * k_in;  // one stream
  for (int k0 = 0; k0 < k_in; k0 += kColsPerWarp) {
    int kk[kColsPerLane];
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      kk[c] = min(k0 + lane + 32 * c, k_in - 1);
    float g[kStreams][kColsPerLane] = {};
    for (int j = j_begin; j < j_end; ++j) {
      float wk[kColsPerLane];
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c) wk[c] = w_s[kk[c] * ldw + j];
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        const float d = d_s[s * k_out + j];
#pragma unroll
        for (int c = 0; c < kColsPerLane; ++c)
          g[s][c] = fmaf(d, wk[c], g[s][c]);
      }
    }
#pragma unroll
    for (int s = 0; s < kStreams; ++s)
#pragma unroll
      for (int c = 0; c < kColsPerLane; ++c)
        part_s[(warp * kStreams + s) * kColsPerWarp + lane + 32 * c] = g[s][c];
    __syncthreads();

    for (int kl = tid; kl < kColsPerWarp; kl += 32 * kSplitWarps) {
      const int k = k0 + kl;
      if (k >= k_in) break;
      float gs[kStreams];
#pragma unroll
      for (int s = 0; s < kStreams; ++s) {
        float sum = part_s[s * kColsPerWarp + kl];
        for (int p = 1; p < kSplitWarps; ++p)
          sum += part_s[(p * kStreams + s) * kColsPerWarp + kl];
        gs[s] = sum;
      }
      const size_t at = static_cast<size_t>(row) * k_in + k;
      const float z1 = z_prev[at + stride], z2 = z_prev[at + 2 * stride];
      const float z3 = z_prev[at + 3 * stride];
      const float a0 = a_prev[at];
      const float d = 1.0f - a0 * a0;
      const float dp = -2.0f * a0 * d;
      dz_prev[at] = d * gs[0] + dp * (z1 * gs[1] + z2 * gs[2] + z3 * gs[3]) -
                    2.0f * (z1 * z1) * d * (d - 2.0f * a0 * a0) * gs[2];
      dz_prev[at + stride] = d * gs[1] - 4.0f * a0 * d * z1 * gs[2];
      dz_prev[at + 2 * stride] = d * gs[2];
      dz_prev[at + 3 * stride] = d * gs[3];
#pragma unroll
      for (int s = 4; s < kStreams; ++s) {
        const float ac = a_prev[at + s * stride];
        dz_prev[at + s * stride] = (1.0f - ac * ac) * gs[s];
      }
    }
    __syncthreads();  // part_s is rewritten for the next k0
  }
}

__device__ __forceinline__ float sum_partials(const float* g, int n, int i) {
  float sum = g[i];
#pragma unroll
  for (int s = 1; s < kStreams; ++s) sum += g[static_cast<size_t>(s) * n + i];
  return sum;
}

// grad = the sum of the 7 per-stream partials, in stream order.
__global__ void sum_partials_kernel(const float* __restrict__ partials, int n,
                                    float* __restrict__ grad) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) grad[i] = sum_partials(partials, n, i);
}

// Adam with torch defaults on the summed partial gradients; t is the
// 1-indexed global step.
__global__ void adam_kernel(float* __restrict__ p, float* __restrict__ m,
                            float* __restrict__ v,
                            const float* __restrict__ partials, int n,
                            float lr, float t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float c1 = 1.0f - expf(t * kLogB1);
  const float c2 = 1.0f - expf(t * kLogB2);
  const float gi = sum_partials(partials, n, i);
  const float mi = kB1 * m[i] + kOneMinusB1 * gi;
  const float vi = kB2 * v[i] + kOneMinusB2 * (gi * gi);
  m[i] = mi;
  v[i] = vi;
  p[i] = p[i] - lr * (mi / c1) / (sqrtf(vi / c2) + kEps);
}

size_t fwd_smem(int k_in) {
  return static_cast<size_t>(kStreams) * (k_in + kSplitWarps * kColsPerWarp) *
         sizeof(float);
}

size_t bwd_data_smem(int k_in, int k_out) {
  return (static_cast<size_t>(k_in) * (k_out + 1) +
          kStreams * (k_out + kSplitWarps * kColsPerWarp)) *
         sizeof(float);
}

int n_params(int H, int L) { return 3 * H + L * H * H + L * H + H + 1; }

// The per-stream gradient partials [kStreams][n] at the end of scratch.
float* partials_of(float* scratch, int B, int H, int L) {
  const int R = kStreams * B;
  return scratch + 2 * R + 3 * static_cast<size_t>(L + 1) * R * H + R;
}

// Enqueue one step's forward and backward: loss -> *loss, the gradient's
// per-stream partials -> partials_of(scratch) (each in the flat layout of
// p). scratch holds heat_scratch_floats(B, H, L).
cudaError_t grad_step(const float* p, const float* u, float* scratch,
                      float* loss, int B, int H, int L, float x_max,
                      float t_max, float kappa, cudaStream_t stream) {
  const int R = kStreams * B;
  const size_t layer = static_cast<size_t>(R) * H;
  const int n = n_params(H, L);
  float* X = scratch;                // [R, 2]
  float* Z = X + 2 * R;              // [L + 1][R, H] pre-activations
  float* A = Z + (L + 1) * layer;    // [L + 1][R, H] activations
  float* G = A + (L + 1) * layer;    // [R] output gradient
  float* DZ = G + R;                 // [L + 1][R, H] gradients w.r.t. Z
  float* grad = partials_of(scratch, B, H, L);

  const float* w_in = p;
  const float* b_in = w_in + 2 * H;
  const float* w_hid = b_in + H;
  const float* b_hid = w_hid + static_cast<size_t>(L) * H * H;
  const float* w_out = b_hid + static_cast<size_t>(L) * H;
  const float* b_out = w_out + H;
  float* gw_in = grad;
  float* gb_in = gw_in + 2 * H;
  float* gw_hid = gb_in + H;
  float* gb_hid = gw_hid + static_cast<size_t>(L) * H * H;
  float* gw_out = gb_hid + static_cast<size_t>(L) * H;
  float* gb_out = gw_out + H;

  const dim3 split(32, kSplitWarps);
  const dim3 fwd_grid(B, dednn::ceil_div(H, kColsPerWarp));
  fwd_layer_kernel<<<fwd_grid, split, fwd_smem(2), stream>>>(
      nullptr, 2, u, x_max, t_max, X, w_in, b_in, H, B, Z, A);
  for (int l = 1; l <= L; ++l) {
    fwd_layer_kernel<<<fwd_grid, split, fwd_smem(H), stream>>>(
        A + (l - 1) * layer, H, nullptr, x_max, t_max, nullptr,
        w_hid + (l - 1) * H * H, b_hid + (l - 1) * H, H, B, Z + l * layer,
        A + l * layer);
  }
  loss_kernel<<<1, kLossThreads, 0, stream>>>(A + L * layer, H, w_out, b_out,
                                              u, B, x_max, kappa, loss, G);

  const dim3 tile(32, 8);
  bwd_weight_kernel<<<dim3(1, dednn::ceil_div(H, kTile), kStreams), tile, 0,
                      stream>>>(A + L * layer, H, G, 1, B, n, gw_out, gb_out);
  bwd_data_kernel<<<B, split, bwd_data_smem(H, 1), stream>>>(
      G, 1, w_out, H, Z + L * layer, A + L * layer, B, DZ + L * layer);
  for (int l = L; l >= 1; --l) {
    const dim3 grid(dednn::ceil_div(H, kTile), dednn::ceil_div(H, kTile),
                    kStreams);
    bwd_weight_kernel<<<grid, tile, 0, stream>>>(
        A + (l - 1) * layer, H, DZ + l * layer, H, B, n,
        gw_hid + (l - 1) * H * H, gb_hid + (l - 1) * H);
    bwd_data_kernel<<<B, split, bwd_data_smem(H, H), stream>>>(
        DZ + l * layer, H, w_hid + (l - 1) * H * H, H, Z + (l - 1) * layer,
        A + (l - 1) * layer, B, DZ + (l - 1) * layer);
  }
  bwd_weight_kernel<<<dim3(dednn::ceil_div(H, kTile), 1, kStreams), tile, 0,
                      stream>>>(X, 2, DZ, H, B, n, gw_in, gb_in);
  return cudaGetLastError();
}

cudaError_t prepare(int H) {
  cudaError_t err = dednn::allow_smem(bwd_data_kernel, bwd_data_smem(H, H));
  if (err != cudaSuccess) return err;
  return dednn::allow_smem(fwd_layer_kernel, fwd_smem(H));
}

}  // namespace

extern "C" int heat_scratch_floats(int B, int H, int L) {
  const int R = kStreams * B;
  return 2 * R + 3 * (L + 1) * R * H + R + kStreams * n_params(H, L);
}

extern "C" int heat_grad(const float* p, const float* u, float* scratch,
                         float* grad, float* loss, int B, int H, int L,
                         float x_max, float t_max, float kappa, void* stream) {
  cudaError_t err = prepare(H);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = grad_step(p, u, scratch, loss, B, H, L, x_max, t_max, kappa, s);
  if (err != cudaSuccess) return err;
  const int n = n_params(H, L);
  sum_partials_kernel<<<dednn::ceil_div(n, kAdamThreads), kAdamThreads, 0,
                        s>>>(partials_of(scratch, B, H, L), n, grad);
  return cudaGetLastError();
}

extern "C" int heat_train(float* p, float* m, float* v, const float* u,
                          float* scratch, float* losses, int K, int B, int H,
                          int L, float x_max, float t_max, float kappa,
                          float lr, int step0, void* stream) {
  cudaError_t err = prepare(H);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = n_params(H, L);
  const float* partials = partials_of(scratch, B, H, L);
  for (int k = 0; k < K; ++k) {
    err = grad_step(p, u + static_cast<size_t>(k) * B * 2, scratch,
                    losses + k, B, H, L, x_max, t_max, kappa, s);
    if (err != cudaSuccess) return err;
    adam_kernel<<<dednn::ceil_div(n, kAdamThreads), kAdamThreads, 0, s>>>(
        p, m, v, partials, n, lr, static_cast<float>(step0 + k + 1));
  }
  return cudaGetLastError();
}
