// K Adam steps of a DGM (gate-network) PINN, and one step's loss and
// gradient.
//
// Replaces: differential_equations_dnn_tpu/kernels/fused_dgm.py::
// dgm_step_math (kernel #7, with its stream ops _act_fwd, _act_bwd,
// _mul_fwd, _mul_bwd) inside kernels/engine_core.py::fused_adam_kernel
// (kernel #4, reached through fused_dgm_chunk). Each step pushes stacked
// value / first-order-tangent stream rows through the gate recurrence
//   Z,G,R = act(s·Wzgr + x·Uzgr + bzgr)
//   H     = act((s⊙R)·Wh + x·Uh + bh)
//   s'    = (1 − G)⊙H + Z⊙s
// under the stream rules (act: v → σ(v), t → σ'(v)·t; product: v → a_v·b_v,
// t → a_v·b_t + a_t·b_v; biases and the "1" of 1 − G on value rows only),
// takes the spec's loss and its cotangent by hand, runs the hand backward
// through the recurrence, and applies Adam (adam.cuh).
//
// What bounds it on the H100: one FitzHugh–Nagumo step (R·B = 300 rows,
// H = 128, L = 4) is about 0.5 GFLOP of fp32 products, 7 µs at the
// 67 TFLOP/s fp32 peak, but it is a chain of ~47 dependent phases of a few
// tens of thousands of outputs each (Fredholm: 17 phases at H = 32). The
// latency of each phase and of the launches between them is the limit.
//
// What the design does about it: the simple version first. Every phase is
// one launch from a host loop in C, with p, m, v as flat L2-resident
// buffers:
//   input      x 1      the spec's rows X from the uniforms (and the const),
//                       s0 = act(X·w_in + b_in)
//   gemm       x 4L     32×32-tiled fp32 products: the gate and H
//                       pre-activations forward; dh_pre·Whᵀ and
//                       dzgr_pre·Wzgrᵀ backward
//   gate/state x 2L     the stream rules of R, s⊙R, H and s' (forward)
//   loss       x 1      output layer, the spec's loss and cotangent G
//   gate_bwd   x 2L     the stream VJPs of s' and of s⊙R and the gates
//   weight     x 2L+2   dW = Aᵀ·dZ and db, one partial per stream
//   adam       x 1      sums the R partials in stream order, lr(t), Adam
// The stream layout (R rows per batch point, a bit per value row) is a
// run-time argument, so Fredholm's R = 1 + ⌈k/B⌉ needs no rebuild; R is at
// most kMaxStreams. Every reduction runs in a fixed order with no atomics,
// so runs are bit-identical and a chunked run equals the uncut run. Every
// product is fp32 FFMA: exact fp32 ("highest"), no tensor cores, no library.
//
// Packed replicas (kernel #5, engine_core.py::fused_packed_adam_kernel,
// reached through fused_dgm_packed_chunk): dgm_train_packed advances N
// independent runs that share the uniforms, the stream layout, the spec's
// consts, Fredholm's const and the lr schedule. p, m, v are [N, n]
// replica-major, each replica has its own scratch (stride scratch_floats),
// and the loss history is [N, K]. A step is the same launch sequence as one
// run's, each launch with N times the blocks: the replica is the grid's y
// index (elementwise kernels), z (gemm), part of z (weight_grad: z = r·R +
// stream) or x (the loss kernels, one block per replica). Every kernel
// moves its pointers to its replica's copy and then runs the
// single-replica code, so replica r of a packed call equals a one-replica
// call on r's state bit for bit. A single run (fused_dgm_chunk) is the
// packed call at N = 1.
//
// Row layout of every [R·B, width] activation: stream s, batch row b at row
// s·B + b (fused_dgm.<Spec>.groups order: per group the value row, then its
// first-order tangents). The input width D is 1 for both specs.
#include <cmath>

#include "adam.cuh"
#include "common.cuh"

namespace {

using dednn::adam_kernel;
using dednn::Schedule;
using dednn::sum_partials_kernel;

constexpr int kMaxStreams = 32;  // bits of Layout::value_mask
constexpr int kMaxConsts = 8;
constexpr int kTile = 32;        // gemm and weight_grad: 32 × 32 outputs
constexpr int kEwThreads = 128;  // elementwise kernels
constexpr int kLossThreads = 1024;
constexpr int kAdamThreads = 256;

enum SpecId : int { kFitzHughNagumo = 0, kFredholm = 1 };

// The spec's numbers (fused_dgm.<Spec>.kernel_consts), passed by value.
struct Consts {
  float c[kMaxConsts];
};

// R stream rows per batch point; bit s of value_mask is set for a value
// row, and the tangent rows of a group follow its value row.
struct Layout {
  int R, B;
  unsigned value_mask;
  __device__ bool is_value(int s) const { return (value_mask >> s) & 1u; }
};

__device__ __forceinline__ size_t at(int s, int b, int B, int width,
                                     int col) {
  return static_cast<size_t>(s * B + b) * width + col;
}

__device__ __forceinline__ float act_value(int act, float z) {
  return act == dednn::kTanh ? tanhf(z) : fmaxf(z, 0.0f);
}

// σ'(z) given a = σ(z).
__device__ __forceinline__ float act_slope(int act, float z, float a) {
  return act == dednn::kTanh ? 1.0f - a * a : (z > 0.0f ? 1.0f : 0.0f);
}

// σ''(z) given a and d = σ'(z): −2σd for tanh, 0 for relu.
__device__ __forceinline__ float act_curve(int act, float a, float d) {
  return act == dednn::kTanh ? -2.0f * a * d : 0.0f;
}

// ---------------------------------------------------------------------------
// Specs: the input rows
// ---------------------------------------------------------------------------

// FitzHugh–Nagumo, rows [t, d/dt tangent (x = 1), t = 0]. c: t_max,
// t_max / B, causal_eps, i_ext, alpha, beta, tau, y_ic. Causal collocation
// is stratified: t_b = (b + u_b)·t_max/B, time-sorted by construction.
__device__ float fn_input(int s, int b, const float* u, const Consts& c) {
  if (s == 0)
    return c.c[2] > 0.0f ? (static_cast<float>(b) + u[b]) * c.c[1]
                         : c.c[0] * u[b];
  return s == 1 ? 1.0f : 0.0f;
}

// Fredholm: row 0 the collocation points x = upper·u, rows 1.. the
// Gauss–Legendre nodes of each node group, from the const
// [2(R−1), B] (nodes, weights per group; zero past k). c: upper.
__device__ float fredholm_input(int s, int b, const float* u,
                                const float* cnst, int B, const Consts& c) {
  if (s == 0) return c.c[0] * u[b];
  return cnst[static_cast<size_t>(2 * (s - 1)) * B + b];
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Thread (b, j): X's rows of batch point b (written once, by j == 0), the
// input layer's pre-activation pre = X·w_in + mask·b_in and s0 = its stream
// activation, at column j. Replica blockIdx.y: weights at y·ps, outputs at
// y·ss (the uniforms and the const are shared).
__global__ void input_kernel(int spec, const float* __restrict__ u,
                             const float* __restrict__ cnst, Consts c,
                             Layout lay, const float* __restrict__ w_in,
                             const float* __restrict__ b_in, int H, int act,
                             float* __restrict__ X, float* __restrict__ pre,
                             float* __restrict__ s0, size_t ss, size_t ps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss, po = blockIdx.y * ps;
  w_in += po;
  b_in += po;
  X += so;
  pre += so;
  s0 += so;
  const int b = idx / H, j = idx - b * H;
  float a = 0.0f, d = 0.0f;
  for (int s = 0; s < lay.R; ++s) {
    const float x = spec == kFitzHughNagumo
                        ? fn_input(s, b, u, c)
                        : fredholm_input(s, b, u, cnst, lay.B, c);
    if (j == 0) X[s * lay.B + b] = x;
    const size_t i = at(s, b, lay.B, H, j);
    if (lay.is_value(s)) {
      const float z = x * w_in[j] + b_in[j];
      a = act_value(act, z);
      d = act_slope(act, z, a);
      pre[i] = z;
      s0[i] = a;
    } else {
      const float z = x * w_in[j];
      pre[i] = z;
      s0[i] = d * z;
    }
  }
}

// One element of the k0 tiles of A and W' (i < 32·32; q runs along
// memory): the A tile's [r][q] into a, the W' tile's into w.
template <bool kTransW>
__device__ __forceinline__ void load_tiles(
    const float* __restrict__ A, const float* __restrict__ W, int N, int K,
    int M, int n0, int m0, int k0, int i, float& a, float& w) {
  const int r = i / kTile, q = i - r * kTile;
  const int n = n0 + r, k = k0 + q;
  a = (n < N && k < K) ? A[static_cast<size_t>(n) * K + k] : 0.0f;
  if (kTransW) {  // w_s[k][m] = W[m, k]
    const int m = m0 + r;
    w = (m < M && k < K) ? W[static_cast<size_t>(m) * K + k] : 0.0f;
  } else {        // w_s[k][m] = W[k, m]
    const int kk = k0 + r, m = m0 + q;
    w = (kk < K && m < M) ? W[static_cast<size_t>(kk) * M + m] : 0.0f;
  }
}

// C[n, m] = Σ_k A[n, k]·W'[k, m] over the N = R·B rows, W' = W ([K, M]) or
// Wᵀ (W [M, K]); then + x[n]·u[m] (the D = 1 input's term) and + bias[m]
// on value rows, or addend[n, m] + the sum. Block (16, 16) owns a 32×32
// tile, each thread 2×2 outputs, summed over k in order; the next k tile
// is loaded into registers while the current one is multiplied. Replica
// blockIdx.z: A, x, addend and C at z·ss; W, u and bias at z·ps.
template <bool kTransW>
__global__ void gemm_kernel(const float* __restrict__ A,
                            const float* __restrict__ W, int N, int K, int M,
                            const float* __restrict__ x,
                            const float* __restrict__ u,
                            const float* __restrict__ bias, Layout lay,
                            const float* __restrict__ addend,
                            float* __restrict__ C, size_t ss, size_t ps) {
  constexpr int kPerThread = kTile * kTile / 256;
  __shared__ float a_s[kTile][kTile + 1];
  __shared__ float w_s[kTile][kTile + 1];
  const size_t so = blockIdx.z * ss, po = blockIdx.z * ps;
  A += so;
  W += po;
  x = dednn::shift(x, so);
  u = dednn::shift(u, po);
  bias = dednn::shift(bias, po);
  addend = dednn::shift(addend, so);
  C += so;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int n0 = blockIdx.y * kTile, m0 = blockIdx.x * kTile;
  float a_next[kPerThread], w_next[kPerThread];
#pragma unroll
  for (int t = 0; t < kPerThread; ++t)
    load_tiles<kTransW>(A, W, N, K, M, n0, m0, 0, tid + 256 * t, a_next[t],
                        w_next[t]);
  float acc[2][2] = {};
  for (int k0 = 0; k0 < K; k0 += kTile) {
#pragma unroll
    for (int t = 0; t < kPerThread; ++t) {
      const int i = tid + 256 * t;
      const int r = i / kTile, q = i - r * kTile;
      a_s[r][q] = a_next[t];
      if (kTransW) w_s[q][r] = w_next[t];
      else w_s[r][q] = w_next[t];
    }
    __syncthreads();
    if (k0 + kTile < K) {
#pragma unroll
      for (int t = 0; t < kPerThread; ++t)
        load_tiles<kTransW>(A, W, N, K, M, n0, m0, k0 + kTile, tid + 256 * t,
                            a_next[t], w_next[t]);
    }
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a0 = a_s[ty][kk], a1 = a_s[ty + 16][kk];
      const float w0 = w_s[kk][tx], w1 = w_s[kk][tx + 16];
      acc[0][0] = fmaf(a0, w0, acc[0][0]);
      acc[0][1] = fmaf(a0, w1, acc[0][1]);
      acc[1][0] = fmaf(a1, w0, acc[1][0]);
      acc[1][1] = fmaf(a1, w1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
    const bool value = lay.is_value(n / lay.B);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int m = m0 + tx + 16 * jj;
      if (m >= M) continue;
      float out = acc[i][jj];
      if (u != nullptr) out = out + x[n] * u[m];
      if (bias != nullptr && value) out = out + bias[m];
      const size_t o = static_cast<size_t>(n) * M + m;
      if (addend != nullptr) out = addend[o] + out;
      C[o] = out;
    }
  }
}

// Thread (b, j): R = act(zgr_pre[:, 2H + j]) under the stream rules and
// sr = s ⊙ R (value: s_v·r_v; tangent: s_v·r_t + s_t·r_v). Replica
// blockIdx.y at y·ss, as in every elementwise kernel below.
__global__ void gate_fwd_kernel(const float* __restrict__ zgr_pre,
                                const float* __restrict__ s, Layout lay,
                                int H, int act, float* __restrict__ sr,
                                size_t ss) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss;
  zgr_pre += so;
  s += so;
  sr += so;
  const int b = idx / H, j = idx - b * H;
  const int B = lay.B;
  float r_v = 0.0f, d = 0.0f, s_v = 0.0f;
  for (int q = 0; q < lay.R; ++q) {
    const float rp = zgr_pre[at(q, b, B, 3 * H, 2 * H + j)];
    const float sq = s[at(q, b, B, H, j)];
    if (lay.is_value(q)) {
      r_v = act_value(act, rp);
      d = act_slope(act, rp, r_v);
      s_v = sq;
      sr[at(q, b, B, H, j)] = s_v * r_v;
    } else {
      sr[at(q, b, B, H, j)] = s_v * (d * rp) + sq * r_v;
    }
  }
}

// Thread (b, j): Z, G (gate columns j, H + j) and H (h_pre column j) under
// the stream rules, then s' = (mask − G)⊙H + Z⊙s.
__global__ void state_fwd_kernel(const float* __restrict__ zgr_pre,
                                 const float* __restrict__ h_pre,
                                 const float* __restrict__ s, Layout lay,
                                 int H, int act, float* __restrict__ s_out,
                                 size_t ss) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss;
  zgr_pre += so;
  h_pre += so;
  s += so;
  s_out += so;
  const int b = idx / H, j = idx - b * H;
  const int B = lay.B;
  float z_v = 0.0f, g_v = 0.0f, h_v = 0.0f, s_v = 0.0f, om_v = 0.0f;
  float dz = 0.0f, dg = 0.0f, dh = 0.0f;
  for (int q = 0; q < lay.R; ++q) {
    const float zp = zgr_pre[at(q, b, B, 3 * H, j)];
    const float gp = zgr_pre[at(q, b, B, 3 * H, H + j)];
    const float hp = h_pre[at(q, b, B, H, j)];
    const float sq = s[at(q, b, B, H, j)];
    const size_t o = at(q, b, B, H, j);
    if (lay.is_value(q)) {
      z_v = act_value(act, zp);
      dz = act_slope(act, zp, z_v);
      g_v = act_value(act, gp);
      dg = act_slope(act, gp, g_v);
      h_v = act_value(act, hp);
      dh = act_slope(act, hp, h_v);
      s_v = sq;
      om_v = 1.0f - g_v;
      s_out[o] = om_v * h_v + z_v * s_v;
    } else {
      const float z_t = dz * zp, om_t = -(dg * gp), h_t = dh * hp;
      s_out[o] = (om_v * h_t + om_t * h_v) + (z_v * sq + z_t * s_v);
    }
  }
}

// ---------------------------------------------------------------------------
// Output layer and the specs' losses (one block per replica: blockIdx.x,
// its scratch at x·ss, its weights at x·ps, its loss at x·ls)
// ---------------------------------------------------------------------------

// out[n, o] = S[n, :]·w_out[:, o] + mask·b_out[o] for the R·B rows: warp w
// takes rows w, w + 32, ...; a butterfly shuffle sums each dot product in a
// fixed order.
__device__ void output_layer(const float* __restrict__ S, int H,
                             const float* __restrict__ w_out,
                             const float* __restrict__ b_out, int O,
                             Layout lay, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int N = lay.R * lay.B;
  for (int n = warp; n < N; n += n_warps) {
    const float* row = S + static_cast<size_t>(n) * H;
    const bool value = lay.is_value(n / lay.B);
    for (int o = 0; o < O; ++o) {
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc = fmaf(row[k], w_out[k * O + o], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) out[n * O + o] = value ? acc + b_out[o] : acc;
    }
  }
  __syncthreads();
}

// FitzHugh–Nagumo (O = 2; fused_dgm.FNDGMSpec.loss). Rows: s = (y, w) at t,
// ds/dt, s(0). Residuals r_y = y' + y³/3 + w − I − y, r_w = w' + (βw − α −
// y)/τ; causal weights w_i = exp(−ε·Δt·Σ_{j<i} ℓ_j), ℓ = r_y² + r_w², held
// constant for the gradient (stop-gradient); loss = 2·mean(w⊙r²) +
// mean((s(0) − y_ic)²) over [B, 2]. aux: 5B floats.
__global__ void fn_loss_kernel(const float* __restrict__ S, int H,
                               const float* __restrict__ w_out,
                               const float* __restrict__ b_out, Layout lay,
                               Consts c, float* out, float* G, float* aux,
                               float* loss, size_t ss, size_t ps, size_t ls) {
  const size_t so = blockIdx.x * ss, po = blockIdx.x * ps;
  S += so;
  out += so;
  G += so;
  aux += so;
  w_out += po;
  b_out += po;
  loss += blockIdx.x * ls;
  output_layer(S, H, w_out, b_out, 2, lay, out);
  const int B = lay.B;
  const float t_max_over_b = c.c[1], eps = c.c[2], i_ext = c.c[3];
  const float alpha = c.c[4], beta = c.c[5], tau = c.c[6], y_ic = c.c[7];
  const float inv_2b = 1.0f / static_cast<float>(2 * B);
  float* r0s = aux;
  float* r1s = aux + B;
  float* wgt = aux + 2 * B;
  float* res = aux + 3 * B;
  float* ic = aux + 4 * B;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const float y = out[2 * i], w = out[2 * i + 1];
    const float dy = out[2 * (B + i)], dw = out[2 * (B + i) + 1];
    r0s[i] = dy + ((y * y * y / 3.0f + w - i_ext) - y);
    r1s[i] = dw + ((beta * w - alpha) - y) / tau;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the exclusive prefix sum, in time order
    float cum = 0.0f;
    for (int i = 0; i < B; ++i) {
      wgt[i] = eps > 0.0f ? expf(-eps * (cum * t_max_over_b)) : 1.0f;
      cum += r0s[i] * r0s[i] + r1s[i] * r1s[i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const float y = out[2 * i];
    const float r0 = r0s[i], r1 = r1s[i], wi = wgt[i];
    const float e0 = out[2 * (2 * B + i)] - y_ic;
    const float e1 = out[2 * (2 * B + i) + 1] - y_ic;
    res[i] = wi * (r0 * r0) + wi * (r1 * r1);
    ic[i] = e0 * e0 + e1 * e1;
    const float q0 = 4.0f * inv_2b * wi * r0, q1 = 4.0f * inv_2b * wi * r1;
    G[2 * i] = q0 * (y * y - 1.0f) - q1 / tau;
    G[2 * i + 1] = q0 + q1 * (beta / tau);
    G[2 * (B + i)] = q0;
    G[2 * (B + i) + 1] = q1;
    G[2 * (2 * B + i)] = 2.0f * inv_2b * e0;
    G[2 * (2 * B + i) + 1] = 2.0f * inv_2b * e1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum_res = 0.0f, sum_ic = 0.0f;
    for (int i = 0; i < B; ++i) {
      sum_res += res[i];
      sum_ic += ic[i];
    }
    *loss = 2.0f * (sum_res * inv_2b) + sum_ic * inv_2b;
  }
}

// Fredholm II (O = 1; fused_dgm.FredholmDGMSpec.loss): integral I =
// Σ_j Σ_b w_jb·cos(t_jb)·y(t_jb), one scalar over all node rows;
// r = y(x) − sin(x)·(1 + I); loss = mean(r²). The node rows' cotangent is
// w_jb·cos(t_jb)·Σ_i (2r_i/B)(−sin x_i). aux: 2B floats.
//
// The two scalars pass between threads through shared memory (through a
// global word that every thread had already read once, the second scalar
// came back stale to other warps on the H100).
__global__ void fredholm_loss_kernel(const float* __restrict__ S, int H,
                                     const float* __restrict__ w_out,
                                     const float* __restrict__ b_out,
                                     Layout lay, const float* __restrict__ u,
                                     const float* __restrict__ cnst, Consts c,
                                     float* out, float* G, float* aux,
                                     float* loss, size_t ss, size_t ps,
                                     size_t ls) {
  __shared__ float scalars[2];  // I, dL/dI
  const size_t so = blockIdx.x * ss, po = blockIdx.x * ps;
  S += so;
  out += so;
  G += so;
  aux += so;
  w_out += po;
  b_out += po;
  loss += blockIdx.x * ls;
  output_layer(S, H, w_out, b_out, 1, lay, out);
  const int B = lay.B, R = lay.R;
  const float upper = c.c[0];
  const float inv_b = 1.0f / static_cast<float>(B);
  float* terms = aux;
  float* ctr = aux + B;
  if (threadIdx.x == 0) {
    float integral = 0.0f;
    for (int g = 1; g < R; ++g) {
      const float* t_g = cnst + static_cast<size_t>(2 * (g - 1)) * B;
      const float* w_g = t_g + B;
      float part = 0.0f;
      for (int b = 0; b < B; ++b) part += w_g[b] * cosf(t_g[b]) * out[g * B + b];
      integral = integral + part;
    }
    scalars[0] = integral;
  }
  __syncthreads();
  const float integral = scalars[0];
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const float sx = sinf(upper * u[i]);
    const float r = out[i] - sx * (1.0f + integral);
    const float g = 2.0f * r * inv_b;
    terms[i] = r * r;
    ctr[i] = g * -sx;
    G[i] = g;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f, d_int = 0.0f;
    for (int i = 0; i < B; ++i) {
      sum += terms[i];
      d_int += ctr[i];
    }
    *loss = sum * inv_b;
    scalars[1] = d_int;
  }
  __syncthreads();
  const float d_int = scalars[1];
  for (int i = threadIdx.x; i < (R - 1) * B; i += blockDim.x) {
    const int g = 1 + i / B, b = i - (g - 1) * B;
    const float* t_g = cnst + static_cast<size_t>(2 * (g - 1)) * B;
    G[g * B + b] = d_int * (t_g[B + b] * cosf(t_g[b]));
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// ds[n, j] = Σ_o G[n, o]·w_out[j, o]; replica blockIdx.y.
__global__ void out_bwd_kernel(const float* __restrict__ G,
                               const float* __restrict__ w_out, int N, int H,
                               int O, float* __restrict__ ds, size_t ss,
                               size_t ps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * H) return;
  G += blockIdx.y * ss;
  ds += blockIdx.y * ss;
  w_out += blockIdx.y * ps;
  const int n = idx / H, j = idx - n * H;
  float acc = 0.0f;
  for (int o = 0; o < O; ++o) acc = fmaf(G[n * O + o], w_out[j * O + o], acc);
  ds[idx] = acc;
}

// The partial of stream s = blockIdx.z over its B rows, in order:
// dW[k, m] = Σ A[r, k]·dz[r, m] (k < KA; written at dwA + s·n), the D = 1
// input row k = KA when x != nullptr (dwx + s·n), and db[m] = Σ dz[r, m] on
// value streams, 0 on tangent streams (db + s·n). Block (32, 8) owns a
// 32 × 32 tile of (k, m). blockIdx.z = r·R + s: replica r's operands and
// partials at r·ss.
__global__ void weight_grad_kernel(const float* __restrict__ A, int KA,
                                   const float* __restrict__ x,
                                   const float* __restrict__ dz, int M,
                                   Layout lay, int n, float* __restrict__ dwA,
                                   float* __restrict__ dwx,
                                   float* __restrict__ db, size_t ss) {
  __shared__ float a_s[kTile][kTile + 1];
  __shared__ float d_s[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int m = blockIdx.x * kTile + tx;
  const int k0 = blockIdx.y * kTile;
  const int stream = blockIdx.z % lay.R;
  const size_t so = (blockIdx.z / lay.R) * ss;
  A += so;
  x = dednn::shift(x, so);
  dz += so;
  dwA += so;
  dwx = dednn::shift(dwx, so);
  db = dednn::shift(db, so);
  const int end = (stream + 1) * lay.B;
  const bool bias = db != nullptr && blockIdx.y == 0 && ty == 0;
  float acc[kTile / 8] = {};
  float bacc = 0.0f;
  for (int r0 = stream * lay.B; r0 < end; r0 += kTile) {
    for (int rr = ty; rr < kTile; rr += 8) {
      const int r = r0 + rr, k = k0 + tx;
      float a = 0.0f;
      if (r < end) {
        if (k < KA) a = A[static_cast<size_t>(r) * KA + k];
        else if (k == KA && x != nullptr) a = x[r];
      }
      a_s[rr][tx] = a;
      d_s[rr][tx] =
          (r < end && m < M) ? dz[static_cast<size_t>(r) * M + m] : 0.0f;
    }
    __syncthreads();
    const int rows = min(kTile, end - r0);
    for (int rr = 0; rr < rows; ++rr) {
      const float d = d_s[rr][tx];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        acc[i] = fmaf(a_s[rr][ty + 8 * i], d, acc[i]);
      if (bias) bacc += d;
    }
    __syncthreads();
  }
  if (m >= M) return;
  const size_t part = static_cast<size_t>(stream) * n;
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int k = k0 + ty + 8 * i;
    if (k < KA) dwA[part + static_cast<size_t>(k) * M + m] = acc[i];
    else if (k == KA && x != nullptr) dwx[part + m] = acc[i];
  }
  if (bias) db[part + m] = lay.is_value(stream) ? bacc : 0.0f;
}

// Thread (b, j), the VJP of s' = om⊙H + Z⊙s (om = mask − G) at column j
// (fused_dgm.py:265-272): d_om, dH, dZ and ds_prev by the product rule
// (value: u_v·b_v + Σ u_t·b_t; tangent: u_t·b_v), dG = −d_om, and the
// activation VJPs (value: σ'·u_v + σ''·Σ z_t·u_t; tangent: σ'·u_t) into
// dh_pre (column j) and dzgr_pre (columns j and H + j).
__global__ void gate_bwd1_kernel(const float* __restrict__ ds,
                                 const float* __restrict__ s_prev,
                                 const float* __restrict__ zgr_pre,
                                 const float* __restrict__ h_pre, Layout lay,
                                 int H, int act, float* __restrict__ dh_pre,
                                 float* __restrict__ dzgr_pre,
                                 float* __restrict__ ds_prev, size_t ss) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss;
  ds += so;
  s_prev += so;
  zgr_pre += so;
  h_pre += so;
  dh_pre += so;
  dzgr_pre += so;
  ds_prev += so;
  const int b = idx / H, j = idx - b * H;
  const int B = lay.B;
  for (int v = 0; v < lay.R; ++v) {
    if (!lay.is_value(v)) continue;
    const float zp = zgr_pre[at(v, b, B, 3 * H, j)];
    const float gp = zgr_pre[at(v, b, B, 3 * H, H + j)];
    const float hp = h_pre[at(v, b, B, H, j)];
    const float z_v = act_value(act, zp), dz = act_slope(act, zp, z_v);
    const float g_v = act_value(act, gp), dg = act_slope(act, gp, g_v);
    const float h_v = act_value(act, hp), dh = act_slope(act, hp, h_v);
    const float om_v = 1.0f - g_v;
    const float u_v = ds[at(v, b, B, H, j)], sp_v = s_prev[at(v, b, B, H, j)];
    float d_om = u_v * h_v, dh_v = u_v * om_v, dz_v = u_v * sp_v;
    float dsp_v = u_v * z_v;
    float pz = 0.0f, pg = 0.0f, ph = 0.0f;  // Σ pre_t·u_t per activation
    for (int t = v + 1; t < lay.R && !lay.is_value(t); ++t) {
      const float zp_t = zgr_pre[at(t, b, B, 3 * H, j)];
      const float gp_t = zgr_pre[at(t, b, B, 3 * H, H + j)];
      const float hp_t = h_pre[at(t, b, B, H, j)];
      const float z_t = dz * zp_t, om_t = -(dg * gp_t), h_t = dh * hp_t;
      const float u_t = ds[at(t, b, B, H, j)];
      const float sp_t = s_prev[at(t, b, B, H, j)];
      d_om = d_om + u_t * h_t;
      dh_v = dh_v + u_t * om_t;
      dz_v = dz_v + u_t * sp_t;
      dsp_v = dsp_v + u_t * z_t;
      const float dh_t = u_t * om_v, dz_t = u_t * sp_v;
      const float dg_t = -(u_t * h_v);
      ph += hp_t * dh_t;
      pz += zp_t * dz_t;
      pg += gp_t * dg_t;
      dh_pre[at(t, b, B, H, j)] = dh * dh_t;
      dzgr_pre[at(t, b, B, 3 * H, j)] = dz * dz_t;
      dzgr_pre[at(t, b, B, 3 * H, H + j)] = dg * dg_t;
      ds_prev[at(t, b, B, H, j)] = u_t * z_v;
    }
    const float dg_v = -d_om;
    dh_pre[at(v, b, B, H, j)] = dh * dh_v + act_curve(act, h_v, dh) * ph;
    dzgr_pre[at(v, b, B, 3 * H, j)] =
        dz * dz_v + act_curve(act, z_v, dz) * pz;
    dzgr_pre[at(v, b, B, 3 * H, H + j)] =
        dg * dg_v + act_curve(act, g_v, dg) * pg;
    ds_prev[at(v, b, B, H, j)] = dsp_v;
  }
}

// Thread (b, j), the VJP of sr = s ⊙ R at column j (fused_dgm.py:277-282):
// ds_prev += dsr ⊙' R, dR = dsr ⊙' s_prev (the product rule as above),
// then R's activation VJP into dzgr_pre column 2H + j.
__global__ void gate_bwd2_kernel(const float* __restrict__ dsr,
                                 const float* __restrict__ s_prev,
                                 const float* __restrict__ zgr_pre,
                                 Layout lay, int H, int act,
                                 float* __restrict__ ds_prev,
                                 float* __restrict__ dzgr_pre, size_t ss) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss;
  dsr += so;
  s_prev += so;
  zgr_pre += so;
  ds_prev += so;
  dzgr_pre += so;
  const int b = idx / H, j = idx - b * H;
  const int B = lay.B;
  for (int v = 0; v < lay.R; ++v) {
    if (!lay.is_value(v)) continue;
    const float rp = zgr_pre[at(v, b, B, 3 * H, 2 * H + j)];
    const float r_v = act_value(act, rp), dr = act_slope(act, rp, r_v);
    const float u_v = dsr[at(v, b, B, H, j)], sp_v = s_prev[at(v, b, B, H, j)];
    float dsp = u_v * r_v, dr_v = u_v * sp_v, pr = 0.0f;
    for (int t = v + 1; t < lay.R && !lay.is_value(t); ++t) {
      const float rp_t = zgr_pre[at(t, b, B, 3 * H, 2 * H + j)];
      const float u_t = dsr[at(t, b, B, H, j)];
      const float sp_t = s_prev[at(t, b, B, H, j)];
      dsp = dsp + u_t * (dr * rp_t);
      dr_v = dr_v + u_t * sp_t;
      const float dr_t = u_t * sp_v;
      pr += rp_t * dr_t;
      const size_t o = at(t, b, B, H, j);
      ds_prev[o] = ds_prev[o] + u_t * r_v;
      dzgr_pre[at(t, b, B, 3 * H, 2 * H + j)] = dr * dr_t;
    }
    const size_t o = at(v, b, B, H, j);
    ds_prev[o] = ds_prev[o] + dsp;
    dzgr_pre[at(v, b, B, 3 * H, 2 * H + j)] =
        dr * dr_v + act_curve(act, r_v, dr) * pr;
  }
}

// Thread (b, j): the input layer's activation VJP, dz0 = act_bwd(pre, ds).
__global__ void input_bwd_kernel(const float* __restrict__ ds,
                                 const float* __restrict__ pre, Layout lay,
                                 int H, int act, float* __restrict__ dz0,
                                 size_t ss) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H) return;
  const size_t so = blockIdx.y * ss;
  ds += so;
  pre += so;
  dz0 += so;
  const int b = idx / H, j = idx - b * H;
  const int B = lay.B;
  for (int v = 0; v < lay.R; ++v) {
    if (!lay.is_value(v)) continue;
    const float zp = pre[at(v, b, B, H, j)];
    const float a = act_value(act, zp), d = act_slope(act, zp, a);
    float p = 0.0f;
    for (int t = v + 1; t < lay.R && !lay.is_value(t); ++t) {
      const float u_t = ds[at(t, b, B, H, j)];
      p += pre[at(t, b, B, H, j)] * u_t;
      dz0[at(t, b, B, H, j)] = d * u_t;
    }
    dz0[at(v, b, B, H, j)] = d * ds[at(v, b, B, H, j)] + act_curve(act, a, d) * p;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

long long n_params(int H, int L, int O) {  // D = 1
  return 2LL * H + static_cast<long long>(L) * (4LL * H * H + 8LL * H) +
         static_cast<long long>(H) * O + O;
}

// Offsets of the flat buffer's tensors (fused_dgm.pack_dgm order).
struct Offsets {
  size_t w_in, b_in, Wzgr, Uzgr, bzgr, Wh, Uh, bh, w_out, b_out;
  Offsets(int H, int L, int O) {
    const size_t h = H, l = L;
    w_in = 0;
    b_in = h;
    Wzgr = 2 * h;
    Uzgr = Wzgr + l * h * 3 * h;
    bzgr = Uzgr + l * 3 * h;
    Wh = bzgr + l * 3 * h;
    Uh = Wh + l * h * h;
    bh = Uh + l * h;
    w_out = bh + l * h;
    b_out = w_out + h * O;
  }
};

long long scratch_floats(int R, int B, int H, int L, int O) {
  const long long N = static_cast<long long>(R) * B, layer = N * H;
  return N + layer + (L + 1) * layer + 3LL * L * layer + 2LL * L * layer +
         2 * N * O + 5LL * B + 7 * layer + R * n_params(H, L, O);
}

// The per-stream gradient partials [R][n] at the end of scratch.
float* partials_of(float* scratch, int R, int B, int H, int L, int O) {
  return scratch + scratch_floats(R, B, H, L, O) - R * n_params(H, L, O);
}

bool valid(int spec, int R, int O, unsigned value_mask) {
  if (R < 1 || R > kMaxStreams) return false;
  if (spec == kFitzHughNagumo) return R == 3 && value_mask == 5u && O == 2;
  if (spec == kFredholm)
    return R >= 2 && O == 1 &&
           value_mask == (R == 32 ? 0xffffffffu : (1u << R) - 1u);
  return false;
}

// Enqueue one step's forward and backward: loss -> *loss, the gradient's
// per-stream partials -> partials_of(scratch). For `reps` replicas, replica
// r's parameters are at p + r·n, its scratch at scratch + r·scratch_floats
// and its loss at loss + r·ls; every launch covers all of them.
cudaError_t grad_step(int spec, const Consts& c, const float* cnst,
                      const float* p, const float* u, float* scratch,
                      float* loss, int reps, size_t ls, const Layout& lay,
                      int H, int L, int O, int act, cudaStream_t stream) {
  const int R = lay.R, B = lay.B, N = R * B;
  const size_t layer = static_cast<size_t>(N) * H;
  const int n = static_cast<int>(n_params(H, L, O));
  const size_t ss = scratch_floats(R, B, H, L, O);
  const Offsets off(H, L, O);
  float* X = scratch;                    // [N]
  float* PRE = X + N;                    // [N, H] input pre-activation
  float* ST = PRE + layer;               // [L + 1][N, H] states
  float* ZG = ST + (L + 1) * layer;      // [L][N, 3H] gate pre-activations
  float* HP = ZG + 3 * L * layer;        // [L][N, H] H pre-activations
  float* SR = HP + L * layer;            // [L][N, H] s ⊙ R
  float* OUT = SR + L * layer;           // [N, O]
  float* G = OUT + static_cast<size_t>(N) * O;  // [N, O] output cotangent
  float* AUX = G + static_cast<size_t>(N) * O;  // [5B] loss scratch
  float* DS = AUX + 5 * B;           // [N, H] cotangent of the state
  float* DSP = DS + layer;               // [N, H] of the previous state
  float* DHP = DSP + layer;              // [N, H] of h_pre (and dz0)
  float* DSR = DHP + layer;              // [N, H] of s ⊙ R
  float* DZ = DSR + layer;               // [N, 3H] of the gates' pre-acts
  float* part = partials_of(scratch, R, B, H, L, O);

  const dim3 ew(dednn::ceil_div(B * H, kEwThreads), reps);
  const dim3 sq(16, 16), wt(32, 8);
  auto gemm_grid = [reps](int rows, int cols) {
    return dim3(dednn::ceil_div(cols, kTile), dednn::ceil_div(rows, kTile),
                reps);
  };
  auto wgrad_grid = [R, reps](int k_rows, int cols) {
    return dim3(dednn::ceil_div(cols, kTile), dednn::ceil_div(k_rows, kTile),
                reps * R);
  };

  input_kernel<<<ew, kEwThreads, 0, stream>>>(spec, u, cnst, c, lay,
                                              p + off.w_in, p + off.b_in, H,
                                              act, X, PRE, ST, ss, n);
  for (int l = 0; l < L; ++l) {
    const float* S = ST + l * layer;
    float* Z = ZG + 3 * l * layer;
    float* Hh = HP + l * layer;
    float* SRl = SR + l * layer;
    const size_t lw3 = static_cast<size_t>(l) * 3 * H;
    const size_t lw = static_cast<size_t>(l) * H;
    gemm_kernel<false><<<gemm_grid(N, 3 * H), sq, 0, stream>>>(
        S, p + off.Wzgr + lw3 * H, N, H, 3 * H, X, p + off.Uzgr + lw3,
        p + off.bzgr + lw3, lay, nullptr, Z, ss, n);
    gate_fwd_kernel<<<ew, kEwThreads, 0, stream>>>(Z, S, lay, H, act, SRl,
                                                   ss);
    gemm_kernel<false><<<gemm_grid(N, H), sq, 0, stream>>>(
        SRl, p + off.Wh + lw * H, N, H, H, X, p + off.Uh + lw,
        p + off.bh + lw, lay, nullptr, Hh, ss, n);
    state_fwd_kernel<<<ew, kEwThreads, 0, stream>>>(Z, Hh, S, lay, H, act,
                                                    ST + (l + 1) * layer, ss);
  }
  const float* S_L = ST + L * layer;
  if (spec == kFitzHughNagumo) {
    fn_loss_kernel<<<reps, kLossThreads, 0, stream>>>(
        S_L, H, p + off.w_out, p + off.b_out, lay, c, OUT, G, AUX, loss, ss,
        n, ls);
  } else {
    fredholm_loss_kernel<<<reps, kLossThreads, 0, stream>>>(
        S_L, H, p + off.w_out, p + off.b_out, lay, u, cnst, c, OUT, G, AUX,
        loss, ss, n, ls);
  }

  weight_grad_kernel<<<wgrad_grid(H, O), wt, 0, stream>>>(
      S_L, H, nullptr, G, O, lay, n, part + off.w_out, nullptr,
      part + off.b_out, ss);
  out_bwd_kernel<<<dim3(dednn::ceil_div(N * H, kAdamThreads), reps),
                   kAdamThreads, 0, stream>>>(G, p + off.w_out, N, H, O, DS,
                                              ss, n);
  for (int l = L - 1; l >= 0; --l) {
    const float* S = ST + l * layer;
    const float* Z = ZG + 3 * l * layer;
    const float* Hh = HP + l * layer;
    const float* SRl = SR + l * layer;
    const size_t lw3 = static_cast<size_t>(l) * 3 * H;
    const size_t lw = static_cast<size_t>(l) * H;
    gate_bwd1_kernel<<<ew, kEwThreads, 0, stream>>>(DS, S, Z, Hh, lay, H, act,
                                                    DHP, DZ, DSP, ss);
    weight_grad_kernel<<<wgrad_grid(H + 1, H), wt, 0, stream>>>(
        SRl, H, X, DHP, H, lay, n, part + off.Wh + lw * H, part + off.Uh + lw,
        part + off.bh + lw, ss);
    gemm_kernel<true><<<gemm_grid(N, H), sq, 0, stream>>>(
        DHP, p + off.Wh + lw * H, N, H, H, nullptr, nullptr, nullptr, lay,
        nullptr, DSR, ss, n);
    gate_bwd2_kernel<<<ew, kEwThreads, 0, stream>>>(DSR, S, Z, lay, H, act,
                                                    DSP, DZ, ss);
    weight_grad_kernel<<<wgrad_grid(H + 1, 3 * H), wt, 0, stream>>>(
        S, H, X, DZ, 3 * H, lay, n, part + off.Wzgr + lw3 * H,
        part + off.Uzgr + lw3, part + off.bzgr + lw3, ss);
    gemm_kernel<true><<<gemm_grid(N, H), sq, 0, stream>>>(
        DZ, p + off.Wzgr + lw3 * H, N, 3 * H, H, nullptr, nullptr, nullptr,
        lay, DSP, DS, ss, n);
  }
  input_bwd_kernel<<<ew, kEwThreads, 0, stream>>>(DS, PRE, lay, H, act, DHP,
                                                  ss);
  weight_grad_kernel<<<wgrad_grid(1, H), wt, 0, stream>>>(
      X, 1, nullptr, DHP, H, lay, n, part + off.w_in, nullptr,
      part + off.b_in, ss);
  return cudaGetLastError();
}

Consts load_consts(const float* consts) {
  Consts c;
  for (int i = 0; i < kMaxConsts; ++i) c.c[i] = consts[i];
  return c;
}

}  // namespace

// Floats of scratch one call needs at R streams of B rows (D = 1).
extern "C" long long dgm_scratch_floats(int R, int B, int H, int L, int O) {
  return scratch_floats(R, B, H, L, O);
}

// The most stream rows per batch point the kernels hold.
extern "C" int dgm_max_streams() { return kMaxStreams; }

// One step's loss and flat gradient (kernel #7 alone). consts: the spec's
// kMaxConsts numbers, in host memory; cnst: Fredholm's [2(R−1), B] nodes
// and weights on the device (unused by FitzHugh–Nagumo).
extern "C" int dgm_grad(int spec, const float* consts, const float* cnst,
                        const float* p, const float* u, float* scratch,
                        float* grad, float* loss, int R, int B, int H, int L,
                        int O, int act, unsigned value_mask, void* stream) {
  if (!valid(spec, R, O, value_mask)) return cudaErrorInvalidValue;
  const Consts c = load_consts(consts);
  const Layout lay{R, B, value_mask};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = grad_step(spec, c, cnst, p, u, scratch, loss, 1, 0, lay,
                              H, L, O, act, st);
  if (err != cudaSuccess) return err;
  const int n = static_cast<int>(n_params(H, L, O));
  sum_partials_kernel<<<dednn::ceil_div(n, kAdamThreads), kAdamThreads, 0,
                        st>>>(partials_of(scratch, R, B, H, L, O), R, n,
                              grad);
  return cudaGetLastError();
}

// K Adam steps of N packed replicas (kernel #5 around #7): p, m, v [N, n]
// updated in place, losses [N, K], scratch N·dgm_scratch_floats; the
// uniforms [K, B], the layout, the consts, cnst and the schedule are
// shared. *step_math_runs (host memory) is set to the number of
// replica-steps whose step math was enqueued. N·R above the grid's 65 535
// is refused.
extern "C" int dgm_train_packed(int spec, const float* consts,
                                const float* cnst, float* p, float* m,
                                float* v, const float* u, float* scratch,
                                float* losses, int N, int K, int R, int B,
                                int H, int L, int O, int act,
                                unsigned value_mask, float lr, int step0,
                                int schedule, float horizon, float decay,
                                float half_span, float log_decay,
                                int* step_math_runs, void* stream) {
  *step_math_runs = 0;
  if (!valid(spec, R, O, value_mask)) return cudaErrorInvalidValue;
  if (N < 1 || N > dednn::kMaxGridYZ / R) return cudaErrorInvalidValue;
  const Consts c = load_consts(consts);
  const Layout lay{R, B, value_mask};
  const Schedule sched{schedule, horizon, decay, half_span, log_decay};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(n_params(H, L, O));
  const float* part = partials_of(scratch, R, B, H, L, O);
  const dim3 adam_grid(dednn::ceil_div(n, kAdamThreads), N);
  for (int k = 0; k < K; ++k) {
    cudaError_t err = grad_step(spec, c, cnst, p,
                                u + static_cast<size_t>(k) * B, scratch,
                                losses + k, N, K, lay, H, L, O, act, st);
    if (err != cudaSuccess) return err;
    *step_math_runs += N;
    adam_kernel<<<adam_grid, kAdamThreads, 0, st>>>(
        p, m, v, part, R, n, scratch_floats(R, B, H, L, O), lr,
        static_cast<float>(step0 + k + 1), sched);
  }
  return cudaGetLastError();
}
