// K Adam steps of any stream spec's PINN (tanh MLP D -> H x L -> 1), and
// one step's loss and gradient.
//
// Replaces: differential_equations_dnn_tpu/kernels/engine_core.py::
// fused_adam_kernel (reached through run_fused_chunk; kernel #4) around
// kernels/fused_engine.py::engine_step_math (kernel #6). The TPU kernel
// keeps p, m, v in VMEM for all K steps and runs the spec's step math
// (a group-generic Taylor forward, the loss cotangent by JAX's vjp, a hand
// backward) inside each step, then Adam with a constant, cosine or
// exponential learning rate computed from the absolute step.
//
// What bounds it on the H100: one step is 6·R·B·L·H² fp32 operations or so
// (heat2d, the widest: R = 11 streams, B = 256, H = 128, L = 3: about 0.8
// GFLOP, 12 µs at the 67 TFLOP/s fp32 peak) spread over a dozen dependent
// phases with a few thousand to a few tens of thousands of outputs each.
// As for csrc/heat_train.cu, the latency of each phase and of the launches
// between them, not the fp32 pipes or HBM, is the limit.
//
// What the design does about it: the launch sequence of heat_train.cu,
// generalised from heat's 7 hard-wired streams and D = 2 to a stream layout
// given at compile time by the spec (a template over the spec struct; one
// instantiation each for R = 3, 5, 7, 9, 11):
//   fwd_layer  x (L+1)  R-stream stacked Taylor forward; the first layer
//                       builds the spec's input rows from the uniforms
//   loss       x 1      output layer, the spec's point loss and its
//                       cotangent written out by hand, loss[k], G [R·B]
//   bwd_weight x (L+2)  dW = act(z)^T dz and db, one partial per stream
//   bwd_data   x (L+1)  g = dz W^T, then the group-generic Taylor VJP
//   adam       x 1      sums the R partials in stream order, lr(t), Adam
//                       (adam.cuh, shared with dgm_train.cu)
// p, m and v are each one flat fp32 buffer (L2-resident at these sizes).
// Every reduction runs in a fixed order with no atomics, so runs are
// bit-identical and a run cut into chunks equals the uncut run. Every
// product is fp32 FFMA: exact fp32 ("highest"), no tensor cores.
//
// Packed replicas (kernel #5, engine_core.py::fused_packed_adam_kernel,
// reached through run_fused_packed): engine_train_packed advances N
// independent runs that share the uniforms and the lr schedule. p, m and
// v are [N, n] replica-major, each replica has its own scratch (stride
// scratch_floats), and the loss history is [N, K]. A step is the same
// launch sequence as one run's, each launch with N times the blocks: the
// replica is the grid's z index (fwd_layer, bwd_data), part of it
// (bwd_weight: z = r·R + stream), x (loss) or y (adam). Every kernel moves
// its pointers to its replica's copy and then runs the single-replica code,
// so replica r of a packed call equals a one-replica call on r's state bit
// for bit. A single run (fused_engine_chunk) is the packed call at N = 1.
//
// Row layout of every [R·B, width] activation: stream s, batch row b at row
// s·B + b, streams in fused_engine.Group order (per group: value, then the
// (first, second) Taylor pairs, then the first-only tangents).
#include <algorithm>
#include <cmath>

#include "adam.cuh"
#include "common.cuh"

namespace {

using dednn::adam_kernel;
using dednn::Schedule;
using dednn::sum_partials_kernel;

constexpr int kTile = 32;          // bwd_weight: 32 x 32 outputs per block
constexpr int kSplitWarps = 8;     // fwd_layer, bwd_data: warps per block
constexpr int kColsPerLane = 4;
constexpr int kColsPerWarp = 32 * kColsPerLane;
constexpr int kLossThreads = 1024;
constexpr int kAdamThreads = 256;
constexpr int kMaxConsts = 8;

// The spec's numbers (fused_engine.<Spec>.kernel_consts), passed by value.
struct Consts {
  float c[kMaxConsts];
};

// ---------------------------------------------------------------------------
// Stream layouts
// ---------------------------------------------------------------------------

// Row kinds, 2 bits per row: a value row starts each group.
enum Kind : unsigned { kValue = 0, kPairFirst = 1, kPairSecond = 2, kFirst = 3 };

constexpr unsigned pack_kinds() { return 0u; }
template <class... Rest>
constexpr unsigned pack_kinds(Kind k, Rest... rest) {
  return static_cast<unsigned>(k) | (pack_kinds(rest...) << 2);
}

// The value row of each row's group, 4 bits per row (evaluated by the host
// compiler: the result is a plain constant in device code).
constexpr unsigned long long pack_value_rows(unsigned kinds, int R) {
  unsigned long long out = 0;
  int v = 0;
  for (int s = 0; s < R; ++s) {
    if (((kinds >> (2 * s)) & 3u) == kValue) v = s;
    out |= static_cast<unsigned long long>(v) << (4 * s);
  }
  return out;
}

constexpr unsigned pack_value_mask(unsigned kinds, int R) {
  unsigned out = 0;
  for (int s = 0; s < R; ++s)
    if (((kinds >> (2 * s)) & 3u) == kValue) out |= 1u << s;
  return out;
}

// Inside loops unrolled over s these fold to constants, so every per-row
// register array below is indexed by constants only.
template <class S>
__device__ __forceinline__ unsigned kind_of(int s) {
  return (S::kKinds >> (2 * s)) & 3u;
}
template <class S>
__device__ __forceinline__ int value_of(int s) {
  return static_cast<int>((S::kValueRows >> (4 * s)) & 15u);
}

#define DEDNN_LAYOUT(...)                                                  \
  static constexpr unsigned kKinds = pack_kinds(__VA_ARGS__);              \
  static constexpr unsigned long long kValueRows =                         \
      pack_value_rows(kKinds, R);                                          \
  static constexpr unsigned kValueMask = pack_value_mask(kKinds, R);

// ---------------------------------------------------------------------------
// Specs: build (input rows from the uniforms) and the point loss with its
// cotangent by hand. loss(...) returns the point's summed loss terms and
// writes g[s] = d(point loss)/d(out_s); the loss kernel scales by 1/B (the
// batch mean, fused_engine._smean). Constants are fp32 (kernel_consts).
// ---------------------------------------------------------------------------

// dy/dt = -y, y(0) = y_ic. c: sample_scale·t_max, y_ic.
struct SimpleOde {
  static constexpr int R = 3, D = 1, U = 1;
  DEDNN_LAYOUT(kValue, kFirst, kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    X[0] = c.c[0] * u[0];  // t
    X[1] = 1.0f;           // t-tangent
    X[2] = 0.0f;           // t = 0
  }
  __device__ static float loss(const float*, const Consts& c, const float* o,
                               float* g) {
    const float r = o[1] + o[0];     // y' + y
    const float r0 = o[2] - c.c[1];  // y(0) - y_ic
    g[0] = 2.0f * r;
    g[1] = 2.0f * r;
    g[2] = 2.0f * r0;
    return r * r + r0 * r0;
  }
};

// Streams shared by heat and burgers: (x,t), x'/x'' pair, t', IC (x,0),
// boundaries (0,t) and (x_max,t). c[0] = x_max, c[1] = t_max.
__device__ __forceinline__ void build_xt7(const float* u, const Consts& c,
                                          float* X) {
  const float x = c.c[0] * u[0], t = c.c[1] * u[1];
  const float rows[14] = {x,    t, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                          1.0f, x, 0.0f, 0.0f, t,    c.c[0], t};
  for (int i = 0; i < 14; ++i) X[i] = rows[i];
}

// u_t = kappa u_xx. c: x_max, t_max, kappa.
struct Heat {
  static constexpr int R = 7, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst, kValue, kValue,
               kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    build_xt7(u, c, X);
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float kappa = c.c[2];
    const float r = o[3] - kappa * o[2];
    const float r0 = o[4] - sinf(c.c[0] * u[0]);
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = -2.0f * kappa * r;
    g[3] = 2.0f * r;
    g[4] = 2.0f * r0;
    g[5] = 2.0f * o[5];
    g[6] = 2.0f * o[6];
    return r * r + r0 * r0 + o[5] * o[5] + o[6] * o[6];
  }
};

// u_t + u u_x = nu u_xx against the travelling wave
// E(x,t) = c - a tanh(a (x - c t - x0) / (2 nu)).
// c: x_max, t_max, nu, a, c, x0, 2 nu.
struct Burgers {
  static constexpr int R = 7, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst, kValue, kValue,
               kValue)
  __device__ static float exact(const Consts& c, float x, float t) {
    return c.c[4] - c.c[3] * tanhf(c.c[3] * (x - c.c[4] * t - c.c[5]) / c.c[6]);
  }
  __device__ static void build(const float* u, const Consts& c, float* X) {
    build_xt7(u, c, X);
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float nu = c.c[2];
    // The value stream enters the residual: g0 = 2 r u_x, g1 = 2 r u.
    const float r = o[3] + o[0] * o[1] - nu * o[2];
    const float r_ic = o[4] - exact(c, x, 0.0f);
    const float r_b0 = o[5] - exact(c, 0.0f, t);
    const float r_b1 = o[6] - exact(c, c.c[0], t);
    g[0] = 2.0f * r * o[1];
    g[1] = 2.0f * r * o[0];
    g[2] = -2.0f * nu * r;
    g[3] = 2.0f * r;
    g[4] = 2.0f * r_ic;
    g[5] = 2.0f * r_b0;
    g[6] = 2.0f * r_b1;
    return r * r + r_ic * r_ic + r_b0 * r_b0 + r_b1 * r_b1;
  }
};

// u_tt = c² u_xx, u(x,0) = sin x, u_t(x,0) = 0, u = 0 at x = 0, x_max.
// c: x_max, t_max, c², velocity weight.
struct Wave {
  static constexpr int R = 9, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kValue, kFirst, kValue, kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float rows[18] = {x,    t,    1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 1.0f, 0.0f, 0.0f, x,    0.0f,
                            0.0f, 1.0f, 0.0f, t,    c.c[0], t};
    for (int i = 0; i < 18; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float c2 = c.c[2], vw = c.c[3];
    const float r = o[4] - c2 * o[2];
    const float r_pos = o[5] - sinf(c.c[0] * u[0]);
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = -2.0f * c2 * r;
    g[3] = 0.0f;
    g[4] = 2.0f * r;
    g[5] = 2.0f * r_pos;
    g[6] = 2.0f * vw * o[6];  // the velocity IC on the t=0 face's tangent
    g[7] = 2.0f * o[7];
    g[8] = 2.0f * o[8];
    return r * r + r_pos * r_pos + vw * (o[6] * o[6]) + o[7] * o[7] +
           o[8] * o[8];
  }
};

// u_t + c u_x = 0, u(x,0) = sin x, u(0,t) = sin(-c t).
// c: x_max, t_max, c, -c.
struct Advection {
  static constexpr int R = 5, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kFirst, kFirst, kValue, kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float rows[10] = {x, t, 1.0f, 0.0f, 0.0f, 1.0f, x, 0.0f, 0.0f, t};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float q = o[2] + c.c[2] * o[1];
    const float r0 = o[3] - sinf(x);
    const float rb = o[4] - sinf(c.c[3] * t);
    g[0] = 0.0f;
    g[1] = 2.0f * c.c[2] * q;
    g[2] = 2.0f * q;
    g[3] = 2.0f * r0;
    g[4] = 2.0f * rb;
    return q * q + (r0 * r0 + rb * rb);
  }
};

// -(u_xx + u_yy) = 2 sin x sin y, u = 0 on the four faces. c: x_max.
struct Poisson {
  static constexpr int R = 9, D = 2, U = 3;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kValue, kValue, kValue, kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    const float xm = c.c[0];
    const float x = xm * u[0], y = xm * u[1], e = xm * u[2];
    const float rows[18] = {x,    y,    1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 1.0f, 0.0f, 0.0f, 0.0f, e,
                            xm,   e,    e,    0.0f, e,    xm};
    for (int i = 0; i < 18; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float x = c.c[0] * u[0], y = c.c[0] * u[1];
    const float src = 2.0f * sinf(x) * sinf(y);
    const float r = -(o[2] + o[4]) - src;
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = -2.0f * r;
    g[3] = 0.0f;
    g[4] = -2.0f * r;
    float sum = r * r;
#pragma unroll
    for (int s = 5; s < 9; ++s) {
      g[s] = 2.0f * o[s];
      sum += o[s] * o[s];
    }
    return sum;
  }
};

// u_t = kappa (u_xx + u_yy), u(x,y,0) = sin x sin y, u = 0 on the faces.
// c: x_max, t_max, kappa.
struct Heat2D {
  static constexpr int R = 11, D = 3, U = 4;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kFirst, kValue, kValue, kValue, kValue, kValue)
  __device__ static void build(const float* u, const Consts& c, float* X) {
    const float xm = c.c[0];
    const float x = xm * u[0], y = xm * u[1], t = c.c[1] * u[2];
    const float e = xm * u[3];
    const float rows[33] = {x,    y,    t,    1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 0.0f, 0.0f, 1.0f, x,    y,    0.0f,
                            0.0f, e,    t,    xm,   e,    t,    e,
                            0.0f, t,    e,    xm,   t};
    for (int i = 0; i < 33; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const float* u, const Consts& c,
                               const float* o, float* g) {
    const float x = c.c[0] * u[0], y = c.c[0] * u[1];
    const float kappa = c.c[2];
    const float r = o[5] - kappa * (o[2] + o[4]);
    const float r0 = o[6] - sinf(x) * sinf(y);
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = -2.0f * kappa * r;
    g[3] = 0.0f;
    g[4] = -2.0f * kappa * r;
    g[5] = 2.0f * r;
    g[6] = 2.0f * r0;
    float sum = r * r + r0 * r0;
#pragma unroll
    for (int s = 7; s < 11; ++s) {
      g[s] = 2.0f * o[s];
      sum += o[s] * o[s];
    }
    return sum;
  }
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// z = in @ w + mask * b for the R streams of batch row blockIdx.x, then the
// Taylor rules of tanh (fused_engine._act_fwd), for the kColsPerWarp columns
// of blockIdx.y. Block (32, kSplitWarps): warp y sums its own slice of the
// k range into an R x kColsPerLane register tile; the slices' partial sums
// are added in warp order through shared memory. For the first layer
// (u != nullptr) the spec builds the row's R input rows from its uniforms,
// which are also written to x_out. Replica blockIdx.z: its activations at
// z·ss (scratch stride), its weights at z·ps.
template <class S>
__global__ void fwd_layer_kernel(const float* __restrict__ in, int k_in,
                                 const float* __restrict__ u, Consts c,
                                 float* __restrict__ x_out,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b, int k_out, int B,
                                 float* __restrict__ z_out,
                                 float* __restrict__ a_out, size_t ss,
                                 size_t ps) {
  constexpr int R = S::R;
  extern __shared__ float smem[];
  const size_t so = blockIdx.z * ss, po = blockIdx.z * ps;
  in = dednn::shift(in, so);
  x_out = dednn::shift(x_out, so);
  w += po;
  b += po;
  z_out += so;
  a_out += so;
  float* in_s = smem;                // [R][k_in]
  float* part_s = smem + R * k_in;   // [kSplitWarps][R][kColsPerWarp]
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row = blockIdx.x;
  const int j0 = blockIdx.y * kColsPerWarp;
  if (u != nullptr) {  // k_in == S::D
    if (tid == 0) {
      float X[R * S::D];
      S::build(u + static_cast<size_t>(row) * S::U, c, X);
      for (int i = 0; i < R * S::D; ++i) in_s[i] = X[i];
      if (blockIdx.y == 0) {
        for (int s = 0; s < R; ++s)
          for (int d = 0; d < S::D; ++d)
            x_out[static_cast<size_t>(s * B + row) * S::D + d] = X[s * S::D + d];
      }
    }
  } else {
    for (int i = tid; i < R * k_in; i += 32 * kSplitWarps) {
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
  for (int cc = 0; cc < kColsPerLane; ++cc)
    col[cc] = min(j0 + lane + 32 * cc, k_out - 1);
  float z[R][kColsPerLane] = {};
#pragma unroll 4
  for (int k = k_begin; k < k_end; ++k) {
    float wk[kColsPerLane];
#pragma unroll
    for (int cc = 0; cc < kColsPerLane; ++cc)
      wk[cc] = w[static_cast<size_t>(k) * k_out + col[cc]];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float x = in_s[s * k_in + k];
#pragma unroll
      for (int cc = 0; cc < kColsPerLane; ++cc)
        z[s][cc] = fmaf(x, wk[cc], z[s][cc]);
    }
  }
#pragma unroll
  for (int s = 0; s < R; ++s)
#pragma unroll
    for (int cc = 0; cc < kColsPerLane; ++cc)
      part_s[(warp * R + s) * kColsPerWarp + lane + 32 * cc] = z[s][cc];
  __syncthreads();

  for (int jj = tid; jj < kColsPerWarp; jj += 32 * kSplitWarps) {
    const int j = j0 + jj;
    if (j >= k_out) break;
    const float bj = b[j];
    float zc[R], a[R], a0[R], d[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float sum = part_s[s * kColsPerWarp + jj];
      for (int p = 1; p < kSplitWarps; ++p)
        sum += part_s[(p * R + s) * kColsPerWarp + jj];
      zc[s] = kind_of<S>(s) == kValue ? sum + bj : sum;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int v = value_of<S>(s);
      const unsigned kind = kind_of<S>(s);
      if (kind == kValue) {
        a0[s] = tanhf(zc[s]);
        d[s] = 1.0f - a0[s] * a0[s];
        a[s] = a0[s];
      } else if (kind == kPairSecond) {
        const float z1 = zc[s > 0 ? s - 1 : 0];
        a[s] = d[v] * zc[s] - 2.0f * a0[v] * d[v] * (z1 * z1);
      } else {
        a[s] = d[v] * zc[s];
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const size_t at = static_cast<size_t>(s * B + row) * k_out + j;
      z_out[at] = zc[s];
      a_out[at] = a[s];
    }
  }
}

// The output layer (O = 1), the spec's point loss, loss = the batch mean,
// and the output gradient G [R·B] = (1/B) d(point loss)/d(out). One block
// per replica (blockIdx.x; its loss at x·ls); warp w takes batch rows w,
// w + 32, ... and reduces each dot product with a butterfly shuffle (fixed
// order).
template <class S>
__global__ void loss_kernel(const float* __restrict__ a, int h,
                            const float* __restrict__ w_out,
                            const float* __restrict__ b_out,
                            const float* __restrict__ u, Consts c, int B,
                            float* __restrict__ loss, float* __restrict__ G,
                            size_t ss, size_t ps, size_t ls) {
  constexpr int R = S::R;
  __shared__ float partial[kLossThreads / 32];
  const size_t so = blockIdx.x * ss, po = blockIdx.x * ps;
  a += so;
  G += so;
  w_out += po;
  b_out += po;
  loss += blockIdx.x * ls;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const float inv_b = 1.0f / static_cast<float>(B);
  const float bo = b_out[0];
  float sum = 0.0f;
  for (int row = warp; row < B; row += n_warps) {
    float out[R], g[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float* ar = a + static_cast<size_t>(s * B + row) * h;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = lane; k < h; k += 32) acc = fmaf(ar[k], w_out[k], acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      out[s] = kind_of<S>(s) == kValue ? acc + bo : acc;
    }
    const float point =
        S::loss(u + static_cast<size_t>(row) * S::U, c, out, g);
    if (lane == 0) {
      sum += point;
#pragma unroll
      for (int s = 0; s < R; ++s) G[s * B + row] = g[s] * inv_b;
    }
  }
  if (lane == 0) partial[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < n_warps; ++i) total += partial[i];
    *loss = total * inv_b;
  }
}

// The partial sums of stream s, written at dw + s * n, db + s * n
// (n = one flat parameter buffer): dw[k, j] = sum of a[r, k] dz[r, j] and
// db[j] = sum of dz[r, j] over the stream's B rows in order (db is 0 for
// tangent streams, which carry no bias: bit s of value_mask is clear).
// Block (32, 8) owns a 32 x 32 tile of dw; blocks with blockIdx.y == 0
// also produce db for their columns. blockIdx.z = r·R + s: replica r's
// operands and partials at r·ss.
__global__ void bwd_weight_kernel(const float* __restrict__ a, int k_in,
                                  const float* __restrict__ dz, int k_out,
                                  int B, int n, int R, unsigned value_mask,
                                  float* __restrict__ dw,
                                  float* __restrict__ db, size_t ss) {
  __shared__ float a_s[kTile][kTile + 1];
  __shared__ float d_s[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kTile + tx;
  const int k0 = blockIdx.y * kTile;
  const int stream = blockIdx.z % R;
  const size_t so = (blockIdx.z / R) * ss;
  const int end = (stream + 1) * B;
  const bool bias = blockIdx.y == 0 && ty == 0;
  const bool value = (value_mask >> stream) & 1u;
  a += so;
  dz += so;
  dw += so + static_cast<size_t>(stream) * n;
  db += so + static_cast<size_t>(stream) * n;
  float acc[kTile / 8] = {};
  float bacc = 0.0f;
  for (int r0 = stream * B; r0 < end; r0 += kTile) {
    for (int rr = ty; rr < kTile; rr += 8) {
      const int r = r0 + rr;
      a_s[rr][tx] = (r < end && k0 + tx < k_in)
                        ? a[static_cast<size_t>(r) * k_in + k0 + tx]
                        : 0.0f;
      d_s[rr][tx] =
          (r < end && j < k_out) ? dz[static_cast<size_t>(r) * k_out + j] : 0.0f;
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
  if (j >= k_out) return;
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) {
    const int k = k0 + ty + 8 * i;
    if (k < k_in) dw[static_cast<size_t>(k) * k_out + j] = acc[i];
  }
  if (bias) db[j] = value ? bacc : 0.0f;
}

// g = dz @ w^T for the R streams of batch row blockIdx.x, then the VJP of
// the Taylor rules at the previous layer (fused_engine._act_bwd): per group
// with a0 = tanh(z0), d = 1 - a0^2, d' = -2 a0 d,
//   dz0 = d g0 + d' sum(z_t g_t over the tangents)
//              - sum over pairs of 2 z1^2 d (d - 2 a0^2) g2
//   dz1 = d g1 - 4 a0 d z1 g2 (pair firsts),  dz2 = d g2 (pair seconds),
//   dzf = d gf (first-only tangents).
// Block (32, kSplitWarps): w is staged in shared memory with rows padded by
// one float; warp y sums its own slice of the j range, and the slices'
// partial sums are added in warp order through shared memory. Replica
// blockIdx.z stages its own weight (at z·ps); its streams are at z·ss.
template <class S>
__global__ void bwd_data_kernel(const float* __restrict__ dz, int k_out,
                                const float* __restrict__ w, int k_in,
                                const float* __restrict__ z_prev,
                                const float* __restrict__ a_prev, int B,
                                float* __restrict__ dz_prev, size_t ss,
                                size_t ps) {
  constexpr int R = S::R;
  extern __shared__ float smem[];
  const size_t so = blockIdx.z * ss;
  dz += so;
  z_prev += so;
  a_prev += so;
  dz_prev += so;
  w += blockIdx.z * ps;
  const int ldw = k_out + 1;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int row = blockIdx.x;
  float* w_s = smem;                  // [k_in][k_out + 1]
  float* d_s = w_s + k_in * ldw;      // [R][k_out]
  float* part_s = d_s + R * k_out;    // [kSplitWarps][R][kColsPerWarp]
  dednn::stage(w_s, ldw, w, k_out, k_in, k_out);
  for (int i = tid; i < R * k_out; i += 32 * kSplitWarps) {
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
    for (int cc = 0; cc < kColsPerLane; ++cc)
      kk[cc] = min(k0 + lane + 32 * cc, k_in - 1);
    float g[R][kColsPerLane] = {};
    for (int j = j_begin; j < j_end; ++j) {
      float wk[kColsPerLane];
#pragma unroll
      for (int cc = 0; cc < kColsPerLane; ++cc) wk[cc] = w_s[kk[cc] * ldw + j];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const float d = d_s[s * k_out + j];
#pragma unroll
        for (int cc = 0; cc < kColsPerLane; ++cc)
          g[s][cc] = fmaf(d, wk[cc], g[s][cc]);
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int cc = 0; cc < kColsPerLane; ++cc)
        part_s[(warp * R + s) * kColsPerWarp + lane + 32 * cc] = g[s][cc];
    __syncthreads();

    for (int kl = tid; kl < kColsPerWarp; kl += 32 * kSplitWarps) {
      const int k = k0 + kl;
      if (k >= k_in) break;
      const size_t at = static_cast<size_t>(row) * k_in + k;
      float gs[R], a0[R], d[R], dzs[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        float sum = part_s[s * kColsPerWarp + kl];
        for (int p = 1; p < kSplitWarps; ++p)
          sum += part_s[(p * R + s) * kColsPerWarp + kl];
        gs[s] = sum;
      }
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int v = value_of<S>(s);
        const unsigned kind = kind_of<S>(s);
        if (kind == kValue) {
          a0[s] = a_prev[at + s * stride];
          d[s] = 1.0f - a0[s] * a0[s];
          dzs[s] = d[s] * gs[s];
        } else if (kind == kPairSecond) {  // closes the pair (s - 1, s)
          const int f = s > 0 ? s - 1 : 0;
          const float z1 = z_prev[at + f * stride];
          const float z2 = z_prev[at + s * stride];
          const float dp = -2.0f * a0[v] * d[v];
          dzs[v] = dzs[v] + dp * (z1 * gs[f] + z2 * gs[s]) -
                   2.0f * (z1 * z1) * d[v] * (d[v] - 2.0f * a0[v] * a0[v]) *
                       gs[s];
          dzs[f] = d[v] * gs[f] - 4.0f * a0[v] * d[v] * z1 * gs[s];
          dzs[s] = d[v] * gs[s];
        } else if (kind == kFirst) {
          const float zf = z_prev[at + s * stride];
          const float dp = -2.0f * a0[v] * d[v];
          dzs[v] = dzs[v] + dp * (zf * gs[s]);
          dzs[s] = d[v] * gs[s];
        }
      }
#pragma unroll
      for (int s = 0; s < R; ++s) dz_prev[at + s * stride] = dzs[s];
    }
    __syncthreads();  // part_s is rewritten for the next k0
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

size_t fwd_smem(int R, int k_in) {
  return static_cast<size_t>(R) * (k_in + kSplitWarps * kColsPerWarp) *
         sizeof(float);
}

size_t bwd_data_smem(int R, int k_in, int k_out) {
  return (static_cast<size_t>(k_in) * (k_out + 1) +
          static_cast<size_t>(R) * (k_out + kSplitWarps * kColsPerWarp)) *
         sizeof(float);
}

int n_params(int D, int H, int L) {
  return D * H + H + L * H * H + L * H + H + 1;
}

template <class S>
size_t scratch_floats(int B, int H, int L) {
  const size_t rows = static_cast<size_t>(S::R) * B;
  return rows * S::D + 3 * static_cast<size_t>(L + 1) * rows * H + rows +
         static_cast<size_t>(S::R) * n_params(S::D, H, L);
}

// The per-stream gradient partials [R][n] at the end of scratch.
template <class S>
float* partials_of(float* scratch, int B, int H, int L) {
  return scratch + scratch_floats<S>(B, H, L) -
         static_cast<size_t>(S::R) * n_params(S::D, H, L);
}

template <class S>
cudaError_t prepare(int H) {
  cudaError_t err =
      dednn::allow_smem(bwd_data_kernel<S>, bwd_data_smem(S::R, H, H));
  if (err != cudaSuccess) return err;
  return dednn::allow_smem(fwd_layer_kernel<S>, fwd_smem(S::R, H));
}

// Enqueue one step's forward and backward: loss -> *loss, the gradient's
// per-stream partials -> partials_of(scratch) (each in the flat layout of
// p). scratch holds scratch_floats<S>(B, H, L) per replica. For N
// replicas, replica r's parameters are at p + r·n, its scratch at
// scratch + r·scratch_floats, and its loss at loss + r·ls; every launch
// covers all N.
template <class S>
cudaError_t grad_step(const float* p, const float* u, const Consts& c,
                      float* scratch, float* loss, int N, size_t ls, int B,
                      int H, int L, cudaStream_t stream) {
  constexpr int R = S::R, D = S::D;
  const size_t rows = static_cast<size_t>(R) * B;
  const size_t layer = rows * H;
  const int n = n_params(D, H, L);
  const size_t ss = scratch_floats<S>(B, H, L);
  float* X = scratch;                // [R·B, D]
  float* Z = X + rows * D;           // [L + 1][R·B, H] pre-activations
  float* A = Z + (L + 1) * layer;    // [L + 1][R·B, H] activations
  float* G = A + (L + 1) * layer;    // [R·B] output gradient
  float* DZ = G + rows;              // [L + 1][R·B, H] gradients w.r.t. Z
  float* grad = partials_of<S>(scratch, B, H, L);

  const float* w_in = p;
  const float* b_in = w_in + D * H;
  const float* w_hid = b_in + H;
  const float* b_hid = w_hid + static_cast<size_t>(L) * H * H;
  const float* w_out = b_hid + static_cast<size_t>(L) * H;
  const float* b_out = w_out + H;
  float* gw_in = grad;
  float* gb_in = gw_in + D * H;
  float* gw_hid = gb_in + H;
  float* gb_hid = gw_hid + static_cast<size_t>(L) * H * H;
  float* gw_out = gb_hid + static_cast<size_t>(L) * H;
  float* gb_out = gw_out + H;

  const dim3 split(32, kSplitWarps);
  const dim3 fwd_grid(B, dednn::ceil_div(H, kColsPerWarp), N);
  fwd_layer_kernel<S><<<fwd_grid, split, fwd_smem(R, D), stream>>>(
      nullptr, D, u, c, X, w_in, b_in, H, B, Z, A, ss, n);
  for (int l = 1; l <= L; ++l) {
    fwd_layer_kernel<S><<<fwd_grid, split, fwd_smem(R, H), stream>>>(
        A + (l - 1) * layer, H, nullptr, c, nullptr,
        w_hid + static_cast<size_t>(l - 1) * H * H, b_hid + (l - 1) * H, H, B,
        Z + l * layer, A + l * layer, ss, n);
  }
  loss_kernel<S><<<N, kLossThreads, 0, stream>>>(
      A + L * layer, H, w_out, b_out, u, c, B, loss, G, ss, n, ls);

  const dim3 tile(32, 8);
  const dim3 data_grid(B, 1, N);
  bwd_weight_kernel<<<dim3(1, dednn::ceil_div(H, kTile), N * R), tile, 0,
                      stream>>>(A + L * layer, H, G, 1, B, n, R,
                                S::kValueMask, gw_out, gb_out, ss);
  bwd_data_kernel<S><<<data_grid, split, bwd_data_smem(R, H, 1), stream>>>(
      G, 1, w_out, H, Z + L * layer, A + L * layer, B, DZ + L * layer, ss, n);
  for (int l = L; l >= 1; --l) {
    const dim3 grid(dednn::ceil_div(H, kTile), dednn::ceil_div(H, kTile),
                    N * R);
    bwd_weight_kernel<<<grid, tile, 0, stream>>>(
        A + (l - 1) * layer, H, DZ + l * layer, H, B, n, R, S::kValueMask,
        gw_hid + static_cast<size_t>(l - 1) * H * H, gb_hid + (l - 1) * H,
        ss);
    bwd_data_kernel<S><<<data_grid, split, bwd_data_smem(R, H, H), stream>>>(
        DZ + l * layer, H, w_hid + static_cast<size_t>(l - 1) * H * H, H,
        Z + (l - 1) * layer, A + (l - 1) * layer, B, DZ + (l - 1) * layer, ss,
        n);
  }
  bwd_weight_kernel<<<dim3(dednn::ceil_div(H, kTile), dednn::ceil_div(D, kTile),
                           N * R),
                      tile, 0, stream>>>(X, D, DZ, H, B, n, R, S::kValueMask,
                                         gw_in, gb_in, ss);
  return cudaGetLastError();
}

template <class S>
int grad_impl(const Consts& c, const float* p, const float* u, float* scratch,
              float* grad, float* loss, int B, int H, int L,
              cudaStream_t stream) {
  cudaError_t err = prepare<S>(H);
  if (err != cudaSuccess) return err;
  err = grad_step<S>(p, u, c, scratch, loss, 1, 0, B, H, L, stream);
  if (err != cudaSuccess) return err;
  const int n = n_params(S::D, H, L);
  sum_partials_kernel<<<dednn::ceil_div(n, kAdamThreads), kAdamThreads, 0,
                        stream>>>(partials_of<S>(scratch, B, H, L), S::R, n,
                                  grad);
  return cudaGetLastError();
}

// K Adam steps of N replicas, one launch sequence per step for all of
// them; *step_math_runs counts the replica-steps whose step math was
// enqueued.
template <class S>
int train_impl(const Consts& c, float* p, float* m, float* v, const float* u,
               float* scratch, float* losses, int N, int K, int B, int H,
               int L, float lr, int step0, const Schedule& sched,
               int* step_math_runs, cudaStream_t stream) {
  if (N < 1 || N > dednn::kMaxGridYZ / S::R) return cudaErrorInvalidValue;
  cudaError_t err = prepare<S>(H);
  if (err != cudaSuccess) return err;
  const int n = n_params(S::D, H, L);
  const float* partials = partials_of<S>(scratch, B, H, L);
  const dim3 adam_grid(dednn::ceil_div(n, kAdamThreads), N);
  for (int k = 0; k < K; ++k) {
    err = grad_step<S>(p, u + static_cast<size_t>(k) * B * S::U, c, scratch,
                       losses + k, N, K, B, H, L, stream);
    if (err != cudaSuccess) return err;
    *step_math_runs += N;
    adam_kernel<<<adam_grid, kAdamThreads, 0, stream>>>(
        p, m, v, partials, S::R, n, scratch_floats<S>(B, H, L), lr,
        static_cast<float>(step0 + k + 1), sched);
  }
  return cudaGetLastError();
}

// Calls f(S{}) with the spec struct of fused_engine.<Spec>.kernel_id;
// -1 for an unknown id.
template <class F>
auto dispatch(int spec, F&& f) -> decltype(f(Heat{})) {
  switch (spec) {
    case 0: return f(SimpleOde{});
    case 1: return f(Heat{});
    case 2: return f(Burgers{});
    case 3: return f(Wave{});
    case 4: return f(Advection{});
    case 5: return f(Poisson{});
    case 6: return f(Heat2D{});
    default: return -1;
  }
}

Consts load_consts(const float* consts) {
  Consts c;
  for (int i = 0; i < kMaxConsts; ++i) c.c[i] = consts[i];
  return c;
}

}  // namespace

// Floats of scratch one call needs, or -1 for an unknown spec.
extern "C" long long engine_scratch_floats(int spec, int B, int H, int L) {
  return dispatch(spec, [&](auto s) -> long long {
    return static_cast<long long>(scratch_floats<decltype(s)>(B, H, L));
  });
}

// Bytes of dynamic shared memory per block that the largest layer kernel
// of a call at hidden width H takes (bwd_data's staged H×H weight beside
// the streams' gradients and partial sums); -1 for an unknown spec.
extern "C" long long engine_smem_bytes(int spec, int H) {
  return dispatch(spec, [&](auto s) -> long long {
    constexpr int R = decltype(s)::R;
    return static_cast<long long>(
        std::max(bwd_data_smem(R, H, H), fwd_smem(R, H)));
  });
}

// One step's loss and flat gradient (kernel #6 alone). consts: the spec's
// kMaxConsts numbers, in host memory.
extern "C" int engine_grad(int spec, const float* consts, const float* p,
                           const float* u, float* scratch, float* grad,
                           float* loss, int B, int H, int L, void* stream) {
  const Consts c = load_consts(consts);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int code = dispatch(spec, [&](auto s) {
    return grad_impl<decltype(s)>(c, p, u, scratch, grad, loss, B, H, L, st);
  });
  return code < 0 ? cudaErrorInvalidValue : code;
}

// K Adam steps of N packed replicas (kernel #5 around #6): p, m, v [N, n]
// updated in place, losses [N, K], scratch N·engine_scratch_floats; the
// uniforms [K, B, U] and the schedule are shared. *step_math_runs (host
// memory) is set to the number of replica-steps whose step math was
// enqueued. N·R above the grid's 65 535 is refused.
extern "C" int engine_train_packed(int spec, const float* consts, float* p,
                                   float* m, float* v, const float* u,
                                   float* scratch, float* losses, int N, int K,
                                   int B, int H, int L, float lr, int step0,
                                   int schedule, float horizon, float decay,
                                   float half_span, float log_decay,
                                   int* step_math_runs, void* stream) {
  const Consts c = load_consts(consts);
  const Schedule sched{schedule, horizon, decay, half_span, log_decay};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *step_math_runs = 0;
  const int code = dispatch(spec, [&](auto s) {
    return train_impl<decltype(s)>(c, p, m, v, u, scratch, losses, N, K, B, H,
                                   L, lr, step0, sched, step_math_runs, st);
  });
  return code < 0 ? cudaErrorInvalidValue : code;
}
