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
// phases of a few thousand to a few tens of thousands of outputs each.
// Each phase's latency, how well its blocks fill the 132 SMs, and the gaps
// between launches are the limit, not the fp32 pipes or HBM.
//
// What the design does about it (the DGM engine's, csrc/dgm_train.cu, whose
// shared pieces are in fused_step.cuh; the layer kernel and the tile plans,
// shared with the heat kernel, are in stream_layer.cuh):
//   * The products are register-blocked fp32 FFMA (TM × TN outputs per
//     thread) over a tile of batch points × all R streams × a column tile,
//     so the tile holds every stream of its batch points: the Taylor rules
//     of tanh (forward) and their VJP (backward) run on it in the same
//     kernel, one thread per (batch point, column) reading its R streams'
//     sums from shared memory. k-tiles of the operand rows and of the
//     weight are staged by cp.async (16 bytes per copy where the block's
//     operands are aligned) into a ring of buffers: shared memory per block
//     depends on the tile and R, not on H.
//   * The loss kernel spreads the output layer's dot products, the spec's
//     point loss and the output layer's data gradient over the batch, one
//     warp per batch point; a one-warp kernel on a side branch sums the
//     point losses.
//   * weight_grad_kernel (fused_step.cuh) sums all R streams of its tile in
//     one block, one thread group per stream, and applies Adam in its
//     epilogue, so no per-stream partials are written. The weight gradients
//     run side by side on three lanes (two side streams and the data path's
//     own) once every layer's data gradient has read its weight.
//   * dednn::capture_steps records GRAPH_STEPS steps as one CUDA graph that
//     engine_train_packed replays; per-call values (p, m, v, the uniforms,
//     the losses, lr, the schedule) come from a device argument block
//     written by one copy per call. The spec's numbers are kernel arguments,
//     as in the first design (the wrapper keys its graphs by them).
//
// One step's launches (L hidden layers):
//   input      x 1      the spec's rows X from the uniforms (one thread per
//                       batch point), the first layer and its Taylor rules
//   layer      x L      hidden layers forward: z = a·W + mask·b, tanh rules
//   loss       x 1      output layer, the spec's loss and cotangent G, the
//                       point losses, and the output layer's data gradient
//                       through the tanh VJP at layer L (a folded spec:
//                       fold_loss, one block per batch point; causal
//                       advection: causal_loss, one block per replica)
//   layer      x L      hidden layers backward: g = dz·Wᵀ, the tanh VJP
//   loss_sum   x 1      loss = the point losses' batch mean (a side lane);
//                       the extra scalar's gradient and Adam step
//   weight     x L + 2  dW = Aᵀ·dz and db over all streams; Adam in training
//                       (three lanes)
// Every reduction runs in the order of the engine's first design: each
// product output is the sum, in slice order, of 8 k-slices of ⌈K/8⌉, each
// an fmaf chain from 0 (a tile folds its running sum at each slice
// boundary), then the bias; each loss dot product lane-strided fmaf chains
// and a butterfly shuffle; the batch loss warp w's rows w, w + 32, ... in
// row order, then the warps in order; each weight gradient the sum in
// stream order of per-stream fmaf chains over the stream's B rows in
// order. So runs are bit-identical, a chunk cut anywhere equals the uncut
// run, and the outputs equal the first design's. Every product of the
// "highest" instances is fp32 FFMA: exact fp32, no tensor cores.
//
// At the "default" precision (bf16 != 0 at the entry points) every launch
// is its kBf16 instance: the layer products and the weight gradients on the
// tensor cores (mma_bf16.cuh: bf16 operands, fp32 accumulation, in a fixed
// order, so runs stay bit-identical and chunk-invariant), and the small
// products of the input and loss kernels (X·w_in, a_L·w_out, G·w_outᵀ) on
// operands rounded to bf16 as they load, as the JAX step math gives each of
// those products its precision. The Taylor rules, the spec's loss (its
// own products, such as volterra's node sums and inverse_heat's observation
// rows, which the JAX step math pins to HIGHEST), the bias sums and Adam
// stay fp32. The "default" instances of every spec double the templates
// to build, so they build in a translation unit of their own,
// engine_train_bf16.cu (this source with DEDNN_ENGINE_BF16 = 1), beside
// this one: the entry points here call its engine_*_bf16 for bf16 != 0.
//
// Packed replicas (kernel #5, engine_core.py::fused_packed_adam_kernel,
// reached through run_fused_packed): engine_train_packed advances N
// independent runs that share the uniforms and the lr schedule. p, m and
// v are [N, n] replica-major, each replica has its own scratch (stride
// scratch_floats), and the loss history is [N, K]. A step is the same
// launch sequence as one run's, each launch with N times the blocks: the
// replica is the grid's z index (y for the loss kernels). Every kernel moves
// its pointers to its replica's copy and then runs the single-replica code,
// so replica r of a packed call equals a one-replica call on r's state bit
// for bit. A single run (fused_engine_chunk) is the packed call at N = 1.
//
// Row layout of every [R·B, width] activation: stream s, batch row b at row
// s·B + b, streams in fused_engine.Group order (per group: value, then the
// (first, second) Taylor pairs, then the first-only tangents).
//
// The sweep mode (engine_core.py:60-64, :97-105, :140-143, :157-162 and
// :233-237 of the JAX package; fused_step.cuh's StepArgs): replica r's
// batch bs[r] scales each row past it by 0 in the loss kernels, which scale
// by 1/bs[r] where they scaled by 1/B (uat's grid spans the bs rows; causal
// advection takes its plain loss under a mask, as the JAX spec does); a
// replica past its step budget returns at the entry of each of its blocks;
// its Adam takes its own lr and, with a trial horizon, its budget as the
// decay's horizon. The values ride the argument block, so one graph serves
// every trial; outside the mode its pointers are null and every output is
// the same bit for bit.
//
// Beyond the MLP layout of the first specs (fused_engine.py:797-1016 of the
// JAX package: VolterraSpec, UATSpec, InverseHeatSpec):
//   * The const operand (engine_core.py:67-69, :94): one device buffer per
//     call, shared by every replica, reached through StepArgs::cnst (so a
//     replayed graph reads the call's buffer, never a captured one).
//     Volterra's node fractions and weights and inverse_heat's observation
//     table ride it; inverse_heat picks its rows by a gather where the TPU
//     kernel multiplied by a one-hot matrix (the same values: the product
//     is exact).
//   * A folded spec (volterra: 1 + k value-only groups, 51 at k = 50) runs
//     as one value stream of (1 + k)·B rows, so its layer kernels are the
//     R = 1 instances whatever k is; its weight gradients take the groups
//     kFoldGroups at a time, one thread group each (a block walking all
//     (1 + k)·B rows in order took 7× longer on the H100); its loss kernel
//     (fold_loss_kernel) sums each point's quadrature in node order where
//     the TPU kernel multiplied by a host-built selection matrix.
//   * L = 0 (uat's Perceptron, _engine_dims): input, loss, and the input
//     and output layers' weight gradients; the flat state carries no
//     hidden tensors. H = 3 stages its rows by 4-byte copies.
//   * An extra trainable scalar after the MLP's tensors (inverse_heat's
//     log κ̂, extra_shapes): the loss kernel writes each point's gradient
//     beside its point loss, and loss_sum_kernel sums both in the same fixed
//     order and applies Adam to it in the same launch.
//
// Causal advection (fused_engine.py:407-475 of the JAX package,
// AdvectionSpec at causal_eps > 0; kernel id 15) is the one spec whose loss
// couples the batch: each point's interior residual energy r_i is weighted
// by w_i = exp(−ε·Δt·Σ_{t_j < t_i} r_j), the TPU kernel's [B, B]
// comparison-mask product. loss_kernel gives each point its own warp, so
// the spec takes causal_loss_kernel instead: one block per replica holds
// every point's residuals and t in shared memory (six floats a point, so
// a batch of at most kCausalMaxBatch), forms each w_i by B strict
// comparisons (equal t do not count, as in JAX: fp32 can round two
// adjacent strata's t to one value), then writes the point losses, the
// cotangents (the interior's scaled by w_i) and the output layer's data
// gradient as loss_kernel does. B² comparisons at B = 128 are 16 K a step.
// Its build puts row b in stratum (b·m) mod B in integers, where the TPU
// kernel computed the same values in fp32 with a floor (exact below 2^24).
// The layer, loss-sum and weight-gradient kernels, the packed launch and
// the graph replay take it unchanged.
//
// The hard-constraint specs (fused_engine.py:611-796 of the JAX package:
// HardSimpleODESpec, HardHeatSpec, HardHeat2DSpec, HardWaveSpec,
// HardPoissonSpec) are stream layouts like the soft ones, of 2 to 6
// interior streams: only their build and loss are their own (the spec
// structs HardSimpleOde ... HardPoisson); the layer, loss-sum and
// weight-gradient kernels, the packed launch and the graph replay take
// them unchanged.
#include <algorithm>
#include <cmath>

// 1 where engine_train_bf16.cu includes this source: that translation unit
// holds the "default" precision's instances and entry points, this one the
// "highest" ones and every other entry point.
#ifndef DEDNN_ENGINE_BF16
#define DEDNN_ENGINE_BF16 0
#endif

#include "common.cuh"
#include "fused_step.cuh"
#include "stream_layer.cuh"

namespace {

using dednn::Consts;
using dednn::kMaxConsts;
using dednn::kSlices;
using dednn::Layout;
using dednn::Schedule;
using dednn::StepArgs;
using dednn::Streams;
using dednn::write_args;

constexpr int kInputBB = 4;     // input kernel: batch points per block
constexpr int kInputBN = 32;    //   and columns
constexpr int kLossWarps = 4;   // loss kernel: batch points (warps) per block
constexpr int kLossLanes = 32;  // the batch loss: 32 lane sums in order
constexpr int kFoldWarps = 8;   // fold_loss_kernel: warps per batch point
// The most groups a spec may fold: fold_loss_kernel keeps a point's F
// outputs in the 48 KB of shared memory a block takes by default.
constexpr int kMaxFold = 48 * 1024 / 4;
constexpr int kFoldGroups = 8;  // a folded spec's weight gradients: groups
// causal_loss_kernel: threads of the one block per replica, and the batch
// its six floats a point hold in the 48 KB of shared memory a block takes
// by default (fused_engine.CAUSAL_MAX_BATCH).
constexpr int kCausalThreads = 512;
constexpr int kCausalFloats = 6;
constexpr int kCausalMaxBatch = 48 * 1024 / (4 * kCausalFloats);

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
// writes g[s] = d(point loss)/d(out_s), and for a spec with an extra
// trainable scalar (kExtra) g[R] = d(point loss)/d(extra); the kernels
// scale by 1/B (the batch mean, fused_engine._smean). Constants are fp32
// (kernel_consts).
// ---------------------------------------------------------------------------

// What a spec's build and loss read of one batch point: its draws u, its
// index b in the batch of B (in a folded spec's input kernel, b is the row
// of the F·B value rows), the call's const operand, the replica's extra
// trainable tensors (after the MLP's six), and in the sweep mode its masked
// batch.
struct Point {
  const float* u;
  int b, B;
  const float* cnst;
  const float* extras;
  int live = 0;  // the masked batch bs (0: unmasked), for uat's grid
};

// A spec's defaults: no extra trainable tensor, groups not folded. A
// folded spec (kFolded: every group a value row, volterra's 1 + k) lays
// its F groups out as one value stream of F·B rows (row s·B + b, the
// engine's usual layout), so its layer kernels run at R = 1 whatever F is
// (its weight gradients see the F groups of B rows: wg_groups); its loss is
// fold_loss over a point's F outputs.
struct SpecBase {
  static constexpr int kExtra = 0;
  static constexpr bool kFolded = false;
  static constexpr bool kCausal = false;  // a cross-point loss
};

// dy/dt = -y, y(0) = y_ic. c: sample_scale·t_max, y_ic.
struct SimpleOde : SpecBase {
  static constexpr int R = 3, D = 1, U = 1;
  DEDNN_LAYOUT(kValue, kFirst, kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    X[0] = c.c[0] * u[0];  // t
    X[1] = 1.0f;           // t-tangent
    X[2] = 0.0f;           // t = 0
  }
  __device__ static float loss(const Point&, const Consts& c,
                               const float* o, float* g) {
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
struct Heat : SpecBase {
  static constexpr int R = 7, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst, kValue, kValue,
               kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    build_xt7(u, c, X);
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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
struct Burgers : SpecBase {
  static constexpr int R = 7, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst, kValue, kValue,
               kValue)
  __device__ static float exact(const Consts& c, float x, float t) {
    return c.c[4] - c.c[3] * tanhf(c.c[3] * (x - c.c[4] * t - c.c[5]) / c.c[6]);
  }
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    build_xt7(u, c, X);
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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
struct Wave : SpecBase {
  static constexpr int R = 9, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kValue, kFirst, kValue, kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float rows[18] = {x,    t,    1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 1.0f, 0.0f, 0.0f, x,    0.0f,
                            0.0f, 1.0f, 0.0f, t,    c.c[0], t};
    for (int i = 0; i < 18; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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
struct Advection : SpecBase {
  static constexpr int R = 5, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kFirst, kFirst, kValue, kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    const float x = c.c[0] * u[0], t = c.c[1] * u[1];
    const float rows[10] = {x, t, 1.0f, 0.0f, 0.0f, 1.0f, x, 0.0f, 0.0f, t};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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

// Advection with causal weighting (kCausal: causal_loss_kernel). Row b's t
// lies in stratum (b·m) mod B: t = (stratum + u_1)·t_max/B. c: x_max,
// t_max, c, -c, eps, t_max/B, m.
struct CausalAdvection : SpecBase {
  static constexpr int R = 5, D = 2, U = 2;
  static constexpr bool kCausal = true;
  DEDNN_LAYOUT(kValue, kFirst, kFirst, kValue, kValue)
  __device__ static float time(const Point& pt, const Consts& c) {
    const long long m = static_cast<long long>(c.c[6]);
    const int stratum = static_cast<int>((pt.b * m) % pt.B);
    return (static_cast<float>(stratum) + pt.u[1]) * c.c[5];
  }
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float x = c.c[0] * pt.u[0], t = time(pt, c);
    const float rows[10] = {x, t, 1.0f, 0.0f, 0.0f, 1.0f, x, 0.0f, 0.0f, t};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  // The point's residuals e = (interior q, IC r0, inflow rb) and its t.
  __device__ static void residuals(const Point& pt, const Consts& c,
                                   const float* o, float* e, float* t) {
    *t = time(pt, c);
    e[0] = o[2] + c.c[2] * o[1];
    e[1] = o[3] - sinf(c.c[0] * pt.u[0]);
    e[2] = o[4] - sinf(c.c[3] * *t);
  }
  // The point loss w·q² + r0² + rb² and its cotangents at weight w.
  __device__ static float weighted_loss(const Consts& c, const float* e,
                                        float w, float* g) {
    const float q = e[0], r0 = e[1], rb = e[2];
    g[0] = 0.0f;
    g[1] = 2.0f * c.c[2] * q * w;
    g[2] = 2.0f * q * w;
    g[3] = 2.0f * r0;
    g[4] = 2.0f * rb;
    return w * (q * q) + (r0 * r0 + rb * rb);
  }
};

// -(u_xx + u_yy) = 2 sin x sin y, u = 0 on the four faces. c: x_max.
struct Poisson : SpecBase {
  static constexpr int R = 9, D = 2, U = 3;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kValue, kValue, kValue, kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
    const float xm = c.c[0];
    const float x = xm * u[0], y = xm * u[1], e = xm * u[2];
    const float rows[18] = {x,    y,    1.0f, 0.0f, 0.0f, 0.0f,
                            0.0f, 1.0f, 0.0f, 0.0f, 0.0f, e,
                            xm,   e,    e,    0.0f, e,    xm};
    for (int i = 0; i < 18; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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
struct Heat2D : SpecBase {
  static constexpr int R = 11, D = 3, U = 4;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kFirst, kValue, kValue, kValue, kValue, kValue)
  __device__ static void build(const Point& pt, const Consts& c,
                                float* X) {
    const float* u = pt.u;
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
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float* u = pt.u;
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

// y(x) = x + ∫₀ˣ (t − x)·y(t) dt by the k-node Gauss rule rescaled to (0, x):
// F = 1 + k value groups folded into one stream, group 0 at x, group 1 + j
// at x·c_j. The const operand is [k, 2]: c_j and (c_j − 1)·w_j. c: upper.
struct Volterra : SpecBase {
  static constexpr int R = 1, D = 1, U = 1;
  static constexpr bool kFolded = true;
  DEDNN_LAYOUT(kValue)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const int s = pt.b / pt.B;
    const float x = c.c[0] * pt.u[0];
    X[0] = s == 0 ? x : x * pt.cnst[2 * (s - 1)];
  }
  // The point loss r² from its F outputs o, r = y(x) − x − x²·Σ_j
  // (c_j − 1)·w_j·y(x·c_j) (the sum in node order); *g0 = 2r is the
  // cotangent of o[0], and o[1 + j]'s is *q times (c_j − 1)·w_j.
  __device__ static float fold_loss(const Point& pt, const Consts& c,
                                    const float* o, int F, float* g0,
                                    float* q) {
    const float x = c.c[0] * pt.u[0];
    float acc = 0.0f;
    for (int j = 0; j + 1 < F; ++j) acc = fmaf(pt.cnst[2 * j + 1], o[1 + j], acc);
    const float r = o[0] - x - (x * x) * acc;
    *g0 = 2.0f * r;
    *q = -2.0f * r * (x * x);
    return r * r;
  }
  __device__ static float fold_coef(const Point& pt, int s) {
    return pt.cnst[2 * (s - 1) + 1];
  }
};

// Full-batch fit of sin(freq·x) on the B-point grid x_b = low + (high −
// low)·b/(B − 1) (the draws are not read); under a batch mask bs the grid
// spans the bs live rows, b/(bs − 1) (the JAX kernel spans the tile). c:
// low, high − low, freq.
struct Uat : SpecBase {
  static constexpr int R = 1, D = 1, U = 1;
  DEDNN_LAYOUT(kValue)
  __device__ static float grid(const Point& pt, const Consts& c) {
    const float i = static_cast<float>(pt.b);
    const int n = pt.live > 0 ? pt.live : pt.B;
    return c.c[0] + (c.c[1] * i) / static_cast<float>(max(n - 1, 1));
  }
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    X[0] = grid(pt, c);
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float r = o[0] - sinf(c.c[2] * grid(pt, c));
    g[0] = 2.0f * r;
    return r * r;
  }
};

// u_t = κ̂ u_xx with log κ̂ trained beside the net (kExtra), and a data term
// on the observation row floor(u_2·n_obs) of the const [n_obs, 3] (x, t,
// u_obs; a row past the table, which fp32 rounding can give, is zeros).
// c: x_max, t_max, data weight, n_obs.
struct InverseHeat : SpecBase {
  static constexpr int R = 5, D = 2, U = 3;
  static constexpr int kExtra = 1;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst, kValue)
  __device__ static const float* obs(const Point& pt, const Consts& c) {
    const float sel = floorf(pt.u[2] * c.c[3]);
    return sel < c.c[3] ? pt.cnst + 3 * static_cast<int>(sel) : nullptr;
  }
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float x = c.c[0] * pt.u[0], t = c.c[1] * pt.u[1];
    const float* row = obs(pt, c);
    const float rows[10] = {x,    t,    1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f,
                            row ? row[0] : 0.0f, row ? row[1] : 0.0f};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float kappa = expf(pt.extras[0]);
    const float* row = obs(pt, c);
    const float r = o[3] - kappa * o[2];
    const float d = o[4] - (row ? row[2] : 0.0f);
    g[0] = 0.0f;
    g[1] = 0.0f;
    g[2] = -2.0f * kappa * r;
    g[3] = 2.0f * r;
    g[4] = 2.0f * c.c[2] * d;
    g[R] = -2.0f * r * (kappa * o[2]);  // d/d log κ̂: dr = −κ̂·u_xx
    return r * r + c.c[2] * (d * d);
  }
};

// ---------------------------------------------------------------------------
// Hard-constraint specs (models/hard.py; fused_engine.HARD_SPECS, kernel
// ids 10-14): the raw net N of the trial function u = A + Dv·N, interior
// streams only, since A and Dv hold the IC and BC exactly. The loss
// composes the analytic derivatives of A and Dv with N's streams, so the
// value stream's cotangent is not zero (N enters through Dv's
// derivatives). x and t come from the point's draws as the soft specs take
// them; scale, Dv's normalisation, is the spec's last number (computed in
// double on the host).
// ---------------------------------------------------------------------------

// y = y_ic + s·N with s = t/t_max; residual y' + y, y' = N/t_max + s·N_t.
// c: sample_scale·t_max, t_max, y_ic.
struct HardSimpleOde : SpecBase {
  static constexpr int R = 2, D = 1, U = 1;
  DEDNN_LAYOUT(kValue, kFirst)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    X[0] = c.c[0] * pt.u[0];  // t
    X[1] = 1.0f;              // t-tangent
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float t = c.c[0] * pt.u[0];
    const float s = t / c.c[1];
    const float y = c.c[2] + s * o[0];
    const float dydt = o[0] / c.c[1] + s * o[1];
    const float r = dydt + y;
    g[0] = 2.0f * r * (1.0f / c.c[1] + s);
    g[1] = 2.0f * r * s;
    return r * r;
  }
};

// Heat, u = sin x + Dv·N, Dv = t·x·(x_max − x)/scale:
//   r = Dv_t·N + Dv·N_t − κ(−sin x + Dv_xx·N + 2·Dv_x·N_x + Dv·N_xx).
// c: x_max, t_max, kappa, scale.
struct HardHeat : SpecBase {
  static constexpr int R = 4, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kFirst)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float x = c.c[0] * pt.u[0], t = c.c[1] * pt.u[1];
    const float rows[8] = {x, t, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    for (int i = 0; i < 8; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float xm = c.c[0], kappa = c.c[2], scale = c.c[3];
    const float x = xm * pt.u[0], t = c.c[1] * pt.u[1];
    const float gx = x * (xm - x);
    const float dv = t * gx / scale;
    const float dv_t = gx / scale;
    const float dv_x = t * (xm - 2.0f * x) / scale;
    const float dv_xx = -2.0f * t / scale;
    const float u_t = dv_t * o[0] + dv * o[3];
    const float u_xx =
        -sinf(x) + dv_xx * o[0] + 2.0f * dv_x * o[1] + dv * o[2];
    const float r = u_t - kappa * u_xx;
    g[0] = 2.0f * r * (dv_t - kappa * dv_xx);
    g[1] = -4.0f * kappa * r * dv_x;
    g[2] = -2.0f * kappa * r * dv;
    g[3] = 2.0f * r * dv;
    return r * r;
  }
};

// 2-D heat, u = sin x·sin y + Dv·N, Dv = t·x(x_max − x)·y(x_max − y)/scale:
//   r = Dv_t·N + Dv·N_t − κ(u_xx + u_yy), each Laplacian term as heat's.
// c: x_max, t_max, kappa, scale.
struct HardHeat2D : SpecBase {
  static constexpr int R = 6, D = 3, U = 3;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond,
               kFirst)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float xm = c.c[0];
    const float x = xm * pt.u[0], y = xm * pt.u[1], t = c.c[1] * pt.u[2];
    const float rows[18] = {x,    y,    t,    1.0f, 0.0f, 0.0f,
                            0.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f,
                            0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    for (int i = 0; i < 18; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float xm = c.c[0], kappa = c.c[2], scale = c.c[3];
    const float x = xm * pt.u[0], y = xm * pt.u[1], t = c.c[1] * pt.u[2];
    const float gx = x * (xm - x), gy = y * (xm - y);
    const float dv = t * gx * gy / scale;
    const float dv_t = gx * gy / scale;
    const float dv_x = t * (xm - 2.0f * x) * gy / scale;
    const float dv_xx = -2.0f * t * gy / scale;
    const float dv_y = t * gx * (xm - 2.0f * y) / scale;
    const float dv_yy = -2.0f * t * gx / scale;
    const float a = sinf(x) * sinf(y);
    const float u_t = dv_t * o[0] + dv * o[5];
    const float u_xx = -a + dv_xx * o[0] + 2.0f * dv_x * o[1] + dv * o[2];
    const float u_yy = -a + dv_yy * o[0] + 2.0f * dv_y * o[3] + dv * o[4];
    const float r = u_t - kappa * (u_xx + u_yy);
    g[0] = 2.0f * r * (dv_t - kappa * (dv_xx + dv_yy));
    g[1] = -4.0f * kappa * r * dv_x;
    g[2] = -2.0f * kappa * r * dv;
    g[3] = -4.0f * kappa * r * dv_y;
    g[4] = -2.0f * kappa * r * dv;
    g[5] = 2.0f * r * dv;
    return r * r;
  }
};

// Wave, u = sin x + Dv·N, Dv = t²·x·(x_max − x)/scale:
//   r = Dv_tt·N + 2·Dv_t·N_t + Dv·N_tt − c²(−sin x + Dv_xx·N + 2·Dv_x·N_x
//       + Dv·N_xx).
// c: x_max, t_max, c², scale.
struct HardWave : SpecBase {
  static constexpr int R = 5, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float x = c.c[0] * pt.u[0], t = c.c[1] * pt.u[1];
    const float rows[10] = {x,    t,    1.0f, 0.0f, 0.0f,
                            0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float xm = c.c[0], c2 = c.c[2], scale = c.c[3];
    const float x = xm * pt.u[0], t = c.c[1] * pt.u[1];
    const float gx = x * (xm - x);
    const float dv = t * t * gx / scale;
    const float dv_t = 2.0f * t * gx / scale;
    const float dv_tt = 2.0f * gx / scale;
    const float dv_x = t * t * (xm - 2.0f * x) / scale;
    const float dv_xx = -2.0f * t * t / scale;
    const float u_tt = dv_tt * o[0] + 2.0f * dv_t * o[3] + dv * o[4];
    const float u_xx =
        -sinf(x) + dv_xx * o[0] + 2.0f * dv_x * o[1] + dv * o[2];
    const float r = u_tt - c2 * u_xx;
    g[0] = 2.0f * r * (dv_tt - c2 * dv_xx);
    g[1] = -4.0f * c2 * r * dv_x;
    g[2] = -2.0f * c2 * r * dv;
    g[3] = 4.0f * r * dv_t;
    g[4] = 2.0f * r * dv;
    return r * r;
  }
};

// Poisson, u = Dv·N, Dv = x(x_max − x)·y(x_max − y)/scale:
//   r = −(u_xx + u_yy) − 2 sin x sin y, u_xx = Dv_xx·N + 2·Dv_x·N_x +
//   Dv·N_xx (and in y). c: x_max, scale.
struct HardPoisson : SpecBase {
  static constexpr int R = 5, D = 2, U = 2;
  DEDNN_LAYOUT(kValue, kPairFirst, kPairSecond, kPairFirst, kPairSecond)
  __device__ static void build(const Point& pt, const Consts& c, float* X) {
    const float x = c.c[0] * pt.u[0], y = c.c[0] * pt.u[1];
    const float rows[10] = {x,    y,    1.0f, 0.0f, 0.0f,
                            0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
    for (int i = 0; i < 10; ++i) X[i] = rows[i];
  }
  __device__ static float loss(const Point& pt, const Consts& c,
                               const float* o, float* g) {
    const float xm = c.c[0], scale = c.c[1];
    const float x = xm * pt.u[0], y = xm * pt.u[1];
    const float gx = x * (xm - x), gy = y * (xm - y);
    const float dv = gx * gy / scale;
    const float dv_x = (xm - 2.0f * x) * gy / scale;
    const float dv_xx = -2.0f * gy / scale;
    const float dv_y = gx * (xm - 2.0f * y) / scale;
    const float dv_yy = -2.0f * gx / scale;
    const float u_xx = dv_xx * o[0] + 2.0f * dv_x * o[1] + dv * o[2];
    const float u_yy = dv_yy * o[0] + 2.0f * dv_y * o[3] + dv * o[4];
    const float src = 2.0f * sinf(x) * sinf(y);
    const float r = -(u_xx + u_yy) - src;
    g[0] = -2.0f * r * (dv_xx + dv_yy);
    g[1] = -4.0f * r * dv_x;
    g[2] = -2.0f * r * dv;
    g[3] = -4.0f * r * dv_y;
    g[4] = -2.0f * r * dv;
    return r * r;
  }
};

// ---------------------------------------------------------------------------
// The Taylor rules of tanh and their VJP, on one (batch point, column)
// ---------------------------------------------------------------------------

// a = the stream activations of the pre-activations zc (value rows: tanh;
// pair seconds: d·z2 − 2·a0·d·z1²; other tangents: d·z), as
// fused_engine._act_fwd.
template <class S>
__device__ __forceinline__ void act_fwd(const float (&zc)[S::R],
                                        float (&a)[S::R]) {
  constexpr int R = S::R;
  float a0[R], d[R];
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
}

// dzs = the VJP of act_fwd at the previous layer (fused_engine._act_bwd),
// given g = the gradient w.r.t. the activations and, per stream, prev =
// the activation of a value row (a0 = tanh(z0)) or the pre-activation of a
// tangent row. Per group, with d = 1 − a0², d' = −2·a0·d:
//   dz0 = d·g0 + d'·Σ(z_t·g_t over the tangents)
//              − Σ over pairs of 2·z1²·d·(d − 2·a0²)·g2
//   dz1 = d·g1 − 4·a0·d·z1·g2 (pair firsts),  dz2 = d·g2 (pair seconds),
//   dzf = d·gf (first-only tangents).
template <class S>
__device__ __forceinline__ void act_bwd(const float (&gs)[S::R],
                                        const float (&prev)[S::R],
                                        float (&dzs)[S::R]) {
  constexpr int R = S::R;
  float a0[R], d[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int v = value_of<S>(s);
    const unsigned kind = kind_of<S>(s);
    if (kind == kValue) {
      a0[s] = prev[s];
      d[s] = 1.0f - a0[s] * a0[s];
      dzs[s] = d[s] * gs[s];
    } else if (kind == kPairSecond) {  // closes the pair (s - 1, s)
      const int f = s > 0 ? s - 1 : 0;
      const float z1 = prev[f];
      const float z2 = prev[s];
      const float dp = -2.0f * a0[v] * d[v];
      dzs[v] = dzs[v] + dp * (z1 * gs[f] + z2 * gs[s]) -
               2.0f * (z1 * z1) * d[v] * (d[v] - 2.0f * a0[v] * a0[v]) *
                   gs[s];
      dzs[f] = d[v] * gs[f] - 4.0f * a0[v] * d[v] * z1 * gs[s];
      dzs[s] = d[v] * gs[s];
    } else if (kind == kFirst) {
      const float zf = prev[s];
      const float dp = -2.0f * a0[v] * d[v];
      dzs[v] = dzs[v] + dp * (zf * gs[s]);
      dzs[s] = d[v] * gs[s];
    }
  }
}

// x, hidden from the optimizer: the Taylor rules see a value of unknown
// origin, as the first design's did (each read from memory), so their
// products fuse into FMAs the same way.
__device__ __forceinline__ float opaque(float x) {
  asm volatile("" : "+f"(x));
  return x;
}

// What act_bwd reads of stream s at flat index i of the previous layer:
// the activation of a value row, the pre-activation of a tangent row.
template <class S>
__device__ __forceinline__ float bwd_operand(int s, const float* z,
                                             const float* a, size_t i) {
  return kind_of<S>(s) == kValue ? a[i] : z[i];
}

// Spec S's Taylor rules and their VJP as the shared layer kernel's
// epilogue (stream_layer.cuh): stream s of one (batch point, column) at
// flat index at + s·stride.
template <class S>
struct Rules {
  static constexpr int R = S::R;
  __device__ static void fwd(const float (&sums)[R], float bias,
                             float* __restrict__ z_out,
                             float* __restrict__ a_out, size_t at,
                             size_t stride) {
    float zc[R], a[R];
#pragma unroll
    for (int s = 0; s < R; ++s)
      zc[s] = kind_of<S>(s) == kValue ? sums[s] + bias : sums[s];
    act_fwd<S>(zc, a);
#pragma unroll
    for (int s = 0; s < R; ++s) {
      z_out[at + s * stride] = zc[s];
      a_out[at + s * stride] = a[s];
    }
  }
  __device__ static void bwd(const float (&gs)[R],
                             const float* __restrict__ z_prev,
                             const float* __restrict__ a_prev,
                             float* __restrict__ dz, size_t at,
                             size_t stride) {
    float prev[R], dzs[R];
#pragma unroll
    for (int s = 0; s < R; ++s)
      prev[s] = bwd_operand<S>(s, z_prev, a_prev, at + s * stride);
    act_bwd<S>(gs, prev, dzs);
#pragma unroll
    for (int s = 0; s < R; ++s) dz[at + s * stride] = dzs[s];
  }
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// The first layer, for step base + j: one thread per batch point builds its
// R input rows from the uniforms (S::build; written to X by the blocks of
// the first column tile), then thread (b, m) takes z = X·w_in + mask·b_in
// for the R streams at column m (the 8-slice sum of the first design: slice
// d < D is the one product x_d·w_dm) and the tanh rules. Block of kInputBB
// batch points × kInputBN columns; replica blockIdx.z: weights at z·ps,
// outputs at z·ss. B counts the rows of a stream: the batch, or a folded
// spec's F·batch rows, row b drawing on point b mod batch. kBf16: X and
// w_in enter the product rounded to bf16 (X is written unrounded).
template <class S, bool kBf16>
__global__ void __launch_bounds__(kInputBB* kInputBN)
    input_kernel(const StepArgs* __restrict__ args, int j, bool sweep,
                 Consts c, long long b_off, int H, int B, int batch,
                 float* __restrict__ X, float* __restrict__ Z,
                 float* __restrict__ A, size_t ss, size_t ps) {
  constexpr int R = S::R, D = S::D;
  if (dednn::gated(args, sweep, blockIdx.z, j)) return;
  __shared__ float x_s[kInputBB][R * D];
  const size_t so = blockIdx.z * ss;
  const float* w_in = args->p + blockIdx.z * ps;  // at offset 0
  const float* b_in = w_in + b_off;
  X += so;
  Z += so;
  A += so;
  const int b0 = blockIdx.y * kInputBB;
  const int tid = threadIdx.x;
  if (tid < kInputBB && b0 + tid < B) {
    const int b = b0 + tid;
    const int point = S::kFolded ? b % batch : b;
    const float* u =
        args->u + (static_cast<size_t>(args->base + j) * batch + point) *
                      S::U;
    float rows[R * D];
    S::build(Point{u, b, batch, args->cnst, nullptr,
                   dednn::live_batch(args, sweep, blockIdx.z)},
             c, rows);
#pragma unroll
    for (int i = 0; i < R * D; ++i)
      x_s[tid][i] = dednn::operand<kBf16>(rows[i]);
    if (blockIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < R; ++s)
#pragma unroll
        for (int d = 0; d < D; ++d)
          X[static_cast<size_t>(s * B + b) * D + d] = rows[s * D + d];
    }
  }
  __syncthreads();
  const int bl = tid / kInputBN, m = blockIdx.x * kInputBN + tid % kInputBN;
  const int b = b0 + bl;
  if (b >= B || m >= H) return;
  float w[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    w[d] = dednn::operand<kBf16>(w_in[static_cast<size_t>(d) * H + m]);
  const float bm = b_in[m];
  float zc[R], a[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    float sum = fmaf(x_s[bl][s * D], w[0], 0.0f);
#pragma unroll
    for (int d = 1; d < D; ++d)
      sum = sum + fmaf(x_s[bl][s * D + d], w[d], 0.0f);
    if (D < kSlices) sum = sum + 0.0f;  // the empty slices D .. 7
    zc[s] = kind_of<S>(s) == kValue ? sum + bm : sum;
  }
  act_fwd<S>(zc, a);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const size_t at = static_cast<size_t>(s * B + b) * H + m;
    Z[at] = zc[s];
    A[at] = a[s];
  }
}

// The output layer (O = 1) and the spec's point loss, for step base + j,
// one warp per batch point b (kLossWarps per block; replica blockIdx.y;
// the spec's numbers c by value, as the first design's loss kernel took
// them, so that the loss compiles to the same arithmetic):
// out_s = a_L[s, b]·w_out (+ b_out on value rows), each dot product
// lane-strided fmaf chains and a butterfly shuffle; the point loss to
// PL[b] (and a kExtra spec's d(point loss)/d(extra) to PE[b]);
// G[s·B + b] = (1/B)·d(point loss)/d(out_s); then the output layer's data
// gradient g = G·w_outᵀ and its VJP at layer L into DZ_L (z_L, a_L). The
// extra tensors are the replica's, at x_off. kBf16: both products take
// their operands rounded to bf16.
template <class S, bool kBf16>
__global__ void __launch_bounds__(32 * kLossWarps)
    loss_kernel(const StepArgs* __restrict__ args, int j, bool sweep,
                Consts c, long long w_off, long long b_off, long long x_off,
                int H, int B, const float* __restrict__ z,
                const float* __restrict__ a, float* __restrict__ G,
                float* __restrict__ PL, float* __restrict__ PE,
                float* __restrict__ dz, size_t ss, size_t ps) {
  constexpr int R = S::R;
  if (dednn::gated(args, sweep, blockIdx.y, j)) return;
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kLossWarps;
  const size_t so = blockIdx.y * ss;
  const float* w_out = args->p + blockIdx.y * ps + w_off;
  const float bo = args->p[blockIdx.y * ps + b_off];
  const float* extras = args->p + blockIdx.y * ps + x_off;
  z += so;
  a += so;
  G += so;
  PL += so;
  PE = dednn::shift(PE, so);
  dz += so;
  const float* u = args->u + static_cast<size_t>(args->base + j) * B * S::U;
  const int live = dednn::live_batch(args, sweep, blockIdx.y);
  const float inv_b = 1.0f / static_cast<float>(live > 0 ? live : B);
  for (int b = blockIdx.x * kLossWarps + threadIdx.x / 32; b < B;
       b += warps) {
    // Under a batch mask a row past bs contributes nothing: its point loss
    // and cotangents are scaled by 0 (the JAX package's q·mask).
    const float keep = live > 0 && b >= live ? 0.0f : 1.0f;
    const float scale = live > 0 ? inv_b * keep : inv_b;
    float out[R], g[R + 1];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float* ar = a + static_cast<size_t>(s * B + b) * H;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32)
        acc = fmaf(dednn::operand<kBf16>(ar[k]),
                   dednn::operand<kBf16>(w_out[k]), acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      out[s] = kind_of<S>(s) == kValue ? acc + bo : acc;
    }
    // Every lane holds the same outputs (the butterfly's sums commute), so
    // every lane computes the same loss and cotangent.
    const float point = S::loss(Point{u + static_cast<size_t>(b) * S::U, b, B,
                                      args->cnst, extras, live},
                                c, out, g);
    if (lane == 0) {
      PL[b] = live > 0 ? point * keep : point;
      if (S::kExtra) PE[b] = live > 0 ? g[R] * keep : g[R];
#pragma unroll
      for (int s = 0; s < R; ++s) G[s * B + b] = g[s] * scale;
    }
    float gr[R];  // G's entries as the product's operand
#pragma unroll
    for (int s = 0; s < R; ++s) gr[s] = dednn::operand<kBf16>(g[s] * scale);
    for (int k = lane; k < H; k += 32) {
      const float w = dednn::operand<kBf16>(w_out[k]);
      float gs[R], prev[R], dzs[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        // The product over the one output column, then the 7 empty
        // slices; opaque, as the first design's sums read back from shared
        // memory, so that the VJP's products fuse as they did there (equal
        // cotangents of two streams must not become one value).
        gs[s] = opaque(fmaf(gr[s], w, 0.0f) + 0.0f);
        prev[s] =
            bwd_operand<S>(s, z, a, static_cast<size_t>(s * B + b) * H + k);
      }
      act_bwd<S>(gs, prev, dzs);
#pragma unroll
      for (int s = 0; s < R; ++s)
        dz[static_cast<size_t>(s * B + b) * H + k] = dzs[s];
    }
  }
}

// A causal spec's output layer and loss (kCausal: causal advection), for
// step base + j, one block per replica (blockIdx.y) of kCausalThreads:
//   1. warp w takes points w, w + 16, ...: its R outputs (each dot product
//      as in loss_kernel), then S::residuals into shared memory: the three
//      residuals e, t and the interior energy r = q²;
//   2. thread i takes point i, ...: cum = Σ_{j : t_j < t_i} r_j in j
//      order (strict, as the TPU kernel's comparison mask), and the weight
//      w_i = exp(−ε·Δt·cum);
//   3. warp w again takes its points: PL[b] = S::weighted_loss,
//      G[s·B + b] = (1/B)·g_s, and the output layer's data gradient through
//      the tanh VJP at layer L into DZ_L, as loss_kernel writes them.
// Dynamic shared memory: kCausalFloats·B floats. kBf16 as in loss_kernel.
template <class S, bool kBf16>
__global__ void __launch_bounds__(kCausalThreads)
    causal_loss_kernel(const StepArgs* __restrict__ args, int j, bool sweep,
                       Consts c, long long w_off, long long b_off, int H,
                       int B,
                       const float* __restrict__ z,
                       const float* __restrict__ a, float* __restrict__ G,
                       float* __restrict__ PL, float* __restrict__ dz,
                       size_t ss, size_t ps) {
  constexpr int R = S::R, kWarps = kCausalThreads / 32;
  if (dednn::gated(args, sweep, blockIdx.y, j)) return;
  extern __shared__ float sh[];
  float* e_s = sh;          // [B][3]: the residuals q, r0, rb
  float* t_s = sh + 3 * B;  // [B]: t
  float* r_s = t_s + B;     // [B]: q²
  float* w_s = r_s + B;     // [B]: the causal weight
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t so = blockIdx.y * ss;
  const float* w_out = args->p + blockIdx.y * ps + w_off;
  const float bo = args->p[blockIdx.y * ps + b_off];
  z += so;
  a += so;
  G += so;
  PL += so;
  dz += so;
  const float* u = args->u + static_cast<size_t>(args->base + j) * B * S::U;
  for (int b = warp; b < B; b += kWarps) {
    float out[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const float* ar = a + static_cast<size_t>(s * B + b) * H;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = lane; k < H; k += 32)
        acc = fmaf(dednn::operand<kBf16>(ar[k]),
                   dednn::operand<kBf16>(w_out[k]), acc);
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      out[s] = kind_of<S>(s) == kValue ? acc + bo : acc;
    }
    if (lane == 0) {
      S::residuals(Point{u + static_cast<size_t>(b) * S::U, b, B, args->cnst,
                         nullptr},
                   c, out, e_s + 3 * b, t_s + b);
      r_s[b] = e_s[3 * b] * e_s[3 * b];
    }
  }
  __syncthreads();
  // Under a batch mask the loss is the plain one (weight 1), as the JAX
  // spec's masked branch: the causal weighting is a single-run protocol.
  const int live = dednn::live_batch(args, sweep, blockIdx.y);
  const float eps = c.c[4], dt = c.c[5];
  for (int i = threadIdx.x; i < B; i += kCausalThreads) {
    const float ti = t_s[i];
    float cum = 0.0f;
    if (live == 0)
      for (int k = 0; k < B; ++k)
        if (t_s[k] < ti) cum += r_s[k];
    w_s[i] = live > 0 ? 1.0f : expf(-eps * (cum * dt));
  }
  __syncthreads();
  const float inv_b = 1.0f / static_cast<float>(live > 0 ? live : B);
  for (int b = warp; b < B; b += kWarps) {
    const float keep = live > 0 && b >= live ? 0.0f : 1.0f;
    const float scale = live > 0 ? inv_b * keep : inv_b;
    float g[R];
    const float point = S::weighted_loss(c, e_s + 3 * b, w_s[b], g);
    if (lane == 0) {
      PL[b] = live > 0 ? point * keep : point;
#pragma unroll
      for (int s = 0; s < R; ++s) G[s * B + b] = g[s] * scale;
    }
    float gr[R];
#pragma unroll
    for (int s = 0; s < R; ++s) gr[s] = dednn::operand<kBf16>(g[s] * scale);
    for (int k = lane; k < H; k += 32) {
      const float w = dednn::operand<kBf16>(w_out[k]);
      float gs[R], prev[R], dzs[R];
#pragma unroll
      for (int s = 0; s < R; ++s) {
        gs[s] = opaque(fmaf(gr[s], w, 0.0f) + 0.0f);
        prev[s] =
            bwd_operand<S>(s, z, a, static_cast<size_t>(s * B + b) * H + k);
      }
      act_bwd<S>(gs, prev, dzs);
#pragma unroll
      for (int s = 0; s < R; ++s)
        dz[static_cast<size_t>(s * B + b) * H + k] = dzs[s];
    }
  }
}

// A folded spec's output layer and loss (kFolded: volterra), for step
// base + j: block (b, replica) of kFoldWarps warps takes point b's F
// outputs out_s = a_L[s·B + b]·w_out + b_out (warp w: s = w, w + kFoldWarps,
// ...; each dot product as in loss_kernel) into shared memory, then thread
// 0 the point loss (S::fold_loss, to PL[b]), then each warp its rows'
// G[s·B + b] = (1/B)·g_s and the data gradient through the tanh VJP at
// layer L into DZ_L. Dynamic shared memory: F floats. kBf16 as in
// loss_kernel.
template <class S, bool kBf16>
__global__ void __launch_bounds__(32 * kFoldWarps)
    fold_loss_kernel(const StepArgs* __restrict__ args, int j, bool sweep,
                     Consts c, long long w_off, long long b_off, int H, int B,
                     int F,
                     const float* __restrict__ a, float* __restrict__ G,
                     float* __restrict__ PL, float* __restrict__ dz,
                     size_t ss, size_t ps) {
  if (dednn::gated(args, sweep, blockIdx.y, j)) return;
  extern __shared__ float out_s[];  // [F]
  __shared__ float coef_s[2];        // g_0 and q of S::fold_loss
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x;
  // Under a batch mask a point past bs contributes nothing (scaled by 0).
  const int live = dednn::live_batch(args, sweep, blockIdx.y);
  const float keep = live > 0 && b >= live ? 0.0f : 1.0f;
  const size_t so = blockIdx.y * ss;
  const float* w_out = args->p + blockIdx.y * ps + w_off;
  const float bo = args->p[blockIdx.y * ps + b_off];
  a += so;
  G += so;
  PL += so;
  dz += so;
  const Point pt{args->u + (static_cast<size_t>(args->base + j) * B + b) *
                               S::U,
                 b, B, args->cnst, nullptr};
  for (int s = warp; s < F; s += kFoldWarps) {
    const float* ar = a + (static_cast<size_t>(s) * B + b) * H;
    float acc = 0.0f;
#pragma unroll 4
    for (int k = lane; k < H; k += 32)
      acc = fmaf(dednn::operand<kBf16>(ar[k]),
                 dednn::operand<kBf16>(w_out[k]), acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out_s[s] = acc + bo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float point =
        S::fold_loss(pt, c, out_s, F, &coef_s[0], &coef_s[1]);
    PL[b] = live > 0 ? point * keep : point;
  }
  __syncthreads();
  const float inv_b = 1.0f / static_cast<float>(live > 0 ? live : B);
  const float scale = live > 0 ? inv_b * keep : inv_b;
  for (int s = warp; s < F; s += kFoldWarps) {
    const float gs = s == 0 ? coef_s[0] : coef_s[1] * S::fold_coef(pt, s);
    const size_t row = static_cast<size_t>(s) * B + b;
    if (lane == 0) G[row] = gs * scale;
    const float gr = dednn::operand<kBf16>(gs * scale);
    for (int k = lane; k < H; k += 32) {
      const float av = a[row * H + k];
      // act_bwd at a value row: (1 − a²)·g, g through the one output
      // column and the 7 empty slices, as in loss_kernel.
      const float gk = opaque(
          fmaf(gr, dednn::operand<kBf16>(w_out[k]), 0.0f) + 0.0f);
      dz[row * H + k] = (1.0f - av * av) * gk;
    }
  }
}

// The step's loss = the batch mean of the point losses, into the replica's
// slot (blockIdx.x) of call step base + j: lane w sums rows w, w + 32, ...
// in row order, then lane 0 the 32 sums in lane order (under a batch mask
// the rows past bs are zeros and the sum is scaled by 1/bs). With PE (a spec
// with an extra trainable scalar, at x_off of the replica's parameters),
// its gradient, the batch mean of PE summed in the same order, then Adam
// on it at step step0 + base + j + 1 (kAdam), or the gradient to
// args->grad.
template <bool kAdam>
__global__ void loss_sum_kernel(const StepArgs* __restrict__ args, int j,
                                bool sweep, const float* __restrict__ PL,
                                const float* __restrict__ PE, int B,
                                size_t ss, size_t ps, long long x_off) {
  if (dednn::gated(args, sweep, blockIdx.x, j)) return;
  const int live = dednn::live_batch(args, sweep, blockIdx.x);
  const float inv_b = 1.0f / static_cast<float>(live > 0 ? live : B);
  auto batch_sum = [&](const float* v) {
    const int lane = threadIdx.x;
    float sum = 0.0f;
    for (int row = lane; row < B; row += kLossLanes) sum += v[row];
    float total = 0.0f;
    for (int i = 0; i < kLossLanes; ++i)
      total += __shfl_sync(0xffffffffu, sum, i);
    return total * inv_b;
  };
  const float loss = batch_sum(PL + blockIdx.x * ss);
  if (threadIdx.x == 0)
    args->losses[blockIdx.x * args->ls + args->base + j] = loss;
  if (PE == nullptr) return;
  const float ge = batch_sum(PE + blockIdx.x * ss);
  if (threadIdx.x != 0) return;
  const size_t at = blockIdx.x * ps + x_off;
  if (kAdam) {
    const dednn::AdamStep step =
        dednn::replica_step(args, sweep, blockIdx.x, j);
    float pv = args->p[at], mv = args->m[at], vv = args->v[at];
    dednn::adam_apply(pv, mv, vv, ge, step);
    args->m[at] = mv;
    args->v[at] = vv;
    args->p[at] = pv;
  } else {
    args->grad[x_off] = ge;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

long long n_params(int D, int H, int L) {
  return static_cast<long long>(D) * H + H + static_cast<long long>(L) * H * H +
         static_cast<long long>(L) * H + H + 1;
}

// Offsets of the flat buffer's tensors (fused_engine.pack_state order: the
// MLP's six, then the spec's extra tensors at `extras`).
struct Offsets {
  long long w_in, b_in, w_hid, b_hid, w_out, b_out, extras;
  Offsets(int D, int H, int L) {
    const long long h = H, l = L;
    w_in = 0;
    b_in = D * h;
    w_hid = b_in + h;
    b_hid = w_hid + l * h * h;
    w_out = b_hid + l * h;
    b_out = w_out + h;
    extras = b_out + 1;
  }
};

size_t align4(size_t floats) { return (floats + 3) / 4 * 4; }

// The per-replica scratch at `rows` rows per stream (the batch, or a folded
// spec's F·batch): X [R·rows, D]; Z, A and DZ [L + 1][R·rows, H]; G
// [R·rows]; the point losses PL and the extra's point gradients PE [rows];
// each region 16-byte aligned.
struct Scratch {
  size_t X, Z, A, G, DZ, PL, PE, total;
  Scratch(int R, int rows_per_stream, int D, int H, int L) {
    const size_t rows = static_cast<size_t>(R) * rows_per_stream;
    const size_t layers = static_cast<size_t>(L + 1) * rows * H;
    X = 0;
    Z = align4(X + rows * D);
    A = align4(Z + layers);
    G = align4(A + layers);
    DZ = align4(G + rows);
    PL = align4(DZ + layers);
    PE = align4(PL + rows_per_stream);
    total = align4(PE + rows_per_stream);
  }
};

// Thread groups of a spec's weight gradients: one per stream, or a folded
// spec's F groups kFoldGroups at a time (so its gradients' blocks walk
// ⌈F/kFoldGroups⌉·⌈B/16⌉ row chunks, not ⌈F·B/16⌉ as at R = 1).
template <class S>
constexpr int wg_groups() {
  return S::kFolded ? kFoldGroups : S::R;
}

// Enqueue call step base + j of `reps` replicas: the forward, the loss into
// its slot, the data path of the backward, then every layer's weight
// gradient (with Adam, kAdam; else the gradient to args->grad) on three
// lanes: the two side streams and main, in turn, the input layer's on the
// least loaded. They start together once every
// layer's data gradient has read its weight (the Adam epilogue rewrites
// it): timed on the H100 (kernels/profile.py), that beat forking each one
// as soon as its layer's data gradient was done, when the weight gradients
// slowed the data path they shared the SMs with. Replica r's scratch is at
// scratch + r·Scratch::total; each layer keeps its own Z, A and dz. F is a
// folded spec's group count (1 for the others): its streams have F·B rows.
// At L = 0 (uat's Perceptron) the step is the input layer, the loss, and
// the weight gradients of the input and output layers. kBf16: every
// launch's "default" instance.
template <class S, bool kAdam, bool kBf16>
cudaError_t enqueue_step(const StepArgs* args, const Consts& c, int j,
                         bool sweep, float* scratch, int reps, int B, int H,
                         int L, int F, Streams& st) {
  constexpr int R = S::R, D = S::D, kWg = wg_groups<S>();
  const int rows = S::kFolded ? F * B : B;
  const Scratch sc(R, rows, D, H, L);
  const Offsets off(D, H, L);
  // The weight gradients' streams: a folded spec's F groups of B rows.
  const Layout lay = S::kFolded ? Layout{F, B, ~0u}
                                : Layout{R, rows, S::kValueMask};
  const size_t layer_floats = static_cast<size_t>(R) * rows * H;
  const size_t ss = sc.total, n = n_params(D, H, L) + S::kExtra;
  float* X = scratch + sc.X;
  float* Z = scratch + sc.Z;
  float* A = scratch + sc.A;
  float* G = scratch + sc.G;
  float* DZ = scratch + sc.DZ;
  float* PL = scratch + sc.PL;
  float* PE = S::kExtra ? scratch + sc.PE : nullptr;
  auto at = [&](float* base, int l) { return base + l * layer_floats; };
  auto w_hid = [&](int l) { return off.w_hid + static_cast<long long>(l) * H * H; };
  auto b_hid = [&](int l) { return off.b_hid + static_cast<long long>(l) * H; };
  const cudaStream_t main = st.main;

  input_kernel<S, kBf16><<<dim3(dednn::ceil_div(H, kInputBN),
                                dednn::ceil_div(rows, kInputBB), reps),
                           kInputBB * kInputBN, 0, main>>>(
      args, j, sweep, c, off.b_in, H, rows, B, X, Z, A, ss, n);
  for (int l = 1; l <= L; ++l)
    dednn::layer<Rules<S>, false, kBf16>(at(A, l - 1), args, j, sweep,
                                         w_hid(l - 1), b_hid(l - 1), H, H,
                                         rows, nullptr, nullptr, at(Z, l),
                                         at(A, l), ss, n, reps, main);
  if constexpr (S::kFolded) {
    fold_loss_kernel<S, kBf16><<<dim3(B, reps), 32 * kFoldWarps,
                                 F * sizeof(float), main>>>(
        args, j, sweep, c, off.w_out, off.b_out, H, B, F, at(A, L), G, PL,
        at(DZ, L), ss, n);
  } else if constexpr (S::kCausal) {
    causal_loss_kernel<S, kBf16><<<dim3(1, reps), kCausalThreads,
                                   kCausalFloats * B * sizeof(float), main>>>(
        args, j, sweep, c, off.w_out, off.b_out, H, B, at(Z, L), at(A, L), G,
        PL, at(DZ, L), ss, n);
  } else {
    loss_kernel<S, kBf16><<<dim3(dednn::ceil_div(B, kLossWarps), reps),
                            32 * kLossWarps, 0, main>>>(
        args, j, sweep, c, off.w_out, off.b_out, off.extras, H, B, at(Z, L),
        at(A, L), G, PL, PE, at(DZ, L), ss, n);
  }
  for (int l = L; l >= 1; --l)
    dednn::layer<Rules<S>, true, kBf16>(at(DZ, l), args, j, sweep,
                                        w_hid(l - 1), -1LL, H, H, rows,
                                        at(Z, l - 1),
                                        at(A, l - 1), nullptr, at(DZ, l - 1),
                                        ss, n, reps, main);

  cudaStream_t lanes[3];
  cudaError_t err = st.branch(&lanes[0]);
  if (err == cudaSuccess) err = st.branch(&lanes[1]);
  if (err != cudaSuccess) return err;
  lanes[2] = main;
  int load[3] = {0, 0, 0};  // weight gradients per lane
  for (int l = L; l >= 1; --l) {  // the hidden layers, one lane each in turn
    ++load[(L - l) % 3];
    dednn::weight_grad<kAdam, kWg, kBf16>(at(A, l - 1), H, at(DZ, l), H, lay,
                                          args, j, sweep, w_hid(l - 1),
                                          b_hid(l - 1), ss, n, reps,
                                          lanes[(L - l) % 3]);
  }
  loss_sum_kernel<kAdam><<<reps, kLossLanes, 0, lanes[1]>>>(
      args, j, sweep, PL, PE, B, ss, n, off.extras);
  ++load[1];
  dednn::weight_grad<kAdam, kWg, kBf16>(at(A, L), H, G, 1, lay, args, j,
                                        sweep, off.w_out, off.b_out, ss, n,
                                        reps, lanes[1]);
  // The input layer's on the least loaded lane, the first of equals (at
  // L = 3 lanes[0], as before; at L = 2 not a third one on lanes[1], which
  // held volterra's step to its three weight gradients in a row).
  int in = 0;
  for (int i = 1; i < 3; ++i)
    if (load[i] < load[in]) in = i;
  dednn::weight_grad<kAdam, kWg, kBf16>(X, D, DZ, H, lay, args, j, sweep,
                                        off.w_in, off.b_in, ss, n, reps,
                                        lanes[in]);
  err = st.merge();
  return err != cudaSuccess ? err : cudaGetLastError();
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
    case 7: return f(Volterra{});
    case 8: return f(Uat{});
    case 9: return f(InverseHeat{});
    case 10: return f(HardSimpleOde{});
    case 11: return f(HardHeat{});
    case 12: return f(HardHeat2D{});
    case 13: return f(HardWave{});
    case 14: return f(HardPoisson{});
    case 15: return f(CausalAdvection{});
    default: return -1;
  }
}

StepArgs host_args(const float* consts, const float* cnst, float* p,
                   float* m, float* v, const float* u, float* losses,
                   long long ls, float* grad) {
  StepArgs a{};
  a.p = p;
  a.m = m;
  a.v = v;
  a.u = u;
  a.losses = losses;
  a.ls = ls;
  a.grad = grad;
  a.cnst = cnst;
  for (int i = 0; i < kMaxConsts; ++i) a.c.c[i] = consts[i];
  return a;
}

// A folded spec's F groups: at least 1, and its loss kernel's outputs in
// the 48 KB of shared memory a block takes without opting in.
bool fold_ok(int F) { return F >= 1 && F <= kMaxFold; }

// The batch of spec S's loss kernel: a causal spec's in its shared memory.
template <class S>
bool batch_ok(int B) {
  return !S::kCausal || (B >= 1 && B <= kCausalMaxBatch);
}


// One step's loss and flat gradient (kernel #6 alone), its launches on one
// stream, at kBf16's precision. consts: the spec's kMaxConsts numbers, in
// host memory; cnst: its const operand on the device (nullptr: none);
// args: a device block of engine_args_bytes(); F: the folded groups (1
// unless the spec folds).
template <bool kBf16>
int grad_steps(int spec, const float* consts, const float* cnst,
               const float* p, const float* u, float* scratch, float* grad,
               float* loss, void* args, int B, int H, int L, int F,
               void* stream) {
  if (!fold_ok(F)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StepArgs* dev = static_cast<StepArgs*>(args);
  const StepArgs a = host_args(consts, cnst, const_cast<float*>(p), nullptr,
                               nullptr, u, loss, 0, grad);
  const int code = dispatch(spec, [&](auto s) -> int {
    using S = decltype(s);
    if (!batch_ok<S>(B)) return cudaErrorInvalidValue;
    cudaError_t err = dednn::prepare_step<Rules<S>, wg_groups<S>(), kBf16>();
    if (err == cudaSuccess) err = write_args(dev, a, st);
    if (err != cudaSuccess) return err;
    Streams one{st, {st, st}, nullptr, nullptr};
    return enqueue_step<S, false, kBf16>(dev, a.c, 0, false, scratch, 1, B,
                                         H, L, F, one);
  });
  return code < 0 ? cudaErrorInvalidValue : code;
}

// Capture S training steps of N packed replicas at kBf16's precision as one
// CUDA graph (dednn::capture_steps) and instantiate it into *exec. The
// graph holds the scratch and argument-block pointers, the shape (F folded
// groups included) and the spec's numbers (consts, in host memory): it
// serves every call of that shape and those numbers whose per-call values
// come through args (engine_train_packed writes them, the const operand's
// pointer among them); sweep != 0: its launches read the sweep mode's
// fields, and it serves the calls in that mode alone.
template <bool kBf16>
int capture_graph(int spec, const float* consts, int B, int H, int L, int F,
                  int N, int S, int sweep, void* args, float* scratch,
                  void** exec) {
  *exec = nullptr;
  if (S < 1 || N < 1 || N > dednn::kMaxGridYZ || !fold_ok(F))
    return cudaErrorInvalidValue;
  StepArgs* dev = static_cast<StepArgs*>(args);
  const Consts c = host_args(consts, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, 0, nullptr).c;
  const int code = dispatch(spec, [&](auto s) -> int {
    using Spec = decltype(s);
    if (!batch_ok<Spec>(B)) return cudaErrorInvalidValue;
    const cudaError_t err =
        dednn::prepare_step<Rules<Spec>, wg_groups<Spec>(), kBf16>();
    if (err != cudaSuccess) return err;
    return dednn::capture_steps(
        dev, S,
        [&](int j, Streams& st) {
          return enqueue_step<Spec, true, kBf16>(dev, c, j, sweep != 0,
                                                 scratch, N, B, H, L, F, st);
        },
        exec);
  });
  return code < 0 ? cudaErrorInvalidValue : code;
}

// K Adam steps of N packed replicas (kernel #5 around #6) at kBf16's
// precision: p, m, v [N, n] updated in place, losses [N, K]; the uniforms
// [K, B, U], the const operand cnst (nullptr: none) and the schedule are
// shared. scratch (N·engine_scratch_floats) and args (engine_args_bytes)
// are the ones exec was built with, if exec is not null: then ⌊K/S⌋
// replays of its S steps on `stream`, and the other K mod S steps as the
// same launches from here, the weight gradients on side0 and side1 (all K,
// without exec). *step_math_runs (host memory) is set to the number of
// replica-steps whose step math was enqueued. N above the grid's 65 535 is
// refused. The sweep mode (StepArgs::lr_vec, bs_vec, steps_vec,
// trial_horizon; device vectors of N, or nullptr) rides the argument block,
// so one graph captured in that mode serves every trial; a call is in it
// when lr_vec and steps_vec are given (bs_vec too, or not: no mask), and
// exec must then have been captured with sweep != 0.
template <bool kBf16>
int train_steps(int spec, const float* consts, const float* cnst, float* p,
                float* m, float* v, const float* u, float* scratch,
                float* losses, void* args, void* exec, int S, int N, int K,
                int B, int H, int L, int F, float lr, int step0, int schedule,
                float horizon, float decay, float half_span, float log_decay,
                const float* lr_vec, const int* bs_vec, const int* steps_vec,
                int trial_horizon, int* step_math_runs, void* stream,
                void* side0, void* side1) {
  *step_math_runs = 0;
  if (N < 1 || N > dednn::kMaxGridYZ || !fold_ok(F))
    return cudaErrorInvalidValue;
  if (exec != nullptr && S < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StepArgs* dev = static_cast<StepArgs*>(args);
  StepArgs a = host_args(consts, cnst, p, m, v, u, losses, K, nullptr);
  a.step0 = step0;
  a.lr = lr;
  a.sched = Schedule{schedule, horizon, decay, half_span, log_decay};
  a.lr_vec = lr_vec;
  a.bs_vec = bs_vec;
  a.steps_vec = steps_vec;
  a.trial_horizon = trial_horizon;
  // The sweep mode takes lr_vec and steps_vec together (bs_vec: a mask).
  const bool sweep = steps_vec != nullptr;
  if ((lr_vec != nullptr) != sweep || (bs_vec != nullptr && !sweep))
    return cudaErrorInvalidValue;
  const int code = dispatch(spec, [&](auto s) -> int {
    using Spec = decltype(s);
    if (!batch_ok<Spec>(B)) return cudaErrorInvalidValue;
    cudaError_t err =
        dednn::prepare_step<Rules<Spec>, wg_groups<Spec>(), kBf16>();
    if (err == cudaSuccess) err = write_args(dev, a, st);
    if (err != cudaSuccess) return err;
    return dednn::run_steps(
        exec, S, K, N, st, static_cast<cudaStream_t>(side0),
        static_cast<cudaStream_t>(side1),
        [&](int j, Streams& two) {
          return enqueue_step<Spec, true, kBf16>(dev, a.c, j, sweep, scratch,
                                                 N, B, H, L, F, two);
        },
        step_math_runs);
  });
  return code < 0 ? cudaErrorInvalidValue : code;
}

}  // namespace

// The "default" precision's entry points, compiled from this source by
// engine_train_bf16.cu (its own nvcc, beside this one's: the bf16 instances
// of every spec's kernels double the build, so each precision builds in a
// translation unit of its own).
extern "C" int engine_grad_bf16(int spec, const float* consts,
                                const float* cnst, const float* p,
                                const float* u, float* scratch, float* grad,
                                float* loss, void* args, int B, int H, int L,
                                int F, void* stream)
#if DEDNN_ENGINE_BF16
{
  return grad_steps<true>(spec, consts, cnst, p, u, scratch, grad, loss, args,
                          B, H, L, F, stream);
}
#else
    ;
#endif

extern "C" int engine_graph_build_bf16(int spec, const float* consts, int B,
                                       int H, int L, int F, int N, int S,
                                       int sweep, void* args, float* scratch,
                                       void** exec)
#if DEDNN_ENGINE_BF16
{
  return capture_graph<true>(spec, consts, B, H, L, F, N, S, sweep, args,
                             scratch, exec);
}
#else
    ;
#endif

extern "C" int engine_train_packed_bf16(
    int spec, const float* consts, const float* cnst, float* p, float* m,
    float* v, const float* u, float* scratch, float* losses, void* args,
    void* exec, int S, int N, int K, int B, int H, int L, int F, float lr,
    int step0, int schedule, float horizon, float decay, float half_span,
    float log_decay, const float* lr_vec, const int* bs_vec,
    const int* steps_vec, int trial_horizon, int* step_math_runs,
    void* stream, void* side0, void* side1)
#if DEDNN_ENGINE_BF16
{
  return train_steps<true>(spec, consts, cnst, p, m, v, u, scratch, losses,
                           args, exec, S, N, K, B, H, L, F, lr, step0,
                           schedule, horizon, decay, half_span, log_decay,
                           lr_vec, bs_vec, steps_vec, trial_horizon,
                           step_math_runs, stream, side0, side1);
}
#else
    ;
#endif

#if !DEDNN_ENGINE_BF16
// Floats of scratch one replica needs at F folded groups (1 for a spec
// that does not fold), or -1 for an unknown spec.
extern "C" long long engine_scratch_floats(int spec, int B, int H, int L,
                                           int F) {
  return dispatch(spec, [&](auto s) -> long long {
    using S = decltype(s);
    return static_cast<long long>(
        Scratch(S::R, S::kFolded ? F * B : B, S::D, H, L).total);
  });
}

// Bytes of dynamic shared memory per block that the largest instance of
// the spec's kernels takes (a layer tile's k-tiles of the R·BB operand rows
// and of the weight, or a weight-gradient tile): the same at every hidden
// width H. -1 for an unknown spec.
extern "C" long long engine_smem_bytes(int spec, int H) {
  (void)H;
  return dispatch(spec, [&](auto s) -> long long {
    using S = decltype(s);
    return static_cast<long long>(
        dednn::step_smem_bytes<S::R, wg_groups<S>()>());
  });
}

// Bytes of the device argument block (StepArgs) every entry point takes.
extern "C" int engine_args_bytes() { return sizeof(StepArgs); }

// One step's loss and flat gradient (kernel #6 alone), its launches on one
// stream (grad_steps); bf16: the "default" precision's instances (else
// "highest"), here and below.
extern "C" int engine_grad(int spec, const float* consts, const float* cnst,
                           const float* p, const float* u, float* scratch,
                           float* grad, float* loss, void* args, int B, int H,
                           int L, int F, int bf16, void* stream) {
  return bf16 ? engine_grad_bf16(spec, consts, cnst, p, u, scratch, grad,
                                 loss, args, B, H, L, F, stream)
              : grad_steps<false>(spec, consts, cnst, p, u, scratch, grad,
                                  loss, args, B, H, L, F, stream);
}

// S training steps of N packed replicas as one CUDA graph (capture_graph).
extern "C" int engine_graph_build(int spec, const float* consts, int B, int H,
                                  int L, int F, int N, int bf16, int S,
                                  int sweep, void* args, float* scratch,
                                  void** exec) {
  return bf16 ? engine_graph_build_bf16(spec, consts, B, H, L, F, N, S, sweep,
                                        args, scratch, exec)
              : capture_graph<false>(spec, consts, B, H, L, F, N, S, sweep,
                                     args, scratch, exec);
}

extern "C" int engine_graph_free(void* exec) {
  return dednn::free_graph(exec);
}

// K Adam steps of N packed replicas (train_steps).
extern "C" int engine_train_packed(int spec, const float* consts,
                                   const float* cnst, float* p, float* m,
                                   float* v, const float* u, float* scratch,
                                   float* losses, void* args, void* exec,
                                   int S, int N, int K, int B, int H, int L,
                                   int F, int bf16, float lr, int step0,
                                   int schedule, float horizon, float decay,
                                   float half_span, float log_decay,
                                   const float* lr_vec, const int* bs_vec,
                                   const int* steps_vec, int trial_horizon,
                                   int* step_math_runs, void* stream,
                                   void* side0, void* side1) {
  return bf16 ? engine_train_packed_bf16(
                    spec, consts, cnst, p, m, v, u, scratch, losses, args,
                    exec, S, N, K, B, H, L, F, lr, step0, schedule, horizon,
                    decay, half_span, log_decay, lr_vec, bs_vec, steps_vec,
                    trial_horizon, step_math_runs, stream, side0, side1)
              : train_steps<false>(
                    spec, consts, cnst, p, m, v, u, scratch, losses, args,
                    exec, S, N, K, B, H, L, F, lr, step0, schedule, horizon,
                    decay, half_span, log_decay, lr_vec, bs_vec, steps_vec,
                    trial_horizon, step_math_runs, stream, side0, side1);
}

// Times what one step is built from (kernels/profile.py --probe-engine):
// `launches` back-to-back launches of one kernel, at the tile the step
// picks, at heat2d's layout (R = 11, D = 3) with batch B and width H on
// `stream`, one hidden layer's buffers in scratch
// (engine_scratch_floats(6, B, H, 1, 1)) and its parameters in params (2·n
// floats: p, then the gradient). kind 0: the forward layer, 1: the
// backward layer, 2: the hidden layer's weight gradient (no Adam), 3: the
// loss kernel, 4: the input kernel.
extern "C" int engine_probe(int kind, int B, int H, int launches,
                            float* params, float* scratch, void* args,
                            void* stream) {
  using S = Heat2D;
  constexpr int R = S::R, D = S::D;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StepArgs* dev = static_cast<StepArgs*>(args);
  const Offsets off(D, H, 1);
  const size_t n = n_params(D, H, 1);
  const float zeros[kMaxConsts] = {};
  const StepArgs a = host_args(zeros, nullptr, params, nullptr, nullptr,
                               scratch, params, 0, params + n);
  cudaError_t err = dednn::prepare_step<Rules<S>>();
  if (err == cudaSuccess) err = write_args(dev, a, st);
  if (err != cudaSuccess) return err;
  const Scratch sc(R, B, D, H, 1);
  const size_t layer_floats = static_cast<size_t>(R) * B * H;
  float* Z = scratch + sc.Z;
  float* A = scratch + sc.A;
  float* DZ = scratch + sc.DZ;
  for (int i = 0; i < launches; ++i) {
    switch (kind) {
      case 0:
        dednn::layer<Rules<S>, false>(A, dev, 0, false, off.w_hid, off.b_hid,
                                      H, H, B, nullptr, nullptr,
                                      Z + layer_floats, A + layer_floats,
                                      sc.total, n, 1, st);
        break;
      case 1:
        dednn::layer<Rules<S>, true>(DZ + layer_floats, dev, 0, false,
                                     off.w_hid, -1LL, H, H, B, Z, A, nullptr,
                                     DZ, sc.total, n, 1, st);
        break;
      case 2:
        dednn::weight_grad<false, R>(A, H, DZ + layer_floats, H,
                                     Layout{R, B, S::kValueMask}, dev, 0,
                                     false, off.w_hid, off.b_hid, sc.total, n,
                                     1, st);
        break;
      case 3:
        loss_kernel<S, false><<<dim3(dednn::ceil_div(B, kLossWarps), 1),
                         32 * kLossWarps, 0, st>>>(
            dev, 0, false, Consts{}, off.w_out, off.b_out, off.extras, H, B,
            Z, A, scratch + sc.G, scratch + sc.PL, scratch + sc.PE, DZ,
            sc.total, n);
        break;
      case 4:
        input_kernel<S, false><<<dim3(dednn::ceil_div(H, kInputBN),
                                      dednn::ceil_div(B, kInputBB), 1),
                          kInputBB * kInputBN, 0, st>>>(
            dev, 0, false, Consts{}, off.b_in, H, B, B, scratch + sc.X, Z, A,
            sc.total, n);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

#endif  // !DEDNN_ENGINE_BF16
