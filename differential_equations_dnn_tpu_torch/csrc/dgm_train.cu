// K Adam steps of a DGM (gate-network) PINN, and one step's loss and
// gradient.
//
// Replaces: differential_equations_dnn_tpu/kernels/fused_dgm.py::
// dgm_step_math (kernel #7, with its stream ops _act_fwd, _act_bwd,
// _mul_fwd, _mul_bwd) inside kernels/engine_core.py::fused_adam_kernel
// (kernel #4, reached through fused_dgm_chunk) and fused_packed_adam_kernel
// (kernel #5, reached through fused_dgm_packed_chunk). Each step pushes
// stacked value / first-order-tangent stream rows through the gate
// recurrence
//   Z,G,R = act(s·Wzgr + x·Uzgr + bzgr)
//   H     = act((s⊙R)·Wh + x·Uh + bh)
//   s'    = (1 − G)⊙H + Z⊙s
// under the stream rules (act: v → σ(v), t → σ'(v)·t; product: v → a_v·b_v,
// t → a_v·b_t + a_t·b_v; biases and the "1" of 1 − G on value rows only),
// takes the spec's loss and its cotangent by hand, runs the hand backward
// through the recurrence, and applies Adam (adam.cuh). The weight gradient,
// the staging helpers, the argument block and the graph capture and replay
// are shared with the MLP engine (fused_step.cuh).
//
// What bounds it on the H100: one FitzHugh–Nagumo step (R·B = 300 rows,
// H = 128, L = 4) is about 0.5 GFLOP of fp32 products, 7 µs at the
// 67 TFLOP/s fp32 peak, but it is a chain of 46 dependent phases of a few
// tens of thousands of outputs each (Fredholm: 16 phases at H = 32); packed
// replicas make every phase N times wider. Each phase's latency, how well
// its blocks fill the 132 SMs, and the gaps between launches are the limit.
//
// What the design does about it:
//   * The products are register-blocked fp32 FFMA. gemm_kernel gives each
//     thread an 8×4 or 2×4 tile of outputs, read from shared memory as
//     float4s four k at a time, over k-tiles staged by cp.async (16 bytes
//     per copy where the block's operands are aligned) into a ring of four
//     buffers; weight_grad_kernel a 4×4, 4×2 or 2×2 tile of (k, m) over
//     rows staged 16 or 32 at a time the same way, three streams at once in
//     three thread groups where the card would otherwise be underfilled.
//     Each launch takes its tile from (rows, cols, replicas).
//   * weight_grad_kernel sums all R streams of its tile in one block and
//     ends with one gradient per tensor: no [R][n] partials. In training its
//     epilogue applies Adam to the tile (adam.cuh), so the gradient never
//     reaches device memory; each layer's backward takes the data gradient
//     through a weight before that weight's update. The weight gradients
//     run on two side streams, forked from the data path once their inputs
//     are written and joined at the end of the step, so they overlap the
//     rest of the backward.
//   * A step is 10L + 6 launches (46 at L = 4). dgm_train_packed replays a
//     CUDA graph of S steps (dgm_graph_build; the wrapper caches it by
//     shape) and runs the K mod S steps left over as the same launches from
//     C. Kernels read what changes per call (p, m, v, the uniforms, the
//     losses, Fredholm's const, the spec's consts, lr and the schedule) from
//     a device argument block, StepArgs, written by one copy per call, and
//     take their step as base + j: j, the step's slot in the graph, is a
//     launch argument; base, the call's steps before this replay, is
//     advanced once per replay by the graph's last node.
//   * Every shared-memory staging copy, every chain of products and the
//     epilogue's loads are arranged so that a block's warps are not held up
//     one row or one output at a time: the row loop has no branch (the bias
//     chain is fmaf(1, dz, chain), exactly chain + dz), and the epilogue
//     loads all its operands before its first store.
//
// One step's launches:
//   input      x 1      the spec's rows X from the uniforms (and the const),
//                       s0 = act(X·w_in + b_in)
//   gemm       x 4L     the gate and H pre-activations forward; dh_pre·Whᵀ
//                       and dzgr_pre·Wzgrᵀ backward
//   gate/state x 2L     the stream rules of R, s⊙R, H and s' (forward)
//   loss       x 1      output layer, the spec's loss and cotangent G
//   out_bwd    x 1      ds = G·w_outᵀ
//   gate_bwd   x 2L     the stream VJPs of s' and of s⊙R and the gates
//   input_bwd  x 1      the input layer's activation VJP
//   weight     x 2L+2   dW = Aᵀ·dZ, the x row and db; Adam in training (on
//                       the two side streams)
// The stream layout (R rows per batch point, a bit per value row) is a
// run-time argument, so Fredholm's R = 1 + ⌈k/B⌉ needs no rebuild; R is at
// most kMaxStreams. Every reduction runs in a fixed order with no atomics:
// each product output is one fmaf chain over k from 0 in ascending order,
// whatever the tile, and each weight gradient the sum in stream order of
// per-stream fmaf chains over the stream's B rows in order. So runs are
// bit-identical and a chunk cut anywhere equals the uncut run. Every
// product of the "highest" instances is fp32 FFMA: exact fp32, no tensor
// cores, no library.
//
// At the "default" precision (bf16 != 0 at the entry points) every launch
// is its kBf16 instance: gemm_kernel and the weight gradients multiply on
// the tensor cores (mma_bf16.cuh: bf16 operands, fp32 accumulation, in a
// fixed order, so runs stay bit-identical and chunk-invariant); the D = 1
// products (x·w_in, x·U in the gemm's epilogue, the x row of the weight
// gradients) and the output layer's (S·w_out, G·w_outᵀ) take their operands
// rounded to bf16 as they load, as the JAX step math gives each of those
// products its precision. The stream rules, the losses (FitzHugh–Nagumo's
// causal weights, Fredholm's quadrature), the bias sums and Adam stay fp32.
//
// Packed replicas: dgm_train_packed advances N independent runs that share
// the uniforms, the stream layout, the spec's consts, Fredholm's const and
// the lr schedule. p, m, v are [N, n] replica-major, each replica has its
// own scratch (stride scratch_floats), and the loss history is [N, K]. A
// step is the same launch sequence as one run's, each launch with N times
// the blocks: the replica is the grid's y index (elementwise kernels), z
// (the products) or x (the loss kernels, one block per replica). Every
// kernel moves its pointers to its replica's copy and then runs the
// single-replica code, so replica r of a packed call equals a one-replica
// call on r's state bit for bit. A single run (fused_dgm_chunk) is the
// packed call at N = 1.
//
// Row layout of every [R·B, width] activation: stream s, batch row b at row
// s·B + b (fused_dgm.<Spec>.groups order: per group the value row, then its
// first-order tangents). The input width D is 1 for both specs.
//
// The sweep mode (engine_train.cu's, through fused_step.cuh): a batch mask
// takes collocation rows only (Fredholm's node rows never), FitzHugh–
// Nagumo's masked loss is the plain one over the bs live rows, and a
// replica past its budget returns at the entry of its input, gemm, loss,
// output-backward and weight-gradient blocks (the elementwise stream
// kernels still run, on its stale rows, whose results nothing reads).
#include <cmath>

#include "common.cuh"
#include "fused_step.cuh"

namespace {

using dednn::aligned16;
using dednn::blocks;
using dednn::Consts;
using dednn::cp_async16;
using dednn::cp_async4;
using dednn::cp_async_commit;
using dednn::cp_async_wait;
using dednn::kMaxConsts;
using dednn::kSMs;
using dednn::launch;
using dednn::Layout;
using dednn::load_frag;
using dednn::Schedule;
using dednn::StepArgs;
using dednn::Streams;
using dednn::weight_grad_kernel;
using dednn::wg_smem_bytes;
using dednn::write_args;

constexpr int kMaxStreams = 32;  // bits of Layout::value_mask
constexpr int kEwThreads = 128;  // elementwise kernels
constexpr int kLossThreads = 1024;
constexpr int kOutThreads = 256;

enum SpecId : int { kFitzHughNagumo = 0, kFredholm = 1 };

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
// Staging
// ---------------------------------------------------------------------------

// Copies a rows × cols tile (cols a multiple of 4) from src (row stride
// ld) into dst (row stride ld_dst, a multiple of 4), by all kThreads threads;
// element (r, c) counts only where ok(r, c) (else 0). With vec, four floats
// per cp.async (src and ld 16-byte aligned, ok the same for each four).
template <int kThreads, int kRowsT, int kCols, class Ok>
__device__ __forceinline__ void stage_tile(float* dst, int ld_dst,
                                           const float* src, size_t ld,
                                           bool vec, Ok ok) {
  if (vec) {
    constexpr int kChunks = kRowsT * kCols / 4;
#pragma unroll
    for (int it = 0; it < (kChunks + kThreads - 1) / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (kChunks % kThreads != 0 && e >= kChunks) break;
      const int r = e / (kCols / 4), c = 4 * (e - r * (kCols / 4));
      const bool valid = ok(r, c);
      cp_async16(dst + r * ld_dst + c, valid ? src + r * ld + c : src, valid);
    }
  } else {
    constexpr int kElems = kRowsT * kCols;
#pragma unroll 4
    for (int it = 0; it < (kElems + kThreads - 1) / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      if (kElems % kThreads != 0 && e >= kElems) break;
      const int r = e / kCols, c = e - r * kCols;
      const bool valid = ok(r, c);
      cp_async4(dst + r * ld_dst + c, valid ? src + r * ld + c : src, valid);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

// Thread (b, j): X's rows of batch point b (written once, by j == 0), the
// input layer's pre-activation pre = X·w_in + mask·b_in and s0 = its stream
// activation, at column j, for step base + j_step's uniforms. Replica
// blockIdx.y: weights at y·ps, outputs at y·ss (the uniforms and the const
// are shared). kBf16: x and w_in enter the product rounded to bf16 (X is
// written unrounded).
template <bool kBf16>
__global__ void input_kernel(int spec, const StepArgs* __restrict__ args,
                             int j_step, bool sweep, Layout lay,
                             size_t w_in_off,
                             size_t b_in_off, int H, int act,
                             float* __restrict__ X, float* __restrict__ pre,
                             float* __restrict__ s0, size_t ss, size_t ps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= lay.B * H || dednn::gated(args, sweep, blockIdx.y, j_step))
    return;
  const size_t so = blockIdx.y * ss, po = blockIdx.y * ps;
  const float* u =
      args->u + static_cast<size_t>(args->base + j_step) * lay.B;
  const float* cnst = args->cnst;
  const Consts c = args->c;
  const float* w_in = args->p + po + w_in_off;
  const float* b_in = args->p + po + b_in_off;
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
    // The product written out in each branch, so that the value row's
    // contracts into one FMA with the bias, as it always has.
    const float xo = dednn::operand<kBf16>(x);
    const float wo = dednn::operand<kBf16>(w_in[j]);
    if (lay.is_value(s)) {
      const float z = xo * wo + b_in[j];
      a = act_value(act, z);
      d = act_slope(act, z, a);
      pre[i] = z;
      s0[i] = a;
    } else {
      const float z = xo * wo;
      pre[i] = z;
      s0[i] = d * z;
    }
  }
}

// C[n, m] = Σ_k A[n, k]·W'[k, m] over the N = R·B rows, W' = W ([K, M]) or
// Wᵀ (W [M, K]), W at w_off in the replica's parameters; then + x[n]·u[m]
// (the D = 1 input's term, u at u_off) and + bias[m] on value rows (at
// b_off; an offset < 0 is an absent operand), or addend[n, m] + the sum.
// Block of (BM/TM)·(BN/TN) threads owns a BM × BN tile, each thread TM × TN
// outputs, each output one fmaf chain over k in order from 0. k-tiles of BK
// are staged as they lie in memory (A [n][k]; W [k][m] or Wᵀ's rows [m][k])
// by cp.async, 16 bytes at a time where the block's operands are aligned,
// into a ring of kStages buffers, kStages − 1 tiles in flight while one is
// multiplied four k at a time from float4 reads. Replica blockIdx.z: A, x,
// addend and C at z·ss; the parameters at z·ps; a replica past its step
// budget at call step base + j returns at entry (fused_step.cuh's gated).
//
// kBf16 (the "default" precision): the same staging, but the block's warps
// split its BM × BN tile into m16n8 tiles on the tensor cores (mma_bf16.cuh)
// over the k-tiles in order, 16 k at a time, the operands rounded to bf16
// as they are read from the ring; the sums then pass through the freed
// ring to the threads' TM × TN outputs, whose epilogue is the fp32 one with
// x and u rounded to bf16 (x·U is a product the JAX step math gives
// precision).
template <bool kTransW, int BM, int BN, int TM, int TN, int BK, int kStages,
          bool kBf16 = false>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    gemm_kernel(const float* __restrict__ A,
                const StepArgs* __restrict__ args, int j, bool sweep,
                long long w_off, int N, int K, int M,
                const float* __restrict__ x, long long u_off,
                long long b_off, Layout lay,
                const float* __restrict__ addend, float* __restrict__ C,
                size_t ss, size_t ps) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  constexpr int kColThreads = BN / TN;
  constexpr int kWRows = kTransW ? BN : BK, kWCols = kTransW ? BK : BN;
  static_assert(BK % 4 == 0 && BN % 4 == 0 && TN % 4 == 0, "float4 tiles");
  __shared__ __align__(16) float a_s[kStages][BM][BK + 4];
  __shared__ __align__(16) float w_s[kStages][kWRows][kWCols + 4];
  if (dednn::gated(args, sweep, blockIdx.z, j)) return;
  const size_t so = blockIdx.z * ss;
  const float* P = args->p + blockIdx.z * ps;
  const float* W = P + w_off;
  const float* u = u_off < 0 ? nullptr : P + u_off;
  const float* bias = b_off < 0 ? nullptr : P + b_off;
  A += so;
  x = dednn::shift(x, so);
  addend = dednn::shift(addend, so);
  C += so;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * BN;
  const int tiles = (K + BK - 1) / BK;
  const bool vec = K % 4 == 0 && M % 4 == 0 && aligned16(A) && aligned16(W);
  // The thread's columns: TN adjacent ones (float4 reads of W's rows), or,
  // for Wᵀ, every kColThreads-th (its rows in shared memory then fall in
  // distinct banks).
  auto col = [&](int jj) {
    return kTransW ? tx + kColThreads * jj : tx * TN + jj;
  };

  // k-tile t into its buffer; every call commits one group.
  auto load = [&](int t) {
    if (t < tiles) {
      const int buf = t % kStages, k0 = t * BK;
      stage_tile<kThreads, BM, BK>(
          &a_s[buf][0][0], BK + 4, A + static_cast<size_t>(n0) * K + k0, K,
          vec, [&](int r, int c) { return n0 + r < N && k0 + c < K; });
      if (kTransW)
        stage_tile<kThreads, BN, BK>(
            &w_s[buf][0][0], BK + 4, W + static_cast<size_t>(m0) * K + k0,
            K, vec, [&](int r, int c) { return m0 + r < M && k0 + c < K; });
      else
        stage_tile<kThreads, BK, BN>(
            &w_s[buf][0][0], BN + 4, W + static_cast<size_t>(k0) * M + m0,
            M, vec, [&](int r, int c) { return k0 + r < K && m0 + c < M; });
    }
    cp_async_commit();
  };

  float acc[TM][TN] = {};
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  if constexpr (kBf16) {
    constexpr int kWarps = kThreads / 32, kLdC = BN + 4;
    static_assert(kThreads % 32 == 0 && BK % 16 == 0, "whole warps, k16");
    static_assert(kStages * BM * (BK + 4) >= BM * kLdC,
                  "the C tile fits the ring");
    using Tiles = dednn::MmaTiles<BM, BN, kWarps>;
    const int warp = tid / 32;
    float d[Tiles::kPer][4] = {};
    auto tile_of = [&](int i, int& tr, int& tc) {
      const int tile = warp + i * kWarps;
      tr = tile / Tiles::kNT * 16;
      tc = tile % Tiles::kNT * 8;
      return tile < Tiles::kTiles;
    };
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<kStages - 2>();  // tile t has landed
      __syncthreads();               // and every thread is done with t − 1
      load(t + kStages - 1);         // into t − 1's buffer
      const int buf = t % kStages;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16)
#pragma unroll
        for (int i = 0; i < Tiles::kPer; ++i) {
          int tr, tc;
          if (!tile_of(i, tr, tc)) continue;
          unsigned fa[4], fb[2];
          dednn::frag_a(
              [&](int r, int k) { return a_s[buf][tr + r][kk + k]; }, fa);
          if constexpr (kTransW)
            dednn::frag_b(
                [&](int k, int n) { return w_s[buf][tc + n][kk + k]; }, fb);
          else
            dednn::frag_b(
                [&](int k, int n) { return w_s[buf][kk + k][tc + n]; }, fb);
          dednn::mma_bf16(d[i], fa, fb);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    float* c_s = &a_s[0][0][0];
#pragma unroll
    for (int i = 0; i < Tiles::kPer; ++i) {
      int tr, tc;
      if (!tile_of(i, tr, tc)) continue;
      dednn::frag_c(d[i], [&](int r, int n, float v) {
        c_s[(tr + r) * kLdC + tc + n] = v;
      });
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj)
        acc[i][jj] = c_s[(ty * TM + i) * kLdC + col(jj)];
  } else {
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every thread is done with t − 1
    load(t + kStages - 1);         // into t − 1's buffer
    const int buf = t % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float a4[TM][4], w4[4][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_frag<4>(&a_s[buf][ty * TM + i][kk], a4[i]);
      if (kTransW) {
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) {
          float c4[4];
          load_frag<4>(&w_s[buf][col(jj)][kk], c4);
#pragma unroll
          for (int q = 0; q < 4; ++q) w4[q][jj] = c4[q];
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) load_frag<TN>(&w_s[buf][kk + q][tx * TN], w4[q]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int jj = 0; jj < TN; ++jj)
            acc[i][jj] = fmaf(a4[i][q], w4[q][jj], acc[i][jj]);
    }
  }
  }
  // The epilogue's operands are all loaded before the first store, so
  // they are in flight together (a store to C could alias them).
  float xv[TM], uv[TN], bv[TN], ad[TM][TN];
  bool value[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + ty * TM + i;
    value[i] = n < N && lay.is_value(n / lay.B);
    xv[i] = u != nullptr && n < N ? dednn::operand<kBf16>(x[n]) : 0.0f;
  }
#pragma unroll
  for (int jj = 0; jj < TN; ++jj) {
    const int m = m0 + col(jj);
    uv[jj] = u != nullptr && m < M ? dednn::operand<kBf16>(u[m]) : 0.0f;
    bv[jj] = bias != nullptr && m < M ? bias[m] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int n = n0 + ty * TM + i, m = m0 + col(jj);
      ad[i][jj] = addend != nullptr && n < N && m < M
                      ? addend[static_cast<size_t>(n) * M + m]
                      : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + ty * TM + i;
    if (n >= N) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int m = m0 + col(jj);
      if (m >= M) continue;
      float out = acc[i][jj];
      if (u != nullptr) out = out + xv[i] * uv[jj];
      if (bias != nullptr && value[i]) out = out + bv[jj];
      if (addend != nullptr) out = ad[i][jj] + out;
      C[static_cast<size_t>(n) * M + m] = out;
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
// fixed order. kBf16: S and w_out enter the products rounded to bf16.
template <bool kBf16>
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
      for (int k = lane; k < H; k += 32)
        acc = fmaf(dednn::operand<kBf16>(row[k]),
                   dednn::operand<kBf16>(w_out[k * O + o]), acc);
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
// mean((s(0) − y_ic)²) over [B, 2]. aux: 5B floats. The loss goes to the
// replica's slot of call step base + j.
template <bool kBf16>
__global__ void fn_loss_kernel(const float* __restrict__ S, int H,
                               const StepArgs* __restrict__ args, int j,
                               bool sweep, size_t w_out_off, size_t b_out_off,
                               Layout lay,
                               float* out, float* G, float* aux, size_t ss,
                               size_t ps) {
  if (dednn::gated(args, sweep, blockIdx.x, j)) return;
  const size_t so = blockIdx.x * ss, po = blockIdx.x * ps;
  S += so;
  out += so;
  G += so;
  aux += so;
  const float* w_out = args->p + po + w_out_off;
  const float* b_out = args->p + po + b_out_off;
  float* loss = args->losses + blockIdx.x * args->ls + args->base + j;
  const Consts c = args->c;
  output_layer<kBf16>(S, H, w_out, b_out, 2, lay, out);
  const int B = lay.B;
  const float t_max_over_b = c.c[1], i_ext = c.c[3];
  const float alpha = c.c[4], beta = c.c[5], tau = c.c[6], y_ic = c.c[7];
  // Under a batch mask bs (live > 0) rows past bs contribute nothing, the
  // causal weights are 1, and both sums are scaled by 1/(2·bs): the loss
  // Σ(r_y² + r_w²)/bs + Σ(e_y² + e_w²)/(2·bs), which at bs = B is the
  // unmasked loss (the JAX kernel's masked branch scales the IC sum by
  // 1/bs, twice its unmasked weight: fused_dgm.py:363-364).
  const int live = dednn::live_batch(args, sweep, blockIdx.x);
  const float eps = live > 0 ? 0.0f : c.c[2];
  const float inv_2b = 1.0f / static_cast<float>(2 * (live > 0 ? live : B));
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
    const float keep = live > 0 && i >= live ? 0.0f : 1.0f;
    const float scale = live > 0 ? inv_2b * keep : inv_2b;
    const float y = out[2 * i];
    const float r0 = r0s[i], r1 = r1s[i], wi = wgt[i];
    const float e0 = out[2 * (2 * B + i)] - y_ic;
    const float e1 = out[2 * (2 * B + i) + 1] - y_ic;
    const float rs = wi * (r0 * r0) + wi * (r1 * r1);
    const float is = e0 * e0 + e1 * e1;
    res[i] = live > 0 ? rs * keep : rs;
    ic[i] = live > 0 ? is * keep : is;
    const float q0 = 4.0f * scale * wi * r0, q1 = 4.0f * scale * wi * r1;
    G[2 * i] = q0 * (y * y - 1.0f) - q1 / tau;
    G[2 * i + 1] = q0 + q1 * (beta / tau);
    G[2 * (B + i)] = q0;
    G[2 * (B + i) + 1] = q1;
    G[2 * (2 * B + i)] = 2.0f * scale * e0;
    G[2 * (2 * B + i) + 1] = 2.0f * scale * e1;
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
template <bool kBf16>
__global__ void fredholm_loss_kernel(const float* __restrict__ S, int H,
                                     const StepArgs* __restrict__ args, int j,
                                     bool sweep, size_t w_out_off,
                                     size_t b_out_off,
                                     Layout lay, float* out, float* G,
                                     float* aux, size_t ss, size_t ps) {
  __shared__ float scalars[2];  // I, dL/dI
  if (dednn::gated(args, sweep, blockIdx.x, j)) return;
  const size_t so = blockIdx.x * ss, po = blockIdx.x * ps;
  S += so;
  out += so;
  G += so;
  aux += so;
  const float* w_out = args->p + po + w_out_off;
  const float* b_out = args->p + po + b_out_off;
  const int step = args->base + j;
  float* loss = args->losses + blockIdx.x * args->ls + step;
  const float* u = args->u + static_cast<size_t>(step) * lay.B;
  const float* cnst = args->cnst;
  output_layer<kBf16>(S, H, w_out, b_out, 1, lay, out);
  const int B = lay.B, R = lay.R;
  const float upper = args->c.c[0];
  // Under a batch mask bs (live > 0) collocation rows past bs contribute
  // nothing and the mean runs over bs; the node rows are never masked.
  const int live = dednn::live_batch(args, sweep, blockIdx.x);
  const float inv_b = 1.0f / static_cast<float>(live > 0 ? live : B);
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
    const float keep = live > 0 && i >= live ? 0.0f : 1.0f;
    const float scale = live > 0 ? inv_b * keep : inv_b;
    const float sx = sinf(upper * u[i]);
    const float r = out[i] - sx * (1.0f + integral);
    const float g = 2.0f * r * scale;
    terms[i] = live > 0 ? r * r * keep : r * r;
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

// ds[n, j] = Σ_o G[n, o]·w_out[j, o]; replica blockIdx.y. kBf16: G and
// w_out enter the product rounded to bf16.
template <bool kBf16>
__global__ void out_bwd_kernel(const float* __restrict__ G,
                               const StepArgs* __restrict__ args,
                               int j_step, bool sweep, size_t w_out_off,
                               int N, int H, int O, float* __restrict__ ds,
                               size_t ss, size_t ps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * H || dednn::gated(args, sweep, blockIdx.y, j_step)) return;
  G += blockIdx.y * ss;
  ds += blockIdx.y * ss;
  const float* w_out = args->p + blockIdx.y * ps + w_out_off;
  const int n = idx / H, j = idx - n * H;
  float acc = 0.0f;
  for (int o = 0; o < O; ++o)
    acc = fmaf(dednn::operand<kBf16>(G[n * O + o]),
               dednn::operand<kBf16>(w_out[j * O + o]), acc);
  ds[idx] = acc;
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
         2 * N * O + 5LL * B + 4 * layer + 4LL * L * layer;
}

bool valid(int spec, int R, int O, unsigned value_mask) {
  if (R < 1 || R > kMaxStreams) return false;
  if (spec == kFitzHughNagumo) return R == 3 && value_mask == 5u && O == 2;
  if (spec == kFredholm)
    return R >= 2 && O == 1 &&
           value_mask == (R == 32 ? 0xffffffffu : (1u << R) - 1u);
  return false;
}

// C = A·W' (+ x·u, + bias on value rows, or addend +) for `reps` replicas.
// The tile, chosen from timings of the candidates at FitzHugh–Nagumo's
// shapes on the H100: 64 × 64 (8 × 4 outputs per thread) while that still
// gives three blocks per SM, else 32 × 32 (2 × 4) while one per SM, else
// 16 × 32 (2 × 4), whose more blocks win where the card is underfilled.
// kBf16: the "default" precision's instance of the same tile.
template <bool kT, bool kBf16 = false>
void gemm(const float* A, const StepArgs* args, int j, bool sweep,
          long long w_off, int N, int K, int M, const float* x,
          long long u_off, long long b_off, const Layout& lay,
          const float* addend, float* C, size_t ss, size_t ps, int reps,
          cudaStream_t stream) {
  if (blocks(N, M, 64, 64, reps) >= 3 * kSMs)
    launch(gemm_kernel<kT, 64, 64, 8, 4, 16, 4, kBf16>, 128, 0, 64, 64, N, M,
           reps, stream, A, args, j, sweep, w_off, N, K, M, x, u_off, b_off,
           lay, addend, C, ss, ps);
  else if (blocks(N, M, 32, 32, reps) >= kSMs)
    launch(gemm_kernel<kT, 32, 32, 2, 4, 32, 4, kBf16>, 128, 0, 32, 32, N, M,
           reps, stream, A, args, j, sweep, w_off, N, K, M, x, u_off, b_off,
           lay, addend, C, ss, ps);
  else
    launch(gemm_kernel<kT, 16, 32, 2, 4, 32, 4, kBf16>, 64, 0, 16, 32, N, M,
           reps, stream, A, args, j, sweep, w_off, N, K, M, x, u_off, b_off,
           lay, addend, C, ss, ps);
}

// The weight-gradient instances, largest first (chosen as the gemm's):
// 32 × 64 tiles (4 × 4 per thread, 32-row chunks, one
// stream at a time; kWg[0]) while that gives two blocks per SM; 32 × 32
// (4 × 2, 16-row chunks, three streams at a time in three thread groups;
// kWg[1]) while one per SM; else 16 × 16 (2 × 2, three groups; kWg[2]).
struct WgConfig {
  int tile_k, tile_m, threads, min_blocks;
  size_t smem;
};
constexpr WgConfig kWg[3] = {
    {32, 64, 128, 2 * kSMs, wg_smem_bytes<32, 64, 32, 3, 1>()},
    {32, 32, 384, kSMs, wg_smem_bytes<32, 32, 16, 4, 3>()},
    {16, 16, 192, 0, wg_smem_bytes<16, 16, 16, 4, 3>()}};

template <bool kAdam, bool kBf16>
auto wg_kernel(int config) {
  return config == 0
             ? weight_grad_kernel<kAdam, 32, 64, 4, 4, 32, 3, 1, kBf16>
         : config == 1
             ? weight_grad_kernel<kAdam, 32, 32, 4, 2, 16, 4, 3, kBf16>
             : weight_grad_kernel<kAdam, 16, 16, 2, 2, 16, 4, 3, kBf16>;
}

// Lets the weight-gradient instances of one precision take their dynamic
// shared memory (above the default 48 KB); before any launch or capture.
template <bool kBf16>
cudaError_t prepare() {
  for (int c = 0; c < 3; ++c) {
    cudaError_t err =
        dednn::allow_smem(wg_kernel<true, kBf16>(c), kWg[c].smem);
    if (err == cudaSuccess)
      err = dednn::allow_smem(wg_kernel<false, kBf16>(c), kWg[c].smem);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// One layer's weight gradient (and Adam, kAdam) for `reps` replicas, with
// the first instance of kWg that gets its blocks (kBf16: its "default"
// instance).
template <bool kAdam, bool kBf16>
void weight_grad(const float* A, int KA, const float* x, const float* dz,
                 int M, const Layout& lay, const StepArgs* args, int j,
                 bool sweep, long long w_off, long long u_off,
                 long long b_off, size_t ss, size_t ps, int reps,
                 cudaStream_t stream) {
  int c = 0;
  while (blocks(KA, M, kWg[c].tile_k, kWg[c].tile_m, reps) <
         kWg[c].min_blocks)
    ++c;
  launch(wg_kernel<kAdam, kBf16>(c), kWg[c].threads, kWg[c].smem,
         kWg[c].tile_k,
         kWg[c].tile_m, KA, M, reps, stream, A, KA, x, dz, M, lay, args, j,
         sweep, w_off, u_off, b_off, ss, ps);
}

// Enqueue call step base + j of `reps` replicas: the forward, the loss into
// its slot, and the backward, each layer's weights updated by Adam after
// their last read in the step (kAdam), or the gradient written to
// args->grad. Replica r's scratch is at scratch + r·scratch_floats; each
// layer's dh_pre and dzgr_pre have their own buffers, so that a layer's
// weight gradient on the side stream reads them while the data path goes on.
// kBf16: every launch's "default" instance.
template <bool kAdam, bool kBf16>
cudaError_t enqueue_step(int spec, const StepArgs* args, int j, bool sweep,
                         float* scratch, int reps, const Layout& lay, int H,
                         int L, int O, int act, Streams& st) {
  const int R = lay.R, B = lay.B, N = R * B;
  const size_t layer = static_cast<size_t>(N) * H;
  const size_t n = n_params(H, L, O);
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
  float* DS = AUX + 5 * B;               // [N, H] cotangent of the state
  float* DSP = DS + layer;               // [N, H] of the previous state
  float* DSR = DSP + layer;              // [N, H] of s ⊙ R
  float* D0 = DSR + layer;               // [N, H] of the input layer's pre
  float* DHP = D0 + layer;               // [L][N, H] of h_pre
  float* DZ = DHP + L * layer;           // [L][N, 3H] of the gates' pre-acts
  const long long none = -1;
  const cudaStream_t main = st.main;
  cudaStream_t side;

  const dim3 ew(dednn::ceil_div(B * H, kEwThreads), reps);
  input_kernel<kBf16><<<ew, kEwThreads, 0, main>>>(
      spec, args, j, sweep, lay, off.w_in, off.b_in, H, act, X, PRE, ST, ss,
      n);
  for (int l = 0; l < L; ++l) {
    const float* S = ST + l * layer;
    float* Z = ZG + 3 * l * layer;
    float* Hh = HP + l * layer;
    float* SRl = SR + l * layer;
    const long long lw3 = static_cast<long long>(l) * 3 * H;
    const long long lw = static_cast<long long>(l) * H;
    gemm<false, kBf16>(S, args, j, sweep, off.Wzgr + lw3 * H, N, H, 3 * H, X,
                       off.Uzgr + lw3, off.bzgr + lw3, lay, nullptr, Z, ss, n,
                       reps, main);
    gate_fwd_kernel<<<ew, kEwThreads, 0, main>>>(Z, S, lay, H, act, SRl, ss);
    gemm<false, kBf16>(SRl, args, j, sweep, off.Wh + lw * H, N, H, H, X,
                       off.Uh + lw, off.bh + lw, lay, nullptr, Hh, ss, n,
                       reps, main);
    state_fwd_kernel<<<ew, kEwThreads, 0, main>>>(Z, Hh, S, lay, H, act,
                                                  ST + (l + 1) * layer, ss);
  }
  const float* S_L = ST + L * layer;
  if (spec == kFitzHughNagumo) {
    fn_loss_kernel<kBf16><<<reps, kLossThreads, 0, main>>>(
        S_L, H, args, j, sweep, off.w_out, off.b_out, lay, OUT, G, AUX, ss, n);
  } else {
    fredholm_loss_kernel<kBf16><<<reps, kLossThreads, 0, main>>>(
        S_L, H, args, j, sweep, off.w_out, off.b_out, lay, OUT, G, AUX, ss, n);
  }

  out_bwd_kernel<kBf16><<<dim3(dednn::ceil_div(N * H, kOutThreads), reps),
                          kOutThreads, 0, main>>>(G, args, j, sweep,
                                                  off.w_out, N, H, O, DS, ss,
                                                  n);
  cudaError_t err = st.branch(&side);
  if (err != cudaSuccess) return err;
  weight_grad<kAdam, kBf16>(S_L, H, nullptr, G, O, lay, args, j, sweep,
                            off.w_out, none, off.b_out, ss, n, reps, side);
  for (int l = L - 1; l >= 0; --l) {
    const float* S = ST + l * layer;
    const float* Z = ZG + 3 * l * layer;
    const float* Hh = HP + l * layer;
    const float* SRl = SR + l * layer;
    float* DHPl = DHP + l * layer;
    float* DZl = DZ + 3 * l * layer;
    const long long lw3 = static_cast<long long>(l) * 3 * H;
    const long long lw = static_cast<long long>(l) * H;
    gate_bwd1_kernel<<<ew, kEwThreads, 0, main>>>(DS, S, Z, Hh, lay, H, act,
                                                  DHPl, DZl, DSP, ss);
    gemm<true, kBf16>(DHPl, args, j, sweep, off.Wh + lw * H, N, H, H, nullptr,
                      none, none, lay, nullptr, DSR, ss, n, reps, main);
    err = st.branch(&side);
    if (err != cudaSuccess) return err;
    weight_grad<kAdam, kBf16>(SRl, H, X, DHPl, H, lay, args, j, sweep,
                              off.Wh + lw * H, off.Uh + lw, off.bh + lw, ss,
                              n, reps, side);
    gate_bwd2_kernel<<<ew, kEwThreads, 0, main>>>(DSR, S, Z, lay, H, act,
                                                  DSP, DZl, ss);
    gemm<true, kBf16>(DZl, args, j, sweep, off.Wzgr + lw3 * H, N, 3 * H, H,
                      nullptr, none, none, lay, DSP, DS, ss, n, reps, main);
    err = st.branch(&side);
    if (err != cudaSuccess) return err;
    weight_grad<kAdam, kBf16>(S, H, X, DZl, 3 * H, lay, args, j, sweep,
                              off.Wzgr + lw3 * H, off.Uzgr + lw3,
                              off.bzgr + lw3, ss, n, reps, side);
  }
  input_bwd_kernel<<<ew, kEwThreads, 0, main>>>(DS, PRE, lay, H, act, D0,
                                                ss);
  err = st.branch(&side);
  if (err != cudaSuccess) return err;
  weight_grad<kAdam, kBf16>(X, 1, nullptr, D0, H, lay, args, j, sweep,
                            off.w_in, none, off.b_in, ss, n, reps, side);
  err = st.merge();
  return err != cudaSuccess ? err : cudaGetLastError();
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

}  // namespace

// Floats of scratch one replica needs at R streams of B rows (D = 1).
extern "C" long long dgm_scratch_floats(int R, int B, int H, int L, int O) {
  return scratch_floats(R, B, H, L, O);
}

// The most stream rows per batch point the kernels hold.
extern "C" int dgm_max_streams() { return kMaxStreams; }

// Bytes of the device argument block (StepArgs) every entry point takes.
extern "C" int dgm_args_bytes() { return sizeof(StepArgs); }

// One step's loss and flat gradient (kernel #7 alone). consts: the spec's
// kMaxConsts numbers, in host memory; cnst: Fredholm's [2(R−1), B] nodes
// and weights on the device (unused by FitzHugh–Nagumo); args: a device
// block of dgm_args_bytes(); bf16: the "default" precision's instances
// (else "highest"), here and below.
extern "C" int dgm_grad(int spec, const float* consts, const float* cnst,
                        const float* p, const float* u, float* scratch,
                        float* grad, float* loss, void* args, int R, int B,
                        int H, int L, int O, int act, unsigned value_mask,
                        int bf16, void* stream) {
  if (!valid(spec, R, O, value_mask)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StepArgs* dev = static_cast<StepArgs*>(args);
  const StepArgs a = host_args(consts, cnst, const_cast<float*>(p), nullptr,
                               nullptr, u, loss, 0, grad);
  const Layout lay{R, B, value_mask};
  return dednn::with_precision(bf16, [&](auto prec) -> int {
    constexpr bool kBf16 = decltype(prec)::value;
    cudaError_t err = prepare<kBf16>();
    if (err == cudaSuccess) err = write_args(dev, a, st);
    if (err != cudaSuccess) return err;
    Streams one{st, {st, st}, nullptr, nullptr};
    return enqueue_step<false, kBf16>(spec, dev, 0, false, scratch, 1, lay, H,
                                      L, O, act, one);
  });
}

// Capture S training steps of N packed replicas as one CUDA graph
// (dednn::capture_steps) and instantiate it into *exec. The graph holds the
// scratch and argument-block pointers and the shape: it serves every call
// of that shape whose per-call values come through args (dgm_train_packed
// writes them); sweep != 0: its launches read the sweep mode's fields, and
// it serves the calls in that mode alone.
extern "C" int dgm_graph_build(int spec, int R, int B, int H, int L, int O,
                               int act, unsigned value_mask, int N, int bf16,
                               int S, int sweep, void* args, float* scratch,
                               void** exec) {
  *exec = nullptr;
  if (!valid(spec, R, O, value_mask) || S < 1) return cudaErrorInvalidValue;
  const Layout lay{R, B, value_mask};
  StepArgs* dev = static_cast<StepArgs*>(args);
  return dednn::with_precision(bf16, [&](auto prec) -> int {
    constexpr bool kBf16 = decltype(prec)::value;
    const cudaError_t err = prepare<kBf16>();
    if (err != cudaSuccess) return err;
    return dednn::capture_steps(
        dev, S,
        [&](int j, Streams& st) {
          return enqueue_step<true, kBf16>(spec, dev, j, sweep != 0, scratch,
                                           N, lay, H, L, O, act, st);
        },
        exec);
  });
}

extern "C" int dgm_graph_free(void* exec) { return dednn::free_graph(exec); }

// K Adam steps of N packed replicas (kernel #5 around #7): p, m, v [N, n]
// updated in place, losses [N, K]; the uniforms [K, B], the layout, the
// consts, cnst and the schedule are shared. scratch (N·dgm_scratch_floats)
// and args (dgm_args_bytes) are the ones exec was built with, if exec is
// not null: then ⌊K/S⌋ replays of its S steps on `stream`, and the other K
// mod S steps as the same launches from here, the weight gradients on side0
// and side1 (all K, without exec). *step_math_runs
// (host memory) is set to the number of replica-steps whose step math was
// enqueued. N above the grid's 65 535 is refused. The sweep mode
// (StepArgs::lr_vec, bs_vec, steps_vec, trial_horizon; device vectors of
// N, or nullptr) rides the argument block, so one graph captured in that
// mode serves every trial; a call is in it when lr_vec and steps_vec are
// given (bs_vec too, or not: no mask), and exec must then have been
// captured with sweep != 0.
extern "C" int dgm_train_packed(int spec, const float* consts,
                                const float* cnst, float* p, float* m,
                                float* v, const float* u, float* scratch,
                                float* losses, void* args, void* exec, int S,
                                int N, int K, int R, int B, int H, int L,
                                int O, int act, unsigned value_mask,
                                int bf16, float lr, int step0, int schedule,
                                float horizon,
                                float decay, float half_span, float log_decay,
                                const float* lr_vec, const int* bs_vec,
                                const int* steps_vec, int trial_horizon,
                                int* step_math_runs, void* stream,
                                void* side0, void* side1) {
  *step_math_runs = 0;
  if (!valid(spec, R, O, value_mask)) return cudaErrorInvalidValue;
  if (N < 1 || N > dednn::kMaxGridYZ) return cudaErrorInvalidValue;
  if (exec != nullptr && S < 1) return cudaErrorInvalidValue;
  const Layout lay{R, B, value_mask};
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
  return dednn::with_precision(bf16, [&](auto prec) -> int {
    constexpr bool kBf16 = decltype(prec)::value;
    cudaError_t err = prepare<kBf16>();
    if (err == cudaSuccess) err = write_args(dev, a, st);
    if (err != cudaSuccess) return err;
    return dednn::run_steps(
        exec, S, K, N, st, static_cast<cudaStream_t>(side0),
        static_cast<cudaStream_t>(side1),
        [&](int j, Streams& two) {
          return enqueue_step<true, kBf16>(spec, dev, j, sweep, scratch, N,
                                           lay, H, L, O, act, two);
        },
        step_math_runs);
  });
}

// The forward product of the training step at [rows, K]·[K, M] (trans = 0)
// or its backward [rows, K]·[M, K]ᵀ (trans = 1), for `replicas` replicas:
// A and C at stride ss, W at stride K·M, through the tile the step picks;
// `launches` launches back to back (the timing of kernels/profile.py
// --probe). args: a device block of dgm_args_bytes().
extern "C" int dgm_gemm_probe(int trans, const float* A, const float* W,
                              float* C, void* args, int rows, int K, int M,
                              int replicas, long long ss, int launches,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  StepArgs* dev = static_cast<StepArgs*>(args);
  StepArgs a{};
  a.p = const_cast<float*>(W);
  cudaError_t err = write_args(dev, a, st);
  if (err != cudaSuccess) return err;
  const Layout lay{1, rows, 1u};
  const size_t ps = static_cast<size_t>(K) * M;
  for (int i = 0; i < launches; ++i) {
    if (trans)
      gemm<true>(A, dev, 0, false, 0, rows, K, M, nullptr, -1, -1, lay,
                 nullptr, C, ss, ps, replicas, st);
    else
      gemm<false>(A, dev, 0, false, 0, rows, K, M, nullptr, -1, -1, lay,
                  nullptr, C, ss, ps, replicas, st);
  }
  return cudaGetLastError();
}
