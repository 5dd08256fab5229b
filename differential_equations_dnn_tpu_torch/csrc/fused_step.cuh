// What the two fused engines' training steps share (csrc/engine_train.cu,
// the MLP engine; csrc/dgm_train.cu, the DGM engine): the device argument
// block a captured step reads its per-call values from, the cp.async
// staging and register-fragment helpers of their products, the weight
// gradient that sums every stream of its tile in one block and applies Adam
// in its epilogue, the two side streams the weight gradients run on, and
// the capture and replay of S steps as one CUDA graph.
//
// As adam.cuh, everything sits in an unnamed namespace: each source that
// includes this header compiles its own instance from this one definition.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "adam.cuh"
#include "common.cuh"
#include "mma_bf16.cuh"

namespace dednn {
namespace {

constexpr int kMaxConsts = 8;
constexpr int kSMs = 132;  // H100 SXM: a launch of fewer blocks idles SMs

// The spec's numbers (fused_engine.<Spec>.kernel_consts,
// fused_dgm.<Spec>.kernel_consts).
struct Consts {
  float c[kMaxConsts];
};

// R stream rows per batch point; bit s of value_mask is set for a value
// row, and the tangent rows of a group follow its value row. Stream s reads
// bit s mod 32: a layout of more than 32 streams (the MLP engine's folded
// groups, all value rows) sets every bit.
struct Layout {
  int R, B;
  unsigned value_mask;
  __device__ bool is_value(int s) const {
    return (value_mask >> (s & 31)) & 1u;
  }
};

// What a call changes, in device memory (one copy per call), so that a
// captured step serves every call of its shape. Step j of a launch is the
// call's step base + j.
struct StepArgs {
  float* p;            // [N, n] parameters
  float* m;            // [N, n] Adam moments (training)
  float* v;
  const float* u;      // [K, B, n_uniform] uniforms
  float* losses;       // loss of replica r, call step k at r·ls + k
  float* grad;         // one step's gradient: the [n] gradient
  const float* cnst;   // the call's const operand: the DGM engine's
                       // Fredholm nodes and weights, the MLP engine's
                       // Volterra nodes or inverse-heat observations
  long long ls;
  int step0;           // absolute index of the call's first step
  int base;            // the call's steps before this replay
  float lr;
  Schedule sched;
  Consts c;
  // The sweep mode's per-replica values (engine_core.py:60-64, :233-237 of
  // the JAX package), read only by the launches of a sweep-mode step (the
  // kernels' `sweep` argument; null outside it, lr_vec and steps_vec both
  // set in it): replica r's lr; its batch bs[r] (rows b >= bs[r] are out
  // of its loss, which is scaled by 1/bs[r]; null: no mask); its step
  // budget (call steps at or past it leave p, m, v and the loss row alone,
  // and its launches return at entry); with trial_horizon, a decaying
  // schedule's horizon is max(budget, 1).
  const float* lr_vec;
  const int* bs_vec;
  const int* steps_vec;
  int trial_horizon;
};

// Each launch of a step takes `sweep` (a kernel argument, so a step outside
// the sweep mode reads none of its fields: a load at every kernel's entry
// cost heat2d's step 5 %) and its call step j. The host sets lr_vec and
// steps_vec in the mode, yet gated and replica_step test them too: without
// those tests the loss and weight-gradient kernels compiled differently
// outside the mode and heat2d's step cost 2.3 % more (kernels/profile.py
// --steady on the H100).

// True if replica r's step budget ends before call step base + j: each of
// its launches of that step returns at entry.
__device__ __forceinline__ bool gated(const StepArgs* args, bool sweep,
                                      int r, int j) {
  return sweep && args->steps_vec != nullptr &&
         args->base + j >= args->steps_vec[r];
}

// Replica r's masked batch bs[r], or 0 outside the masked mode.
__device__ __forceinline__ int live_batch(const StepArgs* args, bool sweep,
                                          int r) {
  return sweep && args->bs_vec != nullptr ? args->bs_vec[r] : 0;
}

// Replica r's Adam scalars at call step base + j: in the sweep mode its own
// lr and, with a trial horizon, its own budget as the decay's horizon.
__device__ __forceinline__ AdamStep replica_step(const StepArgs* args,
                                                 bool sweep, int r, int j) {
  const float t = static_cast<float>(args->step0 + args->base + j + 1);
  if (!sweep) return adam_step(args->lr, t, args->sched);
  Schedule sched = args->sched;
  if (args->trial_horizon != 0 && args->steps_vec != nullptr &&
      sched.kind != 0)
    sched.horizon = fmaxf(static_cast<float>(args->steps_vec[r]), 1.0f);
  return adam_step(args->lr_vec != nullptr ? args->lr_vec[r] : args->lr, t,
                   sched);
}

// ---------------------------------------------------------------------------
// Staging and register tiles
// ---------------------------------------------------------------------------

// One float from global to shared memory, asynchronously (cp.async); zeros
// when !valid (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Four floats, 16-byte aligned at both ends (cp.async.cg: through L2 only);
// zeros when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15u) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// dst = src[0..T) from shared memory, as float4 (or float2) reads.
template <int T>
__device__ __forceinline__ void load_frag(const float* src, float (&dst)[T]) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int i = 0; i < T / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = q.x;
      dst[4 * i + 1] = q.y;
      dst[4 * i + 2] = q.z;
      dst[4 * i + 3] = q.w;
    }
  } else {
    static_assert(T % 2 == 0, "fragments of 2, 4 or 8");
#pragma unroll
    for (int i = 0; i < T / 2; ++i) {
      const float2 q = reinterpret_cast<const float2*>(src)[i];
      dst[2 * i] = q.x;
      dst[2 * i + 1] = q.y;
    }
  }
}

// ---------------------------------------------------------------------------
// The weight gradient (and Adam)
// ---------------------------------------------------------------------------

// The gradient of one layer over all R streams: dW[k, m] = Σ_r A[r, k]·
// dz[r, m] (k < KA; W at w_off), the D = 1 input row dU[m] = Σ_r x[r]·
// dz[r, m] (U at u_off, when x != nullptr) and db[m] = Σ dz[r, m] over the
// value streams (b at b_off); an offset < 0 is an absent tensor.
//
// Block of kGroups groups of (BK/TK)·(BM/TM) threads owns a BK × BM tile of
// (k, m), each thread TK × TM of it; in the blocks of the first k-tile,
// thread t < BM of a group also keeps the bias chain of column t and thread
// BM + t the x-row chain. The streams go kGroups at a time, one per group;
// their rows come kRows at a time through a ring of kStages cp.async
// buffers, kStages − 1 chunks in flight while one is summed. Each stream's
// rows make one fmaf chain per output, in row order from 0; when a round of
// streams ends, the groups' chains pass through shared memory and are added
// to the tile's sums in stream order: sum = s_0, sum += s_1, ... The
// epilogue then walks the tile's sums in memory order, kBatch elements per
// thread at a time (all loads before any store). Rows are staged 16 bytes
// per cp.async where the block's operands are aligned, each thread copying
// the same row slot of every step. kAdam: Adam on p, m,
// v of the replica (blockIdx.z) at step step0 + base + j + 1 (its blocks
// return at entry past its budget: gated); otherwise the gradient to
// args->grad (one replica). Dynamic shared memory:
// wg_smem_bytes<...>().
//
// kBf16 (the "default" precision): the same staging, rounds and epilogue,
// but each group's product runs on the tensor cores (mma_bf16.cuh) with the
// chunk's rows as the reduction: its warps split the BK × BM tile into
// m16n8 tiles (k as rows, m as columns) and accumulate each 16-row step of
// the stream's chunks in order, the operands rounded to bf16 as they are
// read from the ring. The bias chain stays an fp32 sum of dz (the JAX step
// math's jnp.sum); the x-row chain, a product the JAX step math gives
// precision (x·dz over the rows), sums bf16-rounded x and dz in fp32.
template <int BK, int BM, int kRows, int kStages, int kGroups>
constexpr size_t wg_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kStages) * kGroups * kRows *
              ((BK + 4) + (BM + 4) + 1) +
          static_cast<size_t>(kGroups + 1) * (BK * BM + 2 * BM));
}

template <bool kAdam, int BK, int BM, int TK, int TM, int kRows, int kStages,
          int kGroups, bool kBf16 = false>
__global__ void __launch_bounds__(kGroups * (BK / TK) * (BM / TM))
    weight_grad_kernel(const float* __restrict__ A, int KA,
                       const float* __restrict__ x,
                       const float* __restrict__ dz, int M, Layout lay,
                       const StepArgs* __restrict__ args, int j, bool sweep,
                       long long w_off, long long u_off, long long b_off,
                       size_t ss, size_t ps) {
  constexpr int kTile = (BK / TK) * (BM / TM);
  constexpr int kThreads = kGroups * kTile;
  constexpr int kColThreads = BM / TM;
  constexpr int kOut = BK * BM + 2 * BM;  // the W tile, its bias, its x row
  // Epilogue elements per thread and pass: all of them, up to 16.
  constexpr int kBatch = (kOut + kThreads - 1) / kThreads < 16
                             ? (kOut + kThreads - 1) / kThreads
                             : 16;
  static_assert(kTile >= 2 * BM, "a thread per bias and x-row column");
  static_assert(kGroups * kRows <= kThreads, "a thread per row of x");
  if (gated(args, sweep, blockIdx.z, j)) return;
  extern __shared__ __align__(16) float smem[];
  using ATile = float[kGroups][kRows][BK + 4];
  using DTile = float[kGroups][kRows][BM + 4];
  using XTile = float[kGroups][kRows];
  ATile* a_s = reinterpret_cast<ATile*>(smem);
  DTile* d_s = reinterpret_cast<DTile*>(smem + kStages * sizeof(ATile) / 4);
  XTile* x_s = reinterpret_cast<XTile*>(
      smem + kStages * (sizeof(ATile) + sizeof(DTile)) / 4);
  float* red_s = smem + kStages * (sizeof(ATile) + sizeof(DTile) +
                                   sizeof(XTile)) / 4;  // [kGroups][kOut]
  float* tot_s = red_s + kGroups * kOut;                 // [kOut]
  const int tid = threadIdx.x;
  const int g = tid / kTile, lt = tid - g * kTile;
  const int tm = lt % kColThreads, tk = lt / kColThreads;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BK;
  const size_t so = blockIdx.z * ss;
  A += so;
  x = dednn::shift(x, so);
  dz += so;
  const bool first = blockIdx.y == 0;
  const bool with_bias = first && b_off >= 0;
  const bool with_x = first && x != nullptr && u_off >= 0;
  const int col = lt % BM;  // of the bias or x-row chain
  const bool do_bias = with_bias && lt < BM;
  const bool do_x = with_x && lt >= BM && lt < 2 * BM;
  const int B = lay.B, R = lay.R;
  const int per_stream = (B + kRows - 1) / kRows;
  const int n_steps = (R + kGroups - 1) / kGroups * per_stream;

  const bool vec = KA % 4 == 0 && M % 4 == 0 && aligned16(A) && aligned16(dz);

  // Staging: thread tid copies row slot tid mod kSlots (group gg, chunk
  // row rr) of every step, part tid / kSlots of its BK + BM columns, 16
  // bytes per cp.async where aligned (else 4); its slot's destination is
  // fixed, so a step costs it a few address additions.
  constexpr int kSlots = kGroups * kRows;
  constexpr int kParts = kThreads / kSlots;
  const int slot = tid % kSlots, part = tid / kSlots;
  const int sg = slot / kRows, sr = slot - sg * kRows;
  // Step (rho, c) = (round, chunk of each group's stream) into buffer buf;
  // every call commits one group.
  auto load = [&](int buf, int rho, int c, bool live) {
    if (live && part < kParts) {
      const int rows = min(kRows, B - c * kRows);
      const int s = rho * kGroups + sg;
      const bool row_ok = s < R && sr < rows;
      const size_t r = static_cast<size_t>(s) * B + c * kRows + sr;
      const float* a_src = A + r * KA + k0;
      const float* d_src = dz + r * M + m0;
      float* a_dst = &a_s[buf][sg][sr][0];
      float* d_dst = &d_s[buf][sg][sr][0];
      if (vec) {
#pragma unroll 1
        for (int i = 4 * part; i < BK; i += 4 * kParts) {
          const bool ok = row_ok && k0 + i < KA;
          cp_async16(a_dst + i, ok ? a_src + i : A, ok);
        }
#pragma unroll 1
        for (int i = 4 * part; i < BM; i += 4 * kParts) {
          const bool ok = row_ok && m0 + i < M;
          cp_async16(d_dst + i, ok ? d_src + i : dz, ok);
        }
      } else {
#pragma unroll 1
        for (int i = part; i < BK; i += kParts) {
          const bool ok = row_ok && k0 + i < KA;
          cp_async4(a_dst + i, ok ? a_src + i : A, ok);
        }
#pragma unroll 1
        for (int i = part; i < BM; i += kParts) {
          const bool ok = row_ok && m0 + i < M;
          cp_async4(d_dst + i, ok ? d_src + i : dz, ok);
        }
      }
    }
    if (live && with_x && tid < kGroups * kRows) {
      const int rows = min(kRows, B - c * kRows);
      const int gg = tid / kRows, rr = tid - gg * kRows;
      const int s = rho * kGroups + gg;
      const bool ok = s < R && rr < rows;
      cp_async4(&x_s[buf][gg][rr],
                ok ? x + static_cast<size_t>(s) * B + c * kRows + rr : x,
                ok);
    }
    cp_async_commit();
  };
  // The step the next load fetches, as (round, chunk).
  int load_q = 0, load_rho = 0, load_c = 0;
  auto load_next = [&]() {
    load(load_q % kStages, load_rho, load_c, load_q < n_steps);
    ++load_q;
    if (++load_c == per_stream) {
      load_c = 0;
      ++load_rho;
    }
  };

  // The kBf16 product: the group's warps and their m16n8 tiles.
  static_assert(!kBf16 || (kTile % 32 == 0 && kRows % 16 == 0 && BK % 16 == 0),
                "whole warps per group, whole 16-row steps and m-tiles");
  using Tiles = MmaTiles<BK, BM, kBf16 ? kTile / 32 : 1>;
  const int gw = lt / 32;  // the warp within the group
  float dacc[Tiles::kPer][4] = {};
  auto tile_of = [&](int i, int& r0, int& n0) {
    const int tile = gw + i * (kTile / 32);
    r0 = tile / Tiles::kNT * 16;
    n0 = tile % Tiles::kNT * 8;
    return tile < Tiles::kTiles;
  };

  float acc[TK][TM] = {};
  float chain = 0.0f;
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) load_next();
  int rho = 0, c = 0;  // step q's round and chunk
  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait<kStages - 2>();  // step q has landed
    __syncthreads();               // and every thread is done with q − 1
    load_next();                   // step q + kStages − 1, into q − 1's
    const int buf = q % kStages;
    const int s = rho * kGroups + g;
    if (kBf16 && s < R) {
      const int rows = min(kRows, B - c * kRows);
      // Rows past the stream's end were staged as zeros, so every chunk
      // runs whole 16-row steps.
#pragma unroll
      for (int k0r = 0; k0r < kRows; k0r += 16)
#pragma unroll
        for (int i = 0; i < Tiles::kPer; ++i) {
          int r0, n0;
          if (!tile_of(i, r0, n0)) continue;
          unsigned fa[4], fb[2];
          frag_a([&](int r, int k) { return a_s[buf][g][k0r + k][r0 + r]; },
                 fa);
          frag_b([&](int k, int n) { return d_s[buf][g][k0r + k][n0 + n]; },
                 fb);
          mma_bf16(dacc[i], fa, fb);
        }
      if (do_bias || do_x) {
        const float* c_row = &d_s[buf][g][0][col];
        const float* x_row = &x_s[buf][g][0];
        for (int rr = 0; rr < rows; ++rr) {
          const float cd = c_row[rr * (BM + 4)];
          chain = do_x ? fmaf(bf16r(x_row[rr]), bf16r(cd), chain)
                       : chain + cd;
        }
      }
    } else if (!kBf16 && s < R) {
      const int rows = min(kRows, B - c * kRows);
      const float* a_row = &a_s[buf][g][0][tk * TK];
      const float* d_row = &d_s[buf][g][0][tm * TM];
      const float* c_row = &d_s[buf][g][0][col];
      const float* x_row = &x_s[buf][g][0];
      // No branch in the row loop, so rows overlap: the bias chain is
      // fmaf(1, dz, chain), which is chain + dz exactly.
#pragma unroll 4
      for (int rr = 0; rr < rows; ++rr) {
        float af[TK], df[TM];
        load_frag<TK>(a_row + rr * (BK + 4), af);
        load_frag<TM>(d_row + rr * (BM + 4), df);
        const float xr = do_x ? x_row[rr] : 1.0f;
        const float cd = c_row[rr * (BM + 4)];
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int jj = 0; jj < TM; ++jj)
            acc[i][jj] = fmaf(af[i], df[jj], acc[i][jj]);
        chain = fmaf(xr, cd, chain);
      }
    }
    if (c == per_stream - 1) {  // the round's streams end
      float* red = red_s + g * kOut;
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < Tiles::kPer; ++i) {
          int r0, n0;
          if (!tile_of(i, r0, n0)) continue;
          frag_c(dacc[i], [&](int r, int n, float v) {
            red[(r0 + r) * BM + n0 + n] = v;
          });
#pragma unroll
          for (int e = 0; e < 4; ++e) dacc[i][e] = 0.0f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int jj = 0; jj < TM; ++jj) {
            red[(tk * TK + i) * BM + tm * TM + jj] = acc[i][jj];
            acc[i][jj] = 0.0f;
          }
      }
      if (do_bias)
        red[BK * BM + col] = s < R && lay.is_value(s) ? chain : 0.0f;
      if (do_x) red[BK * BM + BM + col] = chain;
      chain = 0.0f;
      __syncthreads();
      for (int e = tid; e < kOut; e += kThreads) {
        float t = rho == 0 ? red_s[e] : tot_s[e] + red_s[e];
        for (int gg = 1; gg < kGroups && rho * kGroups + gg < R; ++gg)
          t = t + red_s[gg * kOut + e];
        tot_s[e] = t;
      }
    }
    if (++c == per_stream) {
      c = 0;
      ++rho;
    }
  }
  __syncthreads();

  const size_t po = blockIdx.z * ps;
  AdamStep step{};
  if (kAdam) step = replica_step(args, sweep, blockIdx.z, j);
  for (int e0 = tid; e0 < kOut; e0 += kBatch * kThreads) {
    long long idx[kBatch];
    float gv[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = e0 + b * kThreads;
      idx[b] = -1;
      gv[b] = 0.0f;
      if (e >= kOut) continue;
      gv[b] = tot_s[e];
      if (e < BK * BM) {
        const int k = k0 + e / BM, m = m0 + e % BM;
        if (k < KA && m < M) idx[b] = w_off + static_cast<long long>(k) * M + m;
      } else {
        const bool bias_row = e < BK * BM + BM;
        const int m = m0 + (bias_row ? e - BK * BM : e - BK * BM - BM);
        if (m < M && (bias_row ? with_bias : with_x))
          idx[b] = (bias_row ? b_off : u_off) + m;
      }
    }
    if (kAdam) {
      float* p = args->p + po;
      float* mo = args->m + po;
      float* vo = args->v + po;
      float pv[kBatch], mv[kBatch], vv[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (idx[b] < 0) continue;
        pv[b] = p[idx[b]];
        mv[b] = mo[idx[b]];
        vv[b] = vo[idx[b]];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (idx[b] < 0) continue;
        dednn::adam_apply(pv[b], mv[b], vv[b], gv[b], step);
        mo[idx[b]] = mv[b];
        vo[idx[b]] = vv[b];
        p[idx[b]] = pv[b];
      }
    } else {
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (idx[b] >= 0) args->grad[idx[b]] = gv[b];
    }
  }
}

// The last node of a captured graph: the call's steps before the next
// replay.
__global__ void advance_kernel(StepArgs* args, int steps) {
  args->base += steps;
}

// ---------------------------------------------------------------------------
// Host side: launches
// ---------------------------------------------------------------------------

// f(std::true_type{}) for the "default" precision's bf16 instances (a C
// entry point's bf16 != 0), else f(std::false_type{}) ("highest").
template <class F>
auto with_precision(int bf16, F&& f) {
  return bf16 != 0 ? f(std::true_type{}) : f(std::false_type{});
}

long long blocks(int rows, int cols, int tile_rows, int tile_cols, int reps) {
  return static_cast<long long>(dednn::ceil_div(rows, tile_rows)) *
         dednn::ceil_div(cols, tile_cols) * reps;
}

// A tiled kernel instance: its tile and launch.
template <class Kernel, class... Args>
void launch(Kernel kernel, int threads, size_t smem, int tile_rows,
            int tile_cols, int rows, int cols, int reps, cudaStream_t stream,
            Args... args) {
  const dim3 grid(dednn::ceil_div(cols, tile_cols),
                  dednn::ceil_div(rows, tile_rows), reps);
  kernel<<<grid, threads, smem, stream>>>(args...);
}

// ---------------------------------------------------------------------------
// Host side: streams, the argument block, graph capture and replay
// ---------------------------------------------------------------------------

// The streams of one step: the data path on `main`, the weight gradients
// (with their Adam updates) on two side streams in turn, each forked once
// its inputs are written and its weights' last read in the step is done,
// all joined back into `main` at the end of the step. Sides equal to main
// run everything in order. In a capture the forks and the joins become the
// graph's branches.
struct Streams {
  cudaStream_t main, side[2];
  cudaEvent_t fork, join;
  int next = 0;  // the side of the next branch

  // The stream of the next weight gradient, made to wait for main's work so
  // far.
  cudaError_t branch(cudaStream_t* out) {
    const cudaStream_t s = side[next];
    next ^= 1;
    *out = s;
    if (s == main) return cudaSuccess;
    const cudaError_t err = cudaEventRecord(fork, main);
    return err != cudaSuccess ? err : cudaStreamWaitEvent(s, fork, 0);
  }
  // main waits for both sides' work so far.
  cudaError_t merge() {
    next = 0;
    for (const cudaStream_t s : side) {
      if (s == main) continue;
      cudaError_t err = cudaEventRecord(join, s);
      if (err == cudaSuccess) err = cudaStreamWaitEvent(main, join, 0);
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
};

// The events of a step's forks and joins (none when the sides are main).
cudaError_t make_streams(cudaStream_t main, cudaStream_t side0,
                         cudaStream_t side1, Streams* st) {
  *st = Streams{main, {side0, side1}, nullptr, nullptr};
  if (side0 == main && side1 == main) return cudaSuccess;
  cudaError_t err = cudaEventCreateWithFlags(&st->fork,
                                             cudaEventDisableTiming);
  if (err == cudaSuccess)
    err = cudaEventCreateWithFlags(&st->join, cudaEventDisableTiming);
  return err;
}

void free_streams(const Streams& st) {
  if (st.fork != nullptr) cudaEventDestroy(st.fork);
  if (st.join != nullptr) cudaEventDestroy(st.join);
}

cudaError_t write_args(StepArgs* dst, const StepArgs& a,
                       cudaStream_t stream) {
  return cudaMemcpyAsync(dst, &a, sizeof(StepArgs), cudaMemcpyHostToDevice,
                         stream);
}

// Capture S training steps, enqueue(j, streams) for j < S, and the advance
// of the argument block's base, as one CUDA graph (on streams of its own:
// the data path and the weight gradients' two branches), and instantiate it
// into *exec. The graph holds the pointers the steps were enqueued with: it
// serves every call whose per-call values come through `args`.
template <class Enqueue>
cudaError_t capture_steps(StepArgs* args, int S, Enqueue enqueue,
                          void** exec) {
  *exec = nullptr;
  cudaStream_t cs = nullptr, side[2] = {nullptr, nullptr};
  Streams st{};
  cudaError_t err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  for (cudaStream_t& s : side)
    if (err == cudaSuccess)
      err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = make_streams(cs, side[0], side[1], &st);
  if (err == cudaSuccess)
    err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    for (int j = 0; j < S && err == cudaSuccess; ++j) err = enqueue(j, st);
    if (err == cudaSuccess) {
      advance_kernel<<<1, 1, 0, cs>>>(args, S);
      err = cudaGetLastError();
    }
    cudaGraph_t graph = nullptr;
    const cudaError_t end = cudaStreamEndCapture(cs, &graph);
    if (err == cudaSuccess) err = end;
    if (err == cudaSuccess) {
      cudaGraphExec_t ge = nullptr;
      err = cudaGraphInstantiateWithFlags(&ge, graph, 0);
      if (err == cudaSuccess) *exec = ge;
    }
    if (graph != nullptr) cudaGraphDestroy(graph);
  }
  free_streams(st);
  for (cudaStream_t s : side)
    if (s != nullptr) cudaStreamDestroy(s);
  if (cs != nullptr) cudaStreamDestroy(cs);
  return err;
}

cudaError_t free_graph(void* exec) {
  return exec == nullptr
             ? cudaSuccess
             : cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// K training steps of N replicas after the call's argument block was
// written on `stream`: ⌊K/S⌋ replays of exec (a capture_steps graph of S
// steps) if it is not null, then the K mod S steps left over (all K,
// without exec) as enqueue(j, streams), the weight gradients on side0 and
// side1. *step_math_runs counts the replica-steps enqueued.
template <class Enqueue>
cudaError_t run_steps(void* exec, int S, int K, int N, cudaStream_t stream,
                      cudaStream_t side0, cudaStream_t side1,
                      Enqueue enqueue, int* step_math_runs) {
  const int replays = exec == nullptr ? 0 : K / S;
  for (int i = 0; i < replays; ++i) {
    const cudaError_t err =
        cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), stream);
    if (err != cudaSuccess) return err;
    *step_math_runs += S * N;
  }
  if (K == replays * S) return cudaGetLastError();
  Streams two{};
  cudaError_t err = make_streams(stream, side0, side1, &two);
  for (int j = 0; j < K - replays * S && err == cudaSuccess; ++j) {
    err = enqueue(j, two);
    if (err == cudaSuccess) *step_math_runs += N;
  }
  free_streams(two);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace dednn
