// What the MLP engine (csrc/engine_train.cu) and the heat kernel
// (csrc/heat_train.cu) share beyond fused_step.cuh: the hidden-layer kernel
// over tiles of batch points x all R streams, whose epilogue applies the
// caller's rules (the Taylor rules of a stream layout forward, their VJP
// backward), and the tile plans of that kernel and of the weight gradient,
// with the host-side launches that pick a tile by the blocks it gives.
//
// A Rules class gives R (stream rows per batch point) and
//   __device__ static void fwd(const float (&sums)[R], float bias,
//                              float* z_out, float* a_out, size_t at,
//                              size_t stride);
//   __device__ static void bwd(const float (&sums)[R], const float* z_prev,
//                              const float* a_prev, float* dz, size_t at,
//                              size_t stride);
// for one (batch point, column): stream s at flat index at + s·stride.
//
// As fused_step.cuh, everything sits in an unnamed namespace: each source
// that includes this header compiles its own instance.
#pragma once

#include <algorithm>
#include <type_traits>

#include "fused_step.cuh"

namespace dednn {
namespace {

constexpr int kSlices = 8;  // k-slices of every product, summed in order

// Shared memory of a layer_kernel instance: kStages k-tiles of the R·BB
// operand rows and of the weight, and the tile's running sums.
template <int R, int BB, int BN, int BK, int kStages>
constexpr size_t layer_smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kStages) *
              (static_cast<size_t>(R) * BB * (BK + 4) +
               std::max(BK * (BN + 4), BN * (BK + 4))) +
          static_cast<size_t>(R) * BB * (BN + 4));
}

// One hidden layer over a tile of BB batch points × all R streams × BN
// columns, for call step base + j (the weight at w_off, the bias at b_off
// in the replica's parameters, read through args; kGate, the sweep mode's
// instances: a replica past its step budget returns at entry,
// fused_step.cuh's gated).
//   Forward (!kBwd): in [R·B, K] activations, W [K, M]; out = in·W, plus
//     the bias on value rows, then the tanh rules: z_out = Z, a_out = A.
//   Backward (kBwd): in = dz [R·B, K] of this layer, W [M, K] (the layer's
//     [k_in, k_out] weight: the product is dz·Wᵀ over j < K); then the VJP
//     at the previous layer (z_prev, a_prev [R·B, M]): a_out = its dz.
// The tile's R·BB rows are row s·BB + bl for stream s, batch point b0 + bl.
// Thread (ty, tx) owns TM of them at TN columns (adjacent ones; for Wᵀ
// every BN/TN-th, so that its rows of the staged weight fall in distinct
// banks). The reduction runs over 8 slices of kps = ⌈K/8⌉, each padded
// with zeros to a multiple of 4, in k-tiles of BK staged by cp.async into a
// ring of kStages buffers; each output's chain restarts from 0 at a slice
// and is added to its running sum when the slice ends (sum = slice 0, then
// sum + slice s), as the first design's slice order. The sums then go through
// shared memory to the epilogue, where thread (bl, column) reads the R
// streams of its batch point and hands them to the caller's rules:
// Rules::fwd (the bias on value rows and the Taylor rules, into z_out and
// a_out) or Rules::bwd (the VJP at the previous layer, into a_out), each at
// flat index at + s·stride of stream s. Replica blockIdx.z: activations at
// z·ss, weights at z·ps.
//
// kBf16 (the "default" precision): the same staging and epilogue, but the
// product runs on the tensor cores (mma_bf16.cuh): the block's whole warps
// split its R·BB × BN tile into m16n8 tiles (rows past R·BB read as zeros)
// and accumulate every k-tile in order, 16 k at a time, the operands
// rounded to bf16 as they are read from the ring; the padded slices'
// zeros add nothing. The sums then reach the epilogue through shared memory
// as the fp32 sums do.
template <class Rules, bool kBwd, int BB, int BN, int TM, int TN, int BK,
          int kStages, bool kBf16 = false, bool kGate = false>
__global__ void __launch_bounds__((Rules::R * BB / TM) * (BN / TN))
    layer_kernel(const float* __restrict__ in,
                 const StepArgs* __restrict__ args, int j, long long w_off, long long b_off, int K, int M, int B,
                 const float* __restrict__ z_prev,
                 const float* __restrict__ a_prev, float* __restrict__ z_out,
                 float* __restrict__ a_out, size_t ss, size_t ps) {
  constexpr int R = Rules::R;
  // The gate keeps a pruned or finished replica's blocks nearly free. It
  // is an instance of its own: its mere presence changes this kernel's
  // code generation, which cost a packed step outside the sweep mode up to
  // 6 % (wave × 8 at the 8 × 64 tile; kernels/profile.py --steady).
  if constexpr (kGate) {
    if (gated(args, true, blockIdx.z, j)) return;
  }
  constexpr int kRowsA = R * BB;
  constexpr int kColThreads = BN / TN;
  constexpr int kThreads = (kRowsA / TM) * kColThreads;
  constexpr int kWRows = kBwd ? BN : BK, kWCols = kBwd ? BK : BN;
  constexpr int kLdC = BN + 4;
  static_assert(kRowsA % TM == 0, "whole thread rows");
  static_assert(BK % 4 == 0 && BN % 4 == 0 && TN % 2 == 0, "float4 tiles");
  extern __shared__ __align__(16) float smem[];
  using ATile = float[kRowsA][BK + 4];
  using WTile = float[kWRows][kWCols + 4];
  ATile* a_s = reinterpret_cast<ATile*>(smem);
  WTile* w_s = reinterpret_cast<WTile*>(smem + kStages * sizeof(ATile) / 4);
  float* c_s = smem + kStages * (sizeof(ATile) + sizeof(WTile)) / 4;
  const size_t so = blockIdx.z * ss;
  const float* P = args->p + blockIdx.z * ps;
  const float* W = P + w_off;
  in += so;
  if (kBwd) {
    z_prev += so;
    a_prev += so;
  } else {
    z_out += so;
  }
  a_out += so;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const int m0 = blockIdx.x * BN, b0 = blockIdx.y * BB;
  // The reduction's padded index kp: slice kp / kpp at k = slice·kps + kp
  // mod kpp, zero past the slice's kps (or K); kpp, a multiple of 4, puts
  // every slice boundary at the start of a 4-wide step.
  const int kps = (K + kSlices - 1) / kSlices;
  const int kpp = (kps + 3) / 4 * 4;
  const int kp_end = kSlices * kpp;
  const int tiles = (kp_end + BK - 1) / BK;
  // 16-byte copies of the operand rows and of the weight where aligned
  // (an odd replica's weights are not: 4-byte copies).
  const bool vec_a = K % 4 == 0 && kps == kpp && dednn::aligned16(in);
  const bool vec_w = K % 4 == 0 && kps == kpp && M % 4 == 0 &&
                     dednn::aligned16(W);
  auto col = [&](int jj) { return kBwd ? tx + kColThreads * jj : tx * TN + jj; };

  // The real k of padded kp, or -1 where the tile holds a zero.
  auto real_k = [&](int kp) {
    if (kps == kpp) return kp < K ? kp : -1;
    const int slice = kp / kpp, i = kp - slice * kpp;
    const int k = slice * kps + i;
    return kp < kp_end && i < kps && k < K ? k : -1;
  };
  // Staging: thread tid copies operand row tid mod kRowsA and weight row
  // tid mod kWRows of every tile, part tid / kRowsA (tid / kWRows) of their
  // columns; its rows' sources and destinations are fixed, so a tile costs
  // it a few address additions.
  static_assert(kThreads >= kRowsA && kThreads >= kWRows,
                "a thread per staged row");
  constexpr int kPartsA = kThreads / kRowsA, kPartsW = kThreads / kWRows;
  const int ra = tid % kRowsA, pa = tid / kRowsA;
  const int rw = tid % kWRows, pw = tid / kWRows;
  const int sa = ra / BB, ba = b0 + ra - sa * BB;
  const bool a_ok = ba < B;
  const float* a_row = in + static_cast<size_t>(sa * B + min(ba, B - 1)) * K;
  const bool w_ok = !kBwd || m0 + rw < M;
  const float* w_row =
      kBwd ? W + static_cast<size_t>(min(m0 + rw, M - 1)) * K : W;

  // Padded k-tile t into its buffer; every call commits one group.
  auto load = [&](int t) {
    if (t < tiles) {
      const int buf = t % kStages, kp0 = t * BK;
      auto copy = [&](auto width, bool on, const float* row, int parts,
                      int part, float* dst, int cols, bool k_cols) {
        constexpr int w = decltype(width)::value;
        if (part >= parts) return;  // a thread past the last part copies nothing
#pragma unroll 1
        for (int i = w * part; i < cols; i += w * parts) {
          // Columns are k (the operand rows, Wᵀ's rows) or m (W's rows,
          // whose k is the row's).
          const int k = real_k(kp0 + (k_cols ? i : rw));
          const bool ok = on && k >= 0 && (k_cols || m0 + i < M);
          const float* src = k_cols ? row + k : W + static_cast<size_t>(k) * M + m0 + i;
          if (w == 4) cp_async16(dst + i, ok ? src : W, ok);
          else cp_async4(dst + i, ok ? src : W, ok);
        }
      };
      using V = std::integral_constant<int, 4>;
      using S1 = std::integral_constant<int, 1>;
      if (vec_a) copy(V{}, a_ok, a_row, kPartsA, pa, &a_s[buf][ra][0], BK, true);
      else copy(S1{}, a_ok, a_row, kPartsA, pa, &a_s[buf][ra][0], BK, true);
      if (vec_w) copy(V{}, w_ok, w_row, kPartsW, pw, &w_s[buf][rw][0], kWCols, kBwd);
      else copy(S1{}, w_ok, w_row, kPartsW, pw, &w_s[buf][rw][0], kWCols, kBwd);
    }
    cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.0f;
  // A slice ends: its chains join the running sums in shared memory (sum =
  // slice 0, then sum + slice s; each thread its own entries) and restart
  // from 0.
  auto fold = [&](bool first) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        float* c = &c_s[(ty * TM + i) * kLdC + col(jj)];
        *c = first ? acc[i][jj] : *c + acc[i][jj];
        acc[i][jj] = 0.0f;
      }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);
  if constexpr (kBf16) {
    constexpr int kWarps = kThreads / 32;  // a partial last warp idles
    static_assert(BK % 16 == 0, "whole k16 steps");
    using Tiles = MmaTiles<kRowsA, BN, kWarps>;
    const int warp = tid / 32;
    float d[Tiles::kPer][4] = {};
    auto tile_of = [&](int i, int& r0, int& n0) {
      const int tile = warp + i * kWarps;
      r0 = tile / Tiles::kNT * 16;
      n0 = tile % Tiles::kNT * 8;
      return warp < kWarps && tile < Tiles::kTiles;
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
          int r0, n0;
          if (!tile_of(i, r0, n0)) continue;
          unsigned fa[4], fb[2];
          frag_a([&](int r, int k) {
            return r0 + r < kRowsA ? a_s[buf][r0 + r][kk + k] : 0.0f;
          }, fa);
          if constexpr (kBwd)
            frag_b([&](int k, int n) { return w_s[buf][n0 + n][kk + k]; }, fb);
          else
            frag_b([&](int k, int n) { return w_s[buf][kk + k][n0 + n]; }, fb);
          mma_bf16(d[i], fa, fb);
        }
    }
#pragma unroll
    for (int i = 0; i < Tiles::kPer; ++i) {
      int r0, n0;
      if (!tile_of(i, r0, n0)) continue;
      frag_c(d[i], [&](int r, int n, float v) {
        if (r0 + r < kRowsA) c_s[(r0 + r) * kLdC + n0 + n] = v;
      });
    }
    __syncthreads();
  } else {
  int next_slice = kpp;  // the padded k where the next slice starts
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();               // and every thread is done with t − 1
    load(t + kStages - 1);         // into t − 1's buffer
    const int buf = t % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      if (t * BK + kk == next_slice && next_slice < kp_end) {
        fold(next_slice == kpp);
        next_slice += kpp;
      }
      float a4[TM][4], w4[4][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) load_frag<4>(&a_s[buf][ty * TM + i][kk], a4[i]);
      if (kBwd) {
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
  fold(false);  // the last slice
  __syncthreads();
  }

  const size_t stride = static_cast<size_t>(B) * M;  // one stream
  for (int e = tid; e < BB * BN; e += kThreads) {
    const int bl = e / BN, c = e - bl * BN;
    const int b = b0 + bl, m = m0 + c;
    if (b >= B || m >= M) continue;
    float sums[R];
#pragma unroll
    for (int s = 0; s < R; ++s) sums[s] = c_s[(s * BB + bl) * kLdC + c];
    const size_t at = static_cast<size_t>(b) * M + m;
    if (!kBwd)
      Rules::fwd(sums, P[b_off + m], z_out, a_out, at, stride);
    else
      Rules::bwd(sums, z_prev, a_prev, a_out, at, stride);
  }
}

// The layer_kernel instances (batch points BB × columns BN per block, rows
// TM × columns TN per thread, k-tile BK, ring depth), largest first: 8 × 64
// (4 × 4) while that gives a block per SM, 8 × 32 (4 × 2) while a block per
// four SMs, else 2 × 32 (2 × 2); chosen from timings of the candidates at
// heat2d's and wave's shapes on the H100 (kernels/profile.py). R·BB/TM ·
// BN/TN threads per block. At R = 1 (one value stream: uat, and volterra's
// groups folded into one) a block of those tiles would have fewer threads
// than it stages rows, so the tiles take 4 times the rows: 32 × 64, 32 ×
// 32, 8 × 32. kernels/engine_core.LAYER_TILES and LAYER_TILES_R1 mirror
// them.
struct LayerConfig {
  int bb, bn, tm, tn, bk, stages, min_blocks;
};
constexpr LayerConfig kLayer[] = {{8, 64, 4, 4, 32, 3, kSMs},
                                  {8, 32, 4, 2, 32, 3, kSMs / 4},
                                  {2, 32, 2, 2, 32, 3, 0}};
constexpr LayerConfig kLayerR1[] = {{32, 64, 4, 4, 32, 3, kSMs},
                                    {32, 32, 4, 2, 32, 3, kSMs / 4},
                                    {8, 32, 2, 2, 32, 3, 0}};

template <int R>
constexpr LayerConfig layer_config(int C) {
  return R == 1 ? kLayerR1[C] : kLayer[C];
}

template <class Rules, bool kBwd, int C, bool kBf16 = false,
          bool kGate = false>
auto layer_instance() {
  constexpr LayerConfig c = layer_config<Rules::R>(C);
  return layer_kernel<Rules, kBwd, c.bb, c.bn, c.tm, c.tn, c.bk, c.stages,
                      kBf16, kGate>;
}

template <int R, int C>
constexpr size_t layer_config_smem() {
  constexpr LayerConfig c = layer_config<R>(C);
  return layer_smem_bytes<R, c.bb, c.bn, c.bk, c.stages>();
}

// One hidden layer (layer_kernel; the tile by the blocks it gives), at
// the "default" precision's bf16 instance where kBf16, at the gated
// instance in the sweep mode.
template <class Rules, bool kBwd, bool kBf16 = false>
void layer(const float* in, const StepArgs* args, int j, bool sweep,
           long long w_off, long long b_off, int K, int M, int B,
           const float* z_prev, const float* a_prev, float* z_out,
           float* a_out, size_t ss, size_t ps, int reps,
           cudaStream_t stream) {
  constexpr int R = Rules::R;
  auto go = [&](auto config) {
    constexpr int C = decltype(config)::value;
    constexpr LayerConfig c = layer_config<R>(C);
    auto kernel = sweep ? layer_instance<Rules, kBwd, C, kBf16, true>()
                        : layer_instance<Rules, kBwd, C, kBf16, false>();
    launch(kernel, (R * c.bb / c.tm) * (c.bn / c.tn),
           layer_config_smem<R, C>(), c.bb, c.bn, B, M, reps, stream, in,
           args, j, w_off, b_off, K, M, B, z_prev, a_prev, z_out, a_out, ss,
           ps);
  };
  auto fits = [&](int i) {
    const LayerConfig c = layer_config<R>(i);
    return blocks(B, M, c.bb, c.bn, reps) >= c.min_blocks;
  };
  if (fits(0)) go(std::integral_constant<int, 0>{});
  else if (fits(1)) go(std::integral_constant<int, 1>{});
  else go(std::integral_constant<int, 2>{});
}

// The weight-gradient instances: fused_step.cuh's kernel with one thread
// group per stream, so that all R streams of a tile run at once, rows 16 at
// a time through a ring of 4 buffers; 32 × 16 tiles (4 × 2 per thread)
// while that gives a block per SM, else 16 × 16 (2 × 4; chosen as the layer
// tiles). kernels/engine_core.WG_TILES mirrors them.
constexpr int kWgRows = 16, kWgStages = 4;
struct WgTile {
  int bk, bm, tk, tm, min_blocks;
};
constexpr WgTile kWgTile[] = {{32, 16, 4, 2, kSMs}, {16, 16, 2, 4, 0}};

template <bool kAdam, int R, int C, bool kBf16 = false>
auto wg_instance() {
  constexpr WgTile t = kWgTile[C];
  return weight_grad_kernel<kAdam, t.bk, t.bm, t.tk, t.tm, kWgRows, kWgStages,
                            R, kBf16>;
}

template <int R, int C>
constexpr size_t wg_config_smem() {
  return wg_smem_bytes<kWgTile[C].bk, kWgTile[C].bm, kWgRows, kWgStages, R>();
}

// One layer's weight gradient over the lay.R streams, R at a time (one
// thread group each; Adam in the epilogue, kAdam; else the gradient to
// args->grad), at the bf16 instance where kBf16.
template <bool kAdam, int R, bool kBf16 = false>
void weight_grad(const float* A, int KA, const float* dz, int M,
                 const Layout& lay, const StepArgs* args, int j, bool sweep,
                 long long w_off, long long b_off, size_t ss, size_t ps,
                 int reps, cudaStream_t stream) {
  const float* none = nullptr;
  auto go = [&](auto config) {
    constexpr int C = decltype(config)::value;
    constexpr WgTile t = kWgTile[C];
    launch(wg_instance<kAdam, R, C, kBf16>(), (t.bk / t.tk) * (t.bm / t.tm) * R,
           wg_config_smem<R, C>(), t.bk, t.bm, KA, M, reps, stream, A, KA,
           none, dz, M, lay, args, j, sweep, w_off, -1LL, b_off, ss, ps);
  };
  if (blocks(KA, M, kWgTile[0].bk, kWgTile[0].bm, reps) >=
      kWgTile[0].min_blocks)
    go(std::integral_constant<int, 0>{});
  else
    go(std::integral_constant<int, 1>{});
}

// The most dynamic shared memory any layer instance of R streams or
// weight-gradient instance of G thread groups takes per block, at any
// width.
template <int R, int G = R>
size_t step_smem_bytes() {
  return std::max({layer_config_smem<R, 0>(), layer_config_smem<R, 1>(),
                   layer_config_smem<R, 2>(), wg_config_smem<G, 0>(),
                   wg_config_smem<G, 1>()});
}

template <class Rules, int C, bool kBf16>
cudaError_t allow_layer() {
  constexpr size_t bytes = layer_config_smem<Rules::R, C>();
  for (const cudaError_t err :
       {allow_smem(layer_instance<Rules, false, C, kBf16, false>(), bytes),
        allow_smem(layer_instance<Rules, true, C, kBf16, false>(), bytes),
        allow_smem(layer_instance<Rules, false, C, kBf16, true>(), bytes),
        allow_smem(layer_instance<Rules, true, C, kBf16, true>(), bytes)})
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

template <int R, int C, bool kBf16>
cudaError_t allow_weight_grad() {
  constexpr size_t bytes = wg_config_smem<R, C>();
  const cudaError_t err = allow_smem(wg_instance<true, R, C, kBf16>(), bytes);
  return err != cudaSuccess
             ? err
             : allow_smem(wg_instance<false, R, C, kBf16>(), bytes);
}

// Lets every layer and weight-gradient instance (G thread groups) of one
// precision (kBf16: "default") take its dynamic shared memory; before any
// launch or capture.
template <class Rules, int G = Rules::R, bool kBf16 = false>
cudaError_t prepare_step() {
  for (const cudaError_t err :
       {allow_layer<Rules, 0, kBf16>(), allow_layer<Rules, 1, kBf16>(),
        allow_layer<Rules, 2, kBf16>(), allow_weight_grad<G, 0, kBf16>(),
        allow_weight_grad<G, 1, kBf16>()})
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

}  // namespace
}  // namespace dednn
