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
// paper; in practice the serial chain of layers, each a k-loop of a few
// hundred dependent steps, and how many SMs share that work do.
//
// What the design does about it: the TPU tile of 256 points x 7 streams x
// 128 wide is 917 KB per activation buffer, four times what an H100 block
// may take. Here a thread block cluster of C CTAs (C = 8 from H = 113)
// takes P points (8 at H = 128): each CTA owns a column slice of every
// layer (16 columns at H = 128), so heat's B = 64 runs on 64 CTAs. A CTA
// keeps all 7 streams of its P points at the layer's full input width in
// shared memory (in_s, two buffers: a layer reads one and its outputs go
// to the other); its threads are (point, column) pairs, each holding the
// accumulators of all 7 streams, so every W value read from shared memory
// feeds 7 FFMAs and the Taylor rules of streams 1-3 read stream 0's
// pre-activation from registers. Its W slices stream through a ring of
// k-tiles by cp.async, across layer boundaries, so the next layer's weights
// arrive while this one computes and shared memory does not grow as H^2.
// After each layer but the output one, each CTA writes its columns into its
// own next in_s buffer, copies that block into every peer's next buffer
// through distributed shared memory in 16-byte stores (stores do not wait,
// where a gather's remote loads would; 4-byte stores, one per thread and
// stream, cost about 5 us per layer on the H100), and the CTAs meet at one
// cluster barrier. A point leaves the SMs only as its 7 outputs. Each
// output is one k-ascending fmaf chain from 0 (the first design's order;
// the zeros that pad a k-tile add nothing), then the bias: the outputs
// equal the first design's bit for bit. Products are fp32 FFMA: exact
// fp32, no tensor cores.
//
// A population of T nets (the JAX kernel under jax.vmap, which gives it a
// leading batch grid axis) is one launch of a grid of ceil(n / P)·C x T
// CTAs: blockIdx.y picks trial t's points, weights and outputs, each a
// contiguous [T, ...] tensor, and a CTA computes exactly what a one-trial
// launch computes for that trial, so a T-trial launch equals T one-trial
// launches bit for bit. The plan (and the shared memory) is per point and
// does not depend on T.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kD = 2;  // the heat inputs are (x, t)
constexpr int kStreams = 7;
constexpr int kThreads = 128;
constexpr int kKTile = 32;     // rows of a W k-tile
// k-tiles in the ring: 8 (7 in flight, the whole W stream of a CTA at H =
// 128) where they fit, else 3.
constexpr int kDeepStages = 8, kShallowStages = 3;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSliceCols = 16;  // columns per CTA a cluster aims for
constexpr size_t kSmemLimit = 227 * 1024;

// The launch's shape at hidden width h: cluster size C, points per cluster
// P (the most of 8, 4, 2, 1 that fit), the row stride of in_s (a multiple
// of 4 that puts two points' rows in different banks), the ring's depth,
// and the dynamic shared memory: the two in_s buffers [2][7][P][ld] and the
// W ring [stages][kKTile][128 / P]. kernels/taylor_mlp.heat_streams_plan
// mirrors it.
struct Plan {
  int C, P, ld, stages;
  size_t smem;
};

Plan make_plan(int h) {
  Plan pl{};
  pl.C = std::min(kMaxCluster, std::max(1, dednn::ceil_div(h, kSliceCols)));
  pl.ld = dednn::ceil_div(std::max(kD, h), 32) * 32 + 4;
  for (int P = 8; P >= 1; P /= 2) {
    for (const int stages : {kDeepStages, kShallowStages}) {
      const size_t floats =
          2 * static_cast<size_t>(kStreams) * P * pl.ld +
          static_cast<size_t>(stages) * kKTile * (kThreads / P);
      if (floats * sizeof(float) <= kSmemLimit) {
        pl.P = P;
        pl.stages = stages;
        pl.smem = floats * sizeof(float);
        return pl;
      }
    }
  }
  return pl;  // P = 0: no plan fits
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Layer li of the network: 0 the input layer, 1 .. l the hidden layers,
// l + 1 the output layer.
struct Net {
  const float *w_in, *b_in, *w_hid, *b_hid, *w_out, *b_out;
  int h, l, o;
  __device__ const float* w(int li) const {
    return li == 0 ? w_in
           : li <= l ? w_hid + static_cast<size_t>(li - 1) * h * h
                     : w_out;
  }
  __device__ const float* b(int li) const {
    return li == 0   ? b_in
           : li <= l ? b_hid + static_cast<size_t>(li - 1) * h
                     : b_out;
  }
  __device__ int k_in(int li) const { return li == 0 ? kD : h; }
  __device__ int k_out(int li) const { return li <= l ? h : o; }
  // Trial t's net: each tensor is [T, ...] and contiguous.
  __device__ Net trial(int t) const {
    const size_t hh = static_cast<size_t>(h), tt = static_cast<size_t>(t);
    return Net{w_in + tt * kD * hh,  b_in + tt * hh,
               w_hid + tt * l * hh * hh, b_hid + tt * l * hh,
               w_out + tt * hh * o,  b_out + tt * o,
               h, l, o};
  }
};

// The next tile of one CTA's W stream: layer li, pass (CL columns of the
// CTA's slice of it at a time), k-tile kt, and the layer's shape (its
// columns [c0, c1), passes and k-tiles, worked out once per layer); li
// past the output layer at the end.
struct TileIt {
  int li, pass, kt, c0, c1, n_pass, n_kt;
};

template <int kStages>
__global__ void __launch_bounds__(kThreads)
    heat_streams_kernel(const float* __restrict__ xt,
                        const float* __restrict__ x0,
                        const float* __restrict__ xb1,
                        const float* __restrict__ xb2, Net nets,
                        float* __restrict__ out, int n, int act, int P,
                        int ld) {
  // This CTA's trial: its points, weights and outputs.
  const size_t trial = blockIdx.y;
  const Net net = nets.trial(static_cast<int>(trial));
  const size_t in_at = trial * n * kD;
  xt += in_at;
  x0 += in_at;
  xb1 += in_at;
  xb2 += in_at;
  out += trial * kStreams * n * net.o;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = kThreads / P;  // column lanes
  extern __shared__ __align__(16) float smem[];
  const int buf_floats = kStreams * P * ld;
  float* in_s = smem;                         // [2][7][P][ld]
  float* w_s = in_s + 2 * buf_floats;         // [kStages][kKTile][CL]
  const int tid = threadIdx.x;
  const int p = tid / CL, jl = tid - (tid / CL) * CL;
  const int row0 = static_cast<int>(blockIdx.x / C) * P;
  const int last = net.l + 1;  // the output layer

  // This CTA's columns [c0, c1) of layer li (a slice width that is a
  // multiple of 4, so the last CTAs may have none).
  auto cols = [&](int li, int& c0, int& c1) {
    const int k_out = net.k_out(li);
    const int cw = ((k_out + C - 1) / C + 3) / 4 * 4;
    c0 = min(k_out, rank * cw);
    c1 = min(k_out, c0 + cw);
  };
  auto ktiles = [&](int li) { return (net.k_in(li) + kKTile - 1) / kKTile; };
  // `it` at the first tile of layer li or, if this CTA has no columns
  // there, of the next layer that it has.
  auto start = [&](TileIt& it, int li) {
    it.pass = it.kt = it.n_pass = it.n_kt = 0;
    for (it.li = li; it.li <= last; ++it.li) {
      cols(it.li, it.c0, it.c1);
      it.n_pass = (it.c1 - it.c0 + CL - 1) / CL;
      if (it.n_pass > 0) {
        it.n_kt = ktiles(it.li);
        return;
      }
    }
  };
  auto advance = [&](TileIt& it) {
    if (++it.kt < it.n_kt) return;
    it.kt = 0;
    if (++it.pass < it.n_pass) return;
    start(it, it.li + 1);
  };
  // Each thread's part of a tile: chunks i = tid + m·kThreads of 4 floats,
  // q = CL/4 (a power of 2) to a row.
  const int q_shift = __ffs(CL / 4) - 1;

  // Tile `it` into ring buffer buf (zeros past the layer's rows and the
  // CTA's columns); every call commits one group.
  auto load = [&](const TileIt& it, int buf) {
    if (it.li <= last) {
      const float* w = net.w(it.li);
      const int k_in = net.k_in(it.li), k_out = net.k_out(it.li);
      const int c1 = it.c1;
      const int j0 = it.c0 + it.pass * CL, k0 = it.kt * kKTile;
      float* dst = w_s + buf * kKTile * CL;
      const bool vec = k_out % 4 == 0 && j0 % 4 == 0 &&
                       (reinterpret_cast<size_t>(w) & 15u) == 0;
      for (int i = tid; i < kKTile * CL / 4; i += kThreads) {
        const int r = i >> q_shift, c = 4 * (i - (r << q_shift));
        const int k = k0 + r, j = j0 + c;
        const float* src = w + static_cast<size_t>(k) * k_out + j;
        if (vec && k < k_in && j + 3 < c1) {
          cp_async16(dst + r * CL + c, src, true);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = k < k_in && j + e < c1;
            cp_async4(dst + r * CL + c + e, ok ? src + e : w, ok);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // in_s: zeros where a layer reads past its input (the columns from h, and
  // buffer 0's first 4 for the input layer), then the 7 input rows of each
  // point in buffer 0; a point past n (the ragged last cluster) gets zeros
  // and writes nothing. The peers store columns below h only, and only
  // after the cluster barrier (which each CTA of the cluster must reach
  // before any touches its shared memory).
  const int pad = ld - net.h;
  for (int i = tid; i < 2 * kStreams * P * pad; i += kThreads) {
    const int row = i / pad;
    in_s[row * ld + net.h + i - row * pad] = 0.0f;
  }
  for (int i = tid; i < kStreams * P * 4; i += kThreads)
    in_s[(i / 4) * ld + i % 4] = 0.0f;
  cluster_arrive();
  cluster_wait();
  for (int i = tid; i < kStreams * P * kD; i += kThreads) {
    const int c = i % kD, r = (i / kD) % P, s = i / (kD * P);
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
    in_s[(s * P + r) * ld + c] = v;
  }

  TileIt ahead;
  start(ahead, 0);
  for (int q = 0; q < kStages - 1; ++q, advance(ahead)) load(ahead, q);
  int t = 0;  // tiles consumed, in the loader's order
  for (int li = 0; li <= last; ++li) {
    int c0, c1;
    cols(li, c0, c1);
    const int k_in = net.k_in(li), n_kt = ktiles(li);
    const float* cur = in_s + (li % 2) * buf_floats;
    float* next = in_s + ((li + 1) % 2) * buf_floats;
    for (int j0 = c0; j0 < c1; j0 += CL) {  // the passes over the columns
      const int j = j0 + jl;
      // The bias, read before the k-loop so that its latency overlaps it.
      const float bj = j < c1 ? net.b(li)[j] : 0.0f;
      float acc[kStreams] = {};
      for (int kt = 0; kt < n_kt; ++kt, ++t) {
        cp_async_wait<kStages - 2>();  // tile t has landed
        __syncthreads();  // every thread is done with t - 1; in_s is set
        load(ahead, (t + kStages - 1) % kStages);
        advance(ahead);
        const int k0 = kt * kKTile;
        const int rows = (min(kKTile, k_in - k0) + 3) / 4 * 4;
        const float* x = cur + p * ld + k0;
        const float* wt = w_s + (t % kStages) * kKTile * CL + jl;
        // Four k at a time: every load first, then four rounds of one FFMA
        // per stream (each stream's chain stays k-ascending).
        auto step = [&](int kk) {
          float w4[4];
          float4 xv[kStreams];
#pragma unroll
          for (int e = 0; e < 4; ++e) w4[e] = wt[(kk + e) * CL];
#pragma unroll
          for (int s = 0; s < kStreams; ++s)
            xv[s] = *reinterpret_cast<const float4*>(x + s * P * ld + kk);
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
            acc[s] = fmaf(xv[s].x, w4[0], acc[s]);
          }
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
            acc[s] = fmaf(xv[s].y, w4[1], acc[s]);
          }
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
            acc[s] = fmaf(xv[s].z, w4[2], acc[s]);
          }
#pragma unroll
          for (int s = 0; s < kStreams; ++s) {
            acc[s] = fmaf(xv[s].w, w4[3], acc[s]);
          }
        };
        if (rows == kKTile) {  // a whole tile: unrolled, loads run ahead
#pragma unroll
          for (int kk = 0; kk < kKTile; kk += 4) step(kk);
        } else {
          for (int kk = 0; kk < rows; kk += 4) step(kk);
        }
      }
      // The bias, then the activation into this CTA's next buffer or the
      // output.
      if (j >= c1) continue;
      float z[kStreams];
#pragma unroll
      for (int s = 0; s < kStreams; ++s)
        z[s] = (s == 0 || s >= 4) ? acc[s] + bj : acc[s];
      if (li < last) {
        act_streams(act, z);
#pragma unroll
        for (int s = 0; s < kStreams; ++s) next[(s * P + p) * ld + j] = z[s];
      } else if (row0 + p < n) {
#pragma unroll
        for (int s = 0; s < kStreams; ++s)
          out[(static_cast<size_t>(s) * n + row0 + p) * net.o + j] = z[s];
      }
    }
    if (li == last) break;
    // This CTA's columns of layer li, copied into every peer's next buffer
    // 16 bytes at a time (c0 and the slice width are multiples of 4; a
    // chunk past h copies the zero pad); then the cluster barrier, after
    // which every CTA holds all of layer li. The peers store into a buffer
    // only after the barrier that follows the layer reading it.
    __syncthreads();
    const int q = (c1 - c0 + 3) / 4;  // float4 chunks per row
    for (int i = tid; i < kStreams * P * q; i += kThreads) {
      const int row = i / q, at = row * ld + c0 + 4 * (i - row * q);
      const float4 v = *reinterpret_cast<const float4*>(next + at);
      for (int r = 1; r < C; ++r)
        *reinterpret_cast<float4*>(
            cluster.map_shared_rank(next, (rank + r) % C) + at) = v;
    }
    cluster_arrive();
    cluster_wait();
  }
}

}  // namespace

// out[6] = (cluster size, points per cluster, W k-tile rows, threads per
// CTA, ring depth, bytes of dynamic shared memory per CTA) of the launch at
// widths h, o (the output width is not staged whole, so it does not count);
// cudaErrorInvalidValue if no plan fits.
extern "C" int heat_streams_plan(int h, int o, int* out) {
  (void)o;
  const Plan pl = make_plan(h);
  out[0] = pl.C;
  out[1] = pl.P;
  out[2] = kKTile;
  out[3] = kThreads;
  out[4] = pl.stages;
  out[5] = static_cast<int>(pl.smem);
  return pl.P == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// The most trials of one launch: gridDim.y's limit.
constexpr int kMaxTrials = 65535;

// out [T, 7, n, o]: for each of T trials, the streams (u, u_x, u_xx, u_t,
// u0, ub1, ub2) at the n points of xt, x0, xb1, xb2 (each [T, n, 2]), for
// the trial's MLP 2 -> h x l -> o (w_in [T, 2, h], b_in [T, h], w_hid
// [T, l, h, h], b_hid [T, l, h], w_out [T, h, o], b_out [T, o]) with
// activation act (dednn::Activation). w_hid and b_hid are unread at l = 0.
// cudaErrorInvalidValue past kMaxTrials or where no plan fits.
extern "C" int heat_streams(const float* xt, const float* x0,
                            const float* xb1, const float* xb2,
                            const float* w_in, const float* b_in,
                            const float* w_hid, const float* b_hid,
                            const float* w_out, const float* b_out,
                            float* out, int n_trials, int n, int h, int l,
                            int o, int act, void* stream) {
  if (n_trials < 0 || n_trials > kMaxTrials) return cudaErrorInvalidValue;
  if (n == 0 || n_trials == 0) return cudaSuccess;
  const Plan pl = make_plan(h);
  if (pl.P == 0) return cudaErrorInvalidValue;
  const auto kernel = pl.stages == kDeepStages
                          ? heat_streams_kernel<kDeepStages>
                          : heat_streams_kernel<kShallowStages>;
  cudaError_t err = dednn::allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return err;
  const Net net{w_in, b_in, w_hid, b_hid, w_out, b_out, h, l, o};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dednn::ceil_div(n, pl.P) * pl.C, n_trials);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xt, x0, xb1, xb2, net, out, n, act,
                           pl.P, pl.ld);
  return err != cudaSuccess ? err : cudaGetLastError();
}
