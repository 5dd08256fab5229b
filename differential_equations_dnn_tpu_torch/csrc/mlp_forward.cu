// The plain MLP forward: y = act(...act(x W_in + b_in)...) W_out + b_out.
//
// Replaces: differential_equations_dnn_tpu/kernels/taylor_mlp.py::_mlp_kernel
// (reached through mlp_forward_pallas), the batch-tiled forward with the
// weights resident on the chip, for grid evaluation and large-batch
// inference.
//
// What bounds it on the H100: fp32 operations on paper. At the heat grid
// (1 600 x 2 -> 128 x 3 -> 1) the work is 0.16 GFLOP (2.4 us at 67 TFLOP/s)
// against 220 KB of inputs and weights; at a 1024 x 1024 grid 104 GFLOP
// (1.55 ms) against 12 MB. In practice: every CTA streams all of W once per
// row tile, each copy of the copy engine costs its issuing thread about the
// same time whatever its size (%globaltimer stamps of a diagnostic build),
// and at a small grid few rows share each W byte, so the FFMAs per copy are
// few; at a large grid, the FFMA issue rate, tanhf in every hidden
// output's epilogue included.
//
// What the design does about it: a CTA takes a tile of R rows (64, 32, 16
// or 8, planned from N: the most that give every SM a tile, 64 only where
// two such CTAs share an SM, fewer where the width needs it) and keeps
// their activations in shared memory between layers, k-major
// (act[k][row]), in two buffers that the layers read and write in turn.
// Its compute warps own register tiles of TM rows x TN columns (8 x 8 at
// R = 64) whose operands come from shared memory as 16-byte loads, KC k
// steps loaded ahead of their FFMAs. One more warp, the producer, streams
// every W tile the CTA consumes (KT rows of one layer and one pass of its
// columns: 64 rows at R = 16 and 32, so that the copies are few, else 32)
// into a ring of stages slots, across layers and row tiles: one bulk copy
// where the tile's rows are contiguous, one per row otherwise, 4-byte
// cp.async copies for widths that are not a multiple of 4. Each slot has a
// full barrier (the tile has landed) and an empty one (every compute warp
// is done with it), so the compute warps meet only at layer boundaries.
// From h = 256 a thread block cluster of 8 CTAs (of 2 at R = 64) shares
// each tile: each CTA copies its share and multicasts it to all; a wide
// layer's column passes run in an order rotated by the cluster, so that
// clusters read different columns of W at a time. CTAs are persistent
// where N has more tiles than the card holds at once. The output layer's
// few columns take one chain per thread. Every output is one fmaf chain
// over k in ascending order starting from +0, then + bias, then the
// activation: the first design's order, so the outputs equal it bit for
// bit. Products are fp32 FFMA: exact fp32, no tensor cores.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kCols = 128;     // columns of a W k-tile: one pass of a layer
constexpr int kMinStages = 2;  // k-tiles in the W ring, at least
constexpr int kLaneRows = 4, kLaneCols = 8;  // a warp's lane grid
constexpr size_t kSmemLimit = 232448;  // 227 KB, the most a block may take
constexpr size_t kSmemPerSM = 233472;  // 228 KB, 1 KB of it kept per block

// A CTA shape: TM x TN outputs per thread, WR x WC warps, W k-tiles of KT
// rows; a CTA covers kRows rows and one kCols-column pass of a hidden layer
// at a time, and kOutCols columns of the output layer (one chain per
// thread).
template <int TM_, int TN_, int WR_, int WC_, int KT_>
struct Shape {
  static constexpr int TM = TM_, TN = TN_, WR = WR_, WC = WC_, KT = KT_;
  static constexpr int kRows = WR * kLaneRows * TM;
  static constexpr int kThreads = WR * WC * 32;
  static constexpr int kOutCols = kThreads / kRows;
  // k steps whose operands a thread loads ahead at once, and the CTAs per
  // SM its registers must allow (two at 64 rows).
  static constexpr int KC = TN == 8 ? 2 : 4;
  static constexpr int kMinBlocks = kRows == 64 ? 2 : 1;
  // Rows and columns go in groups of up to 4 adjacent ones (a 16-byte
  // load); a thread's groups lie a warp's width apart.
  static constexpr int GR = TM < 4 ? TM : 4, GC = TN < 4 ? TN : 4;
  static_assert(WC * kLaneCols * TN == kCols, "a pass is kCols columns");
  static_assert(kOutCols * kRows == kThreads && kOutCols <= kCols,
                "one output chain per thread");
};

// Each W tile is one copy of the copy engine, which costs the producer
// about the same whatever its size, so the tiles of few rows, whose FFMAs
// per tile are few, take 64-row k-tiles; 64-row CTA tiles take 32, so that
// two CTAs share an SM, and 8-row ones 32, so that the widest width fits.
using Rows64 = Shape<8, 8, 2, 2, 32>;  // 128 threads
using Rows32 = Shape<4, 4, 2, 4, 64>;  // 256 threads
using Rows16 = Shape<4, 4, 1, 4, 64>;  // 128 threads
using Rows8 = Shape<2, 4, 1, 4, 32>;   // 128 threads

// Threads per CTA: the compute warps and one producer warp.
int threads_of(int rows) {
  return 32 + (rows == 64   ? Rows64::kThreads
               : rows == 32 ? Rows32::kThreads
               : rows == 16 ? Rows16::kThreads
                            : Rows8::kThreads);
}

// The k-tile rows of a CTA tile of these rows, and the ring's depth aimed
// for (3 at 64 rows, so that two CTAs share an SM).
int kt_of(int rows) {
  return rows == 64   ? Rows64::KT
         : rows == 32 ? Rows32::KT
         : rows == 16 ? Rows16::KT
                      : Rows8::KT;
}
int depth_of(int rows) { return rows == 64 ? 3 : rows == 8 ? 6 : 4; }

// Shared memory: the ring's two mbarriers a stage (16 bytes), two
// activation buffers of width x rows floats, and the ring of stages
// k-tiles.
__host__ __device__ int bar_bytes(int stages) { return 16 * stages; }
size_t smem_bytes(int rows, int width, int stages) {
  return bar_bytes(stages) +
         (2 * static_cast<size_t>(width) * rows +
          static_cast<size_t>(stages) * kt_of(rows) * kCols) *
             sizeof(float);
}

struct Plan {
  int rows, threads, stages;
  size_t smem;
  int cluster;
};

// Columns of the output layer a CTA of this many rows takes per pass.
int out_cols_of(int rows) { return (threads_of(rows) - 32) / rows; }

// Whether every W tile can go by bulk copies, as a cluster's multicast
// needs: h a multiple of the k-tile (no partial tile of an odd size) and
// the output layer one pass.
bool multicast_ok(int rows, int h, int o) {
  return h % kt_of(rows) == 0 && o <= out_cols_of(rows);
}

// CTAs per thread block cluster: each W tile is read from L2 once per
// cluster and multicast to its CTAs, where multicast_ok. 8 from h = 256, 2
// at 64-row tiles, else none (at most the row tiles there are): a cluster
// pays where W is large against a tile's rows, and at h = 128 and 16-row
// tiles its CTAs only wait on each other's ring.
int cluster_of(int rows, int n, int h, int o) {
  if (!multicast_ok(rows, h, o)) return 1;
  int c = h >= 256 ? 8 : rows == 64 ? 2 : 1;
  while (c > 1 && c > dednn::ceil_div(n, rows)) c /= 2;
  return c;
}

// The launch at n rows of width max(d, h) on a card of `sms` SMs: rows per
// CTA tile, the most of 64 (where two such CTAs share an SM), 32 whose
// tiles give every SM one, else 16; then halved (to 8 at least) until two
// activation buffers and a ring of at least kMinStages tiles fit a block,
// the ring as deep as depth_of asks where it fits; the cluster by
// cluster_of. rows = 0: none fits. The output width is streamed in tiles
// and does not count.
Plan make_plan(int n, int d, int h, int o, int sms) {
  const int width = std::max(d, h);
  // Two 64-row CTAs share an SM where they fit, else they hide nothing.
  const bool pair = 2 * (smem_bytes(64, width, depth_of(64)) + 1024) <=
                    kSmemPerSM;
  for (int rows = dednn::ceil_div(n, 64) >= sms && pair ? 64
                  : dednn::ceil_div(n, 32) >= sms       ? 32
                                                        : 16;
       rows >= 8; rows /= 2) {
    for (int stages = depth_of(rows); stages >= kMinStages; --stages) {
      if (smem_bytes(rows, width, stages) <= kSmemLimit)
        return {rows, threads_of(rows), stages,
                smem_bytes(rows, width, stages), cluster_of(rows, n, h, o)};
    }
  }
  return {0, 0, 0, 0, 0};
}

// The current device's SMs.
cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The barrier's phase of this parity has completed: every thread arrived
// and every byte it expects has landed. Traps rather than hang if a copy
// never lands.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  for (int spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1 << 24)) __trap();
  }
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to shared
// memory by the copy engine, counted on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same, landing at dst in every CTA of the cluster in mask, each
// counted on its own barrier at bar's offset.
__device__ __forceinline__ void bulk_copy_multicast(float* dst,
                                                    const float* src,
                                                    unsigned bytes,
                                                    unsigned long long* bar,
                                                    unsigned short mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// Arrive on the barrier at bar's offset in the cluster's CTA `rank`.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar,
                                                    int rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Hold bar's phase open until this thread's earlier cp.async copies have
// landed (a pending arrival added now and made when they land).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// v[0 .. G) = p[0 .. G), G in {1, 2, 4}, as one load.
template <int G>
__device__ __forceinline__ void load_group(float* v, const float* p) {
  if constexpr (G == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (G == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void store_group(float* p, const float* v) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Layer li: 0 the input layer, 1 .. l the hidden layers (h columns each),
// l + 1 the output layer (o columns).
struct Net {
  const float *w_in, *b_in, *w_hid, *b_hid, *w_out, *b_out;
  int d, h, l, o;
  __device__ const float* w(int li) const {
    return li == 0   ? w_in
           : li <= l ? w_hid + static_cast<size_t>(li - 1) * h * h
                     : w_out;
  }
  __device__ const float* b(int li) const {
    return li == 0   ? b_in
           : li <= l ? b_hid + static_cast<size_t>(li - 1) * h
                     : b_out;
  }
  __device__ int k_in(int li) const { return li == 0 ? d : h; }
  __device__ int k_out(int li) const { return li <= l ? h : o; }
};

// The compute threads' barrier (named barrier 1: the producer warp is not
// in it).
template <int kThreads>
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

template <class S>
__global__ void __launch_bounds__(S::kThreads + 32, S::kMinBlocks)
    mlp_forward_kernel(const float* __restrict__ x, Net net,
                       float* __restrict__ y, int n, int act, int tiles,
                       int stages, int C) {
  constexpr int R = S::kRows, TM = S::TM, TN = S::TN, GR = S::GR,
                GC = S::GC, kOutCols = S::kOutCols, kWarps = S::kThreads / 32;
  constexpr int kKTile = S::KT;
  constexpr int KC = S::KC;  // k steps whose operands are loaded at once
  extern __shared__ __align__(16) float smem[];
  const int h = net.h, width = max(net.d, h), last = net.l + 1;
  auto* full = reinterpret_cast<unsigned long long*>(smem);  // [stages]
  unsigned long long* empty = full + stages;                 // [stages]
  float* buf0 = smem + bar_bytes(stages) / sizeof(float);  // [width][R]
  float* buf1 = buf0 + width * R;                          // [width][R]
  float* w_s = buf1 + width * R;  // [stages][kKTile * kCols]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // A cluster of C CTAs (C = 1: no cluster) takes C adjacent row tiles at
  // a time, a group, and walks the groups g, g + clusters, ...; CTA rank r
  // of the cluster takes tile C * group + r of each (past the last tile:
  // rows past n, computed and not stored, so that every CTA of a cluster
  // consumes the same W tiles).
  const int rank = static_cast<int>(blockIdx.x) % C;
  const int cluster = static_cast<int>(blockIdx.x) / C;
  const int clusters = static_cast<int>(gridDim.x) / C;
  const int my_tiles = ((tiles + C - 1) / C - 1 - cluster) / clusters + 1;

  // A layer's passes, and a pass's columns and their row stride in a
  // ring slot: a hidden pass kCols columns (the stride a multiple of 4,
  // for 16-byte loads), an output pass kOutCols.
  auto n_pass_of = [&](int li) {
    return li < last ? (h + kCols - 1) / kCols
                     : (net.o + kOutCols - 1) / kOutCols;
  };
  auto cols_of = [&](int li, int pass) {
    return li < last ? min(kCols, h - pass * kCols)
                     : min(kOutCols, net.o - pass * kOutCols);
  };
  auto stride_of = [&](int li, int cw) {
    return li < last ? (cw + 3) / 4 * 4 : cw;
  };
  // A hidden layer's passes in an order rotated by the cluster (whose CTAs
  // take the same W tiles), so that the clusters of a wide layer read
  // different columns of W at a time (each output's chain is the same in
  // any pass order).
  const int n_hid_pass = (h + kCols - 1) / kCols;
  const int rot = cluster % n_hid_pass;
  auto rotated = [&](int pass) {
    return pass + rot < n_hid_pass ? pass + rot : pass + rot - n_hid_pass;
  };

  if (tid < stages) {
    mbar_init(full + tid, 1);  // the producer's lane 0
    // One arrival per compute warp of every CTA of the cluster.
    mbar_init(empty + tid, kWarps * C);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  // Every CTA's barriers are set before any copy or arrival reaches them.
  if (C > 1)
    cluster_sync();
  else
    __syncthreads();

  if (warp == kWarps) {
    // The producer warp: every W tile the CTA consumes, in its order
    // (row tiles, layers, passes, k-tiles), into the ring slot that the
    // compute warps last released. A tile's rows (those below the layer's
    // k_in) and its pass's columns go packed at the pass's stride: one bulk
    // copy of the copy engine where the rows are contiguous in both (a
    // single pass of a row width that is a multiple of 4), else one per
    // row, a lane each, where rows are 16-byte aligned, else 4-byte
    // cp.async copies. The slot's full barrier completes its phase when the
    // tile has landed.
    int s = 0, round = 0;  // the slot of the next tile, and its use
    for (int it = 0; it < my_tiles; ++it) {
      for (int li = 0; li <= last; ++li) {
        const int ld = li < last ? h : net.o;  // W's row stride
        const int k_in = net.k_in(li);
        const int pass_cols = li < last ? kCols : kOutCols;
        for (int p = 0; p < n_pass_of(li); ++p) {
          const int pass = li < last ? rotated(p) : p;
          const int cw = cols_of(li, pass);
          const int stride = stride_of(li, cw);
          const float* src = net.w(li) + pass * pass_cols;
          const bool aligned = (reinterpret_cast<size_t>(src) & 15u) == 0;
          const bool by_rows = aligned && ld % 4 == 0 && cw % 4 == 0;
          for (int k0 = 0; k0 < k_in;
               k0 += kKTile, src += static_cast<size_t>(kKTile) * ld) {
            const int rows = min(kKTile, k_in - k0);
            // The compute warps of the cluster are done with the slot's
            // previous tile.
            if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
            unsigned long long* bar = full + s;
            float* dst = w_s + s * kKTile * kCols;
            if (++s == stages) {
              s = 0;
              ++round;
            }
            // One arrival per phase, lane 0's (32 arrivals on one barrier
            // serialize): with the tile's byte count for bulk copies; after
            // the lanes' 4-byte copies are counted as pending arrivals
            // otherwise.
            const bool contiguous =
                aligned && stride == ld && rows * ld % 4 == 0;
            if (C > 1 || contiguous || by_rows) {
              if (lane == 0)
                mbar_arrive_expect_tx(bar, rows * cw * sizeof(float));
            }
            if (C > 1) {
              // The launch checked that every tile goes by bulk copies.
              // Rank r copies its share, multicast to the whole cluster,
              // whose every barrier expects the whole tile.
              const auto mask = static_cast<unsigned short>((1 << C) - 1);
              if (stride == ld) {  // a 1/C share of its 16-byte units
                const int units = rows * ld / 4;
                const int u0 = units * rank / C, u1 = units * (rank + 1) / C;
                if (lane == 0 && u1 > u0)
                  bulk_copy_multicast(dst + 4 * u0, src + 4 * u0,
                                      16 * (u1 - u0), bar, mask);
              } else {  // by rows: rank, rank + C, ...
                for (int r = lane; r < rows; r += 32) {
                  if (r % C == rank)
                    bulk_copy_multicast(dst + r * stride,
                                        src + static_cast<size_t>(r) * ld,
                                        cw * sizeof(float), bar, mask);
                }
              }
            } else if (contiguous) {
              if (lane == 0)
                bulk_copy(dst, src, rows * ld * sizeof(float), bar);
            } else if (by_rows) {
              for (int r = lane; r < rows; r += 32)  // a row each
                bulk_copy(dst + r * stride, src + static_cast<size_t>(r) * ld,
                          cw * sizeof(float), bar);
            } else {
              for (int i = lane; i < rows * cw; i += 32) {
                const int r = i / cw, c = i - r * cw;
                cp_async4(dst + r * stride + c,
                          src + static_cast<size_t>(r) * ld + c);
              }
              cp_async_arrive(bar);
              __syncwarp();
              if (lane == 0) mbar_arrive(bar);
            }
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // The compute warps. The thread's first row and column of a hidden
    // layer's pass: groups of GR rows 4 * GR apart, of GC columns 8 * GC
    // apart.
    const int m0 = (warp / S::WC) * kLaneRows * TM + (lane / kLaneCols) * GR;
    const int c0 = (warp % S::WC) * kLaneCols * TN + (lane % kLaneCols) * GC;
    int slot = 0;  // the slot consumed next, and its phase
    unsigned phase = 0;
    auto next_tile = [&]() {
      mbar_wait(full + slot, phase);
      return w_s + slot * kKTile * kCols;
    };
    // The warp is done with the slot: the producers of the cluster may refill
    // it.
    auto done_tile = [&]() {
      __syncwarp();
      if (lane == 0) {
        if (C == 1) {
          mbar_arrive(empty + slot);
        } else {
          for (int q = 0; q < C; ++q) mbar_arrive_cluster(empty + slot, q);
        }
      }
      if (++slot == stages) {
        slot = 0;
        phase ^= 1u;
      }
    };

    for (int it = 0; it < my_tiles; ++it) {
      const int row0 = ((cluster + it * clusters) * C + rank) * R;
      // The previous tile's output layer has read its buffer; then the x
      // rows go to buffer 0, k-major (zeros past n).
      compute_sync<S::kThreads>();
      for (int i = tid; i < R * net.d; i += S::kThreads) {
        const int m = i % R, c = i / R;
        buf0[c * R + m] =
            row0 + m < n ? x[static_cast<size_t>(row0 + m) * net.d + c] : 0.0f;
      }
      compute_sync<S::kThreads>();
      for (int li = 0; li < last; ++li) {
        const float* in = li % 2 == 0 ? buf0 : buf1;
        float* out = li % 2 == 0 ? buf1 : buf0;
        const int k_in = net.k_in(li), n_kt = (k_in + kKTile - 1) / kKTile;
        const float* bias_p = net.b(li);
        for (int p = 0; p < n_hid_pass; ++p) {
          const int pass = rotated(p), j0 = pass * kCols;
          const int stride = stride_of(li, cols_of(li, pass));
          // The bias, read before the k-loop so that its latency overlaps it.
          float bias[TN];
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const int j = j0 + c0 + (c / GC) * kLaneCols * GC + c % GC;
            bias[c] = j < h ? bias_p[j] : 0.0f;
          }
          float acc[TM][TN] = {};
          for (int kt = 0; kt < n_kt; ++kt) {
            const float* w = next_tile() + c0;
            const int k0 = kt * kKTile;
            const float* a = in + k0 * R + m0;
            // Step kk's operands: TM activations, TN weights.
            auto fetch = [&](float (&av)[TM], float (&wv)[TN], int kk) {
#pragma unroll
              for (int g = 0; g < TM / GR; ++g)
                load_group<GR>(av + g * GR, a + kk * R + g * kLaneRows * GR);
#pragma unroll
              for (int g = 0; g < TN / GC; ++g)
                load_group<GC>(wv + g * GC,
                               w + kk * stride + g * kLaneCols * GC);
            };
            auto fma_step = [&](const float (&av)[TM], const float (&wv)[TN]) {
#pragma unroll
              for (int r = 0; r < TM; ++r) {
#pragma unroll
                for (int c = 0; c < TN; ++c)
                  acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
              }
            };
            const int rows_k = min(kKTile, k_in - k0);
            if (rows_k == kKTile) {
              // A whole tile, KC steps at a time: the next KC steps'
              // operands are loaded before this KC's FFMAs.
              float av[2][KC][TM], wv[2][KC][TN];
#pragma unroll
              for (int q = 0; q < KC; ++q) fetch(av[0][q], wv[0][q], q);
#pragma unroll
              for (int ch = 0; ch < kKTile / KC; ++ch) {
                if (ch + 1 < kKTile / KC) {
#pragma unroll
                  for (int q = 0; q < KC; ++q)
                    fetch(av[(ch + 1) & 1][q], wv[(ch + 1) & 1][q],
                          (ch + 1) * KC + q);
                }
#pragma unroll
                for (int q = 0; q < KC; ++q)
                  fma_step(av[ch & 1][q], wv[ch & 1][q]);
              }
            } else {
              for (int kk = 0; kk < rows_k; ++kk) {
                float av[TM], wv[TN];
                fetch(av, wv, kk);
                fma_step(av, wv);
              }
            }
            done_tile();
          }
          // + bias, the activation, into the next buffer (k-major).
#pragma unroll
          for (int c = 0; c < TN; ++c) {
            const int j = j0 + c0 + (c / GC) * kLaneCols * GC + c % GC;
            if (j >= h) continue;
            float v[TM];
#pragma unroll
            for (int r = 0; r < TM; ++r)
              v[r] = dednn::activate(act, acc[r][c] + bias[c]);
#pragma unroll
            for (int g = 0; g < TM / GR; ++g)
              store_group<GR>(out + j * R + m0 + g * kLaneRows * GR,
                              v + g * GR);
          }
        }
        // The layer's outputs are written before the next layer reads them,
        // and its inputs read before the next layer overwrites them.
        compute_sync<S::kThreads>();
      }
      // The output layer: one chain per thread, row m of column jo of each
      // kOutCols-column pass, its W through the ring too, straight to y.
      const float* a = net.l % 2 == 0 ? buf1 : buf0;
      const int m = tid % R, jo = tid / R;
      for (int pass = 0, j0 = 0; j0 < net.o; ++pass, j0 += kOutCols) {
        const int stride = stride_of(last, cols_of(last, pass));
        float acc = 0.0f;
        for (int kt = 0; kt < (h + kKTile - 1) / kKTile; ++kt) {
          const float* w = next_tile() + jo;
          const int k0 = kt * kKTile;
          const float* ak = a + k0 * R + m;
          const int rows_k = min(kKTile, h - k0);
          if (rows_k == kKTile) {
            // 16 steps' operands loaded before their FFMAs, the next 16's
            // before those FFMAs run: the chain waits on no load.
            constexpr int kC = 16;
            float av[2][kC], wv[2][kC];
#pragma unroll
            for (int q = 0; q < kC; ++q) {
              av[0][q] = ak[q * R];
              wv[0][q] = w[q * stride];
            }
#pragma unroll
            for (int ch = 0; ch < kKTile / kC; ++ch) {
              if (ch + 1 < kKTile / kC) {
#pragma unroll
                for (int q = 0; q < kC; ++q) {
                  av[(ch + 1) & 1][q] = ak[((ch + 1) * kC + q) * R];
                  wv[(ch + 1) & 1][q] = w[((ch + 1) * kC + q) * stride];
                }
              }
#pragma unroll
              for (int q = 0; q < kC; ++q)
                acc = fmaf(av[ch & 1][q], wv[ch & 1][q], acc);
            }
          } else {
            for (int kk = 0; kk < rows_k; ++kk)
              acc = fmaf(ak[kk * R], w[kk * stride], acc);
          }
          done_tile();
        }
        const int j = j0 + jo;
        if (j < net.o && row0 + m < n)
          y[static_cast<size_t>(row0 + m) * net.o + j] = acc + net.b_out[j];
      }
    }
  }
  // No CTA leaves while a peer may still copy into it or arrive on it.
  if (C > 1) cluster_sync();
}

template <class S>
cudaError_t launch(const float* x, const Net& net, float* y, int n, int act,
                   const Plan& plan, int sms, cudaStream_t stream) {
  const auto kernel = mlp_forward_kernel<S>;
  cudaError_t err = dednn::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return err;
  // A cluster multicasts its W tiles by bulk copies, which need the
  // weights 16-byte aligned.
  const auto aligned = [](const float* p) {
    return (reinterpret_cast<size_t>(p) & 15u) == 0;
  };
  int C = plan.cluster;
  if (!aligned(net.w_in) || (net.l > 0 && !aligned(net.w_hid)) ||
      !aligned(net.w_out))
    C = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(S::kThreads + 32);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  // Persistent CTAs: no more clusters than the card holds at once.
  const int tiles = dednn::ceil_div(n, S::kRows);
  const int groups = dednn::ceil_div(tiles, C);
  int capacity = 0;
  if (C > 1) {
    cfg.gridDim = dim3(C);
    err = cudaOccupancyMaxActiveClusters(&capacity, kernel, &cfg);
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, S::kThreads + 32, plan.smem);
    capacity = sms * per_sm;
  }
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(std::min(groups, std::max(1, capacity)) * C);
  err = cudaLaunchKernelEx(&cfg, kernel, x, net, y, n, act, tiles,
                           plan.stages, C);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[5] = (rows per CTA tile, threads per CTA, W k-tiles in the ring,
// bytes of dynamic shared memory per CTA, CTAs per cluster) of mlp_forward
// at n rows and widths d, h, o on the current device;
// cudaErrorInvalidValue if no tile fits.
extern "C" int mlp_forward_plan(int n, int d, int h, int o, int* out) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan plan = make_plan(n, d, h, o, sms);
  out[0] = plan.rows;
  out[1] = plan.threads;
  out[2] = plan.stages;
  out[3] = static_cast<int>(plan.smem);
  out[4] = plan.cluster;
  return plan.rows == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// y [n, o] = the MLP d -> h x l -> o with activation act (dednn::Activation)
// at x [n, d], launched as mlp_forward_plan plans it; w_hid and b_hid are
// unread at l = 0.
extern "C" int mlp_forward(const float* x, const float* w_in,
                           const float* b_in, const float* w_hid,
                           const float* b_hid, const float* w_out,
                           const float* b_out, float* y, int n, int d, int h,
                           int l, int o, int act, void* stream) {
  if (n == 0 || o == 0) return cudaSuccess;
  if (d < 1 || h < 1) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const Plan plan = make_plan(n, d, h, o, sms);
  const Net net{w_in, b_in, w_hid, b_hid, w_out, b_out, d, h, l, o};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (plan.rows) {
    case 64:
      return launch<Rows64>(x, net, y, n, act, plan, sms, st);
    case 32:
      return launch<Rows32>(x, net, y, n, act, plan, sms, st);
    case 16:
      return launch<Rows16>(x, net, y, n, act, plan, sms, st);
    case 8:
      return launch<Rows8>(x, net, y, n, act, plan, sms, st);
    default:
      return cudaErrorInvalidValue;
  }
}
