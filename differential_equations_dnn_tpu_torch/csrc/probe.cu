// Probes of the two ways a fused step of ~46 dependent phases can run on
// the H100 (kernels/profile.py --probe): the phases as the kernel nodes of
// a CUDA graph, whose floor is the gap from one node to the next, or one
// persistent kernel with a grid-wide barrier between phases, whose floor is
// the barrier; and the thread block cluster barrier between the layers of
// the heat-streams kernel (csrc/heat_streams.cu). None is a kernel of the
// port's paths; they time the card's launch and barrier machinery with
// empty work.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

// `syncs` grid-wide barriers (cooperative launch: every block resident).
__global__ void grid_sync_kernel(int syncs) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
}

// `syncs` cluster barriers (barrier.cluster arrive and wait, as
// heat_streams_kernel meets its peers between layers).
__global__ void cluster_sync_kernel(int syncs) {
  for (int i = 0; i < syncs; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// Milliseconds between two events around `run`, on stream s.
template <class Run>
cudaError_t time_ms(cudaStream_t s, Run run, float* ms) {
  cudaEvent_t e0, e1;
  cudaError_t err = cudaEventCreate(&e0);
  if (err != cudaSuccess) return err;
  err = cudaEventCreate(&e1);
  if (err == cudaSuccess) {
    cudaEventRecord(e0, s);
    err = run();
    cudaEventRecord(e1, s);
    if (err == cudaSuccess) err = cudaEventSynchronize(e1);
    if (err == cudaSuccess) err = cudaEventElapsedTime(ms, e0, e1);
    cudaEventDestroy(e1);
  }
  cudaEventDestroy(e0);
  return err;
}

}  // namespace

// out[0]: ms per node of a CUDA graph of `nodes` empty kernels of `blocks`
// × `threads` in series, over `reps` replays after a warm-up; out[1]: ms
// per launch of the same kernels issued one by one from the host.
extern "C" int probe_graph_gap(int nodes, int blocks, int threads, int reps,
                               float* out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  err = cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal);
  if (err == cudaSuccess) {
    for (int i = 0; i < nodes; ++i) empty_kernel<<<blocks, threads, 0, s>>>();
    err = cudaGetLastError();
    const cudaError_t end = cudaStreamEndCapture(s, &graph);
    if (err == cudaSuccess) err = end;
  }
  if (err == cudaSuccess) err = cudaGraphInstantiateWithFlags(&exec, graph, 0);
  if (err == cudaSuccess) err = cudaGraphLaunch(exec, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  float ms = 0.0f;
  if (err == cudaSuccess) {
    err = time_ms(s, [&] {
      for (int r = 0; r < reps; ++r) {
        const cudaError_t e = cudaGraphLaunch(exec, s);
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    }, &ms);
    out[0] = ms / (static_cast<float>(reps) * nodes);
  }
  if (err == cudaSuccess) {
    err = time_ms(s, [&] {
      for (int r = 0; r < reps; ++r)
        for (int i = 0; i < nodes; ++i)
          empty_kernel<<<blocks, threads, 0, s>>>();
      return cudaGetLastError();
    }, &ms);
    out[1] = ms / (static_cast<float>(reps) * nodes);
  }
  if (exec != nullptr) cudaGraphExecDestroy(exec);
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaStreamDestroy(s);
  return err;
}

// out[0]: ms per grid-wide barrier of one cooperative kernel of `blocks` ×
// `threads` running `syncs` barriers, less the same launch with none;
// out[1]: ms of that launch with none. Refuses more blocks than can be
// resident at once.
extern "C" int probe_grid_sync(int blocks, int threads, int syncs,
                               float* out) {
  int per_sm = 0, sms = 0, device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_sync_kernel, threads, 0);
  if (err != cudaSuccess) return err;
  if (blocks > per_sm * sms || syncs < 1) return cudaErrorInvalidValue;
  cudaStream_t s;
  err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  auto launch = [&](int n) {
    void* args[] = {&n};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(grid_sync_kernel), dim3(blocks),
        dim3(threads), args, 0, s);
  };
  float with = 0.0f, without = 0.0f;
  err = launch(syncs);  // warm-up
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err == cudaSuccess) err = time_ms(s, [&] { return launch(0); }, &without);
  if (err == cudaSuccess)
    err = time_ms(s, [&] { return launch(syncs); }, &with);
  if (err == cudaSuccess) {
    out[0] = (with - without) / syncs;
    out[1] = without;
  }
  cudaStreamDestroy(s);
  return err;
}

// out[0]: ms per cluster barrier of one kernel of `clusters` clusters of
// `cluster` CTAs of 128 threads running `syncs` barriers, less the same
// launch with none; out[1]: ms of that launch with none.
extern "C" int probe_cluster_sync(int cluster, int clusters, int syncs,
                                  float* out) {
  if (cluster < 1 || cluster > 8 || clusters < 1 || syncs < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return err;
  auto launch = [&](int n) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * clusters);
    cfg.blockDim = dim3(128);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, cluster_sync_kernel, n);
  };
  float with = 0.0f, without = 0.0f;
  err = launch(syncs);  // warm-up
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  if (err == cudaSuccess) err = time_ms(s, [&] { return launch(0); }, &without);
  if (err == cudaSuccess)
    err = time_ms(s, [&] { return launch(syncs); }, &with);
  if (err == cudaSuccess) {
    out[0] = (with - without) / syncs;
    out[1] = without;
  }
  cudaStreamDestroy(s);
  return err;
}
