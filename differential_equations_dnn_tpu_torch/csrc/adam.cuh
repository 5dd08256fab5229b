// The update that ends every step of the fused engines (kernel #4,
// engine_core.py::fused_adam_kernel, and its packed-replica twin #5,
// fused_packed_adam_kernel): the learning rate of the step under its
// schedule and Adam with torch defaults, per element (adam_step,
// adam_apply). Both engines apply them in the epilogue of the shared weight
// gradient (fused_step.cuh), to the gradient summed over the streams in
// stream order.
//
// The kernels sit in an unnamed namespace: each source that includes this
// header compiles its own instance (the library is built without
// relocatable device code), from this one definition.
#pragma once

#include <cuda_runtime.h>

namespace dednn {
namespace {

constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
// As the JAX package rounds them: 1 - b in double, then to fp32.
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kLogB1 = static_cast<float>(-0.10536051565782628);
constexpr float kLogB2 = static_cast<float>(-0.0010005003335835344);
constexpr float kPi = static_cast<float>(3.14159265358979323846);

// The learning-rate schedule of fused_adam_kernel (engine_core.py:128-151).
struct Schedule {
  int kind;         // 0 constant, 1 cosine, 2 exponential
  float horizon;    // total_steps
  float decay;      // lr decays to lr * decay
  float half_span;  // (1 - decay) / 2, rounded from double
  float log_decay;  // log(decay), rounded from double
};

// The scalars of Adam's step t (1-indexed): lr(t) under the schedule and
// the two bias corrections.
struct AdamStep {
  float lr_t, c1, c2;
};

__device__ __forceinline__ AdamStep adam_step(float lr, float t,
                                              const Schedule& sched) {
  float lr_t = lr;
  if (sched.kind == 1) {
    const float frac = fminf((t - 1.0f) / sched.horizon, 1.0f);
    lr_t = lr * (sched.decay + sched.half_span * (1.0f + cosf(kPi * frac)));
  } else if (sched.kind == 2) {
    lr_t = lr * expf(((t - 1.0f) / sched.horizon) * sched.log_decay);
  }
  return {lr_t, 1.0f - expf(t * kLogB1), 1.0f - expf(t * kLogB2)};
}

// Adam with torch defaults on one element's p, m, v (in registers), given
// its gradient.
__device__ __forceinline__ void adam_apply(float& p, float& m, float& v,
                                           float gi, const AdamStep& s) {
  m = kB1 * m + kOneMinusB1 * gi;
  v = kB2 * v + kOneMinusB2 * (gi * gi);
  p = p - s.lr_t * (m / s.c1) / (sqrtf(v / s.c2) + kEps);
}

}  // namespace
}  // namespace dednn
