// The MLP engine's "default" precision (bf16 tensor-core) instances and
// their entry points (engine_grad_bf16, engine_graph_build_bf16,
// engine_train_packed_bf16, which engine_train.cu's entry points call for
// bf16 != 0): engine_train.cu compiled a second time, by an nvcc of its
// own, so that the two precisions' instances of every spec build side by
// side.
#define DEDNN_ENGINE_BF16 1
#include "engine_train.cu"
