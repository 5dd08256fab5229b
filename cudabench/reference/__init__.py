"""The plain reference of the benchmark's cells: straightforward PyTorch
(autograd derivatives, eager ops, fp32 with TF32 off) that rebuilds from a
seed what the program derives (initial weights, collocation draws) and
follows its first training steps. It imports nothing of the program and
nothing of the JAX package."""
