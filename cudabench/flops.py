"""Operation and byte counts of the port's training steps, frozen here so
that later changes to the program cannot move the yardstick.

The counts come from the algorithm's shapes, not from any kernel: an
R-stream PINN step is its forward, its weight gradients and its data
gradients (none into the input), 2 operations per multiply-add, plus
about 12 operations per parameter for the Adam update. They read the same
work whatever implements it (the fused kernel, the scan trainer's torch
kernels or a population's vmapped ones).

Peaks are the published figures of one NVIDIA H100 SXM at its 700 W
limit: 67 TFLOP/s in fp32 outside the tensor cores and 3.35 TB/s of HBM.
Every configuration here runs strict fp32 (TF32 off), so the fp32 peak is
the one that applies.
"""

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
ADAM_FLOPS_PER_PARAM = 12


def n_params(D, H, L, O=1):
    """Parameters of a D → H×L → O tanh MLP (weights and biases)."""
    return D * H + H + L * H * H + L * H + H * O + O


def step_flops(R, B, D, H, L):
    """One step of an R-stream PINN over B points: the forward, the weight
    gradients and the data gradients (none into the input)."""
    fwd = 2 * R * B * (D * H + L * H * H + H)
    return fwd + fwd + 2 * R * B * (L * H * H + H)


def dgm_step_flops(R, B, H, L, O):
    """One DGM step (D = 1): the gate and H products forward, their weight
    and data gradients backward, the input and output layers; the
    elementwise stream rules are not counted."""
    N = R * B
    fwd = 2 * N * (H + L * (3 * H * H + 3 * H + H * H + H) + H * O)
    bwd = 2 * N * (L * ((H + 1) * 3 * H + (H + 1) * H + H * H + 3 * H * H)
                   + 2 * H * O + H)
    return fwd + bwd


def dgm_n_params(H, L, O):
    """Parameters of a DGM 1 → H×L → O."""
    return 2 * H + L * (4 * H * H + 8 * H) + H * O + O


def step_bytes(n, B, U):
    """The least bytes one Adam step moves: parameters, both moments read
    and written once, B·U uniforms read, one loss written."""
    return 4 * (6 * n + B * U + 1)


def bound_s(flops, nbytes):
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes over the HBM rate."""
    return max(flops / FP32_FLOPS, nbytes / HBM_BYTES)


def mlp_step(cfg, rows):
    """(operations, bytes) of one Adam step of an MLP configuration over
    ``rows`` live collocation points."""
    D, H, L, O = cfg["input_dim"], cfg["hidden_size"], cfg["num_layers"], \
        cfg["output_dim"]
    n = n_params(D, H, L, O)
    flops = step_flops(cfg["streams"], rows, D, H, L) \
        + ADAM_FLOPS_PER_PARAM * n
    return flops, step_bytes(n, rows, cfg["n_uniform"])


def dgm_step(cfg, rows):
    """(operations, bytes) of one Adam step of a DGM configuration."""
    H, L, O = cfg["hidden_size"], cfg["num_layers"], cfg["output_dim"]
    n = dgm_n_params(H, L, O)
    flops = dgm_step_flops(cfg["streams"], rows, H, L, O) \
        + ADAM_FLOPS_PER_PARAM * n
    return flops, step_bytes(n, rows, cfg["n_uniform"])


COUNTS = {"mlp": mlp_step, "dgm": dgm_step}


def net_step(cfg, rows):
    """(operations, bytes) of one net's Adam step over ``rows`` points, by
    the configuration's ``count`` ("mlp" | "dgm")."""
    return COUNTS[cfg["count"]](cfg, rows)
