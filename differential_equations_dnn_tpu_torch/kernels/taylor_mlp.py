"""The MLP-forward kernel (csrc/mlp_forward.cu) and its plain version.

Counterpart of the JAX package's kernels/taylor_mlp.py::mlp_forward_pallas.
``Problem.evaluate`` runs the evaluation grid through it.
"""

import torch

from differential_equations_dnn_tpu_torch.kernels import build

_ACT_KIND = {"tanh": 0, "relu": 1, "sigmoid": 2}


def mlp_forward_plain(model, x):
    """The plain PyTorch version: the same products, biases and activation."""
    return model(x)


def mlp_forward(model, x):
    """``model(x)`` for a plain MLP with a tanh, relu or sigmoid activation:
    ``x [N, D]`` → ``[N, O]``, one kernel launch for any N.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``mlp_forward.launches`` counts the launches)."""
    if x.device.type == "cpu":
        return mlp_forward_plain(model, x)
    kind = _ACT_KIND.get(model.activation)
    if kind is None:
        raise ValueError(f"mlp_forward supports {sorted(_ACT_KIND)} "
                         f"activations, not {model.activation!r}")
    n, d = x.shape
    D, H, L, O = (model.input_dim, model.hidden_size, model.num_layers,
                  model.output_dim)
    if d != D:
        raise ValueError(f"x has {d} columns, the model takes {D}")
    weights = [
        ("fc_in.w", model.fc_in.w, (D, H)), ("fc_in.b", model.fc_in.b, (H,)),
        ("hidden.w", model.hidden.w, (L, H, H)),
        ("hidden.b", model.hidden.b, (L, H)),
        ("fc_out.w", model.fc_out.w, (H, O)),
        ("fc_out.b", model.fc_out.b, (O,)),
    ]
    build.require_cuda_f32("x", x)
    for name, t, shape in weights:
        build.require_cuda_f32(name, t, shape)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    y = torch.empty((n, O), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.mlp_forward(x.data_ptr(), *(t.data_ptr() for _, t, _ in
                                               weights),
                               y.data_ptr(), n, D, H, L, O, kind,
                               build.stream_ptr(x.device))
    build.check(code, "mlp_forward")
    mlp_forward.launches += 1
    return y


mlp_forward.launches = 0
