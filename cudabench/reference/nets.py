"""The two networks of the benchmark's configurations, as plain functions
of a dict of tensors: a tanh MLP D → H×L → O and the DGM gate network
1 → H×L → O. The initial draws are a frozen copy of the program's (its
``models/mlp.py`` and ``models/dgm.py`` with their ``core/init.py``), in
the same order from the same generator, so a seed gives the program's
initial weights bit for bit. Weights are stored ``[fan_in, fan_out]``
(``y = x @ w + b``) under the program's parameter names."""

import math

import torch

TANH_GAIN = 5.0 / 3.0


def _uniform(shape, bound, g):
    return torch.empty(shape, dtype=torch.float32).uniform_(-bound, bound,
                                                            generator=g)


def _xavier(shape, gain, g):
    return _uniform(shape, gain * math.sqrt(6.0 / (shape[-2] + shape[-1])), g)


def _linear_default(shape, g, with_bias=True):
    """nn.Linear's default draws for a [fan_in, fan_out] weight: the weight
    first, then the bias, both U(±1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(shape[0])
    w = _uniform(shape, bound, g)
    b = _uniform((shape[1],), bound, g) if with_bias else None
    return w, b


def mlp_init(D, H, L, O, g):
    """A tanh MLP's parameters drawn from generator ``g``: xavier weights
    (tanh gain, gain 1 on the output layer), then nn.Linear-default biases
    (each bias draw preceded by the weight draw nn.Linear makes)."""
    w_in = _xavier((D, H), TANH_GAIN, g)
    w_hid = torch.stack([_xavier((H, H), TANH_GAIN, g) for _ in range(L)])
    w_out = _xavier((H, O), 1.0, g)
    b_in = _linear_default((D, H), g)[1]
    b_hid = torch.stack([_linear_default((H, H), g)[1] for _ in range(L)])
    b_out = _linear_default((H, O), g)[1]
    return {"fc_in.w": w_in, "fc_in.b": b_in, "hidden.w": w_hid,
            "hidden.b": b_hid, "fc_out.w": w_out, "fc_out.b": b_out}


def mlp_forward(p, x):
    h = torch.tanh(x @ p["fc_in.w"] + p["fc_in.b"])
    for l in range(p["hidden.w"].shape[0]):
        h = torch.tanh(h @ p["hidden.w"][l] + p["hidden.b"][l])
    return h @ p["fc_out.w"] + p["fc_out.b"]


def dgm_init(D, H, L, O, g):
    """A DGM's parameters drawn from ``g`` by the nn.Linear defaults (the
    reference's dgm_net.py init), in the program's order."""

    def weight(shape):
        return _linear_default(shape, g, with_bias=False)[0]

    def bias():
        return _linear_default((H, H), g)[1]

    w_in, b_in = _linear_default((D, H), g)
    layers = []
    for _ in range(L):
        w = [weight((H, H)) for _ in range(3)]
        u = [weight((D, H)) for _ in range(3)]
        bzgr = torch.cat([bias() for _ in range(3)])
        wh, uh, bh = weight((H, H)), weight((D, H)), bias()
        layers.append({"Wzgr": torch.cat(w, 1), "Uzgr": torch.cat(u, 1),
                       "bzgr": bzgr, "Wh": wh, "Uh": uh, "bh": bh})
    w_out, b_out = _linear_default((H, O), g)
    p = {"s_in.w": w_in, "s_in.b": b_in}
    for name in ("Wzgr", "Uzgr", "bzgr", "Wh", "Uh", "bh"):
        p[f"layers.{name}"] = torch.stack([t[name] for t in layers])
    p.update({"s_out.w": w_out, "s_out.b": b_out})
    return p


def dgm_forward(p, x):
    H = p["s_in.w"].shape[1]
    s = torch.tanh(x @ p["s_in.w"] + p["s_in.b"])
    for l in range(p["layers.Wh"].shape[0]):
        zgr = torch.tanh(s @ p["layers.Wzgr"][l] + x @ p["layers.Uzgr"][l]
                         + p["layers.bzgr"][l])
        z, gate, r = zgr[:, :H], zgr[:, H:2 * H], zgr[:, 2 * H:]
        h = torch.tanh((s * r) @ p["layers.Wh"][l] + x @ p["layers.Uh"][l]
                       + p["layers.bh"][l])
        s = (1.0 - gate) * h + z * s
    return s @ p["s_out.w"] + p["s_out.b"]


INITS = {"mlp": mlp_init, "dgm": dgm_init}
FORWARDS = {"mlp": mlp_forward, "dgm": dgm_forward}


def init(cfg, g):
    """The initial parameters of configuration ``cfg`` from ``g``."""
    return INITS[cfg["model"]](cfg["input_dim"], cfg["hidden_size"],
                               cfg["num_layers"], cfg["output_dim"], g)


def forward(cfg, p, x):
    return FORWARDS[cfg["model"]](p, x)


def read_params(module):
    """A trained module's parameters as a dict of detached fp32 tensors,
    by name: how the reference reads what the program produced."""
    return {k: v.detach().float() for k, v in module.named_parameters()}
