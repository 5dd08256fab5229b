"""The fused heat trainer: K Adam steps per kernel call (csrc/heat_train.cu).

Counterpart of the JAX package's kernels/fused_train.py. Each step:

* builds the 7-stream stacked input ``[7B, 2]`` from ``[B, 2]`` uniforms
  (interior value, x/xx/t Taylor tangents, IC and two BC forwards);
* pushes it through the tanh MLP with the Taylor activation rules;
* computes the heat loss and its gradient with the hand-derived backward;
* applies Adam with torch-default hyperparameters and bias correction by the
  absolute step ``t = step0 + k + 1``.

``fused_step_math`` and ``engine_core.adam_update`` are the plain PyTorch
version of that step; the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.

Parameters and both Adam moments are each ONE flat fp32 buffer in the order
(w_in, b_in, w_hid, b_hid, w_out, b_out); ``unpack_params`` gives views.
A chunk runs at ``precision="highest"`` (every product exact fp32) or
``"default"`` (the products the JAX step math gives ``precision`` take
bf16 operands and accumulate in fp32: on the card the bf16 tensor-core
instances of the same kernels); ``train_heat_fused_result`` also takes
``"mixed"``, its first ``int(K·mixed_split)`` steps at "default" and the
rest at "highest" on the same state (core/precision.py). On the card a
chunk replays a CUDA graph of GRAPH_STEPS steps, captured on the first call
of its shape and precision and cached (kernels/graphs.py), as the MLP
engine's does; every operand is staged in k-tiles, so the kernels take any
width up to MAX_HEAT_WIDTH (:func:`heat_train_plan`).
"""

import math
import time

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.precision import (
    MIXED_SPLIT,
    check_precision,
    default_steps,
    matmul,
)
from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    replica_generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.kernels import (
    build,
    engine_core,
    graphs,
)
from differential_equations_dnn_tpu_torch.kernels.engine_core import (
    adam_update,
    check_batch_tile,
)
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.train.trainer import TrainResult
from differential_equations_dnn_tpu_torch.utils import trace

# The precisions one chunk runs at ("mixed" is a schedule of chunks).
CHUNK_PRECISIONS = ("highest", "default")


# ---------------------------------------------------------------------------
# The plain step math
# ---------------------------------------------------------------------------


def _stack_inputs(u, x_max, t_max):
    """u: [B, 2] uniforms in [0,1) → the 7-stream stacked input [7B, 2]."""
    x = x_max * u[:, :1]
    t = t_max * u[:, 1:]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        torch.cat([x, t], 1),                            # interior value
        torch.cat([one, zero], 1),                       # x-tangent
        torch.cat([zero, zero], 1),                      # xx-tangent
        torch.cat([zero, one], 1),                       # t-tangent
        torch.cat([x, zero], 1),                         # IC points (x, 0)
        torch.cat([zero, t], 1),                         # boundary x=0
        torch.cat([torch.full_like(x, x_max), t], 1),    # boundary x=x_max
    ]
    return torch.cat(rows, 0), x


def _bias_mask(B, like):
    """Value streams (interior + 3 constraints) get the bias; tangents not."""
    return torch.cat([like.new_ones((B, 1)), like.new_zeros((3 * B, 1)),
                      like.new_ones((3 * B, 1))], 0)


def _act_fwd(z, B):
    """tanh on value streams, Taylor rules on the tangent streams."""
    z0, z1, z2, z3, zc = z[:B], z[B:2 * B], z[2 * B:3 * B], z[3 * B:4 * B], \
        z[4 * B:]
    a0 = torch.tanh(z0)
    d = 1.0 - a0 * a0
    return torch.cat([a0, d * z1, d * z2 - 2.0 * a0 * d * (z1 * z1), d * z3,
                      torch.tanh(zc)], 0)


def _act_bwd(z, g, B):
    """VJP of _act_fwd: grads w.r.t. the streams a → grads w.r.t. z.

    With a0=tanh(z0), d=1−a0², d' = −2 a0 d:
      dz0 = d·g0 + d'(z1 g1 + z2 g2 + z3 g3) − 2 z1² d (d − 2 a0²) g2
      dz1 = d·g1 − 4 a0 d z1 g2,  dz2 = d·g2,  dz3 = d·g3
      dzc = (1 − tanh²(zc))·gc
    """
    z0, z1, z2, z3, zc = z[:B], z[B:2 * B], z[2 * B:3 * B], z[3 * B:4 * B], \
        z[4 * B:]
    g0, g1, g2, g3, gc = g[:B], g[B:2 * B], g[2 * B:3 * B], g[3 * B:4 * B], \
        g[4 * B:]
    a0 = torch.tanh(z0)
    d = 1.0 - a0 * a0
    dp = -2.0 * a0 * d
    dz0 = (d * g0 + dp * (z1 * g1 + z2 * g2 + z3 * g3)
           - 2.0 * (z1 * z1) * d * (d - 2.0 * a0 * a0) * g2)
    dz1 = d * g1 - 4.0 * a0 * d * z1 * g2
    ac = torch.tanh(zc)
    return torch.cat([dz0, dz1, d * g2, d * g3, (1.0 - ac * ac) * gc], 0)


def fused_step_math(params, u, B, L, x_max=math.pi, t_max=3.0, kappa=1.0,
                    precision="highest"):
    """One training step's loss and parameter gradients, in plain PyTorch.
    ``params`` = (w_in, b_in, w_hid [L,H,H], b_hid [L,H], w_out, b_out);
    ``u`` = [B, 2] uniforms; ``precision`` ("highest" | "default") that of
    every product, as the JAX step math gives it to each. Returns (loss,
    grads_tuple)."""
    w_in, b_in, w_hid, b_hid, w_out, b_out = params

    def mm(a, b):
        return matmul(a, b, precision)

    X, x_interior = _stack_inputs(u, x_max, t_max)
    mask = _bias_mask(B, X)

    zs = [mm(X, w_in) + mask * b_in]
    a = _act_fwd(zs[0], B)
    for l in range(L):
        zs.append(mm(a, w_hid[l]) + mask * b_hid[l])
        a = _act_fwd(zs[-1], B)
    out = mm(a, w_out) + mask * b_out

    u_xx = out[2 * B:3 * B]
    u_t = out[3 * B:4 * B]
    u0 = out[4 * B:5 * B]
    ub1 = out[5 * B:6 * B]
    ub2 = out[6 * B:]
    r = u_t - kappa * u_xx
    r0 = u0 - torch.sin(x_interior)
    loss = torch.mean(r * r + r0 * r0 + ub1 * ub1 + ub2 * ub2)

    s = 2.0 / B
    zeros = torch.zeros_like(r)
    G = torch.cat([zeros, zeros, -kappa * s * r, s * r, s * r0, s * ub1,
                   s * ub2], 0)

    d_w_out = mm(_act_fwd(zs[L], B).T, G)
    d_b_out = torch.sum(mask * G, 0)
    g = mm(G, w_out.T)
    d_w_hid, d_b_hid = [], []
    for l in range(L - 1, -1, -1):
        dz = _act_bwd(zs[l + 1], g, B)
        d_w_hid.append(mm(_act_fwd(zs[l], B).T, dz))
        d_b_hid.append(torch.sum(mask * dz, 0))
        g = mm(dz, w_hid[l].T)
    d_w_hid = torch.stack(d_w_hid[::-1]) if L else torch.zeros_like(w_hid)
    d_b_hid = torch.stack(d_b_hid[::-1]) if L else torch.zeros_like(b_hid)
    dz = _act_bwd(zs[0], g, B)
    d_w_in = mm(X.T, dz)
    d_b_in = torch.sum(mask * dz, 0)
    return loss, (d_w_in, d_b_in, d_w_hid, d_b_hid, d_w_out, d_b_out)


# ---------------------------------------------------------------------------
# Flat parameter buffers
# ---------------------------------------------------------------------------


def param_shapes(model):
    D, H, L, O = (model.input_dim, model.hidden_size, model.num_layers,
                  model.output_dim)
    return [(D, H), (H,), (L, H, H), (L, H), (H, O), (O,)]


def pack_params(model) -> torch.Tensor:
    """The model's parameters as one flat fp32 buffer (a copy)."""
    return torch.cat([t.detach().reshape(-1) for t in _tensors(model)])


def unpack_params(model, flat):
    """Views of the six tensors inside a flat buffer."""
    out, at = [], 0
    for shape in param_shapes(model):
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def load_params(model, flat) -> None:
    """Copy a flat buffer into the model's parameters."""
    with torch.no_grad():
        for dst, src in zip(_tensors(model), unpack_params(model, flat)):
            dst.copy_(src)


def _tensors(model):
    return (model.fc_in.w, model.fc_in.b, model.hidden.w, model.hidden.b,
            model.fc_out.w, model.fc_out.b)


_STREAMS = 7  # heat's stream rows per batch point
# The widest hidden width the plan holds (csrc/stream_layer.cuh; the MLP
# engine's MAX_WIDTH).
MAX_HEAT_WIDTH = engine_core.MAX_WIDTH


def heat_train_plan(H):
    """Bytes of dynamic shared memory per block of csrc/heat_train.cu's
    kernels at hidden width H, as the library plans them
    (``heat_train_smem_bytes``): ``layer``, the largest layer tile's ring
    of k-tiles of its 7·BB operand rows and of the weight beside the tile's
    running sums; ``weight_grad``, the largest weight-gradient tile; their
    maximum ``smem``; and ``limit``, the widest H. Every operand is staged
    in k-tiles, so the bytes are the same at every width; past the limit it
    raises a ValueError that names it."""
    if H > MAX_HEAT_WIDTH:
        raise ValueError(
            f"hidden width {H} is past the {MAX_HEAT_WIDTH} the fused heat "
            f"kernel's weight gradient tiles along the grid's y extent")
    layer, weight = engine_core.step_plan(_STREAMS)
    return {"layer": layer, "weight_grad": weight,
            "smem": max(layer, weight), "limit": MAX_HEAT_WIDTH}


def _check_model(model, device=None):
    """A plain tanh MLP 2 → H×L → 1; on a CUDA ``device`` also a width the
    kernels' plan holds (checked before the library is loaded, so nothing
    launches). The plain version takes any width."""
    if not isinstance(model, MLP) or not model.plain \
            or model.activation != "tanh" or model.input_dim != 2 \
            or model.output_dim != 1:
        raise ValueError("the fused heat kernel trains plain tanh MLPs "
                         "2 → H×L → 1 only (no BatchNorm, no Fourier "
                         "features)")
    if device is not None and torch.device(device).type == "cuda":
        heat_train_plan(model.hidden_size)


def _check_state(model, tensors, n_replicas=None):
    """Device, dtype, shape and contiguity of the flat state (``[n]``, or
    ``[N, n]`` for N packed replicas) and uniforms."""
    n = sum(math.prod(s) for s in param_shapes(model))
    shape = (n,) if n_replicas is None else (n_replicas, n)
    device = tensors["uniforms"].device
    for name, t in tensors.items():
        build.require_cuda_f32(name, t, None if name == "uniforms" else shape)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, uniforms on {device}")


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def heat_loss_grad_plain(model, params, u, x_max=math.pi, t_max=3.0,
                         kappa=1.0, precision="highest"):
    """Plain version of :func:`heat_loss_grad`."""
    loss, grads = fused_step_math(unpack_params(model, params), u,
                                  u.shape[0], model.num_layers, x_max, t_max,
                                  kappa, precision)
    return loss, torch.cat([g.reshape(-1) for g in grads])


def count_launch(fn, precision, step_math_runs=None, sweep=False,
                 shape=None):
    """One launch of ``fn``'s kernel: ``fn.launches`` counts every launch,
    ``fn.bf16_launches`` those of its "default" (bf16 tensor-core)
    instances, ``fn.sweep_launches`` those in the sweep mode (a batch mask,
    a step budget or per-slot vectors), and ``fn.sweep_shapes`` those by
    ``shape`` (the tile and the replicas, (B, N)); a training wrapper also
    adds the (replica-)steps whose step math the launch enqueued to
    ``fn.step_math_runs`` (and to ``fn.bf16_step_math_runs`` at
    "default")."""
    fn.launches += 1
    if sweep:
        fn.sweep_launches += 1
        fn.sweep_shapes[shape] = fn.sweep_shapes.get(shape, 0) + 1
    if precision == "default":
        fn.bf16_launches += 1
    if step_math_runs is not None:
        fn.step_math_runs += step_math_runs
        if precision == "default":
            fn.bf16_step_math_runs += step_math_runs


def heat_loss_grad(model, params, u, x_max=math.pi, t_max=3.0, kappa=1.0,
                   precision="highest"):
    """One step's loss and flat gradient at flat ``params`` on ``[B, 2]``
    uniforms, at ``precision`` ("highest" | "default"): the forward and
    backward launches of the training kernel without the Adam update. A CPU
    tensor takes the plain version."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(model, u.device)
    if u.device.type == "cpu":
        return heat_loss_grad_plain(model, params, u, x_max, t_max, kappa,
                                    precision)
    _check_state(model, {"params": params, "uniforms": u})
    B, H, L = u.shape[0], model.hidden_size, model.num_layers
    lib = build.library()
    scratch = torch.empty(lib.heat_scratch_floats(B, H, L), device=u.device)
    grad = torch.empty_like(params)
    loss = torch.empty((), device=u.device)
    with torch.cuda.device(u.device):
        code = lib.heat_grad(params.data_ptr(), u.data_ptr(),
                             scratch.data_ptr(), grad.data_ptr(),
                             loss.data_ptr(), B, H, L, float(x_max),
                             float(t_max), float(kappa),
                             int(precision == "default"),
                             build.stream_ptr(u.device))
    build.check(code, "heat_grad")
    count_launch(heat_loss_grad, precision)
    return loss, grad


heat_loss_grad.launches = 0
heat_loss_grad.bf16_launches = 0


def heat_fused_train_chunk_plain(model, params, m, v, uniforms, step0,
                                 lrate, x_max=math.pi, t_max=3.0, kappa=1.0,
                                 precision="highest"):
    """Plain version of :func:`heat_fused_train_chunk`."""
    check_precision(precision, CHUNK_PRECISIONS)
    K, B, _ = uniforms.shape
    losses = []
    for k in range(K):
        loss, g = heat_loss_grad_plain(model, params, uniforms[k], x_max,
                                       t_max, kappa, precision)
        t = torch.tensor(step0 + k + 1, dtype=torch.float32,
                         device=params.device)
        params, m, v = adam_update(params, m, v, g, lrate, t)
        losses.append(loss)
    return params, m, v, torch.stack(losses)


def heat_fused_train_chunk(model, params, m, v, uniforms, step0, lrate,
                           x_max=math.pi, t_max=3.0, kappa=1.0,
                           batch_tile: int | None = None,
                           precision="highest"):
    """Run ``K = uniforms.shape[0]`` Adam steps at ``precision`` ("highest"
    | "default"). ``params``/``m``/``v`` are flat fp32 buffers;
    ``uniforms`` is [K, B, 2] of U[0,1) draws; ``step0`` is the absolute
    index of the chunk's first step.

    ``batch_tile`` must divide B. Averaging equal tiles' gradients IS the
    full-batch gradient, so the kernel always computes the whole batch.

    Returns new (params, m, v, losses[K]); the inputs are left unchanged.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``heat_fused_train_chunk.launches`` counts the launches,
    ``.bf16_launches`` those at "default"): its steps replay the shape's
    cached CUDA graph of GRAPH_STEPS steps (kernels/graphs.py; one per
    shape and precision), captured by the first call of at least
    GRAPH_STEPS steps, on the shape's side stream."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(model, uniforms.device)
    K, B, _ = uniforms.shape
    check_batch_tile(B, batch_tile)
    if uniforms.device.type == "cpu":
        return heat_fused_train_chunk_plain(model, params, m, v, uniforms,
                                            step0, lrate, x_max, t_max, kappa,
                                            precision)
    _check_state(model, {"params": params, "m": m, "v": v,
                         "uniforms": uniforms})
    H, L = model.hidden_size, model.num_layers
    device = uniforms.device
    lib = build.library()
    consts = (float(x_max), float(t_max), float(kappa))
    bf16 = int(precision == "default")
    # The problem's numbers are kernel arguments of the captured graph, and
    # the precision picks its kernel instances.
    key = ("heat", B, H, L, consts, precision, graphs.GRAPH_STEPS, device)
    entry = graphs.step_graph(key, lambda: graphs.StepGraph(
        "heat", device, 1, lib.heat_scratch_floats(B, H, L),
        lib.heat_args_bytes(), lib.heat_graph_free))
    p, m, v = params.clone(), m.clone(), v.clone()
    losses = torch.empty(K, device=device)
    if K >= graphs.GRAPH_STEPS and entry.exec is None:
        with torch.cuda.device(device):
            entry.capture(lambda args, scratch, out: lib.heat_graph_build(
                B, H, L, *consts, bf16, graphs.GRAPH_STEPS, args, scratch,
                out), "heat_graph_build")
    code = entry.run(lambda stream, side0, side1: lib.heat_train(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), uniforms.data_ptr(),
        entry.scratch.data_ptr(), losses.data_ptr(), K, B, H, L, *consts,
        float(lrate), int(step0), bf16, stream, entry.args.data_ptr(),
        entry.exec, graphs.GRAPH_STEPS, side0, side1), device)
    build.check(code, "heat_train")
    count_launch(heat_fused_train_chunk, precision)
    return p, m, v, losses


heat_fused_train_chunk.launches = 0
heat_fused_train_chunk.bf16_launches = 0


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def replica_models(problem, model, seed, n_replicas, device, first=0):
    """The N replicas ``first .. first + N − 1`` of an ensemble: replica r
    is ``model``'s architecture (default: the problem's) drawn from
    ``replica_generator(seed, r)``, the JAX package's
    ``model.init(fold_in(init_key, r))``."""
    return [problem.default_model(generator=replica_generator(seed, r),
                                  device=device) if model is None
            else model.fresh(generator=replica_generator(seed, r),
                             device=device)
            for r in range(first, first + n_replicas)]


def train_ensemble(problem, model, seed, n_replicas, mesh, device,
                   train_single, train_packed, pack, load, timings=None):
    """The fused ensembles over a mesh (JAX ``train_fused_ensemble`` and
    ``train_dgm_fused_ensemble``). ``mesh=None``: the replicas one after
    another, each a whole run, ``train_single(replica_model, device)``.
    A mesh (or an ``{axis: size}`` dict made into one on ``device``):
    each rank trains its replicas ``lo .. hi − 1`` of the ``pop`` axis as
    one packed run, ``train_packed(hi − lo, lo, device)``, and the ranks
    gather every replica's flat state (``pack(model)``) and loss history.
    Both give replica r the init ``replica_generator(seed, r)`` and the
    shared stream, so replica r is the same run whatever the rank count,
    and the same as replica r of the packed ensemble.

    Returns (the N trained models, loaded by ``load(model, flat)``, on
    this rank's device; losses ``[N, iterations]`` numpy); ``timings``
    receives ``compile_time`` and ``run_time`` (this rank's)."""
    from differential_equations_dnn_tpu_torch.parallel import mesh as pm
    from differential_equations_dnn_tpu_torch.parallel.sharding import (
        gather_rows,
        shard_range,
    )

    if mesh is None:
        device = build.resolve_device(device)
        results = [train_single(
            replica_models(problem, model, seed, 1, device, r)[0], device)
            for r in range(n_replicas)]
        models = [res.params for res in results]
        losses = np.stack([res.loss_history for res in results])
    else:
        mesh = pm.as_mesh(mesh, device)
        device = pm.mesh_device(mesh)
        n_shards = pm.require_axis(mesh, "pop", "a fused ensemble (replicas "
                                   "sharded over 'pop')")
        if n_replicas % n_shards:
            raise ValueError(f"n_replicas {n_replicas} not divisible by "
                             f"'pop' mesh axis ({n_shards} shards)")
        lo, hi = shard_range(n_replicas, mesh, "pop")
        res = train_packed(hi - lo, lo, device)
        results = [res]
        flat = torch.stack([pack(m) for m in res.params])
        flat, losses = gather_rows((flat, res.loss_history), mesh, "pop")
        models = replica_models(problem, model, seed, n_replicas, device)
        for m, row in zip(models, flat):
            load(m, row)
    if timings is not None:
        timings["compile_time"] = sum(r.compile_time for r in results)
        timings["run_time"] = sum(r.wall_time for r in results)
    return models, losses


def _warm_steps(phase, chunk, device):
    """Steps of a phase's warm-up call: on the card enough for the graph
    capture its chunks will replay (GRAPH_STEPS, where a chunk of the phase
    has that many), else 1."""
    if torch.device(device).type != "cuda":
        return 1
    return max(1, min(graphs.GRAPH_STEPS, phase, chunk))


def train_in_chunks(model, run_chunk, draw, p, m, v, iterations, chunk_size,
                    device, start_step=0, load=None, n_default=0, *,
                    trainer) -> TrainResult:
    """The fused trainers' host loop. ``run_chunk(p, m, v, u, step0,
    precision)`` runs the steps of ``u = draw(step0, k)`` at ``precision``
    ("highest" | "default") and returns new (p, m, v, losses); the run's
    first ``n_default`` steps run at "default", the rest at "highest"
    (core.precision.default_steps), chained on the same state with no host
    synchronisation between them. ``load(model, p)`` (default: the MLP's
    :func:`load_params`) copies the trained flat buffer into the model.
    Packed replicas pass ``[N, n]`` state, get ``[N, k]`` losses per chunk
    (joined along the steps) and load their own ``model``, a list of N.

    A warm-up call per precision the run uses, on copies of the state, is
    timed as ``compile_time``: the kernel build, the first dispatch and, on
    the card, the capture of the CUDA graph its chunks replay (the warm-up
    takes GRAPH_STEPS steps where a chunk of the phase does). ``wall_time``
    and ``iters_per_sec`` cover the training steps only, ending in
    ``torch.cuda.synchronize()``. The trained parameters are loaded into
    ``model``, which the result returns as ``params``. ``trainer`` ("heat",
    "engine" or "dgm") names the trainer in the spans (utils/trace.py)."""
    chunk = max(1, min(chunk_size, iterations))
    phases = [("default", n_default), ("highest", iterations - n_default)]
    t0 = time.perf_counter()
    with trace.span("train.warmup", trainer=trainer):
        for precision, steps in phases:
            if steps > 0:
                k = _warm_steps(steps, chunk, device)
                run_chunk(p, m, v, draw(start_step, k), start_step,
                          precision)
        build.sync(device)
    compile_time = time.perf_counter() - t0

    losses = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        k = min(chunk, iterations - done)
        if done < n_default:
            k, precision = min(k, n_default - done), "default"
        else:
            precision = "highest"
        step = start_step + done
        with trace.span("train.draw", trainer=trainer, steps=k):
            u = draw(step, k)
        with trace.span("train.chunk", precision=precision, steps=k):
            p, m, v, chunk_losses = run_chunk(p, m, v, u, step, precision)
        losses.append(chunk_losses)
        done += k
    build.sync(device)
    wall = time.perf_counter() - t0
    (load or load_params)(model, p)
    with trace.span("train.fetch"):
        loss_history = torch.cat(losses, -1).cpu().numpy()
    return TrainResult(
        params=model,
        opt_state={"m": m, "v": v},
        loss_history=loss_history,
        wall_time=wall,
        iters_per_sec=iterations / wall if wall else float("inf"),
        compile_time=compile_time,
    )


def train_heat_fused_result(problem, seed, iterations, batch_size=64,
                            lrate=1e-4, chunk_size=25_000, model=None,
                            params=None, opt_state=None, start_step: int = 0,
                            precision="highest", mixed_split=MIXED_SPLIT,
                            device="cuda"):
    """Train the heat equation with the fused kernel; returns a TrainResult
    (see :func:`train_in_chunks` for its timings).

    ``model`` (default: ``problem.default_model()`` initialised from
    ``seed``) is trained in place and returned as ``params``. ``params`` (a
    flat buffer, :func:`pack_params`) replaces its parameters first;
    ``opt_state`` ({"m", "v"} of an earlier result) and ``start_step``
    resume a run. Step ``i`` draws its collocation points from ``(seed,
    i)`` alone and Adam's bias correction takes the absolute step, so
    neither the chunk layout nor a resume can change the run.
    ``precision`` is "highest", "default" or "mixed" (its first
    ``int(iterations·mixed_split)`` steps at "default", then "highest"; all
    "highest" where a phase would be empty)."""
    n_default = default_steps(iterations, precision, mixed_split)
    with trace.span("train.setup", trainer="heat"):
        device = build.resolve_device(device)
        if model is None:
            model = problem.default_model(generator=generator(seed))
        model.to(device)
        _check_model(model, device)
        kw = dict(x_max=problem.x_max, t_max=problem.t_max,
                  kappa=problem.kappa)
        p = pack_params(model) if params is None else params.to(device).clone()
        if opt_state is None:
            m, v = torch.zeros_like(p), torch.zeros_like(p)
        else:
            m = opt_state["m"].to(device).clone()
            v = opt_state["v"].to(device).clone()

    def run_chunk(p, m, v, u, step0, precision):
        return heat_fused_train_chunk(model, p, m, v, u, step0, lrate,
                                      precision=precision, **kw)

    def draw(start, n):
        return step_uniforms(seed, start, n, batch_size, device)

    return train_in_chunks(model, run_chunk, draw, p, m, v, iterations,
                           chunk_size, device, start_step,
                           n_default=n_default, trainer="heat")
