"""Where one Adam step's device time goes, per CUDA kernel, on the card.

    python -m differential_equations_dnn_tpu_torch.kernels.profile [NAME ...]

For each equation NAME (default: all twelve), at its reference defaults
and seed 0, it runs one warm-up chunk of the fused trainer of its route
(constant-lr heat: the heat kernel; fitzhugh_nagumo and fredholm: the DGM
engine; the rest, volterra, uat and inverse_heat among them, with their
const operands: the generic engine), then
times one chunk of K steps with CUDA events and profiles another with
``torch.profiler``. It prints the µs per step of each kernel name (device
time summed over the chunk, over K), the launches per step, the summed
kernel time against the event-timed step, and the card's name and power
limit. With ``--replicas N [N ...]`` it times the packed-replica kernel
(#5) instead, one run per N: N replicas drawn from ``replica_generator(0,
r)`` in every launch, with µs per packed step and per replica-step. With
``--solve-seeds N`` it also runs ``solve(NAME, engine="fused")`` at the
reference defaults (or with ``--solve-args``, which may name
``"engine": "scan"``) for seeds 0 .. N−1 and prints each MAE and warm
it/s. With ``--scan NAME [NAME ...]`` it times
steps of the scan trainer (train.trainer.make_train_step, default model
and config, seed 0) instead, as ``train`` runs them on the card: replays
of one captured CUDA graph of GRAPH_STEPS steps (train.trainer.ScanGraph),
``--taps`` choosing heat's taps: the same per-kernel lines, launches per
step, and the device's idle share of the event-timed step. ``--scan NAME --solve-seeds N`` runs
``solve(NAME, engine="scan")`` for every taps of ``--taps``, Adam update of
``--adam`` (torch's fused or foreach) and seed, ``--workers`` at a time,
and compares the taps' loss histories. ``--probe`` times what a fused
DGM step is built from instead: the gap between the kernel nodes of a CUDA
graph, a grid-wide barrier (the floor of one persistent kernel per step),
a thread block cluster barrier (the heat-streams kernel's between layers),
and the DGM gemm at its four product shapes for 1 and 16 replicas beside
one fp32 ``torch.addmm`` / ``torch.baddbmm`` call (TF32 off) on the same
operands, a yardstick the port never calls. ``--dgm-outputs PATH`` saves
the DGM kernels' outputs at fixed inputs (FitzHugh–Nagumo and Fredholm:
one step's loss and gradient, a 120-step single chunk, a 53-step packed
chunk of 16 and 4 replicas), ``--engine-outputs PATH`` the MLP engine's
(heat2d, wave, simple_ode and poisson at H = 128: one step's loss and
gradient, a 120-step single chunk, a 53-step packed chunk of 8 replicas);
``--heat-outputs PATH`` kernel #1's (heat at H = 128: one step's loss and
gradient, a 120-step chunk), ``--streams-outputs PATH`` kernel #3's (the 7
streams for tanh, sigmoid and relu at B = 64 and 1 000, H = 128, L = 3),
``--mlp-outputs PATH`` kernel #2's (each shape of ``MLP_SHAPES``, and every
activation, depth 0, 1, 3, input width 1-3, output width 1-2 and ragged N
in {1, 25, 77} at H = 50 and 128), ``--population-outputs PATH`` the
population tier's (heat populations of 4 run twice by graph and once
eagerly, and the scores of a TPE population sweep; ``--deterministic``
runs it under ``torch.use_deterministic_algorithms``);
with ``--compare-to OLD`` each compares them with a file that an earlier
tree saved, tensor by tensor, bit for bit. All use only entry points every
version of the kernels has, so an earlier tree's package can run them:
``PYTHONPATH=<that tree> python -P <this file> --dgm-outputs OLD`` (``-P``
keeps this file's directory off the path). ``--engine`` times constant-lr
heat on the generic engine instead of kernel #1. ``--streams`` times
kernel #3's device time per call instead (B = 64 and 1 000, H = 128, 256
and 512). ``--mlp`` times kernel #2's device time per call at each shape
of ``MLP_SHAPES`` (N = 25 to 2^20, H = 32 to 1 024). ``--probe-engine``
times each kernel of the MLP engine alone (back to back, behind a spin
kernel) at heat2d's layout: B = 256 and 2 048 at H = 128, B = 256 at H = 512.
``--steady`` times 1 000-step chunks of the fused routes outside the sweep
mode (#1 heat, heat2d, wave × 8, FitzHugh–Nagumo × 1 and × 16; an earlier
tree's package can run it as the outputs above), ``--rung`` a 27-slot
heat rung at tile 64 with 27, 9, 3 and 1 live slots. Needs a CUDA device.

    python -m differential_equations_dnn_tpu_torch.kernels.profile \
        fitzhugh_nagumo wave --replicas 1 4 8 16
    python -m differential_equations_dnn_tpu_torch.kernels.profile \
        --scan heat --taps pallas
    python -m differential_equations_dnn_tpu_torch.kernels.profile \
        --scan heat --solve-seeds 5 --taps taylor pallas jvp \
        --adam fused foreach --workers 8 --out scan_seeds.json
    python -m differential_equations_dnn_tpu_torch.kernels.profile --probe
"""

import argparse
import ctypes
import functools
import json
import multiprocessing
import os
import re
import subprocess
from collections import defaultdict
from concurrent import futures
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    replica_generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.equations import PROBLEMS
from differential_equations_dnn_tpu_torch.kernels import build, engine_core
from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
from differential_equations_dnn_tpu_torch.kernels import fused_train as ft
from differential_equations_dnn_tpu_torch.train.trainer import (
    TrainConfig,
    draw_batches,
    make_optimizer,
    make_train_step,
)

STEPS = 200
DGM = ("fitzhugh_nagumo", "fredholm")
SPIN_CYCLES = 500_000_000  # about 0.3 s: the host queues a timed run behind it


def _chunk_fn(name, device, engine=False):
    """A closure running STEPS steps of NAME's fused route from step 0
    (``engine``: constant-lr heat on the generic engine, not kernel #1)."""
    prob = PROBLEMS[name]()
    d = prob.defaults
    model = prob.default_model(generator=generator(0), device=device)
    if name in DGM:
        spec = fd.spec_for(prob, d.batch_size)
        const = fd.const_for(spec, prob, d.batch_size, device)
        p = fd.pack_dgm(model)
        z = torch.zeros_like(p)
        u = step_uniforms(0, 0, STEPS, d.batch_size, device, spec.n_uniform)
        return lambda: fd.fused_dgm_chunk(spec, model, p, z, z, u, 0, d.lrate,
                                          const=const, schedule=d.schedule,
                                          total_steps=d.iterations)
    if name == "heat" and d.schedule == "constant" and not engine:
        p = ft.pack_params(model)
        z = torch.zeros_like(p)
        u = step_uniforms(0, 0, STEPS, d.batch_size, device)
        return lambda: ft.heat_fused_train_chunk(model, p, z, z, u, 0,
                                                 d.lrate)
    spec = fe.spec_for(prob)
    p = fe.pack_state(spec, model)
    z = torch.zeros_like(p)
    const = spec.make_const(d.batch_size, device)
    u = step_uniforms(0, 0, STEPS, d.batch_size, device, spec.n_uniform)
    return lambda: fe.fused_engine_chunk(spec, model, p, z, z, u, 0, d.lrate,
                                         schedule=d.schedule,
                                         total_steps=d.iterations,
                                         const=const)


def _packed_fn(name, device, n_replicas):
    """A closure running STEPS steps of NAME's packed kernel, N replicas."""
    prob = PROBLEMS[name]()
    d = prob.defaults
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=device) for r in range(n_replicas)]
    kw = dict(schedule=d.schedule, total_steps=d.iterations)
    if name in DGM:
        spec = fd.spec_for(prob, d.batch_size)
        kw["const"] = fd.const_for(spec, prob, d.batch_size, device)
        pack, chunk = fd.pack_dgm, fd.fused_dgm_packed_chunk
    else:
        spec = fe.spec_for(prob)
        kw["const"] = spec.make_const(d.batch_size, device)
        chunk = fe.fused_engine_packed_chunk

        def pack(model):
            return fe.pack_state(spec, model)
    p = engine_core.stack_replicas([pack(m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, STEPS, d.batch_size, device, spec.n_uniform)
    return lambda: chunk(spec, models[0], p, z, z, u, 0, d.lrate, n_replicas,
                         **kw)


def _scan_fn(name, device, taps=None):
    """A closure replaying one CUDA graph of GRAPH_STEPS scan-trainer steps
    of NAME (``run.steps``), each on its own batch (drawn up front, on the
    device), from the default model, as ``train`` replays them. (Imported
    here, so that an earlier tree's package can run this file's other
    modes.)"""
    from differential_equations_dnn_tpu_torch.train.trainer import (
        GRAPH_STEPS,
        DeviceSchedule,
        ScanGraph,
    )

    prob = PROBLEMS[name](**({"taps": taps} if taps else {}))
    d = prob.defaults
    model = prob.default_model(generator=generator(0), device=device)
    config = TrainConfig(iterations=d.iterations, batch_size=d.batch_size,
                         lrate=d.lrate, schedule=d.schedule, verbose=False)
    optimizer = make_optimizer(config, model.parameters())
    schedule = DeviceSchedule(optimizer)
    step = make_train_step(prob, model, optimizer, d.batch_size,
                           schedule=schedule)
    block = draw_batches(prob, 0, 0, GRAPH_STEPS, step.draw_size, device)
    graph = ScanGraph(step, block, model, optimizer, schedule, name)

    def run():
        graph.replay(block)
    run.steps = GRAPH_STEPS
    return run


def _kernel_times(prof):
    """{kernel name: (device µs, calls)} of the profiled CUDA kernels and
    copies. A user annotation's range on the device timeline (such as
    ``Optimizer.step#Adam.step``, gaps included) is not a kernel."""
    out = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if (us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.is_user_annotation):
            found = re.search(r"\w+_kernel(<[^>]*>)?", ev.key)
            short = found.group(0) if found else ev.key[:40]
            out[short][0] += us
            out[short][1] += ev.count
    return out


def _event_us(run):
    """µs per step of ``run()`` (``run.steps`` steps, else STEPS) between
    CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / getattr(run, "steps", STEPS)


def profile(name, device, n_replicas=None, scan_taps=False, engine=False):
    """``scan_taps``: profile the scan trainer's step (None: the equation's
    default taps) rather than the fused route; ``engine``: constant-lr heat
    on the generic engine."""
    if scan_taps is not False:
        run = _scan_fn(name, device, scan_taps)
    elif n_replicas is None:
        run = _chunk_fn(name, device, engine)
    else:
        run = _packed_fn(name, device, n_replicas)
    run()
    torch.cuda.synchronize(device)
    steps = getattr(run, "steps", STEPS)
    step_us = _event_us(run)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize(device)
    # Timed again: what a profiler session leaves behind in the process
    # (its host-side hooks) shows in a host-bound step.
    after_us = _event_us(run)
    times = _kernel_times(prof)
    total = sum(us for us, _ in times.values()) / steps
    label = name if n_replicas is None else (
        f"{name} packed, N={n_replicas} ({step_us / n_replicas:.2f} us per "
        f"replica-step)")
    if scan_taps is not False:
        label = f"{name} scan step (taps={scan_taps or 'default'})"
    elif engine and name == "heat":
        label = f"{name} on the generic engine (constant lr)"
    launches = sum(calls for _, calls in times.values()) / steps
    share = total / step_us
    # Above 1 the kernels overlap (the DGM step's weight-gradient branches),
    # and the idle share is not defined by this sum.
    idle = (f"idle {1 - share:.3f}" if share <= 1 else
            "kernels overlap on parallel streams")
    print(f"{label}: {step_us:.2f} us/step (CUDA events, K={steps}); "
          f"kernels {total:.2f} us/step under the profiler "
          f"(share of the event-timed step {share:.3f}, {idle}); "
          f"{launches:.1f} launches/step; "
          f"{after_us:.2f} us/step after the profiler session")
    for kernel, (us, calls) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kernel:24s} {us / steps:8.2f} us/step  "
              f"{calls / steps:5.2f} launches/step  "
              f"{us / calls:7.2f} us/launch")


def solve_seeds(name, n_seeds, **solve_kw):
    """MAE and warm it/s of ``solve(name, engine="fused", **solve_kw)`` per
    seed (inverse_heat: and the κ̂ error); ``solve_kw`` may name another
    engine."""
    from differential_equations_dnn_tpu_torch import solve

    solve_kw = {"engine": "fused", **solve_kw}
    maes = []
    for seed in range(n_seeds):
        res = solve(name, seed=seed, **solve_kw)
        maes.append(res.mae)
        kappa = (f", kappa error {res.problem.kappa_error(res.params):.6g}"
                 if hasattr(res.problem, "kappa_error") else "")
        print(f"  solve({name!r}, seed={seed}, **{solve_kw}): MAE "
              f"{res.mae:.6g}{kappa}, {res.iters_per_sec:.1f} it/s warm "
              f"(wall {res.wall_time:.3f} s), final loss "
              f"{res.loss_history[-1]:.4g}")
    print(f"  {name} MAE over seeds 0-{n_seeds - 1}: min {min(maes):.6g}, "
          f"max {max(maes):.6g}")


def _scan_solve(job):
    """One ``solve(name, engine="scan")`` of :func:`scan_seeds`, in a worker
    process: (name, taps, adam, seed) → (MAE, it/s, loss history)."""
    from differential_equations_dnn_tpu_torch import solve
    from differential_equations_dnn_tpu_torch.train import trainer

    name, taps, adam, seed = job
    with mock.patch.object(trainer, "make_optimizer", functools.partial(
            trainer.make_optimizer, fused=adam == "fused")):
        res = solve(name, engine="scan", seed=seed,
                    **({"taps": taps} if taps else {}))
    return res.mae, res.iters_per_sec, res.loss_history


def scan_seeds(name, taps_list, adams, n_seeds, workers, out=None):
    """MAE, warm it/s and loss history of ``solve(name, engine="scan")`` at
    the reference defaults for every (taps, Adam update, seed), ``workers``
    runs at a time, each in its own process (the scan step is host-bound:
    one core drives the card well under 10 % busy). Then, per Adam update
    and seed, where the loss histories of each taps part from the first's:
    the first step whose relative difference exceeds 1e-3 and 1e-1, and the
    mean loss of the last 1 000 steps."""
    jobs = [(name, taps, adam, seed) for seed in range(n_seeds)
            for adam in adams for taps in taps_list]
    build.library()  # built once, before the workers load it
    runs = {}
    ctx = multiprocessing.get_context("spawn")
    with futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        pending = {pool.submit(_scan_solve, job): job for job in jobs}
        for done in futures.as_completed(pending):
            job = pending[done]
            mae, rate, history = done.result()
            runs[job[1:]] = (mae, rate, history)
            print(f"  solve({name!r}, engine='scan', taps={job[1]!r}, "
                  f"seed={job[3]}) with {job[2]} Adam: MAE {mae:.6g}, "
                  f"{rate:.1f} it/s warm ({workers} runs at a time), final "
                  f"loss {history[-1]:.4g}, mean of the last 1000 "
                  f"{np.mean(history[-1000:]):.4g}", flush=True)
    summary = {"runs": [], "divergence": []}
    for adam in adams:
        for taps in taps_list:
            maes = [runs[(taps, adam, s)][0] for s in range(n_seeds)]
            summary["runs"].append({"taps": taps, "adam": adam,
                                    "mae": maes})
            print(f"  {name} taps={taps!r}, {adam} Adam, MAE over seeds 0-"
                  f"{n_seeds - 1}: " + ", ".join(f"{m:.6g}" for m in maes)
                  + f" (median {np.median(maes):.6g})")
    # Pairs of runs on the same draws: each taps against the first (same
    # Adam), and each Adam against the first (same taps), the rounding
    # noise a change of update alone brings.
    pairs = ([((taps, adam), (taps_list[0], adam)) for adam in adams
              for taps in taps_list[1:]]
             + [((taps, adam), (taps, adams[0])) for taps in taps_list
                for adam in adams[1:]])
    for (a, b) in pairs:
        for seed in range(n_seeds):
            ref = runs[(*b, seed)][2]
            rel = (np.abs(runs[(*a, seed)][2] - ref)
                   / np.maximum(np.abs(ref), 1e-30))
            first = {f"{tol:g}": int(np.argmax(rel > tol))
                     if np.any(rel > tol) else None for tol in (1e-3, 1e-1)}
            summary["divergence"].append({"run": a, "against": b,
                                          "seed": seed,
                                          "first_step_above": first})
            print(f"  seed {seed}: taps={a[0]!r} with {a[1]} Adam against "
                  f"taps={b[0]!r} with {b[1]} Adam: first step with "
                  f"relative loss difference > 1e-3: {first['0.001']}, "
                  f"> 1e-1: {first['0.1']}")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(summary, indent=1))


def _spin_ms(run, calls):
    """Milliseconds per call of ``run()`` (which makes ``calls`` calls) on
    the card alone: queued behind a spin kernel, so the events time the
    calls back to back and not the host; fails if the spin ended first."""
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    run()
    end.record()
    if start.query():
        raise RuntimeError("the spin ended before the host queued the run")
    end.synchronize()
    return start.elapsed_time(end) / calls


def probe(device):
    """The floors of the two designs of a fused step (CUDA-graph nodes, or
    one persistent kernel with grid-wide barriers between its ~46 phases),
    and the DGM gemm at its shapes beside the fp32 library product."""
    lib = build.library()
    out = (ctypes.c_float * 2)()
    for blocks, threads in ((1, 32), (132, 128), (528, 128)):
        build.check(lib.probe_graph_gap(46, blocks, threads, 200,
                                        ctypes.addressof(out)),
                    "probe_graph_gap")
        print(f"graph of 46 empty kernels of {blocks} x {threads}: "
              f"{out[0] * 1e3:.3f} us per node replayed, "
              f"{out[1] * 1e3:.3f} us per kernel launched from the host")
    for blocks in (132, 264):
        build.check(lib.probe_grid_sync(blocks, 128, 2000,
                                        ctypes.addressof(out)),
                    "probe_grid_sync")
        print(f"grid-wide barrier (cooperative_groups, {blocks} x 128): "
              f"{out[0] * 1e3:.3f} us per barrier, the launch alone "
              f"{out[1] * 1e3:.3f} us; 46 phases: "
              f"{46 * out[0] * 1e3:.1f} us per step")
    for cluster, clusters in ((8, 8), (8, 16)):
        build.check(lib.probe_cluster_sync(cluster, clusters, 2000,
                                           ctypes.addressof(out)),
                    "probe_cluster_sync")
        print(f"cluster barrier ({clusters} clusters of {cluster} x 128, "
              f"as the heat-streams kernel between layers): "
              f"{out[0] * 1e3:.3f} us per barrier, the launch alone "
              f"{out[1] * 1e3:.3f} us")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = torch.empty(lib.dgm_args_bytes(), dtype=torch.uint8,
                       device=device)
    rows, launches = 300, 200
    gen = torch.Generator(device=device).manual_seed(0)
    for n in (1, 16):
        for trans, K, M in ((0, 128, 384), (0, 128, 128), (1, 128, 128),
                            (1, 384, 128)):
            ss = rows * max(K, M)
            a = torch.randn(n * ss, device=device, generator=gen)
            w = torch.randn(n * K * M, device=device, generator=gen)
            c = torch.empty(n * ss, device=device)
            stream = build.stream_ptr(device)

            def kernel(calls=launches):
                build.check(lib.dgm_gemm_probe(
                    trans, a.data_ptr(), w.data_ptr(), c.data_ptr(),
                    args.data_ptr(), rows, K, M, n, ss, calls, stream),
                    "dgm_gemm_probe")

            ms = _spin_ms(kernel, launches)
            a3 = a.view(n, ss)[:, :rows * K].reshape(n, rows, K)
            w3 = (w.view(n, M, K).transpose(1, 2) if trans
                  else w.view(n, K, M))
            got = c.view(n, ss)[:, :rows * M].reshape(n, rows, M)
            want = torch.bmm(a3, w3)
            err = float((got - want).abs().max())
            add = torch.zeros((n, rows, M), device=device)
            res = torch.empty((n, rows, M), device=device)

            def library():
                for _ in range(launches):
                    if n == 1:
                        torch.addmm(add[0], a3[0], w3[0], out=res[0])
                    else:
                        torch.baddbmm(add, a3, w3, out=res)

            lib_ms = _spin_ms(library, launches)
            flops = 2 * n * rows * K * M
            print(f"gemm N={n} [{rows}, {K}] x {'Wt' if trans else 'W'} -> "
                  f"[{rows}, {M}]: kernel {ms * 1e3:.2f} us "
                  f"({flops / ms / 1e9:.2f} TFLOP/s; max|diff| against "
                  f"torch.bmm {err:.3g}), library_ms {lib_ms:.5f} "
                  f"({'addmm' if n == 1 else 'baddbmm'}, fp32, TF32 off)")


# engine_probe's kernels, as csrc/engine_train.cu numbers them.
_ENGINE_PROBES = ("layer forward", "layer backward", "weight gradient",
                  "loss", "input")


def probe_engine(device, B=256, H=128, launches=200):
    """Device µs per launch of each MLP-engine kernel at heat2d's layout (R =
    11, D = 3) with batch B and width H, at the tile a step picks, launched
    back to back behind a spin kernel (each alone on the card, unlike in a
    step, where the weight gradients run side by side)."""
    from differential_equations_dnn_tpu_torch.kernels import graphs

    lib = build.library()
    n = 3 * H + H + H * H + H + H + 1
    gen = torch.Generator(device=device).manual_seed(0)
    params = 0.1 * torch.randn(2 * n, device=device, generator=gen)
    scratch = torch.rand(lib.engine_scratch_floats(6, B, H, 1, 1),
                         device=device, generator=gen)
    args = graphs.args_block(lib.engine_args_bytes(), device)
    stream = build.stream_ptr(device)
    for kind, what in enumerate(_ENGINE_PROBES):
        def run(calls=launches):
            build.check(lib.engine_probe(
                kind, B, H, calls, params.data_ptr(), scratch.data_ptr(),
                args.data_ptr(), stream), "engine_probe")

        ms = _spin_ms(run, launches)
        print(f"engine probe B={B} H={H}: {what}: {ms * 1e3:.2f} us per "
              f"launch")


def dgm_outputs(device):
    """The DGM kernels' outputs at fixed inputs, as CPU tensors by name, at
    each precision of OUTPUT_PRECISIONS."""
    out = {}
    for name, n_replicas in (("fitzhugh_nagumo", 16), ("fredholm", 4)):
        prob = PROBLEMS[name]()
        d = prob.defaults
        B = d.batch_size
        spec = fd.spec_for(prob, B)
        const = fd.const_for(spec, prob, B, device)
        models = [prob.default_model(generator=replica_generator(0, r),
                                     device=device)
                  for r in range(n_replicas)]
        p = engine_core.stack_replicas([fd.pack_dgm(m) for m in models])
        z = torch.zeros_like(p)
        u = step_uniforms(0, 100, 120, B, device, spec.n_uniform)
        for pr, tag in OUTPUT_PRECISIONS:
            kw = dict(const=const, schedule="cosine", total_steps=300,
                      precision=pr)
            loss, grad = fd.dgm_loss_grad(spec, models[0],
                                          p[0].contiguous(), u[0], const,
                                          precision=pr)
            out[f"{name}{tag} step loss"] = loss.reshape(1)
            out[f"{name}{tag} step grad"] = grad
            single = fd.fused_dgm_chunk(spec, models[0], p[0].contiguous(),
                                        z[0].clone(), z[0].clone(), u, 100,
                                        d.lrate, **kw)
            packed = fd.fused_dgm_packed_chunk(spec, models[0], p, z, z,
                                               u[:53], 100, d.lrate,
                                               n_replicas, **kw)
            for what, tensors in (("single", single), ("packed", packed)):
                for part, t in zip(("p", "m", "v", "losses"), tensors):
                    out[f"{name}{tag} {what} {part}"] = t
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


# The MLP engine's outputs: (equation, problem arguments, hidden layers of a
# tanh MLP at H = 128, or None for the equation's default model). The last
# four take the loss kernels of their own: volterra's folded groups,
# inverse_heat's extra tensor, uat's grid, causal advection's cross-point
# loss.
ENGINE_OUTPUTS = (("heat2d", {}, 3), ("wave", {}, 3), ("simple_ode", {}, 1),
                  ("poisson", {}, 3), ("volterra", {}, None),
                  ("inverse_heat", {}, None), ("uat", {}, None),
                  ("advection", dict(c=50.0, causal_eps=5.0), None))
# Each output at both precisions of the kernels: (precision, key suffix).
OUTPUT_PRECISIONS = (("highest", ""), ("default", " [default]"))


def engine_outputs(device):
    """The MLP engine's outputs at fixed inputs, as CPU tensors by name:
    per equation of ENGINE_OUTPUTS (replica r drawn from
    replica_generator(0, r)) and precision of OUTPUT_PRECISIONS, one step's
    loss and gradient, a 120-step single chunk (graph boundaries at 50 and
    100) and a 53-step packed chunk of 8 replicas, each from step 100 under
    a cosine schedule over 300 steps; p, m, v and the losses. Only entry
    points every version of the engine with the "default" precision
    has."""
    from differential_equations_dnn_tpu_torch.models import MLP

    out = {}
    n_replicas = 8
    for name, extra, L in ENGINE_OUTPUTS:
        prob = PROBLEMS[name](**extra)
        d = prob.defaults
        B = d.batch_size
        spec = fe.spec_for(prob)
        models = [MLP(spec.input_dim, 1, 128, L, "tanh",
                      generator=replica_generator(0, r), device=device)
                  if L is not None else
                  prob.default_model(generator=replica_generator(0, r),
                                     device=device)
                  for r in range(n_replicas)]
        p = engine_core.stack_replicas([fe.pack_state(spec, m)
                                        for m in models])
        z = torch.zeros_like(p)
        u = step_uniforms(0, 100, 120, B, device, spec.n_uniform)
        const = spec.make_const(B, device)
        for pr, tag in OUTPUT_PRECISIONS:
            kw = dict(schedule="cosine", total_steps=300, const=const,
                      precision=pr)
            loss, grad = fe.engine_loss_grad(spec, models[0],
                                             p[0].contiguous(), u[0], const,
                                             precision=pr)
            out[f"{name}{tag} step loss"] = loss.reshape(1)
            out[f"{name}{tag} step grad"] = grad
            single = fe.fused_engine_chunk(spec, models[0],
                                           p[0].contiguous(), z[0].clone(),
                                           z[0].clone(), u, 100, d.lrate,
                                           **kw)
            packed = fe.fused_engine_packed_chunk(spec, models[0], p, z, z,
                                                  u[:53], 100, d.lrate,
                                                  n_replicas, **kw)
            for what, tensors in (("single", single), ("packed", packed)):
                for part, t in zip(("p", "m", "v", "losses"), tensors):
                    out[f"{name}{tag} {what} {part}"] = t
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def heat_outputs(device):
    """Kernel #1's outputs at fixed inputs, as CPU tensors by name: heat's
    default model (2 → 128×3 → 1 from generator(0)), at each precision of
    OUTPUT_PRECISIONS one step's loss and gradient, and a 120-step chunk
    from step 100 (graph boundaries at 50 and 100; p, m, v and the losses).
    Only entry points every version of the kernel with the "default"
    precision has."""
    prob = PROBLEMS["heat"]()
    d = prob.defaults
    model = prob.default_model(generator=generator(0), device=device)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 100, 120, d.batch_size, device)
    out = {}
    for pr, tag in OUTPUT_PRECISIONS:
        loss, grad = ft.heat_loss_grad(model, p, u[0], precision=pr)
        out[f"heat{tag} step loss"] = loss.reshape(1)
        out[f"heat{tag} step grad"] = grad
        chunk = ft.heat_fused_train_chunk(model, p, z, z, u, 100, d.lrate,
                                          precision=pr)
        for part, t in zip(("p", "m", "v", "losses"), chunk):
            out[f"heat{tag} chunk {part}"] = t
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def streams_outputs(device):
    """Kernel #3's 7 streams at fixed inputs, as CPU tensors by name: a
    2 → 128×3 → 1 MLP (generator(1)) per activation, at B = 64 and a ragged
    1 000 points of Heat1D's sampler (generator(2))."""
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp
    from differential_equations_dnn_tpu_torch.models import MLP

    out = {}
    for act in ("tanh", "sigmoid", "relu"):
        model = MLP(2, 1, 128, 3, act, generator=generator(1), device=device)
        for B in (64, 1000):
            b = Heat1D().sample(B, generator(2), device)
            with torch.no_grad():
                streams = taylor_mlp.heat_fused_streams(
                    model, b["xt"], b["x0"], b["xb1"], b["xb2"])
            for s, t in enumerate(streams):
                out[f"{act} B={B} stream {s}"] = t
    torch.cuda.synchronize()
    return {k: v.detach().cpu() for k, v in out.items()}


def streams_times(device, calls=5):
    """Device ms per call of kernel #3 (queued behind a spin kernel, so the
    events time the calls back to back and not the host) at heat's shape (B
    = 64, H = 128, L = 3, tanh), at B = 1 000 for each activation, and at H
    = 256 and 512 where the kernel takes them."""
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp
    from differential_equations_dnn_tpu_torch.models import MLP

    cases = [("tanh", 64, 128)] + [(a, 1000, 128) for a in
                                   ("tanh", "sigmoid", "relu")]
    cases += [("tanh", 64, 256), ("tanh", 64, 512)]
    for act, B, H in cases:
        model = MLP(2, 1, H, 3, act, generator=generator(1), device=device)
        b = Heat1D().sample(B, generator(2), device)
        pts = (b["xt"], b["x0"], b["xb1"], b["xb2"])

        def run():
            with torch.no_grad():
                for _ in range(calls):
                    taylor_mlp.heat_fused_streams(model, *pts)

        try:
            ms = _spin_ms(run, calls)
        except ValueError as err:  # a width this tree's kernel refuses
            print(f"heat streams [{act}, B={B}, H={H}, L=3]: {err}")
            continue
        print(f"heat streams [{act}, B={B}, H={H}, L=3]: {ms * 1e3:.2f} us "
              f"device time per call")


# Kernel #2's shapes (N, D, H, L, activation), output width 1: simple_ode's
# grid, the 40 × 40 grid of heat, burgers, wave, advection and poisson (the
# three activations), heat2d's 24³, the smoke's H = 256 solves, the widest
# tested, and a 1024 × 1024 grid (large-batch inference).
MLP_SHAPES = [(25, 1, 32, 1, "tanh"), (1600, 2, 128, 3, "tanh"),
              (1600, 2, 128, 3, "relu"), (1600, 2, 128, 3, "sigmoid"),
              (13824, 3, 128, 3, "tanh"), (1600, 2, 256, 3, "tanh"),
              (13824, 3, 256, 3, "tanh"), (1600, 2, 1024, 3, "tanh"),
              (1 << 20, 2, 128, 3, "tanh")]


def mlp_case(N, D, H, L, act, device, O=1):
    """A D → H×L → O MLP (generator(H + L)) and N points in [0, 1)^D
    (generator(N)): the same inputs on every tree."""
    from differential_equations_dnn_tpu_torch.models import MLP

    model = MLP(D, O, H, L, act, generator=generator(H + L), device=device)
    x = torch.rand((N, D), generator=generator(N)).to(device)
    return model, x


def mlp_times(device, calls=5):
    """Device ms per call of kernel #2 (queued behind a spin kernel) at each
    of MLP_SHAPES."""
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp

    for N, D, H, L, act in MLP_SHAPES:
        model, x = mlp_case(N, D, H, L, act, device)

        def run():
            with torch.no_grad():
                for _ in range(calls):
                    taylor_mlp.mlp_forward(model, x)

        ms = _spin_ms(run, calls)
        print(f"mlp_forward [{N}x{D} -> {H}x{L} -> 1, {act}]: "
              f"{ms * 1e3:.2f} us device time per call")


def mlp_outputs(device):
    """Kernel #2's outputs at fixed inputs, as CPU tensors by name: each of
    MLP_SHAPES, then every activation, depth L in {0, 1, 3}, input width D
    in {1, 2, 3}, output width O in {1, 2} and ragged N in {1, 25, 77} at
    H = 50 (neither a multiple of 4 nor of a k-tile) and 128. Only entry
    points every version of the kernel has."""
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp

    cases = [(N, D, H, L, act, 1) for N, D, H, L, act in MLP_SHAPES]
    cases += [(N, D, H, L, act, O) for act in ("tanh", "sigmoid", "relu")
              for L in (0, 1, 3) for D in (1, 2, 3) for O in (1, 2)
              for N in (1, 25, 77) for H in (50, 128)]
    out = {}
    for N, D, H, L, act, O in cases:
        model, x = mlp_case(N, D, H, L, act, device, O)
        with torch.no_grad():
            y = taylor_mlp.mlp_forward(model, x)
        out[f"{N}x{D} -> {H}x{L} -> {O}, {act}"] = y.cpu()
    torch.cuda.synchronize()
    return out


def population_outputs(device):
    """The population tier's outputs at fixed inputs, as CPU tensors by
    name: heat's default model in a population of 4 at max batch 512
    (batches 181, 17, 512 and 64), run three times in this process (64
    steps, two graph replays; the same again; 16 steps, eagerly), then the
    scores of ``tpe_search(heat, 0, num_samples=10, max_iters=2048)`` (the
    run of chip_smoke.py's population check (e)). It prints whether the
    two graph runs, and the eager run against their first 16 steps, agree
    bit for bit."""
    from differential_equations_dnn_tpu_torch.parallel import (
        PopulationConfig,
        train_population,
    )
    from differential_equations_dnn_tpu_torch.sweep import search

    prob = PROBLEMS["heat"]()
    model = prob.default_model()
    lrs = np.array([3.2e-3, 1e-3, 2e-4, 1e-4], np.float32)
    out = {}
    for tag, iterations in (("graph", 64), ("again", 64), ("eager", 16)):
        params, _, losses = train_population(
            prob, model, 0, lrs, [181, 17, 512, 64],
            PopulationConfig(iterations=iterations, max_batch_size=512),
            device=device)
        out[f"{tag} losses"] = torch.as_tensor(losses)
        out.update({f"{tag} {k}": v.cpu() for k, v in params.items()})
    again = all(torch.equal(v, out["again" + k[5:]])
                for k, v in out.items() if k.startswith("graph "))
    eager = torch.equal(out["eager losses"], out["graph losses"][:16])
    print(f"population outputs: the two graph runs bit for bit: {again}; "
          f"the eager run's 16 losses bit for bit the graph's: {eager}")
    res = search.tpe_search(prob, 0, num_samples=10, max_iters=2048)
    out["tpe_search scores"] = torch.as_tensor(res.scores)
    print("tpe_search scores: " + ", ".join(f"{x:.9g}" for x in res.scores))
    return out


def _steady_ms(run, reps=3):
    """Mean milliseconds per call of ``run`` between CUDA events, after a
    warm-up call."""
    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def steady_times(device, K=1000):
    """µs per step of K-step chunks of the fused routes outside the sweep
    mode (heat kernel #1; heat2d; wave × 8; FitzHugh–Nagumo single and ×
    16), each equation's default model and batch; only entry points every
    version of the kernels has, so an earlier tree's package can run it."""
    out = {}
    prob = PROBLEMS["heat"]()
    model = prob.default_model(generator=generator(0), device=device)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, K, 64, device)
    out["heat #1"] = _steady_ms(lambda: ft.heat_fused_train_chunk(
        model, p, z, z, u, 0, 1e-4))
    cases = (("heat2d", 1, fe.spec_for, fe.fused_engine_chunk,
              fe.fused_engine_packed_chunk),
             ("wave", 8, fe.spec_for, fe.fused_engine_chunk,
              fe.fused_engine_packed_chunk),
             ("fitzhugh_nagumo", 1, None, fd.fused_dgm_chunk,
              fd.fused_dgm_packed_chunk),
             ("fitzhugh_nagumo", 16, None, fd.fused_dgm_chunk,
              fd.fused_dgm_packed_chunk))
    for name, N, spec_of, single, packed in cases:
        prob = PROBLEMS[name]()
        B = prob.defaults.batch_size
        spec = spec_of(prob) if spec_of else fd.spec_for(prob, B)
        pack = ((lambda m: fe.pack_state(spec, m)) if spec_of
                else fd.pack_dgm)
        gens = ([generator(0)] if N == 1 else
                [replica_generator(0, r) for r in range(N)])
        models = [prob.default_model(generator=g, device=device)
                  for g in gens]
        p = engine_core.stack_replicas([pack(m) for m in models])
        z = torch.zeros_like(p)
        u = step_uniforms(0, 0, K, B, device, spec.n_uniform)
        kw = dict(schedule="cosine", total_steps=2 * K) if spec_of else {}
        lr = prob.defaults.lrate

        def run():
            if N == 1:
                return single(spec, models[0], p[0], z[0], z[0], u, 0, lr,
                              **kw)
            return packed(spec, models[0], p, z, z, u, 0, lr, N, **kw)

        out[f"{name} x{N}"] = _steady_ms(run)
    print("µs per step of 1 000-step chunks: " + "; ".join(
        f"{k} {v / K * 1e3:.2f}" for k, v in out.items()))


def rung_times(device, n_slots=27, K=500, live=(27, 9, 3, 1)):
    """A halving rung's cost against its live slots: ms of a packed call of
    ``n_slots`` heat slots at a tile of 64 rows, K steps, with the first k
    slots live (the rest pruned: budget 0) for each k of ``live``, beside
    the call outside the sweep mode."""
    prob = PROBLEMS["heat"]()
    spec = fe.spec_for(prob)
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=device) for r in range(n_slots)]
    p = engine_core.stack_replicas([fe.pack_state(spec, m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, K, 64, device, spec.n_uniform)

    def call(k=None):
        kw = {} if k is None else dict(
            lr_vec=np.full(n_slots, 1e-3, np.float32),
            bs_vec=np.full(n_slots, 64),
            steps_vec=np.asarray([K] * k + [0] * (n_slots - k)),
            mask_rows=True)
        return fe.fused_engine_packed_chunk(spec, models[0], p, z, z, u, 0,
                                            1e-3, n_slots, **kw)

    out = {"outside the sweep mode": _steady_ms(call)}
    for k in live:
        out[f"{k} live"] = _steady_ms(lambda: call(k))
    print(f"{n_slots}-slot heat rung at tile 64, {K} steps, ms: "
          + "; ".join(f"{k} {v:.3f}" for k, v in out.items()))


def compare_outputs(new, old):
    """Tensor by tensor: bit for bit, or the largest difference; then the
    count of equal tensors."""
    equal = 0
    for key, t in new.items():
        ref = old[key]
        same = torch.equal(t, ref)
        equal += same
        diff = float((t - ref).abs().max()) if t.numel() else 0.0
        print(f"  {key} {tuple(t.shape)}: "
              + ("bit for bit" if same else f"max|diff| {diff:.3g}"))
    print(f"  {equal}/{len(new)} tensors bit for bit")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        default=sorted(fe.SPECS) + list(DGM))
    parser.add_argument("--solve-seeds", type=int, default=0, metavar="N",
                        help="also solve each NAME at seeds 0 .. N-1")
    parser.add_argument("--replicas", type=int, nargs="+", metavar="N",
                        help="time the packed kernel at N replicas instead")
    parser.add_argument("--scan", nargs="+", metavar="NAME",
                        help="time the scan trainer's step of each NAME")
    parser.add_argument("--taps", nargs="+", default=[None],
                        help="heat's taps for --scan (several: one study "
                             "each with --solve-seeds)")
    parser.add_argument("--adam", nargs="+", default=["fused"],
                        choices=["fused", "foreach"],
                        help="the Adam updates of a --scan --solve-seeds "
                             "study")
    parser.add_argument("--workers", type=int, default=1,
                        help="scan solves run at a time")
    parser.add_argument("--out", help="JSON summary of a scan study")
    parser.add_argument("--probe", action="store_true",
                        help="time the graph gap, the grid barrier and the "
                        "DGM gemm against the library instead")
    parser.add_argument("--dgm-outputs", metavar="PATH",
                        help="save the DGM kernels' outputs at fixed inputs")
    parser.add_argument("--engine-outputs", metavar="PATH",
                        help="save the MLP engine's outputs at fixed inputs")
    parser.add_argument("--heat-outputs", metavar="PATH",
                        help="save kernel #1's outputs at fixed inputs")
    parser.add_argument("--streams-outputs", metavar="PATH",
                        help="save kernel #3's outputs at fixed inputs")
    parser.add_argument("--mlp-outputs", metavar="PATH",
                        help="save kernel #2's outputs at fixed inputs")
    parser.add_argument("--population-outputs", metavar="PATH",
                        help="save the population tier's outputs at fixed "
                        "inputs")
    parser.add_argument("--deterministic", action="store_true",
                        help="run under torch.use_deterministic_algorithms"
                        "(True), which raises at an op that has no "
                        "deterministic version on the card")
    parser.add_argument("--compare-to", metavar="OLD",
                        help="with one of the --*-outputs options: "
                        "compare with OLD, saved by an earlier tree")
    parser.add_argument("--steady", action="store_true",
                        help="µs per step of 1 000-step chunks of the fused "
                             "routes outside the sweep mode")
    parser.add_argument("--rung", action="store_true",
                        help="a 27-slot heat rung's ms against its live "
                             "slots")
    parser.add_argument("--probe-engine", action="store_true",
                        help="time each MLP-engine kernel and tile variant "
                        "at heat2d's layout instead")
    parser.add_argument("--streams", action="store_true",
                        help="time kernel #3's device time per call "
                        "instead")
    parser.add_argument("--mlp", action="store_true",
                        help="time kernel #2's device time per call at "
                        "each of its shapes instead")
    parser.add_argument("--engine", action="store_true",
                        help="time constant-lr heat on the generic engine "
                        "instead of kernel #1")
    parser.add_argument("--solve-args", type=json.loads, default={},
                        metavar="JSON", help="more arguments of the "
                        "--solve-seeds solves, as a JSON object (such as "
                        '\'{"iterations": 50000}\' or \'{"engine": '
                        '"scan"}\')')
    args = parser.parse_args()
    if args.deterministic:
        # cuBLAS reproducible across streams, as torch asks for this mode.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    device = build.resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    for path, make, what in ((args.dgm_outputs, dgm_outputs, "DGM"),
                             (args.engine_outputs, engine_outputs,
                              "MLP engine"),
                             (args.heat_outputs, heat_outputs,
                              "heat kernel (#1)"),
                             (args.streams_outputs, streams_outputs,
                              "heat streams (#3)"),
                             (args.mlp_outputs, mlp_outputs,
                              "MLP forward (#2)"),
                             (args.population_outputs, population_outputs,
                              "population")):
        if path:
            outs = make(device)
            torch.save(outs, path)
            if args.compare_to:
                print(f"{what} outputs against {args.compare_to}:")
                compare_outputs(outs, torch.load(args.compare_to))
            return
    if args.probe:
        probe(device)
        return
    if args.steady or args.rung:
        if args.steady:
            steady_times(device)
        if args.rung:
            rung_times(device)
        return
    if args.streams:
        streams_times(device)
        return
    if args.mlp:
        mlp_times(device)
        return
    if args.probe_engine:
        for B, H in ((256, 128), (2048, 128), (256, 512)):
            probe_engine(device, B, H)  # heat2d, its ×8 batch, H = 512
        return
    for name in args.scan or []:
        if args.solve_seeds:
            scan_seeds(name, args.taps, args.adam, args.solve_seeds,
                       args.workers, args.out)
            continue
        for taps in args.taps:
            profile(name, device, scan_taps=taps)
    if args.scan:
        return
    for name in args.names:
        for n_replicas in args.replicas or [None]:
            profile(name, device, n_replicas, engine=args.engine)
        if args.solve_seeds:
            solve_seeds(name, args.solve_seeds, **args.solve_args)


if __name__ == "__main__":
    main()
