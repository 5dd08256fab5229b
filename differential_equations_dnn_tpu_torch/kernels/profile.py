"""Where one Adam step's device time goes, per CUDA kernel, on the card.

    python -m differential_equations_dnn_tpu_torch.kernels.profile [NAME ...]

For each equation NAME (default: all nine), at its reference defaults and
seed 0, it runs one warm-up chunk of the fused trainer of its route
(constant-lr heat: the heat kernel; fitzhugh_nagumo and fredholm: the DGM
engine; the rest: the generic engine), then
times one chunk of K steps with CUDA events and profiles another with
``torch.profiler``. It prints the µs per step of each kernel name (device
time summed over the chunk, over K), the launches per step, the summed
kernel time against the event-timed step, and the card's name and power
limit. With ``--replicas N [N ...]`` it times the packed-replica kernel
(#5) instead, one run per N: N replicas drawn from ``replica_generator(0,
r)`` in every launch, with µs per packed step and per replica-step. With
``--solve-seeds N`` it also runs ``solve(NAME, engine="fused")`` at the
reference defaults for seeds 0 .. N−1 and prints each MAE and warm it/s.
Needs a CUDA device.

    python -m differential_equations_dnn_tpu_torch.kernels.profile \
        fitzhugh_nagumo wave --replicas 1 4 8 16
"""

import argparse
import re
import subprocess
from collections import defaultdict

import torch

from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    replica_generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.equations import PROBLEMS
from differential_equations_dnn_tpu_torch.kernels import engine_core
from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

STEPS = 200
DGM = ("fitzhugh_nagumo", "fredholm")


def _chunk_fn(name, device):
    """A closure running STEPS steps of NAME's fused route from step 0."""
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
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    if name == "heat" and d.schedule == "constant":
        u = step_uniforms(0, 0, STEPS, d.batch_size, device)
        return lambda: ft.heat_fused_train_chunk(model, p, z, z, u, 0,
                                                 d.lrate)
    spec = fe.spec_for(prob)
    u = step_uniforms(0, 0, STEPS, d.batch_size, device, spec.n_uniform)
    return lambda: fe.fused_engine_chunk(spec, model, p, z, z, u, 0, d.lrate,
                                         schedule=d.schedule,
                                         total_steps=d.iterations)


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
        pack, chunk = ft.pack_params, fe.fused_engine_packed_chunk
    p = engine_core.stack_replicas([pack(m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, STEPS, d.batch_size, device, spec.n_uniform)
    return lambda: chunk(spec, models[0], p, z, z, u, 0, d.lrate, n_replicas,
                         **kw)


def _kernel_times(prof):
    """{kernel name: (device µs, calls)} of the profiled CUDA kernels."""
    out = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"\w+_kernel", ev.key)
            short = found.group(0) if found else ev.key[:40]
            out[short][0] += us
            out[short][1] += ev.count
    return out


def profile(name, device, n_replicas=None):
    run = (_chunk_fn(name, device) if n_replicas is None
           else _packed_fn(name, device, n_replicas))
    run()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    step_us = start.elapsed_time(end) * 1e3 / STEPS
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize(device)
    times = _kernel_times(prof)
    total = sum(us for us, _ in times.values()) / STEPS
    label = name if n_replicas is None else (
        f"{name} packed, N={n_replicas} ({step_us / n_replicas:.2f} us per "
        f"replica-step)")
    print(f"{label}: {step_us:.2f} us/step (CUDA events, K={STEPS}); "
          f"kernels {total:.2f} us/step under the profiler "
          f"(share of the event-timed step {total / step_us:.3f})")
    for kernel, (us, calls) in sorted(times.items(), key=lambda kv: -kv[1][0]):
        print(f"  {kernel:24s} {us / STEPS:8.2f} us/step  "
              f"{calls / STEPS:5.2f} launches/step  "
              f"{us / calls:7.2f} us/launch")


def solve_seeds(name, n_seeds):
    """MAE and warm it/s of ``solve(name, engine="fused")`` per seed."""
    from differential_equations_dnn_tpu_torch import solve

    maes = []
    for seed in range(n_seeds):
        res = solve(name, engine="fused", seed=seed)
        maes.append(res.mae)
        print(f"  solve({name!r}, seed={seed}): MAE {res.mae:.6g}, "
              f"{res.iters_per_sec:.1f} it/s warm, final loss "
              f"{res.loss_history[-1]:.4g}")
    print(f"  {name} MAE over seeds 0-{n_seeds - 1}: min {min(maes):.6g}, "
          f"max {max(maes):.6g}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("names", nargs="*",
                        default=sorted(fe.SPECS) + list(DGM))
    parser.add_argument("--solve-seeds", type=int, default=0, metavar="N",
                        help="also solve each NAME at seeds 0 .. N-1")
    parser.add_argument("--replicas", type=int, nargs="+", metavar="N",
                        help="time the packed kernel at N replicas instead")
    args = parser.parse_args()
    device = ft.resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip())
    for name in args.names:
        for n_replicas in args.replicas or [None]:
            profile(name, device, n_replicas)
        if args.solve_seeds:
            solve_seeds(name, args.solve_seeds)


if __name__ == "__main__":
    main()
