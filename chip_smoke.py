#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

Run from the repository root, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions; fails without a CUDA device.
2. build    — nvcc compiles the package's csrc/*.cu (timed).
3. kernels  — each kernel against its plain PyTorch version on the card, on
              the same inputs at the main path's shapes, with the tolerance
              stated beside each check; both timed with CUDA events.
4. solve    — ``solve("heat", engine="fused")`` at the reference defaults
              (15 000 Adam steps, batch 64, lr 1e-4, seed 0): finite loss
              history, MAE <= 0.05 against sin(x)·e^(−t) on the 40×40 grid,
              and both kernels launched by that run.
5. result   — a JSON line of the kernels, then as the last line
              {"ok": true, "device": {...}}.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "differential_equations_dnn_tpu_torch"
MAE_BOUND = 0.05   # BASELINE.md: reference heat MAE 0.0529 at this budget
CHUNK_STEPS = 50   # steps of the chunk comparison
REPS = 20          # timed calls per measurement, after one warm-up call


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds per call of ``fn`` on the card, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def check_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{max_abs(got, want):.3g} (rtol {rtol}, "
                             f"atol {atol:.3g})")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"CUDA {torch.version.cuda}")


def phase_build():
    from differential_equations_dnn_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{build.library_path().name}")
    log = build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from differential_equations_dnn_tpu_torch.core.prng import (
        generator,
        step_uniforms,
    )
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    dev = torch.device("cuda")
    prob = Heat1D()
    model = prob.default_model(generator=generator(1), device=dev)
    rows = []

    # mlp_forward on the 40×40 evaluation grid, H=128, L=3. Tolerance: fp32
    # reassociation of 128-term dot products through 4 layers, outputs O(1).
    x = prob.grid_inputs(prob.defaults.nodes, device=dev)
    with torch.no_grad():
        got = tm.mlp_forward(model, x)
        want = tm.mlp_forward_plain(model, x)
        check_close("mlp_forward", got, want, rtol=1e-5, atol=1e-5)
        ms = cuda_ms(lambda: tm.mlp_forward(model, x))
        plain_ms = cuda_ms(lambda: tm.mlp_forward_plain(model, x))
    rows.append(dict(
        name="mlp_forward", route="cuda",
        source=f"{PKG}/csrc/mlp_forward.cu",
        replaces="differential_equations_dnn_tpu/kernels/taylor_mlp.py:195",
        max_abs_err=max_abs(got, want), ms=ms, plain_ms=plain_ms))
    print(f"mlp_forward [{x.shape[0]}x2 -> 128x3 -> 1]: max|diff| "
          f"{rows[-1]['max_abs_err']:.3g}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")

    # One step's loss and gradient (the training kernel without Adam) at
    # B=64. Tolerance: fp32 reassociation of the 448-row weight-gradient
    # sums; each gradient tensor is held to 1e-5 of its own largest entry.
    p = ft.pack_params(model)
    u = step_uniforms(0, 0, 1, 64, dev)[0]
    loss_k, grad_k = ft.heat_loss_grad(model, p, u)
    loss_p, grad_p = ft.heat_loss_grad_plain(model, p, u)
    check_close("step loss", loss_k, loss_p, rtol=1e-5, atol=0.0)
    for name, gk, gp in zip(("w_in", "b_in", "w_hid", "b_hid", "w_out",
                             "b_out"), ft.unpack_params(model, grad_k),
                            ft.unpack_params(model, grad_p)):
        check_close(f"grad {name}", gk, gp, rtol=1e-4,
                    atol=1e-5 * float(gp.abs().max()))
    ms = cuda_ms(lambda: ft.heat_loss_grad(model, p, u))
    plain_ms = cuda_ms(lambda: ft.heat_loss_grad_plain(model, p, u))
    print(f"heat step loss+grad [B=64, H=128, L=3]: loss {float(loss_k):.6g} "
          f"vs {float(loss_p):.6g}, max|dgrad| {max_abs(grad_k, grad_p):.3g}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # K Adam steps. Tolerances: the loss history to fp32 reassociation
    # (rtol 1e-4 after K steps); parameters to rtol 1e-4 plus 2·lr, since an
    # Adam step on a gradient within rounding of zero can move a parameter
    # by up to 2·lr in either implementation.
    lr = 1e-4
    zeros = torch.zeros_like(p)
    uk = step_uniforms(0, 0, CHUNK_STEPS, 64, dev)
    pk, mk, vk, lk = ft.heat_fused_train_chunk(model, p, zeros, zeros, uk, 0,
                                               lr)
    pp, mp, vp, lp = ft.heat_fused_train_chunk_plain(model, p, zeros, zeros,
                                                     uk, 0, lr)
    check_close("chunk losses", lk, lp, rtol=1e-4, atol=0.0)
    check_close("chunk params", pk, pp, rtol=1e-4, atol=2 * lr)
    ms = cuda_ms(lambda: ft.heat_fused_train_chunk(model, p, zeros, zeros,
                                                   uk, 0, lr))
    plain_ms = cuda_ms(lambda: ft.heat_fused_train_chunk_plain(
        model, p, zeros, zeros, uk, 0, lr), reps=3)
    n_far = int(((pk - pp).abs() > 1e-5).sum())
    rows.append(dict(
        name="heat_fused_train_chunk", route="cuda",
        source=f"{PKG}/csrc/heat_train.cu",
        replaces="differential_equations_dnn_tpu/kernels/fused_train.py:237",
        max_abs_err=max(max_abs(lk, lp), max_abs(pk, pp)), ms=ms,
        plain_ms=plain_ms))
    print(f"heat_fused_train_chunk [K={CHUNK_STEPS}, B=64]: max|dloss| "
          f"{max_abs(lk, lp):.3g}, max|dparam| {max_abs(pk, pp):.3g} "
          f"({n_far} of {p.numel()} params differ by > 1e-5); kernel "
          f"{ms:.4f} ms ({ms / CHUNK_STEPS * 1e3:.1f} us/step), plain "
          f"{plain_ms:.4f} ms ({plain_ms / CHUNK_STEPS * 1e3:.1f} us/step)")
    return rows


def phase_solve():
    """The main path, through the entry point a user calls."""
    import numpy as np

    from differential_equations_dnn_tpu_torch import solve
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    counters = {"mlp_forward": tm.mlp_forward,
                "heat_fused_train_chunk": ft.heat_fused_train_chunk}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = solve("heat", engine="fused")
    total = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    iters = res.problem.defaults.iterations
    print(f"solve('heat', engine='fused'): {iters} steps, MAE {res.mae:.6g} "
          f"(bound {MAE_BOUND}), final loss {res.loss_history[-1]:.4g}, "
          f"{res.iters_per_sec:.1f} it/s warm (wall {res.wall_time:.3f} s), "
          f"build + warm-up {res.compile_time:.3f} s, total {total:.2f} s, "
          f"on {res.device}; launches {launches}")
    if res.loss_history.shape != (iters,):
        raise AssertionError(f"loss history {res.loss_history.shape}")
    if not np.all(np.isfinite(res.loss_history)):
        raise AssertionError("loss history is not finite")
    nodes = res.problem.defaults.nodes
    if res.solution.shape != (nodes, nodes) or \
            not np.all(np.isfinite(res.solution)):
        raise AssertionError("solution is not a finite 40x40 grid")
    if not res.mae <= MAE_BOUND:
        raise AssertionError(f"MAE {res.mae} above {MAE_BOUND}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    return launches


def main():
    sys.path.insert(0, str(ROOT))
    phase_device()
    import torch

    phase_build()
    rows = phase_kernels()
    launches = phase_solve()
    for row in rows:
        row["launches"] = launches[row["name"]]
        if not all(math.isfinite(row[k]) for k in ("max_abs_err", "ms",
                                                   "plain_ms")):
            raise AssertionError(f"non-finite measurement in {row}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
