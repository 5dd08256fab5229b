"""The control of each cell's comparison, faults planted in the reference
put in the program's place, and the program's own readings: what the
limits of ``correct`` are set from.

The configurations state strict fp32 with TF32 off, so the control is the
reference computed one precision lower, in TF32 (its matrix products on
the tensor cores with 10-bit mantissas), put in the program's place: its
first three losses, and for a solve its grid, are held against the fp32
reference by the cell's own numbers. The faults are the reference with a
step that leaves its state unchanged (learning rate 0), with half of each
batch left out (the mean over the rest) and, in a training cell, with its
state frozen after the program's first graph replay (``end_loss``,
``net_loss``).

    python cudabench/control.py --workload fhn.fused.ensemble16 \
        --seeds 11 12 13 [--program 21 22 ...]

prints one JSON line per seed with each variant's numbers and the cell's
limits, and with ``--program`` one line per seed of the program's own
numbers: its first call of a run with that seed, checked as a run checks
it, all in one process. The benchmark's own runs never run this. The
control has no meaning on the CPU (TF32 is a tensor-core mode), so it
needs the card.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import harness  # noqa: E402
from checks import first_steps  # noqa: E402
from checks import heat_solve  # noqa: E402
from checks import train_losses  # noqa: E402
from reference import draws, nets  # noqa: E402


@contextlib.contextmanager
def tf32():
    """TF32 on for matrix products and convolutions, then as before."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def readings(cell, seed, device):
    """{variant: {number: value}} of one seed: "fp32" (the reference
    against itself, 0), "tf32" (the control), "unchanged" and
    "half_batch" (planted faults) and, in a training cell, "frozen"."""
    mix, cfg = cell.mix, cell.cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = harness.net_rows(mix, cfg)
    want = first_steps.reference_losses(mix, cfg, seed, rows, device)
    with tf32():
        low = first_steps.reference_losses(mix, cfg, seed, rows, device)
    variants = {
        "fp32": want,
        "tf32": low,
        "unchanged": first_steps.reference_losses(mix, cfg, seed, rows,
                                                  device, lrate=0.0),
        "half_batch": first_steps.reference_losses(
            mix, cfg, seed, rows, device,
            rows_used=[max(1, r // 2) for r in rows]),
    }
    out = {k: {"loss_gap": first_steps.gap(v, want)}
           for k, v in variants.items()}
    if mix["driver"] == "solve_loop":
        p0 = draws.initial(mix, cfg, seed, 0, device)
        grid, _ = heat_solve.grid(cfg["nodes"], device)
        for name, ctx in (("fp32", contextlib.nullcontext()),
                          ("tf32", tf32())):
            with ctx, torch.no_grad():
                sol = nets.forward(cfg, p0, grid).double().cpu().numpy()
            exact = heat_solve.grid(cfg["nodes"], "cpu")[1]
            mae = float(np.mean(np.abs(exact - sol.reshape(exact.shape))))
            nums = heat_solve.grid_numbers(cfg, p0, sol, mae, device)
            out[name]["grid_gap"] = nums["grid_gap"]
    else:
        steps = harness.load_module("traffic", mix["driver"]).call_steps(
            mix, cfg)
        out["frozen"] = train_losses.frozen_numbers(cell, seed, steps,
                                                    device)
    return out


def program_readings(cell, seeds, device):
    """(seed, the program's numbers) of each seed's first call, checked
    as a run checks it, from one driver warmed up once."""
    driver = harness.load_module("traffic", cell.mix["driver"]).Driver(
        cell.mix, cell.cfg, device)
    driver.warm_up(harness.call_seed(seeds[0], -1))
    check = harness.load_module("checks", cell.workload["check"])
    rows = harness.net_rows(cell.mix, cell.cfg)
    for seed in seeds:
        s = harness.call_seed(seed, 0)
        answer, steps, _ = driver.call(s)
        call = harness.Call(s, 0.0, 0.0, answer, steps, rows, None)
        yield seed, check.numbers(cell, call, device, True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="control readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--program", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda")
    limits = cell.workload["limits"]
    for seed in args.seeds:
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "limits": limits,
                          "readings": readings(cell, seed, device)}),
              flush=True)
    if args.program:
        for seed, nums in program_readings(cell, args.program, device):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "limits": limits, "program": nums}),
                  flush=True)


if __name__ == "__main__":
    main()
