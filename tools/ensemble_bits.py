"""The FitzHugh–Nagumo ``causal_eps=0`` ensemble's parts, saved apart, to
find which part of a solve depends on what ran before it in the process.

    python3 tools/ensemble_bits.py --out build/fresh.pt
    python3 tools/ensemble_bits.py --after-solve-phase --out build/after.pt \\
        --compare-to build/fresh.pt

On the GPU. It runs what ``solve("fitzhugh_nagumo", engine="fused",
causal_eps=0)`` runs, part by part: the packed training of its 16
replicas (kernel #5 around #7), the validation residuals and pick, and the
L-BFGS polish of the best three with the post-polish pick (torch ops),
twice on the same trained replicas, so that a polish that differs from
itself in one process shows (``--deterministic``: under torch's
deterministic algorithms). ``--after-solve-phase`` first runs
``chip_smoke.py``'s solve phase in this process (with its kernel build).
The last lines say, for each part, whether it equals the other file's bit
for bit.
"""

import argparse
import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def ensemble_parts(steps=None):
    """Each part's outputs as tensors on the CPU (``steps`` cuts the
    training; None: the solve's 150 000)."""
    import numpy as np
    import torch

    from differential_equations_dnn_tpu_torch import api
    from differential_equations_dnn_tpu_torch.core.prng import generator
    from differential_equations_dnn_tpu_torch.equations import FitzHughNagumo
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd

    prob = FitzHughNagumo(causal_eps=0.0)
    d = prob.defaults
    n, polish = api._auto_defaults(prob, None)
    iterations = steps or d.iterations
    t0 = time.perf_counter()
    res = fd.train_dgm_fused_ensemble_packed(
        prob, 0, iterations, n, batch_size=d.batch_size, lrate=d.lrate,
        schedule=d.schedule, chunk_size=25_000)
    train_s = time.perf_counter() - t0

    def flat(model):
        return torch.cat([p.detach().reshape(-1).cpu()
                          for p in model.parameters()])

    out = {"training losses": torch.as_tensor(res.loss_history),
           "trained replicas": torch.stack([flat(m) for m in res.params])}
    device = next(res.params[0].parameters()).device
    val = prob.validation_sample(4096, generator(1), device)
    val_losses = np.array([api._residual(prob, m, val) for m in res.params])
    out["validation residuals"] = torch.as_tensor(val_losses)
    for k in (1, 2):
        models = [copy.deepcopy(m) for m in res.params]
        pick, polished, ft = api._polish_and_select(prob, models,
                                                    val_losses, 0, polish)
        out[f"polish {k}: pick"] = torch.tensor(pick)
        out[f"polish {k}: losses"] = torch.as_tensor(ft)
        out[f"polish {k}: model"] = flat(polished)
        out[f"polish {k}: MAE"] = torch.tensor(prob.mae(polished,
                                                        d.nodes))
    print(f"ensemble of {n} x {iterations} steps: training {train_s:.1f} s; "
          f"pick {int(out['polish 1: pick'])}, MAE "
          f"{float(out['polish 1: MAE']):.8g} (second polish "
          f"{float(out['polish 2: MAE']):.8g})", flush=True)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--compare-to")
    parser.add_argument("--after-solve-phase", action="store_true",
                        help="run chip_smoke.py's solve phase first")
    parser.add_argument("--steps", type=int,
                        help="training steps (default: the solve's)")
    parser.add_argument("--deterministic", action="store_true",
                        help="run under torch.use_deterministic_algorithms "
                        "(set CUBLAS_WORKSPACE_CONFIG=:4096:8 too)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if args.deterministic:
        torch.use_deterministic_algorithms(True)

    if args.after_solve_phase:
        import chip_smoke

        t0 = time.perf_counter()
        chip_smoke.phase_solve()
        print(f"solve phase: {time.perf_counter() - t0:.1f} s", flush=True)
    out = ensemble_parts(args.steps)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(out, args.out)
    if args.compare_to:
        other = torch.load(args.compare_to)
        for key, value in out.items():
            same = torch.equal(value, other[key])
            gap = (value.double() - other[key].double()).abs().max()
            diff = "" if same else f" (max {float(gap):.3g})"
            print(f"{key}: {'equal' if same else 'DIFFERS'}{diff}")


if __name__ == "__main__":
    main()
