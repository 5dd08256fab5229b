"""MAE of the JAX package's ``solve`` over seeds, on the CPU: the reference
numbers that the port's solves are held beside.

    JAX_PLATFORMS=cpu python tools/jax_solve_seeds.py advection --seeds 42 \\
        --args '{"c": 50.0, "causal_eps": 5.0, "iterations": 30000}'
    JAX_PLATFORMS=cpu python tools/jax_solve_seeds.py volterra \\
        --seeds 0 1 2 3 4 --args '{"quadrature": "montecarlo"}'

Each line gives the equation, the arguments, the seed, the MAE, the final
loss and the seconds the solve took. Run it from the repository root.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("equation")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--args", type=json.loads, default={},
                        metavar="JSON", help="solve's other arguments")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from differential_equations_dnn_tpu import solve

    for seed in args.seeds:
        t0 = time.perf_counter()
        res = solve(args.equation, seed=seed, **args.args)
        print(f"JAX solve({args.equation!r}, seed={seed}, **{args.args}): "
              f"MAE {res.mae:.6g}, final loss {res.loss_history[-1]:.4g}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
