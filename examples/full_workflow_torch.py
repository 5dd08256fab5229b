"""Complete worked example of the PyTorch/CUDA port: train → validate →
checkpoint → restore → export → load → sweep, on the heat equation.

Run:  python examples/full_workflow_torch.py  [--platform cpu]

The counterpart of examples/full_workflow.py. It runs on the GPU unless
``--platform cpu`` asks for the CPU (the kernels' plain PyTorch versions,
a few minutes); on the GPU the fused solve is kernel #1, the grid kernel
#2 and the sweep the fused sweep tier (#4/#5).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from differential_equations_dnn_tpu_torch import (  # noqa: E402
    export_solution,
    load_solution,
    solve,
)
from differential_equations_dnn_tpu_torch.equations import Heat1D  # noqa: E402
from differential_equations_dnn_tpu_torch.sweep import (  # noqa: E402
    SearchSpace,
    loguniform,
    randint,
    tpe_search_fused,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    checkpoint_like,
    restore_checkpoint,
    save_checkpoint,
    train,
)


def main(device="cuda"):
    out = Path("temp_results/example_torch")
    out.mkdir(parents=True, exist_ok=True)

    # 1. One-call solve at a reduced budget on the fused heat kernel.
    res = solve("heat", engine="fused", iterations=3000, batch_size=64,
                lrate=1e-4, nodes=40, device=device)
    print(f"[solve]      MAE vs sin(x)e^-t: {res.mae:.5f} "
          f"({res.iters_per_sec:.0f} iters/s on {res.device})")

    # 2. The scan trainer with an explicit config; checkpoint and restore
    # its whole state, then resume for 500 more steps.
    prob = Heat1D(taps="taylor")
    cfg = TrainConfig(iterations=1000, batch_size=64, lrate=1e-3,
                      verbose=False, adaptive_oversample=4)
    tr = train(prob, 0, cfg, device=device)
    save_checkpoint(out / "ckpt", {"params": tr.params.state_dict(),
                                   "opt_state": tr.opt_state,
                                   "step": 1000, "seed": 0})
    ck = restore_checkpoint(out / "ckpt", device=device,
                            like=checkpoint_like(prob, cfg, seed=0))
    model = prob.default_model()
    model.load_state_dict(ck["params"])
    more = train(prob, ck["seed"], cfg, model=model,
                 opt_state=ck["opt_state"], start_step=ck["step"],
                 device=device)
    print(f"[checkpoint] restored step {ck['step']}, resumed to loss "
          f"{more.final_loss:.3e} (MAE {prob.mae(model, 40):.5f})")

    # 3. Export the trained solution for serving; reload and query it.
    blob_path = out / "heat.pt2"
    export_solution(res.params, input_dim=2, path=blob_path)
    fn = load_solution(blob_path, device=device)
    q = torch.tensor([[np.pi / 2, 0.0]])  # u(π/2, 0) ≈ 1
    print(f"[serving]    artifact {blob_path.stat().st_size} bytes, "
          f"u(π/2, 0) = {float(fn(q)[0, 0]):.4f}")

    # 4. A small TPE sweep on the fused tier: every trial inside the
    # kernels, four proposals per launch.
    space = SearchSpace({"lrate": loguniform(1e-4, 1e-2),
                         "batch_size": randint(16, 128)})
    sw = tpe_search_fused(Heat1D(), seed=1, num_samples=8, space=space,
                          max_iters=500, max_batch_size=128, q=4,
                          device=device)
    print(f"[sweep]      best config {sw.best_config} "
          f"(loss {sw.best_score:.2e})")


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(argv[argv.index("--platform") + 1] if "--platform" in argv
         else "cuda")
