"""Run one cell of the port's benchmark on the card and print its result.

    python cudabench/run.py --workload heat1d.fused.solve --seed 12345 \
        --seconds 51 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``. The numbers that decided ``correct`` are the
last lines of standard error and the last key of the result. Without a
CUDA card, or with fewer cards than the cell asks for, it exits 2 and
prints no result; also if the process has loaded JAX or the JAX package
once the window has closed.
"""

import argparse
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Every cache the program or a library it loads may write, at a fixed
# path inside the checkout: only a checkout's first run builds.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "CUDA_CACHE_PATH": "nv_compute_cache"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x):
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def fail(msg, code=2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def main(argv=None, device="cuda", overrides=None, require_card=True):
    """Run one cell. ``device``, ``overrides`` and ``require_card`` serve
    the tests, which drive a run on the CPU at a small size; a run from
    the command line takes the defaults. Returns the result's dict."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / "build" / "cudabench" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(REPO)]
    import harness

    cell = harness.load_cell(args.workload, overrides)
    import torch

    if require_card:
        if not torch.cuda.is_available():
            fail("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            fail(f"{cell.name} needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} present")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    driver = harness.load_module(
        "traffic", cell.mix["driver"]).Driver(cell.mix, cell.cfg, device)
    driver.warm_up(harness.call_seed(args.seed, -1))
    sync()
    setup_s = harness.process_age_s()
    recorder = None
    if args.trace:
        import slices

        spec = cell.workload["trace"]
        recorder = slices.SliceRecorder(spec)
    t0, t1, calls = harness.run_window(
        driver, args.seconds, args.seed, sync,
        harness.net_rows(cell.mix, cell.cfg),
        recorder.before_call if recorder else None)
    sliced = recorder.finish() if recorder else None
    found = harness.forbidden_modules()
    if found:
        fail(f"loaded in the run's process: {', '.join(found)}")

    f, b = harness.step_cost(cell)
    ctx = harness.Context(cell, calls, t0, t1, setup_s, sliced, f, b,
                          recorder.from_call if recorder else None)
    metrics = harness.read_metrics(
        ctx, cell.per_layer if args.trace else cell.end_to_end)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    result = {"correct": False, "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if sliced is not None:
        dev["busy_s"] = sliced.busy_s()
        dev["window_s"] = sliced.window_s
        result["breakdown"] = {"device_ops": sliced.top_ops(),
                               "idle_gaps": sliced.idle_gaps()}
    # The program's state goes before the reference runs on the card.
    driver.close()
    driver = None
    if cuda:
        torch.cuda.empty_cache()
    attempted, failed, readings = harness.check_calls(
        cell, calls, torch.device(device), args.seed)
    result.update(correct=attempted > 0 and failed == 0,
                  attempted=attempted, failed=failed, checks=readings)
    found = harness.forbidden_modules()
    if found:
        fail(f"loaded in the run's process: {', '.join(found)}")
    for name, r in readings.items():
        print(f"check {name}: {r['value']:.6g} (limit {r['limit']:.6g})",
              file=sys.stderr)
    print(json.dumps(_finite(result)))
    return result


if __name__ == "__main__":
    main()
