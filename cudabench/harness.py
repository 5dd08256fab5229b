"""The benchmark's harness: finds a cell's files by the names in
``BENCHMARK.json``, sets the program up, runs the measured window as one
client in a closed loop, reads the metrics, and decides ``correct`` by
the plain reference once the window has closed.

Everything that belongs to one configuration, traffic mix, check or metric
is a file of its own under this directory:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: a mix's parameters, read by the driver it
  names, ``traffic/<driver>.py``;
* ``workloads/<cell>.json``: the cell's check, limits and trace slice;
* ``checks/<check>.py``: ``numbers(cell, call, device, deep)``;
* ``metrics/<metric>.py``: ``read(ctx)``, a number or None.
"""

import importlib
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "differential_equations_dnn_tpu")
# The program under test.
PORT = "differential_equations_dnn_tpu_torch"
# Call seeds per run seed: more calls than any window holds.
CALLS_PER_SEED = 4096


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(kind, name):
    """``<kind>/<name>.py`` under this directory, imported by its path
    (metric names hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cudabench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    cfg: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_cell(name, overrides=None):
    """The cell ``name`` of ``BENCHMARK.json`` with its files and the
    metrics it reports. ``overrides`` ({"cfg": {...}, "mix": {...}})
    changes settings for the tests, which run cells at small sizes."""
    bench = load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(HERE / "workloads" / f"{name}.json")
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    overrides = overrides or {}
    cfg.update(overrides.get("cfg", {}))
    mix.update(overrides.get("mix", {}))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name, entry["chips"], workload, cfg, mix, e2e, layer)


@dataclass
class Call:
    """One call of the program in the window."""
    seed: int
    start: float
    end: float
    answer: object
    steps: int
    rows: list
    program_s: float | None


@dataclass
class Context:
    """What a metric reader reads."""
    cell: Cell
    calls: list
    window_start: float
    window_end: float
    setup_s: float
    trace: object = None
    step_flops: float = 0.0
    step_bytes: float = 0.0
    traced_from: int | None = None

    @property
    def clean_calls(self):
        """The calls a profiler has not touched: in a traced run those
        before the traced call (a profiler session slows the process's
        later launches), else all."""
        if self.traced_from is None:
            return self.calls
        return self.calls[:self.traced_from]

    @property
    def window_s(self):
        return self.window_end - self.window_start

    def steps_in_trace(self):
        """Training steps in the traced slice: the traced calls' own steps,
        or the graph replays traced times the steps one replay advances
        (the program's constant that the cell's file names)."""
        if self.trace is None:
            return 0
        spec = self.cell.workload["trace"]
        if spec["mode"] == "calls":
            first = spec["from_call"]
            return sum(c.steps for c in self.calls[first:first
                                                    + spec["calls"]])
        return self.trace.replays * replay_steps(self.cell)


def program_constant(ref):
    """The value named ``"module:NAME"`` in the program's package."""
    module, name = ref.split(":")
    return getattr(importlib.import_module(f"{PORT}.{module}"), name)


def replay_steps(cell):
    """Steps one of the cell's graph replays advances: the program's own
    constant, named by the cell's ``replay_steps``."""
    return int(program_constant(cell.workload["replay_steps"]))


def net_rows(mix, cfg):
    """The rows each net that a call trains draws per step, one entry per
    net: the mix's ``net_rows`` ([rows, nets] pairs), or one net of the
    configuration's batch."""
    if "net_rows" in mix:
        return [r for r, n in mix["net_rows"] for _ in range(n)]
    return [cfg["batch_size"]]


def process_age_s():
    """Seconds since this process started: the system's uptime less the
    process's start in clock ticks after boot (Linux /proc; 10 ms
    resolution)."""
    import os

    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def call_seed(seed, i):
    """The seed of call ``i`` of a run seeded ``seed`` (``i`` = −1: its
    warm-up): runs of neighbouring seeds share no call."""
    return seed * CALLS_PER_SEED + i + 1


def run_window(driver, seconds, seed, sync, rows, before_call=None):
    """Calls back to back while ``seconds`` have not passed since the
    first began; the window closes when the last call that began in it has
    ended. ``rows``: each net's rows per step. ``before_call(i)`` runs
    before call i (the traced run's profiler)."""
    calls = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if before_call is not None:
            before_call(len(calls))
        s = call_seed(seed, len(calls))
        start = time.perf_counter()
        answer, steps, program_s = driver.call(s)
        sync()
        calls.append(Call(s, start, time.perf_counter(), answer, steps,
                          rows, program_s))
    return t0, calls[-1].end, calls


def step_cost(cell):
    """(operations, bytes) of one step of every net a call trains."""
    sys.path.insert(0, str(HERE))
    import flops

    total_f = total_b = 0
    for rows in net_rows(cell.mix, cell.cfg):
        f, b = flops.net_step(cell.cfg, rows)
        total_f += f
        total_b += b
    return total_f, total_b


def read_metrics(ctx, metrics):
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check_calls(cell, calls, device, seed):
    """Every call's numbers against the cell's limits: (attempted, failed,
    {number: {"value": the worst over the calls, "limit"}}). The numbers a
    check module lists in ``DEEP`` (dear to read) are read on one call
    only, drawn from the run's ``seed``; every other number on every
    call."""
    check = load_module("checks", cell.workload["check"])
    limits = dict(cell.workload["limits"])
    if "mae" in limits and limits["mae"] == "config":
        limits["mae"] = cell.cfg["mae_limit"]
    deep = random.Random(seed).randrange(len(calls)) if calls else None
    worst = {name: -math.inf for name in limits}
    failed = 0
    for i, call in enumerate(calls):
        try:
            nums = check.numbers(cell, call, device, i == deep)
        except Exception:  # noqa: BLE001 — a crash fails the call
            print(f"check of seed {call.seed} raised:\n"
                  f"{traceback.format_exc()}", file=sys.stderr)
            nums = {name: math.inf for name in limits}
        bad = False
        for name, limit in limits.items():
            if i != deep and name in getattr(check, "DEEP", ()):
                continue
            v = nums.get(name, math.inf)
            v = math.inf if v is None or not math.isfinite(v) else v
            worst[name] = max(worst[name], v)
            bad |= v > limit
        failed += bad
    readings = {name: {"value": worst[name], "limit": limits[name]}
                for name in limits}
    return len(calls), failed, readings
