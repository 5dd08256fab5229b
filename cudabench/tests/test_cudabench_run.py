"""``run.py`` refuses to measure without a card, and a checkout that holds
only the benchmark's files cannot run a cell."""

import json
import os
import shutil
import subprocess
import sys

import harness

ARGS = ["--workload", "heat1d.fused.solve", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "cudabench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_exits_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(harness.REPO, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "cudabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.argv[1:] = %r; sys.path.insert(0, "
            "'cudabench'); import run; run.main(device='cpu', "
            "require_card=False)" % ARGS)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "differential_equations_dnn_tpu_torch" in out.stderr


def test_cpu_run_prints_the_contract_line(capsys):
    import run

    result = run.main(ARGS, device="cpu", require_card=False,
                      overrides={"cfg": {"iterations": 8},
                                 "mix": {"warmup_iterations": 2}})
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
    assert set(result["metrics"]) == {"solve_s", "solve_s_p90", "setup_s"}


def _fake_check(monkeypatch, numbers):
    from types import SimpleNamespace

    module = SimpleNamespace(DEEP=("end",), numbers=numbers)
    monkeypatch.setattr(harness, "load_module", lambda kind, name: module)
    cell = harness.load_cell("fhn.fused.ensemble16")
    cell.workload = {"check": "fake", "limits": {"gap": 1.0, "end": 1.0}}
    return cell


def test_deep_numbers_are_read_on_one_call_drawn_from_the_seed(monkeypatch):
    deep_calls = []

    def numbers(cell, call, device, deep):
        if deep:
            deep_calls.append(call.seed)
            return {"gap": 0.5, "end": 0.5}
        return {"gap": 0.5}

    cell = _fake_check(monkeypatch, numbers)
    calls = [harness.Call(i, 0.0, 1.0, None, 1, [1], None) for i in range(4)]
    attempted, failed, got = harness.check_calls(cell, calls, "cpu", 7)
    assert (attempted, failed) == (4, 0) and got["end"]["value"] == 0.5
    assert len(deep_calls) == 1
    harness.check_calls(cell, calls, "cpu", 7)
    assert deep_calls[0] == deep_calls[1]


def test_a_deep_number_never_read_fails_the_run(monkeypatch):
    cell = _fake_check(monkeypatch, lambda cell, call, device, deep:
                       {"gap": 0.5})
    calls = [harness.Call(i, 0.0, 1.0, None, 1, [1], None) for i in range(3)]
    _, failed, got = harness.check_calls(cell, calls, "cpu", 7)
    assert failed == 1 and got["end"]["value"] == float("inf")
