"""The scan trainer's device-side schedule (train.trainer.DeviceSchedule), the
piece of its CUDA-graph replay that runs anywhere: on the CPU it must give
the lr and count the host path (``_set_lr``) gives, bit for bit, so that the
graphed steps on the card follow the same schedule. The graphs themselves
need the card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    SimpleODE,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    engine_core,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    train,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    trainer,
)
from differential_equations_dnn_tpu_torch.utils import trace  # noqa: E402


def _optimizer(schedule, optimizer="adam"):
    cfg = TrainConfig(iterations=30, lrate=2e-3, schedule=schedule,
                      optimizer=optimizer)
    return trainer.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(3))])


@pytest.mark.parametrize("schedule", list(engine_core.SCHEDULES))
def test_device_schedule_matches_host(schedule):
    """40 steps (past the 30-step horizon): the device lr of each step
    equals the host's ``_set_lr`` float bit for bit, and the device count
    the host count."""
    host, dev = _optimizer(schedule), _optimizer(schedule)
    sched = trainer.DeviceSchedule(dev)
    group = dev.param_groups[0]
    for i in range(40):
        trainer._set_lr(host)
        sched.advance()
        assert np.float32(host.param_groups[0]["lr"]) == \
            group["lr"].numpy(), i
    _, _, count = sched.rows[0]
    assert float(count) == 40 == host.param_groups[0]["count"]
    assert group["count"] == 0  # the host count moves only by count_steps
    sched.count_steps(40)
    assert group["count"] == 40


def test_device_schedule_resumes_from_the_group_count():
    """A schedule made on an optimizer whose group count is 17 (a resumed
    run) continues at step 18, as ``_set_lr`` does; ``reset`` after a
    ``load_state_dict`` takes the loaded count and new tensors."""
    host, dev = _optimizer("cosine"), _optimizer("cosine")
    for opt in (host, dev):
        opt.param_groups[0]["count"] = 17
    sched = trainer.DeviceSchedule(dev)
    trainer._set_lr(host)
    sched.advance()
    assert np.float32(host.param_groups[0]["lr"]) == \
        dev.param_groups[0]["lr"].numpy()
    old = sched.state()
    state = dev.state_dict()
    state["param_groups"][0]["count"] = 5
    dev.load_state_dict(state)
    sched.reset(dev)
    assert float(sched.rows[0][2]) == 5.0
    assert all(a is not b for a, b in zip(sched.state(), old))
    assert dev.param_groups[0]["lr"] is sched.state()[0]


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_cpu_optimizer_keeps_a_host_lr(name):
    """On the CPU the optimizers keep their float lr and are not
    capturable: the eager path stays as it was."""
    opt = _optimizer("constant", name)
    group = opt.param_groups[0]
    assert isinstance(group["lr"], float) and group["lr"] == 2e-3
    assert not group.get("capturable", False)
    assert not group.get("fused") and group["count"] == 0


def test_scheduled_lr_takes_a_tensor_lrate():
    """``scheduled_lr`` of an fp32 tensor lrate (what a graph reads) equals
    that of the float, bit for bit, for every schedule."""
    t = torch.tensor(7.0)
    for schedule in engine_core.SCHEDULES:
        a = engine_core.scheduled_lr(3e-3, t, schedule, 20.0, 0.1)
        b = engine_core.scheduled_lr(torch.tensor(3e-3), t, schedule, 20.0,
                                     0.1)
        assert torch.equal(a, b), schedule


def _scan_graph_counts():
    counts = trace.counters()
    return [counts.get(f"graph.{what}.scan", 0)
            for what in ("captures", "replays")]


def test_cpu_runs_capture_no_graph():
    """On the CPU every step is eager: a run with whole graph blocks equals
    one cut into chunks shorter than a graph, and no graph is captured or
    replayed."""
    before = _scan_graph_counts()
    runs = [train(SimpleODE(), 0,
                  TrainConfig(iterations=trainer.GRAPH_STEPS + 3,
                              batch_size=4, chunk_size=chunk, verbose=False),
                  model=MLP(1, 1, 4, 1, "tanh", generator=generator(0)),
                  device="cpu")
            for chunk in (25_000, 100)]
    np.testing.assert_array_equal(runs[0].loss_history,
                                  runs[1].loss_history)
    assert _scan_graph_counts() == before
    assert trainer.GRAPH_STEPS == trainer.DRAW_BLOCK
