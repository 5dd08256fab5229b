"""The keys of the scan and population trainers' cached CUDA graphs
(``train.trainer.graph_key``, ``parallel.population.graph_key``), the
cache they index (``kernels.graphs``) and the copy of a call's starting
state into a cached scan entry. A key holds exactly what the captured
kernels read as host values or shapes: two calls that differ only in what
each call copies in (the seed, the lr, the starting weights, a constant
schedule's iterations) share it, and any change to what a graph bakes in
parts them. The graphs themselves need the card (tests/test_torch_gpu.py).
"""

import contextlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
    InverseHeat1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    graphs,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    population,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    train,
    trainer,
)
from differential_equations_dnn_tpu_torch.utils import trace  # noqa: E402

CPU = torch.device("cpu")
BASE_CONFIG = TrainConfig(iterations=15_000, batch_size=64, lrate=1e-4)


class _Unhashable(Heat1D):
    __hash__ = None


class _TensorAttr(MLP):
    """An MLP that keeps a tensor outside its parameters and buffers."""

    def __init__(self):
        super().__init__(2, 1, 128, 3, "tanh", generator=generator(0))
        self.scale = torch.ones(1)


def _heat_model(seed=0, **kw):
    args = dict(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                activation="tanh")
    return MLP(**{**args, **kw}, generator=generator(seed))


def _hooked():
    model = _heat_model()
    model.register_forward_hook(lambda *a: None)
    return model


def _nudged():
    model = _heat_model()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
    return model


@contextlib.contextmanager
def _math(setting):
    """Run the block under one process-wide math setting, ``(get, set,
    value)``, put back after it."""
    if setting is None:
        yield
        return
    get, put, value = setting
    old = get()
    put(value)
    try:
        yield
    finally:
        put(old)


def _attr(obj, name, value):
    return (lambda: getattr(obj, name),
            lambda v: setattr(obj, name, v), value)


MATMUL, CUDNN = torch.backends.cuda.matmul, torch.backends.cudnn


def _scan_key(problem=None, model=None, device=CPU, mesh=None, math=None,
              **config):
    problem = problem or Heat1D()
    model = model if model is not None else problem.default_model(
        generator=generator(0))
    with _math(math):
        return trainer.graph_key(problem, model,
                                 replace(BASE_CONFIG, **config), device,
                                 mesh)


COSINE = dict(schedule="cosine")

# (the two keys' arguments, "same" | "differs" | "none": the second has no
# key). Each case changes one thing against the first.
SCAN_CASES = {
    "seed": ({}, dict(model=_heat_model(seed=7)), "same"),
    "lr": ({}, dict(lrate=3e-3), "same"),
    "initial weights": ({}, dict(model=_nudged()), "same"),
    "constant iterations": ({}, dict(iterations=256), "same"),
    "chunk_size": ({}, dict(chunk_size=1000), "same"),
    "equal problem": ({}, dict(problem=Heat1D(kappa=1.0)), "same"),
    "hard ansatz rebuilt": (dict(problem=Heat1D(constraint="hard")),
                            dict(problem=Heat1D(constraint="hard")), "same"),
    "cosine decay iterations": (dict(COSINE, iterations=256),
                                dict(COSINE, iterations=256, lrate=1e-2),
                                "same"),
    "taps": ({}, dict(problem=Heat1D(taps="pallas")), "differs"),
    "constraint": ({}, dict(problem=Heat1D(constraint="hard")), "differs"),
    "kappa": ({}, dict(problem=Heat1D(kappa=0.5)), "differs"),
    "width": ({}, dict(model=_heat_model(hidden_size=64)), "differs"),
    "depth": ({}, dict(model=_heat_model(num_layers=2)), "differs"),
    "activation": ({}, dict(model=_heat_model(activation="sigmoid")),
                   "differs"),
    "batch norm": ({}, dict(model=_heat_model(batch_norm="pre")),
                   "differs"),
    "dtype": ({}, dict(model=_heat_model().double()), "differs"),
    "batch_size": ({}, dict(batch_size=128), "differs"),
    "adaptive_oversample": ({}, dict(adaptive_oversample=4), "differs"),
    "optimizer": ({}, dict(optimizer="adamw"), "differs"),
    "schedule": ({}, COSINE, "differs"),
    "horizon": (COSINE, dict(COSINE, iterations=256), "differs"),
    "decay": (COSINE, dict(COSINE, schedule_decay=0.5), "differs"),
    "device": ({}, dict(device=torch.device("cuda", 1)), "differs"),
    "matmul tf32": ({}, dict(math=_attr(MATMUL, "allow_tf32",
                                        not MATMUL.allow_tf32)), "differs"),
    "cudnn tf32": ({}, dict(math=_attr(CUDNN, "allow_tf32",
                                       not CUDNN.allow_tf32)), "differs"),
    "float32 matmul precision": ({}, dict(math=(
        torch.get_float32_matmul_precision,
        torch.set_float32_matmul_precision, "medium")), "differs"),
    "deterministic algorithms": ({}, dict(math=(
        torch.are_deterministic_algorithms_enabled,
        torch.use_deterministic_algorithms, True)), "differs"),
    "cudnn benchmark": ({}, dict(math=_attr(CUDNN, "benchmark", True)),
                        "differs"),
    "mesh": ({}, dict(mesh={"data": 1}), "none"),
    "unhashable problem": ({}, dict(problem=_Unhashable()), "none"),
    "observations as arrays": ({}, dict(problem=InverseHeat1D(obs_data=(
        np.zeros((200, 2)), np.zeros((200, 1))))), "none"),
    "tensor attribute": ({}, dict(model=_TensorAttr()), "none"),
    "hook": ({}, dict(model=_hooked()), "none"),
}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_graph_key(case):
    """Two scan calls share a graph exactly when they differ in what each
    call copies in; a mesh, or a problem or model the key cannot
    describe, gives no key."""
    first, second, expect = SCAN_CASES[case]
    a, b = _scan_key(**first), _scan_key(**second)
    assert a is not None
    hash(a)
    if expect == "none":
        assert b is None
    else:
        assert (a == b) == (expect == "same")


def _reading(value):
    """A function that reads the module global ``SCALE`` (``value``), in
    a module of its own."""
    scope = {"SCALE": value, "torch": torch}
    exec("def f(x):\n    return torch.tanh(SCALE * x)\n", scope)
    return scope["f"]


GLOBAL_CASES = {
    "equal globals": (_reading(2.0), _reading(2.0), "same"),
    "another global": (_reading(2.0), _reading(3.0), "differs"),
    "an array global": (_reading(2.0), _reading(np.ones(2)), "none"),
}


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_function_key_reads_its_globals(case):
    """A function is keyed by the module globals its code reads besides
    its code: two functions of equal code share a key only where those
    globals are equal, and a global the key cannot describe gives none."""
    first, second, expect = GLOBAL_CASES[case]
    a = trainer.value_key(first)
    hash(a)
    if expect == "none":
        with pytest.raises(trainer._NoKey):
            trainer.value_key(second)
    else:
        assert (a == trainer.value_key(second)) == (expect == "same")


def _pop_key(problem=None, model=None, n_trials=4, max_bs=64, seed=0,
             device=CPU, mesh=None, math=None):
    problem = problem or Heat1D()
    model = model if model is not None else problem.default_model(
        generator=generator(0))
    params, state = population.init_trials(model, seed, n_trials)
    opt_state = population._adam_init(params, n_trials, None)
    named = population.named_tensors(params, state, opt_state)
    with _math(math):
        return population.graph_key(problem, model, named, n_trials,
                                    max_bs, device, mesh)


POP_CASES = {
    "seed": ({}, dict(seed=5), "same"),
    "template's weights": ({}, dict(model=_heat_model(seed=3)), "same"),
    "equal problem": ({}, dict(problem=Heat1D(kappa=1.0)), "same"),
    "n_local": ({}, dict(n_trials=8), "differs"),
    "max_batch_size": ({}, dict(max_bs=128), "differs"),
    "taps": ({}, dict(problem=Heat1D(taps="taylor")), "differs"),
    "kappa": ({}, dict(problem=Heat1D(kappa=0.5)), "differs"),
    "width": ({}, dict(model=_heat_model(hidden_size=64)), "differs"),
    "activation": ({}, dict(model=_heat_model(activation="sigmoid")),
                   "differs"),
    "stateful": ({}, dict(model=_heat_model(batch_norm="post")),
                 "differs"),
    "device": ({}, dict(device=torch.device("cuda", 1)), "differs"),
    "matmul tf32": ({}, dict(math=_attr(MATMUL, "allow_tf32",
                                        not MATMUL.allow_tf32)), "differs"),
    "mesh": ({}, dict(mesh={"pop": 1}), "none"),
    "unhashable problem": ({}, dict(problem=_Unhashable()), "none"),
    "tensor attribute": ({}, dict(model=_TensorAttr()), "none"),
}


@pytest.mark.parametrize("case", list(POP_CASES))
def test_population_graph_key(case):
    """The population's key: the same rule, over the number of trials and
    the drawn rows besides."""
    first, second, expect = POP_CASES[case]
    a, b = _pop_key(**first), _pop_key(**second)
    assert a is not None
    hash(a)
    if expect == "none":
        assert b is None
    else:
        assert (a == b) == (expect == "same")


class _Entry:
    def __init__(self, k):
        self.k, self.freed = k, False

    def free(self):
        self.freed = True


def test_trainer_cache_is_lru_and_cleared(monkeypatch):
    """Past its size a GraphCache frees its least recently used entry,
    counted as an eviction; a key read moves to the end; ``pop`` forgets
    an entry without freeing it; ``clear_graphs`` frees the trainers'
    entries; a None key is never found."""
    cache = graphs.GraphCache(3)
    monkeypatch.setattr(graphs, "TRAINER_GRAPHS", cache)
    evictions = trace.counters().get("graph.evictions", 0)
    entries = [_Entry(k) for k in range(5)]
    for e in entries[:3]:
        assert cache.put(("k", e.k), e) is e
    assert cache.get(("k", 0)) is entries[0]
    cache.put(("k", 3), entries[3])
    assert trace.counters().get("graph.evictions", 0) == evictions + 1
    assert entries[1].freed and ("k", 1) not in cache
    assert cache.get(("k", 1)) is None
    assert cache.get(("k", 0)) is entries[0]
    assert cache.get(None) is None
    cache.pop(("k", 0))
    cache.pop(None)
    assert cache.get(("k", 0)) is None and not entries[0].freed
    graphs.clear_graphs()
    assert not cache.entries
    assert entries[2].freed and entries[3].freed


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
@pytest.mark.parametrize("resume", [False, True])
def test_scan_entry_load_equals_fresh_setup(optimizer, resume):
    """What a cached entry holds after ``_ScanEntry.load`` of a call's
    model, opt_state and config equals what the call's own setup
    (``make_optimizer``, ``load_opt_state``, ``DeviceSchedule``) gives:
    parameters, moments (zero where the call's fresh optimizer has none
    yet), ``step``, the lr and count tensors and every param group's
    settings. The entry trained another call first."""
    prob = Heat1D()
    cfg = TrainConfig(iterations=300, batch_size=8, lrate=1e-3,
                      optimizer=optimizer, verbose=False)
    other = train(prob, 1, replace(cfg, lrate=5e-3, iterations=40),
                  device="cpu")
    resumed = train(prob, 2, replace(cfg, iterations=20), device="cpu")
    opt_state = resumed.opt_state if resume else None
    model = resumed.params if resume else prob.default_model(
        generator=generator(3))

    def setup(net):
        opt = trainer.make_optimizer(cfg, net.parameters())
        if opt_state is not None:
            trainer.load_opt_state(opt, opt_state)
        return opt, trainer.DeviceSchedule(opt)

    opt, schedule = setup(model)
    net = other.params
    entry_opt = trainer.make_optimizer(replace(cfg, lrate=5e-3,
                                               iterations=40),
                                       net.parameters())
    trainer.load_opt_state(entry_opt, other.opt_state)
    entry = trainer._ScanEntry(net, entry_opt,
                               trainer.DeviceSchedule(entry_opt), None, None)
    entry.load(model, opt_state, cfg)
    for a, b in zip(trainer._tensors(net), trainer._tensors(model)):
        assert torch.equal(a, b)
    for p, q in zip(net.parameters(), model.parameters()):
        want = opt.state.get(q, {})
        for k, v in entry_opt.state[p].items():
            if torch.is_tensor(v):
                expect = want.get(k)
                expect = (torch.zeros_like(v) if expect is None
                          else expect.to(v.dtype))
                assert torch.equal(v, expect), k
    for g, h in zip(entry_opt.param_groups, opt.param_groups):
        for k in ("lrate", "schedule", "horizon", "decay", "count"):
            assert g[k] == h[k], k
    for a, b in zip(entry.schedule.state(), schedule.state()):
        assert torch.equal(a, b)
