"""One client in a closed loop calling one of the program's training
entries back to back, each call a whole run from its own seed. The mix
names the entry (``module:function``), the problem it is given, fixed
arguments, and which configuration keys fill which arguments."""

import importlib

PORT = "differential_equations_dnn_tpu_torch"


def call_steps(mix, cfg):
    """The steps one call of the mix trains."""
    arg = mix["steps_arg"]
    key = mix.get("from_config", {}).get(arg)
    return cfg[key] if key else mix["args"][arg]


def _resolve(name):
    module, fn = name.split(":")
    return getattr(importlib.import_module(f"{PORT}.{module}"), fn)


class Driver:
    def __init__(self, mix, cfg, device):
        self.entry = _resolve(mix["entry"])
        get_problem = importlib.import_module(f"{PORT}.equations").get_problem
        self.problem = get_problem(cfg["equation"],
                                   **mix.get("problem_kwargs", {}))
        self.mix, self.cfg, self.device = mix, cfg, device
        self.kwargs = dict(mix.get("args", {}), device=device)
        self.kwargs.update({arg: cfg[key] for arg, key
                            in mix.get("from_config", {}).items()})
        self.steps = call_steps(mix, cfg)

    def _run(self, seed, steps):
        kwargs = dict(self.kwargs, **{self.mix["steps_arg"]: steps})
        return self.entry(self.problem, seed=seed, **kwargs)

    def warm_up(self, seed):
        """One short call at the cell's shapes."""
        self._run(seed, self.mix["warmup_iterations"])

    def call(self, seed):
        """One whole call; returns (answer, steps, None: the entry reports
        no training seconds of its own)."""
        return self._run(seed, self.steps), self.steps, None

    def close(self):
        """Free the program's cached graphs and their buffers."""
        importlib.import_module(f"{PORT}.kernels.graphs").clear_graphs()
