"""One client in a closed loop calling the program's ``solve`` back to
back: each call trains a network on the configuration's equation from its
own seed, evaluates it on the grid and returns its MAE. The mix names the
engine and any problem options; the configuration gives the training
settings, passed to ``solve`` explicitly."""

import importlib

PORT = "differential_equations_dnn_tpu_torch"


class Driver:
    def __init__(self, mix, cfg, device):
        self.solve = importlib.import_module(PORT).solve
        self.mix, self.cfg, self.device = mix, cfg, device
        self.kwargs = dict(mix.get("problem_kwargs", {}),
                           engine=mix["engine"],
                           batch_size=cfg["batch_size"], lrate=cfg["lrate"],
                           schedule=cfg["schedule"], nodes=cfg["nodes"],
                           precision=cfg["precision"], device=device)

    def warm_up(self, seed):
        """One short solve at the cell's shapes: builds the kernels and,
        where the program caches them, captures its graphs."""
        self.solve(self.cfg["equation"], seed=seed,
                   iterations=self.mix["warmup_iterations"], **self.kwargs)

    def call(self, seed):
        """One whole solve; returns (answer, steps, the program's own
        training seconds)."""
        res = self.solve(self.cfg["equation"], seed=seed,
                         iterations=self.cfg["iterations"], **self.kwargs)
        return res, self.cfg["iterations"], res.wall_time

    def close(self):
        """Free the program's cached graphs and their buffers."""
        importlib.import_module(f"{PORT}.kernels.graphs").clear_graphs()
