"""Result-artifact IO, compatible with the reference's ``temp_results/*.npy``
layout (heat.py:220-225, simple_ode.py:184-186): the ``--solve`` phase saves
arrays, the ``--plot`` phase reloads them — that split IS the reference's
resume mechanism, preserved here. The files are the JAX package's, so
either package's ``--plot`` reads the other's ``--solve``."""

from pathlib import Path

import numpy as np

DEFAULT_RESULTS_DIR = "temp_results"


def results_dir(path: str | Path | None = None) -> Path:
    d = Path(path or DEFAULT_RESULTS_DIR)
    d.mkdir(parents=True, exist_ok=True)
    return d


def save_array(name: str, array, directory=None) -> Path:
    """``array`` (numpy, or a tensor on any device) as ``<name>.npy``."""
    if hasattr(array, "detach"):
        array = array.detach().cpu().numpy()
    d = results_dir(directory)
    path = d / name
    np.save(path, np.asarray(array))
    return path.with_suffix(".npy")


def load_array(name: str, directory=None):
    d = Path(directory or DEFAULT_RESULTS_DIR)
    name = name if name.endswith(".npy") else name + ".npy"
    return np.load(d / name)
