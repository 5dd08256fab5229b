"""Run-manifest writer.

The reference ships (dead-code) ``parameters_summary`` which redirects stdout
into a ``.pms`` text file of hyperparameters (auxiliary_funs.py:33-87). Here
it is a first-class, tested utility writing both a human-readable ``.pms``
text file and a machine-readable ``.json`` next to it.
"""

import json
import time
from pathlib import Path


def parameters_summary(params: dict, destination: str | Path, name: str = "run"):
    """Write hyperparameter manifest files ``<name>.pms`` and ``<name>.json``
    under ``destination``. Returns the ``.pms`` path."""
    destination = Path(destination)
    destination.mkdir(parents=True, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")

    pms = destination / f"{name}.pms"
    with pms.open("w") as f:
        f.write(f"# Run parameters summary — {name}\n")
        f.write(f"# Written {stamp}\n")
        for key, value in sorted(params.items()):
            f.write(f"{key:<30} : {value}\n")

    with (destination / f"{name}.json").open("w") as f:
        json.dump({"name": name, "written": stamp, "params": params}, f,
                  indent=2, default=str)
    return pms
