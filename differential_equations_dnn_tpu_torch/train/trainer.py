"""Training configuration and result records.

The generic (scan) trainer of the JAX package is not ported yet (ROADMAP.md
queue 1, item 6); the fused trainers (kernels.fused_train, kernels.
fused_engine, kernels.fused_dgm) fill these.
"""

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass(frozen=True)
class TrainConfig:
    iterations: int = 1000
    batch_size: int = 32
    lrate: float = 1e-4
    chunk_size: int = 25_000
    schedule: str = "constant"


@dataclass
class TrainResult:
    params: Any                 # the trained model (a list of N for packed
                                # replicas)
    opt_state: Any              # {"m": flat tensor, "v": flat tensor}
    loss_history: np.ndarray    # [iterations] ([N, iterations] packed)
    wall_time: float            # steady-state seconds, after synchronize
    iters_per_sec: float        # iterations / wall_time
    compile_time: float = 0.0   # kernel build + first dispatch

    @property
    def final_loss(self) -> float:
        return float(self.loss_history[-1])
