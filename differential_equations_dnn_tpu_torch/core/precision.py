"""Matmul precision policy and the single dense primitive used by the models.

The physics residuals take second derivatives through small networks, so
matmul rounding shows up directly in the PDE residual. The port therefore
runs strict IEEE fp32: TF32 is off for matmuls and for cuDNN. Importing this
module sets that policy for the process; it is the counterpart of the JAX
package pinning ``lax.Precision.HIGHEST``.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def dense(x, w, b=None):
    """y = x @ w (+ b), with ``w`` stored ``[fan_in, fan_out]``."""
    y = x @ w
    if b is not None:
        y = y + b
    return y
