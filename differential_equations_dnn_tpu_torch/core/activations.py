"""Activation registry: name → callable on tensors.

Unknown names fall back to relu with a warning, as the reference's selector
does (neural_networks.py:39-41).
"""

import logging

import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "leaky_relu": F.leaky_relu,
    "identity": lambda x: x,
}


def get_activation(name: str):
    """Look up an activation by name; unknown names fall back to relu."""
    fn = ACTIVATIONS.get(name)
    if fn is None:
        logger.warning("Activation %r not found; falling back to relu.", name)
        return ACTIVATIONS["relu"]
    return fn
