"""Carry device state between the JAX package and this one.

``state_from_numpy`` takes a JAX scene's ``device_collect()`` tree after
``jax.device_get`` (plain numpy arrays) and returns the same tree of
tensors on ``device``, same keys and dtypes; ``state_to_numpy`` goes the
other way.  Neither imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(tree, device="cpu"):
    """Numpy tree -> tensor tree on ``device`` (always a copy: the port
    updates some leaves in place)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def state_to_numpy(tree):
    """Tensor tree -> numpy tree (copies on the host)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu(), copy=True)
