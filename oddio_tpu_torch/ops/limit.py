"""Soft limiters: Reinhard and Tanh (counterpart of oddio_tpu/ops/limit.py).

Reference: oddio's src/reinhard.rs (``x / (1 + |x|)`` per channel,
reinhard.rs:28-35) and src/tanh.rs (``tanh(x)`` per channel,
tanh.rs:22-29).  Elementwise maps on the block.
"""

from __future__ import annotations

import torch

from .channels import _Wrapper

__all__ = ["Reinhard", "Tanh"]


class Reinhard(_Wrapper):
    _dr_elementwise = True

    def __init__(self, signal):
        super().__init__(signal)
        self.channels = signal.channels

    def _map(self, x):
        return x / (1.0 + torch.abs(x))


class Tanh(_Wrapper):
    _dr_elementwise = True

    def __init__(self, signal):
        super().__init__(signal)
        self.channels = signal.channels

    def _map(self, x):
        return torch.tanh(x)
