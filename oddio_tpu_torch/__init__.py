"""oddio_tpu_torch — the oddio_tpu batch audio engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``oddio_tpu`` (the JAX/TPU package beside it, which stays the
reference), slice by slice, main path first.  This slice renders the
device-resident ``SpatialScene``: ``play()`` voices in the seek pool
(doppler by time warp, elementwise tensor math) and ``play_buffered()``
voices in the delay-ring pool, whose ring append and ear-select reads run
on the kernels of ``ops/ring_kernels.py`` (plain PyTorch on the CPU, CUDA
on a GPU).  The device is explicit: ``SpatialScene.new(device=...)``,
default CPU.

Imports torch and numpy only — never jax or oddio_tpu.
"""

from .core.signal import Signal, ControlBlock
from .core.run import Renderer, run
from .ops.sine import Sine
from .spatial import (
    SpatialScene,
    SpatialSceneControl,
    Spatial,
    SpatialOptions,
    SPEED_OF_SOUND,
    HEAD_RADIUS,
)

__all__ = [
    "Signal",
    "ControlBlock",
    "Renderer",
    "run",
    "Sine",
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
]
