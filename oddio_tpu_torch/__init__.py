"""oddio_tpu_torch — the oddio_tpu batch audio engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

A port of ``oddio_tpu`` (the JAX/TPU package beside it, which stays the
reference), slice by slice, main path first.  It renders:

* the device-resident ``SpatialScene``: ``play()`` voices in the seek pool
  (doppler by time warp, elementwise tensor math) and ``play_buffered()``
  voices in the delay-ring pool, whose ring append and ear-select reads run
  on the kernels of ``ops/ring_kernels.py``;
* the device-resident ``Mixer`` of ``Adapt(Stream)``, ``Adapt(Sine)``,
  ``Stream`` and ``Sine`` voices: stream ingest and reads on the kernels of
  ``ops/stream_kernels.py``, the AGC gains on ``ops/agc.py``'s;
* the host pools of both engines, for chains that are not device-resident
  capable (``Speed`` over a ``Stream``, user signals, a seekable signal
  with its own finish rule) and for submixes (a ``Mixer`` played as one
  voice): the host buffered pool writes its rings through ``ring_place``
  and reads them through ``strip_select`` (``ops/ring_kernels.py``);
* streams in the scene's device-resident buffered pool, and ``Speed``.

Every kernel runs its plain PyTorch version on the CPU and its CUDA kernel
on a GPU.  Engines run on the CUDA card unless the caller passes another
device (``SpatialScene.new(device="cpu")``, ``Mixer.new(channels,
device=...)``, ``Renderer(signal, rate, device=...)`` and ``run(...,
device=...)`` for a standalone signal); without a card they raise rather
than fall back to the CPU.

Imports torch and numpy only — never jax or oddio_tpu.
"""

from .core.signal import Signal, ControlBlock
from .core.run import Renderer, run
from .ops.sine import Sine
from .ops.stream import Stream, StreamControl
from .ops.adapt import Adapt, AdaptOptions
from .ops.speed import Speed, SpeedControl
from .mixer import Mixer, MixerControl, Mixed
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
    "Stream",
    "StreamControl",
    "Adapt",
    "AdaptOptions",
    "Speed",
    "SpeedControl",
    "Mixer",
    "MixerControl",
    "Mixed",
    "SpatialScene",
    "SpatialSceneControl",
    "Spatial",
    "SpatialOptions",
    "SPEED_OF_SOUND",
    "HEAD_RADIUS",
]
