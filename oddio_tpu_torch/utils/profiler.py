"""Rendering observability: xRT counters and a torch.profiler trace
(counterpart of oddio_tpu/utils/profiler.py).

The reference has zero instrumentation (SURVEY.md §5 — "you hear
glitches"); this is the additive equivalent: wrap a Renderer's calls to
track how many times faster than real time it runs, and optionally capture
a device trace.  On a CUDA device a block's clock stops only after
``torch.cuda.synchronize``, so a block that leaves its audio on the device
(``render_frames_device``) is timed to the end of its kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["XrtMeter", "device_trace"]


class XrtMeter:
    """Tracks audio-seconds rendered vs wall-clock seconds spent.

    >>> meter = XrtMeter(rate=48000)
    >>> with meter.block(512):
    ...     out = renderer.render_block(512)   # doctest: +SKIP
    >>> meter.xrt()                            # doctest: +SKIP
    """

    def __init__(self, rate, device=None):
        self.rate = float(rate)
        self.device = None if device is None else torch.device(device)
        self.frames = 0
        self.wall = 0.0

    @contextlib.contextmanager
    def block(self, n):
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall += time.perf_counter() - t0
        self.frames += n

    def audio_seconds(self):
        return self.frames / self.rate

    def xrt(self):
        """Times-real-time achieved so far (> 1 means keeping up)."""
        return self.audio_seconds() / self.wall if self.wall else float("inf")

    def reset(self):
        self.frames = 0
        self.wall = 0.0


@contextlib.contextmanager
def device_trace(logdir):
    """Capture a ``torch.profiler`` trace (the CPU, and the CUDA device when
    there is one) around a rendering region; writes a Chrome trace,
    ``trace.json``, into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
