"""Real-time host integration: the two-thread architecture of the reference
(counterpart of oddio_tpu/control/realtime.py).

The reference is driven by a host audio callback (examples/simple.rs:27-38):
the *audio thread* pulls blocks with ``oddio::run`` while the *control
thread* mutates parameters through wait-free channels.  Block rendering on
a card has launch latency, so the equivalent architecture is:

  control thread  --handles-->  render thread  --native SPSC ring-->  audio callback

The render thread keeps the native output ring topped up ``lead_blocks``
ahead; the audio callback (any thread, or C code holding no GIL-relevant
state) drains it wait-free via :class:`~oddio_tpu_torch.control.native.SpscRing`.
Underruns are zero-filled and counted, like Stream's graceful underrun
(stream.rs:41-49).
"""

from __future__ import annotations

import threading

import numpy as np

from ..core.run import Renderer
from ..utils.profiler import XrtMeter
from .native import SpscRing

__all__ = ["RealtimeDriver"]


class RealtimeDriver:
    """Drives a Signal in a background render thread into a wait-free
    native output ring.

    - ``read(n)`` is the audio-callback side: returns (n, C) float32
      immediately, zero-filling on underrun.
    - controls (play/stop/set_motion/set_gain/...) are used from any other
      thread; they take effect at block granularity, exactly like the
      reference's message channels.
    - ``device`` is the Renderer's for a standalone signal; an engine
      renders on its own device.
    - ``blocks`` counts the blocks rendered, ``meter`` times them (the
      render thread's xRT), and ``error`` holds the exception that ended
      the render thread, if one did.
    """

    def __init__(self, signal, rate, block_size=512, lead_blocks=4, device=None):
        self.signal = signal
        self.rate = int(rate)
        self.block_size = int(block_size)
        self.channels = signal.channels
        self.lead = lead_blocks
        self._renderer = Renderer(signal, rate, device=device)
        self._ring = SpscRing(block_size * self.channels * (lead_blocks + 2))
        self.underruns = 0
        self.blocks = 0
        self.error = None
        self.meter = XrtMeter(rate)
        self._stop = threading.Event()
        self._space = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._space.set()
        self._thread.join(timeout=5)

    def alive(self):
        """Whether the render thread is running."""
        return self._thread.is_alive()

    def _run(self):
        try:
            self._loop()
        except BaseException as e:  # recorded for the caller; the thread ends
            self.error = e
            raise

    def _loop(self):
        frames_per_block = self.block_size * self.channels
        while not self._stop.is_set():
            if self._ring.writable() >= frames_per_block:
                with self.meter.block(self.block_size):
                    block = self._renderer.render_block(self.block_size)
                data = np.ascontiguousarray(block, dtype=np.float32).reshape(-1)
                wrote = self._ring.write(data)
                if wrote != data.size:  # we checked writable() first
                    raise RuntimeError(f"ring took {wrote} of {data.size} samples")
                self.blocks += 1
            else:
                self._space.wait(timeout=0.001)
                self._space.clear()

    def read(self, n):
        """Audio-callback side: pop n frames (wait-free), zero-fill underrun.
        Only whole frames are consumed so channel alignment is preserved."""
        avail = min(n, self._ring.readable() // self.channels)
        out = np.zeros(n * self.channels, np.float32)
        if avail:
            got = self._ring.read_into(out[: avail * self.channels])
            assert got == avail * self.channels
        if avail < n:
            self.underruns += 1
        self._space.set()
        return out.reshape(n, self.channels)
